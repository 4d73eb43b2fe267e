"""The system under test: jrr_tpu_torch's outer-step program
(`refine.trainer.compile_outer_step`), built from the benchmark's inputs.

The only module of the benchmark that imports the port. It hands the port
the scene's arrays as they are (the body, the regressor, the priors'
weights, the batches); what the port derives from them (the vertex order
its rasterizer pages by, its captured graphs, its copies) is its own.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from jrr_tpu_torch import config as config_lib
from jrr_tpu_torch.models import smpl as smpl_lib
from jrr_tpu_torch.refine import trainer
from jrr_tpu_torch.refine.losses import FrameBatch, FrameParams

from benchmark.reference import body as body_lib


def _replace(obj, values: dict):
    """`obj` (a frozen dataclass) with `values` set, nested dataclasses by dict."""
    changes = {}
    for f in dataclasses.fields(obj):
        if f.name not in values:
            continue
        v = values[f.name]
        cur = getattr(obj, f.name)
        if dataclasses.is_dataclass(cur) and isinstance(v, dict):
            v = _replace(cur, v)
        elif isinstance(cur, tuple) and isinstance(v, list):
            v = tuple(v)
        changes[f.name] = v
    return dataclasses.replace(obj, **changes)


def pipeline_config(config: dict) -> config_lib.PipelineConfig:
    """The port's PipelineConfig holding the configuration file's values."""
    return _replace(config_lib.PipelineConfig(), config["pipeline"])


class Step(NamedTuple):
    """What a step hands back to the caller, on the host, and the state."""

    state: trainer.TrainState
    numbers: torch.Tensor  # (len(NUMBERS),) float64, by NUMBERS
    params: torch.Tensor  # (B, 23·6 + 6 + betas + 3) refined params
    vertices: torch.Tensor  # (B, V, 3) on the device


class Program:
    """The port's model and outer-step program over one scene's batches."""

    def __init__(self, scene, config: dict, device):
        body = scene.body
        self.cfg = pipeline_config(config)
        perm = smpl_lib.vertex_locality_perm(body.v_template.cpu().numpy())
        self.model = smpl_lib.SMPLModel(
            v_template=body.v_template, shapedirs=body.shapedirs, posedirs=body.posedirs,
            j_regressor=body.j_regressor, lbs_weights=body.lbs_weights, faces=body.faces,
            j_regressor_extra=None, parents=body_lib.PARENTS,
            vertex_perm=torch.as_tensor(perm.astype("int64"), device=device))
        state = trainer.init_train_state(scene.j_reg_init, self.cfg)
        with torch.no_grad():
            for module, weights in ((state.pose_disc, scene.pose_w),
                                    (state.shape_disc, scene.shape_w)):
                for name, p in module.named_parameters():
                    p.copy_(weights[name])
        self.state0 = state
        self.scene = scene
        self.step_fn = trainer.compile_outer_step(self.cfg)

    def batch(self, k: int):
        rows = self.scene.batch_rows(k)
        f = self.scene.frames
        init = FrameParams(*(x[rows] for x in f.init))
        data = FrameBatch(gt_j2d=f.gt_j2d[rows], gt_j3d=f.gt_j3d[rows], mask=f.mask[rows])
        return init, data, f.gt_verts[rows]

    def step(self, state, k: int) -> Step:
        """Outer step on batch k; returns once the refined params and the
        metrics are on the host, as `run_optimize`'s writer receives them."""
        init, data, gt_verts = self.batch(k)
        state, metrics, result = self.step_fn(state, self.model, init, data)
        pgt = (result.vertices - gt_verts).norm(dim=-1).mean() * 1000.0
        terms = result.stage_b_terms
        first = [result.stage_a_loss[0]] + [getattr(terms, t)[0] for t in FIRST_TERMS[1:]]
        numbers = torch.stack([x.double() for x in list(metrics) + first + [pgt]]).cpu()
        b = init.cam_t.shape[0]
        params = torch.cat([p.reshape(b, -1) for p in result.params], dim=1).cpu()
        return Step(state, numbers, params, result.vertices)


# The refinement's first losses: stage A's, and stage B's terms at its first step.
FIRST_TERMS = ("stage_a", "total", "j2d", "j3d", "pose_disc", "shape_disc")
# What `Program.step` hands back in `numbers`, in order: the step's metrics,
# the refinement's first losses, the refined meshes' mean vertex error (mm).
NUMBERS = trainer.OuterMetrics._fields + FIRST_TERMS + ("pgt_mm",)


def state_leaves(state) -> dict:
    """The trained leaves by name: the raw regressor and the priors' weights."""
    out = {"j_reg": state.j_reg_raw}
    for prefix, module in (("pose", state.pose_disc), ("shape", state.shape_disc)):
        out.update({f"{prefix}.{k}": v for k, v in module.named_parameters()})
    return out


def first_moments(state) -> dict:
    """Each leaf's Adam first moment, by the names of `state_leaves`."""
    out = {"j_reg": state.jreg_opt.m[0]}
    for prefix, module, opt in (("pose", state.pose_disc, state.pose_disc_opt),
                                ("shape", state.shape_disc, state.shape_disc_opt)):
        out.update({f"{prefix}.{k}": m for (k, _), m in zip(module.named_parameters(), opt.m)})
    return out
