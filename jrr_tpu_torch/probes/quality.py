"""The protocol shared by the silhouette quality probes
(`probes/silhouette_quality.py`, `probes/c2f_probe.py`; counterparts of
tools/silhouette_quality.py:94-153 and tools/c2f_probe.py:70-95).

The problem: ground-truth params → a hard mask (the soft render thresholded
at 0.5, like a Mask-RCNN output); the start is the truth perturbed by
constant offsets, with a deliberate shape mismatch in the betas that the 17
joints cannot pin down. Every configuration refines from the same start and
is scored on the final vertices:
- `mpjpe_mm`: regressed-joint error against the true joints;
- `vert_mm`: mean per-vertex error against the true vertices;
- `sil_mse`: mean squared error of the final vertices' render against the
  mask, at the FIXED evaluation spec (σ 1e-4, blur 0), whatever blur the
  configuration trained with;
- `iou`: hard-silhouette IoU at threshold 0.5.

The render goes through `silhouette_fused.silhouette_tiles_fused`: on the
card, the fused α kernel. Each function takes its inputs explicitly, so a
problem built elsewhere (jrr_tpu's, carried over by `convert`) can be
scored here.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from jrr_tpu_torch import problem as problem_lib
from jrr_tpu_torch import resolve_device
from jrr_tpu_torch.config import RefinerConfig
from jrr_tpu_torch.models import discriminator
from jrr_tpu_torch.ops import jreg as jreg_lib
from jrr_tpu_torch.refine import engine, losses
from jrr_tpu_torch.render import silhouette as sil_lib
from jrr_tpu_torch.render import silhouette_fused as sf
from jrr_tpu_torch.utils import precision

POSE_DISC_SEED, SHAPE_DISC_SEED = 7, 8
# Offsets of (pose6d, orient6d, cam_t) from the truth; the betas' is the
# tools' --betas-perturb.
POSE_PERTURB, ORIENT_PERTURB, CAM_PERTURB = 0.03, 0.02, 0.05


class QualityProblem(NamedTuple):
    model: object
    j_reg: torch.Tensor  # (17, V) raw
    cfg: RefinerConfig  # the base every configuration replaces fields of
    init: losses.FrameParams
    data: losses.FrameBatch  # mask thresholded to {0, 1}
    gt_verts: torch.Tensor  # (B, V, 3)
    gt_joints: torch.Tensor  # (B, 17, 3)
    j_norm: torch.Tensor  # (17, V) normalized
    pose_disc: object
    shape_disc: object
    eval_spec: sil_lib.RasterizerSpec
    thin_idx: Optional[torch.Tensor] = None  # appendage vertices of a thin-appendage body


def make_problem(model, j_reg, cfg, init, data, gt_verts, pose_disc, shape_disc,
                 thin_idx=None) -> QualityProblem:
    """A `QualityProblem` of given arrays: the mask thresholded at 0.5, the
    regressor normalized, the true joints regressed from `gt_verts`, the
    scoring spec `cfg`'s rasterizer at blur 0."""
    j_norm = jreg_lib.normalize_jreg(j_reg)
    with torch.no_grad(), precision.float32_products():
        gt_joints = jreg_lib.apply_jreg(j_norm, gt_verts)
    data = data._replace(mask=(data.mask > 0.5).to(torch.float32))
    return QualityProblem(model, j_reg, cfg, init, data, gt_verts, gt_joints, j_norm, pose_disc,
                          shape_disc, losses.rasterizer_spec(cfg)._replace(blur_radius=0.0),
                          thin_idx)


def shape_mismatch_problem(batch: int, num_verts: int, image_size: int, seed: int = 0,
                           betas_perturb: float = 0.6, model=None, thin_idx=None,
                           device="cuda") -> QualityProblem:
    """The probes' problem: `problem.synthetic_problem` (drift scene) with
    the betas offset by `betas_perturb`, live discriminators from seeds 7
    and 8. `model` replaces the synthetic body (a thin-appendage one, whose
    appendage vertices are `thin_idx`); its device wins over `device`."""
    dev = model.v_template.device if model is not None else resolve_device(device)
    model, j_reg, cfg, init, data, _, gt_verts = problem_lib.synthetic_problem(
        batch=batch, num_verts=num_verts, image_size=image_size, seed=seed, device=dev,
        return_gt=True, model=model,
        perturb=(POSE_PERTURB, ORIENT_PERTURB, betas_perturb, CAM_PERTURB),
    )
    pose_disc = discriminator.PoseDiscriminator(seed=POSE_DISC_SEED, device=dev)
    shape_disc = discriminator.ShapeDiscriminator(seed=SHAPE_DISC_SEED, device=dev)
    if thin_idx is not None:
        thin_idx = torch.as_tensor(thin_idx, dtype=torch.int64, device=dev)
    return make_problem(model, j_reg, cfg, init, data, gt_verts, pose_disc, shape_disc, thin_idx)


def with_steps(problem: QualityProblem, stage_a: int, stage_b: int) -> QualityProblem:
    """The problem with its base config at `stage_a` + `stage_b` steps."""
    return problem._replace(cfg=dataclasses.replace(problem.cfg, stage_a_steps=stage_a,
                                                    stage_b_steps=stage_b))


@torch.no_grad()
def score(j_norm, model, verts, cam_t, gt_verts, gt_joints, mask, spec) -> Tuple[float, ...]:
    """(mpjpe_mm, vert_mm, sil_mse, iou) of vertices (B, V, 3) seen from
    `cam_t` (B, 3), against the truth and the (B, S, S) mask at `spec`."""
    with precision.float32_products():
        vert_mm = torch.linalg.norm(verts - gt_verts, dim=-1).mean() * 1000.0
        joints = jreg_lib.apply_jreg(j_norm, verts)
        mpjpe = torch.linalg.norm(joints - gt_joints, dim=-1).mean() * 1000.0
        tiles = sf.silhouette_tiles_fused(verts, model, cam_t, spec)
    mask_t = sf.image_to_tiles(mask, spec.tile_size)
    sil_mse = torch.mean((tiles - mask_t) ** 2)
    hard, hm = tiles > 0.5, mask_t > 0.5
    iou = (hard & hm).sum() / (hard | hm).sum().clamp_min(1)
    return tuple(torch.stack([mpjpe, vert_mm, sil_mse, iou.to(sil_mse.dtype)]).tolist())


def score_result(problem: QualityProblem, verts, cam_t) -> Tuple[float, ...]:
    """`score` of final vertices on `problem`."""
    return score(problem.j_norm, problem.model, verts, cam_t, problem.gt_verts,
                 problem.gt_joints, problem.data.mask, problem.eval_spec)


@torch.no_grad()
def thin_vertex_mm(verts, gt_verts, idx) -> float:
    """Mean error (mm) over the vertices `idx` only."""
    return float(torch.linalg.norm(verts[:, idx] - gt_verts[:, idx], dim=-1).mean() * 1000.0)


def rounded(line: Dict, digits: Dict[str, int]) -> Dict:
    """A result line as the tools print it: each key of `digits` rounded
    to that many digits."""
    return {k: round(v, digits[k]) if k in digits else v for k, v in line.items()}


def refine(problem: QualityProblem, cfg: RefinerConfig, init=None):
    """(RefineResult, seconds) of one `engine.refine_batch` call from
    `init` (the problem's start by default) under `cfg`; the seconds end
    after the device has finished."""
    t0 = time.perf_counter()
    res = engine.refine_batch(problem.model, problem.j_reg,
                              problem.init if init is None else init, problem.data, cfg,
                              problem.pose_disc, problem.shape_disc)
    if res.params.cam_t.is_cuda:
        torch.cuda.synchronize()
    return res, time.perf_counter() - t0
