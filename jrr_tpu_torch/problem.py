"""Synthetic refinement problem (counterpart of
`__graft_entry__._synthetic_problem`). Two scenes:

- "drift" (the default): small-angle poses near rest and a constant init
  offset (`perturb`) from the truth;
- "realistic": the fixture generator's statistics (fully random per-joint
  rotations, betas σ 0.4, Gaussian init noise at the stored estimates'
  scales: pose6d 0.06, orient6d 0.03, betas 0.1, cam_t 0.05).

Both put the camera at the depths of real SPIN crops (36-60 m, a body
spanning ~140-240 px of the 224² crop). Everything is numpy-seeded: the
regressor, betas, camera and init noise come from one generator in the
JAX version's order, so they equal its draws bit for bit. The rotations
drawn with jax.random there (the global orientation from seed + 1, the
realistic scene's joint rotations from seed + 2) come from numpy
generators of those seeds here, so those frames differ from the JAX
version's at the same seed; tests that compare the two pass arrays across
(`render_data`).

The mask is rendered at the ground-truth params through
`render_mesh_silhouette` with the default spec (the round-1 tile path, the
tile kernel on the card), as `__graft_entry__.py:111-115` does.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from jrr_tpu_torch import resolve_device
from jrr_tpu_torch.config import RefinerConfig, SilhouetteConfig
from jrr_tpu_torch.models import smpl as smpl_mod
from jrr_tpu_torch.ops import jreg as jreg_lib
from jrr_tpu_torch.ops import rotations
from jrr_tpu_torch.refine import losses
from jrr_tpu_torch.render import silhouette as sil_lib

SCENES = ("drift", "realistic")
# Standard deviations of the realistic scene's init noise on (pose6d,
# orient6d, betas, cam_t), drawn in that order.
_REALISTIC_NOISE = (0.06, 0.03, 0.1, 0.05)


@torch.no_grad()
def render_data(model, j_reg, params: losses.FrameParams, cfg: RefinerConfig):
    """(FrameBatch, vertices) of ground-truth params: the regressed joints'
    reprojection and millimetres, and the round-1 render of the body."""
    out = losses.forward_frame(model, params)
    joints = jreg_lib.apply_jreg(jreg_lib.normalize_jreg(j_reg), out.vertices)
    spec = sil_lib.RasterizerSpec(
        image_size=cfg.silhouette.image_size, tile_size=8,
        faces_per_tile=cfg.silhouette.faces_per_tile,
    )
    mask = sil_lib.render_mesh_silhouette(out.vertices, model.faces, params.cam_t, spec)
    data = losses.FrameBatch(
        gt_j2d=losses.reproject_joints(joints, params.cam_t, cfg),
        gt_j3d=joints * 1000.0,
        mask=mask,
    )
    return data, out.vertices


def synthetic_problem(
    batch: int, num_verts: int = 6890, image_size: int = 224, seed: int = 0, device="cuda",
    return_gt: bool = False, perturb=(0.03, 0.02, 0.05, 0.05), scene: str = "drift",
    model=None,
):
    """Returns (model, j_reg, cfg, init, data), and with `return_gt` also the
    ground-truth params and vertices. `model` replaces the synthetic body
    (it sets the device; its vertex count must be `num_verts`). `perturb`
    is the drift scene's constant offset of (pose6d, orient6d, betas,
    cam_t).

    `cfg` carries 3 + 3 steps like the JAX version; callers set the schedule.
    """
    if scene not in SCENES:
        raise ValueError(f"unknown scene {scene!r}")
    full = num_verts == 6890
    if model is None:
        dev = resolve_device(device)
        model = smpl_mod.synthetic_smpl_model(
            seed=seed, num_verts=num_verts, num_faces=None if full else 120, device=dev
        )
    elif model.num_verts != num_verts:
        raise ValueError(f"model override has {model.num_verts} verts, expected {num_verts}")
    dev = model.v_template.device
    rng = np.random.default_rng(seed)
    j_reg = np.zeros((17, num_verts), np.float32)
    for j in range(17):
        j_reg[j, rng.choice(num_verts, size=8, replace=False)] = rng.uniform(0.5, 1.0, 8)
    j_reg = torch.as_tensor(j_reg, device=dev)

    cfg = dataclasses.replace(
        RefinerConfig(),
        stage_a_steps=3,
        stage_b_steps=3,
        silhouette=SilhouetteConfig(
            image_size=image_size, tile_size=8, faces_per_tile=96 if full else 64
        ),
        camera=dataclasses.replace(RefinerConfig().camera, image_size=image_size),
    )

    t = lambda a: torch.as_tensor(a.astype(np.float32), device=dev)  # noqa: E731
    if scene == "realistic":
        pose6d_gt = rotations.rotmat_to_rot6d(
            rotations.random_rotmat(np.random.default_rng(seed + 2), (batch, 23), device=dev)
        )
        beta_scale = 0.4
    else:
        pose6d_gt = rotations.rotmat_to_rot6d(
            rotations.axis_angle_to_rotmat(t(rng.normal(scale=0.25, size=(batch, 23, 3))))
        )
        beta_scale = 0.3
    params = losses.FrameParams(
        pose6d=pose6d_gt,
        orient6d=rotations.rotmat_to_rot6d(
            rotations.random_rotmat(np.random.default_rng(seed + 1), (batch, 1), device=dev)
        ),
        betas=t(rng.normal(scale=beta_scale, size=(batch, 10))),
        cam_t=t(np.stack(
            [rng.uniform(-0.1, 0.1, batch), rng.uniform(-0.1, 0.1, batch),
             rng.uniform(36, 60, batch)], axis=-1,
        )),
    )
    data, vertices = render_data(model, j_reg, params, cfg)
    if scene == "realistic":
        init = losses.FrameParams(*(
            x + t(rng.normal(scale=s, size=tuple(x.shape)))
            for x, s in zip(params, _REALISTIC_NOISE)
        ))
    else:
        init = losses.FrameParams(*(x + d for x, d in zip(params, perturb)))
    if return_gt:
        return model, j_reg, cfg, init, data, params, vertices
    return model, j_reg, cfg, init, data
