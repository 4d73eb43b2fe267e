"""Synthetic refinement problem (counterpart of
`__graft_entry__._synthetic_problem`, scene "drift"): small-angle poses near
rest, a constant init offset, camera depths of real SPIN crops (36-60 m, a
body spanning ~140-240 px of the 224² crop). Everything is numpy-seeded.

The mask is rendered at the ground-truth params through
`render_mesh_silhouette` with the default spec (the round-1 tile path, the
tile kernel on the card), as `__graft_entry__.py:111-115` does. One
divergence stays: the global orientation is drawn from numpy (the JAX
version draws it with jax.random), so frames differ from the JAX version's
at the same seed; tests that compare the two pass arrays across.
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


# Constant init offsets of (pose6d, orient6d, betas, cam_t) from the truth.
_PERTURB = (0.03, 0.02, 0.05, 0.05)


def synthetic_problem(
    batch: int, num_verts: int = 6890, image_size: int = 224, seed: int = 0, device="cuda",
):
    """Returns (model, j_reg, cfg, init, data).

    `cfg` carries 3 + 3 steps like the JAX version; callers set the schedule.
    """
    dev = resolve_device(device)
    full = num_verts == 6890
    model = smpl_mod.synthetic_smpl_model(
        seed=seed, num_verts=num_verts, num_faces=None if full else 120, device=dev
    )
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
    pose6d_gt = rotations.rotmat_to_rot6d(
        rotations.axis_angle_to_rotmat(t(rng.normal(scale=0.25, size=(batch, 23, 3))))
    )
    params = losses.FrameParams(
        pose6d=pose6d_gt,
        orient6d=rotations.rotmat_to_rot6d(
            rotations.random_rotmat(np.random.default_rng(seed + 1), (batch, 1), device=dev)
        ),
        betas=t(rng.normal(scale=0.3, size=(batch, 10))),
        cam_t=t(np.stack(
            [rng.uniform(-0.1, 0.1, batch), rng.uniform(-0.1, 0.1, batch),
             rng.uniform(36, 60, batch)], axis=-1,
        )),
    )
    with torch.no_grad():
        out = losses.forward_frame(model, params)
        joints = jreg_lib.apply_jreg(jreg_lib.normalize_jreg(j_reg), out.vertices)
        spec = sil_lib.RasterizerSpec(
            image_size=image_size, tile_size=8,
            faces_per_tile=cfg.silhouette.faces_per_tile,
        )
        mask = sil_lib.render_mesh_silhouette(out.vertices, model.faces, params.cam_t, spec)
        data = losses.FrameBatch(
            gt_j2d=losses.reproject_joints(joints, params.cam_t, cfg),
            gt_j3d=joints * 1000.0,
            mask=mask,
        )
    dp, do, db, dc = _PERTURB
    init = losses.FrameParams(
        pose6d=params.pose6d + dp, orient6d=params.orient6d + do,
        betas=params.betas + db, cam_t=params.cam_t + dc,
    )
    return model, j_reg, cfg, init, data
