"""Hermetic synthetic fixtures in the exact dataset schema (counterpart of
jrr_tpu/data/fixtures.py:26-209).

`write_fixture_dataset` materializes a dataset directory (tensors.npz,
images.json, PNG frames and masks) whose geometry is self-consistent: frames
come from the SMPL model, 2D joints are true projections and masks are true
rendered silhouettes, so an end-to-end run has a recoverable ground truth.

One deliberate divergence: the ground-truth rotations are drawn from numpy
(JAX draws them with jax.random), so the same seed gives other frames than
the JAX package's; betas, cameras, boxes and noise are the same numpy draws.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np
import torch

from jrr_tpu_torch import constants
from jrr_tpu_torch.config import RefinerConfig
from jrr_tpu_torch.data import png
from jrr_tpu_torch.models import smpl as smpl_lib
from jrr_tpu_torch.ops import jreg as jreg_lib
from jrr_tpu_torch.ops import rotations
from jrr_tpu_torch.refine import losses
from jrr_tpu_torch.render import silhouette as sil_lib

_RENDER_CHUNK = 512  # frames per mask render (bounds the binning intermediates)


@torch.no_grad()
def make_synthetic_frames(
    model: smpl_lib.SMPLModel,
    j_reg_raw,
    num_frames: int,
    seed: int = 0,
    depth_range: tuple = (18.0, 28.0),
):
    """Returns (FrameParams gt, FrameBatch data) on the model's device.

    `depth_range` sets the camera z draw: the default (18, 28) projects
    bodies 1.5-2.5× larger than a real SPIN crop (kept as in jrr_tpu, where
    fixtures and tests are pinned to it); (36, 60) is SPIN-crop scale. Masks
    render through `render_mesh_silhouette` (the round-1 tile kernel for
    CUDA tensors) at the crop size, CROP_RES²."""
    dev = model.v_template.device
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)  # noqa: E731
    pose = rotations.random_rotmat(np.random.default_rng((seed, 23)), (num_frames, 23), device=dev)
    orient = rotations.random_rotmat(np.random.default_rng((seed, 1)), (num_frames, 1), device=dev)
    gt = losses.FrameParams(
        pose6d=rotations.rotmat_to_rot6d(pose),
        orient6d=rotations.rotmat_to_rot6d(orient),
        betas=t(rng.normal(scale=0.4, size=(num_frames, 10))),
        cam_t=t(np.stack(
            [rng.uniform(-0.1, 0.1, num_frames), rng.uniform(-0.1, 0.1, num_frames),
             rng.uniform(depth_range[0], depth_range[1], num_frames)], axis=-1,
        )),
    )
    out = losses.forward_frame(model, gt)
    joints = jreg_lib.apply_jreg(jreg_lib.normalize_jreg(t(j_reg_raw)), out.vertices)
    gt_j2d = losses.reproject_joints(joints, gt.cam_t, RefinerConfig())

    spec = sil_lib.RasterizerSpec(image_size=constants.CROP_RES)
    mask = torch.cat([
        sil_lib.render_mesh_silhouette(
            out.vertices[i : i + _RENDER_CHUNK], model.faces, gt.cam_t[i : i + _RENDER_CHUNK], spec
        )
        for i in range(0, num_frames, _RENDER_CHUNK)
    ])
    return gt, losses.FrameBatch(gt_j2d=gt_j2d, gt_j3d=joints * 1000.0, mask=mask)


def write_fixture_dataset(
    root: str,
    num_frames: int = 8,
    seed: int = 0,
    model: Optional[smpl_lib.SMPLModel] = None,
    j_reg_raw: Optional[np.ndarray] = None,
    num_sequences: int = 2,
    depth_range: tuple = (18.0, 28.0),
    device="cuda",
) -> str:
    """Write a dataset directory that `H36MDataset(root, 'validation')` reads
    (the schema of jrr_tpu's fixtures: precomputed_val/tensors.npz with
    seq_id/frame_id, images.json, imageSequence/seqNNN/img_NNNNNN.png and
    the 224² masks under maskSequence/, the valid flag in pixel (0, 0)).
    Without `model`, a 256-vertex synthetic body on `device`."""
    if model is None:
        model = smpl_lib.synthetic_smpl_model(
            seed=seed, num_verts=256, num_faces=500, device=device
        )
    if j_reg_raw is None:
        rng = np.random.default_rng(seed)
        j_reg_raw = np.zeros((constants.NUM_EVAL_JOINTS, model.num_verts), np.float32)
        for j in range(constants.NUM_EVAL_JOINTS):
            j_reg_raw[j, rng.choice(model.num_verts, size=6, replace=False)] = rng.uniform(
                0.5, 1.0, 6
            )

    gt, data = make_synthetic_frames(
        model, j_reg_raw, num_frames, seed=seed, depth_range=depth_range
    )
    gt = losses.FrameParams(*(x.cpu().numpy() for x in gt))
    masks224 = data.mask.cpu().numpy()  # (N, 224, 224)
    j2d_crop = data.gt_j2d.cpu().numpy()

    split_dir = os.path.join(root, "precomputed_val")
    img_dir = os.path.join(root, "imageSequence")
    mask_dir = os.path.join(root, "maskSequence")
    os.makedirs(split_dir, exist_ok=True)

    # Temporal identity: contiguous frame ranges per sequence.
    seq_id = (np.arange(num_frames) * num_sequences) // max(1, num_frames)
    frame_id = np.arange(num_frames) - np.searchsorted(seq_id, seq_id)
    for k in range(num_sequences):
        os.makedirs(os.path.join(img_dir, f"seq{k:03d}"), exist_ok=True)
        os.makedirs(os.path.join(mask_dir, f"seq{k:03d}"), exist_ok=True)

    r, crop = constants.IMG_RES, constants.CROP_RES
    images = []
    rng = np.random.default_rng(seed + 2)
    bboxes = np.zeros((num_frames, 4), np.float32)
    gt_j2d_src = np.zeros((num_frames, constants.NUM_EVAL_JOINTS, 2), np.float32)
    for i in range(num_frames):
        # Place each crop-space render into a 1000² frame at a known bbox.
        side = int(rng.uniform(320, 620))
        oy = int(rng.uniform(0, r - side))
        ox = int(rng.uniform(0, r - side))
        bboxes[i] = (oy, ox, oy + side, ox + side)  # (min_y, min_x, max_y, max_x)

        m = masks224[i]
        yy = (np.arange(side) * crop / side).astype(int)  # nearest upsampling
        frame = np.zeros((r, r), np.float32)
        frame[oy : oy + side, ox : ox + side] = m[yy][:, yy]

        # 2D joints: crop coords → source-frame coords (the inverse of
        # reposition_j2d with scale = side/1000).
        scale = side / r
        gt_j2d_src[i, :, 0] = j2d_crop[i, :, 0] * (r / crop) * scale + ox
        gt_j2d_src[i, :, 1] = j2d_crop[i, :, 1] * (r / crop) * scale + oy

        mask_u8 = (m * 255).astype(np.uint8)
        mask_u8[0, 0] = 255  # the reference's valid-flag marker pixel
        rel = os.path.join(f"seq{seq_id[i]:03d}", f"img_{frame_id[i]:06d}.png")
        img_path = os.path.join(img_dir, rel)
        png.write(img_path, (np.stack([frame] * 3, -1) * 255).astype(np.uint8))
        png.write(os.path.join(mask_dir, rel), mask_u8)
        images.append(img_path)

    intr = np.zeros((num_frames, 3, 3), np.float32)
    intr[:, 0, 0] = intr[:, 1, 1] = 1100.0
    intr[:, 0, 2] = intr[:, 1, 2] = 500.0
    intr[:, 2, 2] = 1.0

    # Stored pose/betas/cam play the role of the reference's precomputed SPIN
    # predictions (noisy initial estimates); gt_j2d/gt_j3d stay exact.
    prng = np.random.default_rng(seed + 3)

    def noisy(x, s):
        return x + prng.normal(scale=s, size=np.shape(x)).astype(np.float32)

    np.savez(
        os.path.join(split_dir, "tensors.npz"),
        bboxes=bboxes,
        betas=noisy(gt.betas, 0.1),
        estimated_translation=noisy(gt.cam_t, 0.05),
        gt_j2d=gt_j2d_src,
        gt_j3d=data.gt_j3d.cpu().numpy(),
        intrinsics=intr,
        orient=noisy(gt.orient6d, 0.03),
        pose=noisy(gt.pose6d, 0.06),
        seq_id=seq_id.astype(np.int64),
        frame_id=frame_id.astype(np.int64),
    )
    with open(os.path.join(split_dir, "images.json"), "w") as f:
        json.dump(images, f)
    return root
