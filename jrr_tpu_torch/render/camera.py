"""Perspective camera: SMPL frame → NDC → screen (counterpart of
jrr_tpu/render/camera.py:31-88; pytorch3d 0.3.0 conventions of the reference,
scripts/renderer.py:10-51).

- SMPL → camera frame: negate x, y and double all coordinates;
- view transform: translation by the per-frame camera vector T (R = I);
- NDC: x_ndc = f·x/z with f = focal/image_size;
- screen: (S−1)/2 · (1 − ndc), the pytorch3d 0.3.0 formula.
"""

from __future__ import annotations

import torch

from jrr_tpu_torch import constants

SMPL_TO_CAM_FLIP_SCALE = (-2.0, -2.0, 2.0)


def smpl_to_camera_frame(points: torch.Tensor) -> torch.Tensor:
    # The scale filled on the device (fill_, not a copy of host values,
    # which a CUDA graph capture refuses).
    scale = points.new_empty((3,))
    for axis, factor in enumerate(SMPL_TO_CAM_FLIP_SCALE):
        scale[axis].fill_(factor)
    return points * scale


def weak_perspective_to_translation(
    pred_camera: torch.Tensor, image_size: int = constants.CROP_RES
) -> torch.Tensor:
    """SPIN weak-perspective (s, tx, ty) → camera translation (B, 3)
    (reference: scripts/optimize.py:170-173)."""
    s, tx, ty = pred_camera.unbind(-1)
    tz = 2.0 * constants.FOCAL_LENGTH / (image_size * s + 1e-9)
    return torch.stack([-2.0 * tx, -2.0 * ty, tz], dim=-1)


def project_to_ndc(points_cam: torch.Tensor, cam_t: torch.Tensor, focal_ndc: float) -> torch.Tensor:
    """(B, N, 3) camera-frame points + (B, 3) translation → (x_ndc, y_ndc, z_view)."""
    p = points_cam + cam_t[:, None, :]
    z = p[..., 2:3]
    xy_ndc = focal_ndc * p[..., :2] / z
    return torch.cat([xy_ndc, z], dim=-1)


def ndc_to_screen(ndc: torch.Tensor, image_size: int) -> torch.Tensor:
    half = (image_size - 1.0) / 2.0
    xy = half * (1.0 - ndc[..., :2])
    return torch.cat([xy, ndc[..., 2:]], dim=-1)


def project_points_screen(
    points_smpl: torch.Tensor,
    cam_t: torch.Tensor,
    image_size: int = constants.CROP_RES,
    focal_length: float = constants.FOCAL_LENGTH,
) -> torch.Tensor:
    """SMPL-frame points (B, N, 3) → screen (x, y, z_view) (B, N, 3)."""
    ndc = project_to_ndc(smpl_to_camera_frame(points_smpl), cam_t, focal_length / image_size)
    return ndc_to_screen(ndc, image_size)
