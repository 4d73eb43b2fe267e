"""Bounding-box crop and camera-intrinsics bookkeeping (counterpart of
jrr_tpu/data/crop.py:23-139; reference scripts/data.py:220-271 `find_crop`,
:385-449 `crop_intrinsics`/`resize_intrinsics`,
scripts/perturbation_helper.py:185-210 `vec2mat_for_similarity`).

The bbox is normalized to [-1, 1] over the 1000² frame and turned into a
square similarity transform; the image is warped with the bilinear sampler
and the pinhole intrinsics are updated for the crop + resize, so 3D↔2D
geometry stays consistent.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from jrr_tpu_torch import constants
from jrr_tpu_torch.ops import sampling


def similarity_vec_to_mat(vec: torch.Tensor) -> torch.Tensor:
    """(B, 5) [θ, sx, sy, dx, dy] → (B, 3, 3) = R(θ)·S(sx, sy)·T(dx, dy)."""
    theta, sx, sy, dx, dy = vec.unbind(1)
    cos, sin = torch.cos(theta), torch.sin(theta)
    zero, one = torch.zeros_like(theta), torch.ones_like(theta)
    r = torch.stack([cos, -sin, zero, sin, cos, zero, zero, zero, one], -1).reshape(-1, 3, 3)
    s = torch.stack([sx, zero, zero, zero, sy, zero, zero, zero, one], -1).reshape(-1, 3, 3)
    t = torch.stack([one, zero, dx, zero, one, dy, zero, zero, one], -1).reshape(-1, 3, 3)
    return r @ s @ t


def crop_intrinsics(intrinsics, height, width, crop_ci, crop_cj) -> torch.Tensor:
    """Principal-point update for a crop window (reference: scripts/data.py:385-410)."""
    out = intrinsics.clone()
    out[:, 0, 2] = intrinsics[:, 0, 2] + (width - 1) / 2 - crop_cj
    out[:, 1, 2] = intrinsics[:, 1, 2] + (height - 1) / 2 - crop_ci
    return out


def resize_intrinsics(intrinsics, height, width, scale) -> torch.Tensor:
    """Focal/principal update for a resize (reference: scripts/data.py:413-449)."""
    out = intrinsics.clone()
    x0, y0 = intrinsics[:, 0, 2], intrinsics[:, 1, 2]
    out[:, 0, 2] = (scale * width - 1) / 2 + scale * (x0 - (width - 1) / 2)
    out[:, 1, 2] = (scale * height - 1) / 2 + scale * (y0 - (height - 1) / 2)
    out[:, 0, 0] = scale * intrinsics[:, 0, 0]
    out[:, 1, 1] = scale * intrinsics[:, 1, 1]
    return out


class CropResult(NamedTuple):
    image: torch.Tensor  # (B, C, img_size, img_size)
    min_x: torch.Tensor  # (B,) crop origin in source pixels
    min_y: torch.Tensor  # (B,)
    scale: torch.Tensor  # (B,) half-extent in normalized units
    intrinsics: torch.Tensor  # (B, 3, 3) updated for the crop+resize


def find_crop(
    image: torch.Tensor,  # (B, C, H, W), H = W = 1000
    bbox: torch.Tensor,  # (B, 4) = (min_y, min_x, max_y, max_x) source pixels
    intrinsics: torch.Tensor,  # (B, 3, 3)
    img_size: int = constants.IMAGE_CROP_RES,
) -> CropResult:
    """Square crop around the bbox, warped to img_size² (bilinear)."""
    half = constants.IMG_RES / 2.0
    min_x = (bbox[:, 1] - half) / half
    max_x = (bbox[:, 3] - half) / half
    min_y = (bbox[:, 0] - half) / half
    max_y = (bbox[:, 2] - half) / half

    avg_x = (min_x + max_x) / 2
    avg_y = (min_y + max_y) / 2
    scale = torch.maximum(max_x - min_x, max_y - min_y) / 2

    vec = torch.stack([torch.zeros_like(scale), scale, scale, avg_x / scale, avg_y / scale], 1)
    warped = sampling.warp_image(image, similarity_vec_to_mat(vec), (img_size, img_size))

    side = constants.IMG_RES * scale
    new_intr = crop_intrinsics(intrinsics, side, side, avg_y * half + half, avg_x * half + half)
    new_intr = resize_intrinsics(new_intr, side, side, img_size / (scale * constants.IMG_RES))
    return CropResult(
        image=warped, min_x=(avg_x - scale) * half + half, min_y=(avg_y - scale) * half + half,
        scale=scale, intrinsics=new_intr,
    )


def reposition_j2d(gt_j2d, min_x, min_y, scale, crop_res: int = constants.CROP_RES):
    """Source-frame 2D joints → crop pixel coords (reference: scripts/data.py:134-138)."""
    ratio = constants.IMG_RES / crop_res
    x = (gt_j2d[..., 0] - min_x[..., None]) / scale[..., None] / ratio
    y = (gt_j2d[..., 1] - min_y[..., None]) / scale[..., None] / ratio
    return torch.stack([x, y], dim=-1)
