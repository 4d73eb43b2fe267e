"""Differentiable bilinear image sampling (counterpart of the bilinear path of
jrr_tpu/ops/sampling.py:30-69,110-152; reference scripts/sampling_helper.py:5-69).

- `grid_sample`: torch.nn.functional.grid_sample semantics for
  mode='bilinear', padding='zeros', align_corners=False — grid coords in
  [-1, 1], pixel = ((g + 1) · size − 1) / 2, zero padding outside. Written
  as JAX's four-corner gather with the same product order, so both packages
  give the same numbers.
- `warp_image`: homography warp (grid from an output-shape mesh, the 3×3
  transform with perspective divide, sample, NaN scrub).

The linearized multi-sampling mode (JAX's `mode="linearized"`, unused on
the reference's hot path) is not ported yet.
"""

from __future__ import annotations

import torch


def _unnormalize(coord: torch.Tensor, size: int) -> torch.Tensor:
    """[-1, 1] grid coordinate → pixel coordinate, align_corners=False."""
    return ((coord + 1.0) * size - 1.0) / 2.0


def _gather_2d(image: torch.Tensor, ix: torch.Tensor, iy: torch.Tensor) -> torch.Tensor:
    """image (B, C, H, W); ix/iy int64 (B, Ho, Wo) → (B, C, Ho, Wo), zero outside."""
    b, c, h, w = image.shape
    inb = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
    flat = iy.clamp(0, h - 1) * w + ix.clamp(0, w - 1)  # (B, Ho, Wo)
    vals = torch.gather(
        image.reshape(b, c, h * w), 2, flat.reshape(b, 1, -1).expand(b, c, -1)
    ).reshape((b, c) + ix.shape[1:])
    return torch.where(inb[:, None], vals, vals.new_zeros(()))


def grid_sample(image: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """image (B, C, H, W), grid (B, Ho, Wo, 2) in [-1,1] (x, y) → (B, C, Ho, Wo)."""
    h, w = image.shape[-2:]
    x = _unnormalize(grid[..., 0], w)
    y = _unnormalize(grid[..., 1], h)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    dx = (x - x0)[:, None]
    dy = (y - y0)[:, None]
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)
    v00 = _gather_2d(image, x0i, y0i)
    v01 = _gather_2d(image, x0i + 1, y0i)
    v10 = _gather_2d(image, x0i, y0i + 1)
    v11 = _gather_2d(image, x0i + 1, y0i + 1)
    return (
        v00 * (1 - dx) * (1 - dy)
        + v01 * dx * (1 - dy)
        + v10 * (1 - dx) * dy
        + v11 * dx * dy
    )


def _linspace(n: int, like: torch.Tensor) -> torch.Tensor:
    """linspace(-1, 1, n) as jnp.linspace computes it, −(1 − i/(n−1)) + i/(n−1)
    with the end point exact (torch.linspace rounds other points otherwise)."""
    step = torch.arange(n - 1, dtype=like.dtype, device=like.device) / (n - 1)
    return torch.cat([-(1 - step) + step, like.new_ones(1)])


def make_warp_grid(homography: torch.Tensor, out_shape: tuple) -> torch.Tensor:
    """(B, 3, 3) homography → (B, Ho, Wo, 2) sampling grid: the output mesh
    is linspace(-1, 1) inclusive over each axis, transformed with
    perspective divide (reference: scripts/sampling_helper.py:42-69)."""
    ho, wo = out_shape
    ys, xs = (_linspace(n, homography) for n in (ho, wo))
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    pts = torch.stack([gx.reshape(-1), gy.reshape(-1), torch.ones_like(gx).reshape(-1)])
    warped = torch.einsum("bij,jn->bin", homography, pts)
    xy = warped[:, :2] / (warped[:, 2:3] + 1e-8)
    return xy.permute(0, 2, 1).reshape(-1, ho, wo, 2)


def warp_image(image: torch.Tensor, homography: torch.Tensor, out_shape: tuple) -> torch.Tensor:
    """Differentiable homography warp (B, C, H, W) → (B, C, Ho, Wo)."""
    out = grid_sample(image, make_warp_grid(homography, out_shape))
    # NaN scrub, as the reference does (scripts/sampling_helper.py:36-38).
    return torch.where(torch.isnan(out), out.new_zeros(()), out)
