"""Differentiable image sampling (counterpart of jrr_tpu/ops/sampling.py;
reference scripts/sampling_helper.py:5-69, scripts/linearized.py:141-204).

- `grid_sample`: torch.nn.functional.grid_sample semantics for
  mode='bilinear', padding='zeros', align_corners=False — grid coords in
  [-1, 1], pixel = ((g + 1) · size − 1) / 2, zero padding outside. Written
  as JAX's four-corner gather with the same product order, so both packages
  give the same numbers.
- `mode="linearized"`: the bilinear value, with a gradient with respect
  to the grid taken from a local linear model fitted to four jittered
  samples around each output pixel (jrr_tpu :70-123; unused on the
  reference's hot path). Its noise comes from an explicit
  `torch.Generator`; `linearized_sample` takes the noise itself.
- `warp_image`: homography warp (grid from an output-shape mesh, the 3×3
  transform with perspective divide, sample, NaN scrub).
"""

from __future__ import annotations

from typing import Optional

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


def _bilinear(image: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
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


def linearized_sample(image: torch.Tensor, grid: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """Linearized multi-sampling with the standard-normal `noise`
    (B, A, Ho, Wo, 2) given: the A jitters are `noise` pixels (in grid
    units, 2/size per pixel). Value = bilinear(grid); the gradient
    with respect to the grid flows through the least-squares fit
    value ≈ a + J·d over the A + 1 samples, J held constant; the image's
    flows through the exact sample.

    The fit is jrr_tpu's ridge system (XᵀX + 1e-6·I) c = Xᵀv over
    X = [d, 1], formed and solved in float64: its condition number reaches
    ~1e4 on 256² frames, where float32 loses ~1e-3 of J. Each product of
    two float32 values is exact in float64 and the A + 1 terms are summed
    in a fixed order, so the CPU and the card form the same system."""
    b, c, h, w = image.shape
    ho, wo = grid.shape[1:3]
    scale = torch.tensor([2.0 / w, 2.0 / h], dtype=grid.dtype, device=grid.device)
    noise = noise * scale
    offsets = torch.cat([torch.zeros_like(noise[:, :1]), noise], dim=1)  # (B, A+1, Ho, Wo, 2)
    a1 = offsets.shape[1]
    grids = grid.detach()[:, None] + offsets
    samples = _bilinear(
        image.repeat_interleave(a1, dim=0), grids.reshape(b * a1, ho, wo, 2)
    ).reshape(b, a1, c, ho, wo)
    x_mat = torch.cat([offsets, torch.ones_like(offsets[..., :1])], dim=-1).double()
    xtx = xtv = 0.0
    for a in range(a1):
        x = x_mat[:, a, ..., :, None]  # (B, Ho, Wo, 3, 1)
        xtx = xtx + x * x.transpose(-1, -2)
        xtv = xtv + x * samples[:, a].detach().double().permute(0, 2, 3, 1)[..., None, :]
    eye = torch.eye(3, dtype=xtx.dtype, device=xtx.device) * 1e-6
    jac = torch.linalg.solve(xtx + eye, xtv)[..., :2, :].to(grid.dtype)  # (B, Ho, Wo, 2, C)
    delta = grid - grid.detach()  # zero value, carries the gradient
    return samples[:, 0] + torch.einsum("bhwd,bhwdc->bchw", delta, jac)


def grid_sample(
    image: torch.Tensor,
    grid: torch.Tensor,
    mode: str = "bilinear",
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """image (B, C, H, W), grid (B, Ho, Wo, 2) in [-1,1] (x, y) → (B, C, Ho, Wo).

    `mode="linearized"` draws its (B, 4, Ho, Wo, 2) noise (jrr_tpu's four
    jitters a pixel) from `generator` (a generator on the grid's device;
    None: the default one)."""
    if mode == "bilinear":
        return _bilinear(image, grid)
    if mode == "linearized":
        noise = torch.randn((grid.shape[0], 4) + tuple(grid.shape[1:]),
                            generator=generator, dtype=grid.dtype, device=grid.device)
        return linearized_sample(image, grid, noise)
    raise ValueError(f"unknown sampling mode: {mode}")


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


def warp_image(
    image: torch.Tensor, homography: torch.Tensor, out_shape: tuple,
    mode: str = "bilinear", generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Differentiable homography warp (B, C, H, W) → (B, C, Ho, Wo)."""
    out = grid_sample(image, make_warp_grid(homography, out_shape), mode=mode,
                      generator=generator)
    # NaN scrub, as the reference does (scripts/sampling_helper.py:36-38).
    return torch.where(torch.isnan(out), out.new_zeros(()), out)
