"""The round-1 tile kernel's layout and its differentiable entry point
(counterpart of jrr_tpu/render/silhouette_pallas.py).

`pack_tri` lays each tile's candidate triangles out as six 128-lane rows
[ax ay bx by cx cy] plus a validity row. `tiles_alpha` computes the tiles'
α from them and is differentiable in `tri`:
- CUDA tensors: forward `kernels.tiles_alpha_fwd` (csrc/silhouette_tiles.cu,
  replacing `_fwd_kernel` :169), backward `kernels.tiles_alpha_bwd`
  (replacing `_bwd_kernel` :182), which returns d`tri` only, as
  `_tiles_alpha_bwd` :255-277 does (zeros for origin and valid);
- CPU tensors: the plain version, `silhouette._tiles_alpha_xla` under
  autograd.

The backward kernel routes the min-distance gradient to the exact argmin,
not to every edge within the Pallas kernel's 1e-4 band (ROADMAP Queue 3).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from jrr_tpu_torch import kernels
from jrr_tpu_torch.render import silhouette as sil

_LANES = 128


def pack_tri(sel_xy: torch.Tensor, sel_valid: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """(..., G², K, 3, 2) corners + (..., G², K) bool → tri (..., G², 6, K_pad)
    [ax ay bx by cx cy], valid (..., G², 1, K_pad) f32, K_pad (K rounded up
    to 128); the pad lanes are zero and invalid."""
    k = sel_valid.shape[-1]
    k_pad = ((k + _LANES - 1) // _LANES) * _LANES
    tri = sel_xy.reshape(sel_valid.shape + (6,)).transpose(-1, -2)
    tri = F.pad(tri, (0, k_pad - k))
    valid = F.pad(sel_valid.to(sel_xy.dtype)[..., None, :], (0, k_pad - k))
    return tri, valid, k_pad


def tiles_alpha_plain(origin, tri, valid, tile: int, inv_sigma: float, blur_px2: float):
    """Plain α (N, T²) of origin (N, 2), tri (N, 6, K), valid (N, 1, K);
    differentiable by autograd."""
    return sil._tiles_alpha_xla(origin, tri, valid, tile, inv_sigma, blur_px2)


class _TilesAlpha(torch.autograd.Function):
    @staticmethod
    def forward(ctx, origin, tri, valid, tile, inv_sigma, blur_px2):
        ctx.save_for_backward(origin, tri, valid)
        ctx.consts = (tile, inv_sigma, blur_px2)
        return kernels.tiles_alpha_fwd(origin, tri, valid, tile, inv_sigma, blur_px2)

    @staticmethod
    def backward(ctx, g):
        origin, tri, valid = ctx.saved_tensors
        dtri = kernels.tiles_alpha_bwd(origin, tri, valid, g.contiguous(), *ctx.consts)
        return torch.zeros_like(origin), dtri, torch.zeros_like(valid), None, None, None


def tiles_alpha(origin, tri, valid, tile: int, inv_sigma: float, blur_px2: float):
    """α (N, T²) of N tiles; CUDA tensors launch the tile kernels (forward
    and, under autograd, backward), CPU tensors take the plain version."""
    if origin.device.type == "cpu":
        return tiles_alpha_plain(origin, tri, valid, tile, inv_sigma, blur_px2)
    return _TilesAlpha.apply(
        origin.contiguous(), tri.contiguous(), valid.contiguous(), tile, inv_sigma, blur_px2
    )
