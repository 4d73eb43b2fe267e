"""Rasterizer settings and the plain per-tile α (counterpart of
jrr_tpu/render/silhouette.py:45,313).

Soft silhouette as in the reference's pytorch3d MeshRasterizer +
SoftSilhouetteShader (scripts/mesh_renderer.py:23-79): per pixel and face
p = sigmoid(−d²_ndc/σ) inside the blur band, α = 1 − Π(1 − p) — a union, so
no depth order is needed. Only the fused page-gather path
(render/silhouette_fused.py) is ported; the JAX package's round-1 paths
(`backend="pallas"/"xla"`, `BinState`) are not.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from jrr_tpu_torch import constants
from jrr_tpu_torch.render import coverage


class RasterizerSpec(NamedTuple):
    image_size: int = constants.CROP_RES
    sigma: float = 1e-4  # NDC² blend sigma (scripts/mesh_renderer.py:28)
    blur_radius: float = 0.0  # NDC² outside band (scripts/mesh_renderer.py:36)
    tile_size: int = 8
    faces_per_tile: int = 96
    focal_length: float = constants.FOCAL_LENGTH
    # "auto"/"fused": kernels for CUDA tensors, plain versions for CPU tensors.
    backend: str = "auto"
    max_tiles_per_face: int = 4  # max tiles per axis a face's padded bbox spans
    bin_margin_px: float = 0.0  # bbox slack for rebin amortization
    pages_per_tile: int = 16  # vertex pages per tile incl. the dump slot


def _tiles_alpha_xla(origin, tri, valid, tile: int, inv_sigma: float, blur_px2: float):
    """Plain per-tile α: origin (N, 2), tri (N, 6, K) [ax ay bx by cx cy],
    valid (N, 1, K) → (N, T²). Differentiable by autograd."""
    t2 = tile * tile
    i = torch.arange(t2, device=origin.device)
    px_x = origin[:, 0:1, None] + (i % tile).to(origin.dtype)[None, :, None]  # (N, T², 1)
    px_y = origin[:, 1:2, None] + (i // tile).to(origin.dtype)[None, :, None]
    rows = tuple(tri[:, j, None, :] for j in range(6))  # (N, 1, K)
    p, *_ = coverage.coverage_rows(px_x, px_y, rows, inv_sigma=inv_sigma, blur_px2=blur_px2)
    p = torch.where(valid[:, 0:1, :] > 0, p, torch.zeros_like(p))
    return 1.0 - coverage.lane_prod(torch.clamp_min(1.0 - p, 1e-30))
