"""Rasterizer settings, the plain per-tile α and the round-1 tile rasterizer
(counterpart of jrr_tpu/render/silhouette.py).

Soft silhouette as in the reference's pytorch3d MeshRasterizer +
SoftSilhouetteShader (scripts/mesh_renderer.py:23-79): per pixel and face
p = sigmoid(−d²_ndc/σ) inside the blur band, α = 1 − Π(1 − p) — a union, so
no depth order is needed.

Three rasterizers share this math:
- the fused page-gather path (render/silhouette_fused.py), which the
  refinement loss uses by default (`backend="auto"`/"fused");
- the round-1 tile path here: sort-based binning of each face's ≤ cap² tiles
  (`compute_bins`, `BinState`), a gather of each tile's candidate triangles
  with a scatter-free backward (`_slot_gather`), and the tile kernel
  (render/silhouette_pallas.py). `render_mesh_silhouette` runs it for
  `backend="auto"`/"pallas" and whenever it is given bins, and so does the
  loss for `backend="pallas"`;
- the XLA tile loop (`backend="xla"` without bins): top-K binning from the
  (G², F) hit matrix (`_bin_faces`) and plain PyTorch coverage over chunks
  of tiles (`render_silhouette`), each chunk recomputed in the backward
  pass. jrr_tpu runs it off the TPU, also for "auto"; here "auto" takes the
  round-1 route, the card's counterpart of JAX on the TPU.

`render_silhouette_dense` (every pixel against every face) is the oracle of
the tests.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch.utils import checkpoint as checkpoint_lib

from jrr_tpu_torch import constants
from jrr_tpu_torch.render import camera as camera_lib
from jrr_tpu_torch.render import coverage

# Frames binned at once: bounds the (frames, F·cap²) sort intermediates.
_BIN_FRAMES = 32
# Frames binned at once by the top-K binning: bounds its (frames, G², F)
# hit matrix and the sort's int64 indices (~100 MB a frame at full width).
_TOPK_FRAMES = 8


class RasterizerSpec(NamedTuple):
    image_size: int = constants.CROP_RES
    sigma: float = 1e-4  # NDC² blend sigma (scripts/mesh_renderer.py:28)
    blur_radius: float = 0.0  # NDC² outside band (scripts/mesh_renderer.py:36)
    tile_size: int = 8
    faces_per_tile: int = 96
    focal_length: float = constants.FOCAL_LENGTH
    # The loss: "auto"/"fused" = fused page-gather path, "pallas" = round-1
    # tile path, "xla" = the XLA tile loop (round-1 route when given bins).
    # `render_mesh_silhouette`: "auto"/"pallas" = round-1 tile path, "xla" =
    # the tile loop. Kernels for CUDA tensors, plain versions for CPU tensors.
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


# ---------------------------------------------------------------------------
# Dense oracle
# ---------------------------------------------------------------------------


def _signed_dist2_px(px: torch.Tensor, tri: torch.Tensor) -> torch.Tensor:
    """Signed squared distance (pixel²) from points px (..., P, 2) to
    triangles tri (..., K, 3, 2) → (..., P, K); negative inside."""
    v0, v1, v2 = tri[..., 0, :], tri[..., 1, :], tri[..., 2, :]

    def edge_terms(a, b):
        ab = b - a  # (..., K, 2)
        ap = px[..., :, None, :] - a[..., None, :, :]  # (..., P, K, 2)
        cross = ab[..., None, :, 0] * ap[..., 1] - ab[..., None, :, 1] * ap[..., 0]
        len2 = torch.sum(ab * ab, dim=-1)
        t = torch.sum(ap * ab[..., None, :, :], dim=-1) / torch.clamp_min(len2[..., None, :], 1e-12)
        t = coverage._clip01(t)
        proj = a[..., None, :, :] + t[..., None] * ab[..., None, :, :]
        return cross, torch.sum((px[..., :, None, :] - proj) ** 2, dim=-1)

    c0, d0 = edge_terms(v0, v1)
    c1, d1 = edge_terms(v1, v2)
    c2, d2 = edge_terms(v2, v0)
    d2min = torch.minimum(torch.minimum(d0, d1), d2)
    inside = ((c0 >= 0) & (c1 >= 0) & (c2 >= 0)) | ((c0 <= 0) & (c1 <= 0) & (c2 <= 0))
    return torch.where(inside, -d2min, d2min)


def _coverage(signed_d2_px: torch.Tensor, spec: RasterizerSpec, valid: torch.Tensor) -> torch.Tensor:
    """Coverage probability per (pixel, face) in pytorch3d's NDC units."""
    px_to_ndc2 = (2.0 / spec.image_size) ** 2
    d2_ndc = signed_d2_px * px_to_ndc2
    p = torch.sigmoid(-d2_ndc / spec.sigma)
    return torch.where((d2_ndc <= spec.blur_radius) & valid, p, torch.zeros_like(p))


def _alpha_from_coverage(p: torch.Tensor) -> torch.Tensor:
    """Union α over the face (last) axis: 1 − Π(1 − p)."""
    return 1.0 - torch.prod(1.0 - p, dim=-1)


def _face_screen_verts(verts_screen: torch.Tensor, faces: torch.Tensor):
    """(..., V, 3) → corner xy (..., F, 3, 2) and valid (..., F): faces with
    a corner at z ≤ 1e-6 (behind the camera) are culled. The gather is
    plain indexing, whose backward on the card sums deterministically."""
    fv = verts_screen[..., faces, :]  # (..., F, 3, 3)
    return fv[..., :2], torch.all(fv[..., 2] > 1e-6, dim=-1)


def render_silhouette_dense(verts_screen: torch.Tensor, faces: torch.Tensor,
                            spec: RasterizerSpec) -> torch.Tensor:
    """Every pixel against every face, one frame (V, 3) → (S, S). O(S²·F):
    tests and tiny meshes only."""
    s = spec.image_size
    xy, valid = _face_screen_verts(verts_screen, faces)
    ar = torch.arange(s, dtype=verts_screen.dtype, device=verts_screen.device)
    px = torch.stack([ar.repeat(s), ar.repeat_interleave(s)], dim=-1)  # (S², 2) as (x, y)
    p = _coverage(_signed_dist2_px(px, xy), spec, valid[None, :])
    return _alpha_from_coverage(p).reshape(s, s)


# ---------------------------------------------------------------------------
# Round-1 binning
# ---------------------------------------------------------------------------


class BinState(NamedTuple):
    """Reusable per-batch candidate lists (non-differentiable)."""

    origin: torch.Tensor  # (B, G², 2) f32 tile origins (pixels)
    sel_face: torch.Tensor  # (B, G², K) i32
    sel_valid: torch.Tensor  # (B, G², K) bool
    slot_of_pair: torch.Tensor  # (B, F, cap²) i32 flat tile·K + k slot, or the G²·K dump slot


def _bin_faces_sorted_core(verts_screen: torch.Tensor, faces: torch.Tensor, spec: RasterizerSpec):
    """Sort-based exact binning of a few frames (jrr_tpu
    `_bin_faces_sorted_core`, batched): each face emits its ≤ cap² (tile,
    face) pairs, one stable sort groups them by tile, two searchsorteds
    read off each tile's run. `slot_of_pair` inverts the sort for the
    scatter-free backward of `_slot_gather`.

    verts_screen (b, V, 3) → (origin (b, G², 2), xy (b, F, 3, 2),
    sel_face (b, G², K) i32, sel_valid (b, G², K), slot_of_pair (b, F, cap²) i32).
    """
    s, t = spec.image_size, spec.tile_size
    if s % t:
        raise ValueError(f"image_size {s} must be divisible by tile_size {t}")
    dev = verts_screen.device
    i32 = torch.int32
    b = verts_screen.shape[0]
    g = s // t
    g2 = g * g
    f = faces.shape[0]
    k = min(spec.faces_per_tile, f)
    cap = spec.max_tiles_per_face

    xy, valid = _face_screen_verts(verts_screen, faces)  # (b, F, 3, 2), (b, F)
    pad = 0.5 + s / 2.0 * max(spec.blur_radius, 0.0) ** 0.5 + spec.bin_margin_px
    tmin = torch.floor((xy.amin(dim=2) - pad) / t).to(i32)  # (b, F, 2) (x, y)
    tmax = torch.floor((xy.amax(dim=2) + pad) / t).to(i32)
    on_screen = valid & torch.all(tmax >= 0, dim=-1) & (tmin[..., 0] < g) & (tmin[..., 1] < g)
    tmin_c = torch.clamp(tmin, 0, g - 1)
    span = torch.clamp(tmax, 0, g - 1) - tmin_c

    ar = torch.arange(cap, dtype=i32, device=dev)
    dy = ar[:, None].expand(cap, cap)
    dx = ar[None, :].expand(cap, cap)
    sub = lambda x, c: x[..., c, None, None]  # noqa: E731  (b, F) → (b, F, 1, 1)
    ty = sub(tmin_c, 1) + dy  # (b, F, cap, cap)
    tx = sub(tmin_c, 0) + dx
    pair_ok = (
        on_screen[..., None, None] & (dy <= sub(span, 1)) & (dx <= sub(span, 0))
        & (ty < g) & (tx < g)
    )
    n = f * cap * cap
    tile_id = torch.where(pair_ok, ty * g + tx, g2).reshape(b, n)

    # Stable sort by tile; the sort's index is the pair id (face = id // cap²).
    keys, spos = torch.sort(tile_id, dim=-1, stable=True)
    vals = spos // (cap * cap)
    tiles = torch.arange(g2, dtype=i32, device=dev).expand(b, g2).contiguous()
    start = torch.searchsorted(keys, tiles, side="left")
    end = torch.searchsorted(keys, tiles, side="right")
    count = end - start

    slots = start[:, :, None] + torch.arange(k, device=dev)  # (b, G², K)
    sel_face = torch.gather(vals, 1, torch.clamp_max(slots, n - 1).reshape(b, -1)).reshape(b, g2, k)
    sel_valid = torch.arange(k, device=dev) < count[..., None]
    sel_face = torch.where(sel_valid, sel_face, 0)

    # Invert the sort: flat output slot of each original (tile, face) pair.
    pos = torch.arange(n, device=dev)
    in_grid = keys < g2
    keys_l = keys.long()
    kk = pos - torch.where(in_grid, torch.gather(start, 1, torch.clamp(keys_l, 0, g2 - 1)), 0)
    slot_sorted = torch.where(in_grid & (kk < k), keys_l * k + kk, g2 * k)
    slot_of_pair = torch.empty_like(slot_sorted).scatter_(1, spos, slot_sorted)

    tile_yx = torch.arange(g, device=dev, dtype=xy.dtype)
    origin = torch.stack([tile_yx.repeat(g), tile_yx.repeat_interleave(g)], dim=-1) * t
    return (
        origin.expand(b, g2, 2).contiguous(), xy, sel_face.to(i32), sel_valid,
        slot_of_pair.to(i32).reshape(b, f, cap * cap),
    )


def _bins_from_screen(verts_screen: torch.Tensor, faces: torch.Tensor, spec: RasterizerSpec) -> BinState:
    """`_bin_faces_sorted_core`, `_BIN_FRAMES` frames at a time."""
    parts = [
        _bin_faces_sorted_core(verts_screen[lo : lo + _BIN_FRAMES], faces, spec)
        for lo in range(0, verts_screen.shape[0], _BIN_FRAMES)
    ]
    cat = lambda j: torch.cat([p[j] for p in parts], dim=0)  # noqa: E731
    return BinState(origin=cat(0), sel_face=cat(2), sel_valid=cat(3), slot_of_pair=cat(4))


def compute_bins(vertices_smpl: torch.Tensor, faces: torch.Tensor, cam_t: torch.Tensor,
                 spec: RasterizerSpec) -> BinState:
    """Bin once for reuse across refinement steps (`bin_margin_px` of slack
    keeps slightly stale bins covering)."""
    verts_screen = camera_lib.project_points_screen(
        vertices_smpl.detach(), cam_t.detach(), spec.image_size, spec.focal_length
    )
    return _bins_from_screen(verts_screen, faces, spec)


class _SlotGather(torch.autograd.Function):
    """xy (B, F, 6) → (B, G², K, 6) by sel_face, with a backward of gathers
    only: each face sums the cotangent rows of its own ≤ cap² slots through
    `slot_of_pair` (jrr_tpu `_slot_gather`). Autograd's own index backward
    adds with float atomics on the card, whose order changes from run to run
    (and 30 Adam steps amplify those last bits); this sum repeats bit for
    bit. Cotangents at invalid slots reach no face."""

    @staticmethod
    def forward(ctx, xy, sel_face, slot_of_pair):
        ctx.save_for_backward(slot_of_pair)
        ctx.g_shape = sel_face.shape
        batch = torch.arange(xy.shape[0], device=xy.device)[:, None, None]
        return xy[batch, sel_face]

    @staticmethod
    def backward(ctx, g):
        (slot_of_pair,) = ctx.saved_tensors
        b, g2, k = ctx.g_shape
        g_pad = torch.cat([g.reshape(b, g2 * k, -1), g.new_zeros(b, 1, g.shape[-1])], dim=1)
        batch = torch.arange(b, device=g.device)[:, None, None]
        d_pairs = g_pad[batch, torch.clamp_max(slot_of_pair, g2 * k)]  # (B, F, cap², 6)
        return d_pairs.sum(dim=2), None, None


def _slot_gather(xy_flat, sel_face, slot_of_pair):
    return _SlotGather.apply(xy_flat, sel_face, slot_of_pair)


def _tiles_to_image(alphas: torch.Tensor, g: int, t: int) -> torch.Tensor:
    """(..., G², T²) → (..., S, S)."""
    lead = alphas.shape[:-2]
    return alphas.reshape(lead + (g, g, t, t)).transpose(-3, -2).reshape(lead + (g * t, g * t))


def tile_constants(spec: RasterizerSpec):
    """(inv_sigma, blur_px2): σ and the blur band in pixel² units."""
    px_to_ndc2 = (2.0 / spec.image_size) ** 2
    return px_to_ndc2 / spec.sigma, (spec.blur_radius / px_to_ndc2 if spec.blur_radius > 0 else 0.0)


def packed_tiles(verts_screen: torch.Tensor, faces: torch.Tensor, spec: RasterizerSpec,
                 bins: Optional[BinState] = None):
    """The tile kernel's inputs for screen vertices (B, V, 3): origin
    (N, 2), tri (N, 6, K_pad), valid (N, 1, K_pad) with N = B·G² (binning
    here when `bins` is None); differentiable in the vertices."""
    from jrr_tpu_torch.render import silhouette_pallas as sp

    b = verts_screen.shape[0]
    if bins is None:
        bins = _bins_from_screen(verts_screen.detach(), faces, spec)
    xy, _ = _face_screen_verts(verts_screen, faces)
    sel_xy = _slot_gather(xy.reshape(b, faces.shape[0], 6), bins.sel_face, bins.slot_of_pair)
    tri, valid, _ = sp.pack_tri(sel_xy.reshape(bins.sel_face.shape + (3, 2)), bins.sel_valid)
    flat = lambda x: x.reshape((-1,) + x.shape[2:])  # noqa: E731
    return flat(bins.origin), flat(tri), flat(valid)


def render_silhouette_batch_pallas(verts_screen: torch.Tensor, faces: torch.Tensor,
                                   spec: RasterizerSpec, bins: Optional[BinState] = None):
    """Batched round-1 rasterization (B, V, 3) → (B, S, S): binning in torch
    ops, every (B, G²) tile in one launch of the tile kernel
    (`silhouette_pallas.tiles_alpha`). Pass `bins` to reuse candidate
    lists across steps."""
    from jrr_tpu_torch.render import silhouette_pallas as sp

    b = verts_screen.shape[0]
    t = spec.tile_size
    g = spec.image_size // t
    origin, tri, valid = packed_tiles(verts_screen, faces, spec, bins)
    alphas = sp.tiles_alpha(origin, tri, valid, t, *tile_constants(spec))
    return _tiles_to_image(alphas.reshape(b, g * g, t * t), g, t)


# ---------------------------------------------------------------------------
# The XLA tile loop
# ---------------------------------------------------------------------------


def _bin_faces(verts_screen: torch.Tensor, faces: torch.Tensor, spec: RasterizerSpec):
    """Top-K candidate lists per tile (jrr_tpu `_bin_faces`, :145-181) for
    frames (b, V, 3): the faces whose padded bbox touches the tile, in face
    order, the first K kept; a tile with fewer is filled with the
    lowest-index faces that miss it, marked invalid. jax.lax.top_k breaks
    the ties of the 0/1 hit scores to the lowest face index, as a stable
    descending sort does; torch.topk promises no order among ties.

    Returns (origin (G², 2), sel_xy (b, G², K, 3, 2), differentiable in the
    vertices, and sel_valid (b, G², K))."""
    s, t = spec.image_size, spec.tile_size
    if s % t:
        raise ValueError(f"image_size {s} must be divisible by tile_size {t}")
    dev = verts_screen.device
    g = s // t
    k = min(spec.faces_per_tile, faces.shape[0])
    xy, valid = _face_screen_verts(verts_screen, faces)  # (b, F, 3, 2), (b, F)
    box = xy.detach()
    pad = 0.5 + s / 2.0 * max(spec.blur_radius, 0.0) ** 0.5
    tmin = torch.floor((box.amin(dim=2) - pad) / t).to(torch.int32)[:, None]  # (b, 1, F, 2)
    tmax = torch.floor((box.amax(dim=2) + pad) / t).to(torch.int32)[:, None]
    ar = torch.arange(g, dtype=torch.int32, device=dev)
    tile_x = ar.repeat(g)[:, None]  # (G², 1)
    tile_y = ar.repeat_interleave(g)[:, None]
    hit = (
        valid[:, None, :]
        & (tile_x >= tmin[..., 0]) & (tile_x <= tmax[..., 0])
        & (tile_y >= tmin[..., 1]) & (tile_y <= tmax[..., 1])
    )  # (b, G², F)
    order = torch.sort(hit.to(torch.uint8), dim=-1, descending=True, stable=True).indices
    face_idx = order[..., :k]
    sel_valid = torch.gather(hit, -1, face_idx)
    batch = torch.arange(xy.shape[0], device=dev)[:, None, None]
    origin = torch.stack([tile_x[:, 0], tile_y[:, 0]], dim=-1).to(xy.dtype) * t
    return origin, xy[batch, face_idx], sel_valid


def render_silhouette(verts_screen: torch.Tensor, faces: torch.Tensor,
                      spec: RasterizerSpec) -> torch.Tensor:
    """The XLA tile loop (jrr_tpu `render_silhouette`, :353-389) over a
    batch: screen vertices (B, V, 3) → α (B, S, S). Binning by `_bin_faces`
    (`_TOPK_FRAMES` frames at a time), then the plain tile α
    (`_tiles_alpha_xla`: the coverage helpers and the lane product) over
    chunks of G tiles of every frame, as jrr_tpu maps over tiles in chunks
    of G. Under autograd each chunk runs in `torch.utils.checkpoint`, so the
    backward pass keeps the (B, G², T²) α and recomputes a chunk's
    (tiles, T², K) intermediates instead of storing them. The α draws no
    random numbers, so the recompute keeps no RNG state (restoring the
    card's would be refused inside a CUDA graph capture)."""
    b = verts_screen.shape[0]
    t = spec.tile_size
    g = spec.image_size // t
    parts = [_bin_faces(verts_screen[lo : lo + _TOPK_FRAMES], faces, spec)
             for lo in range(0, b, _TOPK_FRAMES)]
    origin = parts[0][0]
    sel_xy = torch.cat([p[1] for p in parts])  # (B, G², K, 3, 2)
    k = sel_xy.shape[2]
    tri = sel_xy.reshape(b, g * g, k, 6).transpose(-1, -2)  # (B, G², 6, K)
    valid = torch.cat([p[2] for p in parts])[:, :, None, :].to(sel_xy.dtype)  # (B, G², 1, K)
    consts = tile_constants(spec)
    remat = torch.is_grad_enabled() and tri.requires_grad
    alphas = []
    for lo in range(0, g * g, g):
        args = (origin[lo : lo + g].expand(b, -1, -1).reshape(-1, 2),
                tri[:, lo : lo + g].reshape(-1, 6, k), valid[:, lo : lo + g].reshape(-1, 1, k),
                t, *consts)
        alpha = (checkpoint_lib.checkpoint(_tiles_alpha_xla, *args, use_reentrant=False,
                                           preserve_rng_state=False)
                 if remat else _tiles_alpha_xla(*args))
        alphas.append(alpha.reshape(b, -1, t * t))
    return _tiles_to_image(torch.cat(alphas, dim=1), g, t)


def render_mesh_silhouette(
    vertices_smpl: torch.Tensor,
    faces: torch.Tensor,
    cam_t: torch.Tensor,
    spec: RasterizerSpec = RasterizerSpec(),
    dense: bool = False,
    bins: Optional[BinState] = None,
) -> torch.Tensor:
    """SMPL-frame vertices (B, V, 3) + camera (B, 3) → α image (B, S, S),
    the reference's render_mesh chain (scripts/optimize.py:77-85), routed as
    jrr_tpu routes it (:476-504): `dense` → the oracle; `bins` (from
    `compute_bins`, reused across steps) or backend "auto"/"pallas" → the
    round-1 tile path; backend "xla" without bins → the XLA tile loop."""
    if spec.backend not in ("auto", "pallas", "xla"):
        raise ValueError(f"render_mesh_silhouette backend {spec.backend!r}: "
                         "one of 'auto', 'pallas', 'xla'")
    verts_screen = camera_lib.project_points_screen(
        vertices_smpl, cam_t, spec.image_size, spec.focal_length
    )
    if dense:
        return torch.stack([render_silhouette_dense(v, faces, spec) for v in verts_screen])
    if spec.backend == "xla" and bins is None:
        return render_silhouette(verts_screen, faces, spec)
    return render_silhouette_batch_pallas(verts_screen, faces, spec, bins=bins)
