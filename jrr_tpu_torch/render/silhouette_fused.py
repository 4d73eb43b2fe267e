"""Fused page-gather soft-silhouette rasterizer (counterpart of
jrr_tpu/render/silhouette_fused.py, the refinement path's silhouette).

- Per frame, the screen coordinates of the vertices sit in two (PG, 128)
  tables, vertices in Morton order (`models.smpl.vertex_locality_perm`), so
  the vertices one image tile touches cluster into a few 128-vertex pages.
- Binning (amortized over `rebin_interval` steps) gives each tile the ≤ P̂−1
  pages its candidate faces touch and, per candidate-face corner, a local
  index page_slot·128 + lane.
- The CUDA kernels (csrc/silhouette_fused.cu through `kernels.py`) gather
  each tile's corners through those indices and run signed distance, sigmoid
  coverage and the union α per tile; the loss kernel and the α VJP kernel
  also route dL/dcorner back onto the per-frame tables. Invalid slots index a reserved DUMP page
  whose first three lanes form a far-off-screen triangle (zero coverage).
- Lane packing (`pack_bins`, after the interior skip) pairs sparse tiles so
  that two of them share one 128-lane candidate row; only the loss+grad
  path (`fused_lossgrad_packed`) reads the packed fields.
- The plain versions (`fused_tiles_alpha_plain`, `fused_lossgrad_plain`,
  `fused_lossgrad_packed_plain`) compute the same functions with tensor ops
  and autograd; the kernel wrappers use them for CPU tensors only.

The bins contract (`pages`, `idx`, `origin`, the dump page) and the packed
fields equal the JAX package's exactly. Binning capacity limits are never
silent: `BinStats` counts span-clipped faces, truncated tiles and
page-overflow drops.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from jrr_tpu_torch import kernels
from jrr_tpu_torch.render import camera as camera_lib
from jrr_tpu_torch.render import coverage
from jrr_tpu_torch.render import silhouette as sil

_LANES = 128

# Far-off-screen dump triangle (lanes 0..2 of the dump page): a real,
# non-degenerate triangle ~1e6 px below the screen, so coverage and its
# gradient are exactly zero for any slot that points at it.
_DUMP_X = (0.0, 8.0, 0.0)
_DUMP_Y = (-1.0e6, -1.0e6, -1.0e6 + 8.0)

# Frames binned at once: bounds the (frames, G², K, 3, P̂−1) page-match and
# the (frames, F·cap²) sort intermediates at full width.
_BIN_FRAMES = 32

# f32 saturation threshold of the interior skip (silhouette_fused.py:421).
_SAT_EPS = 1e-6


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


class BinStats(NamedTuple):
    """Capacity counters (0-dim integer tensors) — caps are never silent."""

    max_faces_per_tile: torch.Tensor  # true max candidate count
    truncated_tiles: torch.Tensor  # tiles with count > K (faces dropped)
    span_clipped_faces: torch.Tensor  # faces whose bbox span > cap tiles
    page_overflow_tiles: torch.Tensor  # tiles needing > P̂−1 pages
    dropped_slots: torch.Tensor  # candidate slots dropped by page overflow
    interior_skipped_tiles: torch.Tensor  # tiles newly emptied by apply_interior_skip

    def total_dropped(self):
        return self.truncated_tiles + self.span_clipped_faces + self.dropped_slots


class FusedBins(NamedTuple):
    """Per-batch candidate structure (static across a rebin interval)."""

    origin: torch.Tensor  # (B, G², 2) f32 tile origins (pixels)
    pages: torch.Tensor  # (B, G², P̂) i32 page ids (slot P̂−1 = dump page)
    idx: torch.Tensor  # (B, G², 3, K_pad) i32 local page_slot·128 + lane
    stats: BinStats  # batch-summed counters
    # (B, G²) bool from apply_interior_skip: α≡1 tiles marked kernel-empty.
    sat_tiles: Optional[torch.Tensor] = None
    core_count: Optional[torch.Tensor] = None  # (B, G²) CORE candidate counts
    # Lane-packed layout (`pack_bins`), read by the loss+grad path only: a
    # packed pair's PRIMARY entry carries both tiles (64 lanes each), its
    # BUDDY entry is dump-marked (kernel-empty).
    p_pages: Optional[torch.Tensor] = None  # (B, G², P̂) pair-union page lists
    p_idx: Optional[torch.Tensor] = None  # (B, G², 3, K_pad) remapped indices
    p_origin_b: Optional[torch.Tensor] = None  # (B, G², 2) buddy origin (self when unpacked)
    p_flags: Optional[torch.Tensor] = None  # (B, G²) i32: 0 normal, 1 primary, 2 buddy
    p_buddy: Optional[torch.Tensor] = None  # (B, G²) i32 buddy tile id (self when unpacked)
    p_num_pairs: Optional[torch.Tensor] = None  # (B,) i32 packed pair count


def num_pages(num_verts: int) -> int:
    """Real pages + 1 dump page, rounded to a multiple of 8."""
    return _round_up((num_verts + _LANES - 1) // _LANES + 1, 8)


def dump_page_id(num_verts: int) -> int:
    return _round_up(num_verts, _LANES) // _LANES


def build_tables(verts_screen: torch.Tensor, perm: torch.Tensor):
    """(B, V, 3) screen vertices → per-frame coordinate tables (B, PG, 128)×2.

    Table position i holds vertex perm[i]; the pad tail and the dump page hold
    the dump coordinates (lanes 0..2 of the dump page form the dump triangle).
    """
    b, v, _ = verts_screen.shape
    pg = num_pages(v)
    xy = verts_screen[:, perm, :2]
    pad = pg * _LANES - v
    first_dump = _round_up(v, _LANES) - v
    dump_x = verts_screen.new_full((pad,), _DUMP_X[0])
    dump_y = verts_screen.new_full((pad,), _DUMP_Y[0])
    dump_x[first_dump + 1] = _DUMP_X[1]
    dump_y[first_dump + 2] = _DUMP_Y[2]
    tx = torch.cat([xy[..., 0], dump_x.expand(b, pad)], dim=1).reshape(b, pg, _LANES)
    ty = torch.cat([xy[..., 1], dump_y.expand(b, pad)], dim=1).reshape(b, pg, _LANES)
    return tx, ty


# ---------------------------------------------------------------------------
# Binning
# ---------------------------------------------------------------------------


def _fused_bins_frames(
    verts_screen: torch.Tensor,  # (b, V, 3)
    faces: torch.Tensor,  # (F, 3) original vertex ids
    faces_pos: torch.Tensor,  # (F, 3) positions in the permuted table
    *,
    image_size: int,
    tile: int,
    k: int,
    cap: int,
    pad_px: float,
    margin_px: float,
    p_hat: int,
    num_verts: int,
):
    """Fused binning of a few frames (jrr_tpu `_fused_bins_one`, batched).
    Returns (origin, pages, idx, per-frame stats tuple, core_count)."""
    dev = verts_screen.device
    i32 = torch.int32
    b = verts_screen.shape[0]
    g = image_size // tile
    g2 = g * g
    f = faces.shape[0]
    k_pad = _round_up(k, _LANES)
    dump = dump_page_id(num_verts)

    fv = verts_screen[:, faces]  # (b, F, 3, 3)
    xy = fv[..., :2]
    valid = torch.all(fv[..., 2] > 1e-6, dim=-1)
    xy_min = xy.amin(dim=2)  # (b, F, 2)
    xy_max = xy.amax(dim=2)

    tmin = torch.floor((xy_min - pad_px) / tile).to(i32)
    tmax = torch.floor((xy_max + pad_px) / tile).to(i32)
    # CORE range: the bbox without the drift margin (faces covering the tile
    # now). On truncation, margin-only candidates drop first.
    core_pad = pad_px - margin_px
    tmin0 = torch.floor((xy_min - core_pad) / tile).to(i32)
    tmax0 = torch.floor((xy_max + core_pad) / tile).to(i32)

    on_screen = (
        valid & torch.all(tmax >= 0, dim=-1) & (tmin[..., 0] < g) & (tmin[..., 1] < g)
    )
    tmin_c = torch.clamp(tmin, 0, g - 1)
    full_span = torch.clamp(tmax, 0, g - 1) - tmin_c
    span_clipped = torch.sum(on_screen & torch.any(full_span > cap - 1, dim=-1), dim=1)
    span = torch.clamp_max(full_span, cap - 1)

    ar = torch.arange(cap, dtype=i32, device=dev)
    dy = ar[:, None].expand(cap, cap)
    dx = ar[None, :].expand(cap, cap)
    sub = lambda t, c: t[..., c, None, None]  # noqa: E731  (b, F) → (b, F, 1, 1)
    ty_ = sub(tmin_c, 1) + dy  # (b, F, cap, cap)
    tx_ = sub(tmin_c, 0) + dx
    pair_ok = (
        on_screen[..., None, None]
        & (dy <= sub(span, 1)) & (dx <= sub(span, 0)) & (ty_ < g) & (tx_ < g)
    )
    core = (
        (ty_ >= sub(tmin0, 1)) & (ty_ <= sub(tmax0, 1))
        & (tx_ >= sub(tmin0, 0)) & (tx_ <= sub(tmax0, 0))
    )
    tile_id = torch.where(pair_ok, ty_ * g + tx_, g2).reshape(b, -1)
    # Margin-only candidates are ordered nearest-first: a 2-bit bucket of the
    # face-bbox → tile-rect gap (in units of margin/3) sits between the
    # (tile, margin-flag) key and the face id.
    tile_x0 = tx_.to(xy.dtype) * tile
    tile_y0 = ty_.to(xy.dtype) * tile
    bx0 = xy_min - core_pad
    bx1 = xy_max + core_pad
    gap_x = torch.maximum(tile_x0 - sub(bx1, 0), sub(bx0, 0) - (tile_x0 + tile))
    gap_y = torch.maximum(tile_y0 - sub(bx1, 1), sub(bx0, 1) - (tile_y0 + tile))
    gap = torch.clamp_min(torch.maximum(gap_x, gap_y), 0.0)
    # Clamped before the cast (equal to cast-then-clip for gap ≥ 0, and
    # defined for off-screen faces too).
    bucket = torch.clamp(gap * (3.0 / max(margin_px, 1e-6)), 0.0, 3.0).to(i32).reshape(b, -1)

    # Sort key, one int32: [ tile·2 + margin-flag : 2-bit bucket : 14-bit face id ].
    if f >= (1 << 14):
        raise ValueError("packed binning sort assumes < 16384 faces")
    if 2 * g2 + 1 >= (1 << 15):
        raise ValueError(
            f"packed binning sort key overflows int32 for grid {g}x{g}; "
            "use a larger tile_size"
        )
    is_core = core.reshape(b, -1) & (tile_id < g2)
    key = tile_id * 2 + (~is_core).to(i32)
    bucket = torch.where(is_core, 0, bucket)
    face_id = torch.arange(f, dtype=i32, device=dev)[:, None].expand(f, cap * cap).reshape(-1)
    packed = torch.sort((key << 16) | (bucket << 14) | face_id, dim=-1).values

    # Tile t's candidate run (core + trailing margin keys) is
    # [bounds[t], bounds[t+1]); its core-only run is [bounds[t], core_bounds[t]).
    tiles1 = torch.arange(g2 + 1, dtype=i32, device=dev)
    bounds = torch.searchsorted(
        packed, ((tiles1 * 2) << 16).expand(b, -1).contiguous(), side="left"
    )
    core_bounds = torch.searchsorted(
        packed, ((tiles1[:-1] * 2 + 1) << 16).expand(b, -1).contiguous(), side="left"
    )
    start, end = bounds[:, :-1], bounds[:, 1:]
    count = end - start  # (b, G²)
    core_count = (core_bounds - start).to(i32)

    # K-slot windows are contiguous runs of the sorted keys; a K-entry tail
    # pad keeps every window in bounds.
    packed_pad = torch.cat([packed, packed.new_zeros(b, k)], dim=1)
    window = start[:, :, None] + torch.arange(k, device=dev)
    sel_raw = torch.gather(packed_pad, 1, window.reshape(b, -1)).reshape(b, g2, k)
    sel_valid = torch.arange(k, device=dev) < count[..., None]
    sel_face = torch.where(sel_valid, sel_raw & ((1 << 14) - 1), 0).long()

    # --- page assignment ---------------------------------------------------
    vid = faces_pos[sel_face]  # (b, G², K, 3) permuted-table positions
    page = vid >> 7

    # Per-tile page reference counts (scatter-add in place of the JAX
    # package's one-hot reduction: same counts, no (…, 3K, pg_dim) tensor).
    pg_dim = _round_up(dump + 1, 8)
    counts = torch.zeros(b * g2, pg_dim, dtype=torch.int64, device=dev)
    counts.scatter_add_(
        1, page.reshape(b * g2, 3 * k),
        sel_valid[..., None].expand(b, g2, k, 3).reshape(b * g2, 3 * k).long(),
    )
    counts = counts.reshape(b, g2, pg_dim)
    n_distinct = torch.sum(counts > 0, dim=-1)

    # Keep the P̂−1 pages with the most corner references; ties go to the
    # lower page id (jax.lax.top_k's order), made explicit by a unique
    # integer key and a stable descending sort.
    usable = p_hat - 1  # slot P̂−1 is reserved for the dump page
    k_top = min(usable, pg_dim)
    page_ids = torch.arange(pg_dim, device=dev)
    top_pages = torch.sort(
        counts * pg_dim + (pg_dim - 1 - page_ids), dim=-1, descending=True, stable=True
    ).indices[..., :k_top]
    top_counts = torch.gather(counts, -1, top_pages)
    pages_sel = torch.where(top_counts > 0, top_pages, dump)
    pages = torch.cat([pages_sel, pages_sel.new_full((b, g2, p_hat - k_top), dump)], dim=-1)

    # Local page slot per (slot, corner); a corner whose page missed the list
    # (overflow beyond P̂−1 pages) invalidates the whole face slot.
    eq = page[..., None] == pages[:, :, None, None, :usable]  # (b, G², K, 3, P̂−1)
    found = torch.any(eq, dim=-1)
    ps = torch.argmax(eq.to(torch.uint8), dim=-1)
    all_found = torch.all(found, dim=-1)
    slot_ok = sel_valid & all_found
    dropped = torch.sum(sel_valid & ~all_found, dim=(1, 2))

    corner = torch.arange(3, device=dev)
    idx = ps * _LANES + (vid & 127)  # (b, G², K, 3)
    idx = torch.where(slot_ok[..., None], idx, (p_hat - 1) * _LANES + corner)
    idx = idx.transpose(2, 3)  # (b, G², 3, K)
    if k_pad > k:
        # Padded lanes of each corner row still form the dump triangle.
        pad_fill = ((p_hat - 1) * _LANES + corner)[:, None].expand(3, k_pad - k)
        idx = torch.cat([idx, pad_fill.expand(b, g2, 3, k_pad - k)], dim=3)

    tile_yx = torch.arange(g, device=dev, dtype=xy.dtype)
    origin = torch.stack(
        [tile_yx.repeat(g), tile_yx.repeat_interleave(g)], dim=-1
    ) * tile  # (G², 2) as (x, y)

    stats = (
        count.amax(dim=1),
        torch.sum(count > k, dim=1),
        span_clipped,
        torch.sum(n_distinct > usable, dim=1),
        dropped,
    )
    return (
        origin.expand(b, g2, 2).contiguous(),
        pages.to(i32).contiguous(),
        idx.to(i32).contiguous(),
        stats,
        core_count,
    )


def compute_fused_bins(vertices_smpl, model, cam_t, spec: sil.RasterizerSpec) -> FusedBins:
    """Bin a batch for the fused kernels (vertices in the SMPL frame),
    `_BIN_FRAMES` frames at a time. Recompute every `rebin_interval` steps
    with `bin_margin_px` of slack."""
    faces = model.faces
    perm = model.vertex_perm
    if perm is None:
        perm = torch.arange(model.num_verts, device=faces.device)
    inv_perm = torch.empty_like(perm)
    inv_perm[perm] = torch.arange(perm.shape[0], device=perm.device, dtype=perm.dtype)
    faces_pos = inv_perm[faces]

    verts_screen = camera_lib.project_points_screen(
        vertices_smpl.detach(), cam_t.detach(), spec.image_size, spec.focal_length
    )
    pad_px = (
        0.5
        + spec.image_size / 2.0 * math.sqrt(max(spec.blur_radius, 0.0))
        + spec.bin_margin_px
    )
    parts = [
        _fused_bins_frames(
            verts_screen[lo : lo + _BIN_FRAMES], faces, faces_pos,
            image_size=spec.image_size, tile=spec.tile_size,
            k=min(spec.faces_per_tile, faces.shape[0]), cap=spec.max_tiles_per_face,
            pad_px=pad_px, margin_px=spec.bin_margin_px, p_hat=spec.pages_per_tile,
            num_verts=model.num_verts,
        )
        for lo in range(0, verts_screen.shape[0], _BIN_FRAMES)
    ]
    cat = lambda j: torch.cat([p[j] for p in parts], dim=0)  # noqa: E731
    per_frame = [torch.cat([p[3][s] for p in parts]) for s in range(5)]
    stats = BinStats(
        max_faces_per_tile=per_frame[0].max(),
        truncated_tiles=per_frame[1].sum(),
        span_clipped_faces=per_frame[2].sum(),
        page_overflow_tiles=per_frame[3].sum(),
        dropped_slots=per_frame[4].sum(),
        interior_skipped_tiles=per_frame[4].new_zeros(()),
    )
    return FusedBins(
        origin=cat(0), pages=cat(1), idx=cat(2), stats=stats, core_count=cat(4)
    )


# ---------------------------------------------------------------------------
# Interior-saturated-tile skip
# ---------------------------------------------------------------------------


def _erode_tiles(flag: torch.Tensor, g: int, radius: int) -> torch.Tensor:
    """(B, G²) bool → bool: True only where the whole (2r+1)² tile
    neighbourhood is True; out-of-grid neighbours count False."""
    b = flag.shape[0]
    x = F.pad(flag.reshape(b, 1, g, g).float(), (radius,) * 4)  # zero pad = False
    w = 2 * radius + 1
    x = -F.max_pool2d(-x, kernel_size=w, stride=1)  # window minimum
    return (x > 0.5).reshape(b, g * g)


def apply_interior_skip(bins: FusedBins, vertices_smpl, model, cam_t, spec) -> FusedBins:
    """Mark α-saturated tiles kernel-empty; record α≡1 tiles in `sat_tiles`.

    Once per rebin: render α with the fresh bins, find tiles saturated at
    ≤ _SAT_EPS or ≥ 1−_SAT_EPS everywhere, erode by ceil(margin/tile) tiles
    (the drift budget), and overwrite those tiles' pages/idx with the dump
    sentinel the kernels' empty-tile exit branches on. Their gradient is
    numerically zero; the loss of α≡1 tiles is restored from `sat_tiles`
    by `silhouette_sq_err_fused`/`silhouette_tiles_fused`.
    """
    g = spec.image_size // spec.tile_size
    with torch.no_grad():
        tiles = silhouette_tiles_fused(vertices_smpl, model, cam_t, spec, bins=bins)
    lo = torch.all(tiles <= _SAT_EPS, dim=-1)
    hi = torch.all(tiles >= 1.0 - _SAT_EPS, dim=-1)
    radius = max(1, int(math.ceil(spec.bin_margin_px / spec.tile_size)))
    hi_safe = _erode_tiles(hi, g, radius)
    skip = _erode_tiles(lo, g, radius) | hi_safe
    dump = dump_page_id(model.num_verts)
    p_hat = bins.pages.shape[2]
    # Count only tiles the skip newly empties (background tiles are already
    # kernel-empty from binning).
    newly = skip & (bins.pages[:, :, 0] != dump)
    pages = torch.where(skip[..., None], dump, bins.pages).to(torch.int32)
    corner = torch.arange(3, dtype=torch.int32, device=pages.device).reshape(1, 1, 3, 1)
    idx = torch.where(skip[..., None, None], (p_hat - 1) * _LANES + corner, bins.idx)
    stats = bins.stats._replace(interior_skipped_tiles=torch.sum(newly))
    return FusedBins(
        origin=bins.origin, pages=pages.contiguous(), idx=idx.to(torch.int32).contiguous(),
        stats=stats, sat_tiles=hi_safe, core_count=bins.core_count,
    )


# ---------------------------------------------------------------------------
# Lane packing: two sparse tiles share one 128-lane candidate row
# ---------------------------------------------------------------------------

# Lanes per packed tile: each tile of a pair fills two whole warps of the
# loss kernel's 128-thread CTA.
K_HALF = 64


def _pack_bins_frames(pages, idx, origin, core_count, *, dump: int, k_half: int):
    """Lane packing of a few frames (jrr_tpu `_pack_bins_one`, batched).
    Returns (p_pages, p_idx, p_origin_b, p_flags, p_buddy, num_pairs)."""
    dev = pages.device
    b, g2, p_hat = pages.shape
    k_pad = idx.shape[3]
    usable = p_hat - 1
    pg_dim = _round_up(dump + 1, 8)
    tiles = torch.arange(g2, device=dev).expand(b, g2)

    occupied = pages[:, :, 0] != dump
    packable = occupied & (core_count <= k_half)

    # Pair packable tiles in tile order (row-major: horizontal neighbours
    # pair first): rank r pairs with rank r ^ 1.
    rank = torch.cumsum(packable.long(), dim=1) - 1
    npack = packable.long().sum(dim=1, keepdim=True)
    tile_of_rank = torch.sort(torch.where(packable, rank, 2 * g2), dim=1, stable=True).indices
    buddy_rank = rank ^ 1
    has_buddy = packable & (buddy_rank < npack) & (buddy_rank >= 0)
    buddy = torch.where(has_buddy, torch.gather(tile_of_rank, 1, buddy_rank.clamp(0, g2 - 1)), tiles)

    # Pages referenced by each tile's first k_half slots (the half that packs).
    half = idx[..., :k_half]
    gpid = torch.gather(pages.long(), 2, (half >> 7).long().reshape(b, g2, -1))
    real = (half < usable * _LANES).reshape(b, g2, -1)
    pres = torch.zeros(b, g2, pg_dim, dtype=torch.int32, device=dev)
    pres = pres.scatter_add_(2, gpid, real.to(torch.int32)) > 0

    union_pres = pres | torch.gather(pres, 1, buddy[..., None].expand(b, g2, pg_dim))
    union_ok = union_pres.sum(dim=2) <= usable
    paired = has_buddy & union_ok & torch.gather(union_ok, 1, buddy)
    odd = rank % 2 == 1
    primary = paired & ~odd
    is_buddy_role = paired & odd

    # Pair page list: the distinct union pages in ascending id order,
    # dump-padded (the score is unique per page, so the order is exact).
    score = torch.where(union_pres, pg_dim - torch.arange(pg_dim, device=dev), 0)
    k_top = min(usable, pg_dim)
    top = torch.topk(score, k_top, dim=2).values
    union_list = torch.where(top > 0, pg_dim - top, dump)
    if k_top < usable:
        union_list = torch.cat([union_list, union_list.new_full((b, g2, usable - k_top), dump)], dim=2)
    pair_list = torch.where(paired[..., None], union_list, pages[:, :, :usable].long())
    pair_pages = torch.cat([pair_list, pair_list.new_full((b, g2, 1), dump)], dim=2)

    # Old page slot → new slot in the pair list (identity when unpacked);
    # the dump slot stays the dump slot.
    eq = pages[..., None].long() == pair_list[:, :, None, :]  # (b, G², P̂, P̂−1)
    remap = torch.where(eq.any(dim=3), torch.argmax(eq.to(torch.uint8), dim=3), usable)
    remap[:, :, p_hat - 1] = usable
    idx_re = torch.gather(remap, 2, (idx >> 7).long().reshape(b, g2, -1)).reshape(idx.shape)
    idx_re = idx_re * _LANES + (idx & 127)

    # Primary rows: own first half in lanes [0, k_half), the buddy's in
    # [k_half, 2·k_half). Buddy rows: the dump pattern (kernel-empty).
    buddy_idx = torch.gather(idx_re, 1, buddy[:, :, None, None].expand(b, g2, 3, k_pad))
    packed_idx = torch.cat([idx_re[..., :k_half], buddy_idx[..., :k_half]], dim=3)
    corner = torch.arange(3, device=dev).reshape(1, 1, 3, 1)
    dump_idx = (usable * _LANES + corner).expand(b, g2, 3, k_pad)
    p_idx = torch.where(
        primary[..., None, None], packed_idx,
        torch.where(is_buddy_role[..., None, None], dump_idx, idx_re),
    )
    p_pages = torch.where(is_buddy_role[..., None], dump, pair_pages)
    origin_b = torch.gather(origin, 1, buddy[..., None].expand(b, g2, 2))
    p_origin_b = torch.where(primary[..., None], origin_b, origin)
    p_flags = torch.where(primary, 1, torch.where(is_buddy_role, 2, 0))
    p_buddy = torch.where(primary, buddy, tiles)
    i32 = torch.int32
    return (p_pages.to(i32).contiguous(), p_idx.to(i32).contiguous(), p_origin_b.contiguous(),
            p_flags.to(i32).contiguous(), p_buddy.to(i32).contiguous(), primary.sum(dim=1).to(i32))


def pack_bins(bins: FusedBins, num_verts: int, k_half: int = K_HALF) -> FusedBins:
    """Lane-pack a batch's bins (after any interior skip), `_BIN_FRAMES`
    frames at a time; adds the p_* fields and leaves the unpacked ones as
    they are (the α paths read those).

    Tiles with at most `k_half` CORE candidates pair up in tile order; a
    packed tile keeps its first `k_half` candidates (all core ones plus the
    nearest margin ones), so at bin time the packed loss equals the
    unpacked one. Pairs whose page-list union exceeds P̂−1 pages stay
    unpacked: packing itself drops no candidate (jrr_tpu `pack_bins`)."""
    if bins.core_count is None:
        raise ValueError("pack_bins needs FusedBins.core_count (re-bin first)")
    if bins.idx.shape[3] != 2 * k_half:
        raise ValueError(f"pack_bins needs K_pad == 2·k_half, got {bins.idx.shape[3]} and {k_half}")
    dump = dump_page_id(num_verts)
    parts = [
        _pack_bins_frames(
            bins.pages[lo:lo + _BIN_FRAMES], bins.idx[lo:lo + _BIN_FRAMES],
            bins.origin[lo:lo + _BIN_FRAMES], bins.core_count[lo:lo + _BIN_FRAMES],
            dump=dump, k_half=k_half,
        )
        for lo in range(0, bins.pages.shape[0], _BIN_FRAMES)
    ]
    p_pages, p_idx, p_origin_b, p_flags, p_buddy, pairs = (
        torch.cat([p[j] for p in parts]) for j in range(6)
    )
    return bins._replace(p_pages=p_pages, p_idx=p_idx, p_origin_b=p_origin_b,
                         p_flags=p_flags, p_buddy=p_buddy, p_num_pairs=pairs)


# ---------------------------------------------------------------------------
# Plain versions (CPU tests, the on-card reference) — autograd gradients
# ---------------------------------------------------------------------------


def _gather_tri(tx, ty, pages, idx):
    """Corner coordinates through the bins contract → (B, G², 6, K)
    [ax ay bx by cx cy]."""
    b = tx.shape[0]
    g2, k = pages.shape[1], idx.shape[3]
    slot = (idx >> 7).long().reshape(b, g2, 3 * k)
    page = torch.gather(pages.long(), 2, slot)
    pos = (page * _LANES + (idx & 127).long().reshape(b, g2, 3 * k)).reshape(b, -1)
    x = torch.gather(tx.reshape(b, -1), 1, pos).reshape(b, g2, 3, k)
    y = torch.gather(ty.reshape(b, -1), 1, pos).reshape(b, g2, 3, k)
    return torch.stack([x, y], dim=3).reshape(b, g2, 6, k)


def fused_tiles_alpha_plain(tx, ty, pages, idx, origin, tile, inv_sigma, blur_px2):
    """Plain α tiles (B, G², T²) from the bins contract (jrr_tpu
    `fused_tiles_alpha_xla`): gather through pages/idx, then the
    `_tiles_alpha_xla` math. Empty tiles gather the dump triangle (α≡0)."""
    b, g2 = pages.shape[:2]
    k = idx.shape[3]
    tri = _gather_tri(tx, ty, pages, idx).reshape(b * g2, 6, k)
    valid = tri.new_ones(b * g2, 1, k)
    alpha = sil._tiles_alpha_xla(
        origin.reshape(b * g2, 2), tri, valid, tile, inv_sigma, blur_px2
    )
    return alpha.reshape(b, g2, tile * tile)


def fused_lossgrad_plain(tx, ty, pages, idx, origin, mask_tiles, tile, inv_sigma, blur_px2):
    """(err (B,), dtx, dty): per-frame Σ(α − mask)² and its gradient w.r.t.
    the coordinate tables, by autograd through the plain α."""
    with torch.enable_grad():
        tx_ = tx.detach().requires_grad_(True)
        ty_ = ty.detach().requires_grad_(True)
        tiles = fused_tiles_alpha_plain(tx_, ty_, pages, idx, origin, tile, inv_sigma, blur_px2)
        err = torch.sum((tiles - mask_tiles) ** 2, dim=(-1, -2))
        dtx, dty = torch.autograd.grad(err.sum(), (tx_, ty_))
    return err.detach(), dtx, dty


def fused_lossgrad_packed_plain(tx, ty, pages, idx, origin, origin_b, flags, buddy, mask_tiles,
                                tile, inv_sigma, blur_px2, k_half=K_HALF):
    """(err (B,), dtx, dty) of the lane-packed layout (jrr_tpu
    `_fused_lossgrad_packed_kernel` :1192-1240 with the wrapper's rule for
    empty rows), gradients by autograd. Lanes [0, k_half) lie at `origin`,
    the rest at `origin_b`. A primary entry (flags 1) holds two tiles: each
    half's α = 1 − Π over its own lanes, held against the entry's mask and
    its buddy's; a normal entry's α is 1 − Π over all lanes; buddy entries
    (flags 2) add nothing, their primary counted them."""
    b, g2 = pages.shape[:2]
    t2 = tile * tile
    with torch.enable_grad():
        tx_ = tx.detach().requires_grad_(True)
        ty_ = ty.detach().requires_grad_(True)
        tri = _gather_tri(tx_, ty_, pages, idx)  # (B, G², 6, K)
        lane_b = torch.arange(idx.shape[3], device=tx.device) >= k_half
        org = torch.where(lane_b[:, None], origin_b[:, :, None, :], origin[:, :, None, :])
        i = torch.arange(t2, device=tx.device)
        px_x = org[:, :, None, :, 0] + (i % tile).to(tx.dtype)[:, None]  # (B, G², T², K)
        px_y = org[:, :, None, :, 1] + (i // tile).to(tx.dtype)[:, None]
        rows = tuple(tri[:, :, j, None, :] for j in range(6))
        p = coverage.coverage_rows(px_x, px_y, rows, inv_sigma=inv_sigma, blur_px2=blur_px2)[0]
        logs = torch.log(torch.clamp_min(1.0 - p, 1e-30))
        total_a = torch.exp(torch.sum(torch.where(lane_b, 0.0, logs), dim=-1))  # (B, G², T²)
        total_b = torch.exp(torch.sum(torch.where(lane_b, logs, 0.0), dim=-1))
        primary = flags == 1
        alpha_a = 1.0 - torch.where(primary[..., None], total_a, total_a * total_b)
        alpha_b = 1.0 - total_b
        mask_b = torch.gather(mask_tiles, 1, buddy.long()[..., None].expand(b, g2, t2))
        err_a = torch.sum((alpha_a - mask_tiles) ** 2, dim=-1)
        err_b = torch.sum((alpha_b - mask_b) ** 2, dim=-1)
        err_entry = err_a + torch.where(primary, err_b, 0.0)
        err = torch.sum(torch.where(flags == 2, 0.0, err_entry), dim=1)
        dtx, dty = torch.autograd.grad(err.sum(), (tx_, ty_))
    return err.detach(), dtx, dty


# ---------------------------------------------------------------------------
# Kernel wrappers: plain version for CPU tensors, CUDA kernel otherwise
# ---------------------------------------------------------------------------


class _FusedTilesAlpha(torch.autograd.Function):
    """α tiles through `kernels.fused_alpha_fwd`; the backward launches the
    α VJP kernel `kernels.fused_alpha_bwd` (dL/dα → dtx, dty; jrr_tpu
    `fused_tiles_alpha.defvjp` :978). The bins are integer inputs and the
    origin gets no gradient."""

    @staticmethod
    def forward(ctx, tx, ty, pages, idx, origin, tile, inv_sigma, blur_px2, dump_page):
        ctx.save_for_backward(tx, ty, pages, idx, origin)
        ctx.consts = (tile, inv_sigma, blur_px2, dump_page)
        return kernels.fused_alpha_fwd(tx, ty, pages, idx, origin, *ctx.consts)

    @staticmethod
    def backward(ctx, g):
        tx, ty, pages, idx, origin = ctx.saved_tensors
        dtx, dty = kernels.fused_alpha_bwd(tx, ty, pages, idx, origin, g.contiguous(), *ctx.consts)
        return (dtx, dty) + (None,) * 7


def fused_tiles_alpha(tx, ty, pages, idx, origin, tile, inv_sigma, blur_px2, dump_page):
    """α tiles (B, G², T²), differentiable in the tables; CUDA tensors
    launch the forward kernel (and, under autograd, the α VJP kernel), CPU
    tensors take the plain version."""
    if tx.device.type == "cpu":
        return fused_tiles_alpha_plain(tx, ty, pages, idx, origin, tile, inv_sigma, blur_px2)
    return _FusedTilesAlpha.apply(tx, ty, pages, idx, origin, tile, inv_sigma, blur_px2, dump_page)


def fused_lossgrad(tx, ty, pages, idx, origin, mask_tiles, tile, inv_sigma, blur_px2, dump_page):
    """(err (B,), dtx, dty); CUDA tensors launch `kernels.fused_lossgrad`,
    whose empty tiles (α≡0) add their Σmask² here (jrr_tpu :1090-1097)."""
    if tx.device.type == "cpu":
        kernels.check_mask_range(mask_tiles)  # the kernel's input contract, on every device
        return fused_lossgrad_plain(tx, ty, pages, idx, origin, mask_tiles, tile, inv_sigma, blur_px2)
    err_tile, dtx, dty = kernels.fused_lossgrad(
        tx, ty, pages, idx, origin, mask_tiles, tile, inv_sigma, blur_px2, dump_page
    )
    empty = pages[:, :, 0] == dump_page
    err_empty = torch.where(empty, torch.sum(mask_tiles * mask_tiles, dim=-1), 0.0)
    return err_tile.sum(dim=1) + err_empty.sum(dim=1), dtx, dty


class _FusedSqErr(torch.autograd.Function):
    """Per-frame Σ(α − mask)²: the forward computes the error and the table
    gradients in one pass; the backward scales them by the cotangent. The
    mask's cotangent is zero by declaration (jrr_tpu :1122-1147)."""

    @staticmethod
    def forward(ctx, tx, ty, pages, idx, origin, mask_tiles, tile, inv_sigma, blur_px2,
                dump_page):
        err, dtx, dty = fused_lossgrad(
            tx, ty, pages, idx, origin, mask_tiles, tile, inv_sigma, blur_px2, dump_page
        )
        ctx.save_for_backward(dtx, dty)
        return err

    @staticmethod
    def backward(ctx, g):
        dtx, dty = ctx.saved_tensors
        scale = g[:, None, None]
        return (scale * dtx, scale * dty) + (None,) * 8


def fused_sq_err(tx, ty, pages, idx, origin, mask_tiles, tile, inv_sigma, blur_px2, dump_page):
    return _FusedSqErr.apply(
        tx, ty, pages, idx, origin, mask_tiles, tile, inv_sigma, blur_px2, dump_page
    )


def fused_lossgrad_packed(tx, ty, pages, idx, origin, origin_b, flags, buddy, mask_tiles, tile,
                          inv_sigma, blur_px2, dump_page):
    """(err (B,), dtx, dty) of the lane-packed layout; CUDA tensors launch
    `kernels.fused_lossgrad_packed`. Kernel-empty rows add their Σmask²
    here, except buddy rows (flags 2), whose error their primary already
    counted (jrr_tpu :1301-1308)."""
    if tx.device.type == "cpu":
        kernels.check_mask_range(mask_tiles)
        return fused_lossgrad_packed_plain(tx, ty, pages, idx, origin, origin_b, flags, buddy,
                                           mask_tiles, tile, inv_sigma, blur_px2)
    err_tile, dtx, dty = kernels.fused_lossgrad_packed(
        tx, ty, pages, idx, origin, origin_b, flags, buddy, mask_tiles, tile, inv_sigma,
        blur_px2, dump_page,
    )
    empty = (pages[:, :, 0] == dump_page) & (flags != 2)
    err_empty = torch.where(empty, torch.sum(mask_tiles * mask_tiles, dim=-1), 0.0)
    return err_tile.sum(dim=1) + err_empty.sum(dim=1), dtx, dty


class _FusedSqErrPacked(torch.autograd.Function):
    """`_FusedSqErr` on the lane-packed layout (jrr_tpu `fused_sq_err_packed`
    :1311-1367): the forward computes the error and the table gradients in
    one pass, the backward scales them by the cotangent; the mask's
    cotangent is zero."""

    @staticmethod
    def forward(ctx, tx, ty, pages, idx, origin, origin_b, flags, buddy, mask_tiles, tile,
                inv_sigma, blur_px2, dump_page):
        err, dtx, dty = fused_lossgrad_packed(
            tx, ty, pages, idx, origin, origin_b, flags, buddy, mask_tiles, tile, inv_sigma,
            blur_px2, dump_page,
        )
        ctx.save_for_backward(dtx, dty)
        return err

    @staticmethod
    def backward(ctx, g):
        dtx, dty = ctx.saved_tensors
        scale = g[:, None, None]
        return (scale * dtx, scale * dty) + (None,) * 11


def fused_sq_err_packed(tx, ty, bins: FusedBins, mask_tiles, tile, inv_sigma, blur_px2, dump_page):
    """Per-frame Σ(α − mask)² through the packed fields of `bins`."""
    return _FusedSqErrPacked.apply(
        tx, ty, bins.p_pages, bins.p_idx, bins.origin, bins.p_origin_b, bins.p_flags,
        bins.p_buddy, mask_tiles, tile, inv_sigma, blur_px2, dump_page,
    )


# ---------------------------------------------------------------------------
# High-level entry points
# ---------------------------------------------------------------------------


def _prep_kernel_inputs(vertices_smpl, model, cam_t, spec, bins):
    """Bins default, identity-perm fallback, coordinate tables and the σ/blur
    pixel-space constants shared by every fused entry point."""
    if bins is None:
        bins = compute_fused_bins(vertices_smpl, model, cam_t, spec)
    verts_screen = camera_lib.project_points_screen(
        vertices_smpl, cam_t, spec.image_size, spec.focal_length
    )
    perm = model.vertex_perm
    if perm is None:
        perm = torch.arange(model.num_verts, device=vertices_smpl.device)
    tx, ty = build_tables(verts_screen, perm)
    return (bins, tx, ty) + sil.tile_constants(spec)


def silhouette_sq_err_fused(vertices_smpl, model, cam_t, mask_tiles, spec,
                            bins: Optional[FusedBins] = None) -> torch.Tensor:
    """Per-frame mean squared silhouette error (B,), one kernel pass per
    value-and-gradient, through the lane-packed layout when `bins` carries
    one (`pack_bins`). The mask is supervision: its gradient is stopped.
    Unlike jrr_tpu off the TPU, CPU tensors keep the packed layout too
    (its plain version)."""
    bins, tx, ty, inv_sigma, blur_px2 = _prep_kernel_inputs(vertices_smpl, model, cam_t, spec, bins)
    mask_tiles = mask_tiles.detach()
    consts = (spec.tile_size, inv_sigma, blur_px2, dump_page_id(model.num_verts))
    if bins.p_pages is not None:
        err = fused_sq_err_packed(tx, ty, bins, mask_tiles, *consts)
    else:
        err = fused_sq_err(tx, ty, bins.pages, bins.idx, bins.origin, mask_tiles, *consts)
    if bins.sat_tiles is not None:
        # Interior-skipped α≡1 tiles read as kernel-empty (α≡0) and so
        # contributed Σmask² instead of Σ(1−mask)²: add Σ(1 − 2m). Constant
        # w.r.t. vertices (their gradient is zero by saturation).
        err = err + torch.sum(
            torch.where(bins.sat_tiles, torch.sum(1.0 - 2.0 * mask_tiles, dim=-1), 0.0), dim=-1
        )
    return err / float(spec.image_size * spec.image_size)


def silhouette_tiles_fused(vertices_smpl, model, cam_t, spec,
                           bins: Optional[FusedBins] = None) -> torch.Tensor:
    """SMPL-frame vertices (B, V, 3) + camera (B, 3) → α tiles (B, G², T²)."""
    bins, tx, ty, inv_sigma, blur_px2 = _prep_kernel_inputs(vertices_smpl, model, cam_t, spec, bins)
    tiles = fused_tiles_alpha(
        tx, ty, bins.pages, bins.idx, bins.origin, spec.tile_size, inv_sigma, blur_px2,
        dump_page_id(model.num_verts),
    )
    if bins.sat_tiles is not None:
        # Skipped tiles read α≡0 from the kernel; their true α is saturated 1.
        tiles = torch.where(bins.sat_tiles[..., None], 1.0, tiles)
    return tiles


def image_to_tiles(img: torch.Tensor, tile: int) -> torch.Tensor:
    """(B, S, S) → (B, G², T²), the kernels' tile order."""
    b, s, _ = img.shape
    g = s // tile
    return img.reshape(b, g, tile, g, tile).permute(0, 1, 3, 2, 4).reshape(b, g * g, tile * tile)


def tiles_to_image(tiles: torch.Tensor, image_size: int, tile: int) -> torch.Tensor:
    """(B, G², T²) → (B, S, S)."""
    b = tiles.shape[0]
    g = image_size // tile
    return tiles.reshape(b, g, g, tile, tile).permute(0, 1, 3, 2, 4).reshape(b, image_size, image_size)
