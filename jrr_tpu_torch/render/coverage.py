"""Per-tile soft-coverage math shared by the plain rasterizer versions and
mirrored line for line by csrc/silhouette_fused.cu (counterpart of
jrr_tpu/render/silhouette_pallas.py:41-155).

Per edge (a, b) and pixel p:
    e = b − a, q = p − a, t = clip(q·e/‖e‖², 0, 1), r = q − t·e, d² = ‖r‖²
    ∂d²/∂a = −2(1−t)·r, ∂d²/∂b = −2t·r
Coverage p = sigmoid(−sd²/σ) inside the blur band (sd² = ∓min d², negative
inside the triangle); union α = 1 − Π(1−p), computed as exp(Σ log) with
1−p clamped to ≥ 1e-30.

`clip` is written as minimum(maximum(·)) and the edge minimum as
torch.minimum so that autograd splits the gradient at ties as JAX does
(torch.clamp passes the whole gradient at the bound).
"""

from __future__ import annotations

import torch


def _clip01(t: torch.Tensor) -> torch.Tensor:
    return torch.minimum(torch.maximum(t, t.new_zeros(())), t.new_ones(()))


def edge_terms(px_x, px_y, ax, ay, bx, by):
    """(cross, t, rx, ry, d2) for one edge; corners broadcast against pixels.
    The reciprocal of ‖e‖² depends on the corner rows only."""
    ex = bx - ax
    ey = by - ay
    qx = px_x - ax
    qy = px_y - ay
    cross = ex * qy - ey * qx
    inv_len2 = 1.0 / torch.clamp_min(ex * ex + ey * ey, 1e-12)
    t = _clip01((qx * ex + qy * ey) * inv_len2)
    rx = qx - t * ex
    ry = qy - t * ey
    return cross, t, rx, ry, rx * rx + ry * ry


# The loss kernel's cull (csrc/coverage.cuh, pixel_box): the blur radius
# grown by 2^-10 so that rounding in the edge distances never drops a pair
# with p > 0, and the area ratio below which a face counts as a sliver.
BOX_GROW = 1.0009765625  # 1 + 2^-10
SLIVER = 0.000244140625  # 2^-12


def near_box(px_x, px_y, rows, *, blur_px2: float) -> torch.Tensor:
    """Pixels the CUDA loss kernel visits for each candidate: the pixel lies
    within √blur_px2 (grown by BOX_GROW) of the face's bounding box on both
    axes, or the face is a sliver (|2·area| ≤ SLIVER·Σ|e|², NaN included),
    whose inside test can hold far from it, and covers its whole tile.

    Every (pixel, face) with p > 0 passes: outside the box the distance to
    the face exceeds the blur radius, and only a face of (near) zero area
    can be "inside" away from its box. Same broadcasting as
    `coverage_rows`; float32 ops rounded one at a time, as the kernel
    writes them, so the two agree exactly."""
    ax, ay, bx, by, cx, cy = rows
    r = torch.sqrt(torch.tensor(max(blur_px2, 0.0), dtype=torch.float32)) * torch.tensor(
        BOX_GROW, dtype=torch.float32)
    xmin, xmax = torch.fmin(torch.fmin(ax, bx), cx), torch.fmax(torch.fmax(ax, bx), cx)
    ymin, ymax = torch.fmin(torch.fmin(ay, by), cy), torch.fmax(torch.fmax(ay, by), cy)
    in_box = ((px_x - xmax <= r) & (xmin - px_x <= r)) & ((px_y - ymax <= r) & (ymin - px_y <= r))
    a2 = (bx - ax) * (cy - ay) - (by - ay) * (cx - ax)
    len2 = ((bx - ax) * (bx - ax) + (by - ay) * (by - ay)
            + (cx - bx) * (cx - bx) + (cy - by) * (cy - by)
            + (ax - cx) * (ax - cx) + (ay - cy) * (ay - cy))
    sliver = ~(a2.abs() > len2 * SLIVER)
    return in_box | sliver


def lane_prod(x: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    """Π over the last (candidate) axis as exp(Σ log x); x > 0."""
    return torch.exp(torch.sum(torch.log(x), dim=-1, keepdim=keepdim))


def coverage_rows(px_x, px_y, rows, *, inv_sigma: float, blur_px2: float):
    """rows = (ax, ay, bx, by, cx, cy) broadcastable against the pixel grids.
    Returns (p, sd2, dmin, inside, edges)."""
    ax, ay, bx, by, cx, cy = rows
    e0 = edge_terms(px_x, px_y, ax, ay, bx, by)
    e1 = edge_terms(px_x, px_y, bx, by, cx, cy)
    e2 = edge_terms(px_x, px_y, cx, cy, ax, ay)
    c0, c1, c2 = e0[0], e1[0], e2[0]
    dmin = torch.minimum(torch.minimum(e0[4], e1[4]), e2[4])
    inside = ((c0 >= 0) & (c1 >= 0) & (c2 >= 0)) | ((c0 <= 0) & (c1 <= 0) & (c2 <= 0))
    sd2 = torch.where(inside, -dmin, dmin)
    p = torch.sigmoid(-sd2 * inv_sigma)
    p = torch.where(sd2 <= blur_px2, p, torch.zeros_like(p))
    return p, sd2, dmin, inside, (e0, e1, e2)


def corner_row_grads(g, p, dmin, inside, edges, *, inv_sigma: float, total=None):
    """dL/d(ax, ay, bx, by, cx, cy) given dL/dα per pixel — the hand-derived
    backward that the CUDA loss+grad kernel runs (pass 2).

    p, dmin, inside and the edge terms are (..., T², K); g and `total`
    (= Π(1−p)) are (..., T², 1). The min-distance subgradient goes to the
    edges whose d² equals dmin exactly, split evenly at a tie. That is
    autograd's split through the nested minimum at a two-way tie; at an exact
    three-way tie autograd splits 1/4, 1/4, 1/2 and this 1/3 each. The Pallas
    kernels route to every edge within tol = 1e-4·(1+dmin) instead, a guard
    against the TPU compiler re-associating the d² arithmetic between uses.
    Each d² here is computed once, so the exact comparison is stable. At full
    width (6890 vertices) the band's even splits of near-ties put the JAX
    kernel itself beyond its kernel test's tolerance against its autodiff
    twin (tools/band_tie_witness.py); exact routing stays within it.
    Returns six (..., K) rows.
    """
    one_minus = torch.clamp_min(1.0 - p, 1e-30)
    if total is None:
        total = lane_prod(one_minus, keepdim=True)
    dl_dp = g * total / one_minus
    dl_dsd2 = dl_dp * (-inv_sigma) * p * (1.0 - p)
    dl_ddmin = torch.where(inside, -dl_dsd2, dl_dsd2)
    sel = [(e[4] <= dmin).to(p.dtype) for e in edges]
    nsel = sel[0] + sel[1] + sel[2]  # ∈ {1, 2, 3}
    inv_nsel = torch.where(nsel <= 1.0, 1.0, torch.where(nsel <= 2.0, 0.5, 1.0 / 3.0))
    route = dl_ddmin * inv_nsel
    acc = [torch.zeros_like(p[..., 0, :]) for _ in range(6)]
    ends = ((0, 2), (2, 4), (4, 0))  # corner slots per edge: (A,B), (B,C), (C,A)
    for e in range(3):
        _, te, rxe, rye, _ = edges[e]
        w = sel[e] * route * (-2.0)
        a_slot, b_slot = ends[e]
        acc[a_slot] = acc[a_slot] + torch.sum(w * (1.0 - te) * rxe, dim=-2)
        acc[a_slot + 1] = acc[a_slot + 1] + torch.sum(w * (1.0 - te) * rye, dim=-2)
        acc[b_slot] = acc[b_slot] + torch.sum(w * te * rxe, dim=-2)
        acc[b_slot + 1] = acc[b_slot + 1] + torch.sum(w * te * rye, dim=-2)
    return acc
