"""Plain soft silhouette (the method's pytorch3d SoftSilhouetteShader,
scripts/mesh_renderer.py:23-79) and its exact gradient.

Per pixel centre p (integer coordinates) and face (a, b, c) on the screen:
the squared distance d² from p to the triangle's nearest edge, signed
negative where p lies inside; coverage sigmoid(-sd²/σ) where sd² is within
the blur band and 0 beyond it; the silhouette α = 1 - Π(1 - coverage),
with 1 - coverage kept at 1e-30 or above. σ and the band come in NDC² and
are scaled to pixel² by (S/2)².

A face's coverage is 0 wherever p is farther than √band from its bounding
box, so each face is evaluated over the pixels of its box grown by √band:
faces are grouped by the size of that window and each group evaluated over
a square window of that size, in chunks of pairs. The gradient of the
per-frame loss Σ(α - m)²/S² is the chain rule written out once: dα/d log(1 -
coverage) = -(1 - α), then autograd from each pair's log(1 - coverage) to
its corners, chunk by chunk.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

# Window sizes (pixels a side) faces are grouped by.
_SIZES = (2, 3, 4, 5, 6, 8, 10, 12, 16, 20, 24, 32, 48, 64, 96, 128, 192, 256, 384, 512)
# (pixel, face) pairs evaluated at once.
_CHUNK_PAIRS = 1 << 24


class Spec(NamedTuple):
    size: int  # image side, pixels
    inv_sigma: float  # 1/σ in 1/pixel²
    band: float  # blur band, pixel²


def spec(size: int, sigma_ndc2: float, blur_ndc2: float) -> Spec:
    scale = (size / 2.0) ** 2
    return Spec(size, 1.0 / (sigma_ndc2 * scale), blur_ndc2 * scale)


def _edge(px, py, ax, ay, bx, by):
    ex, ey = bx - ax, by - ay
    qx, qy = px - ax, py - ay
    cross = ex * qy - ey * qx
    t = (qx * ex + qy * ey) / torch.clamp_min(ex * ex + ey * ey, 1e-12)
    t = torch.clamp(t, 0.0, 1.0)
    rx, ry = qx - t * ex, qy - t * ey
    return cross, rx * rx + ry * ry


def coverage(px, py, corners, sp: Spec) -> torch.Tensor:
    """Coverage of faces `corners` (N, 6) [ax ay bx by cx cy] at pixels
    px, py (N, W²)."""
    ax, ay, bx, by, cx, cy = (corners[:, i:i + 1] for i in range(6))
    c0, d0 = _edge(px, py, ax, ay, bx, by)
    c1, d1 = _edge(px, py, bx, by, cx, cy)
    c2, d2 = _edge(px, py, cx, cy, ax, ay)
    dmin = torch.minimum(torch.minimum(d0, d1), d2)
    inside = ((c0 >= 0) & (c1 >= 0) & (c2 >= 0)) | ((c0 <= 0) & (c1 <= 0) & (c2 <= 0))
    sd2 = torch.where(inside, -dmin, dmin)
    p = torch.sigmoid(-sd2 * sp.inv_sigma)
    return torch.where(sd2 <= sp.band, p, torch.zeros_like(p))


class _Windows(NamedTuple):
    frame: torch.Tensor  # (N,) frame of each face window
    face: torch.Tensor  # (N,) face index
    x0: torch.Tensor  # (N,) first pixel column
    y0: torch.Tensor
    nx: torch.Tensor  # (N,) columns in the window
    ny: torch.Tensor
    side: int  # the group's square window side


def _windows(xy: torch.Tensor, faces: torch.Tensor, sp: Spec):
    """Face windows grouped by size: a list of `_Windows`."""
    with torch.no_grad():
        tri = xy[:, faces]  # (B, F, 3, 2)
        lo = tri.amin(dim=2)
        hi = tri.amax(dim=2)
        r = sp.band ** 0.5 if sp.band > 0 else 0.0
        first = torch.clamp(torch.ceil(lo - r), min=0)
        last = torch.clamp(torch.floor(hi + r), max=sp.size - 1)
        count = (last - first + 1).to(torch.int64)  # (B, F, 2)
        ok = (count > 0).all(dim=-1) & torch.isfinite(tri).all(dim=(2, 3))
        side = count.amax(dim=-1)
        sizes = torch.tensor(_SIZES, device=xy.device)
        group = torch.searchsorted(sizes, side.clamp(min=1))
        first = first.to(torch.int64)
        out = []
        for g in torch.unique(group[ok]).tolist():
            frame, face = torch.nonzero(ok & (group == g), as_tuple=True)
            n = int(_SIZES[g])
            out.append(_Windows(frame, face, first[frame, face, 0], first[frame, face, 1],
                                count[frame, face, 0], count[frame, face, 1], n))
        return out


def _pairs(xy, faces, w: _Windows, lo: int, hi: int, sp: Spec):
    """(flat pixel index (n, W²), valid (n, W²), coverage (n, W²)) of the
    windows lo:hi of one group; coverage is differentiable in `xy`."""
    n = w.side
    frame, face = w.frame[lo:hi], w.face[lo:hi]
    corners = xy[frame[:, None], faces[face]].reshape(-1, 6)  # (n, 6)
    i = torch.arange(n * n, device=xy.device)
    dx, dy = (i % n)[None, :], (i // n)[None, :]
    valid = (dx < w.nx[lo:hi, None]) & (dy < w.ny[lo:hi, None])
    px = (w.x0[lo:hi, None] + dx).clamp(max=sp.size - 1)
    py = (w.y0[lo:hi, None] + dy).clamp(max=sp.size - 1)
    flat = (frame[:, None] * sp.size + py) * sp.size + px
    p = coverage(px.to(xy.dtype), py.to(xy.dtype), corners, sp)
    return flat, valid, p


def _chunks(windows):
    for w in windows:
        step = max(1, _CHUNK_PAIRS // (w.side * w.side))
        for lo in range(0, w.frame.shape[0], step):
            yield w, lo, min(lo + step, w.frame.shape[0])


def log_transmittance(xy: torch.Tensor, faces: torch.Tensor, sp: Spec, windows=None):
    """Σ over faces of log(max(1 - coverage, 1e-30)) per pixel, (B, S, S), no gradient."""
    b = xy.shape[0]
    acc = torch.zeros(b * sp.size * sp.size, dtype=xy.dtype, device=xy.device)
    windows = _windows(xy, faces, sp) if windows is None else windows
    with torch.no_grad():
        for w, lo, hi in _chunks(windows):
            flat, valid, p = _pairs(xy, faces, w, lo, hi, sp)
            logs = torch.log(torch.clamp_min(1.0 - p, 1e-30))
            acc.index_add_(0, flat[valid], logs[valid])
    return acc.reshape(b, sp.size, sp.size)


def alpha(xy: torch.Tensor, faces: torch.Tensor, sp: Spec) -> torch.Tensor:
    """The soft silhouette (B, S, S) of screen vertices xy (B, V, 2)."""
    return 1.0 - torch.exp(log_transmittance(xy, faces, sp))


def loss_and_grad(xy: torch.Tensor, faces: torch.Tensor, mask: torch.Tensor, sp: Spec):
    """(per-frame Σ(α - mask)²/S² (B,), its gradient in xy (B, V, 2) for
    the loss summed over frames)."""
    xy = xy.detach()
    windows = _windows(xy, faces, sp)
    log_t = log_transmittance(xy, faces, sp, windows)
    a = 1.0 - torch.exp(log_t)
    s2 = float(sp.size * sp.size)
    loss = ((a - mask) ** 2).sum(dim=(1, 2)) / s2
    # dL/d log(1 - coverage) of each pair = dL/dα · dα/d log(1 - coverage).
    upstream = (2.0 * (a - mask) / s2 * -(1.0 - a)).reshape(-1)
    grad = torch.zeros_like(xy)
    for w, lo, hi in _chunks(windows):
        with torch.enable_grad():
            leaf = xy.detach().requires_grad_(True)
            flat, valid, p = _pairs(leaf, faces, w, lo, hi, sp)
            logs = torch.log(torch.clamp_min(1.0 - p, 1e-30))
            weight = torch.where(valid, upstream[flat], torch.zeros_like(logs))
            (g,) = torch.autograd.grad((logs * weight).sum(), [leaf])
        grad += g
    return loss, grad

