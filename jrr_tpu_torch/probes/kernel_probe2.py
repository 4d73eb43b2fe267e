"""Each fused-rasterizer primitive alone, on the card (counterpart of
tools/kernel_probe2.py, row 9 of PERF.md's kernel table):

    A  rows of a resident table at dynamic row ids      table[pages]
    B  the lane gather as a one-hot product, in f32 FMAs
    C  take_along_axis on lanes, C2 on rows             (row 8's kernel)
    D  select-reduce over the 8 rows
    E  read-modify-write at dynamic rows                (int64 fixed point)
    F  the elementwise anchor 2x + 1

    python -m jrr_tpu_torch.probes.kernel_probe2

Inputs as the tool draws them (numpy seed 0, same order), 6272 tiles.
"""

from __future__ import annotations

import numpy as np
import torch

from jrr_tpu_torch import kernels
from jrr_tpu_torch import probes
from jrr_tpu_torch.probes import LANES, ROWS
from jrr_tpu_torch.probes.kernel_probe import fixed_point_tolerance, take_along_axis_plain

PAGES = 56
N_TILES = 784 * 8
REPS = 50
_ONEHOT_TILES = 256  # tiles per step of the one-hot plain version (its (n, 8, 128, 128) product)


def make_inputs(n_tiles: int = N_TILES, seed: int = 0, device="cpu") -> dict:
    """tools/kernel_probe2.py's inputs in its draw order: table, pages, x,
    il (lane indices), isub (row indices)."""
    rng = np.random.default_rng(seed)
    arrays = dict(
        table=rng.normal(size=(PAGES, LANES)).astype(np.float32),
        pages=rng.integers(0, PAGES, size=(n_tiles, ROWS)).astype(np.int32),
        x=rng.normal(size=(n_tiles, ROWS, LANES)).astype(np.float32),
        il=rng.integers(0, LANES, size=(n_tiles, ROWS, LANES)).astype(np.int32),
        isub=rng.integers(0, ROWS, size=(n_tiles, ROWS, LANES)).astype(np.int32),
    )
    return {k: torch.as_tensor(v, device=device) for k, v in arrays.items()}


def dyn_slice_plain(pages, table):
    """A: out[n, p] = table[pages[n, p]]."""
    return table[pages.long()]


def _onehot(il):
    """(…, 8, 128) lane ids → (…, 8, 128 l, 128 k) f32 one-hot M[l, k] = (l == il[k])."""
    lanes = torch.arange(LANES, device=il.device)
    return (lanes[:, None] == il[..., None, :]).float()


def onehot_gather_plain(x, il):
    """B: out[n, r, k] = Σ_l x[n, r, l]·(l == il[n, r, k]), the one-hot
    product the Pallas probe ran on the matrix unit; `_ONEHOT_TILES` tiles
    at a time."""
    parts = [
        torch.sum(x[lo:lo + _ONEHOT_TILES, :, :, None] * _onehot(il[lo:lo + _ONEHOT_TILES]), dim=2)
        for lo in range(0, x.shape[0], _ONEHOT_TILES)
    ]
    return torch.cat(parts)


def select_reduce_plain(x, isub):
    """D: out[n, r, k] = Σ_s (s == isub[n, r, k])·x[n, s, k]."""
    rows = torch.arange(ROWS, device=x.device)[:, None]
    return torch.sum(torch.where(rows == isub[:, :, None, :], x[:, None], 0.0), dim=2)


def rmw_rows_plain(pages, x, rows: int):
    """E: out[pages[n, p]] += x[n, p] over every tile and p, summed in
    float64 and rounded to float32 once."""
    out = torch.zeros(rows, LANES, dtype=torch.float64, device=x.device)
    out.index_add_(0, pages.long().reshape(-1), x.double().reshape(-1, LANES))
    return out.float()


def elementwise_plain(x):
    """F: 2x + 1."""
    return x * 2.0 + 1.0


def measure(n_tiles: int = N_TILES, reps: int = REPS) -> list:
    x = make_inputs(n_tiles, device="cuda")
    pages, table, xs, il, isub = x["pages"], x["table"], x["x"], x["il"], x["isub"]
    n = n_tiles
    block = n * ROWS * LANES * 4  # bytes of one (N, 8, 128) array
    table_bytes, pages_bytes = PAGES * LANES * 4, n * ROWS * 4
    src = "tools/kernel_probe2.py:"
    time = probes.time_ms
    records = []

    def add(name, line, kernel, plain, tolerance, tolerance_text, bound, library=None, library_fn=None):
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        records.append(probes.record(
            name, src + line, got, want, tolerance, tolerance_text, time(kernel, reps),
            time(plain, 3), bound, library, None if library_fn is None else time(library_fn, reps),
        ))

    pages64, il64, isub64 = pages.long(), il.long(), isub.long()
    add("A_dyn_sublane_slice", "73", lambda: kernels.dyn_slice(pages, table),
        lambda: dyn_slice_plain(pages, table), 0.0, "exact",
        probes.bound(pages_bytes + table_bytes + block, 0), "table[pages]", lambda: table[pages64])

    onehot = _onehot(il).reshape(n * ROWS, LANES, LANES)  # 3.3 GB: the library call's operand
    x_rows = xs.reshape(n * ROWS, 1, LANES)
    add("B_onehot_matmul", "90", lambda: kernels.onehot_gather(xs, il),
        lambda: onehot_gather_plain(xs, il), 0.0, "exact (one nonzero term per sum)",
        probes.bound(3 * block, 2 * n * ROWS * LANES * LANES), "torch.bmm with the one-hot matrix",
        lambda: torch.bmm(x_rows, onehot))
    del onehot

    for name, line, index, axis, index64 in (("C_taa_lane", "114", il, 2, il64),
                                             ("C2_taa_sublane", "130", isub, 1, isub64)):
        add(name, line, lambda: kernels.take_along_axis(xs, index, axis),
            lambda: take_along_axis_plain(xs, index, axis), 0.0, "exact",
            probes.bound(3 * block, 0), "torch.gather", lambda: torch.gather(xs, axis, index64))

    add("D_select_reduce", "146", lambda: kernels.select_reduce(xs, isub),
        lambda: select_reduce_plain(xs, isub), 0.0, "exact (the other terms add zero)",
        probes.bound(3 * block, n * ROWS * LANES * ROWS), "torch.gather",
        lambda: torch.gather(xs, 1, isub64))

    terms = torch.bincount(pages64.reshape(-1), minlength=PAGES)[:, None].double()
    want_e = rmw_rows_plain(pages, xs, PAGES)
    acc = torch.zeros(PAGES, LANES, device=xs.device)
    add("E_rmw_dynamic_rows", "170", lambda: kernels.rmw_rows(pages, xs, PAGES),
        lambda: rmw_rows_plain(pages, xs, PAGES), fixed_point_tolerance(want_e.double(), terms),
        "terms·2^-33 + 1 f32 ulp (int64 fixed point vs float64)",
        probes.bound(pages_bytes + block + table_bytes, n * ROWS * LANES), "index_add_",
        lambda: acc.index_add_(0, pages64.reshape(-1), xs.reshape(-1, LANES)))

    one = torch.ones((), device=xs.device)
    add("F_elementwise_baseline", "191", lambda: kernels.elementwise_baseline(xs),
        lambda: elementwise_plain(xs), 0.0, "exact (2x is exact, one rounding)",
        probes.bound(2 * block, 2 * n * ROWS * LANES), "torch.add(1, x, alpha=2)",
        lambda: torch.add(one, xs, alpha=2.0))
    return records


def main() -> None:
    probes.run(measure)


if __name__ == "__main__":
    main()
