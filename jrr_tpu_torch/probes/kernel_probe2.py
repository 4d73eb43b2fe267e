"""Each fused-rasterizer primitive alone, on the card (counterpart of
tools/kernel_probe2.py, row 9 of PERF.md's kernel table):

    A  rows of a resident table at dynamic row ids      table[pages]
    B  the lane gather the TPU computes as a one-hot product (a gather here)
    C  take_along_axis on lanes (B's kernel), C2 on rows (row 8's kernels)
    D  select-reduce over the 8 rows
    E  read-modify-write at dynamic rows                (int64 fixed point)
    F  the elementwise anchor 2x + 1

    python -m jrr_tpu_torch.probes.kernel_probe2

Inputs as the tool draws them (numpy seed 0, same order), 6272 tiles.
"""

from __future__ import annotations

import numpy as np
import torch

from jrr_tpu_torch import kernels, probes, resolve_device
from jrr_tpu_torch.probes import LANES, ROWS
from jrr_tpu_torch.probes.kernel_probe import fixed_point_tolerance, take_along_axis_plain

PAGES = 56
N_TILES = 784 * 8
REPS = 50
_ONEHOT_TILES = 256  # tiles per step of the one-hot plain version (its (n, 8, 128, 128) product)


def make_inputs(n_tiles: int = N_TILES, seed: int = 0, device="cuda") -> dict:
    """tools/kernel_probe2.py's inputs in its draw order: table, pages, x,
    il (lane indices), isub (row indices)."""
    device = resolve_device(device)
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


def rmw_rows_fixed_plain(pages, x, rows: int):
    """E as the kernel computes it: each term quantized to int64 fixed point
    (x·2³², rounded half to even as llrintf), summed exactly; the kernel's
    own integers."""
    q = torch.round(x.float() * 2.0**32).long()
    out = torch.zeros(rows, LANES, dtype=torch.int64, device=x.device)
    out.index_add_(0, pages.long().reshape(-1), q.reshape(-1, LANES))
    return out


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

    def add(name, entry, line, kernel, plain, tolerance, tolerance_text, bound, library=None,
            library_fn=None):
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        records.append(probes.record(
            name, entry, src + line, got, want, tolerance, tolerance_text, time(kernel, reps),
            time(plain, 3), bound, library, None if library_fn is None else time(library_fn, reps),
        ))
        return got

    pages64, il64, isub64 = pages.long(), il.long(), isub.long()
    out_a = add("A_dyn_sublane_slice", "dyn_slice_kernel", "73",
                lambda: kernels.dyn_slice(pages, table), lambda: dyn_slice_plain(pages, table), 0.0,
                "exact", probes.bound(pages_bytes + table_bytes + block, 0), "table[pages]",
                lambda: table[pages64])
    # What writing the same bytes costs on this card: the floor under the
    # bytes bound. Both also with the L2 cold (see probes.time_cold_ms).
    records[-1].update(
        write_ms=time(lambda: out_a.zero_(), reps),
        cold_ms=probes.time_cold_ms(lambda: kernels.dyn_slice(pages, table), reps),
        write_cold_ms=probes.time_cold_ms(lambda: out_a.zero_(), reps))

    # B's function is the lane gather: its bound counts the bytes (x, il
    # read, out written); the TPU's one-hot product, 128 FMAs per output, is
    # work no kernel here does, kept as onehot_ops_bound_ms.
    add("B_onehot_matmul", "lane_gather_kernel", "90", lambda: kernels.onehot_gather(xs, il),
        lambda: onehot_gather_plain(xs, il), 0.0, "exact (one nonzero term per sum)",
        probes.bound(3 * block, 0), "torch.gather", lambda: torch.gather(xs, 2, il64))
    records[-1].update(
        onehot_ops_bound_ms=probes.bound(0, 2 * n * ROWS * LANES * LANES)[0],
        cold_ms=probes.time_cold_ms(lambda: kernels.onehot_gather(xs, il), reps))

    for name, entry, line, index, axis, index64 in (
            ("C_taa_lane", "lane_gather_kernel", "114", il, 2, il64),
            ("C2_taa_sublane", "row_gather_kernel", "130", isub, 1, isub64)):
        add(name, entry, line,
            lambda: kernels.take_along_axis(xs, index, axis),
            lambda: take_along_axis_plain(xs, index, axis), 0.0, "exact",
            probes.bound(3 * block, 0), "torch.gather", lambda: torch.gather(xs, axis, index64))

    add("D_select_reduce", "select_reduce_kernel", "146", lambda: kernels.select_reduce(xs, isub),
        lambda: select_reduce_plain(xs, isub), 0.0, "exact (the other terms add zero)",
        probes.bound(3 * block, n * ROWS * LANES * ROWS), "torch.gather",
        lambda: torch.gather(xs, 1, isub64))

    # E: the kernel's int64 table equals its fixed-point plain version
    # exactly, and in float32 lies within the quantization of the float64 sum.
    got_e = kernels.rmw_rows(pages, xs, PAGES)
    want_e = rmw_rows_fixed_plain(pages, xs, PAGES)
    torch.cuda.synchronize()
    if not torch.equal(got_e, want_e):
        raise AssertionError("E_rmw_dynamic_rows: int64 sums differ from rmw_rows_fixed_plain's")
    want_f64 = rmw_rows_plain(pages, xs, PAGES).double()
    terms = torch.bincount(pages64.reshape(-1), minlength=PAGES)[:, None].double()
    f64_diff = (kernels.from_fixed_point(got_e).double() - want_f64).abs()
    if not bool(torch.all(f64_diff <= fixed_point_tolerance(want_f64, terms))):
        raise AssertionError("E_rmw_dynamic_rows: beyond terms·2^-33 + 1 f32 ulp of the float64 sum")
    acc = torch.zeros(PAGES, LANES, device=xs.device)
    rec = probes.record(
        "E_rmw_dynamic_rows", "rmw_rows_kernel", src + "170", got_e, want_e, 0.0,
        "int64 sums equal rmw_rows_fixed_plain's exactly; as float32 within terms·2^-33 + 1 f32 ulp "
        "of the float64 sum (rmw_rows_plain)",
        time(lambda: kernels.rmw_rows(pages, xs, PAGES), reps),
        time(lambda: rmw_rows_fixed_plain(pages, xs, PAGES), 3),
        probes.bound(pages_bytes + block + table_bytes * 2, n * ROWS * LANES), "index_add_",
        time(lambda: acc.index_add_(0, pages64.reshape(-1), xs.reshape(-1, LANES)), reps),
    )
    # What reading x alone costs on this card: the floor under the bytes bound.
    rec.update(exact_vs_fixed_plain=True, float64_max_abs_err=float(f64_diff.max()),
               faster_than_library=rec["ms"] < rec["library_ms"],
               read_x_ms=time(lambda: xs.sum(), reps))
    records.append(rec)

    one = torch.ones((), device=xs.device)
    add("F_elementwise_baseline", "elementwise_kernel", "191", lambda: kernels.elementwise_baseline(xs),
        lambda: elementwise_plain(xs), 0.0, "exact (2x is exact, one rounding)",
        probes.bound(2 * block, 2 * n * ROWS * LANES), "torch.add(1, x, alpha=2)",
        lambda: torch.add(one, xs, alpha=2.0))
    return records


def main() -> None:
    probes.run(measure)


if __name__ == "__main__":
    main()
