"""The page-workspace gather with its read-modify-write accumulation, and
take_along_axis along lanes and rows, on the card (counterpart of
tools/kernel_probe.py, rows 7 and 8 of PERF.md's kernel table).

    python -m jrr_tpu_torch.probes.kernel_probe

Inputs as the tool draws them (numpy seed 0, same order): a (56, 128)
table, per tile 8 page ids and an (8, 128) block of page_slot·128 + lane
indices, 6272 tiles (batch 8 at 224²/tile 8).
"""

from __future__ import annotations

import numpy as np
import torch

from jrr_tpu_torch import kernels, probes, resolve_device
from jrr_tpu_torch.probes import LANES, ROWS

P_HAT = 8
PAGES = 56
N_TILES = 784 * 8
REPS = 50


def make_inputs(n_tiles: int = N_TILES, seed: int = 0, device="cuda") -> dict:
    """tools/kernel_probe.py's inputs: table, pages, idx (gather), x, il,
    isub (take_along_axis on lanes and rows), in its draw order."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    arrays = dict(
        table=rng.normal(size=(PAGES, LANES)).astype(np.float32),
        pages=rng.integers(0, PAGES, size=(n_tiles, P_HAT)).astype(np.int32),
        idx=rng.integers(0, P_HAT * LANES, size=(n_tiles, ROWS, LANES)).astype(np.int32),
        x=rng.normal(size=(n_tiles, ROWS, LANES)).astype(np.float32),
        il=rng.integers(0, LANES, size=(n_tiles, ROWS, LANES)).astype(np.int32),
        isub=rng.integers(0, ROWS, size=(n_tiles, ROWS, LANES)).astype(np.int32),
    )
    return {k: torch.as_tensor(v, device=device) for k, v in arrays.items()}


def paged_gather_rmw_plain(pages, idx, table):
    """(out, dtab) of `kernels.paged_gather_rmw`: out[n, r, k] =
    table[pages[n, ps], lane] for ps = (i >> 7) mod 8, lane = i & 127,
    i = idx[n, r, k]; dtab[pages[n, p]] += 0.5·out[n, p], summed in float64
    and rounded to float32 once."""
    n = idx.shape[0]
    ws = table[pages.long()].reshape(n, P_HAT * LANES)
    flat = (((idx >> 7) & (P_HAT - 1)) * LANES + (idx & (LANES - 1))).long()
    out = torch.gather(ws, 1, flat.reshape(n, -1)).reshape(idx.shape)
    dtab = torch.zeros(table.shape, dtype=torch.float64, device=table.device)
    dtab.index_add_(0, pages.long().reshape(-1), 0.5 * out[:, :P_HAT].double().reshape(-1, LANES))
    return out, dtab.float()


def take_along_axis_plain(x, index, axis: int):
    """`np.take_along_axis(x, index, axis)` with indices taken modulo the
    axis length, as `kernels.take_along_axis`."""
    return torch.gather(x, axis, (index & (x.shape[axis] - 1)).long())


def fixed_point_tolerance(want, terms):
    """Per-element bound on |fixed-point sum − float64 sum rounded to f32|:
    each of `terms` adds rounds to the 2^-32 grid (≤ 2^-33), and both round
    the total to float32 once (≤ one ulp between them)."""
    return terms * 2.0**-33 + want.abs() * 2.0**-23 + 2.0**-149


def measure(n_tiles: int = N_TILES, reps: int = REPS) -> list:
    x = make_inputs(n_tiles, device="cuda")
    n = n_tiles
    block = n * ROWS * LANES * 4  # bytes of one (N, 8, 128) f32 or i32 array
    table_bytes = PAGES * LANES * 4

    out, dtab = kernels.paged_gather_rmw(x["pages"], x["idx"], x["table"])
    out_p, dtab_p = paged_gather_rmw_plain(x["pages"], x["idx"], x["table"])
    torch.cuda.synchronize()
    if not torch.equal(out, out_p):
        raise AssertionError("paged_gather_rmw: gathered rows differ from the plain version")
    terms = torch.bincount(x["pages"].long().reshape(-1), minlength=PAGES)[:, None].double()
    rec = probes.record(
        "paged_gather_rmw", "tools/kernel_probe.py:43", dtab, dtab_p,
        fixed_point_tolerance(dtab_p.double(), terms),
        "gather exact; dtab within terms·2^-33 + 1 f32 ulp (int64 fixed point vs float64)",
        probes.time_ms(lambda: kernels.paged_gather_rmw(x["pages"], x["idx"], x["table"]), reps),
        probes.time_ms(lambda: paged_gather_rmw_plain(x["pages"], x["idx"], x["table"]), 3),
        probes.bound(n * P_HAT * 4 + 2 * block + 2 * table_bytes, 2 * n * P_HAT * LANES),
        None, None,
    )
    records = [rec]

    for axis, index, name in ((2, x["il"], "take_along_axis_lane"), (1, x["isub"], "take_along_axis_sublane")):
        got = kernels.take_along_axis(x["x"], index, axis)
        want = take_along_axis_plain(x["x"], index, axis)
        index64 = index.long()
        records.append(probes.record(
            name, "tools/kernel_probe.py:107", got, want, 0.0, "exact",
            probes.time_ms(lambda: kernels.take_along_axis(x["x"], index, axis), reps),
            probes.time_ms(lambda: take_along_axis_plain(x["x"], index, axis), reps),
            probes.bound(3 * block, 0), "torch.gather",
            probes.time_ms(lambda: torch.gather(x["x"], axis, index64), reps),
        ))
    return records


def main() -> None:
    probes.run(measure)


if __name__ == "__main__":
    main()
