"""The probes' plain versions (jrr_tpu_torch/probes/) on the CPU against the
Pallas probe bodies of tools/ run in interpret mode (rows 7, 8 and 10 of
PERF.md's kernel table) and against the numpy statements of
tools/kernel_probe2.py (row 9, whose kernels are local to its main()), at
16 tiles. Gathers, selects and the elementwise anchor are exact; sums of
many terms within float32 rounding of a float64 sum (stated per test)."""

import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from jrr_tpu_torch import kernels
from jrr_tpu_torch.probes import bf16_probe, kernel_probe, kernel_probe2

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools"))
import bf16_vpu_probe  # noqa: E402
import kernel_probe as jax_probe  # noqa: E402

N = 16
CHUNK = 8
LANES = 128


def _np(d):
    return {k: v.numpy() for k, v in d.items()}


def test_paged_gather_rmw_matches_interpret_kernel():
    x = kernel_probe.make_inputs(N, device="cpu")
    a = _np(x)
    # tools/kernel_probe.py::run_gather's specs, in interpret mode.
    out, dtab = pl.pallas_call(
        functools.partial(jax_probe.gather_kernel, chunk=CHUNK),
        grid=(N // CHUNK,),
        in_specs=[
            pl.BlockSpec((CHUNK, jax_probe.P_HAT), lambda i: (i, 0), memory_space=pltpu.SMEM),
            pl.BlockSpec((CHUNK, 8, LANES), lambda i: (i, 0, 0), memory_space=pltpu.VMEM),
            pl.BlockSpec((jax_probe.PAGES, LANES), lambda i: (0, 0), memory_space=pltpu.VMEM),
        ],
        out_specs=(
            pl.BlockSpec((CHUNK, 8, LANES), lambda i: (i, 0, 0), memory_space=pltpu.VMEM),
            pl.BlockSpec((jax_probe.PAGES, LANES), lambda i: (0, 0), memory_space=pltpu.VMEM),
        ),
        out_shape=(
            jax.ShapeDtypeStruct((N, 8, LANES), jnp.float32),
            jax.ShapeDtypeStruct((jax_probe.PAGES, LANES), jnp.float32),
        ),
        interpret=True,
    )(a["pages"], a["idx"], a["table"])
    got_out, got_dtab = kernel_probe.paged_gather_rmw_plain(x["pages"], x["idx"], x["table"])
    np.testing.assert_array_equal(got_out.numpy(), np.asarray(out))
    # The Pallas body adds in float32 in grid order, the plain version in
    # float64: at most 2·8·N/56 terms per entry, so a few float32 ulps.
    np.testing.assert_allclose(got_dtab.numpy(), np.asarray(dtab), rtol=1e-5, atol=1e-6)
    assert np.abs(np.asarray(dtab)).max() > 0.1


@pytest.mark.parametrize("axis", [2, 1], ids=["lane", "sublane"])
def test_take_along_axis_matches_interpret_kernel(axis):
    x = kernel_probe.make_inputs(N, device="cpu")
    index = x["il"] if axis == 2 else x["isub"]
    spec = pl.BlockSpec((CHUNK, 8, LANES), lambda i: (i, 0, 0), memory_space=pltpu.VMEM)
    want = pl.pallas_call(
        # The body gathers along an axis of its (8, 128) block: lanes are
        # block axis 1 and rows block axis 0 (the array's axes 2 and 1).
        functools.partial(jax_probe.taa_kernel, chunk=CHUNK, axis=axis - 1),
        grid=(N // CHUNK,), in_specs=[spec, spec], out_specs=spec,
        out_shape=jax.ShapeDtypeStruct((N, 8, LANES), jnp.float32), interpret=True,
    )(index.numpy(), x["x"].numpy())
    got = kernel_probe.take_along_axis_plain(x["x"], index, axis)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), np.take_along_axis(x["x"].numpy(), index.numpy(), axis))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fma_chain_matches_interpret_kernel(dtype):
    rows, grid = 8, 2
    x = bf16_probe.make_input(rows * grid, device="cpu")
    want = np.asarray(pl.pallas_call(
        functools.partial(bf16_vpu_probe._kernel, reps=bf16_vpu_probe.REPS, dtype=getattr(jnp, dtype)),
        grid=(grid,),
        in_specs=[pl.BlockSpec((rows, LANES), lambda i: (i, 0), memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((rows, LANES), lambda i: (i, 0), memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((rows * grid, LANES), jnp.float32), interpret=True,
    )(x.numpy()))
    tdtype = getattr(torch, dtype)
    fused, two_step = (bf16_probe.fma_chain_plain(x, bf16_vpu_probe.REPS, tdtype, f).numpy()
                       for f in (True, False))
    if dtype == "float32":
        # XLA's CPU backend may contract the multiply-add into one FMA; the
        # result is exactly one of the two roundings.
        assert np.array_equal(fused, want) or np.array_equal(two_step, want)
    else:
        # In bf16 c1 rounds to 1 and c2 is a power of two, so every product is
        # exact: one rounding per step (the card's kernels) and two agree.
        np.testing.assert_array_equal(two_step, want)
        np.testing.assert_array_equal(fused, want)


def test_probe2_plain_versions_match_numpy():
    x = kernel_probe2.make_inputs(N, device="cpu")
    a = _np(x)
    t, p, xs, il, isub = a["table"], a["pages"], a["x"], a["il"], a["isub"]
    # The tool's oracles (tools/kernel_probe2.py:86, :126, :142).
    np.testing.assert_array_equal(kernel_probe2.dyn_slice_plain(x["pages"], x["table"]).numpy(), t[p])
    np.testing.assert_array_equal(kernel_probe.take_along_axis_plain(x["x"], x["il"], 2).numpy(),
                                  np.take_along_axis(xs, il, axis=2))
    np.testing.assert_array_equal(kernel_probe.take_along_axis_plain(x["x"], x["isub"], 1).numpy(),
                                  np.take_along_axis(xs, isub, axis=1))
    # B: the one-hot product, exact (one nonzero term).
    onehot = (np.arange(LANES)[:, None] == il[:, :, None, :]).astype(np.float32)
    np.testing.assert_array_equal(kernel_probe2.onehot_gather_plain(x["x"], x["il"]).numpy(),
                                  np.einsum("nrl,nrlk->nrk", xs, onehot))
    # D: select-reduce over the 8 rows.
    sel = np.arange(8)[None, None, :, None] == isub[:, :, None, :]
    np.testing.assert_array_equal(kernel_probe2.select_reduce_plain(x["x"], x["isub"]).numpy(),
                                  np.where(sel, xs[:, None], 0.0).sum(axis=2).astype(np.float32))
    # E: read-modify-write at dynamic rows, float64 sums rounded once.
    want = np.zeros((kernel_probe2.PAGES, LANES))
    np.add.at(want, p.reshape(-1), xs.reshape(-1, LANES).astype(np.float64))
    np.testing.assert_array_equal(kernel_probe2.rmw_rows_plain(x["pages"], x["x"], kernel_probe2.PAGES).numpy(),
                                  want.astype(np.float32))
    # F: the elementwise anchor.
    np.testing.assert_array_equal(kernel_probe2.elementwise_plain(x["x"]).numpy(), xs * 2.0 + 1.0)


def test_fixed_point_tolerance_covers_the_quantization():
    """int64 fixed point (·2^32) against the float64 sum: within the bound
    the probes check, for the probe's magnitudes."""
    rng = np.random.default_rng(1)
    terms = rng.normal(size=(400, 64)).astype(np.float32)
    fixed = np.rint(terms.astype(np.float64) * 2.0**32).astype(np.int64).sum(axis=0)
    got = torch.as_tensor((fixed.astype(np.float32) * np.float32(2.0**-32)))
    want = torch.as_tensor(terms.astype(np.float64).sum(axis=0)).float()
    tol = kernel_probe.fixed_point_tolerance(want.double(), 400)
    assert bool(torch.all((got.double() - want.double()).abs() <= tol))


def test_rmw_rows_fixed_plain_matches_int64_oracle():
    """E as the kernel computes it: `rmw_rows_fixed_plain` equals a numpy
    int64 oracle exactly (each term x·2^32 rounded half to even, as
    llrintf), and as float32 lies within `fixed_point_tolerance` of the
    float64 `rmw_rows_plain`."""
    x = kernel_probe2.make_inputs(N, device="cpu")
    pages, xs, rows = x["pages"], x["x"], kernel_probe2.PAGES
    got = kernel_probe2.rmw_rows_fixed_plain(pages, xs, rows)
    q = np.rint(xs.numpy().astype(np.float64) * 2.0**32).astype(np.int64)
    want = np.zeros((rows, LANES), np.int64)
    np.add.at(want, pages.numpy().reshape(-1), q.reshape(-1, LANES))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    terms = torch.bincount(pages.long().reshape(-1), minlength=rows)[:, None].double()
    want64 = kernel_probe2.rmw_rows_plain(pages, xs, rows).double()
    diff = (kernels.from_fixed_point(got).double() - want64).abs()
    assert bool(torch.all(diff <= kernel_probe.fixed_point_tolerance(want64, terms)))

    # Terms on a rounding tie go to the even integer, as llrintf does.
    ties = torch.zeros(1, 8, LANES)
    ties[0, 0, :5] = torch.tensor([0.5, -0.5, 1.5, -1.5, 2.5]) * 2.0**-32
    one = kernel_probe2.rmw_rows_fixed_plain(torch.arange(8, dtype=torch.int32)[None], ties, 8)
    assert one[0, :5].tolist() == [0, 0, 2, -2, 2]
