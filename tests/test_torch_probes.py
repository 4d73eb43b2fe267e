"""The probes' plain versions (jrr_tpu_torch/probes/) on the CPU against the
Pallas probe bodies of tools/ run in interpret mode (rows 7, 8 and 10 of
PERF.md's kernel table, and row 9's A and B, whose bodies are local to
tools/kernel_probe2.py's main() and copied here) and against the numpy
statements of tools/kernel_probe2.py (row 9), at 16 tiles. Gathers, selects
and the elementwise anchor are exact; sums of many terms within float32
rounding of a float64 sum (stated per test)."""

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


def _interpret_gather(a):
    """(out, dtab) of tools/kernel_probe.py::gather_kernel with run_gather's
    specs, in interpret mode, on numpy inputs `a`."""
    return pl.pallas_call(
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


def test_paged_gather_rmw_matches_interpret_kernel():
    x = kernel_probe.make_inputs(N, device="cpu")
    out, dtab = _interpret_gather(_np(x))
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


@pytest.mark.parametrize("reps", bf16_probe.SWEEP_REPS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fma_chain_matches_interpret_kernel(dtype, reps):
    """At the probe's length and every length the sweep times."""
    assert bf16_probe.REPS == bf16_vpu_probe.REPS and bf16_probe.REPS in bf16_probe.SWEEP_REPS
    rows, grid = 8, 2
    x = bf16_probe.make_input(rows * grid, device="cpu")
    want = np.asarray(pl.pallas_call(
        functools.partial(bf16_vpu_probe._kernel, reps=reps, dtype=getattr(jnp, dtype)),
        grid=(grid,),
        in_specs=[pl.BlockSpec((rows, LANES), lambda i: (i, 0), memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((rows, LANES), lambda i: (i, 0), memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((rows * grid, LANES), jnp.float32), interpret=True,
    )(x.numpy()))
    tdtype = getattr(torch, dtype)
    fused, two_step = (bf16_probe.fma_chain_plain(x, reps, tdtype, f).numpy()
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


def test_ptxas_report_parsed_for_a_template_instance(monkeypatch):
    """chip_smoke reads the registers of `fma_chain_kernel<ChainBf16, 200>`
    from its mangled name, not those of another instance of the template."""
    import chip_smoke

    name = "_ZN41_GLOBAL__N__890fc4d7_9_probes_cu_cc882b2216fma_chain_kernelINS_9ChainBf16ELi{}EEEvPK6float4PS2_xi"
    report = "\n".join(
        line for reps, regs in ((0, 27), (200, 29)) for line in (
            f"ptxas info    : Compiling entry function '{name.format(reps)}' for 'sm_90a'",
            f"ptxas info    : Function properties for {name.format(reps)}",
            "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
            f"ptxas info    : Used {regs} registers, used 0 barriers"))
    monkeypatch.setitem(kernels.build_info, "ptxas", report)
    assert chip_smoke._ptxas("fma_chain_kernel<ChainBf16, 200>") == dict(
        registers=29, spill_stores=0, spill_loads=0, smem_bytes=0)
    assert chip_smoke._ptxas("fma_chain_kernel<ChainBf16, 0>")["registers"] == 27
    assert chip_smoke._ptxas("fma_chain_kernel<ChainF32, 200>") is None



def test_sweep_fits_the_chunked_instance_only(monkeypatch):
    """The chain sweep's line goes through the lengths that run the chunked
    instance; REPS, which runs the completely unrolled one, stands beside
    it (`unrolled_ms`), and the FMA rate follows from the slope."""
    import types

    def fake_chain(bf16):
        return lambda x, reps: (reps, bf16)

    def fake_time_ms(fn, trials):
        reps, bf16 = fn()
        if reps == bf16_probe.REPS:
            return 0.04  # off the line
        return (0.004 if bf16 else 0.005) + (0.00025 if bf16 else 0.0004) * reps

    monkeypatch.setattr(kernels, "fma_chain_f32", fake_chain(False))
    monkeypatch.setattr(kernels, "fma_chain_bf16", fake_chain(True))
    monkeypatch.setattr(bf16_probe.probes, "time_ms", fake_time_ms)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: types.SimpleNamespace(multi_processor_count=132))
    x = torch.zeros(4096)
    out = bf16_probe.sweep(x, clock_mhz=2000.0)
    assert out["fit_reps"] == [r for r in bf16_probe.SWEEP_REPS if r != bf16_probe.REPS]
    for name, intercept, slope, instructions in (("f32", 0.005, 0.0004, 2 * 4096),
                                                 ("bf16", 0.004, 0.00025, 4096)):
        fit = out[name]
        assert fit["intercept_ms"] == pytest.approx(intercept, rel=1e-9)
        assert fit["ms_per_step"] == pytest.approx(slope, rel=1e-9)
        assert fit["max_line_residual_ms"] < 1e-12
        assert fit["unrolled_ms"] == 0.04
        assert fit["line_ms_at_unrolled_reps"] == pytest.approx(intercept + slope * 200, rel=1e-9)
        between = [slope] * (len(out["fit_reps"]) - 1)
        assert fit["ms_per_step_between"] == pytest.approx(between, rel=1e-9)
        assert fit["warp_instructions_per_sm_clock"] == pytest.approx(
            instructions / (slope * 1e-3) / 32 / 132 / 2e9, rel=1e-9)

# The A and B bodies of tools/kernel_probe2.py, verbatim (:73-86 and
# :90-108 there; local to its main(), so they cannot be imported), with
# the tool's block specs below.
def k_dynslice(pages_ref, table_ref, out_ref):
    for c in range(CHUNK):
        rows = [table_ref[pl.ds(pages_ref[c, p], 1), :] for p in range(8)]
        out_ref[c] = jnp.concatenate(rows, axis=0)


def k_onehot(x_ref, il_ref, out_ref):
    for c in range(CHUNK):
        ws = x_ref[c]
        outs = []
        for r in range(8):
            m = (
                jax.lax.broadcasted_iota(jnp.int32, (LANES, LANES), 0)
                == il_ref[c, r : r + 1, :]
            ).astype(jnp.float32)
            t = jnp.dot(ws, m, preferred_element_type=jnp.float32)
            outs.append(t[r : r + 1, :])
        out_ref[c] = jnp.concatenate(outs, axis=0)


def _interpret_probe2(body, in_specs, *args):
    """tools/kernel_probe2.py's bench() call of `body` at N tiles, in
    interpret mode: grid N // CHUNK, (CHUNK, 8, 128) output blocks."""
    return np.asarray(pl.pallas_call(
        body, grid=(N // CHUNK,), in_specs=in_specs,
        out_specs=pl.BlockSpec((CHUNK, 8, LANES), lambda i: (i, 0, 0), memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((N, 8, LANES), jnp.float32), interpret=True,
    )(*args))


def test_dyn_slice_plain_matches_interpret_kernel():
    x = kernel_probe2.make_inputs(N, device="cpu")
    want = _interpret_probe2(
        k_dynslice,
        [pl.BlockSpec((CHUNK, 8), lambda i: (i, 0), memory_space=pltpu.SMEM),
         pl.BlockSpec((kernel_probe2.PAGES, LANES), lambda i: (0, 0), memory_space=pltpu.VMEM)],
        x["pages"].numpy(), x["table"].numpy())
    np.testing.assert_array_equal(kernel_probe2.dyn_slice_plain(x["pages"], x["table"]).numpy(), want)


def test_onehot_gather_plain_matches_interpret_kernel():
    """Exact: on the CPU the interpret-mode float32 dot has one nonzero
    term per sum (the others are x·0), so it returns x at the index."""
    x = kernel_probe2.make_inputs(N, device="cpu")
    spec = pl.BlockSpec((CHUNK, 8, LANES), lambda i: (i, 0, 0), memory_space=pltpu.VMEM)
    want = _interpret_probe2(k_onehot, [spec, spec], x["x"].numpy(), x["il"].numpy())
    got = kernel_probe2.onehot_gather_plain(x["x"], x["il"]).numpy()
    np.testing.assert_array_equal(got, want)
    # ... which is the lane gather, the function the card's kernel computes.
    np.testing.assert_array_equal(got, np.take_along_axis(x["x"].numpy(), x["il"].numpy(), axis=2))


def test_lane_gather_plain_versions_outside_indices():
    """The two functions the card's lane gather computes differ only on
    indices outside [0, 128): take_along_axis takes them modulo 128, the
    one-hot product gives 0 (no term matches)."""
    rng = np.random.default_rng(3)
    x = torch.as_tensor(rng.normal(size=(2, 8, LANES)).astype(np.float32))
    il = torch.as_tensor(rng.integers(-300, 300, size=(2, 8, LANES)).astype(np.int32))
    inside = (il >= 0) & (il < LANES)
    assert 0 < int(inside.sum()) < il.numel()
    modulo = np.take_along_axis(x.numpy(), np.mod(il.numpy(), LANES), axis=2)
    np.testing.assert_array_equal(kernel_probe.take_along_axis_plain(x, il, 2).numpy(), modulo)
    np.testing.assert_array_equal(kernel_probe2.onehot_gather_plain(x, il).numpy(),
                                  np.where(inside.numpy(), modulo, 0.0))


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


def test_paged_gather_rmw_fixed_plain_matches_int64_oracle():
    """Row 7's dtab as the kernel computes it: `paged_gather_rmw_fixed_plain`
    equals a numpy int64 oracle exactly (each term 0.5·out·2^32 rounded half
    to even, as llrintf; integer sums in any order), and as float32 lies
    within `fixed_point_tolerance` of the float64 `paged_gather_rmw_plain`
    and of the Pallas body in interpret mode. The Pallas body adds its terms
    in float32, one rounding per add after the first, so against it the
    bound adds that sum's own error, (terms − 1)·2^-24·Σ|term| per entry."""
    x = kernel_probe.make_inputs(N, device="cpu")
    a = _np(x)
    got = kernel_probe.paged_gather_rmw_fixed_plain(x["pages"], x["idx"], x["table"])
    ws = a["table"][a["pages"]].reshape(N, 8 * LANES)
    flat = ((a["idx"] >> 7) & 7) * LANES + (a["idx"] & (LANES - 1))
    out = np.take_along_axis(ws, flat.reshape(N, -1), axis=1).reshape(N, 8, LANES)
    q = np.rint(0.5 * out.astype(np.float64) * 2.0**32).astype(np.int64)
    want = np.zeros((kernel_probe.PAGES, LANES), np.int64)
    np.add.at(want, a["pages"].reshape(-1), q.reshape(-1, LANES))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)

    terms = torch.bincount(x["pages"].long().reshape(-1), minlength=kernel_probe.PAGES)[:, None].double()
    abs_sum = np.zeros((kernel_probe.PAGES, LANES))
    np.add.at(abs_sum, a["pages"].reshape(-1), np.abs(0.5 * out.astype(np.float64)).reshape(-1, LANES))
    f32_sum_err = (terms - 1).clamp_min(0) * 2.0**-24 * torch.as_tensor(abs_sum)
    fixed = kernels.from_fixed_point(got).double()
    plain = kernel_probe.paged_gather_rmw_plain(x["pages"], x["idx"], x["table"])[1].double()
    pallas = torch.tensor(np.asarray(_interpret_gather(a)[1]), dtype=torch.float64)
    assert bool(torch.all((fixed - plain).abs() <= kernel_probe.fixed_point_tolerance(plain, terms)))
    assert bool(torch.all(
        (fixed - pallas).abs() <= kernel_probe.fixed_point_tolerance(pallas, terms) + f32_sum_err))
    assert float(fixed.abs().max()) > 0.1


def test_product_loop_needs_a_card():
    """The product-loop timing script refuses to run without a card rather
    than timing the CPU."""
    import subprocess

    script = os.path.join(os.path.dirname(kernels.__file__), "probes", "product_loop.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    proc = subprocess.run([sys.executable, script, "--runs", "1"], env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
