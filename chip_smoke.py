"""On-card smoke test of the PyTorch/CUDA port (jrr_tpu_torch) on one GPU.

    python3 chip_smoke.py

1. builds the CUDA kernels from jrr_tpu_torch/csrc with nvcc (sm_90a);
2. holds each kernel against its plain PyTorch version on the card, on the
   main path's inputs (full-width body, batch 256) at both geometries the
   path uses (224²/tile 8 and 112²/tile 4) plus an all-empty-tiles case,
   and times both;
3. drives the main path once: `refine_batch` at batch 256, 1000 + 100
   steps, shipped defaults, live discriminators (one warm-up, then three
   timed runs, the median reported), with every kernel's launch count set to
   0 just before each timed run and read just after;
4. runs a short full-width refinement (seed 1) twice through the kernels
   (equal bit for bit), twice through the plain versions and once through
   them in float64, and compares the parameters (kernel vs plain ≤ 5e-4);
5. holds the silhouette term's gradient at the first stage-B step through
   the kernels against the plain versions, full width, both geometries,
   problem seeds 1-12;
6. prints the kernels line, the card's name and power limit, and the
   contract line `{"ok": true, "device": {...}}` last.

Any failed check raises (non-zero exit, no result line). Needs one CUDA card
and the repository around this file; TF32 is off for the whole run.
Details too long for stdout (ptxas report, profile) go to chiprun_out/.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "chiprun_out")

# H100 SXM data-sheet peaks (dense): HBM bytes/s and float32 (non-tensor-core) op/s.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# Operations per (pixel, candidate lane) pair, counted from the kernel source:
# three edges × 18 (q, cross, projection, clamp, residual, d²), min/inside/
# select ~12, sigmoid 4, band 2, log(max(1−p)) 3, lane reduction 1.
OPS_COVERAGE = 76
# Pass 2 per pair with 0 < p < 1, on top of recomputing the coverage: the
# p ∈ {0, 1} test 2, dL/dp → dL/dd²min 9, exact-argmin edge selection and
# split 8, the selected edge's four corner terms 12.
OPS_GRADIENT = 31

ALPHA_ATOL = 1e-5
ERR_RTOL = 1e-5
GRAD_ATOL_REL, GRAD_RTOL = 3e-4, 2e-4
REFINE_PARAM_ATOL = 5e-4
GRAD_SEEDS = range(1, 13)  # problem seeds of the stage-B gradient check

BATCH = 256
MAIN_RUNS = 3  # timed main-path runs after the warm-up
PLAIN_FRAMES = 8  # plain versions run in frame chunks (their (B, G², T², 128) intermediates)


def _emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def _time_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _chunked(fn, batch_args, other_args, frames=PLAIN_FRAMES):
    """Run a plain version `frames` frames at a time; concatenate outputs."""
    import torch

    b = batch_args[0].shape[0]
    outs = [fn(*(a[lo:lo + frames] for a in batch_args), *other_args) for lo in range(0, b, frames)]
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(col) for col in zip(*outs))
    return torch.cat(outs)


def _geometry(cfg, mask, geometry):
    """(cfg, mask) of one c2f phase: "fine" as given, "coarse" at
    1/coarse_factor (image, tile and bin margin divided, mask mean-pooled)."""
    from jrr_tpu_torch.refine import engine

    if geometry == "fine":
        return cfg, mask
    sil = cfg.silhouette
    f = sil.coarse_factor
    cfg = dataclasses.replace(cfg, silhouette=dataclasses.replace(
        sil, image_size=sil.image_size // f, tile_size=sil.tile_size // f,
        bin_margin_px=sil.bin_margin_px / f,
    ))
    return cfg, engine._pool_mask(mask, f)


def _kernel_inputs(problem, geometry):
    """The bins, tables and mask the main path hands the kernels at the
    first rebin of one c2f phase (`geometry` = "fine" or "coarse")."""
    import torch

    from jrr_tpu_torch.refine import losses
    from jrr_tpu_torch.render import silhouette_fused as sf

    model, _, cfg, init, data = problem
    cfg, mask = _geometry(cfg, data.mask, geometry)
    spec = losses.rasterizer_spec(cfg)
    with torch.no_grad():
        verts = losses.forward_frame(model, init).vertices
        bins = sf.compute_fused_bins(verts, model, init.cam_t, spec)
        bins = sf.apply_interior_skip(bins, verts, model, init.cam_t, spec)
        _, tx, ty, inv_sigma, blur_px2 = sf._prep_kernel_inputs(verts, model, init.cam_t, spec, bins)
    mask_tiles = sf.image_to_tiles(mask, spec.tile_size).contiguous()
    return dict(
        tx=tx, ty=ty, pages=bins.pages, idx=bins.idx, origin=bins.origin, mask=mask_tiles,
        tile=spec.tile_size, inv_sigma=inv_sigma, blur_px2=blur_px2,
        dump=sf.dump_page_id(model.num_verts),
    )


def _pair_counts(x):
    """(pixel, candidate) pairs these bins need: (pairs of a real candidate
    face, those with 0 < p < 1, occupied tiles). A lane is a real candidate
    when its corners do not index page slot P̂−1: binning points the lanes
    past a tile's face count, the pad from K to 128 and the faces dropped by
    page overflow there, at the dump triangle (p ≡ 0, no work needed)."""
    import torch

    from jrr_tpu_torch.render import coverage
    from jrr_tpu_torch.render import silhouette_fused as sf

    occupied = x["pages"][:, :, 0] != x["dump"]
    t2 = x["tile"] ** 2
    real = (x["idx"][:, :, 0, :] >> 7) != x["pages"].shape[2] - 1
    pairs = int((real & occupied[..., None]).sum()) * t2
    active = 0
    i = torch.arange(t2, device=x["tx"].device)
    for lo in range(0, x["tx"].shape[0], PLAIN_FRAMES):
        sl = slice(lo, lo + PLAIN_FRAMES)
        tri = sf._gather_tri(x["tx"][sl], x["ty"][sl], x["pages"][sl], x["idx"][sl])[occupied[sl]]
        org = x["origin"][sl][occupied[sl]]
        px_x = org[:, 0:1, None] + (i % x["tile"]).float()[None, :, None]
        px_y = org[:, 1:2, None] + (i // x["tile"]).float()[None, :, None]
        rows = tuple(tri[:, j, None, :] for j in range(6))
        p = coverage.coverage_rows(px_x, px_y, rows, inv_sigma=x["inv_sigma"], blur_px2=x["blur_px2"])[0]
        active += int(((p > 0) & (p < 1)).sum())
    return pairs, active, int(occupied.sum())


def _bound_ms(x, ops, with_mask_and_grads):
    """Least time for these inputs: max(bytes / HBM rate, ops / f32 rate).
    Bytes: tables and pages read once, idx/origin(/mask) of occupied tiles
    read once, outputs written once."""
    b, pg, lanes = x["tx"].shape
    g2, p_hat = x["pages"].shape[1:]
    t2 = x["tile"] ** 2
    occ = int((x["pages"][:, :, 0] != x["dump"]).sum())
    read = 2 * b * pg * lanes * 4 + b * g2 * p_hat * 4 + occ * (3 * lanes * 4 + 2 * 4)
    if with_mask_and_grads:
        read += occ * t2 * 4
        written = b * g2 * 4 + 2 * b * pg * lanes * 4
    else:
        written = b * g2 * t2 * 4
    byte_ms = 1e3 * (read + written) / HBM_BYTES_PER_S
    op_ms = 1e3 * ops / F32_OPS_PER_S
    return max(byte_ms, op_ms), ("bytes" if byte_ms >= op_ms else "operations")


def _max_rel_violation(got, want, atol, rtol):
    """max |got − want| / (atol + rtol·|want|): ≤ 1 passes allclose."""
    import torch

    return float(torch.max((got - want).abs() / (atol + rtol * want.abs())))


def check_kernels(problem):
    """Each kernel against its plain version at both geometries + all-empty."""
    import torch

    from jrr_tpu_torch import kernels
    from jrr_tpu_torch.render import silhouette_fused as sf

    report = {}
    for geometry in ("fine", "coarse", "empty"):
        x = _kernel_inputs(problem, "fine" if geometry == "empty" else geometry)
        if geometry == "empty":
            p_hat = x["pages"].shape[2]
            x["pages"] = torch.full_like(x["pages"], x["dump"])
            corner = torch.arange(3, dtype=torch.int32, device=x["idx"].device).reshape(1, 1, 3, 1)
            x["idx"] = ((p_hat - 1) * 128 + corner).expand_as(x["idx"]).contiguous()
        bins = (x["tx"], x["ty"], x["pages"], x["idx"], x["origin"])
        consts = (x["tile"], x["inv_sigma"], x["blur_px2"])

        alpha = kernels.fused_alpha_fwd(*bins, *consts, x["dump"])
        alpha_plain = _chunked(sf.fused_tiles_alpha_plain, bins, consts)
        torch.cuda.synchronize()
        a_err = float((alpha - alpha_plain).abs().max())
        _check(a_err <= ALPHA_ATOL, f"{geometry}: fused_alpha_fwd max|Δα| {a_err} > {ALPHA_ATOL}")

        err, dtx, dty = sf.fused_lossgrad(*bins, x["mask"], *consts, x["dump"])
        err_p, dtx_p, dty_p = _chunked(sf.fused_lossgrad_plain, bins + (x["mask"],), consts)
        torch.cuda.synchronize()
        e_viol = _max_rel_violation(err, err_p, 1e-30, ERR_RTOL)
        _check(e_viol <= 1.0, f"{geometry}: fused_lossgrad err beyond rtol {ERR_RTOL} ({e_viol})")
        g_scale = max(float(dtx_p.abs().max()), float(dty_p.abs().max()), 1e-30)
        g_viol = max(
            _max_rel_violation(dtx, dtx_p, GRAD_ATOL_REL * g_scale, GRAD_RTOL),
            _max_rel_violation(dty, dty_p, GRAD_ATOL_REL * g_scale, GRAD_RTOL),
        )
        _check(g_viol <= 1.0, f"{geometry}: fused_lossgrad grads beyond tolerance ({g_viol})")
        g_err = max(float((dtx - dtx_p).abs().max()), float((dty - dty_p).abs().max()))

        row = dict(
            alpha_max_abs_err=a_err,
            err_max_rel_err=float(((err - err_p).abs() / err_p.abs().clamp_min(1e-30)).max()),
            grad_max_abs_err=g_err, grad_scale=g_scale, grad_tolerance_use=g_viol,
        )
        if geometry != "empty":
            pairs, active, occ = _pair_counts(x)
            row.update(occupied_tiles=occ, pairs=pairs, active_pairs=active)
            row["fwd_ms"] = _time_ms(lambda: kernels.fused_alpha_fwd(*bins, *consts, x["dump"]), 20)
            row["lossgrad_ms"] = _time_ms(
                lambda: kernels.fused_lossgrad(*bins, x["mask"], *consts, x["dump"]), 20
            )
            row["fwd_plain_ms"] = _time_ms(lambda: _chunked(sf.fused_tiles_alpha_plain, bins, consts), 1)
            row["lossgrad_plain_ms"] = _time_ms(
                lambda: _chunked(sf.fused_lossgrad_plain, bins + (x["mask"],), consts), 1
            )
            row["fwd_bound_ms"], row["fwd_bound_by"] = _bound_ms(x, pairs * OPS_COVERAGE, False)
            row["lossgrad_bound_ms"], row["lossgrad_bound_by"] = _bound_ms(
                x, pairs * OPS_COVERAGE + active * (OPS_COVERAGE + OPS_GRADIENT), True
            )
        report[geometry] = row
    return report


def _card() -> str:
    """`nvidia-smi`'s name and power limit of the card, e.g. "NVIDIA H100 …, 700.00 W"."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def run_main_path(problem, pose_disc, shape_disc):
    """refine_batch at full width: warm-up, then MAIN_RUNS timed runs, each
    with the launch counts set to 0 just before it and read just after. The
    call is host-bound, so its wall time spreads: the median is reported."""
    import torch

    from jrr_tpu_torch import kernels
    from jrr_tpu_torch.refine import engine

    model, j_reg, cfg, init, data = problem
    cfg = dataclasses.replace(cfg, stage_a_steps=1000, stage_b_steps=100)
    engine.refine_batch(model, j_reg, init, data, cfg, pose_disc, shape_disc)
    torch.cuda.synchronize()

    runs = []
    for _ in range(MAIN_RUNS):
        kernels.reset_launches()
        t0 = time.perf_counter()
        res = engine.refine_batch(model, j_reg, init, data, cfg, pose_disc, shape_disc)
        torch.cuda.synchronize()
        runs.append(time.perf_counter() - t0)
        launches = {w.__name__: w.launches for w in kernels.WRAPPERS}
        _check(launches == {"fused_lossgrad": 38, "fused_alpha_fwd": 2},
               f"main path launches {launches}, expected 38 fused_lossgrad + 2 fused_alpha_fwd")
    seconds = sorted(runs)[len(runs) // 2]

    # Stage A alone (no stage-B steps): the rest of the call is stage B.
    t0 = time.perf_counter()
    engine.refine_batch(model, j_reg, init, data, dataclasses.replace(cfg, stage_b_steps=0),
                        pose_disc, shape_disc)
    torch.cuda.synchronize()
    stage_a_seconds = time.perf_counter() - t0

    total = res.stage_b_terms.total
    first, last = float(total[0]), float(total[-1])
    _check(total.shape == (100,) and res.stage_a_loss.shape == (1000,), "loss curve shapes")
    _check(last < first, f"stage-B total did not decrease: {first} -> {last}")
    finite = all(bool(torch.isfinite(p).all()) for p in res.params)
    _check(finite and res.vertices.shape == (BATCH, 6890, 3), "non-finite or misshapen params")
    return dict(
        batch=BATCH, stage_a_steps=1000, stage_b_steps=100, seconds=seconds,
        seconds_runs=runs, stage_a_only_seconds=stage_a_seconds,
        frames_per_s=BATCH / seconds, launches=launches,
        bin_stats={k: int(v) for k, v in res.bin_stats._asdict().items()},
        stage_a_loss_first_last=[float(res.stage_a_loss[0]), float(res.stage_a_loss[-1])],
        stage_b_total_first_last=[first, last], params_finite=finite,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, card=_card(),
    ), launches


def profile_main_path(problem, pose_disc, shape_disc, timed_seconds):
    """One more refine_batch under torch.profiler: device time by kernel
    (chiprun_out/profile.txt) and the device-idle share of the timed run
    (1 − device-busy seconds / the unprofiled call's seconds)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from jrr_tpu_torch.refine import engine

    model, j_reg, cfg, init, data = problem
    cfg = dataclasses.replace(cfg, stage_a_steps=1000, stage_b_steps=100)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.refine_batch(model, j_reg, init, data, cfg, pose_disc, shape_disc)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # Device-side events only (kernels, copies, fills): operator rows would
    # count their kernels a second time.
    rows = sorted(
        ((e.self_device_time_total, e.count, e.key) for e in prof.key_averages()
         if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
        reverse=True,
    )
    busy_s = sum(r[0] for r in rows) / 1e6
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "profile.txt"), "w") as f:
        f.write(f"profiled_wall_s {wall:.6f} device_busy_s {busy_s:.6f}\n")
        for us, n, key in rows[:60]:
            f.write(f"{us / 1e3:12.3f} ms {n:8d}  {key[:160]}\n")
    return dict(
        profiled_wall_s=wall, device_busy_s=busy_s, timed_run_s=timed_seconds,
        device_idle_share=max(0.0, 1.0 - busy_s / timed_seconds),
        kernel_launches=sum(r[1] for r in rows),
        top=[{"ms": us / 1e3, "count": n, "kernel": key[:80]} for us, n, key in rows[:8]],
    )


@contextlib.contextmanager
def _plain_versions():
    """Route the rasterizer's two kernel wrappers to their plain versions on
    any device, for the reference run only (the wrappers themselves never
    fall back)."""
    from jrr_tpu_torch.render import silhouette_fused as sf

    saved = sf.fused_tiles_alpha, sf.fused_lossgrad
    sf.fused_tiles_alpha = lambda *args: sf.fused_tiles_alpha_plain(*args[:-1])  # drops dump_page
    sf.fused_lossgrad = lambda *args: sf.fused_lossgrad_plain(*args[:-1])
    try:
        yield
    finally:
        sf.fused_tiles_alpha, sf.fused_lossgrad = saved


def _max_param_diff(a, b) -> float:
    return max(float((p - q.to(p.dtype)).abs().max()) for p, q in zip(a.params, b.params))


def _float64(problem, pose_disc, shape_disc):
    """The problem and discriminators in float64 (for the plain versions)."""
    import copy

    import torch

    model, j_reg, cfg, init, data = problem
    dbl = lambda t: t.double() if torch.is_tensor(t) and t.is_floating_point() else t  # noqa: E731
    model = dataclasses.replace(model, **{
        f.name: dbl(getattr(model, f.name)) for f in dataclasses.fields(model)
    })
    problem = (model, j_reg.double(), cfg, type(init)(*map(dbl, init)), type(data)(*map(dbl, data)))
    return problem, copy.deepcopy(pose_disc).double(), copy.deepcopy(shape_disc).double()


def short_problem(seed):
    """The synthetic problem at full width, batch 2 (its mask is rendered
    through the forward kernel)."""
    from jrr_tpu_torch import problem as problem_lib

    return problem_lib.synthetic_problem(batch=2, seed=seed, device="cuda")


def short_refine(problem, pose_disc, shape_disc, plain=False, float64=False):
    """refine_batch on `problem` (a `short_problem`) with 20 + 10 steps:
    through the kernels, or (plain=True) through the plain versions with
    PyTorch's deterministic algorithms on (their gather backward otherwise
    adds with float atomics), in float32 or float64."""
    import torch

    from jrr_tpu_torch.refine import engine

    if float64:
        problem, pose_disc, shape_disc = _float64(problem, pose_disc, shape_disc)
    model, j_reg, cfg, init, data = problem
    cfg = dataclasses.replace(cfg, stage_a_steps=20, stage_b_steps=10)
    if not plain:
        return engine.refine_batch(model, j_reg, init, data, cfg, pose_disc, shape_disc)
    torch.use_deterministic_algorithms(True)
    try:
        with _plain_versions():
            return engine.refine_batch(model, j_reg, init, data, cfg, pose_disc, shape_disc)
    finally:
        torch.use_deterministic_algorithms(False)


def compare_kernel_and_plain_refine(pose_disc, shape_disc, seed=1):
    """`short_refine` twice through the kernels (the path is deterministic,
    so the two must agree bit for bit), twice through the plain versions,
    and once through the plain versions in float64. The Adam steps amplify
    any last-bit difference into the parameters, so the float64 run says how
    far float32 rounding alone moves them: kernel and plain float32 should
    each lie that far from it."""
    from jrr_tpu_torch import kernels

    problem = short_problem(seed)
    before = sum(w.launches for w in kernels.WRAPPERS)
    k1 = short_refine(problem, pose_disc, shape_disc)
    k2 = short_refine(problem, pose_disc, shape_disc)
    launched = sum(w.launches for w in kernels.WRAPPERS)
    _check(launched > before, "the kernel refinement launched no kernel")
    repeat = _max_param_diff(k1, k2)
    _check(repeat == 0.0, f"two kernel refinements differ by {repeat}")
    p1 = short_refine(problem, pose_disc, shape_disc, plain=True)
    p2 = short_refine(problem, pose_disc, shape_disc, plain=True)
    p64 = short_refine(problem, pose_disc, shape_disc, plain=True, float64=True)
    _check(sum(w.launches for w in kernels.WRAPPERS) == launched,
           "the plain reference refinements launched a kernel")
    sil_active = int((k1.stage_b_terms.silhouette != 0).sum())
    _check(sil_active > 0, "the short refinement never ran the silhouette term")
    return dict(
        seed=seed, batch=2, stage_a_steps=20, stage_b_steps=10,
        max_param_abs_diff=_max_param_diff(k1, p1), tolerance=REFINE_PARAM_ATOL,
        kernel_repeat_diff=repeat, plain_repeat_diff=_max_param_diff(p1, p2),
        kernel_vs_float64=_max_param_diff(p64, k1), plain_vs_float64=_max_param_diff(p64, p1),
        silhouette_steps=sil_active,
    )


def compare_silhouette_gradients(seeds=GRAD_SEEDS):
    """The silhouette term's gradient w.r.t. the frame parameters at the
    first stage-B step, through the kernels and through the plain versions
    at the same inputs: full width, batch 2, both c2f geometries, every seed.
    The kernel test's criterion (atol 3e-4·max|plain| + rtol 2e-4) per
    parameter tensor. Unlike the refinement, no optimizer amplifies the
    last bits here."""
    import torch

    from jrr_tpu_torch import problem as problem_lib
    from jrr_tpu_torch.refine import engine, losses
    from jrr_tpu_torch.render import silhouette_fused as sf

    worst = {"fine": 0.0, "coarse": 0.0}
    for seed in seeds:
        model, j_reg, cfg, init, data = problem_lib.synthetic_problem(batch=2, seed=seed, device="cuda")
        # Stage A alone (20 camera steps) gives stage B's starting point.
        start = engine.refine_batch(
            model, j_reg, init, data, dataclasses.replace(cfg, stage_a_steps=20, stage_b_steps=0)
        ).params
        for geometry in worst:
            gcfg, mask = _geometry(cfg, data.mask, geometry)
            spec = losses.rasterizer_spec(gcfg)
            with torch.no_grad():
                verts = losses.forward_frame(model, start).vertices
                bins = sf.compute_fused_bins(verts, model, start.cam_t, spec)
                bins = sf.apply_interior_skip(bins, verts, model, start.cam_t, spec)

            def grads():
                leaves = [x.detach().clone().requires_grad_(True) for x in start]
                p = type(start)(*leaves)
                v = losses.forward_frame(model, p).vertices
                loss = losses.silhouette_loss(model, v, p.cam_t, mask, gcfg, bins=bins).sum()
                return torch.autograd.grad(loss, leaves)

            got = grads()
            with _plain_versions():
                want = grads()
            viol = max(
                _max_rel_violation(a, b, GRAD_ATOL_REL * float(b.abs().max()) + 1e-30, GRAD_RTOL)
                for a, b in zip(got, want)
            )
            worst[geometry] = max(worst[geometry], viol)
            _check(viol <= 1.0, f"seed {seed} {geometry}: silhouette gradient beyond tolerance ({viol})")
    return dict(seeds=list(seeds), batch=2, stage_a_steps=20,
                tolerance=f"atol {GRAD_ATOL_REL}*max|plain| + rtol {GRAD_RTOL} per parameter",
                max_tolerance_use=worst)


def main() -> int:
    # cuBLAS's setting for deterministic results, read when its handle is
    # made; PyTorch's deterministic mode (the plain reference run) needs it.
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    # One card: the first of those visible, so the device count reads 1.
    os.environ["CUDA_VISIBLE_DEVICES"] = os.environ.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0]
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from jrr_tpu_torch import kernels
    from jrr_tpu_torch import problem as problem_lib
    from jrr_tpu_torch.models import discriminator

    # Full float32 products (the matmul default) and no TF32 in cuDNN.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    kernels.build()
    build_s = time.perf_counter() - t0
    release = kernels.nvcc_release()
    if kernels.build_info.get("ptxas"):
        os.makedirs(OUT_DIR, exist_ok=True)
        with open(os.path.join(OUT_DIR, "ptxas.txt"), "w") as f:
            f.write(kernels.build_info["ptxas"])
    _emit({"build": {"seconds": build_s, "nvcc_release": release, "arch": "sm_90a"}})

    problem = problem_lib.synthetic_problem(batch=BATCH, seed=0, device="cuda")
    pose_disc = discriminator.PoseDiscriminator(seed=7, device="cuda")
    shape_disc = discriminator.ShapeDiscriminator(seed=8, device="cuda")

    checks = check_kernels(problem)
    main_path, launches = run_main_path(problem, pose_disc, shape_disc)
    _emit({"main_path": main_path})
    _emit({"profile": profile_main_path(problem, pose_disc, shape_disc, main_path["seconds"])})
    refine = compare_kernel_and_plain_refine(pose_disc, shape_disc)
    _emit({"kernel_vs_plain_refine": refine})
    _check(refine["max_param_abs_diff"] <= REFINE_PARAM_ATOL,
           f"kernel vs plain refine params differ by {refine['max_param_abs_diff']}")
    _emit({"kernel_vs_plain_silhouette_gradient": compare_silhouette_gradients()})
    _emit({"kernel_checks": checks})

    fine = checks["fine"]
    source = "jrr_tpu_torch/csrc/silhouette_fused.cu"
    _emit({"kernels": [
        {
            "name": "fused_lossgrad", "route": "cuda", "source": source,
            "replaces": "jrr_tpu/render/silhouette_fused.py:994",
            "launches": launches["fused_lossgrad"],
            "max_abs_err": max(checks[g]["grad_max_abs_err"] for g in checks),
            "ms": fine["lossgrad_ms"], "plain_ms": fine["lossgrad_plain_ms"],
            "bound_ms": fine["lossgrad_bound_ms"], "bound_by": fine["lossgrad_bound_by"],
            "library_ms": None,
            "tolerance": f"err rtol {ERR_RTOL}; grads atol {GRAD_ATOL_REL}*max|plain| + rtol {GRAD_RTOL}",
            "coarse_ms": checks["coarse"]["lossgrad_ms"],
            "coarse_bound_ms": checks["coarse"]["lossgrad_bound_ms"],
        },
        {
            "name": "fused_alpha_fwd", "route": "cuda", "source": source,
            "replaces": "jrr_tpu/render/silhouette_fused.py:719",
            "launches": launches["fused_alpha_fwd"],
            "max_abs_err": max(checks[g]["alpha_max_abs_err"] for g in checks),
            "ms": fine["fwd_ms"], "plain_ms": fine["fwd_plain_ms"],
            "bound_ms": fine["fwd_bound_ms"], "bound_by": fine["fwd_bound_by"],
            "library_ms": None,
            "tolerance": f"atol {ALPHA_ATOL}",
            "coarse_ms": checks["coarse"]["fwd_ms"],
            "coarse_bound_ms": checks["coarse"]["fwd_bound_ms"],
        },
    ]})
    print(_card(), flush=True)
    _emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
