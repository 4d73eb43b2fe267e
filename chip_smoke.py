"""On-card smoke test of the PyTorch/CUDA port (jrr_tpu_torch) on one GPU.

    python3 chip_smoke.py

1. builds the CUDA kernels from jrr_tpu_torch/csrc with nvcc (sm_90a);
2. holds each kernel against its plain PyTorch version on the card, on the
   main paths' inputs (full-width body, batch 256) at both geometries the
   paths use (224²/tile 8 and 112²/tile 4) plus an all-empty-tiles case,
   and times both: the fused kernels on the fused bins, the round-1 tile
   kernels on the round-1 bins, and the lane-packed loss kernel on the
   fused bins after `pack_bins` (also against the unpacked kernel and
   against its own repeat); the loss kernel against its own repeat too; the
   α VJP kernel against its own repeat and, at dL/dα = 2·(α − mask) with α
   from the fused α kernel, against the loss kernel's gradients bit for bit
   (`bwd_equals_lossgrad`), its time over the loss kernel's on the same
   bins (`bwd_over_lossgrad`: the two run the same near-pair passes); both
   α kernels and the round-1 backward against their own repeats; the
   near-pair passes' balance across each warp's threads on the fused bins
   (`pass2_warp_efficiency`, `pass1_item_efficiency`: counts, not times);
   each kernel's registers, spills and shared memory from `ptxas -v`; the
   interior skip's tile
   decisions from the fused α kernel against those from the plain α on the
   bins the skip sees (`skip_flips`); the packed kernel's NORMAL rows
   against the unpacked kernel's err bit for bit. Bounds count a coverage
   per (pixel, lane) pair in the face's pixel box and the box test per
   other pair;
3. drives the main path once: `refine_batch` at batch 256, 1000 + 100
   steps, shipped defaults, live discriminators (one warm-up, then three
   timed runs, the median reported), with every kernel's launch count set to
   0 just before each timed run and read just after;
4. runs a short full-width refinement (seed 1) twice through the kernels
   (equal bit for bit), twice through the plain versions and once through
   them in float64, and compares the parameters (kernel vs plain ≤ 5e-4);
5. holds the silhouette term's gradient at the first stage-B step through
   the kernels against the plain versions, full width, both geometries,
   problem seeds 1-12, for the fused path, the lane-packed fused path and
   the round-1 backend;
6. drives the training path: three `outer_step`s at batch 256, 1000 + 100
   steps (three batches of one synthetic problem whose mask is rendered
   through the round-1 tile kernel) and a profiled repeat of the last,
   then the closed-form regressor fit over those batches at V = 6890;
7. drives the round-1 configuration (`silhouette.backend="pallas"`):
   `refine_batch` at batch 256, full width and depth (warm-up, one timed
   run, one profiled run), and two short kernel refinements that must
   agree bit for bit;
8. drives the XLA tile loop (`silhouette.backend="xla"`, `xla_path`):
   `render_mesh_silhouette` at batch 256 against row 5's render of the
   same vertices (α within 1e-5; seconds and peak memory, forward and
   backward), its gradient against the plain round-1 route's on 8 frames,
   `refine_batch(backend="xla")` at the shipped defaults equal to step 7's
   round-1 run bit for bit with the same launches, and a
   `rebin_interval=1` refinement at batch 16 through the tile loop (finite,
   falling, no kernel launched);
9. holds the gradient of Σ w·`silhouette_tiles_fused` (the α VJP kernel)
   against the plain version at batch 256, both geometries;
10. drives the lane-packed configuration (`silhouette.lane_pack=True`):
   `refine_batch` at batch 256, full width and depth (warm-up, two timed
   runs with every active silhouette step through the packed kernel, in
   turns A B B A with two unpacked runs to compare with), and two short
   kernel refinements that must agree bit for bit;
11. runs the primitive probes (jrr_tpu_torch/probes/): each probe kernel
   against its plain version at the probe tools' shapes, timed beside one
   PyTorch call for the same function (the RMW probe's int64 sums equal its
   fixed-point plain version's exactly; the lane gather also on indices
   outside [0, 128), modulo 128 for take_along_axis and 0 for the one-hot
   product's function, as their plain versions);
12. builds the host runtime (jrr_tpu_torch/runtime/jrr_runtime.cc) with
   g++ on this host and decodes the committed JPEGs of tests/data/jpeg
   (`jpeg_check`): each within 1 level of its committed imageio decode (the
   1000² frame's SHA-256 equal), the values that differ counted, the
   1000² frame's decode timed;
13. reads the committed HDF5 files of tests/data/h5 (`h5_check`): every
   in-scope layout equal to its committed h5py decode (0 values differ),
   two out-of-scope files refused, the 4-frame data.h5 dataset in
   H36MDataset's h5 mode held to jrr_tpu's committed batch, one 1000²
   frame's read timed, `load_raw_h36m` on the committed annot.h5 tree
   equal to jrr_tpu's committed output, and `run_pipeline(demo=True)` over
   the dataset at full width (batch 4), which must read through the
   reader and launch rows 1 and 2 38 and 2 times;
14. drives the product loop (`product_path`) as tools/pipeline_bench.py
   drives jrr_tpu's: 512 fixture frames written at SPIN-crop scale, the v1
   pack and the pre-warped v2 pack built from them (each timed), then
   `run_pipeline(demo=True, loader="auto")` on them at full width (two
   shards of 256, shipped defaults, temporary directories), which must read
   the v2 pack, with rows 1, 2 and 5 launched 76, 4 and at least 1 times
   and finite evals, then the same call again, which must resume both
   shards, launch no kernel, give the same regressors and evals bit for
   bit and save the train state it restored, in jrr_tpu's layout, equal;
   restores the committed jrr_tpu-written train state of tests/data
   (V = 96) equal to its file; then loads the loop's first batch through the python loader, the
   v1 pack and the v2 pack (`loader_check`: jrr_tpu's tolerances, ms per
   batch each), holds row 5 on the fixture render's own tiles (against its
   plain version, its repeat and the mask PNGs) and rows 1 and 2 on the
   bins of the loop's first batch. On these inputs some coverage decisions
   lie within float32 rounding of their thresholds, where the kernels'
   contracted products and the plain versions' rounded ones may decide
   them apart and α jumps: there each α is held within the bounds of both
   outcomes, the loss kernel's err off those frames and its gradients off
   the entries they reach;
15. runs the product loop again as one process per card of an NCCL group
   (`multi_gpu`: `parallel.multihost.launch_local` starts
   torch.cuda.device_count() processes, one here, each running the
   product path's `run_pipeline` call on its card under
   `torch.distributed`): at one process its shard files, train state,
   regressors, evals, lstsq accumulator and rows 1 and 2's launch counts
   equal the one-process run's bit for bit; its seconds and product
   frames/s beside the one-process run's; a run across cards is not
   verified here;
16. converts a full-width SMPL pickle in the official layout, written from
   the product path's synthetic body, with the port's
   `convert_smpl_pickle` and loads it on the card (`body_weights`: arrays
   and a batch-256 forward equal to the body's bit for bit), loads the
   shipped retrained regressor (rows normalize to 1 within 1e-5, ≥ 0)
   and applies it to the product path's refined vertices (an MPJPE that
   means nothing on synthetic bodies);
17. drives SPIN initialization and the VIBE/MEVA consumer evals
   (`consumer_path`): SPIN's hmr, VIBE's and MEVA's checkpoints fabricated
   at the published shapes from a seeded generator, then
   `run_pipeline(demo=True, spin_checkpoint=…, vibe_checkpoint=…,
   meva_checkpoint=…, consumer_seqlen=16)` on the product path's fixtures
   and their v2 pack at full width, batch 256, shipped defaults, with rows
   1 and 2 launched
   76 and 4 times, row 5 never, and finite evals; then holds SPIN
   (features and estimates, TF32 off as shipped; the TF32-on gap reported)
   and both consumers of each kind against the port's float32 CPU runs,
   and rows 1 and 2 on the first SPIN-initialized batch's bins;
18. runs the off-path modules at full width (`aux_modules`): a
   thin-appendage body's mask render through row 5 held to its plain
   version, the legacy staged fit at batch 256 (and at batch 8 against
   the CPU), the image discriminator and linearized sampling at batch 256
   against the CPU on their first frames, perturbations drawn on the card;
19. prints the kernels line, the card's name and power limit, and the
   contract line `{"ok": true, "device": {...}}` last.

Any failed check raises (non-zero exit, no result line). Needs one CUDA card
and the repository around this file; TF32 is off for the whole run.
Details too long for stdout (ptxas report, profiles, every JSON line in
chip_smoke.jsonl) go to chiprun_out/.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
import tempfile
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
# Per pair outside its triangle's pixel box (coverage.cuh, pixel_box): the
# box tests each of a tile's T rows and T columns once per lane (two
# differences, two compares, an and, a bit set: ~8 ops each), 16T ops over
# T² pairs, 2 per pair at tile 8 (4 at tile 4). Pairs inside the box (the
# near pairs, `coverage.near_box`) cost a coverage each; the per-lane box
# set-up (~40 ops) is left out.
OPS_BOX = 2

ALPHA_ATOL = 1e-5
ERR_RTOL = 1e-5
GRAD_ATOL_REL, GRAD_RTOL = 3e-4, 2e-4
REFINE_PARAM_ATOL = 5e-4
# How near its threshold the plain α's deciding extreme may lie for an
# interior-skip tile decision to differ between the kernel's α and the plain
# α: ~4 float32 ulp at 1 − 1e-6, far inside ALPHA_ATOL.
SKIP_BAND = 2.5e-7
GRAD_SEEDS = range(1, 13)  # problem seeds of the stage-B gradient check
# How near a coverage decision may lie to its threshold, relative to the
# magnitudes of its terms, for the kernels (whose compiler contracts products
# into FMAs) and the plain versions (every op rounded) to decide it
# differently: ~8 float32 ulp. The decisions are the inside test (a cross
# product's sign) and the blur band (sd2 ≤ blur_px2). Where the band is 0,
# as in the fixture masks' render, an inside flip moves p between ≥ 0.5 and
# 0; at the band's edge p jumps from sigmoid(−blur_px2·inv_sigma) to 0.
DECISION_BAND = 2.0 ** -20

BATCH = 256
MAIN_RUNS = 3  # timed main-path runs after the warm-up
PLAIN_FRAMES = 8  # plain versions run in frame chunks (their (B, G², T², 128) intermediates)
TRAIN_STEPS = 3  # outer_step calls of the training path, one batch of BATCH frames each
LANE_PACK_PAIRS = 2  # timed (lane-packed, unpacked) pairs, in turns A B B A
PRODUCT_FRAMES = 2 * BATCH  # fixture frames of the product path: two shards
# Camera z of the product path's fixtures: SPIN-crop scale, the range of
# tools/pipeline_bench.py and of the synthetic problem of the other phases.
PRODUCT_DEPTH = (36.0, 60.0)
SPIN_CHECK_FRAMES = 8  # SPIN on the card against the CPU on the first batch's first frames
# jrr_tpu's loader tolerances (tests/test_native_pipeline.py): the v1 pack's
# crops against the python loader's (its C++ warp against the torch one) and
# gt_j2d in px; the v2 pack against the v1 (u8 quantization of the crops);
# the tensors both copy from tensors.npz.
LOADER_IMAGE_ATOL, LOADER_J2D_ATOL = 2e-2, 0.5
LOADER_V2_ATOL = 1.01 / 255
LOADER_STORED_ATOL = 1e-6
JPEG_DIR = os.path.join(ROOT, "tests", "data", "jpeg")
H5_DIR = os.path.join(ROOT, "tests", "data", "h5")  # tests/make_h5_fixtures.py
# A jrr_tpu TrainState one Adam step in, V = 96 (tests/make_state_fixture.py).
JAX_STATE = os.path.join(ROOT, "tests", "data", "train_state", "state_00000001.npz")
H5_FRAMES = 4  # frames of the committed data.h5 dataset: one batch
H5_FRAME_READS = 11  # reads of one 1000² frame timed (median)
# The CPU tolerances of an h5-mode batch against jrr_tpu's committed one
# (tests/test_torch_hdf5.py): warped crops, crop intrinsics, gt_j2d in px;
# every other key equal.
H5_BATCH_ATOL = {"image": 2e-4, "spin_image": 2e-4, "intrinsics": 1e-3, "gt_j2d": 1e-4}
XLA_GRAD_FRAMES = PLAIN_FRAMES  # the tile loop's gradient against the plain round-1 route's
XLA_REFINE_BATCH = 16  # the tile loop's refinement (rebin_interval 1)
CONSUMER_SEQLEN = 16  # the reference's chunk length (scripts/test.py:254-273)
CONSUMER_CHUNKS = 2  # sequence chunks of the consumers' card-against-CPU hold
# SPIN and the consumers ship with TF32 off: float32 card against float32 CPU,
# their entry points called with TF32 on for the process, so that the code
# itself must turn it off. Each limit lies between the gap of that sound
# path and the gap of the same path with its float32 policy taken out
# (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md, PR 8): features 3.1e-7 against
# 5.3e-4 of their largest, estimates 6.0e-8 against 7.6e-6, consumer joints
# 8.9e-8 m against 3.2e-5 to 4.5e-5 m. Each run reports both readings.
SPIN_FEATURE_RTOL = 1e-4  # of the largest feature
SPIN_OUTPUT_ATOL = 1e-6
CONSUMER_ATOL = 1e-6  # meters


def _emit(obj) -> None:
    """Print one JSON line, and keep it in chiprun_out/chip_smoke.jsonl
    (stdout's head can be cut where only its end is kept)."""
    line = json.dumps(obj)
    print(line, flush=True)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.jsonl"), "a") as f:
        f.write(line + "\n")


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
        pre_skip = sf.compute_fused_bins(verts, model, init.cam_t, spec)
        bins = sf.apply_interior_skip(pre_skip, verts, model, init.cam_t, spec)
        _, tx, ty, inv_sigma, blur_px2 = sf._prep_kernel_inputs(verts, model, init.cam_t, spec, bins)
    mask_tiles = sf.image_to_tiles(mask, spec.tile_size).contiguous()
    return dict(
        tx=tx, ty=ty, pages=bins.pages, idx=bins.idx, origin=bins.origin, mask=mask_tiles,
        pre_skip=(pre_skip.pages, pre_skip.idx),
        tile=spec.tile_size, inv_sigma=inv_sigma, blur_px2=blur_px2,
        dump=sf.dump_page_id(model.num_verts), bins=bins, num_verts=model.num_verts,
    )


def _empty_tiles(x):
    """`_kernel_inputs` with every tile kernel-empty (binning's dump pattern)."""
    import torch

    p_hat = x["pages"].shape[2]
    x["pages"] = torch.full_like(x["pages"], x["dump"])
    corner = torch.arange(3, dtype=torch.int32, device=x["idx"].device).reshape(1, 1, 3, 1)
    x["idx"] = ((p_hat - 1) * 128 + corner).expand_as(x["idx"]).contiguous()
    x["bins"] = x["bins"]._replace(pages=x["pages"], idx=x["idx"])
    return x


def _pixel_grid(tri, origin, tile):
    """(px_x, px_y (N, T², 1), corner rows (N, 1, K) each) of tiles tri
    (N, 6, K) at origin (N, 2), pixels placed as the kernels place them."""
    import torch

    i = torch.arange(tile * tile, device=tri.device)
    px_x = origin[:, 0:1, None] + (i % tile).float()[None, :, None]
    px_y = origin[:, 1:2, None] + (i // tile).float()[None, :, None]
    return px_x, px_y, tuple(tri[:, j, None, :] for j in range(6))


def _near_and_active_pairs(tri, origin, tile, inv_sigma, blur_px2, lane_ok):
    """(pixel, lane) pairs of tiles tri (N, 6, K), origin (N, 2): those in
    their triangle's pixel box (`coverage.near_box`, the loss kernel's own
    test) and those with 0 < p < 1, counting only lanes where `lane_ok`
    (N, K) is set."""
    from jrr_tpu_torch.render import coverage

    px_x, px_y, rows = _pixel_grid(tri, origin, tile)
    p = coverage.coverage_rows(px_x, px_y, rows, inv_sigma=inv_sigma, blur_px2=blur_px2)[0]
    active = (p > 0) & (p < 1) & lane_ok[:, None, :]
    near = coverage.near_box(px_x, px_y, rows, blur_px2=blur_px2) & lane_ok[:, None, :]
    return int(near.sum()), int(active.sum())


def _lane_groups(items, lanes):
    """coverage.cuh's lane_groups: the threads that share one pass-1 item."""
    g = 1
    while 32 * g <= lanes and 2 * g * items <= 128:
        g *= 2
    return g


def _pass_work(near):
    """How evenly the near-pair passes load each warp's threads on tiles of
    one 128-lane row each, near (N, T², 128) bool the kernels' pixel boxes:
    (pass-2 work, pass-2 slots, pass-1 work, pass-1 slots). A warp takes
    as long as its busiest thread, so its slots are 32 × that thread's
    work. Pass 2 (box_corner_grads): thread k walks lane k's box. Pass 1
    (box_log_sums): thread w walks share w % G of pixel w // G's set lanes,
    G = lane_groups(T², 128), in rounds of 128 threads."""
    import torch.nn.functional as F

    n, t2, lanes = near.shape
    groups = _lane_groups(t2, lanes)
    box = near.sum(1)  # (N, 128): pixels in each lane's box
    share = near.reshape(n, t2, groups, lanes // groups).sum(-1).reshape(n, -1)  # thread order
    share = F.pad(share, (0, -share.shape[1] % 32))

    def work_and_slots(per_thread):
        warps = per_thread.reshape(n, -1, 32)
        return int(warps.sum()), 32 * int(warps.amax(-1).sum())

    return work_and_slots(box) + work_and_slots(share)


def _pass_efficiencies(x):
    """`_pass_work` over the occupied tiles of fused bins (all 128 lanes:
    the pad lanes' dump triangle has an empty box, as in the kernels):
    pass2_warp_efficiency = Σ box pixels / Σ over warps of 32 × the warp's
    largest box; pass1_item_efficiency = Σ set lanes walked / Σ over warps
    of 32 × the warp's largest share."""
    from jrr_tpu_torch.render import coverage
    from jrr_tpu_torch.render import silhouette_fused as sf

    occupied = x["pages"][:, :, 0] != x["dump"]
    totals = [0, 0, 0, 0]
    for lo in range(0, x["tx"].shape[0], PLAIN_FRAMES):
        sl = slice(lo, lo + PLAIN_FRAMES)
        occ = occupied[sl]
        tri = sf._gather_tri(x["tx"][sl], x["ty"][sl], x["pages"][sl], x["idx"][sl])[occ]
        px_x, px_y, rows = _pixel_grid(tri, x["origin"][sl][occ], x["tile"])
        near = coverage.near_box(px_x, px_y, rows, blur_px2=x["blur_px2"])
        totals = [a + b for a, b in zip(totals, _pass_work(near))]
    return dict(pass2_warp_efficiency=totals[0] / totals[1],
                pass1_item_efficiency=totals[2] / totals[3])


def _ops(pairs, near, active, gradient):
    """Operations these inputs need of a coverage kernel: a coverage per
    near pair, the box test per other pair, and for a gradient kernel the
    recomputed coverage and the gradient per pair with 0 < p < 1."""
    ops = near * OPS_COVERAGE + (pairs - near) * OPS_BOX
    return ops + (active * (OPS_COVERAGE + OPS_GRADIENT) if gradient else 0)


def _pair_counts(x):
    """(pixel, candidate) pairs these bins need: (pairs of a real candidate
    face, those in the face's pixel box, those with 0 < p < 1, occupied
    tiles). A lane is a real candidate when its corners do not index page
    slot P̂−1: binning points the lanes past a tile's face count, the pad
    from K to 128 and the faces dropped by page overflow there, at the dump
    triangle (p ≡ 0, no work needed)."""
    from jrr_tpu_torch.render import silhouette_fused as sf

    occupied = x["pages"][:, :, 0] != x["dump"]
    real = (x["idx"][:, :, 0, :] >> 7) != x["pages"].shape[2] - 1
    pairs = int((real & occupied[..., None]).sum()) * x["tile"] ** 2
    near = active = 0
    for lo in range(0, x["tx"].shape[0], PLAIN_FRAMES):
        sl = slice(lo, lo + PLAIN_FRAMES)
        occ = occupied[sl]
        tri = sf._gather_tri(x["tx"][sl], x["ty"][sl], x["pages"][sl], x["idx"][sl])[occ]
        n, a = _near_and_active_pairs(tri, x["origin"][sl][occ], x["tile"], x["inv_sigma"],
                                      x["blur_px2"], real[sl][occ])
        near, active = near + n, active + a
    return pairs, near, active, int(occupied.sum())


def _max_bound(byte_count, ops):
    """(max(bytes / HBM rate, ops / f32 rate) in ms, which of the two bounds)."""
    byte_ms = 1e3 * byte_count / HBM_BYTES_PER_S
    op_ms = 1e3 * ops / F32_OPS_PER_S
    return max(byte_ms, op_ms), ("bytes" if byte_ms >= op_ms else "operations")


def _bound_ms(x, ops, with_mask_and_grads, err_out=True):
    """Least time for these inputs of a fused kernel. Bytes: tables and
    pages read once, idx/origin(/mask or g) of occupied tiles read once,
    outputs (α, or the per-tile err if `err_out` and the gradient tables)
    written once."""
    b, pg, lanes = x["tx"].shape
    g2, p_hat = x["pages"].shape[1:]
    t2 = x["tile"] ** 2
    occ = int((x["pages"][:, :, 0] != x["dump"]).sum())
    read = 2 * b * pg * lanes * 4 + b * g2 * p_hat * 4 + occ * (3 * lanes * 4 + 2 * 4)
    if with_mask_and_grads:
        read += occ * t2 * 4
        written = (b * g2 * 4 if err_out else 0) + 2 * b * pg * lanes * 4
    else:
        written = b * g2 * t2 * 4
    return _max_bound(read + written, ops)


def _max_rel_violation(got, want, atol, rtol):
    """max |got − want| / (atol + rtol·|want|): ≤ 1 passes allclose."""
    import torch

    return float(torch.max((got - want).abs() / (atol + rtol * want.abs())))


def _grad_check(got, want):
    """Tensors against their plain versions at the kernel test's criterion
    (atol 3e-4·max|plain| + rtol 2e-4, one scale over all of them):
    (share of the tolerance used, max |Δ|, scale)."""
    scale = max(max(float(w.abs().max()) for w in want), 1e-30)
    viol = max(_max_rel_violation(a, b, GRAD_ATOL_REL * scale, GRAD_RTOL) for a, b in zip(got, want))
    err = max(float((a - b).abs().max()) for a, b in zip(got, want))
    return viol, err, scale


def _seeded_uniform(shape, seed):
    """U(−1, 1) on the card from a seeded generator: the cotangents the
    checks feed the backward kernels."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    return torch.rand(shape, generator=gen, device="cuda") * 2.0 - 1.0


def _fused_alpha_vjp_plain(tx, ty, pages, idx, origin, g, tile, inv_sigma, blur_px2):
    """Plain version of the α VJP kernel: (dtx, dty) by autograd through
    the plain α with cotangent g."""
    import torch

    from jrr_tpu_torch.render import silhouette_fused as sf

    with torch.enable_grad():
        tx_, ty_ = tx.detach().requires_grad_(True), ty.detach().requires_grad_(True)
        alpha = sf.fused_tiles_alpha_plain(tx_, ty_, pages, idx, origin, tile, inv_sigma, blur_px2)
        return torch.autograd.grad(alpha, (tx_, ty_), g)


def skip_decision_flips(alpha, alpha_plain, band=SKIP_BAND):
    """`apply_interior_skip`'s tile decisions (lo: every α of the tile ≤
    _SAT_EPS; hi: every α ≥ 1 − _SAT_EPS) from the kernel's α and from the
    plain α, both (..., T²): (tiles whose decisions differ, those of them
    whose plain α's deciding extreme, its largest α for lo and its smallest
    for hi, lies more than `band` from the threshold). Another summation
    order may move an α within a few ulp of a threshold across it; a flip
    farther out is a fault."""
    from jrr_tpu_torch.render.silhouette_fused import _SAT_EPS

    lo_flip = (alpha <= _SAT_EPS).all(-1) != (alpha_plain <= _SAT_EPS).all(-1)
    hi_flip = (alpha >= 1.0 - _SAT_EPS).all(-1) != (alpha_plain >= 1.0 - _SAT_EPS).all(-1)
    lo_far = (alpha_plain.amax(-1) - _SAT_EPS).abs() > band
    hi_far = (alpha_plain.amin(-1) - (1.0 - _SAT_EPS)).abs() > band
    return int((lo_flip | hi_flip).sum()), int(((lo_flip & lo_far) | (hi_flip & hi_far)).sum())


def _fused_flip_bounds(bins, consts):
    """`_edge_flip_bounds` of fused bins (B, G², T²), PLAIN_FRAMES frames at
    a time (the plain version's lanes: every candidate, dump triangles
    included)."""
    import torch

    from jrr_tpu_torch.render import silhouette_fused as sf

    tx, ty, pages, idx, origin = bins
    los, his, kinds = [], [], []
    for lo in range(0, tx.shape[0], PLAIN_FRAMES):
        sl = slice(lo, lo + PLAIN_FRAMES)
        tri = sf._gather_tri(tx[sl], ty[sl], pages[sl], idx[sl])
        b, g2, _, k = tri.shape
        a_lo, a_hi, kind = _edge_flip_bounds(origin[sl].reshape(b * g2, 2),
                                             tri.reshape(b * g2, 6, k), tri.new_ones(b * g2, 1, k),
                                             *consts)
        los.append(a_lo.reshape(b, g2, -1))
        his.append(a_hi.reshape(b, g2, -1))
        kinds.append(kind.reshape(b, g2, -1))
    return torch.cat(los), torch.cat(his), torch.cat(kinds)


def _fused_plain64(bins, consts, frames):
    """The float64 plain α of fused bins on the frames `frames` (B,) bool,
    zeros elsewhere: the witness of the flips there."""
    import torch

    from jrr_tpu_torch.render import silhouette_fused as sf

    tx, ty, pages, idx, origin = bins
    out = torch.zeros(tuple(pages.shape[:2]) + (consts[0] ** 2,), dtype=torch.float64,
                      device=tx.device)
    sub = (tx[frames].double(), ty[frames].double(), pages[frames], idx[frames],
           origin[frames].double())
    out[frames] = _chunked(sf.fused_tiles_alpha_plain, sub, consts)
    return out


def _flip_reach(pages, idx, edge_tiles, table_shape):
    """The coordinate-table entries (`table_shape`, as tx) of every corner
    of every candidate of the tiles that hold a decision-edge pixel: the
    gradient entries a flip there can move (it changes α, and so every
    lane's share, at its pixel)."""
    import torch

    b, g2, _, k = idx.shape
    lanes = table_shape[-1]
    slot = (idx >> 7).long().reshape(b, g2, 3 * k)
    pos = torch.gather(pages.long(), 2, slot) * lanes + (idx & (lanes - 1)).long().reshape(b, g2, 3 * k)
    fb, fg = torch.nonzero(edge_tiles, as_tuple=True)
    reach = torch.zeros(b, math.prod(table_shape[1:]), dtype=torch.bool, device=idx.device)
    reach[fb[:, None], pos[fb, fg]] = True
    return reach.reshape(table_shape)


def _hold_fused(x, where, pre_skip=True, decision_flips=False):
    """Rows 1 and 2 on one set of bins (`_kernel_inputs`): the α kernel and
    the loss kernel against their plain versions and their own repeats (bit
    for bit); with `pre_skip`, also the α kernel on the bins the interior
    skip sees (the main path's launches) and the skip's tile decisions from
    its α against those from the plain α. With `decision_flips`, the α
    kernels are held by `_hold_within_flips`, the loss kernel's err on the
    frames without a decision-edge pixel and its gradients off the entries
    a flip can reach (`_flip_reach`), and the skip's far flips on the tiles
    without such a pixel."""
    import torch

    from jrr_tpu_torch import kernels
    from jrr_tpu_torch.render import silhouette_fused as sf

    bins = (x["tx"], x["ty"], x["pages"], x["idx"], x["origin"])
    consts = (x["tile"], x["inv_sigma"], x["blur_px2"])
    alpha = kernels.fused_alpha_fwd(*bins, *consts, x["dump"])
    alpha_again = kernels.fused_alpha_fwd(*bins, *consts, x["dump"])
    alpha_plain = _chunked(sf.fused_tiles_alpha_plain, bins, consts)
    torch.cuda.synchronize()
    _check(torch.equal(alpha, alpha_again), f"{where}: two fused_alpha_fwd launches differ")
    edge_frames = lambda a, p: ((a - p).abs() > ALPHA_ATOL).flatten(1).any(1)  # noqa: E731
    row = {}
    if decision_flips:
        report, edge = _hold_within_flips(
            alpha, alpha_plain, _fused_flip_bounds(bins, consts), f"{where}: fused_alpha_fwd",
            lambda: _fused_plain64(bins, consts, edge_frames(alpha, alpha_plain)))
        a_err = report.pop("alpha_max_abs_err")
        row.update(report)
    else:
        a_err = float((alpha - alpha_plain).abs().max())
        _check(a_err <= ALPHA_ATOL, f"{where}: fused_alpha_fwd max|Δα| {a_err} > {ALPHA_ATOL}")

    err, dtx, dty = sf.fused_lossgrad(*bins, x["mask"], *consts, x["dump"])
    again = sf.fused_lossgrad(*bins, x["mask"], *consts, x["dump"])
    err_p, dtx_p, dty_p = _chunked(sf.fused_lossgrad_plain, bins + (x["mask"],), consts)
    torch.cuda.synchronize()
    _check(all(torch.equal(a, b) for a, b in zip((err, dtx, dty), again)),
           f"{where}: two fused_lossgrad launches differ")
    if decision_flips:
        keep = ~edge.flatten(1).any(1)
        reach = _flip_reach(x["pages"], x["idx"], edge.any(-1), tuple(dtx.shape))
        err, err_p = err[keep], err_p[keep]
        dtx, dty, dtx_p, dty_p = (v[~reach] for v in (dtx, dty, dtx_p, dty_p))
        row.update(err_frames=int(keep.sum()), grad_entries=int((~reach).sum()) * 2,
                   grad_entries_reached=int(reach.sum()) * 2)
    e_viol = _max_rel_violation(err, err_p, 1e-30, ERR_RTOL)
    _check(e_viol <= 1.0, f"{where}: fused_lossgrad err beyond rtol {ERR_RTOL} ({e_viol})")
    g_viol, g_err, g_scale = _grad_check((dtx, dty), (dtx_p, dty_p))
    _check(g_viol <= 1.0, f"{where}: fused_lossgrad grads beyond tolerance ({g_viol})")
    row.update(
        alpha_max_abs_err=a_err,
        err_max_rel_err=float(((err - err_p).abs() / err_p.abs().clamp_min(1e-30)).max()),
        grad_max_abs_err=g_err, grad_scale=g_scale, grad_tolerance_use=g_viol,
    )
    if pre_skip:
        pre = (x["tx"], x["ty"], *x["pre_skip"], x["origin"])
        rebin_alpha = kernels.fused_alpha_fwd(*pre, *consts, x["dump"])
        rebin_plain = _chunked(sf.fused_tiles_alpha_plain, pre, consts)
        torch.cuda.synchronize()
        tiles = slice(None)
        if decision_flips:
            report, edge = _hold_within_flips(
                rebin_alpha, rebin_plain, _fused_flip_bounds(pre, consts),
                f"{where}: fused_alpha_fwd before the skip",
                lambda: _fused_plain64(pre, consts, edge_frames(rebin_alpha, rebin_plain)))
            r_err = report.pop("alpha_max_abs_err")
            tiles = ~edge.any(-1)
            row.update({f"rebin_{k}": v for k, v in report.items()})
            row.update(skip_flips_at_edge_tiles=skip_decision_flips(
                rebin_alpha[~tiles], rebin_plain[~tiles])[0])
        else:
            r_err = float((rebin_alpha - rebin_plain).abs().max())
            _check(r_err <= ALPHA_ATOL,
                   f"{where}: fused_alpha_fwd before the skip max|Δα| {r_err} > {ALPHA_ATOL}")
        flips, far = skip_decision_flips(rebin_alpha[tiles], rebin_plain[tiles])
        _check(far == 0, f"{where}: {far} interior-skip decisions flip farther than "
                         f"{SKIP_BAND} from their threshold")
        row.update(rebin_alpha_max_abs_err=r_err, skip_flips=flips)
    return row


def check_kernels(problem):
    """Each fused kernel against its plain version at both geometries +
    all-empty (`_hold_fused`, and the α VJP kernel)."""
    import torch

    from jrr_tpu_torch import kernels
    from jrr_tpu_torch.render import silhouette_fused as sf

    report = {}
    for geometry in ("fine", "coarse", "empty"):
        x = _kernel_inputs(problem, "fine" if geometry == "empty" else geometry)
        if geometry == "empty":
            x = _empty_tiles(x)
        bins = (x["tx"], x["ty"], x["pages"], x["idx"], x["origin"])
        consts = (x["tile"], x["inv_sigma"], x["blur_px2"])
        row = _hold_fused(x, geometry, pre_skip=geometry != "empty")

        g = _seeded_uniform(tuple(x["mask"].shape), seed=3)
        bwd = kernels.fused_alpha_bwd(*bins, g, *consts, x["dump"])
        bwd_again = kernels.fused_alpha_bwd(*bins, g, *consts, x["dump"])
        bwd_p = _chunked(_fused_alpha_vjp_plain, bins + (g,), consts)
        torch.cuda.synchronize()
        _check(all(torch.equal(a, b) for a, b in zip(bwd, bwd_again)),
               f"{geometry}: two fused_alpha_bwd launches differ")
        b_viol, b_err, b_scale = _grad_check(bwd, bwd_p)
        _check(b_viol <= 1.0, f"{geometry}: fused_alpha_bwd beyond tolerance ({b_viol})")
        row.update(bwd_max_abs_err=b_err, bwd_scale=b_scale, bwd_tolerance_use=b_viol)
        # The loss kernel's dL/dα is 2·(α − mask), α = 1 − Π(1 − p) as the α
        # kernel forms it, and the α VJP runs the loss kernel's passes: on
        # the same bins the two give the same sums bit for bit.
        g_loss = 2.0 * (kernels.fused_alpha_fwd(*bins, *consts, x["dump"]) - x["mask"])
        via_bwd = kernels.fused_alpha_bwd(*bins, g_loss, *consts, x["dump"])
        via_loss = kernels.fused_lossgrad(*bins, x["mask"], *consts, x["dump"])[1:]
        torch.cuda.synchronize()
        row["bwd_equals_lossgrad"] = all(torch.equal(a, b) for a, b in zip(via_bwd, via_loss))
        _check(row["bwd_equals_lossgrad"],
               f"{geometry}: fused_alpha_bwd at 2(α − mask) differs from fused_lossgrad's gradients")
        if geometry != "empty":
            pre = (x["tx"], x["ty"], *x["pre_skip"], x["origin"])
            row["fwd_rebin_ms"] = _time_ms(lambda: kernels.fused_alpha_fwd(*pre, *consts, x["dump"]), 20)
            pairs, near, active, occ = _pair_counts(x)
            row.update(occupied_tiles=occ, pairs=pairs, near_pairs=near, active_pairs=active,
                       near_share=near / pairs, **_pass_efficiencies(x))
            row["fwd_ms"] = _time_ms(lambda: kernels.fused_alpha_fwd(*bins, *consts, x["dump"]), 20)
            row["lossgrad_ms"] = _time_ms(
                lambda: kernels.fused_lossgrad(*bins, x["mask"], *consts, x["dump"]), 20
            )
            row["fwd_plain_ms"] = _time_ms(lambda: _chunked(sf.fused_tiles_alpha_plain, bins, consts), 1)
            row["lossgrad_plain_ms"] = _time_ms(
                lambda: _chunked(sf.fused_lossgrad_plain, bins + (x["mask"],), consts), 1
            )
            row["bwd_ms"] = _time_ms(
                lambda: kernels.fused_alpha_bwd(*bins, g, *consts, x["dump"]), 20
            )
            row["bwd_plain_ms"] = _time_ms(
                lambda: _chunked(_fused_alpha_vjp_plain, bins + (g,), consts), 1
            )
            row["bwd_over_lossgrad"] = row["bwd_ms"] / row["lossgrad_ms"]
            fwd_ops, grad_ops = _ops(pairs, near, active, False), _ops(pairs, near, active, True)
            row["fwd_bound_ms"], row["fwd_bound_by"] = _bound_ms(x, fwd_ops, False)
            row["lossgrad_bound_ms"], row["lossgrad_bound_by"] = _bound_ms(x, grad_ops, True)
            row["bwd_bound_ms"], row["bwd_bound_by"] = _bound_ms(x, grad_ops, True, err_out=False)
        report[geometry] = row
    return report


def _packed_pair_counts(x, packed):
    """`_pair_counts` of the lane-packed layout: (pairs of a real candidate
    lane in an occupied row, those in the face's pixel box and those with
    0 < p < 1, each lane at its own half's origin, occupied rows)."""
    from jrr_tpu_torch.render import silhouette_fused as sf

    half = sf.K_HALF
    occupied = packed.p_pages[:, :, 0] != x["dump"]
    real = (packed.p_idx[:, :, 0, :] >> 7) != packed.p_pages.shape[2] - 1
    pairs = int((real & occupied[..., None]).sum()) * x["tile"] ** 2
    near = active = 0
    for lo in range(0, x["tx"].shape[0], PLAIN_FRAMES):
        sl = slice(lo, lo + PLAIN_FRAMES)
        occ = occupied[sl]
        tri = sf._gather_tri(x["tx"][sl], x["ty"][sl], packed.p_pages[sl], packed.p_idx[sl])[occ]
        for lanes, origin in ((slice(0, half), x["origin"]), (slice(half, None), packed.p_origin_b)):
            n, a = _near_and_active_pairs(tri[..., lanes], origin[sl][occ], x["tile"],
                                          x["inv_sigma"], x["blur_px2"], real[sl][occ][..., lanes])
            near, active = near + n, active + a
    return pairs, near, active, int(occupied.sum())


def _packed_bound_ms(x, packed, ops):
    """Least time of the packed loss kernel for these inputs. Bytes: tables
    and page lists read once; per occupied row its idx, both origins, flag
    and buddy id; each occupied tile's mask row once (a pair reads two);
    err per row and the gradient tables written once."""
    b, pg, lanes = x["tx"].shape
    g2, p_hat = packed.p_pages.shape[1:]
    rows = int((packed.p_pages[:, :, 0] != x["dump"]).sum())
    tiles = int((x["pages"][:, :, 0] != x["dump"]).sum())
    read = (2 * b * pg * lanes * 4 + b * g2 * p_hat * 4 + rows * (3 * lanes * 4 + 4 * 4 + 2 * 4)
            + tiles * x["tile"] ** 2 * 4)
    written = b * g2 * 4 + 2 * b * pg * lanes * 4
    return _max_bound(read + written, ops)


def check_packed_kernel(problem):
    """The lane-packed loss kernel on the main path's fused bins after the
    interior skip and `pack_bins`, at the first rebin of each c2f phase
    (224²/tile 8, 112²/tile 4) plus all-empty, held against its plain
    version (err rtol ERR_RTOL, gradients at the kernel test's criterion),
    against the unpacked kernel on the same bins (at bin time the two are
    one function: err rtol 2e-5, gradients atol 5e-5·max, the contract of
    tests/test_lane_pack.py) and against its own repeat (bit for bit). Its
    NORMAL rows (flags 0, an unpacked tile's lanes in order) run the
    unpacked kernel's work in its order: their per-row err must equal that
    kernel's per-tile err bit for bit."""
    import torch

    from jrr_tpu_torch import kernels
    from jrr_tpu_torch.render import silhouette_fused as sf

    report = {}
    for geometry in ("fine", "coarse", "empty"):
        x = _kernel_inputs(problem, "fine" if geometry == "empty" else geometry)
        if geometry == "empty":
            x = _empty_tiles(x)
        packed = sf.pack_bins(x["bins"], x["num_verts"])
        args = (x["tx"], x["ty"], packed.p_pages, packed.p_idx, x["origin"], packed.p_origin_b,
                packed.p_flags, packed.p_buddy, x["mask"])
        unpacked_args = (x["tx"], x["ty"], x["pages"], x["idx"], x["origin"], x["mask"])
        consts = (x["tile"], x["inv_sigma"], x["blur_px2"])

        got = sf.fused_lossgrad_packed(*args, *consts, x["dump"])
        again = sf.fused_lossgrad_packed(*args, *consts, x["dump"])
        plain = _chunked(sf.fused_lossgrad_packed_plain, args, consts)
        unpacked = sf.fused_lossgrad(*unpacked_args, *consts, x["dump"])
        err_rows = kernels.fused_lossgrad_packed(*args, *consts, x["dump"])[0]
        err_tiles = kernels.fused_lossgrad(*unpacked_args, *consts, x["dump"])[0]
        normal = (packed.p_flags == 0) & (packed.p_pages[:, :, 0] != x["dump"])
        torch.cuda.synchronize()
        _check(all(torch.equal(a, b) for a, b in zip(got, again)),
               f"{geometry}: two packed kernel runs differ")
        _check(torch.equal(err_rows[normal], err_tiles[normal]),
               f"{geometry}: packed NORMAL rows' err differs from fused_lossgrad's")
        e_viol = _max_rel_violation(got[0], plain[0], 1e-30, ERR_RTOL)
        _check(e_viol <= 1.0, f"{geometry}: packed err beyond rtol {ERR_RTOL} of plain ({e_viol})")
        g_viol, g_err, g_scale = _grad_check(got[1:], plain[1:])
        _check(g_viol <= 1.0, f"{geometry}: packed grads beyond tolerance of plain ({g_viol})")
        u_err_viol = _max_rel_violation(got[0], unpacked[0], 1e-30, 2e-5)
        u_scale = max(float(u.abs().max()) for u in unpacked[1:])
        u_grad = max(float((a - b).abs().max()) for a, b in zip(got[1:], unpacked[1:]))
        _check(u_err_viol <= 1.0 and u_grad <= 5e-5 * u_scale,
               f"{geometry}: packed vs unpacked kernel err {u_err_viol}, grads {u_grad} (scale {u_scale})")
        pairs_per_frame = packed.p_num_pairs.float()
        row = dict(
            err_max_rel_err=float(((got[0] - plain[0]).abs() / plain[0].abs().clamp_min(1e-30)).max()),
            grad_max_abs_err=g_err, grad_scale=g_scale, grad_tolerance_use=g_viol,
            vs_unpacked_err_tolerance_use=u_err_viol, vs_unpacked_grad_max_abs=u_grad,
            vs_unpacked_grad_tolerance_use=u_grad / (5e-5 * max(u_scale, 1e-30)),
            entries=int(packed.p_pages.shape[0] * packed.p_pages.shape[1]),
            normal_rows=int(normal.sum()), primary_rows=int((packed.p_flags == 1).sum()),
            pairs_per_frame=[float(pairs_per_frame.mean()), int(packed.p_num_pairs.min()),
                             int(packed.p_num_pairs.max())],
        )
        if geometry != "empty":
            pairs, near, active, rows = _packed_pair_counts(x, packed)
            u_pairs, _, u_active, occ = _pair_counts(x)
            row.update(occupied_tiles=occ, occupied_rows=rows, pairs=pairs, near_pairs=near,
                       active_pairs=active, unpacked_pairs=u_pairs, unpacked_active_pairs=u_active)
            row["ms"] = _time_ms(lambda: kernels.fused_lossgrad_packed(*args, *consts, x["dump"]), 20)
            row["unpacked_ms"] = _time_ms(lambda: kernels.fused_lossgrad(*unpacked_args, *consts, x["dump"]), 20)
            row["packed_over_unpacked"] = row["ms"] / row["unpacked_ms"]
            row["plain_ms"] = _time_ms(lambda: _chunked(sf.fused_lossgrad_packed_plain, args, consts), 1)
            row["pack_ms"] = _time_ms(lambda: sf.pack_bins(x["bins"], x["num_verts"]), 3)
            row["pack_device_ms"] = 1e3 * _profile(
                f"profile_pack_{geometry}.txt", row["pack_ms"] / 1e3,
                lambda: sf.pack_bins(x["bins"], x["num_verts"]),
            )["device_busy_s"]
            row["bound_ms"], row["bound_by"] = _packed_bound_ms(x, packed, _ops(pairs, near, active, True))
        report[geometry] = row
    return report


def _tile_inputs(problem, geometry):
    """The packed tiles (origin, tri, valid) the round-1 path hands the tile
    kernels at its first rebin of one c2f phase: round-1 bins of the
    synthetic problem at its initial parameters."""
    import torch

    from jrr_tpu_torch.refine import losses
    from jrr_tpu_torch.render import camera
    from jrr_tpu_torch.render import silhouette as sil

    model, _, cfg, init, data = problem
    cfg, _ = _geometry(cfg, data.mask, geometry)
    spec = losses.rasterizer_spec(cfg)
    with torch.no_grad():
        verts = losses.forward_frame(model, init).vertices
        bins = sil.compute_bins(verts, model.faces, init.cam_t, spec)
        screen = camera.project_points_screen(verts, init.cam_t, spec.image_size, spec.focal_length)
        origin, tri, valid = sil.packed_tiles(screen, model.faces, spec, bins)
    inv_sigma, blur_px2 = sil.tile_constants(spec)
    return dict(origin=origin, tri=tri, valid=valid, tile=spec.tile_size, inv_sigma=inv_sigma,
                blur_px2=blur_px2, tiles_per_frame=bins.origin.shape[1])


def _tiles_alpha_vjp_plain(origin, tri, valid, g, tile, inv_sigma, blur_px2):
    """Plain version of the tile backward kernel: d tri by autograd."""
    import torch

    from jrr_tpu_torch.render import silhouette_pallas as sp

    with torch.enable_grad():
        t = tri.detach().requires_grad_(True)
        alpha = sp.tiles_alpha_plain(origin, t, valid, tile, inv_sigma, blur_px2)
        return torch.autograd.grad(alpha, (t,), g)[0]


def _tile_pair_counts(t):
    """(pixel, valid lane) pairs of these tiles, those in the face's pixel
    box, those with 0 < p < 1, the occupied tiles (any valid lane) and the
    valid lanes."""
    valid = t["valid"][:, 0, :] > 0
    occupied = valid.any(dim=-1)
    lanes = int(valid.sum())
    near = active = 0
    step = PLAIN_FRAMES * t["tiles_per_frame"]
    for lo in range(0, valid.shape[0], step):
        occ = occupied[lo:lo + step]
        n, a = _near_and_active_pairs(t["tri"][lo:lo + step][occ], t["origin"][lo:lo + step][occ],
                                      t["tile"], t["inv_sigma"], t["blur_px2"],
                                      valid[lo:lo + step][occ])
        near, active = near + n, active + a
    return lanes * t["tile"] ** 2, near, active, int(occupied.sum()), lanes


def _tile_bound_ms(t, ops, backward, occ, lanes):
    """Least time of a tile kernel for these inputs. Bytes: the valid rows
    of every tile, origin of occupied tiles and the six corner values of
    each valid lane read once (and g of occupied tiles for the backward);
    α (N, T²), or d tri (N, 6, 128) for the backward, written once."""
    n = t["valid"].shape[0]
    t2 = t["tile"] ** 2
    read = n * 128 * 4 + occ * 2 * 4 + lanes * 6 * 4
    if backward:
        read += occ * t2 * 4
        written = n * 6 * 128 * 4
    else:
        written = n * t2 * 4
    return _max_bound(read + written, ops)


def check_tile_kernels(problem):
    """The round-1 tile kernels (forward and backward) against their plain
    versions on the round-1 bins at both geometries + all-empty, and each
    against its own repeat (bit for bit)."""
    import torch

    from jrr_tpu_torch import kernels
    from jrr_tpu_torch.render import silhouette_pallas as sp

    report = {}
    for geometry in ("fine", "coarse", "empty"):
        t = _tile_inputs(problem, "fine" if geometry == "empty" else geometry)
        if geometry == "empty":
            t["valid"] = torch.zeros_like(t["valid"])
        args = (t["origin"], t["tri"], t["valid"])
        consts = (t["tile"], t["inv_sigma"], t["blur_px2"])
        per = PLAIN_FRAMES * t["tiles_per_frame"]  # plain versions: 8 frames of tiles at a time
        g = _seeded_uniform((t["origin"].shape[0], t["tile"] ** 2), seed=5)

        alpha = kernels.tiles_alpha_fwd(*args, *consts)
        alpha_again = kernels.tiles_alpha_fwd(*args, *consts)
        alpha_p = _chunked(sp.tiles_alpha_plain, args, consts, per)
        dtri = kernels.tiles_alpha_bwd(*args, g, *consts)
        dtri_again = kernels.tiles_alpha_bwd(*args, g, *consts)
        dtri_p = _chunked(_tiles_alpha_vjp_plain, args + (g,), consts, per)
        torch.cuda.synchronize()
        _check(torch.equal(alpha, alpha_again), f"{geometry}: two tiles_alpha_fwd launches differ")
        _check(torch.equal(dtri, dtri_again), f"{geometry}: two tiles_alpha_bwd launches differ")
        a_err = float((alpha - alpha_p).abs().max())
        _check(a_err <= ALPHA_ATOL, f"{geometry}: tiles_alpha_fwd max|Δα| {a_err} > {ALPHA_ATOL}")
        viol, err, scale = _grad_check((dtri,), (dtri_p,))
        _check(viol <= 1.0, f"{geometry}: tiles_alpha_bwd beyond tolerance ({viol})")
        if geometry == "empty":
            _check(not alpha.any() and not dtri.any(), "empty tiles: α and d tri must be zero")
        row = dict(alpha_max_abs_err=a_err, bwd_max_abs_err=err, bwd_scale=scale,
                   bwd_tolerance_use=viol)
        if geometry != "empty":
            pairs, near, active, occ, lanes = _tile_pair_counts(t)
            row.update(tiles=t["origin"].shape[0], occupied_tiles=occ, valid_lanes=lanes,
                       pairs=pairs, near_pairs=near, active_pairs=active)
            row["fwd_ms"] = _time_ms(lambda: kernels.tiles_alpha_fwd(*args, *consts), 20)
            row["bwd_ms"] = _time_ms(lambda: kernels.tiles_alpha_bwd(*args, g, *consts), 20)
            row["fwd_plain_ms"] = _time_ms(lambda: _chunked(sp.tiles_alpha_plain, args, consts, per), 1)
            row["bwd_plain_ms"] = _time_ms(
                lambda: _chunked(_tiles_alpha_vjp_plain, args + (g,), consts, per), 1
            )
            row["fwd_bound_ms"], row["fwd_bound_by"] = _tile_bound_ms(
                t, _ops(pairs, near, active, False), False, occ, lanes
            )
            row["bwd_bound_ms"], row["bwd_bound_by"] = _tile_bound_ms(
                t, _ops(pairs, near, active, True), True, occ, lanes
            )
        report[geometry] = row
    return report


def _read_launches():
    from jrr_tpu_torch import kernels

    return {w.__name__: w.launches for w in kernels.WRAPPERS}


def _launches(**counts):
    """Every wrapper's expected launch count: those given, 0 for the rest."""
    from jrr_tpu_torch import kernels

    return {w.__name__: counts.get(w.__name__, 0) for w in kernels.WRAPPERS}


def _ptxas(kernel: str):
    """Registers, spills and static shared memory that `ptxas -v` reported
    for the entry function `kernel` in this process's build (None when the
    library was built before, or for a name no entry has). A template
    instance is named as `name<Type, N>`."""
    import re

    from jrr_tpu_torch import kernels

    # The name as the mangled symbol holds it: <length><name>, and for an
    # instance of a template in the file's anonymous namespace
    # I NS_<length><Type>E Li<N>E E.
    m = re.fullmatch(r"(\w+)<(\w+), (\d+)>", kernel)
    tag = (f"{len(m[1])}{m[1]}INS_{len(m[2])}{m[2]}ELi{m[3]}EE" if m
           else f"{len(kernel)}{kernel}")
    lines = kernels.build_info.get("ptxas", "").splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and tag in line:
            block = " ".join(lines[i + 1:i + 4])
            nums = {key: re.search(pattern, block) for key, pattern in (
                ("registers", r"Used (\d+) registers"), ("spill_stores", r"(\d+) bytes spill stores"),
                ("spill_loads", r"(\d+) bytes spill loads"), ("smem_bytes", r"(\d+) bytes smem"))}
            return {key: int(m.group(1)) if m else 0 for key, m in nums.items()}
    return None


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
        launches = _read_launches()
        _check(launches == _launches(fused_lossgrad=38, fused_alpha_fwd=2),
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
    """One more refine_batch under torch.profiler (chiprun_out/profile.txt)."""
    from jrr_tpu_torch.refine import engine

    model, j_reg, cfg, init, data = problem
    cfg = dataclasses.replace(cfg, stage_a_steps=1000, stage_b_steps=100)
    return _profile(
        "profile.txt", timed_seconds,
        lambda: engine.refine_batch(model, j_reg, init, data, cfg, pose_disc, shape_disc),
    )


def _profile(filename, timed_seconds, fn):
    """`fn()` once under torch.profiler: device time by kernel (written to
    chiprun_out/`filename`) and the device-idle share of the timed,
    unprofiled run of the same work (1 − device-busy s / `timed_seconds`)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    # Device activity only: nothing here reads the host's operator trace.
    start = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # Device-side events only (kernels, copies, fills).
    rows = sorted(
        ((e.self_device_time_total, e.count, e.key) for e in prof.key_averages()
         if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
        reverse=True,
    )
    busy_s = sum(r[0] for r in rows) / 1e6
    overhead_s = time.perf_counter() - start - wall  # profiler set-up and aggregation
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, filename), "w") as f:
        f.write(f"profiled_wall_s {wall:.6f} device_busy_s {busy_s:.6f}\n")
        for us, n, key in rows[:60]:
            f.write(f"{us / 1e3:12.3f} ms {n:8d}  {key[:160]}\n")
    return dict(
        profiled_wall_s=wall, profiler_overhead_s=overhead_s, device_busy_s=busy_s,
        timed_run_s=timed_seconds,
        device_idle_share=max(0.0, 1.0 - busy_s / timed_seconds),
        kernel_launches=sum(r[1] for r in rows),
        top=[{"ms": us / 1e3, "count": n, "kernel": key[:80]} for us, n, key in rows[:8]],
    )


@contextlib.contextmanager
def _plain_versions():
    """Route the rasterizers' kernel wrappers to their plain versions on any
    device, for the reference runs only (the wrappers themselves never fall
    back)."""
    from jrr_tpu_torch.render import silhouette_fused as sf
    from jrr_tpu_torch.render import silhouette_pallas as sp

    saved = sf.fused_tiles_alpha, sf.fused_lossgrad, sf.fused_lossgrad_packed, sp.tiles_alpha
    sf.fused_tiles_alpha = lambda *args: sf.fused_tiles_alpha_plain(*args[:-1])  # drops dump_page
    sf.fused_lossgrad = lambda *args: sf.fused_lossgrad_plain(*args[:-1])
    sf.fused_lossgrad_packed = lambda *args: sf.fused_lossgrad_packed_plain(*args[:-1])
    sp.tiles_alpha = sp.tiles_alpha_plain
    try:
        yield
    finally:
        sf.fused_tiles_alpha, sf.fused_lossgrad, sf.fused_lossgrad_packed, sp.tiles_alpha = saved


def _with_backend(cfg, backend, lane_pack=False):
    return dataclasses.replace(cfg, silhouette=dataclasses.replace(
        cfg.silhouette, backend=backend, lane_pack=lane_pack))


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


def short_refine(problem, pose_disc, shape_disc, plain=False, float64=False, backend="auto",
                 lane_pack=False):
    """refine_batch on `problem` (a `short_problem`) with 20 + 10 steps, the
    silhouette `backend` and `lane_pack`: through the kernels, or (plain=True) through
    the plain versions with PyTorch's deterministic algorithms on (their
    gather backward otherwise adds with float atomics), in float32 or
    float64."""
    import torch

    from jrr_tpu_torch.refine import engine

    if float64:
        problem, pose_disc, shape_disc = _float64(problem, pose_disc, shape_disc)
    model, j_reg, cfg, init, data = problem
    cfg = dataclasses.replace(_with_backend(cfg, backend, lane_pack), stage_a_steps=20,
                              stage_b_steps=10)
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
    at the same inputs: full width, batch 2, both c2f geometries, three
    configurations (fused: loss kernel; fused_lane_pack: the packed loss
    kernel on `pack_bins`; pallas: round-1 tile kernels), every seed.
    The kernel test's criterion (atol 3e-4·max|plain| + rtol 2e-4) per
    parameter tensor. Unlike the refinement, no optimizer amplifies the
    last bits here."""
    import torch

    from jrr_tpu_torch import problem as problem_lib
    from jrr_tpu_torch.refine import engine, losses
    from jrr_tpu_torch.render import silhouette as sil
    from jrr_tpu_torch.render import silhouette_fused as sf

    worst = {b: {"fine": 0.0, "coarse": 0.0} for b in ("fused", "fused_lane_pack", "pallas")}
    for seed in seeds:
        model, j_reg, cfg, init, data = problem_lib.synthetic_problem(batch=2, seed=seed, device="cuda")
        # Stage A alone (20 camera steps) gives stage B's starting point.
        start = engine.refine_batch(
            model, j_reg, init, data, dataclasses.replace(cfg, stage_a_steps=20, stage_b_steps=0)
        ).params
        for backend in worst:
            for geometry in worst[backend]:
                gcfg, mask = _geometry(_with_backend(cfg, backend.split("_")[0]), data.mask, geometry)
                spec = losses.rasterizer_spec(gcfg)
                with torch.no_grad():
                    verts = losses.forward_frame(model, start).vertices
                    if backend.startswith("fused"):
                        bins = sf.compute_fused_bins(verts, model, start.cam_t, spec)
                        bins = sf.apply_interior_skip(bins, verts, model, start.cam_t, spec)
                        if backend == "fused_lane_pack":
                            bins = sf.pack_bins(bins, model.num_verts)
                    else:
                        bins = sil.compute_bins(verts, model.faces, start.cam_t, spec)

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
                worst[backend][geometry] = max(worst[backend][geometry], viol)
                _check(viol <= 1.0,
                       f"seed {seed} {backend} {geometry}: silhouette gradient beyond tolerance ({viol})")
    return dict(seeds=list(seeds), batch=2, stage_a_steps=20,
                tolerance=f"atol {GRAD_ATOL_REL}*max|plain| + rtol {GRAD_RTOL} per parameter",
                max_tolerance_use=worst)


def run_round1_path(problem, pose_disc, shape_disc):
    """refine_batch with silhouette.backend="pallas" at full width and
    depth: a warm-up, then one timed run with the launch counts set to 0
    just before it and read just after; then two short kernel refinements
    (seed 1) that must agree bit for bit."""
    import torch

    from jrr_tpu_torch import kernels
    from jrr_tpu_torch.refine import engine

    model, j_reg, cfg, init, data = problem
    cfg = dataclasses.replace(_with_backend(cfg, "pallas"), stage_a_steps=1000, stage_b_steps=100)
    engine.refine_batch(model, j_reg, init, data, cfg, pose_disc, shape_disc)
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    res = engine.refine_batch(model, j_reg, init, data, cfg, pose_disc, shape_disc)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = _read_launches()
    _check(launches == _launches(tiles_alpha_fwd=38, tiles_alpha_bwd=38),
           f"round-1 path launches {launches}, expected 38 tiles_alpha_fwd + 38 tiles_alpha_bwd")
    total = res.stage_b_terms.total
    first, last = float(total[0]), float(total[-1])
    _check(last < first, f"round-1 stage-B total did not decrease: {first} -> {last}")
    _check(all(bool(torch.isfinite(p).all()) for p in res.params), "round-1: non-finite params")
    _check(res.bin_stats is None, "round-1 bins carry no capacity counters")
    prof = _profile(
        "profile_round1.txt", seconds,
        lambda: engine.refine_batch(model, j_reg, init, data, cfg, pose_disc, shape_disc),
    )

    short = short_problem(1)
    k1 = short_refine(short, pose_disc, shape_disc, backend="pallas")
    k2 = short_refine(short, pose_disc, shape_disc, backend="pallas")
    repeat = _max_param_diff(k1, k2)
    _check(repeat == 0.0, f"two round-1 kernel refinements differ by {repeat}")
    _check(int((k1.stage_b_terms.silhouette != 0).sum()) > 0, "the short round-1 run had no silhouette")
    return dict(
        batch=BATCH, stage_a_steps=1000, stage_b_steps=100, seconds=seconds,
        frames_per_s=BATCH / seconds, launches=launches,
        stage_b_total_first_last=[first, last], short_repeat_diff=repeat, profile=prof,
        card=_card(),
    ), launches, res


def run_xla_path(problem, pose_disc, shape_disc, round1_res, round1_launches):
    """`xla_path`: silhouette.backend="xla", the XLA tile loop (top-K bins,
    plain PyTorch coverage over checkpointed chunks of tiles) and its
    dispatch.
    - `render_mesh_silhouette` at batch 256, full width, 224², with no bin
      margin: α against row 5's render of the same vertices (round-1
      binning with the tile cap the widest face needs, so that both list
      the same faces) within ALPHA_ATOL; seconds and peak memory of its
      forward and of forward + backward;
    - the vertex gradient of Σ w·α on the first XLA_GRAD_FRAMES frames
      against the plain round-1 route's (the kernel gradient tolerance);
    - `refine_batch(backend="xla")` at the shipped defaults (rebin 50: the
      round-1 bins and route) equal to round1_path's run bit for bit, with
      the same row 5 and 6 launches;
    - a rebin_interval=1 refinement at batch XLA_REFINE_BATCH, 1000 + 100
      steps, every active step through the tile loop: seconds, no kernel
      launched, finite parameters, a falling stage-B loss."""
    import torch

    from jrr_tpu_torch import kernels
    from jrr_tpu_torch.refine import engine, losses
    from jrr_tpu_torch.render import camera
    from jrr_tpu_torch.render import silhouette as sil

    model, j_reg, cfg, init, data = problem
    spec = losses.rasterizer_spec(cfg)._replace(bin_margin_px=0.0)
    with torch.no_grad():
        verts = losses.forward_frame(model, init).vertices
        # Round-1 binning drops the faces whose padded bbox spans more than
        # max_tiles_per_face tiles on an axis; top-K binning has no cap. Row
        # 5 is held with the cap the widest face here needs.
        xy = camera.project_points_screen(verts, init.cam_t, spec.image_size,
                                          spec.focal_length)[:, model.faces, :2]
        pad, t = 0.5 + spec.image_size / 2 * spec.blur_radius ** 0.5, spec.tile_size
        span = torch.floor((xy.amax(2) + pad) / t) - torch.floor((xy.amin(2) - pad) / t) + 1
        cap = int(span.clamp(1, spec.image_size // t).max())
        del xy, span
    xla = spec._replace(backend="xla")
    round1 = spec._replace(backend="pallas", max_tiles_per_face=max(cap, spec.max_tiles_per_face))
    weights = _seeded_uniform((BATCH, spec.image_size, spec.image_size), 3)

    def timed(fn):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, (torch.cuda.max_memory_allocated() - base) / 1e9

    with torch.no_grad():
        alpha, fwd_s, fwd_gb = timed(lambda: sil.render_mesh_silhouette(
            verts, model.faces, init.cam_t, xla))
        kernels.reset_launches()
        alpha_r1 = sil.render_mesh_silhouette(verts, model.faces, init.cam_t, round1)
        _check(_read_launches() == _launches(tiles_alpha_fwd=1), "xla_path: row 5 not launched")
    err = float((alpha - alpha_r1).abs().max())
    _check(err <= ALPHA_ATOL and float(alpha.sum()) > 0,
           f"xla_path: tile-loop α differs from row 5's by {err}")

    def grad(v, s):
        v = v.detach().requires_grad_(True)
        a = sil.render_mesh_silhouette(v, model.faces, init.cam_t[: v.shape[0]], s)
        (g,) = torch.autograd.grad((a * weights[: v.shape[0]]).sum(), [v])
        return g

    _, bwd_s, bwd_gb = timed(lambda: grad(verts, xla))
    sub = verts[:XLA_GRAD_FRAMES]
    got = grad(sub, xla)
    with _plain_versions():
        want = grad(sub, round1)
    viol = _max_rel_violation(got, want, GRAD_ATOL_REL * float(want.abs().max()), GRAD_RTOL)
    _check(viol <= 1.0, f"xla_path: tile-loop gradient beyond tolerance ({viol})")

    full = dataclasses.replace(_with_backend(cfg, "xla"), stage_a_steps=1000, stage_b_steps=100)
    _check(full.silhouette.rebin_interval > 1, "xla_path: shipped rebin_interval changed")
    kernels.reset_launches()
    t0 = time.perf_counter()
    res = engine.refine_batch(model, j_reg, init, data, full, pose_disc, shape_disc)
    torch.cuda.synchronize()
    binned_s = time.perf_counter() - t0
    launches = _read_launches()
    _check(launches == round1_launches, f"xla_path launches {launches}, round-1 {round1_launches}")
    same = all(torch.equal(a, b) for a, b in zip(res.params, round1_res.params))
    _check(same and torch.equal(res.stage_b_terms.total, round1_res.stage_b_terms.total),
           "xla_path: backend='xla' with bins differs from backend='pallas'")

    sl = slice(0, XLA_REFINE_BATCH)
    small = (type(init)(*(x[sl] for x in init)), type(data)(*(x[sl] for x in data)))
    loop = dataclasses.replace(full, silhouette=dataclasses.replace(full.silhouette, rebin_interval=1))
    kernels.reset_launches()
    t0 = time.perf_counter()
    res = engine.refine_batch(model, j_reg, *small, loop, pose_disc, shape_disc)
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    _check(_read_launches() == _launches(), "xla_path: the tile loop launched a kernel")
    total = res.stage_b_terms.total
    first, last = float(total[0]), float(total[-1])
    _check(all(bool(torch.isfinite(p).all()) for p in res.params) and last < first,
           f"xla_path: tile-loop refinement non-finite or not falling ({first} -> {last})")
    return dict(
        render=dict(batch=BATCH, alpha_max_abs_err_vs_row5=err, tolerance=ALPHA_ATOL,
                    row5_max_tiles_per_face=round1.max_tiles_per_face,
                    fwd_seconds=fwd_s, fwd_peak_gb=fwd_gb, fwd_bwd_seconds=bwd_s,
                    fwd_bwd_peak_gb=bwd_gb, grad_frames=XLA_GRAD_FRAMES,
                    grad_tolerance_use=viol),
        binned=dict(batch=BATCH, seconds=binned_s, launches=launches, equal_to_round1=True),
        tile_loop=dict(batch=XLA_REFINE_BATCH, stage_a_steps=1000, stage_b_steps=100,
                       seconds=loop_s, silhouette_steps=int((res.stage_b_terms.silhouette != 0).sum()),
                       stage_b_total_first_last=[first, last]),
        card=_card(),
    )


def _active_steps(steps: int, stride: int) -> int:
    return len(range(0, steps, max(1, stride)))


def run_lane_pack_path(problem, pose_disc, shape_disc, packed_checks, fused_checks, fused_busy_s):
    """refine_batch with silhouette.lane_pack=True at full width and depth,
    otherwise shipped defaults: a warm-up, then LANE_PACK_PAIRS pairs of
    timed runs with the unpacked configuration, in turns A B B A (the call
    is host-bound, so only turns in one phase compare), each with the launch
    counts set to 0 just before it and read just after (every active
    silhouette step of a packed run through the packed kernel, none through
    the unpacked one); then two short kernel refinements (seed 1) that must
    agree bit for bit. Not profiled (a profile costs 25-30 s): the
    device-busy seconds are derived from the fused cell's profile in this
    run, with each loss launch's time swapped from the unpacked kernel's to
    the packed kernel's at its phase's geometry, plus one pack pass (its
    profiled device time) per rebin."""
    import torch

    from jrr_tpu_torch import kernels
    from jrr_tpu_torch.refine import engine

    model, j_reg, cfg, init, data = problem
    cfg = dataclasses.replace(cfg, stage_a_steps=1000, stage_b_steps=100)
    packed_cfg = _with_backend(cfg, "auto", lane_pack=True)
    sil = cfg.silhouette
    coarse_steps = int(sil.coarse_frac * cfg.stage_b_steps)
    phase_steps = {"coarse": _active_steps(coarse_steps, sil.coarse_step_stride or sil.step_stride),
                   "fine": _active_steps(cfg.stage_b_steps - coarse_steps, sil.step_stride)}
    active = sum(phase_steps.values())
    engine.refine_batch(model, j_reg, init, data, packed_cfg, pose_disc, shape_disc)
    torch.cuda.synchronize()
    seconds = {"lane_pack": [], "unpacked": []}
    runs = {"lane_pack": (packed_cfg, _launches(fused_lossgrad_packed=active, fused_alpha_fwd=2)),
            "unpacked": (cfg, _launches(fused_lossgrad=active, fused_alpha_fwd=2))}
    for pair in range(LANE_PACK_PAIRS):
        order = ("lane_pack", "unpacked") if pair % 2 == 0 else ("unpacked", "lane_pack")
        for name in order:
            run_cfg, want = runs[name]
            kernels.reset_launches()
            t0 = time.perf_counter()
            res = engine.refine_batch(model, j_reg, init, data, run_cfg, pose_disc, shape_disc)
            torch.cuda.synchronize()
            seconds[name].append(time.perf_counter() - t0)
            launches = _read_launches()
            _check(launches == want, f"{name} run launches {launches}, expected {want}")
            if name == "lane_pack":
                packed_res, packed_launches = res, launches
    total = packed_res.stage_b_terms.total
    first, last = float(total[0]), float(total[-1])
    _check(last < first, f"lane-pack stage-B total did not decrease: {first} -> {last}")
    _check(all(bool(torch.isfinite(p).all()) for p in packed_res.params), "lane-pack: non-finite params")

    short = short_problem(1)
    k1 = short_refine(short, pose_disc, shape_disc, lane_pack=True)
    k2 = short_refine(short, pose_disc, shape_disc, lane_pack=True)
    repeat = _max_param_diff(k1, k2)
    _check(repeat == 0.0, f"two lane-packed kernel refinements differ by {repeat}")
    _check(int((k1.stage_b_terms.silhouette != 0).sum()) > 0, "the short lane-pack run had no silhouette")

    swap_s = sum(
        n * (packed_checks[g]["ms"] - fused_checks[g]["lossgrad_ms"]) + packed_checks[g]["pack_device_ms"]
        for g, n in phase_steps.items()
    ) / 1e3
    mean = lambda xs: sum(xs) / len(xs)  # noqa: E731
    return dict(
        batch=BATCH, stage_a_steps=1000, stage_b_steps=100, seconds_runs=seconds["lane_pack"],
        unpacked_seconds_runs=seconds["unpacked"], frames_per_s=BATCH / mean(seconds["lane_pack"]),
        unpacked_frames_per_s=BATCH / mean(seconds["unpacked"]),
        launches=packed_launches, active_silhouette_steps=phase_steps,
        stage_b_total_first_last=[first, last], short_repeat_diff=repeat,
        bin_stats={k: int(v) for k, v in packed_res.bin_stats._asdict().items()},
        device_busy_s_derived=fused_busy_s + swap_s,
        device_busy_derivation="fused cell's profiled busy s + per active step (packed − unpacked "
                               "loss kernel ms at its geometry) + one pack pass (device ms) per rebin",
        card=_card(),
    ), packed_launches


def run_probes():
    """Rows 7-10: each probe kernel against its plain version at the probe
    tools' shapes (jrr_tpu_torch/probes/), with its time, the plain
    version's, the bound and one PyTorch call's for the same function. The
    two read-modify-write probes (row 7's gather + RMW, 9E's RMW) sum int64
    fixed point in resident per-CTA tables: their int64 tables must equal
    their fixed-point plain versions' exactly."""
    import numpy as np
    import torch

    from jrr_tpu_torch import kernels
    from jrr_tpu_torch.probes import bf16_probe, kernel_probe, kernel_probe2

    records = kernel_probe.measure() + kernel_probe2.measure() + bf16_probe.measure()
    for name, plain in (("paged_gather_rmw", "paged_gather_rmw_fixed_plain"),
                        ("E_rmw_dynamic_rows", "rmw_rows_fixed_plain")):
        rec = [r for r in records if r.get("name") == name]
        _check(len(rec) == 1 and rec[0]["exact_vs_fixed_plain"],
               f"{name}: int64 sums not held equal to {plain}'s")
    # The lane gather on indices outside [0, 128), over more tiles than its
    # grid holds: taken modulo 128 for take_along_axis, 0 for the one-hot
    # product's function.
    rng = np.random.default_rng(3)
    x = torch.as_tensor(rng.normal(size=(1000, 8, 128)).astype(np.float32), device="cuda")
    il = torch.as_tensor(rng.integers(-300, 300, size=(1000, 8, 128)).astype(np.int32), device="cuda")
    _check(torch.equal(kernels.take_along_axis(x, il, 2), kernel_probe.take_along_axis_plain(x, il, 2)),
           "take_along_axis (lanes): indices outside [0, 128) not taken modulo 128")
    _check(torch.equal(kernels.onehot_gather(x, il), kernel_probe2.onehot_gather_plain(x, il)),
           "onehot_gather: indices outside [0, 128) do not give the one-hot product's 0")
    # The chains' chunked instance (lengths other than the probe's: a chunk
    # and a remainder) on a ragged input, exact.
    x = torch.as_tensor(rng.uniform(size=1000 * 128 + 4).astype(np.float32), device="cuda")
    for reps in (2, 27):
        for wrapper, dtype in ((kernels.fma_chain_f32, torch.float32),
                               (kernels.fma_chain_bf16, torch.bfloat16)):
            _check(torch.equal(wrapper(x, reps), bf16_probe.fma_chain_plain(x, reps, dtype, True)),
                   f"{wrapper.__name__} at {reps} steps differs from its plain version")
    return [r for r in records if "name" in r], [r for r in records if "name" not in r]


def _perturbed_regressor(j_reg, seed=0):
    """The true regressor perturbed as the pipeline's demo does
    (jrr_tpu/pipeline.py:540-546): sparse |N(0, 0.15)| on 5% of its zeros,
    N(0, 0.08) on its nonzeros; numpy-seeded."""
    import numpy as np

    rng = np.random.default_rng(seed)
    j = j_reg.cpu().numpy()
    return j + np.abs(rng.normal(scale=0.15, size=j.shape)).astype(np.float32) * (j == 0) * (
        rng.uniform(size=j.shape) < 0.05
    ) + rng.normal(scale=0.08, size=j.shape).astype(np.float32) * (j > 0)


def run_training():
    """The training path: one synthetic problem of TRAIN_STEPS·BATCH frames
    (full width; its mask rendered through the round-1 tile kernel), cut
    into TRAIN_STEPS batches; `outer_step` on each at 1000 + 100 steps and
    shipped defaults, from the perturbed true regressor; then the
    closed-form regressor fit over those batches at V = 6890."""
    import torch

    from jrr_tpu_torch import config, kernels
    from jrr_tpu_torch import problem as problem_lib
    from jrr_tpu_torch.evals import metrics
    from jrr_tpu_torch.ops import jreg as jreg_lib
    from jrr_tpu_torch.refine import trainer

    kernels.reset_launches()
    model, j_true, cfg, init, data = problem_lib.synthetic_problem(
        batch=TRAIN_STEPS * BATCH, seed=0, device="cuda"
    )
    torch.cuda.synchronize()
    problem_launches = _read_launches()
    _check(problem_launches == _launches(tiles_alpha_fwd=1),
           f"problem mask launches {problem_launches}, expected 1 tiles_alpha_fwd")
    pcfg = config.PipelineConfig(
        refiner=dataclasses.replace(cfg, stage_a_steps=1000, stage_b_steps=100)
    )
    j_init = torch.as_tensor(_perturbed_regressor(j_true), device="cuda")
    state0 = trainer.init_train_state(j_init, pcfg, seed=7)
    state, steps, kept = state0, [], []
    for i in range(TRAIN_STEPS):
        sl = slice(i * BATCH, (i + 1) * BATCH)
        init_i = type(init)(*(x[sl] for x in init))
        data_i = type(data)(*(x[sl] for x in data))
        kernels.reset_launches()
        state_prev = state
        t0 = time.perf_counter()
        state, m, res = trainer.outer_step(state, model, init_i, data_i, pcfg)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = _read_launches()
        _check(launches == _launches(fused_lossgrad=38, fused_alpha_fwd=2),
               f"outer step {i} launches {launches}, expected 38 fused_lossgrad + 2 fused_alpha_fwd")
        values = {k: float(v) for k, v in m._asdict().items()}
        _check(all(math.isfinite(v) for v in values.values()), f"outer step {i}: non-finite metrics")
        steps.append(dict(seconds=seconds, frames_per_s=BATCH / seconds, launches=launches,
                          metrics=values))
        kept.append((res.vertices, res.joints3d[:, :1], data_i.gt_j3d))
    _check(state.step == TRAIN_STEPS, f"state.step {state.step} != {TRAIN_STEPS}")
    _check(bool((state.j_reg_raw != state0.j_reg_raw).any()), "the regressor did not change")
    for name in ("pose_disc", "shape_disc"):
        changed = any(bool((a != b).any()) for a, b in zip(
            getattr(state, name).parameters(), getattr(state0, name).parameters()))
        _check(changed, f"the {name} did not change")
    # outer_step leaves its input state as it was: profile the last step again.
    prof = _profile("profile_outer_step.txt", steps[-1]["seconds"],
                    lambda: trainer.outer_step(state_prev, model, init_i, data_i, pcfg))

    t0 = time.perf_counter()
    acc = trainer.JRegLstsqAccumulator.zero(model.num_verts, device="cuda")
    for verts, pelvis, gt in kept:
        acc = trainer.jreg_lstsq_accumulate(acc, verts, gt, pelvis)
    w = trainer.jreg_lstsq_solve(acc, pcfg.jreg.lstsq_ridge)
    torch.cuda.synchronize()
    lstsq_seconds = time.perf_counter() - t0
    verts_all = torch.cat([k[0] for k in kept])
    gt_all = torch.cat([k[2] for k in kept])

    def mpjpe(j_raw):
        joints = jreg_lib.apply_jreg(jreg_lib.normalize_jreg(j_raw), verts_all)
        return float(metrics.evaluate(joints, gt_all).mpjpe)

    fit, initial, adam = mpjpe(w), mpjpe(j_init), mpjpe(state.j_reg_raw)
    _check(math.isfinite(fit) and fit < initial,
           f"lstsq fit MPJPE {fit} not below the perturbed initial regressor's {initial}")
    return dict(
        batch=BATCH, outer_steps=TRAIN_STEPS, stage_a_steps=1000, stage_b_steps=100,
        problem_launches=problem_launches, steps=steps,
        seconds_per_step=[st["seconds"] for st in steps], state_step=state.step, profile=prof,
        lstsq=dict(frames=int(acc.count), num_verts=model.num_verts, seconds=lstsq_seconds,
                   mpjpe_fit_mm=fit, mpjpe_initial_mm=initial, mpjpe_adam_mm=adam),
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, card=_card(),
    )


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def _eval_dict(res):
    return {"mpjpe_mm": res.mpjpe, "pa_mpjpe_mm": res.pa_mpjpe, "frames": res.num_frames}


def _edge_flip_bounds(origin, tri, valid, tile, inv_sigma, blur_px2):
    """Plain α (N, T²) of these tiles under every mix of the coverage
    decisions that lie within DECISION_BAND of their thresholds: (lo, hi),
    each such pair's p taken at its least and its largest outcome, the
    other pairs as the plain version has them (α is monotone in each p, so
    every mix lies in [lo, hi]); and per pixel which kinds of decision lie
    there (1: an inside test, 2: the blur band's edge, 3: both)."""
    import torch

    from jrr_tpu_torch.render import coverage

    i = torch.arange(tile * tile, device=origin.device)
    px_x = origin[:, 0:1, None] + (i % tile).to(origin.dtype)[None, :, None]
    px_y = origin[:, 1:2, None] + (i // tile).to(origin.dtype)[None, :, None]
    ax, ay, bx, by, cx, cy = rows = tuple(tri[:, j, None, :] for j in range(6))
    _, _, dmin, inside, edges = coverage.coverage_rows(px_x, px_y, rows, inv_sigma=inv_sigma,
                                                       blur_px2=blur_px2)
    cross_near = blur_near = torch.zeros_like(inside)
    for (x0, y0, x1, y1), (_, _, rx, ry, d2) in zip(
            ((ax, ay, bx, by), (bx, by, cx, cy), (cx, cy, ax, ay)), edges):
        ex, ey, qx, qy = x1 - x0, y1 - y0, px_x - x0, px_y - y0
        a, b = ex * qy, ey * qx
        mag = a.abs() + b.abs()  # 0 on a degenerate edge: its cross is 0 either way
        cross_near = cross_near | (((a - b).abs() <= DECISION_BAND * mag) & (mag > 0))
        spread = (rx.abs() + ry.abs()) * (qx.abs() + qy.abs() + ex.abs() + ey.abs()) + d2
        blur_near = blur_near | ((d2 - blur_px2).abs() <= DECISION_BAND * spread)
    zero = torch.zeros_like(dmin)
    p_in = torch.sigmoid(dmin * inv_sigma)  # sd2 = −dmin ≤ blur_px2
    p_band = torch.sigmoid(-dmin * inv_sigma)
    p_out = torch.where(dmin <= blur_px2, p_band, zero)
    out_lo = torch.where(blur_near, zero, p_out)
    out_hi = torch.where(blur_near, p_band, p_out)
    p_lo = torch.where(cross_near, torch.minimum(p_in, out_lo), torch.where(inside, p_in, out_lo))
    p_hi = torch.where(cross_near, torch.maximum(p_in, out_hi), torch.where(inside, p_in, out_hi))
    ok = valid[:, 0:1, :] > 0
    alpha = lambda q: 1.0 - coverage.lane_prod(torch.clamp_min(1.0 - torch.where(ok, q, zero), 1e-30))  # noqa: E731
    kind = (cross_near & ok).any(-1).to(torch.int8) + 2 * (blur_near & ok).any(-1).to(torch.int8)
    return alpha(p_lo), alpha(p_hi), kind


def _hold_within_flips(got, plain, bounds, where, plain64=None):
    """`got` against `plain`: within ALPHA_ATOL at every pixel where the
    bounds (lo, hi, kind) of `_edge_flip_bounds` lie within ALPHA_ATOL of
    each other, within [lo, hi] ± ALPHA_ATOL at the others (the
    decision-edge pixels). Returns a report (max |Δ| off the edges, edge
    pixels, flips: pixels beyond ALPHA_ATOL, their largest |Δ|, their
    decision kinds, and with `plain64()` (the float64 plain α) those where
    `got` lies nearer it than `plain`) and the edge mask."""
    lo, hi, kind = bounds
    _check(bool(((got >= lo - ALPHA_ATOL) & (got <= hi + ALPHA_ATOL)).all()),
           f"{where}: α outside the bounds of its decision flips")
    edge = hi - lo > ALPHA_ATOL
    d = (got - plain).abs()
    off = float(d[~edge].max()) if bool((~edge).any()) else 0.0
    _check(off <= ALPHA_ATOL, f"{where}: max|Δα| {off} > {ALPHA_ATOL} away from decision edges")
    flip = d > ALPHA_ATOL
    report = dict(alpha_max_abs_err=off, edge_pixels=int(edge.sum()), flips=int(flip.sum()),
                  flip_max_abs_diff=float(d[flip].max()) if bool(flip.any()) else 0.0,
                  flips_inside_test=int((flip & (kind % 2 == 1)).sum()),
                  flips_blur_edge=int((flip & (kind >= 2)).sum()), flips_kernel_nearer_f64=0)
    if plain64 is not None and report["flips"]:
        f64 = plain64()
        nearer = (got.double() - f64).abs() < (plain.double() - f64).abs()
        report["flips_kernel_nearer_f64"] = int(nearer[flip].sum())
    return report, edge


def _merge_flip_reports(reports):
    """Sum the counts of `_hold_within_flips` reports; max of the |Δ|s."""
    out = {}
    for r in reports:
        for k, v in r.items():
            out[k] = max(out.get(k, 0.0), v) if isinstance(v, float) else out.get(k, 0) + v
    return out


def _hold_tile_render(model, gt, mask, where):
    """Row 5 on a fixture mask render (`fixtures.make_synthetic_frames`'
    tiles, one launch per `fixtures._RENDER_CHUNK` frames) rebuilt from the
    ground truth `gt`: against its own repeat (bit for bit) and its plain
    version (`_hold_within_flips`; the render's blur band is 0, so an inside
    test decided the other way moves α by up to 0.5), each flip also scored
    against a float64 plain version. The α it gives must be `mask`. Returns
    (report, α images)."""
    import torch

    from jrr_tpu_torch import constants, kernels
    from jrr_tpu_torch.data import fixtures
    from jrr_tpu_torch.refine import losses
    from jrr_tpu_torch.render import camera
    from jrr_tpu_torch.render import silhouette as sil
    from jrr_tpu_torch.render import silhouette_pallas as sp

    frames = gt.cam_t.shape[0]
    spec = sil.RasterizerSpec(image_size=constants.CROP_RES)
    t, g = spec.tile_size, spec.image_size // spec.tile_size
    consts = (t, *sil.tile_constants(spec))
    per = PLAIN_FRAMES * g * g
    with torch.no_grad():
        verts = losses.forward_frame(model, gt).vertices
    reports, images = [], []
    for lo in range(0, frames, fixtures._RENDER_CHUNK):
        sl = slice(lo, lo + fixtures._RENDER_CHUNK)
        with torch.no_grad():
            screen = camera.project_points_screen(verts[sl], gt.cam_t[sl], spec.image_size,
                                                  spec.focal_length)
            args = sil.packed_tiles(screen, model.faces, spec)
        alpha = kernels.tiles_alpha_fwd(*args, *consts)
        again = kernels.tiles_alpha_fwd(*args, *consts)
        torch.cuda.synchronize()
        _check(torch.equal(alpha, again), f"{where}: two tiles_alpha_fwd launches differ")
        with torch.no_grad():
            for c in range(0, alpha.shape[0], per):
                a, part = alpha[c:c + per], tuple(x[c:c + per] for x in args)
                plain = sp.tiles_alpha_plain(*part, *consts)
                reports.append(_hold_within_flips(
                    a, plain, _edge_flip_bounds(*part, *consts), f"{where}: tiles_alpha_fwd",
                    lambda: sp.tiles_alpha_plain(*(x.double() for x in part), *consts))[0])
        images.append(sil._tiles_to_image(alpha.reshape(-1, g * g, t * t), g, t))
    alpha = torch.cat(images)
    _check(torch.equal(alpha, mask), f"{where}: the rebuilt render differs")
    return dict(frames=frames, tiles=frames * g * g, blur_px2=consts[2],
                **_merge_flip_reports(reports)), alpha


def check_product_render(model, j_true, seed, data_root):
    """Row 5 on the product path's own tiles (`_hold_tile_render`): the
    fixture write's mask render of PRODUCT_FRAMES frames, rebuilt from the
    same draws, whose 8-bit image must be the mask PNG that the loop read
    (valid-flag pixel aside)."""
    import numpy as np

    from jrr_tpu_torch.data import fixtures, png

    gt, data = fixtures.make_synthetic_frames(model, j_true, PRODUCT_FRAMES, seed=seed,
                                              depth_range=PRODUCT_DEPTH)
    report, alpha = _hold_tile_render(model, gt, data.mask, "product fixtures")
    want = (alpha.cpu().numpy() * 255).astype(np.uint8)
    want[:, 0, 0] = 255  # the valid-flag pixel
    with open(os.path.join(data_root, "precomputed_val", "images.json")) as f:
        paths = json.load(f)
    head_tails = [p.split("imageSequence") for p in paths]
    mismatched = sum(not np.array_equal(png.read(f"{h}maskSequence{tl}"), want[i])
                     for i, (h, tl) in enumerate(head_tails))
    _check(mismatched == 0, f"product fixtures: {mismatched} mask PNGs differ from the render")
    return dict(report, mask_pngs_equal=len(paths))


def _first_indices(cfg, data_root):
    """The frames of the first batch the loop refines (epoch 0's order)."""
    from jrr_tpu_torch.data import h36m

    dataset = h36m.H36MDataset(data_root, cfg.data.split)
    return h36m.BatchLoader(dataset, BATCH, seed=cfg.data.shuffle_seed,
                            drop_last=True)._indices()[:BATCH]


def _first_batch(cfg, data_root):
    """The first batch the loop refines, from the loader it reads ("auto":
    the v2 pack the product path builds)."""
    from jrr_tpu_torch.data import native_pipeline

    dataset = native_pipeline.PackedH36MDataset(data_root, cfg.data.split)
    _check(dataset.prewarped, "the loop's first batch: no v2 pack")
    return dataset.load_batch(_first_indices(cfg, data_root))


def _max_gap(a, b) -> float:
    import numpy as np

    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())


def check_loaders(cfg, data_root):
    """`loader_check`: the loop's first batch through the python loader
    (H36MDataset), the v1 pack and the v2 pack, each key's largest gap held
    to jrr_tpu's tolerances (v1 against python: the crops and mask within
    LOADER_IMAGE_ATOL, gt_j2d within LOADER_J2D_ATOL px; v2 against v1:
    crops and mask within LOADER_V2_ATOL; the stored tensors within
    LOADER_STORED_ATOL; the intrinsics not against python, whose are the
    crop's), and ms per 256-frame batch of each: python one load, the packs
    the median of three after a warm-up."""
    import numpy as np

    from jrr_tpu_torch import runtime
    from jrr_tpu_torch.data import h36m, native_pipeline

    idx = _first_indices(cfg, data_root)
    loaders = {
        "python": h36m.H36MDataset(data_root, cfg.data.split),
        "v1": native_pipeline.PackedH36MDataset(data_root, cfg.data.split, prewarped=False),
        "v2": native_pipeline.PackedH36MDataset(data_root, cfg.data.split, prewarped=True),
    }
    batches, ms = {}, {}
    for name, loader in loaders.items():
        times = []
        for _ in range(1 if name == "python" else 4):
            t0 = time.perf_counter()
            batches[name] = loader.load_batch(idx)
            times.append(time.perf_counter() - t0)
        ms[name] = 1e3 * (times[0] if name == "python" else sorted(times[1:])[1])
    py, v1, v2 = batches["python"], batches["v1"], batches["v2"]
    crops = ("image", "spin_image", "mask_rcnn")
    stored = ("bboxes", "betas", "cam", "gt_j3d", "orient", "pose")
    gaps = {
        "v1_vs_python": {k: _max_gap(v1[k], py[k]) for k in crops + stored + ("gt_j2d",)},
        "v2_vs_v1": {k: _max_gap(v2[k], v1[k]) for k in crops + stored + ("gt_j2d", "intrinsics")},
    }
    limits = {
        "v1_vs_python": dict({k: LOADER_IMAGE_ATOL for k in crops}, gt_j2d=LOADER_J2D_ATOL),
        "v2_vs_v1": {k: LOADER_V2_ATOL for k in crops},
    }
    for pair, row in gaps.items():
        for key, gap in row.items():
            limit = limits[pair].get(key, LOADER_STORED_ATOL)
            _check(gap <= limit, f"loader_check {pair} {key}: {gap} > {limit}")
    _check(np.array_equal(py["valid"], v1["valid"]) and np.array_equal(v1["valid"], v2["valid"]),
           "loader_check: the valid flags differ")
    return dict(frames=len(idx), max_abs_gap=gaps, ms_per_batch=ms,
                tolerance=dict(image_v1_vs_python=LOADER_IMAGE_ATOL, gt_j2d_px=LOADER_J2D_ATOL,
                               v2_vs_v1=LOADER_V2_ATOL, stored=LOADER_STORED_ATOL),
                runtime_threads=runtime.default_threads(), cpu_count=os.cpu_count())


def check_jpeg():
    """`jpeg_check`: the host runtime built with g++ on this host from the
    checkout's source, then the committed test JPEGs decoded, each within 1
    level of its committed imageio decode (the frame's SHA-256 and channel
    sums equal), with the count of values that differ; and the 1000² 4:2:0
    frame's decode timed from its bytes (median of 20 after a warm-up)."""
    import hashlib

    import numpy as np

    from jrr_tpu_torch import runtime

    t0 = time.perf_counter()
    runtime.build_library(force=True)
    build_s = time.perf_counter() - t0
    report = {}
    with np.load(os.path.join(JPEG_DIR, "decodes.npz")) as f:
        for name in f.files:
            got = runtime.decode_jpeg(os.path.join(JPEG_DIR, f"{name}.jpg"))
            want = f[name]
            _check(got.shape == want.shape, f"jpeg_check {name}: shape {got.shape}")
            gap = np.abs(got.astype(np.int16) - want.astype(np.int16))
            report[name] = dict(shape=list(got.shape), max_gap=int(gap.max()),
                                differing_values=int((gap > 0).sum()))
            _check(gap.max() <= 1, f"jpeg_check {name}: {report[name]}")
    with open(os.path.join(JPEG_DIR, "decodes.json")) as f:
        frames = json.load(f)
    for name, want in frames.items():
        with open(os.path.join(JPEG_DIR, f"{name}.jpg"), "rb") as f:
            data = f.read()
        got = runtime.decode_jpeg(data)
        sums = got.sum(axis=(0, 1), dtype=np.int64).tolist()
        report[name] = dict(shape=list(got.shape), channel_sums=sums,
                            sha256_equal=hashlib.sha256(got.tobytes()).hexdigest() == want["sha256"])
        _check(list(got.shape) == want["shape"] and sums == want["channel_sums"]
               and report[name]["sha256_equal"], f"jpeg_check {name}: {report[name]}")
        times = []
        for _ in range(21):
            t0 = time.perf_counter()
            runtime.decode_jpeg(data)
            times.append(time.perf_counter() - t0)
        report[name]["decode_ms"] = 1e3 * sorted(times[1:])[10]
        report[name]["bytes"] = len(data)
    return dict(build_seconds=build_s, files=report, tolerance="1 level; the frame bit for bit")


def check_h5():
    """`h5_check`: the HDF5 reader (data/hdf5.py) on the committed files of
    tests/data/h5 (tests/make_h5_fixtures.py):
    - layouts.h5 equal to its committed h5py decodes, 0 values differ;
      latest.h5 and compound.h5 refused (NotImplementedError);
    - the 4-frame data.h5 dataset through H36MDataset in h5 mode, its batch
      held to jrr_tpu's committed one at the CPU tolerances, and the ms to
      read one 1000² frame (deflate + shuffle chunks, median of
      H5_FRAME_READS);
    - `load_raw_h36m` on the committed annot.h5 tree equal to jrr_tpu's
      committed output;
    - `run_pipeline(demo=True)` over the dataset at full width (batch 4,
      shipped stage lengths): the python loader reads through the reader,
      rows 1 and 2 launch 38 and 2 times, the evals are finite."""
    import shutil

    import numpy as np
    import torch

    from jrr_tpu_torch import config, kernels
    from jrr_tpu_torch.data import h36m, hdf5, raw_h36m
    from jrr_tpu_torch.models import smpl
    from jrr_tpu_torch.pipeline import run_pipeline

    layouts = hdf5.File(os.path.join(H5_DIR, "layouts.h5"))
    with open(os.path.join(H5_DIR, "layouts_decodes.json")) as f:
        names = json.load(f)
    differ = values = 0
    with np.load(os.path.join(H5_DIR, "layouts_decodes.npz")) as decodes:
        for key, name in names.items():
            want = decodes[key]
            got = (np.stack([layouts.read(f"big/e{i:04d}") for i in range(len(want))])
                   if name == "big/*" else layouts.read(name))
            _check(got.dtype == want.dtype and got.shape == want.shape,
                   f"h5_check {name}: {got.dtype} {got.shape}, h5py {want.dtype} {want.shape}")
            differ += int(np.count_nonzero(got != want))
            values += want.size
    _check(differ == 0, f"h5_check: {differ} values differ from h5py's")
    refused = {}
    for name in ("latest.h5", "compound.h5"):
        try:
            hdf5.File(os.path.join(H5_DIR, name)).read("x")
        except NotImplementedError as e:
            refused[name] = str(e)[len(H5_DIR) + 1 :]
        _check(name in refused, f"h5_check: {name} was read")

    raw = {}
    with np.load(os.path.join(H5_DIR, "raw_expected.npz")) as f:
        for split in ("train", "validation"):
            out = raw_h36m.load_raw_h36m(os.path.join(H5_DIR, "raw"), split)
            out["images"] = np.asarray([os.path.relpath(p, os.path.join(H5_DIR, "raw"))
                                        for p in out["images"]])
            for key, got in out.items():
                want = f[f"{split}/{key}"]
                _check(got.dtype == want.dtype and np.array_equal(got, want),
                       f"h5_check: load_raw_h36m {split} {key} differs from jrr_tpu's")
            raw[split] = len(out["images"])

    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "dataset")
        shutil.copytree(os.path.join(H5_DIR, "dataset"), root)
        ds = h36m.H36MDataset(root)
        _check(ds.use_h5 and len(ds) == H5_FRAMES, "h5_check: the dataset is not in h5 mode")
        batch = ds.load_batch(np.arange(H5_FRAMES))
        gaps = {}
        with np.load(os.path.join(H5_DIR, "dataset_batch.npz")) as f:
            _check(set(f.files) == set(batch), "h5_check: batch keys differ")
            for key in f.files:
                gaps[key] = _max_gap(batch[key], f[key])
                _check(gaps[key] <= H5_BATCH_ATOL.get(key, 0.0),
                       f"h5_check: h5 batch {key} {gaps[key]} from jrr_tpu's")
        frame_key = "/".join(ds.images[0].split("/")[-5:])
        times = []
        for _ in range(H5_FRAME_READS):
            t0 = time.perf_counter()
            frame = ds.h5.read(frame_key)
            times.append(time.perf_counter() - t0)
        _check(frame.shape == (3, 1000, 1000), f"h5_check: frame {frame.shape}")

        cfg = config.PipelineConfig()
        cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, batch_size=H5_FRAMES))
        model = smpl.synthetic_smpl_model(seed=0, device="cuda")
        kernels.reset_launches()
        t0 = time.perf_counter()
        arts = run_pipeline(cfg, data_root=root, out_dir=os.path.join(tmp, "run"), demo=True,
                            model=model, loader="auto")
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = _read_launches()
    _check(arts.loader == "python", f"h5_check: run_pipeline read {arts.loader}")
    _check(launches == _launches(fused_lossgrad=38, fused_alpha_fwd=2),
           f"h5_check run launches {launches}, expected 38 fused_lossgrad + 2 fused_alpha_fwd")
    evals = {"initial": arts.eval_before_after.before, "adam_final": arts.eval_before_after.after,
             "lstsq": arts.eval_lstsq}
    _check(all(math.isfinite(getattr(e, k)) for e in evals.values() for k in ("mpjpe", "pa_mpjpe")),
           "h5_check: non-finite evals")
    return dict(
        layouts=dict(datasets=len(layouts.datasets()), values=values, differing_values=differ),
        refused=refused, raw_h36m_frames=raw,
        dataset=dict(frames=H5_FRAMES, batch_max_gap=gaps, tolerance=H5_BATCH_ATOL,
                     frame_read_ms=1e3 * sorted(times)[len(times) // 2],
                     frame_bytes=int(frame.nbytes)),
        run=dict(batch=H5_FRAMES, stage_a_steps=cfg.refiner.stage_a_steps,
                 stage_b_steps=cfg.refiner.stage_b_steps, seconds=run_s,
                 phase_seconds=arts.seconds, loader=arts.loader, launches=launches,
                 evals={k: _eval_dict(v) for k, v in evals.items()}),
    )


def check_product_bins(model, cfg, data_root, spin_fn=None, where="product"):
    """Rows 1 and 2 on the product path's own bins (`_hold_fused` with
    decision flips, both geometries): the first batch the loop refines at
    its stored initial estimates, or at SPIN's with `spin_fn`, with the
    mask pooled as the loop pools it."""
    from jrr_tpu_torch.pipeline import _batch_to_device_inputs

    init, data = _batch_to_device_inputs(_first_batch(cfg, data_root), cfg, "cuda",
                                         spin_fn=spin_fn)
    problem = (model, None, cfg.refiner, init, data)
    return {geometry: _hold_fused(_kernel_inputs(problem, geometry), f"{where} {geometry}",
                                  decision_flips=True)
            for geometry in ("fine", "coarse")}


def run_product_path(data_root, tmp):
    """The product loop through its entry points, as tools/pipeline_bench.py
    drives jrr_tpu's: the fixtures written into `data_root` at SPIN-crop
    scale (camera z in PRODUCT_DEPTH), the v1 pack and the v2 pack built
    from them, and then `run_pipeline(demo=True, loader="auto")` on them at
    full width (the 6890-vertex synthetic body, batch 256, shipped
    defaults, 1000 + 100 steps) over PRODUCT_FRAMES frames (two shards),
    which must read the v2 pack; then the same call again on the same out
    dir, which must resume both shards (no refinement kernel launched) and
    give the same regressors and evals; then a run killed after shard 0 and
    resumed (`run_killed_and_resumed`). The launch counts are set to 0
    before each run (the first's fixture write and pack builds included)
    and read after it; the out dir is temporary. The three loaders are then
    held against each other on the first batch (`check_loaders`), and rows
    1, 2 and 5 on the run's own inputs. The runs write under `tmp`, which
    outlives the phase. Returns the phase's record, the body model and what
    `run_multi_gpu` holds its runs to: the first run's out dir, launches,
    evals, regressors and lstsq accumulator."""
    import numpy as np
    import torch

    from jrr_tpu_torch import config, kernels
    from jrr_tpu_torch.data import fixtures, native_pipeline
    from jrr_tpu_torch.models import smpl
    from jrr_tpu_torch.pipeline import _demo_regressor, run_pipeline
    from jrr_tpu_torch.utils.checkpoint import ShardManifest
    from jrr_tpu_torch.utils.logging import MetricsLogger

    cfg = config.PipelineConfig()
    _check(cfg.data.batch_size == BATCH and cfg.refiner.stage_a_steps == 1000
           and cfg.refiner.stage_b_steps == 100, "product path: shipped defaults changed")
    model = smpl.synthetic_smpl_model(seed=0, device="cuda")
    # The regressor that generates the fixtures: the demo's, drawn as
    # run_pipeline(demo=True) draws it from cfg.seed before perturbing it.
    j_true = _demo_regressor(model.num_verts, np.random.default_rng(cfg.seed))
    runs = []
    out_dir = os.path.join(tmp, "product_run")
    for name in ("first", "resumed"):
        metrics_path = os.path.join(tmp, f"metrics_{name}.jsonl")
        logger = MetricsLogger(path=metrics_path, echo=False)
        kernels.reset_launches()
        t0 = time.perf_counter()
        once = {}
        try:
            if name == "first":
                fixtures.write_fixture_dataset(
                    data_root, PRODUCT_FRAMES, seed=cfg.seed, model=model, j_reg_raw=j_true,
                    depth_range=PRODUCT_DEPTH,
                )
                torch.cuda.synchronize()
                once["fixtures"] = time.perf_counter() - t0
                t1 = time.perf_counter()
                native_pipeline.pack_dataset(data_root)
                once["pack_build"] = time.perf_counter() - t1
                t1 = time.perf_counter()
                native_pipeline.build_pack2(data_root)
                once["pack2_build"] = time.perf_counter() - t1
            arts = run_pipeline(cfg, data_root=data_root, out_dir=out_dir, demo=True,
                                model=model, logger=logger, loader="auto")
        finally:
            logger.close()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = _read_launches()
        records = _records(metrics_path)
        evals = {"initial": arts.eval_before_after.before,
                 "adam_final": arts.eval_before_after.after, "lstsq": arts.eval_lstsq}
        with np.load(os.path.join(out_dir, "ckpt", "state_00000002.npz")) as f:
            state = dict(f)
        runs.append(dict(
            arts=arts, launches=launches, seconds=seconds, records=records, evals=evals,
            phase_seconds=dict(arts.seconds, **{"fixtures": 0.0, **once}),
            shards=ShardManifest(os.path.join(out_dir, "refined")).completed(),
            saved=os.path.exists(os.path.join(out_dir, "retrained_j_regressor.npz")),
            state=state, acc=arts.accumulator,
        ))
    killed = run_killed_and_resumed(cfg, data_root, os.path.join(tmp, "product_killed"), model,
                                    runs[0], os.path.join(out_dir, "refined"))
    loaders = check_loaders(cfg, data_root)
    render = check_product_render(model, j_true, cfg.seed, data_root)
    bins = check_product_bins(model, cfg, data_root)
    first, resumed = runs
    _check(first["arts"].loader == resumed["arts"].loader == "pack2",
           f"product path read {first['arts'].loader}, {resumed['arts'].loader}: not the v2 pack")
    _check(first["shards"] == [0, 1], f"product path: manifest shards {first['shards']}")
    want = _launches(fused_lossgrad=76, fused_alpha_fwd=4,
                     tiles_alpha_fwd=first["launches"]["tiles_alpha_fwd"])
    _check(first["launches"] == want and first["launches"]["tiles_alpha_fwd"] >= 1,
           f"product path launches {first['launches']}, expected 76 fused_lossgrad + "
           "4 fused_alpha_fwd + at least 1 tiles_alpha_fwd")
    _check(resumed["launches"] == _launches(),
           f"resumed product path launched kernels: {resumed['launches']}")
    _check(len(first["records"]) == 2 and not resumed["records"],
           "product path: one metrics record per refined shard")
    values = [v for r in first["records"] for v in r.values() if isinstance(v, float)]
    values += [getattr(e, k) for run in runs for e in run["evals"].values()
               for k in ("mpjpe", "pa_mpjpe")]
    _check(all(math.isfinite(v) for v in values), "product path: non-finite metrics")
    _check(first["saved"] and resumed["saved"], "product path: no retrained_j_regressor.npz")
    a, b = first["arts"], resumed["arts"]
    lstsq_diff = float(np.abs(a.j_reg_lstsq - b.j_reg_lstsq).max())
    _check(np.array_equal(a.j_reg_final, b.j_reg_final), "resumed Adam-path regressor differs")
    _check(lstsq_diff == 0.0, f"resumed lstsq regressor differs by {lstsq_diff}")
    _check(all(first["evals"][k] == resumed["evals"][k] for k in first["evals"]),
           "resumed evals differ")
    # The train state is saved in jrr_tpu's layout and the resume restored it
    # (the resumed run saves what it restored).
    _check(all(k.startswith(".") for k in first["state"]) and ".step" in first["state"],
           "product path: the train state is not in jrr_tpu's layout")
    _check(first["state"].keys() == resumed["state"].keys() and all(
        np.array_equal(first["state"][k], resumed["state"][k]) for k in first["state"]),
        "product path: the resumed run's train state differs from the one it restored")
    jax_state = check_jax_state()
    frames = PRODUCT_FRAMES
    return dict(
        frames=frames, batch=BATCH, stage_a_steps=1000, stage_b_steps=100,
        depth_range=list(PRODUCT_DEPTH), shards=first["shards"], loader=a.loader,
        seconds=first["seconds"], phase_seconds=first["phase_seconds"],
        loader_wait_s=[r["loader_wait_s"] for r in first["records"]],
        step_s=[r["batch_seconds"] for r in first["records"]],
        product_frames_per_s=frames / a.seconds["optimize"],
        end_to_end_frames_per_s=frames / first["seconds"],
        evals={k: _eval_dict(v) for k, v in first["evals"].items()},
        launches=first["launches"],
        resumed=dict(seconds=resumed["seconds"], phase_seconds=resumed["phase_seconds"],
                     launches=resumed["launches"], lstsq_max_abs_diff=lstsq_diff,
                     evals_equal=True, state_layout="jrr_tpu", state_keys=len(first["state"]),
                     state_restored_equal=True),
        killed_and_resumed=killed,
        jax_state=jax_state,
        loader_check=loaders, render_check=render, bins_check=bins,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, card=_card(),
    ), model, dict(out_dir=out_dir, launches=first["launches"], evals=first["evals"],
                   acc=first["acc"], optimize_seconds=a.seconds["optimize"], j_true=j_true)


class _Killed(Exception):
    """The simulated crash of `run_killed_and_resumed`."""


def run_killed_and_resumed(cfg, data_root, out_dir, model, first, first_refined):
    """The product run of `run_product_path` again in a new out dir, with a
    regressor snapshot after every shard, killed in its second outer step
    (after shard 0: `trainer.outer_step` raises), then resumed with the
    same arguments. The killed run must leave shard 0, its snapshot and the
    train state after it, nothing of shard 1; the resume must run shard 1
    alone (one refinement's launches) and end bit for bit where the
    uninterrupted run `first` ended: regressors, evals, train state and
    refined shards, with shard 1's snapshot equal to the final regressor."""
    import numpy as np
    import torch

    from jrr_tpu_torch import kernels
    from jrr_tpu_torch.pipeline import run_pipeline
    from jrr_tpu_torch.refine import trainer
    from jrr_tpu_torch.utils.checkpoint import ShardManifest

    cfg = dataclasses.replace(cfg, jreg=dataclasses.replace(cfg.jreg, snapshot_interval=1))
    step, calls = trainer.outer_step, []

    def killed_step(*args, **kwargs):
        if calls:
            raise _Killed("killed in the outer step of shard 1")
        calls.append(1)
        return step(*args, **kwargs)

    snaps = os.path.join(out_dir, "jreg_snapshots")
    trainer.outer_step = killed_step
    t0 = time.perf_counter()
    try:
        run_pipeline(cfg, data_root=data_root, out_dir=out_dir, demo=True, model=model,
                     loader="auto")
        _check(False, "killed product run: the simulated crash did not stop it")
    except _Killed:
        pass
    finally:
        trainer.outer_step = step
    torch.cuda.synchronize()
    killed_s = time.perf_counter() - t0
    with open(os.path.join(out_dir, "resume.json")) as f:
        marker = json.load(f)
    after_kill = dict(shards=ShardManifest(os.path.join(out_dir, "refined")).completed(),
                      snapshots=sorted(os.listdir(snaps)), states=sorted(
                          os.listdir(os.path.join(out_dir, "ckpt"))), resume=marker)
    _check(after_kill == dict(shards=[0], snapshots=["snap_00000.npz"],
                              states=["state_00000001.npz"],
                              resume={"state": "state_00000001.npz", "shard": 0}),
           f"killed product run left {after_kill}")
    kernels.reset_launches()
    t0 = time.perf_counter()
    arts = run_pipeline(cfg, data_root=data_root, out_dir=out_dir, demo=True, model=model,
                        loader="auto")
    torch.cuda.synchronize()
    resume_s = time.perf_counter() - t0
    launches = _read_launches()
    _check(launches == _launches(fused_lossgrad=38, fused_alpha_fwd=2),
           f"resumed killed run launched {launches}, not one shard's refinement")
    a = first["arts"]
    _check(np.array_equal(arts.j_reg_final, a.j_reg_final)
           and np.array_equal(arts.j_reg_lstsq, a.j_reg_lstsq),
           "killed and resumed run: regressors differ from the uninterrupted run's")
    evals = {"initial": arts.eval_before_after.before,
             "adam_final": arts.eval_before_after.after, "lstsq": arts.eval_lstsq}
    _check(evals == first["evals"], "killed and resumed run: evals differ")
    with np.load(os.path.join(out_dir, "ckpt", "state_00000002.npz")) as f:
        state = dict(f)
    _check(state.keys() == first["state"].keys() and all(
        np.array_equal(state[k], first["state"][k]) for k in state),
        "killed and resumed run: train state differs from the uninterrupted run's")
    for sid in (0, 1):
        name = f"shard_{sid:06d}.npz"
        with np.load(os.path.join(out_dir, "refined", name)) as f, \
                np.load(os.path.join(first_refined, name)) as g:
            _check(f.files == g.files and all(np.array_equal(f[k], g[k]) for k in f.files),
                   f"killed and resumed run: {name} differs from the uninterrupted run's")
    _check(sorted(os.listdir(snaps)) == ["snap_00000.npz", "snap_00001.npz"],
           f"killed and resumed run: snapshots {sorted(os.listdir(snaps))}")
    with np.load(os.path.join(snaps, "snap_00001.npz")) as f:
        _check(np.array_equal(f["j_regressor"], a.j_reg_final),
               "killed and resumed run: shard 1's snapshot is not the final regressor")
    return dict(after_kill=after_kill, killed_seconds=killed_s, resume_seconds=resume_s,
                resume_launches=launches, equal_to_uninterrupted=True)


def check_jax_state():
    """The committed jrr_tpu-written train state (JAX_STATE, V = 96)
    restored on the card: every array of the port's state equal to the
    file's."""
    import numpy as np
    import torch

    from jrr_tpu_torch import config, convert
    from jrr_tpu_torch.refine import trainer
    from jrr_tpu_torch.utils.checkpoint import restore_train_state

    template = trainer.init_train_state(torch.zeros(17, 96, device="cuda"), config.PipelineConfig())
    back = restore_train_state(JAX_STATE, template)
    got = convert.train_state_arrays(back)
    with np.load(JAX_STATE) as f:
        _check(set(f.files) == set(got), "jax_state: keys differ")
        differ = sum(int(np.count_nonzero(got[k] != f[k])) for k in f.files)
    _check(differ == 0 and back.j_reg_raw.is_cuda and back.step == 1,
           f"jax_state: {differ} values differ from the file's")
    return dict(file=os.path.relpath(JAX_STATE, ROOT), keys=len(got), differing_values=differ,
                step=back.step, pose_disc_adam_count=back.pose_disc_opt.count)


def _fabricate(module, gen, skip=(), head=(), head_scale=1e-3, identity=()):
    """A state dict of `module`'s names and shapes drawn from `gen`: conv
    and linear weights N(0, 1/fan_in), biases N(0, 0.05²), BatchNorm scale
    U(0.8, 1.2), shift N(0, 0.1²) and running statistics as
    tests/test_spin.py randomizes them; the tensors under a `head` prefix
    scaled by `head_scale`, those in `identity` set to the identity rot6d
    pose (tiled), the mean camera (0.9, 0, 0), zero mean shape."""
    import torch

    norms = {n for n, m in module.named_modules() if isinstance(m, torch.nn.BatchNorm2d)}
    pose6d = torch.tensor([1.0, 0.0, 0.0, 1.0, 0.0, 0.0]).repeat(24)
    out = {}
    for name, value in module.state_dict().items():
        owner, leaf = name.rpartition(".")[::2]
        shape = value.shape
        if name.startswith(skip):
            continue
        if leaf == "num_batches_tracked":
            out[name] = torch.zeros_like(value)
            continue
        if name in identity:
            t = pose6d.reshape(shape).clone()
        elif leaf == "init_cam":
            t = torch.tensor([[0.9, 0.0, 0.0]])
        elif leaf == "init_shape":
            t = torch.zeros(shape)
        elif leaf == "running_mean":
            t = torch.rand(shape, generator=gen) * 0.4 - 0.2
        elif leaf == "running_var":
            t = torch.rand(shape, generator=gen) * 0.8 + 0.6
        elif owner in norms:
            t = (torch.rand(shape, generator=gen) * 0.4 + 0.8 if leaf == "weight"
                 else torch.randn(shape, generator=gen) * 0.1)
        elif value.ndim >= 2:
            t = torch.randn(shape, generator=gen) / math.sqrt(value[0].numel())
        else:
            t = torch.randn(shape, generator=gen) * 0.05
        if name.startswith(head) and name not in identity and "init_" not in name:
            t = t * head_scale
        out[name] = t
    return out


def fabricate_checkpoints(root, seed=0):
    """SPIN's hmr, VIBE's and MEVA's files at the published shapes, in their
    torch layouts, from one seeded torch.Generator: hmr ResNet-50 + IEF
    (the dec* heads scaled by 1e-3, so the estimates stay near the mean
    parameters: cam s ≈ 0.9, t_z ≈ 2·5000/(224·0.9) ≈ 50 m), with an
    smpl_mean_params.npz (identity pose, zero shape, cam (0.9, 0, 0)); VIBE
    hidden 1024, 2 layers; MEVA hidden 1024, 2 layers, latent 32, VAE
    hidden 1024 (tests/test_consumer_full_shape.py:70-82), its VAE decoder
    biased to the identity pose."""
    import numpy as np
    import torch

    from jrr_tpu_torch.models import convert_util, meva, spin, temporal

    gen = torch.Generator().manual_seed(seed)
    paths = {k: os.path.join(root, name) for k, name in (
        ("spin", "model_checkpoint.pt"), ("mean", "smpl_mean_params.npz"),
        ("vibe", "vibe_model_wo_3dpw.pth.tar"), ("meva", "meva_model.pth.tar"))}
    hmr = convert_util.empty_module(spin.SPIN)
    torch.save({"model": _fabricate(hmr, gen, head=("dec",), identity=("init_pose",)),
                "epoch": 0}, paths["spin"])
    np.savez(paths["mean"], pose=np.tile(np.float32([1, 0, 0, 1, 0, 0]), 24),
             shape=np.zeros(10, np.float32), cam=np.float32([0.9, 0.0, 0.0]))
    vibe = convert_util.empty_module(lambda: temporal.TemporalPoseModel(1024, 2))
    torch.save({"gen_state_dict": _fabricate(vibe, gen, skip=("backbone.",),
                                             head=("regressor.dec",),
                                             identity=("regressor.init_pose",)),
                "performance": 56.5}, paths["vibe"])
    model = convert_util.empty_module(lambda: meva.MEVAPoseModel(
        1024, 2, latent_dim=32, vae_hidden=1024))
    torch.save({"gen_state_dict": _fabricate(
        model, gen, skip=("backbone.", "regressor.init_pose"),
        head=("regressor.dec", "vae_model.d_out.weight"), identity=("vae_model.d_out.bias",)),
        "performance": 60.0}, paths["meva"])
    return paths


def _max_rel(got, want) -> float:
    """max |got − want| over max |want|."""
    return float((got.double().cpu() - want.double()).abs().max() / want.double().abs().max())


def _tf32(on: bool):
    """Both TF32 flags set to `on` inside, restored after."""
    import torch

    @contextlib.contextmanager
    def flags():
        saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = on
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved

    return flags()


@contextlib.contextmanager
def _shipped(policy: bool):
    """TF32 on for the process, as a caller may leave it. With `policy` the
    port's float32 policy (`utils.precision.float32_products`, which the
    entry points enter on each call) stays in place: the shipped path.
    Without it the policy is a null context: the same path in TF32, the
    gap the holds must tell apart from the shipped one."""
    from unittest import mock

    from jrr_tpu_torch.utils import precision

    with _tf32(True), (contextlib.nullcontext() if policy else mock.patch.object(
            precision, "float32_products", contextlib.nullcontext)):
        yield


@contextlib.contextmanager
def _backbone_features(out: dict):
    """out["features"]: the backbone features of the last network call
    inside, the spatial mean of the output of its last bottleneck block
    (the tensor `ResNet50.forward` pools), caught by a forward hook."""
    import torch

    from jrr_tpu_torch.models import spin

    def hook(module, args, output):
        if isinstance(module, spin.Bottleneck):
            out["last_block"] = output

    handle = torch.nn.modules.module.register_module_forward_hook(hook)
    try:
        yield
    finally:
        handle.remove()
    out["features"] = out.pop("last_block").mean(dim=(2, 3))


def check_spin(paths, cfg, data_root):
    """SPIN on the card against the port's own float32 CPU run on the first
    batch's first SPIN_CHECK_FRAMES crops, through the shipped entry point
    (`make_spin_fn`) called with TF32 on for the process (`_shipped`): its
    backbone features (caught by a hook) within SPIN_FEATURE_RTOL of their
    largest and its (pose6d, betas, cam) within SPIN_OUTPUT_ATOL. The same
    gaps with the entry point's float32 policy taken out are reported
    beside them. Then the shipped path's time for the whole 256-frame
    batch, and that of the path in TF32 (median of three after a
    warm-up)."""
    import torch

    from jrr_tpu_torch.models import spin
    from jrr_tpu_torch.pipeline import make_spin_fn

    batch = _first_batch(cfg, data_root)
    images = spin.normalize_image(torch.as_tensor(batch["spin_image"]))
    few = images[:SPIN_CHECK_FRAMES]
    cpu = spin.load_spin_checkpoint(paths["spin"], paths["mean"], device="cpu")
    with torch.inference_mode():
        want_feats = spin.ResNet50.forward(cpu, few)
        want = cpu(few)
    shipped = make_spin_fn(paths["spin"], paths["mean"], device="cuda")
    report = {}
    for mode, policy in (("shipped", True), ("tf32", False)):
        caught = {}
        with _shipped(policy), _backbone_features(caught):
            got = shipped(few.cuda())
        errs = {k: float((g.cpu() - w).abs().max())
                for k, g, w in zip(("pose6d", "betas", "cam"), got, want)}
        report[mode] = dict(feature_max_rel_err=_max_rel(caught["features"], want_feats),
                            output_max_abs_err=errs, max_abs_err=max(errs.values()))
    sound = report["shipped"]
    _check(sound["feature_max_rel_err"] <= SPIN_FEATURE_RTOL,
           f"SPIN features on the card differ from the CPU's: {sound}")
    _check(sound["max_abs_err"] <= SPIN_OUTPUT_ATOL,
           f"SPIN on the card differs from the CPU's by {sound['max_abs_err']}")
    batch_images = images.cuda()

    def timed(policy):
        def call():
            with _shipped(policy):
                shipped(batch_images)
        return _median_seconds(call)

    return dict(frames=SPIN_CHECK_FRAMES,
                tolerance=f"features rtol {SPIN_FEATURE_RTOL} of max; outputs atol {SPIN_OUTPUT_ATOL}",
                tf32_caught=(report["tf32"]["feature_max_rel_err"] > SPIN_FEATURE_RTOL
                             and report["tf32"]["max_abs_err"] > SPIN_OUTPUT_ATOL),
                seconds_per_batch=timed(True), tf32_seconds_per_batch=timed(False), batch=BATCH,
                **report)


def _median_seconds(fn, runs=3):
    """Median wall seconds of `runs` calls after a warm-up, each ending in a
    device synchronize."""
    import torch

    times = []
    for _ in range(runs + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return sorted(times[1:])[runs // 2]


def check_consumers(paths, cfg, data_root, model, j_regs):
    """Both consumers of each kind on the card against their CPU runs (the
    same files, the SMPL model copied to the CPU) on the first
    CONSUMER_CHUNKS chunks of the ordered sequence batches, with the run's
    initial and retrained regressors: the joints of the shipped consumers,
    called with TF32 on for the process (`_shipped`), within CONSUMER_ATOL
    m; the same gap with their float32 policy taken out beside it."""
    import dataclasses as dc

    import torch

    from jrr_tpu_torch.data import h36m
    from jrr_tpu_torch.evals import consumers
    from jrr_tpu_torch.models import spin
    from jrr_tpu_torch.ops import jreg

    dataset = h36m.H36MDataset(data_root, cfg.data.split)
    frames = CONSUMER_CHUNKS * CONSUMER_SEQLEN
    batch = next(h36m.ordered_sequence_batches(dataset.load_batch, dataset.frame_order(),
                                               frames, CONSUMER_SEQLEN))
    images = spin.normalize_image(torch.as_tensor(batch["spin_image"]))
    video = images.reshape((CONSUMER_CHUNKS, CONSUMER_SEQLEN) + images.shape[1:])
    model_cpu = dc.replace(model, **{f.name: getattr(model, f.name).cpu()
                                     for f in dc.fields(model)
                                     if isinstance(getattr(model, f.name), torch.Tensor)})
    norms = torch.stack([jreg.normalize_jreg(torch.as_tensor(j)) for j in j_regs])
    backbone = consumers._spin_backbone_variables(paths["spin"])
    report = {}
    for kind in ("vibe", "meva"):
        built = {dev: consumers.build_consumer(kind, paths[kind], m, backbone=backbone,
                                               seqlen=CONSUMER_SEQLEN)
                 for dev, m in (("cuda", model), ("cpu", model_cpu))}
        for name, index, x in (("frame", 0, images), ("sequence", 1, video)):
            want = built["cpu"][index](x, norms)
            for mode, policy in (("", True), ("_tf32", False)):
                with _shipped(policy):
                    got = built["cuda"][index](x.cuda(), norms.cuda())
                report[f"{kind}_{name}{mode}_max_abs_err_m"] = float((got.cpu() - want).abs().max())
                report[f"{kind}_{name}{mode}_finite"] = bool(torch.isfinite(got).all())
            err = report[f"{kind}_{name}_max_abs_err_m"]
            _check(report[f"{kind}_{name}_finite"] and err <= CONSUMER_ATOL,
                   f"{kind} {name} consumer on the card differs from the CPU's by {err} m")
            # The network alone on BATCH frames (the chunks repeated), as
            # the eval calls it per batch.
            big = x.cuda().repeat((BATCH // frames,) + (1,) * (x.ndim - 1))
            report[f"{kind}_{name}_seconds_per_batch"] = _median_seconds(
                lambda: built["cuda"][index](big, norms.cuda()))
    report["tf32_caught"] = all(v > CONSUMER_ATOL for k, v in report.items()
                                if k.endswith("_tf32_max_abs_err_m"))
    return dict(frames=frames, seqlen=CONSUMER_SEQLEN, tolerance_m=CONSUMER_ATOL, **report)


def run_consumer_path(data_root, model):
    """SPIN initialization and the VIBE/MEVA consumer evals through
    `run_pipeline(demo=True)`: checkpoints fabricated at the published
    shapes (`fabricate_checkpoints`), the product path's fixture directory
    (`data_root`: no second fixture write), full width, batch 256, shipped
    defaults, consumer seqlen 16, its own temporary out dir. The launch
    counts are set to 0 just before the call and read just after: rows 1
    and 2 as in the product path (76 and 4), row 5 none. "auto" must read
    the product path's v2 pack. Then SPIN and both
    consumers are held against the port's CPU runs, and rows 1 and 2 on the
    first SPIN-initialized batch's bins."""
    import tempfile

    import torch

    from jrr_tpu_torch import config, kernels
    from jrr_tpu_torch.pipeline import make_spin_fn, run_pipeline
    from jrr_tpu_torch.utils.logging import MetricsLogger

    cfg = config.PipelineConfig()
    with tempfile.TemporaryDirectory() as tmp:
        paths = fabricate_checkpoints(tmp)
        logger = MetricsLogger(path=os.path.join(tmp, "metrics.jsonl"), echo=False)
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        t0 = time.perf_counter()
        try:
            arts = run_pipeline(
                cfg, data_root=data_root, out_dir=os.path.join(tmp, "run"), demo=True,
                model=model, logger=logger, spin_checkpoint=paths["spin"],
                spin_mean_params=paths["mean"], vibe_checkpoint=paths["vibe"],
                meva_checkpoint=paths["meva"], consumer_seqlen=CONSUMER_SEQLEN)
        finally:
            logger.close()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = _read_launches()
        peak = torch.cuda.max_memory_allocated()
        records = _records(os.path.join(tmp, "metrics.jsonl"))
        spin_check = check_spin(paths, cfg, data_root)
        consumer_check = check_consumers(paths, cfg, data_root, model,
                                         (arts.j_reg_initial, arts.j_reg_final))
        bins = check_product_bins(model, cfg, data_root, where="spin",
                                  spin_fn=make_spin_fn(paths["spin"], paths["mean"]))
    _check(launches == _launches(fused_lossgrad=76, fused_alpha_fwd=4),
           f"consumer path launches {launches}, expected 76 fused_lossgrad + 4 fused_alpha_fwd")
    _check(arts.loader == "pack2", f"consumer path read {arts.loader}, not the v2 pack")
    _check(sorted(arts.consumer_evals) == ["meva", "meva (sequence)", "vibe", "vibe (sequence)"],
           f"consumer evals {sorted(arts.consumer_evals)}")
    evals = dict(arts.consumer_evals, protocol2=arts.eval_before_after)
    results = [r for e in evals.values() for r in (e.before, e.after)] + [arts.eval_lstsq]
    _check(all(math.isfinite(r.mpjpe) and math.isfinite(r.pa_mpjpe) and r.num_frames > 0
               for r in results), "consumer path: a non-finite or empty eval")
    frames = PRODUCT_FRAMES
    return dict(
        frames=frames, batch=BATCH, consumer_seqlen=CONSUMER_SEQLEN, seconds=seconds,
        loader=arts.loader,
        phase_seconds=arts.seconds, step_s=[r["batch_seconds"] for r in records],
        loader_wait_s=[r["loader_wait_s"] for r in records],
        spin_seconds_per_batch=spin_check["seconds_per_batch"],
        consumer_eval_seconds={k.removeprefix("consumer_"): v for k, v in arts.seconds.items()
                               if k.startswith("consumer_")},
        product_frames_per_s=frames / arts.seconds["optimize"],
        end_to_end_frames_per_s=frames / seconds,
        peak_mem_gb=peak / 1e9, launches=launches,
        evals={k: {"before": _eval_dict(v.before), "after": _eval_dict(v.after)}
               for k, v in evals.items()},
        lstsq=_eval_dict(arts.eval_lstsq),
        spin_check=spin_check, consumer_check=consumer_check, bins_check=bins, card=_card(),
    )


def _slice_fused_bins(bins, sl):
    return bins._replace(**{
        f: getattr(bins, f)[sl] for f in ("origin", "pages", "idx", "sat_tiles", "core_count")
        if getattr(bins, f) is not None
    })


def check_fused_alpha_vjp_api(problem):
    """Row 3 through the public API: the gradient w.r.t. the vertices of
    Σ w·silhouette_tiles_fused (w ~ U(−1, 1), seeded) at batch 256, full
    width, both geometries, against the plain versions (8 frames at a
    time; frames are independent). Counts the launches of each kernel run."""
    import torch

    from jrr_tpu_torch import kernels
    from jrr_tpu_torch.refine import losses
    from jrr_tpu_torch.render import silhouette_fused as sf

    model, _, cfg, init, data = problem
    report, total = {}, _launches()
    for geometry in ("fine", "coarse"):
        gcfg, _ = _geometry(cfg, data.mask, geometry)
        spec = losses.rasterizer_spec(gcfg)
        with torch.no_grad():
            verts = losses.forward_frame(model, init).vertices
            bins = sf.compute_fused_bins(verts, model, init.cam_t, spec)
            bins = sf.apply_interior_skip(bins, verts, model, init.cam_t, spec)
        w = _seeded_uniform(tuple(bins.pages.shape[:2]) + (spec.tile_size**2,), seed=11)

        def grad(sl):
            v = verts[sl].detach().requires_grad_(True)
            tiles = sf.silhouette_tiles_fused(v, model, init.cam_t[sl], spec,
                                              bins=_slice_fused_bins(bins, sl))
            return torch.autograd.grad(torch.sum(tiles * w[sl]), [v])[0]

        kernels.reset_launches()
        got = grad(slice(None))
        torch.cuda.synchronize()
        launches = _read_launches()
        _check(launches == _launches(fused_alpha_fwd=1, fused_alpha_bwd=1),
               f"{geometry}: α VJP path launches {launches}")
        total = {k: total[k] + launches[k] for k in total}
        with _plain_versions():
            want = torch.cat([grad(slice(lo, lo + PLAIN_FRAMES)) for lo in range(0, BATCH, PLAIN_FRAMES)])
        viol, err, scale = _grad_check((got,), (want,))
        _check(viol <= 1.0, f"{geometry}: Σ w·silhouette_tiles_fused gradient beyond tolerance ({viol})")
        report[geometry] = dict(max_abs_err=err, scale=scale, tolerance_use=viol, launches=launches)
    return report, total


MULTI_GPU_TIMEOUT_S = 420  # the multi_gpu group's deadline; every process is killed past it
THIN_APPENDAGE_RADIUS = 0.01  # meters: ~2 px wide on the SPIN crop
AUX_FRAMES = 16  # the thin-appendage render
AUX_CPU_FRAMES = (8, 4)  # the staged fit's and the image modules' card-against-CPU holds
STAGED_FIT_ATOL = 1e-4
IMAGE_DISC_ATOL = 1e-4
LINEARIZED_ATOL = 1e-5


def _collective_ms(mesh, acc, reps=10):
    """ms per call of each collective an outer step of the product run
    issues, at its sizes, each alone between synchronizations (after the
    run; at one process a collective is a copy on the card): the batch's
    lstsq statistics, the shared gradients (both discriminators and the
    (17, V) regressor), the metrics, loss curves and rasterizer counters
    (11 + 1000 + 6 × 100 + 5 × 2 values in float64), the counters'
    maximum, and the gather of this process's rows of the refined
    parameters and joints."""
    import torch

    from jrr_tpu_torch.models import discriminator
    from jrr_tpu_torch.parallel import mesh as mesh_lib

    dev = mesh.device
    shared = [p.detach() for m in (discriminator.PoseDiscriminator(device=dev),
                                   discriminator.ShapeDiscriminator(device=dev))
              for p in m.parameters()] + [torch.zeros(17, acc.gram.shape[0], device=dev)]
    rows = BATCH // mesh.world_size
    refined = {k: torch.zeros((rows,) + shape, device=dev) for k, shape in (
        ("pose6d", (23, 6)), ("orient6d", (1, 6)), ("betas", (10,)), ("cam_t", (3,)),
        ("joints3d", (17, 3)))}
    calls = {
        "lstsq_statistics": lambda: mesh_lib.sum_over_ranks(mesh, acc),
        "gradients": lambda: mesh_lib.sum_over_ranks(mesh, shared),
        "metrics": lambda: mesh_lib.sum_over_ranks(
            mesh, [torch.zeros(11 + 1000 + 600 + 10, dtype=torch.float64, device=dev)]),
        "counters_max": lambda: mesh_lib.max_over_ranks(mesh, [torch.zeros(2, dtype=torch.int64,
                                                                           device=dev)]),
        "gather_rows": lambda: mesh_lib.gather_rows(mesh, refined),
    }
    out = {}
    for name, fn in calls.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        out[name] = (time.perf_counter() - t0) / reps * 1e3
    return out


def _multi_gpu_worker(data_root, out_dir, backend) -> int:
    """One process of `run_multi_gpu`'s group (`chip_smoke.py
    --multi-gpu-worker DATA_ROOT OUT_DIR BACKEND`, started by
    `multihost.launch_local`): the product path's `run_pipeline` call, its
    launches counted from 0, on its own card over NCCL, or on cuda:0 with
    the other processes over gloo. Writes rank<r>.json and acc_rank<r>.npz
    into OUT_DIR."""
    import numpy as np
    import torch
    import torch.distributed as dist

    sys.path.insert(0, ROOT)
    from jrr_tpu_torch import config
    from jrr_tpu_torch import kernels
    from jrr_tpu_torch.models import smpl
    from jrr_tpu_torch.parallel import multihost
    from jrr_tpu_torch.pipeline import run_pipeline

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    multihost.initialize(backend=backend, timeout_s=MULTI_GPU_TIMEOUT_S)
    try:
        mesh = multihost.global_mesh(device="cuda" if backend == "nccl" else "cuda:0")
        model = smpl.synthetic_smpl_model(seed=0, device=mesh.device)
        kernels.reset_launches()
        t0 = time.perf_counter()
        arts = run_pipeline(config.PipelineConfig(), data_root=data_root,
                            out_dir=os.path.join(out_dir, "run"), demo=True, model=model,
                            loader="auto")
        torch.cuda.synchronize()
        nccl = torch.cuda.nccl.version()
        rec = dict(rank=mesh.rank, world=mesh.world_size, device=str(mesh.device),
                   backend=dist.get_backend(), nccl=list(nccl) if isinstance(nccl, tuple) else nccl,
                   seconds=time.perf_counter() - t0, phase_seconds=arts.seconds,
                   loader=arts.loader, launches=_read_launches())
        if mesh.is_lead:
            rec["evals"] = {"initial": _eval_dict(arts.eval_before_after.before),
                            "adam_final": _eval_dict(arts.eval_before_after.after),
                            "lstsq": _eval_dict(arts.eval_lstsq)}
        rec["collective_ms"] = _collective_ms(mesh, arts.accumulator)
        np.savez(os.path.join(out_dir, f"acc_rank{mesh.rank}.npz"),
                 **{k: v.cpu().numpy() for k, v in arts.accumulator._asdict().items()})
        with open(os.path.join(out_dir, f"rank{mesh.rank}.json"), "w") as f:
            json.dump(rec, f)
    finally:
        multihost.shutdown()
    return 0


def _npz_files(root):
    """Every .npz under `root` (relative path → arrays) and every .json's text."""
    import numpy as np

    out = {}
    for d, _, names in os.walk(root):
        for name in sorted(names):
            path = os.path.join(d, name)
            rel = os.path.relpath(path, root)
            if name.endswith(".npz"):
                with np.load(path) as f:
                    out[rel] = dict(f)
            elif name.endswith(".json"):
                with open(path) as f:
                    out[rel] = f.read()
    return out


def run_multi_gpu(data_root, ref, tmp, world=None, backend="nccl"):
    """The product path's `run_pipeline` (its fixtures and v2 pack, full
    width, two shards of 256, shipped defaults) as one process per card of
    an NCCL group (`multihost.launch_local`, torch.cuda.device_count()
    processes: one here, as this script keeps to one card), or as `world`
    processes sharing cuda:0 over gloo. At one process it must equal
    `run_product_path`'s one-process run bit for bit: the shard files, the
    train state and resume marker, both regressors, the evals, the lstsq
    accumulator every process holds, and rows 1 and 2's launches; with more
    each array's largest difference from the one-process run is recorded
    in chiprun_out/multi_gpu_differences.json (the probe
    jrr_tpu_torch/probes/multi_gpu.py holds such runs). A run across cards
    stays unverified here."""
    import numpy as np
    import torch

    from jrr_tpu_torch.parallel import multihost

    world = world or torch.cuda.device_count()
    out = os.path.join(tmp, "multi_gpu")
    os.makedirs(out)
    t0 = time.perf_counter()
    res = multihost.launch_local(
        [sys.executable, os.path.abspath(__file__), "--multi-gpu-worker", data_root, out, backend],
        world, MULTI_GPU_TIMEOUT_S, cwd=ROOT)
    seconds = time.perf_counter() - t0
    for r, log in enumerate(res.logs):
        with open(os.path.join(OUT_DIR, f"multi_gpu_rank{r}.log"), "w") as f:
            f.write(log["stdout"] + "\n--- stderr ---\n" + log["stderr"])
    _check(res.returncodes == [0] * world, f"multi_gpu: exit codes {res.returncodes}: "
           + res.logs[0]["stderr"][-1500:])
    recs = []
    for r in range(world):
        with open(os.path.join(out, f"rank{r}.json")) as f:
            recs.append(json.load(f))
    lead = recs[0]
    # Each process refines its rows of both shards: the one-process run's launches.
    want = _launches(fused_lossgrad=ref["launches"]["fused_lossgrad"],
                     fused_alpha_fwd=ref["launches"]["fused_alpha_fwd"])
    _check(all(r["launches"] == want for r in recs),
           f"multi_gpu launches {[r['launches'] for r in recs]}, expected {want} per process")
    _check(all(r["loader"] == "pack2" for r in recs), "multi_gpu: not the v2 pack")
    got_files = _npz_files(os.path.join(out, "run"))
    want_files = _npz_files(ref["out_dir"])
    _check(sorted(got_files) == sorted(want_files),
           f"multi_gpu files {sorted(got_files)} against {sorted(want_files)}")
    accs = []
    for r in range(world):
        with np.load(os.path.join(out, f"acc_rank{r}.npz")) as f:
            accs.append(dict(f))
    ref_acc = {k: v.cpu().numpy() for k, v in ref["acc"]._asdict().items()}
    if world == 1:
        for name, w in want_files.items():
            g = got_files[name]
            same = g == w if isinstance(w, str) else (
                g.keys() == w.keys() and all(np.array_equal(g[k], w[k]) for k in w))
            _check(same, f"multi_gpu: {name} differs from the one-process run's")
        _check(all(np.array_equal(accs[0][k], ref_acc[k]) for k in ref_acc),
               "multi_gpu: the accumulator differs from the one-process run's")
        want_evals = {k: _eval_dict(v) for k, v in ref["evals"].items()}
        _check(lead["evals"] == want_evals, "multi_gpu: evals differ from the one-process run's")
        held = "bit for bit"
    else:
        # At product scale the refinement's result depends on how a batch is
        # split into rows at the level of O(0.1-1) (one process refining the
        # rows as blocks parts as far: jrr_tpu_torch/probes/multi_gpu.py
        # --split), so the runs are compared, not held: per array the
        # largest difference and the entries beyond 1e-5. The probe holds
        # shard 0 to the blocks bit for bit.
        differences = {}
        for name, w in want_files.items():
            if not isinstance(w, str):
                d = {k: np.abs(got_files[name][k] - w[k]) for k in w if w[k].dtype.kind == "f"}
                differences[name] = {k: [float(v.max()), int((v > 1e-5).sum())]
                                     for k, v in d.items()}
        with open(os.path.join(OUT_DIR, "multi_gpu_differences.json"), "w") as f:
            json.dump(dict(world=world, backend=backend, differences=differences), f, indent=1)
        held = "compared, not held (see differences)"
    cards = len({r["device"] for r in recs})
    return dict(
        world=world, backend=lead["backend"], nccl_version=lead["nccl"],
        devices=[r["device"] for r in recs], seconds=seconds, run_seconds=lead["seconds"],
        phase_seconds=lead["phase_seconds"],
        product_frames_per_s=PRODUCT_FRAMES / lead["phase_seconds"]["optimize"],
        one_process_product_frames_per_s=PRODUCT_FRAMES / ref["optimize_seconds"],
        collectives_per_outer_step=5, collective_ms=lead["collective_ms"],
        launches=lead["launches"], held_to_one_process=held, files=len(got_files),
        cross_card="unverified" if cards < 2 else f"ran on {cards} cards", card=_card(),
    )


def _fake_chumpy():
    """A stand-in `chumpy` module whose `Ch` pickles as the official SMPL
    pickle's arrays do (their state dict holds the ndarray under 'x')."""
    import types

    import numpy as np

    module = types.ModuleType("chumpy")

    class Ch:
        def __init__(self, x):
            self.x = np.asarray(x)

    Ch.__module__, Ch.__qualname__ = "chumpy", "Ch"
    module.Ch = Ch
    return module


def check_body_weights(model, ref, tmp):
    """The real-weights path at full width: `model` (the synthetic body of
    the product path) written as the official SMPL pickle lays it out
    (chumpy arrays in float64, a scipy csc_matrix J_regressor, posedirs
    (V, 3, 207), a 2³²−1 root in kintree_table), converted by the port and
    loaded on the card: its arrays and its batch-256 forward equal the
    model's bit for bit. The shipped regressor loads on the card, its
    normalized rows sum to 1 within 1e-5 and are ≥ 0; applied to the
    product path's refined vertices of shard 0 it gives an MPJPE that means
    nothing on synthetic bodies (they are not SMPL's)."""
    import pickle

    import numpy as np
    import scipy.sparse
    import torch

    from jrr_tpu_torch import assets
    from jrr_tpu_torch.evals import metrics
    from jrr_tpu_torch.models import smpl
    from jrr_tpu_torch.ops import jreg, rotations
    from jrr_tpu_torch.refine import losses

    v, j = model.num_verts, model.num_joints
    host = lambda x: x.cpu().numpy().astype(np.float64)  # noqa: E731
    chumpy = _fake_chumpy()
    parents = np.asarray(model.parents)
    payload = {
        "v_template": chumpy.Ch(host(model.v_template)),
        "shapedirs": chumpy.Ch(host(model.shapedirs)),
        "posedirs": chumpy.Ch(host(model.posedirs).T.reshape(v, 3, 9 * (j - 1))),
        "J_regressor": scipy.sparse.csc_matrix(host(model.j_regressor)),
        "weights": chumpy.Ch(host(model.lbs_weights)),
        "f": model.faces.cpu().numpy(),
        "kintree_table": np.vstack([np.where(parents < 0, 2**32 - 1, parents), np.arange(j)]),
    }
    pkl, npz = os.path.join(tmp, "basicmodel_synthetic.pkl"), os.path.join(tmp, "smpl.npz")
    sys.modules["chumpy"] = chumpy
    try:
        with open(pkl, "wb") as f:
            pickle.dump(payload, f, protocol=2)
    finally:
        del sys.modules["chumpy"]
    t0 = time.perf_counter()
    smpl.convert_smpl_pickle(pkl, npz)
    convert_s = time.perf_counter() - t0
    loaded = smpl.load_smpl_npz(npz, device="cuda")
    fields = ("v_template", "shapedirs", "posedirs", "j_regressor", "lbs_weights", "faces",
              "vertex_perm")
    differ = [f for f in fields if not torch.equal(getattr(loaded, f), getattr(model, f))]
    _check(not differ and loaded.parents == model.parents,
           f"body_weights: converted arrays differ from the model's: {differ}")
    rng = np.random.default_rng(11)
    betas = torch.as_tensor(rng.normal(size=(BATCH, 10)).astype(np.float32), device="cuda")
    rots = rotations.axis_angle_to_rotmat(torch.as_tensor(
        rng.normal(scale=0.3, size=(BATCH, 24, 3)).astype(np.float32), device="cuda"))
    outs = [smpl.smpl_forward(m, betas, rots[:, :1], rots[:, 1:]) for m in (model, loaded)]
    _check(torch.equal(outs[0].vertices, outs[1].vertices)
           and torch.equal(outs[0].joints, outs[1].joints),
           "body_weights: the converted model's forward differs")
    regressor = assets.load_retrained_j_regressor(device="cuda")
    norm = jreg.normalize_jreg(regressor)
    row_err = float((norm.sum(dim=1) - 1.0).abs().max())
    _check(tuple(regressor.shape) == (17, 6890) and regressor.is_cuda and row_err <= 1e-5
           and bool((norm >= 0).all()), f"body_weights: shipped regressor rows off by {row_err}")
    with np.load(os.path.join(ref["out_dir"], "refined", "shard_000000.npz")) as f:
        shard = {k: torch.as_tensor(f[k], device="cuda") for k in f.files}
    with torch.no_grad():
        verts = losses.forward_frame(
            model, losses.FrameParams(*(shard[k] for k in losses.FrameParams._fields))).vertices
        errors = metrics.evaluate(jreg.apply_jreg(norm, verts), shard["gt_j3d"])
    _check(math.isfinite(float(errors.mpjpe)), "body_weights: non-finite MPJPE")
    return dict(
        pickle_mb=os.path.getsize(pkl) / 1e6, convert_seconds=convert_s, forward_batch=BATCH,
        arrays_equal=len(fields), forward_equal=True, regressor_row_sum_max_err=row_err,
        regressor_nonzero_share=float((regressor != 0).float().mean()),
        shipped_regressor_on_refined_mpjpe_mm=float(errors.mpjpe),
        shipped_regressor_on_refined_pa_mpjpe_mm=float(errors.pa_mpjpe),
        mpjpe_note="meaningless: the synthetic body's vertices are not SMPL's",
        card=_card(),
    )


def _rel_max(got, want) -> float:
    """max|got − want| over max|want|."""
    return float((got.double() - want.double()).abs().max() / want.double().abs().max().clamp_min(1e-30))


def check_aux_modules(model, j_true):
    """The off-path modules at full width on the card:
    - thin appendages: a `synthetic_smpl_model(thin_appendage_radius=0.01)`
      mask render of AUX_FRAMES frames through row 5 (launches counted),
      held to its plain version as the product path's render is;
    - the staged fit (`refine.legacy.find_translation_and_pose`, 100 + 100
      steps) at batch 256 on `model`: finite, the pose stage's loss falling,
      the translation stage's flat (the loss is pelvis-centred, so the
      translation is a gauge); at batch 8 its loss curves and quaternions
      within 1e-4 of the same call on the CPU;
    - the image discriminator's score and silhouette gradient at batch 256,
      224², TF32 off, the first 4 frames within 1e-4 of the CPU's;
    - linearized sampling of 224² crops from 256² frames at batch 256 with
      noise drawn on the card, value and both gradients on the first 4
      frames within 1e-5 of the CPU's with the same noise;
    - random perturbations drawn on the card: finite, near the identity,
      repeated by the same generator."""
    import numpy as np
    import torch

    from jrr_tpu_torch import kernels
    from jrr_tpu_torch.data import fixtures, perturbation
    from jrr_tpu_torch.models import image_discriminator as imgd
    from jrr_tpu_torch.models import smpl
    from jrr_tpu_torch.ops import rotations, sampling
    from jrr_tpu_torch.parallel import mesh as mesh_lib
    from jrr_tpu_torch.refine import legacy

    out = {}
    cpu = lambda tree: mesh_lib.tree_map(lambda x: x.cpu(), tree)  # noqa: E731
    # Thin appendages.
    thin, aux = smpl.synthetic_smpl_model(seed=0, thin_appendage_radius=THIN_APPENDAGE_RADIUS,
                                          return_aux=True, device="cuda")
    kernels.reset_launches()
    gt, data = fixtures.make_synthetic_frames(thin, j_true, AUX_FRAMES, seed=0,
                                              depth_range=PRODUCT_DEPTH)
    torch.cuda.synchronize()
    launches = _read_launches()
    _check(launches == _launches(tiles_alpha_fwd=launches["tiles_alpha_fwd"])
           and launches["tiles_alpha_fwd"] >= 1, f"aux_modules: thin render launched {launches}")
    report, _ = _hold_tile_render(thin, gt, data.mask, "thin appendages")
    out["thin_appendages"] = dict(report, radius_m=THIN_APPENDAGE_RADIUS,
                                  appendage_verts=int(len(aux["appendage_verts"])),
                                  tiles_alpha_fwd_launches=launches["tiles_alpha_fwd"])

    # The staged fit.
    rng = np.random.default_rng(5)
    b = BATCH
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device="cuda")  # noqa: E731
    q_orient = rotations.rotmat_to_quat(
        rotations.random_rotmat(np.random.default_rng(6), (b, 1), device="cuda"))
    q_pose = rotations.rotmat_to_quat(
        rotations.random_rotmat(np.random.default_rng(7), (b, 23), device="cuda"))
    betas = t(rng.normal(scale=0.4, size=(b, 10)))
    j_reg = t(j_true)
    with torch.no_grad():
        gt_mm = legacy.find_joints_quat(model, betas, q_orient, q_pose, j_reg) * 1000.0
    args = (gt_mm, q_orient + t(rng.normal(scale=0.03, size=(b, 1, 4))),
            q_pose + t(rng.normal(scale=0.05, size=(b, 23, 4))), torch.zeros(b, 3, device="cuda"),
            betas, j_reg)
    t0 = time.perf_counter()
    res = legacy.find_translation_and_pose(model, *args)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    _check(all(bool(torch.isfinite(x).all()) for x in res), "aux_modules: staged fit not finite")
    l1, l2 = res.stage1_loss, res.stage2_loss
    _check(float(l2[-1]) < 0.5 * float(l2[0]), "aux_modules: the staged fit's pose loss did not fall")
    stage1_drift = float((l1 - l1[0]).abs().max() / l1[0])
    _check(stage1_drift <= 1e-4, f"aux_modules: the translation stage moved the loss by {stage1_drift}")
    n = AUX_CPU_FRAMES[0]
    small = [a[:n] for a in args[:-1]] + [j_reg]
    card = legacy.find_translation_and_pose(model, *small)
    host = legacy.find_translation_and_pose(cpu(model), *(a.cpu() for a in small))
    fit_err = {k: float((getattr(card, k).cpu() - getattr(host, k)).abs().max())
               for k in ("stage1_loss", "stage2_loss", "orient_quat", "pose_quat")}
    _check(max(fit_err.values()) <= STAGED_FIT_ATOL,
           f"aux_modules: staged fit card against CPU {fit_err}")
    out["staged_fit"] = dict(batch=b, steps=[len(l1), len(l2)], seconds=fit_s,
                             stage2_loss_first_last=[float(l2[0]), float(l2[-1])],
                             stage1_relative_drift=stage1_drift, cpu_frames=n,
                             cpu_max_abs_err=fit_err, tolerance=STAGED_FIT_ATOL)

    # The image discriminator.
    n = AUX_CPU_FRAMES[1]
    disc = imgd.ImageDiscriminator(seed=0, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(3)
    image = torch.rand((b, 3, 224, 224), generator=gen, device="cuda")
    sil = torch.rand((b, 224, 224), generator=gen, device="cuda")

    def disc_run(d, img, s):
        s = s.clone().requires_grad_(True)
        score = d(img, s)
        (g,) = torch.autograd.grad(((score - 1.0) ** 2).sum(), [s])  # per-frame, batch-free
        return score.detach(), g

    disc_run(disc, image, sil)  # warm-up (cuDNN's algorithm choice)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    score, grad = disc_run(disc, image, sil)
    torch.cuda.synchronize()
    disc_s = time.perf_counter() - t0
    h_score, h_grad = disc_run(cpu(disc), image[:n].cpu(), sil[:n].cpu())
    disc_err = dict(score=float((score[:n].cpu() - h_score).abs().max()),
                    grad_rel=_rel_max(grad[:n].cpu(), h_grad))
    _check(bool(torch.isfinite(score).all() & torch.isfinite(grad).all())
           and max(disc_err.values()) <= IMAGE_DISC_ATOL,
           f"aux_modules: image discriminator card against CPU {disc_err}")
    out["image_discriminator"] = dict(batch=b, size=224, seconds=disc_s, cpu_frames=n,
                                      cpu_err=disc_err, tolerance=IMAGE_DISC_ATOL)

    # Linearized sampling on the SPIN crop.
    frames = torch.rand((b, 3, 256, 256), generator=gen, device="cuda")
    homography = perturbation.gen_random_perturbation(b, 0.05, 0.05, 0.05, generator=gen,
                                                      device="cuda")
    grid = sampling.make_warp_grid(homography, (224, 224))
    noise = torch.randn((b, 4, 224, 224, 2), generator=gen, device="cuda")
    w = torch.rand((b, 3, 224, 224), generator=gen, device="cuda")

    def lin_run(img, g, z, wt):
        img, g = img.clone().requires_grad_(True), g.clone().requires_grad_(True)
        value = sampling.linearized_sample(img, g, z)
        gi, gg = torch.autograd.grad((value * wt).sum(), [img, g])
        return value.detach(), gi, gg

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    value, gi, gg = lin_run(frames, grid, noise, w)
    torch.cuda.synchronize()
    lin_s = time.perf_counter() - t0
    bil = sampling.grid_sample(frames, grid)
    hv, hgi, hgg = lin_run(*(x[:n].cpu() for x in (frames, grid, noise, w)))
    lin_err = dict(value=float((value[:n].cpu() - hv).abs().max()),
                   value_vs_bilinear=float((value - bil).abs().max()),
                   grad_image_rel=_rel_max(gi[:n].cpu(), hgi), grad_grid_rel=_rel_max(gg[:n].cpu(), hgg))
    _check(all(bool(torch.isfinite(x).all()) for x in (value, gi, gg))
           and max(lin_err.values()) <= LINEARIZED_ATOL,
           f"aux_modules: linearized sampling card against CPU {lin_err}")
    out["linearized_sampling"] = dict(batch=b, size=[256, 224], num_aux=4, seconds=lin_s,
                                      cpu_frames=n, cpu_err=lin_err, tolerance=LINEARIZED_ATOL)

    # Perturbations.
    mats = perturbation.gen_random_perturbation(
        b, generator=torch.Generator(device="cuda").manual_seed(0), device="cuda")
    again = perturbation.gen_random_perturbation(
        b, generator=torch.Generator(device="cuda").manual_seed(0), device="cuda")
    dev = float((mats - torch.eye(3, device="cuda")).abs().max())
    _check(bool(torch.isfinite(mats).all()) and dev < 0.25 and torch.equal(mats, again),
           f"aux_modules: perturbations {dev} from the identity")
    out["perturbation"] = dict(batch=b, max_abs_from_identity=dev)
    out["card"] = _card()
    return out


def main() -> int:
    if len(sys.argv) == 5 and sys.argv[1] == "--multi-gpu-worker":
        return _multi_gpu_worker(*sys.argv[2:])
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

    phases, last = {}, [time.perf_counter()]

    def done(phase):
        """Record the wall seconds since the previous phase ended."""
        now = time.perf_counter()
        phases[phase], last[0] = now - last[0], now

    os.makedirs(OUT_DIR, exist_ok=True)
    open(os.path.join(OUT_DIR, "chip_smoke.jsonl"), "w").close()
    t0 = time.perf_counter()
    kernels.build(force=True)  # a cached library has no ptxas report for the kernels line
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

    done("build_and_problem")
    checks = check_kernels(problem)
    done("fused_kernel_checks")
    packed_checks = check_packed_kernel(problem)
    _emit({"packed_kernel_checks": packed_checks})
    done("packed_kernel_checks")
    tile_checks = check_tile_kernels(problem)
    done("tile_kernel_checks")
    main_path, launches = run_main_path(problem, pose_disc, shape_disc)
    _emit({"main_path": main_path})
    main_profile = profile_main_path(problem, pose_disc, shape_disc, main_path["seconds"])
    _emit({"profile": main_profile})
    done("main_path")
    refine = compare_kernel_and_plain_refine(pose_disc, shape_disc)
    _emit({"kernel_vs_plain_refine": refine})
    _check(refine["max_param_abs_diff"] <= REFINE_PARAM_ATOL,
           f"kernel vs plain refine params differ by {refine['max_param_abs_diff']}")
    done("kernel_vs_plain_refine")
    _emit({"kernel_vs_plain_silhouette_gradient": compare_silhouette_gradients()})
    done("silhouette_gradients")
    _emit({"training_path": run_training()})
    done("training_path")
    round1, round1_launches, round1_res = run_round1_path(problem, pose_disc, shape_disc)
    _emit({"round1_path": round1})
    done("round1_path")
    _emit({"xla_path": run_xla_path(problem, pose_disc, shape_disc, round1_res, round1_launches)})
    del round1_res
    done("xla_path")
    vjp, vjp_launches = check_fused_alpha_vjp_api(problem)
    _emit({"fused_alpha_vjp_api": vjp})
    done("fused_alpha_vjp_api")
    lane_pack, lane_pack_launches = run_lane_pack_path(
        problem, pose_disc, shape_disc, packed_checks, checks, main_profile["device_busy_s"])
    _emit({"lane_pack_path": lane_pack})
    done("lane_pack_path")
    probe_records, probe_summary = run_probes()
    _emit({"probes": probe_records + probe_summary})
    done("probes")
    _emit({"jpeg_check": check_jpeg()})
    done("jpeg_check")
    _emit({"h5_check": check_h5()})
    done("h5_check")
    with tempfile.TemporaryDirectory() as tmp:
        data_root = os.path.join(tmp, "fixtures")
        product, model, product_ref = run_product_path(data_root, tmp)
        _emit({"product_path": product})
        done("product_path")
        multi_gpu = run_multi_gpu(data_root, product_ref, tmp)
        _emit({"multi_gpu": multi_gpu})
        done("multi_gpu")
        _emit({"body_weights": check_body_weights(model, product_ref, tmp)})
        done("body_weights")
        consumer = run_consumer_path(data_root, model)
        _emit({"consumer_path": consumer})
        done("consumer_path")
        aux = check_aux_modules(model, product_ref["j_true"])
        _emit({"aux_modules": aux})
        done("aux_modules")
    _emit({"kernel_checks": checks})
    _emit({"tile_kernel_checks": tile_checks})
    _emit({"phase_seconds": phases})

    def entry(name, source, replaces, n, checks, key, tolerance):
        fine, coarse = checks["fine"], checks["coarse"]
        err_key = "alpha_max_abs_err" if key == "fwd" else (
            "grad_max_abs_err" if key == "lossgrad" else "bwd_max_abs_err")
        return {
            "name": name, "route": "cuda", "source": f"jrr_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": n,
            "max_abs_err": max(checks[g][err_key] for g in checks),
            "ms": fine[f"{key}_ms"], "plain_ms": fine[f"{key}_plain_ms"],
            "bound_ms": fine[f"{key}_bound_ms"], "bound_by": fine[f"{key}_bound_by"],
            "library_ms": None, "tolerance": tolerance,
            "coarse_ms": coarse[f"{key}_ms"], "coarse_plain_ms": coarse[f"{key}_plain_ms"],
            "coarse_bound_ms": coarse[f"{key}_bound_ms"],
        }

    grad_tol = f"atol {GRAD_ATOL_REL}*max|plain| + rtol {GRAD_RTOL}"
    lossgrad = entry("fused_lossgrad", "silhouette_fused.cu", "jrr_tpu/render/silhouette_fused.py:994",
                     launches["fused_lossgrad"], checks, "lossgrad",
                     f"err rtol {ERR_RTOL}; grads {grad_tol}; two launches bit for bit")
    # Counts of the bins, shared by the near-pair gradient kernels.
    passes = {f"{prefix}{key}": checks[g][key] for g, prefix in (("fine", ""), ("coarse", "coarse_"))
              for key in ("near_share", "pass2_warp_efficiency", "pass1_item_efficiency")}
    lossgrad.update(passes)
    alpha_bwd = entry("fused_alpha_bwd", "silhouette_fused.cu",
                      "jrr_tpu/render/silhouette_fused.py:814", vjp_launches["fused_alpha_bwd"],
                      checks, "bwd", f"{grad_tol}; two launches bit for bit; at dL/dα = 2(α − mask) "
                                     "equal to fused_lossgrad's gradients bit for bit")
    alpha_bwd.update(passes, bwd_over_lossgrad=checks["fine"]["bwd_over_lossgrad"],
                     coarse_bwd_over_lossgrad=checks["coarse"]["bwd_over_lossgrad"],
                     bwd_equals_lossgrad={g: checks[g]["bwd_equals_lossgrad"] for g in checks})
    alpha_fwd = entry("fused_alpha_fwd", "silhouette_fused.cu",
                      "jrr_tpu/render/silhouette_fused.py:719", launches["fused_alpha_fwd"], checks,
                      "fwd", f"atol {ALPHA_ATOL}; two launches bit for bit; interior-skip "
                             f"decisions flip only within {SKIP_BAND} of their threshold")
    # The product path's launches; its own inputs in max_abs_err (away from
    # the decision edges), their flips beside it.
    prod_bins = product["bins_check"].values()
    render = product["render_check"]
    on_product = (f"; on the product's inputs the same away from decisions within "
                  f"{DECISION_BAND} of their thresholds, within the bounds of their flips there")
    alpha_fwd.update(product_launches=product["launches"]["fused_alpha_fwd"], max_abs_err=max(
        alpha_fwd["max_abs_err"], *(r[k] for r in prod_bins
                                    for k in ("alpha_max_abs_err", "rebin_alpha_max_abs_err"))),
        product_decision_flips=sum(r["flips"] + r["rebin_flips"] for r in prod_bins),
        product_flips_nearer_float64=sum(r["flips_kernel_nearer_f64"]
                                         + r["rebin_flips_kernel_nearer_f64"] for r in prod_bins),
        tolerance=alpha_fwd["tolerance"] + on_product)
    spin_bins = consumer["bins_check"].values()
    for row, name in ((alpha_fwd, "fused_alpha_fwd"), (lossgrad, "fused_lossgrad")):
        row["spin_product_launches"] = consumer["launches"][name]
        row["multi_gpu_launches"] = multi_gpu["launches"][name]
    alpha_fwd.update(max_abs_err=max(alpha_fwd["max_abs_err"], *(
        r[k] for r in spin_bins for k in ("alpha_max_abs_err", "rebin_alpha_max_abs_err"))))
    alpha_fwd["spin_decision_flips"] = sum(r["flips"] + r["rebin_flips"] for r in spin_bins)
    prod_bins = list(prod_bins) + list(spin_bins)
    lossgrad.update(product_launches=product["launches"]["fused_lossgrad"], max_abs_err=max(
        lossgrad["max_abs_err"], *(r["grad_max_abs_err"] for r in prod_bins)),
        tolerance=lossgrad["tolerance"] + "; on the product's bins the same, err on the frames "
                  "and grads on the entries no decision flip can reach")
    tiles_fwd = entry("tiles_alpha_fwd", "silhouette_tiles.cu",
                      "jrr_tpu/render/silhouette_pallas.py:169", round1_launches["tiles_alpha_fwd"],
                      tile_checks, "fwd", f"atol {ALPHA_ATOL}; two launches bit for bit" + on_product)
    tiles_fwd.update(
        product_launches=product["launches"]["tiles_alpha_fwd"],
        spin_product_launches=consumer["launches"]["tiles_alpha_fwd"],
        max_abs_err=max(tiles_fwd["max_abs_err"], render["alpha_max_abs_err"],
                        aux["thin_appendages"]["alpha_max_abs_err"]),
        product_decision_flips=render["flips"],
        product_flips_nearer_float64=render["flips_kernel_nearer_f64"],
        thin_appendage_launches=aux["thin_appendages"]["tiles_alpha_fwd_launches"],
        thin_appendage_decision_flips=aux["thin_appendages"]["flips"])
    # The main path launches it on the bins before the skip.
    alpha_fwd.update(rebin_ms=checks["fine"]["fwd_rebin_ms"],
                     coarse_rebin_ms=checks["coarse"]["fwd_rebin_ms"],
                     skip_flips=checks["fine"]["skip_flips"],
                     coarse_skip_flips=checks["coarse"]["skip_flips"])
    kernels_line = [
        lossgrad,
        alpha_fwd,
        alpha_bwd,
        tiles_fwd,
        entry("tiles_alpha_bwd", "silhouette_tiles.cu", "jrr_tpu/render/silhouette_pallas.py:182",
              round1_launches["tiles_alpha_bwd"], tile_checks, "bwd",
              f"{grad_tol}; two launches bit for bit"),
        {
            "name": "fused_lossgrad_packed", "route": "cuda",
            "source": "jrr_tpu_torch/csrc/silhouette_fused.cu",
            "replaces": "jrr_tpu/render/silhouette_fused.py:1155",
            "launches": lane_pack_launches["fused_lossgrad_packed"],
            "max_abs_err": max(packed_checks[g]["grad_max_abs_err"] for g in packed_checks),
            "ms": packed_checks["fine"]["ms"], "plain_ms": packed_checks["fine"]["plain_ms"],
            "bound_ms": packed_checks["fine"]["bound_ms"], "bound_by": packed_checks["fine"]["bound_by"],
            "library_ms": None, "unpacked_ms": packed_checks["fine"]["unpacked_ms"],
            "packed_over_unpacked": packed_checks["fine"]["packed_over_unpacked"],
            "tolerance": f"err rtol {ERR_RTOL}; grads {grad_tol}; vs unpacked at bin time: "
                         "err rtol 2e-5, grads atol 5e-5*max; NORMAL rows' err equal to "
                         "fused_lossgrad's; repeat bit for bit",
            "coarse_ms": packed_checks["coarse"]["ms"],
            "coarse_unpacked_ms": packed_checks["coarse"]["unpacked_ms"],
            "coarse_packed_over_unpacked": packed_checks["coarse"]["packed_over_unpacked"],
            "coarse_bound_ms": packed_checks["coarse"]["bound_ms"],
        },
    ] + [dict(r, launches=0, note="probe") for r in probe_records]
    for row in kernels_line:
        row["ptxas"] = _ptxas(row.get("kernel", row["name"] + "_kernel"))
    _emit({"kernels": kernels_line})
    print(_card(), flush=True)
    _emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
