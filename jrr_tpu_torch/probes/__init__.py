"""Hopper microbenchmarks of the fused rasterizer's primitives: counterparts
of the JAX package's Pallas probes (tools/kernel_probe.py,
tools/kernel_probe2.py, tools/bf16_vpu_probe.py), one CUDA kernel each in
csrc/probes.cu, at the tools' shapes.

    python -m jrr_tpu_torch.probes.kernel_probe    # page gather + RMW, take_along_axis
    python -m jrr_tpu_torch.probes.kernel_probe2   # primitives A-F one at a time
    python -m jrr_tpu_torch.probes.bf16_probe      # FMA chain, f32 against packed bf16

Each module holds the plain PyTorch versions of its kernels and a
`measure()` that runs every kernel on the card, holds it against its plain
version and returns one record per kernel (ms, plain ms, the bound, and the
time of one PyTorch call for the same function where there is one); its
`main()` prints the records as JSON lines. This module holds what they share.
"""

from __future__ import annotations

import json
import subprocess
import time

import torch

LANES = 128
ROWS = 8  # rows per (8, 128) tile block, and page ids per tile
SOURCE = "jrr_tpu_torch/csrc/probes.cu"

# H100 SXM data-sheet peaks (dense, at 700 W): HBM bytes/s; float32 op/s
# outside the tensor cores; bf16 op/s outside the tensor cores, twice the
# float32 rate (NVIDIA's Hopper architecture white paper).
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 2 * F32_OPS_PER_S


def time_ms(fn, reps: int) -> float:
    """Mean device ms per call of `fn`: `reps` calls captured in one CUDA
    graph, replayed once to warm up and once under CUDA events. A probe
    kernel takes tens of µs, less than the host needs to issue a wrapper
    call, so timing the calls as issued would time the host."""
    fn()  # lazy set-up and the caching allocator's first blocks, outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def time_cold_ms(fn, reps: int) -> float:
    """Mean device ms per call of `fn` when it finds the L2 cache cold: each
    call after a read of a buffer twice the L2's size, less those reads
    alone (both timed as `time_ms`). It includes writing back to device
    memory what `fn` left in L2. `time_ms`'s repeats on the same inputs
    find part of a working set near the L2's 50 MB in the cache, and
    rewrite the same output there."""
    l2_bytes = torch.cuda.get_device_properties(torch.cuda.current_device()).L2_cache_size
    flush = torch.zeros(2 * l2_bytes // 4, device="cuda")

    def after_flush():
        flush.sum()
        fn()

    return time_ms(after_flush, reps) - time_ms(flush.sum, reps)


def bound(byte_count: float, ops: float, ops_per_s: float = F32_OPS_PER_S):
    """(least ms for these bytes and operations, "bytes" or "operations")."""
    byte_ms = 1e3 * byte_count / HBM_BYTES_PER_S
    op_ms = 1e3 * ops / ops_per_s
    return max(byte_ms, op_ms), ("bytes" if byte_ms >= op_ms else "operations")


def record(name, kernel, replaces, got, want, tolerance, tolerance_text, ms, plain_ms, bound_ms_by,
           library, library_ms):
    """One kernel's record; `kernel` names its CUDA entry function in
    `SOURCE`. Raises unless `got` agrees with `want` within `tolerance` (0, an
    absolute bound, or a tensor of per-element bounds)."""
    diff = (got.double() - want.double()).abs()
    err = float(diff.max())
    if not bool(torch.all(diff <= tolerance)):
        raise AssertionError(f"{name}: kernel and plain version differ by {err} ({tolerance_text})")
    return {
        "name": name, "route": "cuda", "source": SOURCE, "kernel": kernel, "replaces": replaces,
        "max_abs_err": err, "tolerance": tolerance_text, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms_by[0], "bound_by": bound_ms_by[1],
        "library": library, "library_ms": library_ms,
    }


def card() -> str:
    """`nvidia-smi`'s name and power limit of the first card."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def sm_clocks(samples_during=None) -> dict:
    """The first card's SM clock in MHz as `nvidia-smi` reads it: now
    (`clocks.sm`) and its maximum (`clocks.max.sm`); with
    `samples_during=(fn, seconds)` also the median and range of
    `clocks.sm` sampled every 20 ms while CUDA-graph replays of `fn` keep
    the card busy for about that many seconds (`under_load`)."""
    query = ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm", "--format=csv,noheader,nounits"]

    def read(out):
        rows = [[float(v) for v in line.split(",")] for line in out.strip().splitlines()]
        return [r for r in rows if len(r) == 2]

    clocks = {}
    if samples_during is not None:
        fn, seconds = samples_during
        fn()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(20):
                fn()
        sampler = subprocess.Popen(query + ["-lms", "20"], stdout=subprocess.PIPE, text=True)
        try:
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < seconds:
                graph.replay()
                torch.cuda.synchronize()
        finally:
            sampler.terminate()
            out, _ = sampler.communicate()
        # The first samples may precede the load.
        mhz = sorted(r[0] for r in read(out)[2:]) or [float("nan")]
        clocks["under_load"] = {"median": mhz[len(mhz) // 2], "min": mhz[0], "max": mhz[-1],
                                "samples": len(mhz)}
    now = read(subprocess.run(query, capture_output=True, text=True, check=True).stdout)[0]
    clocks.update(now=now[0], max=now[1])
    return clocks


def run(measure) -> None:
    """A probe module's entry: fail without a card, else print each record
    and the card as JSON lines."""
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the probes time kernels on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    for rec in measure():
        print(json.dumps(rec), flush=True)
    print(json.dumps({"card": card(), "kind": torch.cuda.get_device_name(0)}), flush=True)
