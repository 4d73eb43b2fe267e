"""One run of one cell: set-up, the measured window, the check, the result.

The cell (`--workload`) is looked up in BENCHMARK.json, which names its
configuration file and traffic mix (`traffic/<traffic>.json`); its check's
steps and limits are in `limits/<workload>.json`, and each per-layer
metric is read by `metrics/<metric>.py`. Nothing here names a cell, a
configuration, a traffic mix or a metric.

Set-up makes the scene on the card from the seed, builds the port's
outer-step program and drives it through the check's first steps on the
pool's first batches (the first call captures the program's graphs, so
every later call replays). The window carries the same state on, one
batch in flight, through the pool in turn, and ends at the first step
completion after `--seconds`, not before the pool's first pass is done.
With `--trace 1` the window runs under the profiler, for at most
`TRACE_SECONDS` (still not before the pool's first pass), and the run
reports the cell's per-layer metrics instead of its end-to-end ones. Once
the window has closed, the program is freed and the reference runs the check.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, NamedTuple, Optional

ROOT = Path(__file__).resolve().parent.parent
BENCH = Path(__file__).resolve().parent
# Top-level modules that no run may load: JAX and the JAX package.
FORBIDDEN = ("jax", "jaxlib", "flax", "jrr_tpu")
# The longest traced window: on an H100 host the profiler's trace takes
# some 8 s a traced step to read, and a run has to end within 360 s.
TRACE_SECONDS = 12.0


class RunError(Exception):
    """A run that cannot produce a result; the message goes to stderr."""


class Cell(NamedTuple):
    name: str
    workload: dict
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def _read_json(path: Path) -> dict:
    try:
        return json.loads(path.read_text())
    except FileNotFoundError as e:
        raise RunError(f"missing {path.relative_to(ROOT)}") from e


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell `name` of BENCHMARK.json with its configuration, traffic,
    limits and metrics."""
    bench = _read_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise RunError(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    return Cell(name, w, _read_json(root / configs[w["config"]]["file"]),
                _read_json(BENCH / "traffic" / f"{w['traffic']}.json"),
                _read_json(BENCH / "limits" / f"{name}.json"),
                [m for m in bench["end_to_end"] if _applies(m, name)],
                [m for m in bench["per_layer"] if _applies(m, name)])


def files_cell(config: str, traffic: str, steps: int) -> Cell:
    """A cell that BENCHMARK.json does not hold, from `configs/<config>.json`
    and `traffic/<traffic>.json`, with no limits: for calibration."""
    name = f"{config}.{traffic}"
    return Cell(name, {"name": name, "config": config, "traffic": traffic, "chips": 1},
                _read_json(BENCH / "configs" / f"{config}.json"),
                _read_json(BENCH / "traffic" / f"{traffic}.json"),
                {"steps": steps, "limits": {}}, [], [])


def metric_reader(name: str):
    """`read(ctx)` of metrics/<name>.py."""
    path = BENCH / "metrics" / f"{name}.py"
    if not path.exists():
        raise RunError(f"no reader {path.relative_to(ROOT)} for metric {name}")
    spec = importlib.util.spec_from_file_location(f"benchmark.metrics.{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def cache_environment(root: Path = ROOT) -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    cache = root / ".bench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["USE_FLAX"] = "0"


def power_limit_w() -> Optional[float]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=20, check=True).stdout
        return float(out.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


class Context(NamedTuple):
    """What a per-layer metric reader reads."""

    trace: object  # trace.Trace of the window
    config: dict
    batch: int
    traced_batches: List[int]  # pool batch of each traced step


def first_steps(prog, steps: int):
    """Drive the program through the check's first `steps` steps on the
    pool's first batches: (its `check.Readings`, the state after them, each
    step's numbers as `program.Program.step` returns them)."""
    from benchmark import check, program as program_lib

    start = {k: v.detach().clone() for k, v in program_lib.state_leaves(prog.state0).items()}
    state, losses, first, pgt, frames, grads, numbers = prog.state0, [], [], [], [], None, []
    evals = []
    for k in range(steps):
        s = prog.step(state, k)
        frames.append(check.frame_mm(s.vertices, prog.batch(k)[2]))
        state = s.state
        numbers.append(dict(zip(program_lib.NUMBERS, s.numbers.tolist())))
        losses.append({n: numbers[-1][n] for n in check.LOSSES})
        evals.append({n: numbers[-1][n] for n in check.EVALS})
        first.append({n: numbers[-1][n] for n in program_lib.FIRST_TERMS})
        pgt.append(numbers[-1]["pgt_mm"])
        if k == 0:  # Adam's first moment after one step is (1 - b1) g
            grads = {n: m.detach().clone() / (1.0 - 0.9)
                     for n, m in program_lib.first_moments(state).items()}
    end = {k: v.detach().clone() for k, v in program_lib.state_leaves(state).items()}
    return check.Readings(losses, first, grads, start, end, pgt, frames, evals), state, numbers


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def run(args, t_start: float, cell: Optional[Cell] = None, device=None) -> dict:
    """One run. `cell` and `device` stand in for BENCHMARK.json's cell and
    the card in the CPU tests, which skip the look for a card."""
    cell = load_cell(args.workload) if cell is None else cell
    cache_environment()
    import torch

    chips = int(cell.workload["chips"])
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            raise RunError(f"this cell needs {chips} CUDA device(s); torch.cuda.is_available()="
                           f"{torch.cuda.is_available()}, device_count="
                           f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        device = torch.device("cuda", 0)
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from benchmark import check, scene as scene_lib, trace as trace_lib
    from benchmark import program as program_lib

    steps = int(cell.limits["steps"])
    scene = scene_lib.make_scene(args.seed, cell.config, cell.traffic, dev)
    pool = scene.pool_batches
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    prog = program_lib.Program(scene, cell.config, dev)

    # Set-up: the check's first steps through the window's own call.
    got, state, _ = first_steps(prog, steps)
    pgt = list(got.pgt_mm)
    if cuda:
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - t_start
    _log(f"set-up {setup_s:.3f} s ({steps} steps, pool {pool} x {scene.batch})")

    # The window.
    window = {"k": steps, "failed": 0}
    seconds = min(args.seconds, TRACE_SECONDS) if args.trace else args.seconds

    def run_window() -> int:
        st, k = state, steps
        t0 = time.perf_counter()
        while True:
            s = prog.step(st, k)
            st = s.state
            if not bool(torch.isfinite(s.numbers).all()):
                window["failed"] += 1
            if k < pool:
                pgt.append(float(s.numbers[-1]))
            k += 1
            if time.perf_counter() - t0 >= seconds and k >= pool:
                break
        window["seconds"] = time.perf_counter() - t0
        window["k"] = k
        return k - steps

    traced = None
    if args.trace:
        traced = trace_lib.record(run_window)
    else:
        run_window()
    n_steps = window["k"] - steps
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0

    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    metrics: Dict[str, dict] = {}
    card = {"platform": "gpu" if cuda else "cpu",
            "kind": torch.cuda.get_device_name(dev) if cuda else "cpu", "count": chips,
            "memory_peak_bytes": int(peak)}
    extra = {}
    if traced is None:
        values = {"frames_per_s": n_steps * scene.batch / window["seconds"],
                  "pgt_vertex_mm": sum(pgt[:pool]) / pool, "setup_s": setup_s}
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": units[m["name"]]}
    else:
        ctx = Context(traced, cell.config, scene.batch,
                      [k % pool for k in range(steps, window["k"])])
        for m in cell.per_layer:
            value = metric_reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": units[m["name"]]}
        busy = trace_lib.busy_ns(traced.ops) / 1e9
        card.update(busy_s=busy, window_s=traced.window_s)
        extra["breakdown"] = {"device_ops": trace_lib.device_ops(traced.ops),
                              "idle_gaps": trace_lib.idle_gaps(traced.ops)}
    power = power_limit_w() if cuda else None
    _log(f"window {window['seconds']:.3f} s, {n_steps} steps of {scene.batch}; "
         f"{card['kind']}, power limit {power} W; peak {peak} bytes")

    # The check, after the window, with the program freed.
    del prog, state, traced
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    want = check.run_reference(scene, cell.config, steps)
    numbers = check.compare(got, want)
    correct, table = check.verdict(numbers, cell.limits["limits"])
    _log(f"reference {time.perf_counter() - t0:.3f} s")
    for name in check.NUMBERS:
        if name not in table:
            _log(f"reading {name} {numbers[name]!r} (no limit)")
    for name, row in table.items():
        _log(f"check {name} {row['value']!r} limit {row['limit']!r}")
    found = forbidden_modules()
    if found:
        raise RunError(f"the run loaded {', '.join(found)} (JAX or the JAX package)")
    if power is not None:
        card["power_limit_w"] = power
    return {"correct": correct, "attempted": n_steps, "failed": window["failed"],
            "metrics": metrics, "device": card, **extra, "checks": table}


def main(argv=None, t_start: Optional[float] = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    try:
        result = run(args, t_start)
    except RunError as e:
        _log(f"benchmark: {e}")
        return 2
    print(json.dumps(result), flush=True)
    return 0

