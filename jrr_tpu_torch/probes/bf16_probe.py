"""Is packed-bf16 arithmetic faster than f32 on the card? The same dependent
FMA chain of two streams timed in both (counterpart of
tools/bf16_vpu_probe.py, row 10 of PERF.md's kernel table):

    python -m jrr_tpu_torch.probes.bf16_probe

Per element x of a (64·512, 128) f32 array (numpy seed 0, U[0, 1)):
acc = y = x, then `REPS` times acc ← acc·c1 + c2, y ← y·c2 + c1, and
out = acc + y in f32. The kernels round each step once (fmaf, __hfma2 on
two bf16 values per instruction). In bf16, c1 = 1 + 2^-10 rounds to 1 (the
Pallas probe's too), so that chain's acc stream adds c2 only. Prints one record per kernel
(its `pipe_floor_ms`: REPS steps at the sweep's slope), the speed-up
f32_ms / bf16_ms, a sweep over the chain length (`sweep`) with
the SM clock read under load, and the chain kernels' SASS counts
(`sass_counts`).
"""

from __future__ import annotations

import collections
import os
import re
import subprocess

import numpy as np
import torch

from jrr_tpu_torch import kernels, probes, resolve_device
from jrr_tpu_torch.probes import LANES

ROWS = 512
GRID = 64
REPS = 200  # chain length; the kernels unroll it completely (probes.cu kChainProbeReps)
C1 = 1.0009765625  # 1 + 2^-10: exact in f32, rounds to 1 in bf16 (8 significant bits)
C2 = -0.001953125  # -2^-9, exact in both
TRIALS = 30
SWEEP_REPS = (0, 25, 50, 100, 200, 400)  # chain lengths of the sweep


def make_input(rows: int = GRID * ROWS, seed: int = 0, device="cuda"):
    """The probe's input, U[0, 1) from numpy seed `seed`."""
    return torch.as_tensor(
        np.random.default_rng(seed).uniform(size=(rows, LANES)).astype(np.float32),
        device=resolve_device(device),
    )


def _round_once(v, dtype):
    """float64 `v` rounded to `dtype` once, to nearest even (torch converts
    float64 to bfloat16 through float32, which can round twice)."""
    if dtype == torch.float32:
        return v.float()
    m, e = torch.frexp(v)  # v = m·2^e, 0.5 <= |m| < 1: keep 8 significant bits
    return torch.ldexp(torch.round(torch.ldexp(m, torch.full_like(e, 8))), e - 8).to(dtype)


def fma_chain_plain(x, reps: int, dtype, fused: bool):
    """The chain in `dtype` (torch.float32 or torch.bfloat16) from x and the
    constants rounded to it (in bf16 c1 is 1, as in the Pallas probe).
    fused=True rounds each step once, as fmaf and __hfma2 do: the step is
    computed in float64, exact here (the product of a `dtype` value and c1
    or c2 plus the other fits in 53 bits unless |acc| < 2^-28), and rounded
    to `dtype`. fused=False rounds the product and then the sum, as the
    Pallas body reads; in bf16 both products are exact (c1 = 1, c2 a power
    of two), so there the two agree. acc + y is added in f32."""
    c1, c2 = (torch.tensor(c, dtype=dtype).item() for c in (C1, C2))
    acc = x.to(dtype)
    y = acc
    for _ in range(reps):
        if fused:
            acc = _round_once(acc.double() * c1 + c2, dtype)
            y = _round_once(y.double() * c2 + c1, dtype)
        else:
            acc = acc * c1 + c2
            y = y * c2 + c1
    return acc.float() + y.float()


def measure(rows: int = GRID * ROWS, reps: int = REPS, trials: int = TRIALS) -> list:
    x = make_input(rows, device="cuda")
    n = x.numel()
    records = []
    for name, dtype, kernel, chain, rate in (
        ("fma_chain_f32", torch.float32, kernels.fma_chain_f32, "ChainF32", probes.F32_OPS_PER_S),
        ("fma_chain_bf16", torch.bfloat16, kernels.fma_chain_bf16, "ChainBf16",
         probes.BF16_OPS_PER_S),
    ):
        got = kernel(x, reps)
        want = fma_chain_plain(x, reps, dtype, fused=True)
        two_step = fma_chain_plain(x, reps, dtype, fused=False)
        rec = probes.record(
            name, f"fma_chain_kernel<{chain}, {reps if reps == REPS else 0}>",
            "tools/bf16_vpu_probe.py:36", got, want, 0.0,
            "exact against the plain version rounding each step once (as fmaf/__hfma2)",
            probes.time_ms(lambda: kernel(x, reps), trials),
            probes.time_ms(lambda: fma_chain_plain(x, reps, dtype, fused=True), 1),
            probes.bound(2 * n * 4, 4.0 * n * reps, rate), None, None,
        )
        # The Pallas body rounds product and sum apart: how far that moves the result.
        rec["max_abs_diff_two_roundings"] = float((got - two_step).abs().max())
        records.append(rec)
    clocks = probes.sm_clocks(samples_during=(lambda: kernels.fma_chain_bf16(x, reps), 1.0))
    chains = sweep(x, trials, clocks["under_load"]["median"])
    # Beside the data-sheet bound, the floor the FMA pipe sets in this run:
    # `reps` steps at the chunked instance's measured time per step.
    for rec, dtype in zip(records, ("f32", "bf16")):
        fit = chains[dtype]
        rec["pipe_floor_ms"] = reps * fit["ms_per_step"]
        rec["pipe_floor_by"] = (
            f"{reps} steps at the sweep's slope: {fit['warp_instructions_per_sm_clock']:.3f} "
            f"warp FMA instructions per SM and clock at {chains['clock_mhz']:.0f} MHz")
    f32_ms, bf16_ms = records[0]["ms"], records[1]["ms"]
    records.append({"f32_ms": f32_ms, "bf16_ms": bf16_ms, "speedup": f32_ms / bf16_ms,
                    "kernels": [records[0]["kernel"], records[1]["kernel"]]})
    records.append({"fma_chain_sweep": chains, "sm_clock_mhz": clocks, "card": probes.card()})
    return records


def sweep(x, trials: int = TRIALS, clock_mhz: float = float("nan")) -> dict:
    """Each chain kernel graph-timed at every length of SWEEP_REPS. REPS
    runs the kernels' completely unrolled instance (`unrolled_ms`, beside
    the line's value there); the other lengths run the chunked instance,
    and a least-squares line through those (reps, ms) gives the intercept,
    what does not grow with the chain (launch, loads, stores, tails), and
    the slope, the time per step; beside it the time per step between
    neighbouring lengths. From the slope, the FMA instructions issued per
    second (f32: two FFMA per element and step; bf16: two HFMA2 per two
    elements) and per SM and clock at `clock_mhz` (the warp instructions an
    SM could issue to its four FMA pipes: 4)."""
    n = x.numel()
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    chunked = [r for r in SWEEP_REPS if r != REPS]
    out = {"reps": list(SWEEP_REPS), "fit_reps": chunked, "clock_mhz": clock_mhz, "sms": sms}
    for name, kernel, instructions in (("f32", kernels.fma_chain_f32, 2 * n),
                                       ("bf16", kernels.fma_chain_bf16, n)):
        ms = [probes.time_ms(lambda r=r: kernel(x, r), trials) for r in SWEEP_REPS]
        fit_ms = [t for r, t in zip(SWEEP_REPS, ms) if r != REPS]
        slope, intercept = np.polyfit(chunked, fit_ms, 1)
        per_s = instructions / (slope * 1e-3)
        out[name] = {
            "ms": ms, "intercept_ms": float(intercept), "ms_per_step": float(slope),
            "instructions_per_s": per_s,
            "warp_instructions_per_sm_clock": per_s / 32 / sms / (clock_mhz * 1e6),
            "max_line_residual_ms": float(np.max(np.abs(
                np.polyval([slope, intercept], chunked) - fit_ms))),
            "ms_per_step_between": [(b - a) / (rb - ra) for a, b, ra, rb in zip(
                fit_ms, fit_ms[1:], chunked, chunked[1:])],
            "unrolled_ms": ms[SWEEP_REPS.index(REPS)],
            "line_ms_at_unrolled_reps": float(intercept + slope * REPS),
        }
    return out


def sass_counts() -> dict:
    """Per chain kernel of the built library (`cuobjdump -sass`, from the
    toolkit of `nvcc`): its instructions (NOP padding left out), how many
    are the chain's FMA and which opcodes those are."""
    cuobjdump = os.path.join(os.path.dirname(kernels._nvcc()), "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", str(kernels.build())], capture_output=True,
                          text=True, check=True).stdout
    out = {}
    for block in text.split("Function : ")[1:]:
        m = re.search(r"fma_chain_kernelINS_\d+(\w+?)ELi(\d+)E", block.split()[0])
        if not m:
            continue
        ops = collections.Counter(re.findall(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][\w.]*)",
                                             block))
        ops.pop("NOP", None)
        fma = {op: k for op, k in ops.items() if op.startswith(("FFMA", "HFMA2"))
               and not op.endswith(".MMA")}
        out[f"fma_chain_kernel<{m[1]}, {m[2]}>"] = {
            "instructions": sum(ops.values()), "chain_fma": fma,
            "other": sum(ops.values()) - sum(fma.values())}
    return out


def main() -> None:
    probes.run(lambda: measure() + [{"sass": sass_counts()}])


if __name__ == "__main__":
    main()
