"""Is packed-bf16 arithmetic faster than f32 on the card? The same dependent
FMA chain of two streams timed in both (counterpart of
tools/bf16_vpu_probe.py, row 10 of PERF.md's kernel table):

    python -m jrr_tpu_torch.probes.bf16_probe

Per element x of a (64·512, 128) f32 array (numpy seed 0, U[0, 1)):
acc = y = x, then `REPS` times acc ← acc·c1 + c2, y ← y·c2 + c1, and
out = acc + y in f32. The kernels round each step once (fmaf, __hfma2 on
two bf16 values per instruction). In bf16, c1 = 1 + 2^-10 rounds to 1 (the
Pallas probe's too), so that chain's acc stream adds c2 only. Prints one record per kernel and the
speed-up f32_ms / bf16_ms.
"""

from __future__ import annotations

import numpy as np
import torch

from jrr_tpu_torch import kernels, probes, resolve_device
from jrr_tpu_torch.probes import LANES

ROWS = 512
GRID = 64
REPS = 200  # chain length
C1 = 1.0009765625  # 1 + 2^-10: exact in f32, rounds to 1 in bf16 (8 significant bits)
C2 = -0.001953125  # -2^-9, exact in both
TRIALS = 30


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
    for name, dtype, kernel, rate in (
        ("fma_chain_f32", torch.float32, kernels.fma_chain_f32, probes.F32_OPS_PER_S),
        ("fma_chain_bf16", torch.bfloat16, kernels.fma_chain_bf16, probes.BF16_OPS_PER_S),
    ):
        got = kernel(x, reps)
        want = fma_chain_plain(x, reps, dtype, fused=True)
        two_step = fma_chain_plain(x, reps, dtype, fused=False)
        rec = probes.record(
            name, name + "_kernel", "tools/bf16_vpu_probe.py:36", got, want, 0.0,
            "exact against the plain version rounding each step once (as fmaf/__hfma2)",
            probes.time_ms(lambda: kernel(x, reps), trials),
            probes.time_ms(lambda: fma_chain_plain(x, reps, dtype, fused=True), 1),
            probes.bound(2 * n * 4, 4.0 * n * reps, rate), None, None,
        )
        # The Pallas body rounds product and sum apart: how far that moves the result.
        rec["max_abs_diff_two_roundings"] = float((got - two_step).abs().max())
        records.append(rec)
    f32_ms, bf16_ms = records[0]["ms"], records[1]["ms"]
    records.append({"f32_ms": f32_ms, "bf16_ms": bf16_ms, "speedup": f32_ms / bf16_ms})
    return records


def main() -> None:
    probes.run(measure)


if __name__ == "__main__":
    main()
