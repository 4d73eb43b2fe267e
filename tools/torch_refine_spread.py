"""How far a short refinement through the port's CUDA kernels drifts from the
same refinement through their plain PyTorch versions, over problem seeds,
and where the two part.

    python3 tools/torch_refine_spread.py [--seeds 12] [--trace-seeds 9 12]

For each seed, `chip_smoke.compare_kernel_and_plain_refine` (full width,
batch 2, 20 + 10 steps): kernel vs plain, kernel vs kernel, plain vs plain,
and each against the plain versions in float64. One JSON line per seed, then
a summary line.

For each trace seed, the same three refinements (kernel, plain float32,
plain float64) with every Adam step recorded: per step, the largest
parameter difference and the largest gradient difference (relative to the
largest gradient) of kernel vs plain, plain vs float64 and kernel vs
float64. Steps 0-19 are stage A (camera only), 20-24 the coarse stage-B
phase, 25-29 the fine one. Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _traced(run):
    """Run `run()` with every Adam step's parameters and gradients recorded."""
    import torch

    from jrr_tpu_torch.refine import engine

    log = []
    base = engine._Adam

    class Recording(base):
        def step(self, params, grads):
            super().step(params, grads)
            copy = lambda ts: [t.detach().to(torch.float64, copy=True) for t in ts]  # noqa: E731
            log.append((copy(params), copy(grads)))

    engine._Adam = Recording
    try:
        run()
    finally:
        engine._Adam = base
    return log


def _step_diffs(a, b):
    """Per recorded step: (max |Δparam|, max |Δgrad| / max |grad|)."""
    rows = []
    for (pa, ga), (pb, gb) in zip(a, b):
        dp = max(float((x - y).abs().max()) for x, y in zip(pa, pb))
        scale = max(float(y.abs().max()) for y in gb) + 1e-30
        dg = max(float((x - y).abs().max()) for x, y in zip(ga, gb)) / scale
        rows.append((dp, dg))
    return rows


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seeds", type=int, default=12)
    parser.add_argument("--trace-seeds", type=int, nargs="*", default=[9, 12])
    args = parser.parse_args()
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch

    if not torch.cuda.is_available():
        print("torch_refine_spread: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke
    from jrr_tpu_torch.models import discriminator

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pose_disc = discriminator.PoseDiscriminator(seed=7, device="cuda")
    shape_disc = discriminator.ShapeDiscriminator(seed=8, device="cuda")
    rows = []
    for seed in range(1, args.seeds + 1):
        row = chip_smoke.compare_kernel_and_plain_refine(pose_disc, shape_disc, seed=seed)
        rows.append(row)
        print(json.dumps(row), flush=True)
    kvp = [r["max_param_abs_diff"] for r in rows]
    print(json.dumps({"summary": {
        "seeds": args.seeds, "kernel_vs_plain_sorted": sorted(kvp),
        "above_5e-4": sum(d > 5e-4 for d in kvp),
        "kernel_vs_float64_sorted": sorted(r["kernel_vs_float64"] for r in rows),
        "plain_vs_float64_sorted": sorted(r["plain_vs_float64"] for r in rows),
        "kernel_closer_to_float64": sum(r["kernel_vs_float64"] < r["plain_vs_float64"] for r in rows),
        "card": chip_smoke._card(),
    }}), flush=True)

    for seed in args.trace_seeds:
        problem = chip_smoke.short_problem(seed)
        runs = {
            name: _traced(lambda kw=kw: chip_smoke.short_refine(problem, pose_disc, shape_disc, **kw))
            for name, kw in (("kernel", {}), ("plain", {"plain": True}),
                             ("float64", {"plain": True, "float64": True}))
        }
        trace = {
            pair: _step_diffs(runs[a], runs[b])
            for pair, (a, b) in (("kernel_vs_plain", ("kernel", "plain")),
                                 ("plain_vs_float64", ("plain", "float64")),
                                 ("kernel_vs_float64", ("kernel", "float64")))
        }
        print(json.dumps({"trace": {"seed": seed, "steps": len(runs["kernel"]), **{
            pair: {"param": [d[0] for d in rows_], "grad_rel": [d[1] for d in rows_]}
            for pair, rows_ in trace.items()
        }}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
