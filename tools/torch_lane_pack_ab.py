"""Wall time of `refine_batch` with and without lane packing, on one card.

    python3 tools/torch_lane_pack_ab.py [--pairs 3] [--batch 256]

Runs the synthetic problem of `chip_smoke.py` (full width, 1000 + 100 steps,
shipped defaults, live discriminators) in turns A B B A (A lane-packed,
B unpacked) after warming both up, so the host's drift cancels, and splits
each call's host time over the layers it passes through: binning, the
interior skip, `pack_bins`, the loss wrapper, the stage-B loss forward and
`torch.autograd.grad`. One JSON line per call, then the means; the card's
name and power limit last. The call is host-bound (PERF.md section 5), so
only calls of one run compare.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import functools
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _timed(acc, mod, name):
    """Replace `mod.name` by a wrapper that adds its host seconds to acc[name]."""
    fn = getattr(mod, name)

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        acc[name] += time.perf_counter() - t0
        return out

    setattr(mod, name, wrapper)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--pairs", type=int, default=3, help="A B B A turns count two pairs")
    parser.add_argument("--batch", type=int, default=256)
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this times refine_batch on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import chip_smoke
    from jrr_tpu_torch import problem as problem_lib
    from jrr_tpu_torch.models import discriminator
    from jrr_tpu_torch.refine import engine, losses
    from jrr_tpu_torch.render import silhouette_fused as sf

    model, j_reg, cfg, init, data = problem_lib.synthetic_problem(
        batch=args.batch, seed=0, device="cuda")
    pose_disc = discriminator.PoseDiscriminator(seed=7, device="cuda")
    shape_disc = discriminator.ShapeDiscriminator(seed=8, device="cuda")
    cfg = dataclasses.replace(cfg, stage_a_steps=1000, stage_b_steps=100)
    cfgs = {"lane_pack": chip_smoke._with_backend(cfg, "auto", lane_pack=True), "unpacked": cfg}

    acc = collections.defaultdict(float)
    for mod, name in ((sf, "compute_fused_bins"), (sf, "apply_interior_skip"), (sf, "pack_bins"),
                      (sf, "fused_lossgrad_packed"), (sf, "fused_lossgrad"),
                      (losses, "stage_b_loss"), (torch.autograd, "grad")):
        _timed(acc, mod, name)

    def call(name):
        acc.clear()
        t0 = time.perf_counter()
        engine.refine_batch(model, j_reg, init, data, cfgs[name], pose_disc, shape_disc)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, dict(acc)

    for name in cfgs:
        call(name)  # warm-up
    seconds = {name: [] for name in cfgs}
    for pair in range(args.pairs):
        order = ("lane_pack", "unpacked") if pair % 2 == 0 else ("unpacked", "lane_pack")
        for name in order:
            s, layers = call(name)
            seconds[name].append(s)
            print(json.dumps({"config": name, "seconds": s, "host_seconds_by_layer": layers}), flush=True)
    means = {name: sum(v) / len(v) for name, v in seconds.items()}
    print(json.dumps({"mean_seconds": means, "lane_pack_over_unpacked": means["lane_pack"] / means["unpacked"],
                      "batch": args.batch, "pairs": args.pairs}), flush=True)
    print(chip_smoke._card(), flush=True)


if __name__ == "__main__":
    main()
