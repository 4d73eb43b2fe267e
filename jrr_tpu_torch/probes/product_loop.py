"""Product frames/s of the port's product loop on the card, for the checkout
at `--root` (default: the one holding this file), so that two checkouts can
be timed in turns in one call:

    python jrr_tpu_torch/probes/product_loop.py [--root DIR] [--runs 2]

Writes `chip_smoke.py`'s product fixtures (512 frames at camera depth
36-60 m, the 6890-vertex synthetic body, the shipped config's seed) and
both packs into a temporary directory, then calls
`run_pipeline(demo=True, loader="auto")` `--runs` times at the shipped
defaults (batch 256, two shards), each into a new out dir: the first also
warms the card up. Prints one JSON record per run (its phase seconds and
product frames/s: frames over `run_optimize`'s seconds), then the card.
Run by path, not with -m: `--root` decides which package it imports.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

FRAMES = 512  # two shards of the shipped batch
DEPTH = (36.0, 60.0)  # chip_smoke.PRODUCT_DEPTH


def main() -> None:
    here = os.path.dirname(os.path.abspath(__file__))
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--root", default=os.path.dirname(os.path.dirname(here)))
    p.add_argument("--runs", type=int, default=2)
    args = p.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the product loop is timed on the card")
    from jrr_tpu_torch import config, kernels
    from jrr_tpu_torch.data import fixtures, native_pipeline
    from jrr_tpu_torch.models import smpl
    from jrr_tpu_torch.pipeline import _demo_regressor, run_pipeline

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernels.build()
    cfg = config.PipelineConfig()
    model = smpl.synthetic_smpl_model(seed=0, device="cuda")
    j_true = _demo_regressor(model.num_verts, np.random.default_rng(cfg.seed))
    with tempfile.TemporaryDirectory() as tmp:
        data_root = os.path.join(tmp, "fixtures")
        fixtures.write_fixture_dataset(data_root, FRAMES, seed=cfg.seed, model=model,
                                       j_reg_raw=j_true, depth_range=DEPTH)
        native_pipeline.pack_dataset(data_root)
        native_pipeline.build_pack2(data_root)
        for run in range(args.runs):
            t0 = time.perf_counter()
            arts = run_pipeline(cfg, data_root=data_root, out_dir=os.path.join(tmp, f"run{run}"),
                                demo=True, model=model, loader="auto")
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            print(json.dumps({
                "root": os.path.abspath(args.root), "run": run, "seconds": seconds,
                "phase_seconds": arts.seconds,
                "product_frames_per_s": FRAMES / arts.seconds["optimize"],
            }), flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps({"card": card.splitlines()[0]}), flush=True)


if __name__ == "__main__":
    main()
