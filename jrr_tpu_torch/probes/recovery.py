"""Regressor recovery at product scale through the port (counterpart of
tools/recovery_bench.py): on a fixture scene whose gt_j3d was generated by a
known TRUE regressor, the shipped pipeline starts from a PERTURBED copy and
retrains it (the Adam path and the simplex-lstsq fit); every regressor is
then scored on a HELD-OUT fixture split that training never saw, against
the perturbed start and the oracle.

Phases (`--phase all` runs the three in one process, on one device):

  build    write the train fixture set (default 4096 frames at camera depth
           36-60 m, SPIN-crop scale; the masks rendered by the tile kernel
           on the card), a held-out set (default 512 frames, seed 101, the
           same true regressor), the train split's v1 and v2 packs, and
           true_regressor.npz.
  run      drive `run_pipeline(demo=True, loader="native")` over `--epochs`
           passes of the train set at batch `--batch` and the shipped
           defaults, with an Adam-path regressor snapshot per epoch; prints
           the product loop's steady-state frames/s from the run's metrics.
  analyze  replay the saved shards into the lstsq accumulator, solve at
           doubling prefixes (lstsq@k), and score every regressor (perturbed
           init, Adam final, oracle, each prefix fit, each snapshot adam@k)
           in one `evaluate_regressors` pass per split (held-out and train),
           with the weights' distance to the oracle; also every reference
           regressor on the refined vertices themselves, and the run's own
           fit against the full-prefix replay. Writes run/recovery_analysis.json
           with tools/recovery_bench.py's keys.

    python -m jrr_tpu_torch.probes.recovery --phase all --root DIR
        [--train-frames 4096] [--heldout-frames 512] [--epochs 4]
        [--batch 256] [--num-verts 6890] [--stage-a N] [--stage-b N]
        [--device cuda]

`--root` has no default: `run` deletes DIR/run, so two runs must not share
one by accident. Runs on the card unless `--device cpu` is given (a
missing card raises). The smaller knobs (`--num-verts`, `--stage-a`,
`--stage-b`) keep the whole contract runnable on the CPU at toy size.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import time
from typing import Callable, Dict, Iterator, Mapping, Optional

import numpy as np
import torch

from jrr_tpu_torch import config as cfg_lib
from jrr_tpu_torch import kernels, resolve_device
from jrr_tpu_torch.data import fixtures, native_pipeline
from jrr_tpu_torch.evals import harness
from jrr_tpu_torch.evals import metrics as metrics_lib
from jrr_tpu_torch.models import smpl as smpl_lib
from jrr_tpu_torch.ops import jreg as jreg_lib
from jrr_tpu_torch.pipeline import demo_regressors, replay_vertices, run_pipeline
from jrr_tpu_torch.refine import losses, trainer
from jrr_tpu_torch.utils import precision
from jrr_tpu_torch.utils.checkpoint import ShardManifest
from jrr_tpu_torch.utils.logging import MetricsLogger

# Must equal cfg.seed: run_pipeline(demo=True) draws the true regressor from
# it before perturbing it, and the fixtures must come from that regressor.
SEED = 0
HELDOUT_SEED = 101
DEPTH = (36.0, 60.0)  # camera z of SPIN crops at focal 5000 / 224 px
PREFIXES = (1, 2, 4, 8, 16, 32, 64, 128)
REFERENCE_NAMES = ("init (perturbed)", "adam final", "oracle (true)")
DIAG_NAMES = ("init", "adam", "lstsq", "oracle")


def _emit(record: Mapping, log: Optional[Callable[[str], None]] = print) -> None:
    if log is not None:
        log(json.dumps(record))


def true_regressor(num_verts: int) -> np.ndarray:
    """The regressor that generates the fixtures: `run_pipeline(demo=True)`'s
    own, drawn from the shipped config's seed."""
    return demo_regressors(num_verts, SEED)[0]


def make_model(num_verts: int, device) -> smpl_lib.SMPLModel:
    """The synthetic body every phase builds (the same, or the shards'
    replay and the regressors' shapes drift)."""
    return smpl_lib.synthetic_smpl_model(seed=SEED, num_verts=num_verts, device=device)


def build(root: str, model, train_frames: int, heldout_frames: int, log=print) -> Dict:
    """Fixtures of both splits, the train split's packs and
    true_regressor.npz under `root`; a split or pack already there is kept.
    Returns the launches of the build's kernels."""
    os.makedirs(root, exist_ok=True)
    j_true = true_regressor(model.num_verts)
    np.savez(os.path.join(root, "true_regressor.npz"), j_regressor=j_true)
    kernels.reset_launches()
    for name, n, seed in (("train", train_frames, SEED), ("heldout", heldout_frames, HELDOUT_SEED)):
        split = os.path.join(root, name)
        if os.path.exists(os.path.join(split, "precomputed_val")):
            _emit({"phase": f"build_{name}", "cached": True}, log)
            continue
        t0 = time.perf_counter()
        fixtures.write_fixture_dataset(split, num_frames=n, seed=seed, model=model,
                                       j_reg_raw=j_true, depth_range=DEPTH)
        _emit({"phase": f"build_{name}", "frames": n, "seconds": time.perf_counter() - t0}, log)
    train_root = os.path.join(root, "train")
    for builder, fname in ((native_pipeline.pack_dataset, "frames.jrrpack"),
                           (native_pipeline.build_pack2, "frames.jrrpack2")):
        if not os.path.exists(os.path.join(train_root, "precomputed_val", fname)):
            t0 = time.perf_counter()
            builder(train_root, "validation")
            _emit({"phase": f"build_{fname}", "seconds": time.perf_counter() - t0}, log)
    launches = _launches()
    _emit({"phase": "build", "launches": launches}, log)
    return launches


def _launches() -> Dict[str, int]:
    return {w.__name__: w.launches for w in kernels.WRAPPERS}


def run(root: str, model, train_frames: int, epochs: int = 4, batch: int = 256,
        stage_a: Optional[int] = None, stage_b: Optional[int] = None, log=print) -> Dict:
    """`run_pipeline(demo=True, loader="native")` on root/train into a new
    root/run; saves the perturbed start as run/perturbed_init.npz. Returns
    the product loop's record (frames/s as tools/pipeline_bench.py derives
    it: wall time between the first and last shard records) with the
    run's kernel launches. `stage_a` and `stage_b` replace the shipped
    step counts when given."""
    run_dir = os.path.join(root, "run")
    if os.path.exists(run_dir):
        shutil.rmtree(run_dir)  # a resume would skip all the work
    os.makedirs(run_dir)
    refiner = cfg_lib.RefinerConfig()
    refiner = dataclasses.replace(
        refiner,
        stage_a_steps=refiner.stage_a_steps if stage_a is None else stage_a,
        stage_b_steps=refiner.stage_b_steps if stage_b is None else stage_b,
    )
    cfg = cfg_lib.PipelineConfig(
        refiner=refiner,
        data=dataclasses.replace(cfg_lib.DataConfig(), batch_size=batch, train_epochs=epochs),
        # One Adam-path snapshot per epoch: the adam@k rows of `analyze`.
        jreg=dataclasses.replace(cfg_lib.JRegConfig(),
                                 snapshot_interval=max(1, train_frames // batch)),
    )
    assert cfg.seed == SEED
    metrics_path = os.path.join(run_dir, "metrics.jsonl")
    logger = MetricsLogger(path=metrics_path, echo=False)
    kernels.reset_launches()
    t0 = time.perf_counter()
    try:
        arts = run_pipeline(cfg, data_root=os.path.join(root, "train"), out_dir=run_dir,
                            demo=True, logger=logger, loader="native", model=model,
                            demo_frames=train_frames)
    finally:
        logger.close()
    total_s = time.perf_counter() - t0
    np.savez(os.path.join(run_dir, "perturbed_init.npz"), j_regressor=arts.j_reg_initial)
    with open(metrics_path) as f:
        recs = [json.loads(line) for line in f if line.strip()]
    shard_recs = [r for r in recs if "batch_seconds" in r]
    per_batch = [r["batch_seconds"] for r in shard_recs]
    steady = per_batch[1:] or per_batch
    steady_s = (shard_recs[-1]["ts"] - shard_recs[0]["ts"] if len(shard_recs) >= 2
                else sum(steady))
    record = {
        "metric": "product_pipeline_frames_per_sec_per_chip",
        "value": batch * len(steady) / steady_s,
        "unit": f"frames/s on one {model.v_template.device.type} device (shipped defaults, "
                f"batch {batch}, {len(per_batch)} batches = {epochs} epochs x "
                f"{train_frames} frames)",
        "first_batch_s_incl_compile": per_batch[0],
        "steady_per_batch_s": steady_s / max(len(steady), 1),
        "end_to_end_s_incl_eval": total_s,
        "phase_seconds": arts.seconds,
        "launches": _launches(),
    }
    _emit(record, log)
    return record


def tensor_batches(root: str, batch: int) -> Iterator[Dict[str, np.ndarray]]:
    """A split's stored estimates and ground truth from its tensors.npz,
    `batch` frames at a time, the last partial batch dropped (as the
    loader drops it): the eval needs no image."""
    with np.load(os.path.join(root, "precomputed_val", "tensors.npz")) as f:
        pose, orient, betas, gt_j3d = f["pose"], f["orient"].reshape(-1, 1, 6), f["betas"], f["gt_j3d"]
    for i in range(0, pose.shape[0] - batch + 1, batch):
        yield {
            "pose6d": np.concatenate([orient[i:i + batch], pose[i:i + batch]], 1),
            "betas": betas[i:i + batch],
            "gt_j3d": gt_j3d[i:i + batch],
        }


def _snapshots(run_dir: str):
    """(shards covered, regressor) of each Adam-path snapshot, in order."""
    snap_dir = os.path.join(run_dir, "jreg_snapshots")
    snaps = []
    if os.path.isdir(snap_dir):
        for fname in sorted(os.listdir(snap_dir)):
            with np.load(os.path.join(snap_dir, fname)) as f:
                snaps.append((int(f["shard"]) + 1, f["j_regressor"]))
    return snaps


def analyze(run_dir: str, j_true: np.ndarray, j_init: np.ndarray, splits: Mapping[str, str],
            model, batch: int = 256, exact: bool = False, log=print):
    """The recovery report of the run in `run_dir` (its refined shards,
    snapshots and retrained_j_regressor.npz), the regressors scored over
    each split root of `splits` (name → root) on the model's device. The
    report's numbers are rounded as tools/recovery_bench.py rounds them,
    or kept whole with `exact`. Writes run_dir/recovery_analysis.json and
    returns (report, {shards: that prefix's (17, V) fit})."""
    t_start = time.perf_counter()
    dev = model.v_template.device
    rnd = (lambda x, n: float(x)) if exact else (lambda x, n: round(float(x), n))  # noqa: E731
    with np.load(os.path.join(run_dir, "retrained_j_regressor.npz")) as f:
        j_adam, j_lstsq_run = f["j_regressor"], f["j_regressor_lstsq"]
    as_t = lambda x: torch.as_tensor(np.asarray(x), device=dev)  # noqa: E731

    # The prefix-lstsq curve from the saved shards, and every reference
    # regressor scored on the refined vertices themselves: the j3d term
    # drags the vertices towards the training regressor, so the oracle
    # winning there would show refinement recovering the true surface.
    manifest = ShardManifest(os.path.join(run_dir, "refined"))
    shards = manifest.completed()
    acc = trainer.JRegLstsqAccumulator.zero(model.num_verts, device=dev)
    diag_norms = torch.stack([jreg_lib.normalize_jreg(as_t(j).float())
                              for j in (j_init, j_adam, j_lstsq_run, j_true)])
    diag_tot = np.zeros((len(DIAG_NAMES), 2))
    prefix_points = sorted({p for p in PREFIXES if p <= len(shards)} | {len(shards)})
    prefix_regs = {}
    with torch.no_grad(), precision.float32_products():
        for k, sid in enumerate(shards, start=1):
            saved = manifest.read_shard(sid)
            params = losses.FrameParams(*(as_t(saved[f]) for f in losses.FrameParams._fields))
            verts = replay_vertices(model, params)
            gt = as_t(saved["gt_j3d"])
            acc = trainer.jreg_lstsq_accumulate(acc, verts, gt, as_t(saved["joints3d"][:, :1]))
            per = []
            for norm in diag_norms:
                e = metrics_lib.evaluate(jreg_lib.apply_jreg(norm, verts), gt)
                per.append(torch.stack([e.per_frame_mpjpe.mean(), e.per_frame_pa_mpjpe.mean()]))
            diag_tot += torch.stack(per).cpu().numpy()
            if k in prefix_points:
                prefix_regs[k] = trainer.jreg_lstsq_solve(acc).cpu().numpy()
                _emit({"phase": "prefix_solve", "batches": k}, log)

    snaps = _snapshots(run_dir)
    names = (list(REFERENCE_NAMES) + [f"lstsq@{k}" for k in prefix_points]
             + [f"adam@{k}" for k, _ in snaps])
    regs = ([j_init, j_adam, j_true] + [prefix_regs[k] for k in prefix_points]
            + [j for _, j in snaps])

    def normalized(j):
        return jreg_lib.normalize_jreg(torch.as_tensor(np.asarray(j, np.float32))).numpy()

    oracle = normalized(j_true)

    def dist(j):
        return float(np.linalg.norm(normalized(j) - oracle) / np.linalg.norm(oracle))

    report = {"n_shards": len(shards), "splits": {}}
    for split, root in splits.items():
        results = harness.evaluate_regressors(model, tensor_batches(root, min(batch, 256)), regs)
        if results[0].num_frames == 0:  # all zeros otherwise, as if every fit were perfect
            raise ValueError(f"split {split!r} ({root}) holds fewer than {min(batch, 256)} frames")
        rows = {
            name: {"mpjpe": rnd(r.mpjpe, 3), "pa_mpjpe": rnd(r.pa_mpjpe, 3),
                   "weight_rel_dist_to_oracle": rnd(dist(j), 4)}
            for name, r, j in zip(names, results, regs)
        }
        init_m, oracle_m = rows["init (perturbed)"]["mpjpe"], rows["oracle (true)"]["mpjpe"]
        for name in ("adam final", f"lstsq@{len(shards)}"):
            rows[name]["gap_closed_frac"] = rnd(
                (init_m - rows[name]["mpjpe"]) / max(init_m - oracle_m, 1e-9), 4)
        report["splits"][split] = rows
        _emit({"split": split, "rows": rows}, log)

    diag_tot /= max(len(shards), 1)
    report["on_refined_vertices"] = {
        name: {"mpjpe": rnd(diag_tot[i, 0], 2), "pa_mpjpe": rnd(diag_tot[i, 1], 2)}
        for i, name in enumerate(DIAG_NAMES)
    }
    _emit({"on_refined_vertices": report["on_refined_vertices"]}, log)
    # The run's own fit (accumulated online) against the full-prefix replay.
    full = prefix_regs[len(shards)]
    report["run_lstsq_matches_replay_rel"] = float(
        np.linalg.norm(j_lstsq_run - full) / max(np.linalg.norm(full), 1e-9))
    out = os.path.join(run_dir, "recovery_analysis.json")
    with open(out, "w") as f:
        json.dump(report, f, indent=2)
    _emit({"phase": "analyze_done", "out": out, "seconds": time.perf_counter() - t_start}, log)
    return report, prefix_regs


def analyze_root(root: str, model, batch: int = 256, exact: bool = False, log=print) -> Dict:
    """`analyze` on the layout `build` and `run` write under `root`."""
    run_dir = os.path.join(root, "run")
    with np.load(os.path.join(root, "true_regressor.npz")) as f:
        j_true = f["j_regressor"]
    with np.load(os.path.join(run_dir, "perturbed_init.npz")) as f:
        j_init = f["j_regressor"]
    splits = {name: os.path.join(root, name) for name in ("heldout", "train")}
    return analyze(run_dir, j_true, j_init, splits, model, batch=batch, exact=exact, log=log)[0]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phase", choices=["build", "run", "analyze", "all"], default="all")
    ap.add_argument("--root", required=True,
                    help="the splits, packs and run/ go here; run/ is deleted first")
    ap.add_argument("--train-frames", type=int, default=4096)
    ap.add_argument("--heldout-frames", type=int, default=512)
    ap.add_argument("--epochs", type=int, default=4)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--num-verts", type=int, default=6890)
    ap.add_argument("--stage-a", type=int, default=None)
    ap.add_argument("--stage-b", type=int, default=None)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    model = make_model(args.num_verts, resolve_device(args.device))
    os.makedirs(args.root, exist_ok=True)
    if args.phase in ("build", "all"):
        build(args.root, model, args.train_frames, args.heldout_frames)
    if args.phase in ("run", "all"):
        run(args.root, model, args.train_frames, args.epochs, args.batch, args.stage_a,
            args.stage_b)
    if args.phase in ("analyze", "all"):
        analyze_root(args.root, model, args.batch)


if __name__ == "__main__":
    main()
