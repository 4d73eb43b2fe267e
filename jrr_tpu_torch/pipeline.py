"""End-to-end product loop (counterpart of jrr_tpu/pipeline.py:27-713;
reference main.py:13-27): fixtures or the converted dataset → optimize
(refine + train the regressor and discriminators over the batches) → the
closed-form regressor fit → protocol-2 evaluation before/after.

`run_optimize` keeps jrr_tpu's structure on one card:
- a prefetch thread loads each batch and copies it to the card (plain
  synchronous copies on the default stream, so a batch is complete on the
  card before the main thread sees it, and ordered after the work already
  queued there);
- an ordered writer thread owns every device→host pull: refined shards
  (with a manifest, so a restart skips completed shards), regressor
  snapshots and accumulator checkpoints. Its pulls run on the default
  stream too, so each waits for the step that produced it. A writer error
  stops the run at the next put or check;
- the writer also checkpoints the train state after every shard (ckpt/,
  with resume.json naming the last shard it includes), so a resume
  continues the regressor's and discriminators' Adam trajectory where it
  stopped: it restores that state, replays the completed shards it
  includes into the lstsq accumulator (or restores the accumulator's
  checkpoint, every `ACC_CKPT_EVERY` shards) after checking that each
  shard's stored gt_j3d pairs with this run's batch, and runs every later
  shard again, its regressor snapshot included. Every file is written whole
  or not at all (tmp + `os.replace`). jrr_tpu saves its state only at the
  end of a run and restarts Adam after a mid-run crash
  (jrr_tpu/pipeline.py:272,395); a directory with such a state (no
  resume.json) resumes as jrr_tpu resumes it.

With a SPIN checkpoint every batch's initial estimates come from the
network on its 224² crop (`make_spin_fn`), run by the main thread just
before the batch's outer step, so the launch order stays that of one
thread; with VIBE/MEVA checkpoints the retrained regressor is also scored
through those video models, frame by frame and over real sequences
(`evals/consumers.py`).

The batches come from the host runtime's pack loader
(`data/native_pipeline.py`) with `loader="native"`, or with "auto" when the
split has a frames.jrrpack (the pre-warped frames.jrrpack2 is read when it
exists); otherwise from H36MDataset + BatchLoader.

Under `torch.distributed` (one process per GPU, `parallel/`), every process
loads each global batch and refines its contiguous rows of it, so batch k
covers the frames it covers in a one-process run. Per outer step the main
thread of every process issues the same collectives in the same order: the
shared gradients and the metrics (refine/trainer.py), the batch's lstsq
statistics (so every process holds the global accumulator) and a gather of
the refined rows. Rank 0 alone writes files (its writer thread issues no
collective) and runs the fit, the evals and the consumers while the others
wait at a barrier; every process restores the same state on resume, and
replays only its rows of a completed shard. Without `torch.distributed`
nothing of this runs.
"""

from __future__ import annotations

import dataclasses
import json
import os
import queue as queue_mod
import re
import threading
import time
from typing import Dict, Iterable, Optional

import numpy as np
import torch

from jrr_tpu_torch import constants, resolve_device
from jrr_tpu_torch.config import PipelineConfig
from jrr_tpu_torch.data import fixtures, h36m, native_pipeline
from jrr_tpu_torch.evals import consumers, harness
from jrr_tpu_torch.models import smpl as smpl_lib
from jrr_tpu_torch.models import spin as spin_lib
from jrr_tpu_torch.parallel import mesh as mesh_lib
from jrr_tpu_torch.refine import engine, losses, trainer
from jrr_tpu_torch.utils import checkpoint as ckpt_lib
from jrr_tpu_torch.utils import precision
from jrr_tpu_torch.utils.logging import outer_metrics_record

# Accumulator checkpoint cadence: without it a resume near the end of a long
# run replays every completed shard's SMPL forward. The gram is (V, V),
# ~190 MB at V = 6890, so it is written every N shards.
ACC_CKPT_EVERY = 16

_STATE_FILE = re.compile(r"state_\d{8}\.npz")
_SNAP_FILE = re.compile(r"snap_(\d+)\.npz")
# In the out dir: names the newest mid-run train state and the last shard
# it includes.
_RESUME_MARKER = "resume.json"

# The loader's prefetch thread, reused for the host→device staging.
_prefetch_iter = h36m.background_iter


@dataclasses.dataclass
class PipelineArtifacts:
    j_reg_initial: np.ndarray
    j_reg_final: np.ndarray
    j_reg_lstsq: Optional[np.ndarray]
    # None on the ranks other than 0 of a multi-process run, which run no
    # fit and no eval.
    eval_before_after: Optional[harness.BeforeAfter]
    out_dir: str
    eval_lstsq: Optional[harness.EvalResult] = None
    # Wall seconds of each phase: fixtures (demo), optimize, fit, eval, and
    # with consumers consumer_frame (their build and the frame-level pass)
    # and consumer_sequence.
    seconds: Dict[str, float] = dataclasses.field(default_factory=dict)
    # The batches' source: "python" (H36MDataset + BatchLoader), "pack" (the
    # raw v1 pack) or "pack2" (the pre-warped v2 pack).
    loader: str = "python"
    # kind ("vibe"/"meva" [+ " (sequence)"]) → BeforeAfter, when consumer
    # checkpoints were given (reference: main.py:26-27 runs both).
    consumer_evals: Dict[str, harness.BeforeAfter] = dataclasses.field(default_factory=dict)
    # The lstsq statistics the fit solved (global sums), on the run's device.
    accumulator: Optional[trainer.JRegLstsqAccumulator] = None


def _to_device(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x), device=device)


def _frame_batch(batch: Dict[str, np.ndarray], cfg: PipelineConfig, device) -> losses.FrameBatch:
    """The batch's targets on `device`. When the silhouette term is live at
    a smaller resolution than the stored mask (e.g. --demo), the mask is
    mean-pooled down to match; the rasterizer spec scales focal
    accordingly, so mask and render stay pixel-aligned."""
    mask = batch.get("mask_rcnn")
    if mask is not None and mask.ndim == 4:
        mask = mask[:, 0]
    if mask is not None and cfg.refiner.use_silhouette:
        target = cfg.refiner.silhouette.image_size
        src = mask.shape[-1]
        if src != target:
            if src % target != 0:
                raise ValueError(
                    f"mask resolution {src} is not an integer multiple of the "
                    f"silhouette size {target}"
                )
            f = src // target
            mask = mask.reshape(mask.shape[0], target, f, target, f).mean(axis=(2, 4))
    return losses.FrameBatch(
        gt_j2d=_to_device(batch["gt_j2d"], device), gt_j3d=_to_device(batch["gt_j3d"], device),
        mask=None if mask is None else _to_device(mask, device),
    )


def _stored_init(batch: Dict[str, np.ndarray], device) -> losses.FrameParams:
    """The stored orient/pose/betas/cam tensors (the reference's precomputed
    SPIN outputs) as the initial estimates."""
    return losses.FrameParams(
        pose6d=_to_device(batch["pose"], device),
        orient6d=_to_device(batch["orient"], device).reshape(-1, 1, 6),
        betas=_to_device(batch["betas"], device),
        cam_t=_to_device(batch["cam"], device),
    )


def _spin_init(spin_fn, spin_image01: torch.Tensor) -> losses.FrameParams:
    """SPIN's estimates on the [0, 1] crops as the initial estimates
    (reference: scripts/optimize.py:164-182)."""
    return engine.spin_prediction_to_params(*spin_fn(spin_lib.normalize_image(spin_image01)))


def _batch_to_device_inputs(batch: Dict[str, np.ndarray], cfg: PipelineConfig, device,
                            spin_fn=None):
    """Host batch dict → (FrameParams init, FrameBatch data) on `device`.

    With `spin_fn` (`make_spin_fn`) the initial estimates come from the
    network on the 224² crop; otherwise from the stored tensors."""
    data = _frame_batch(batch, cfg, device)
    if spin_fn is not None:
        return _spin_init(spin_fn, _to_device(batch["spin_image"], device)), data
    return _stored_init(batch, device), data


@torch.no_grad()
def replay_vertices(model, params: losses.FrameParams) -> torch.Tensor:
    """The refined vertices of saved parameters, computed as `refine_batch`
    computes its final ones (TF32 off)."""
    with precision.float32_products():
        return losses.forward_frame(model, params).vertices


class _OrderedWriter:
    """A thread that runs `handle(item)` for each put item, in order. A
    failure is kept and raised by the next `put` or `check`; `put` polls it
    while the queue is full, so a dead writer cannot block the caller."""

    def __init__(self, handle, depth: int = 2):
        self._handle = handle
        self._q: queue_mod.Queue = queue_mod.Queue(maxsize=depth)
        self._err: list = []
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            try:
                self._handle(item)
            except BaseException as e:  # raised in the main thread by check()
                self._err.append(e)
                return

    def check(self):
        if self._err:
            raise RuntimeError("async shard writer failed") from self._err[0]

    def put(self, item):
        while True:
            self.check()
            try:
                self._q.put(item, timeout=5.0)
                return
            except queue_mod.Full:
                continue

    def close(self):
        """Let the thread finish what is queued, then stop it."""
        while self._thread.is_alive():
            try:
                self._q.put(None, timeout=0.1)
                break
            except queue_mod.Full:
                continue
        self._thread.join()


def _timed(iterator):
    """(seconds the consumer waited for the item, item) for each item."""
    while True:
        t0 = time.perf_counter()
        try:
            item = next(iterator)
        except StopIteration:
            return
        yield time.perf_counter() - t0, item


def _run_mesh(cfg: PipelineConfig, dev) -> Optional[mesh_lib.Mesh]:
    """The process mesh of a run under `torch.distributed`, else None; a
    configured device count must be the process count."""
    n = cfg.mesh.num_devices
    if not mesh_lib.initialized():
        if n is not None and n > 1:
            raise ValueError(f"mesh.num_devices={n} in a single process: "
                             + mesh_lib.launch_hint(n))
        return None
    mesh = mesh_lib.make_mesh(n, device=dev)
    if mesh.device != dev:
        raise ValueError(f"rank {mesh.rank} runs on {dev}, not its own device {mesh.device}")
    if cfg.data.batch_size % mesh.world_size:
        raise ValueError(
            f"batch size {cfg.data.batch_size} does not split over {mesh.world_size} processes; "
            f"{mesh_lib.feasible_device_count(cfg.data.batch_size, mesh.world_size)} would")
    return mesh


def _local_rows(batch: Dict[str, np.ndarray], rows: Optional[slice]) -> Dict[str, np.ndarray]:
    """A process's rows of every per-frame entry of a host batch."""
    if rows is None:
        return batch
    n = len(batch["gt_j3d"])
    return {k: v[rows] if hasattr(v, "__len__") and len(v) == n else v for k, v in batch.items()}


def run_optimize(
    cfg: PipelineConfig,
    model,
    j_reg_initial: np.ndarray,
    batches: Iterable[Dict[str, np.ndarray]],
    out_dir: str,
    logger=None,
    resume: bool = True,
    spin_fn=None,
):
    """The `optimize_pose_refiner` equivalent (reference:
    scripts/optimize.py:88-337), on the model's device: one outer step per
    batch through the run's program (`trainer.compile_outer_step`, and
    `trainer.compile_accumulate` for the lstsq accumulator; CUDA graphs
    captured at the first batch of each shape), shard writes, resume.

    With `spin_fn` (`make_spin_fn`) each refined batch starts from SPIN's
    estimates on its crops: the prefetch thread stages the crops, and the
    main thread runs the network just before the batch's outer step, so
    every launch comes from one thread in a fixed order (a resumed shard
    needs no estimates and runs no network).

    Under `torch.distributed` each process refines its rows of every batch
    (module docstring); `cfg.mesh.num_devices`, when set, must be the
    process count, and the model must sit on this process's device.

    Returns (final TrainState, JRegLstsqAccumulator, ShardManifest); the
    state and the accumulator are global and the same on every process."""
    dev = model.v_template.device
    mesh = _run_mesh(cfg, dev)
    lead = mesh is None or mesh.is_lead
    manifest = ckpt_lib.ShardManifest(os.path.join(out_dir, "refined"))
    ckpt_dir = os.path.join(out_dir, "ckpt")
    snap_dir = os.path.join(out_dir, "jreg_snapshots")
    acc_path = os.path.join(out_dir, "jreg_acc_ckpt.npz")
    marker = os.path.join(out_dir, _RESUME_MARKER)
    state = trainer.init_train_state(
        torch.as_tensor(j_reg_initial, dtype=torch.float32, device=dev), cfg, seed=cfg.seed
    )
    # `covered`: the last shard whose outer step the state includes (None:
    # every completed shard). Later shards run again, and so rewrite every
    # file a crash may have left half-written beside its final path.
    covered = -1
    if resume:
        state, covered = _restore_train_state(ckpt_dir, marker, state)
    done = set(manifest.completed()) if resume else set()

    acc = trainer.JRegLstsqAccumulator.zero(model.num_verts, device=dev)
    acc_upto = -1
    if resume and os.path.exists(acc_path):
        with np.load(acc_path) as f:
            upto = int(f["upto"])
            if covered is None or upto <= covered:
                acc = trainer.JRegLstsqAccumulator(
                    *(torch.as_tensor(f[k], device=dev) for k in ("gram", "rhs", "count"))
                )
                acc_upto = upto
    if mesh is not None:
        mesh_lib.barrier(mesh)  # every process has read the out dir before rank 0 writes
    if lead and covered is not None and os.path.isdir(snap_dir):
        for name in os.listdir(snap_dir):
            m = _SNAP_FILE.fullmatch(name)
            if m and int(m.group(1)) > covered:
                os.remove(os.path.join(snap_dir, name))
    # The batch's statistics summed over the processes before they are
    # added: every process holds the global accumulator.
    reduce = None if mesh is None else (lambda part: mesh_lib.sum_over_ranks(mesh, part))
    # One program per run, as jrr_tpu builds its jitted step and accumulate
    # (jrr_tpu/pipeline.py:204-211): captured at the first batch of each
    # shape, replayed for the others.
    step_fn = trainer.compile_outer_step(cfg, mesh=mesh)
    accumulate = trainer.compile_accumulate(mesh)

    def write(item):
        kind, sid, payload = item
        if kind == "shard":
            manifest.write_shard(sid, {
                k: v.cpu().numpy() if isinstance(v, torch.Tensor) else v
                for k, v in payload.items()
            })
        elif kind == "jreg_snap":
            os.makedirs(snap_dir, exist_ok=True)
            ckpt_lib.savez_atomic(os.path.join(snap_dir, f"snap_{sid:05d}.npz"),
                                  j_regressor=payload.cpu().numpy(), shard=sid)
        elif kind == "state":
            # The state first, then the marker, then the older states: the
            # marker always names a whole file.
            path = ckpt_lib.save_train_state(ckpt_dir, payload, payload.step)
            name = os.path.basename(path)
            ckpt_lib.write_json_atomic(marker, {"state": name, "shard": sid})
            for old in os.listdir(ckpt_dir):
                if _STATE_FILE.fullmatch(old) and old != name:
                    os.remove(os.path.join(ckpt_dir, old))
        else:  # "acc_ckpt"
            host = [x.cpu().numpy() for x in payload]
            ckpt_lib.savez_atomic(acc_path, gram=host[0], rhs=host[1], count=host[2], upto=sid)

    # Rank 0's writer; the other processes write nothing.
    writer = _OrderedWriter(write) if lead else None

    def put(item):
        if writer is not None:
            writer.put(item)

    def maybe_ckpt_acc(shard_id, acc):
        if shard_id % ACC_CKPT_EVERY == ACC_CKPT_EVERY - 1:
            # Ordered after this shard's manifest entry and train state: a
            # resume never counts a shard twice.
            put(("acc_ckpt", shard_id, acc))

    def stage(batch):
        rows = None if mesh is None else mesh_lib.local_rows(mesh, len(batch["gt_j3d"]))
        local = _local_rows(batch, rows)
        init = (_stored_init(local, dev) if spin_fn is None
                else _to_device(local["spin_image"], dev))
        return batch, rows, init, _frame_batch(local, cfg, dev)

    staged = _prefetch_iter(map(stage, batches), cfg.data.prefetch)
    try:
        for shard_id, (loader_wait, (batch, rows, init, data)) in enumerate(_timed(staged)):
            if writer is not None:
                writer.check()
            if resume and (covered is None or shard_id <= covered) and shard_id in done:
                if shard_id > acc_upto:  # else already in the checkpointed accumulator
                    acc = _replay_shard(manifest, shard_id, batch, model, acc, rows, reduce)
                    maybe_ckpt_acc(shard_id, acc)
                continue
            t0 = time.time()
            if spin_fn is not None:
                init = _spin_init(spin_fn, init)
            state, m, result = step_fn(state, model, init, data)
            acc = accumulate(acc, result.vertices, data.gt_j3d, result.joints3d[:, :1])
            refined = {
                "pose6d": result.params.pose6d,
                "orient6d": result.params.orient6d,
                "betas": result.params.betas,
                "cam_t": result.params.cam_t,
                "joints3d": result.joints3d,
            }
            if mesh is not None:
                refined = mesh_lib.gather_rows(mesh, refined)
            # Frame identity for the resume-time pairing check.
            put(("shard", shard_id, dict(refined, gt_j3d=np.asarray(batch["gt_j3d"]))))
            snap_every = cfg.jreg.snapshot_interval
            if snap_every and shard_id % snap_every == snap_every - 1:
                put(("jreg_snap", shard_id, state.j_reg_raw))
            put(("state", shard_id, state))
            maybe_ckpt_acc(shard_id, acc)
            if logger is not None and lead:
                # One copy for every metric (waits for the step).
                values = torch.stack([v.to(torch.float64) for v in m]).cpu().tolist()
                rec = outer_metrics_record(type(m)(*values))
                rec["shard"] = shard_id
                rec["batch_seconds"] = time.time() - t0
                rec["loader_wait_s"] = loader_wait
                logger.log(rec, step=state.step)
    finally:
        staged.close()
        if writer is not None:
            writer.close()
    if writer is not None:
        writer.check()
    # The writer saved the state of every shard that ran; a run that ran
    # none (all resumed, or no data) saves the state it ends with, as
    # jrr_tpu does.
    if lead and not os.path.exists(os.path.join(ckpt_dir, f"state_{state.step:08d}.npz")):
        ckpt_lib.save_train_state(ckpt_dir, state, state.step)
    if mesh is not None:
        mesh_lib.barrier(mesh)  # rank 0's files are whole before any process goes on
    return state, acc, manifest


def _restore_train_state(ckpt_dir: str, marker: str, template):
    """(state, covered) to resume from: the state in `ckpt_dir` that
    `marker` names and the last shard it includes; else the newest
    state_*.npz, a state saved at the end of a run (by jrr_tpu, or by the
    port before mid-run checkpoints), which includes every completed shard
    (covered None); else `template` and -1."""
    if os.path.exists(marker):
        with open(marker) as f:
            info = json.load(f)
        return ckpt_lib.restore_train_state(os.path.join(ckpt_dir, info["state"]), template), int(
            info["shard"])
    existing = sorted(n for n in os.listdir(ckpt_dir) if _STATE_FILE.fullmatch(n)) if (
        os.path.isdir(ckpt_dir)) else []
    if existing:
        return ckpt_lib.restore_train_state(os.path.join(ckpt_dir, existing[-1]), template), None
    return template, -1


def _replay_shard(manifest, shard_id: int, batch, model, acc, rows=None, reduce=None):
    """Add a completed shard to the accumulator from its saved refined
    parameters, after checking that the shard pairs with this run's batch.
    `rows`: this process's rows of the shard (the others replay theirs;
    `reduce` sums the statistics over the processes)."""
    saved = manifest.read_shard(shard_id)
    # Shards pair with batches by position: a resume under another
    # shuffle/seed/batch size would cross-pair refined vertices with the
    # wrong frames' GT. The shard stores its gt_j3d; a mismatch (shape
    # first, then values) is an error.
    if "gt_j3d" not in saved:
        print(
            f"WARNING: shard {shard_id} predates the gt_j3d identity field — "
            "resume-time batch/shard pairing cannot be validated; ensure the data "
            "order (seed/batch-size/split) is unchanged, or clear the output dir."
        )
    elif (
        saved["gt_j3d"].shape != np.asarray(batch["gt_j3d"]).shape
        or not np.allclose(saved["gt_j3d"], batch["gt_j3d"], atol=1e-5)
    ):
        raise ValueError(
            f"shard {shard_id}: saved gt_j3d does not match this run's batch — "
            "the data order changed since the manifest was written (different "
            "seed/batch-size/split/epochs?). Clear the output dir or restore the "
            "original config."
        )
    dev = model.v_template.device
    rows = slice(None) if rows is None else rows
    t = lambda k: torch.as_tensor(saved[k][rows], device=dev)  # noqa: E731
    params = losses.FrameParams(*(t(k) for k in losses.FrameParams._fields))
    return trainer.jreg_lstsq_accumulate(
        acc, replay_vertices(model, params),
        torch.as_tensor(np.asarray(batch["gt_j3d"])[rows], device=dev), t("joints3d")[:, :1],
        reduce=reduce,
    )


def make_spin_fn(checkpoint_path: str, mean_params_path: Optional[str] = None, device="cuda"):
    """A SPIN torch checkpoint → the initializer fn: ImageNet-normalized
    (B, 3, 224, 224) crops → (pose6d (B, 24, 6), betas (B, 10), cam (B, 3)).

    The reference builds hmr, loads `model_checkpoint.pt` and runs it per
    batch (reference: scripts/optimize.py:90-94,164-168). Any torch file
    whose ['model'] (or root) is hmr's state dict loads, with or without
    DataParallel `module.` prefixes; `mean_params_path` is SPIN's
    smpl_mean_params.npz. A drifted key layout raises
    `CheckpointLayoutError` with a diff report.

    The network runs in inference mode with float32 products (TF32 off in
    cuBLAS and cuDNN, the caller's flags restored after); its outputs are
    returned as ordinary tensors, so refinement can take gradients from
    them."""
    if checkpoint_path.endswith((".npz", ".npy")):
        raise ValueError("pass the torch SPIN checkpoint (.pt); it loads by name")
    model = spin_lib.load_spin_checkpoint(checkpoint_path, mean_params_path, device=device)

    def spin_fn(image: torch.Tensor):
        with torch.inference_mode(), precision.float32_products():
            out = model(image)
        return tuple(x.clone() for x in out)

    return spin_fn


def load_regressor_file(path: str) -> np.ndarray:
    """(17, V) regressor from .npy / .npz (key j_regressor) / torch .pt."""
    if path.endswith(".npy"):
        return np.load(path).astype(np.float32)
    if path.endswith(".npz"):
        with np.load(path) as f:
            key = "j_regressor" if "j_regressor" in f else f.files[0]
            return f[key].astype(np.float32)
    return torch.load(path, map_location="cpu", weights_only=True).numpy().astype(np.float32)


def _demo_regressor(num_verts: int, rng: np.random.Generator) -> np.ndarray:
    """The demo's true regressor: 6 random vertices per joint."""
    j_reg = np.zeros((constants.NUM_EVAL_JOINTS, num_verts), np.float32)
    for j in range(constants.NUM_EVAL_JOINTS):
        j_reg[j, rng.choice(num_verts, 6, replace=False)] = rng.uniform(0.5, 1.0, 6)
    return j_reg


def demo_regressors(num_verts: int, seed: int):
    """(true, initial): the demo's true regressor, which generates its
    fixtures, and the perturbed copy training starts from, so that the
    before/after comparison has real error to recover."""
    rng = np.random.default_rng(seed)
    j_true = _demo_regressor(num_verts, rng)
    j_initial = j_true + np.abs(
        rng.normal(scale=0.15, size=j_true.shape)
    ).astype(np.float32) * (j_true == 0) * (
        rng.uniform(size=j_true.shape) < 0.05
    ) + rng.normal(scale=0.08, size=j_true.shape).astype(np.float32) * (j_true > 0)
    return j_true, j_initial


def run_pipeline(
    cfg: PipelineConfig,
    data_root: Optional[str] = None,
    out_dir: str = "output",
    demo: bool = False,
    logger=None,
    jreg_init_path: Optional[str] = None,
    spin_checkpoint: Optional[str] = None,
    spin_mean_params: Optional[str] = None,
    loader: str = "auto",
    vibe_checkpoint: Optional[str] = None,
    meva_checkpoint: Optional[str] = None,
    consumer_seqlen: int = 16,
    model=None,
    demo_frames: Optional[int] = None,
    device="cuda",
) -> PipelineArtifacts:
    """Full flow: [SPIN init →] optimize → regressor fit → protocol-2 eval
    [→ VIBE/MEVA consumer evals], on `device` (the card unless "cpu" is
    asked for; `model`, when given, sets it).

    `demo=True` writes synthetic fixtures under out_dir/fixtures (unless
    `data_root` already holds a split) and trains from a perturbed copy of
    the regressor that generated them; `model` overrides the demo's
    256-vertex body and `demo_frames` the fixture count (2 batches by
    default). Outside the demo the initial regressor is mandatory: an
    explicit `jreg_init_path` or J_regressor_h36m.{npy,npz} under the data
    root. `loader`: "python" (H36MDataset + BatchLoader), "native" (the
    runtime's pack loader, `PackedH36MDataset`, which builds frames.jrrpack
    if it is missing) or "auto" (native when the split has a frames.jrrpack).

    `spin_checkpoint` (+ `spin_mean_params`) initializes every batch from
    SPIN on its crop (reference: scripts/optimize.py:164-182), and the eval
    scores SPIN's predictions, instead of the stored estimates.
    `vibe_checkpoint` / `meva_checkpoint` score the initial and retrained
    regressors through those video models after retraining (reference:
    main.py:26-27 → scripts/test.py:141-301): frame by frame, and over
    `consumer_seqlen`-frame sequences in the dataset's temporal order.

    Under `torch.distributed` every process calls this with the same
    arguments and its own device (cuda:LOCAL_RANK): rank 0 writes the demo
    fixtures and builds a missing pack while the others wait, every process
    optimizes its rows of each batch (`run_optimize`), and rank 0 alone
    fits, evaluates and prints; the others return artifacts with no fit and
    no evals."""
    if loader not in ("auto", "python", "native"):
        raise ValueError(f"unknown loader {loader!r} (auto, python or native)")
    dev = model.v_template.device if model is not None else resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)
    mesh = _run_mesh(cfg, dev)
    lead = mesh is None or mesh.is_lead

    def lead_first(make):
        """`make()` on rank 0 before the other processes run it (it writes
        what they then find)."""
        if mesh is None:
            return make()
        out = make() if lead else None
        mesh_lib.barrier(mesh)
        return out if lead else make()

    if demo:
        data_root = data_root or os.path.join(out_dir, "fixtures")

    seconds: Dict[str, float] = {}
    if demo:
        if model is None:
            model = smpl_lib.synthetic_smpl_model(
                seed=cfg.seed, num_verts=256, num_faces=500, device=dev
            )
        j_true, j_reg_initial = demo_regressors(model.num_verts, cfg.seed)
        t0 = time.perf_counter()

        def write_fixtures():
            if not os.path.exists(os.path.join(data_root, "precomputed_val")):
                fixtures.write_fixture_dataset(
                    data_root, num_frames=demo_frames or cfg.data.batch_size * 2,
                    seed=cfg.seed, model=model, j_reg_raw=j_true,
                )

        lead_first(write_fixtures)
        seconds["fixtures"] = time.perf_counter() - t0
    else:
        # Training starts from SPIN's original J_regressor_h36m.npy
        # (reference: scripts/optimize.py:105-107), never from a retrained one.
        if jreg_init_path is None and data_root:
            for name in ("J_regressor_h36m.npy", "J_regressor_h36m.npz"):
                if os.path.exists(os.path.join(data_root, name)):
                    jreg_init_path = os.path.join(data_root, name)
                    break
        if jreg_init_path is None:
            raise ValueError(
                "no --jreg-init given and no J_regressor_h36m.{npy,npz} found "
                "under the data root; training must start from the original "
                "regressor (reference: scripts/optimize.py:105-107), not the "
                "shipped retrained artifact"
            )
        j_reg_initial = load_regressor_file(jreg_init_path)
        if model is None:
            model = smpl_lib.resolve_smpl_model(device=dev)

    spin_fn = None
    if spin_checkpoint is not None:
        spin_fn = make_spin_fn(spin_checkpoint, spin_mean_params, device=dev)

    # The host input pipeline: the runtime's pack loader (no Python per
    # frame; its calls release the interpreter lock), or the python loader.
    sub = "precomputed_train" if cfg.data.split == "train" else "precomputed_val"
    pack_path = os.path.join(data_root or "", sub, "frames.jrrpack")
    if loader == "native" or (loader == "auto" and os.path.exists(pack_path)):
        packed = lead_first(lambda: native_pipeline.PackedH36MDataset(data_root, cfg.data.split))
        index_source, source = packed, "pack2" if packed.prewarped else "pack"

        def epoch_batches(for_eval: bool = False):
            """All train epochs back to back, reshuffled per epoch."""
            for epoch in range(1 if for_eval else max(1, cfg.data.train_epochs)):
                yield from packed.batches(cfg.data.batch_size, seed=cfg.data.shuffle_seed,
                                          epoch=epoch, drop_last=True)
    else:
        dataset = h36m.H36MDataset(data_root, cfg.data.split)
        index_source, source = dataset, "python"
        batch_loader = h36m.BatchLoader(
            dataset, cfg.data.batch_size, seed=cfg.data.shuffle_seed,
            drop_last=True, prefetch=cfg.data.prefetch,
        )

        def epoch_batches(for_eval: bool = False):
            """All train epochs back to back, reshuffled per epoch."""
            for epoch in range(1 if for_eval else max(1, cfg.data.train_epochs)):
                batch_loader.set_epoch(epoch)
                yield from iter(batch_loader)

    t0 = time.perf_counter()
    state, acc, _ = run_optimize(
        cfg, model, j_reg_initial, epoch_batches(), out_dir, logger=logger, spin_fn=spin_fn
    )
    seconds["optimize"] = time.perf_counter() - t0
    j_reg_final = state.j_reg_raw.cpu().numpy()
    if not lead:  # rank 0 fits and evaluates; wait for it
        mesh_lib.barrier(mesh)
        return PipelineArtifacts(
            j_reg_initial=j_reg_initial, j_reg_final=j_reg_final, j_reg_lstsq=None,
            eval_before_after=None, out_dir=out_dir, seconds=seconds, loader=source,
            accumulator=acc,
        )
    t0 = time.perf_counter()
    j_reg_lstsq = trainer.jreg_lstsq_solve(acc, cfg.jreg.lstsq_ridge).cpu().numpy()
    seconds["fit"] = time.perf_counter() - t0
    np.savez(
        os.path.join(out_dir, "retrained_j_regressor.npz"),
        j_regressor=j_reg_final, j_regressor_lstsq=j_reg_lstsq,
    )

    # Protocol-2 eval: the initializer's predictions (SPIN on the crops, or
    # the stored ones) through the initial, Adam-path and lstsq regressors,
    # one pass over the split.
    def predictions():
        for batch in epoch_batches(for_eval=True):
            if spin_fn is not None:
                pose6d, betas, _ = spin_fn(
                    spin_lib.normalize_image(_to_device(batch["spin_image"], dev)))
            else:
                pose6d = np.concatenate(
                    [batch["orient"].reshape(-1, 1, 6), batch["pose"]], axis=1)
                betas = batch["betas"]
            yield {"pose6d": pose6d, "betas": betas, "gt_j3d": batch["gt_j3d"]}

    t0 = time.perf_counter()
    res_init, res_final, res_lstsq = harness.evaluate_regressors(
        model, predictions(), [j_reg_initial, j_reg_final, j_reg_lstsq]
    )
    seconds["eval"] = time.perf_counter() - t0
    before_after = harness.BeforeAfter(before=res_init, after=res_final)
    print(before_after.summary())
    print(f"\nafter (lstsq fit)\nMPJPE\n{res_lstsq.mpjpe:.4f}\nPAMPJPE\n{res_lstsq.pa_mpjpe:.4f}")

    # Consumer evals (reference: main.py:26-27 → scripts/test.py:141-301):
    # the retrained regressor plugged into the VIBE/MEVA video models.
    def norm_batch(batch):
        return dict(batch, spin_image=spin_lib.normalize_image(
            _to_device(batch["spin_image"], dev)))

    # Both models are built first, then scored together: one loader pass
    # for the frame-level evals and one for the sequence evals (jrr_tpu
    # makes two passes per model).
    consumer_evals: Dict[str, harness.BeforeAfter] = {}
    paths = {kind: path for kind, path in (("vibe", vibe_checkpoint), ("meva", meva_checkpoint))
             if path is not None}
    if paths:
        t0 = time.perf_counter()
        backbone = (None if spin_checkpoint is None
                    else consumers._spin_backbone_variables(spin_checkpoint))
        built = {}
        for kind, path in paths.items():
            built[kind] = consumers.build_consumer(kind, path, model, backbone=backbone,
                                                   seqlen=consumer_seqlen)
            print(f"\n[{kind.upper()}] checkpoint layout: {built[kind][2]}")
        frame_evals = harness.evaluate_consumer(
            {kind: b[0] for kind, b in built.items()},
            map(norm_batch, epoch_batches(for_eval=True)), j_reg_initial, j_reg_final, device=dev,
        )
        seconds["consumer_frame"] = time.perf_counter() - t0
        order = index_source.frame_order()
        seq_evals = {}
        if order is not None:
            t0 = time.perf_counter()
            seq_batches = h36m.background_iter(h36m.ordered_sequence_batches(
                index_source.load_batch, order, cfg.data.batch_size, consumer_seqlen),
                cfg.data.prefetch)
            seq_evals = harness.evaluate_consumer_sequences(
                {kind: b[1] for kind, b in built.items()}, map(norm_batch, seq_batches),
                j_reg_initial, j_reg_final, seqlen=consumer_seqlen, device=dev,
            )
            seconds["consumer_sequence"] = time.perf_counter() - t0
        for kind in paths:
            print(f"\n{kind.upper()}\n{frame_evals[kind].summary()}")
            consumer_evals[kind] = frame_evals[kind]
            if order is None:
                print(
                    f"{kind.upper()}: no temporal order available in the dataset "
                    "(no seq_id/frame_id tensors and no image paths) — sequence "
                    "eval skipped; frame-level consumer eval above is complete."
                )
                continue
            print(f"\n{kind.upper()} (sequence)\n{seq_evals[kind].summary()}")
            consumer_evals[f"{kind} (sequence)"] = seq_evals[kind]

    if mesh is not None:
        mesh_lib.barrier(mesh)
    return PipelineArtifacts(
        j_reg_initial=j_reg_initial,
        j_reg_final=j_reg_final,
        j_reg_lstsq=j_reg_lstsq,
        eval_before_after=before_after,
        out_dir=out_dir,
        eval_lstsq=res_lstsq,
        seconds=seconds,
        consumer_evals=consumer_evals,
        loader=source,
        accumulator=acc,
    )
