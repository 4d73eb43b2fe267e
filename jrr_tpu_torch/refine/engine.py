"""The two-stage refinement engine (counterpart of jrr_tpu/refine/engine.py:64-337).

Per batch (reference scripts/optimize.py:187-265): (1) `stage_a_steps` Adam
steps on the camera translation against the 2D reprojection loss, with the
SMPL forward hoisted out of the loop (the loss depends on the camera only);
(2) `stage_b_steps` Adam steps on (pose, orient, betas, cam) against the
five-term loss, with fresh Adam state per stage and per coarse-to-fine phase.

Stage B rebins every `rebin_interval` steps (candidate lists with
`bin_margin_px` of slack: fused bins, or round-1 `BinState`s under
`silhouette.backend="pallas"` or "xla", which then render alike through
the round-1 tile path; "xla" with `rebin_interval=1` renders every step
through the XLA tile loop, as jrr_tpu :238-300 does), marks α-saturated tiles kernel-empty
(interior skip, fused path only) and, with `lane_pack`, packs the bins
(fused path only), strides the silhouette term (a Python `if` replaces `lax.cond`) and,
with `coarse_frac > 0`, runs its first steps at image_size/coarse_factor.

Adam is written by hand with optax's formula, elementwise:
m ← b1·m + (1−b1)·g, v ← b2·v + (1−b2)·g², p ← p − lr · m̂ / (√v̂ + eps),
m̂ = m/(1−b1^t), v̂ = v/(1−b2^t), b1 0.9, b2 0.999, eps 1e-8 after the sqrt;
the engine keeps t and the bias corrections on the device (float64, as the
Python numbers were, rounded to the params' type for the division).

jrr_tpu compiles a batch's whole refinement into one XLA program
(jrr_tpu :9-13). The port's counterpart (`Refinement`): each kind of step
is a closure over tensors allocated before the loop, writing its loss
terms into preallocated buffers at a device-side step index. The kinds are
the stage-A step and the stage-B step per silhouette variant (active,
inactive, and with `fine_warm_frac > 0` the warm stride's scale). On CUDA
tensors each kind's first step runs eagerly and is captured into a CUDA
graph that its later steps replay; the rebins stay eager and copy their
bins into the static bins the graphs read. Every route captures: the fused,
lane-packed, round-1 and "xla" bins, and the per-step binning of
`rebin_interval=1` (the tile loop's checkpointed chunks included). On the
CPU, and on the card under `disable_graphs()` (the counterpart of
`jax.disable_jit()`), the same closures run eagerly, bit for bit the
captured run.

`refine_batch` is jrr_tpu's un-jitted call: each call builds its own
`refiner`, whose graphs live for the call. `compile_refine` is the
counterpart of `jax.jit(refine_batch)`: a program that keeps one refiner
per input shape and replays its graphs from call to call, bit for bit
`refine_batch`'s result.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import threading
from typing import List, NamedTuple, Optional

import torch

from jrr_tpu_torch import constants
from jrr_tpu_torch.config import RefinerConfig
from jrr_tpu_torch.ops import jreg as jreg_lib
from jrr_tpu_torch.refine import losses
from jrr_tpu_torch.refine.losses import FrameBatch, FrameParams, LossTerms
from jrr_tpu_torch.render import camera as camera_lib
from jrr_tpu_torch.render import silhouette as sil_lib
from jrr_tpu_torch.render import silhouette_fused as sf
from jrr_tpu_torch.utils import precision, profiling


class RefineResult(NamedTuple):
    params: FrameParams
    stage_a_loss: torch.Tensor  # (stage_a_steps,)
    stage_b_terms: LossTerms  # each (stage_b_steps,)
    joints3d: torch.Tensor  # (B, 17, 3) final regressed joints (meters)
    vertices: torch.Tensor  # (B, V, 3) final vertices
    # Rasterizer capacity counters, worst rebin chunk (None without fused bins).
    bin_stats: Optional[sf.BinStats] = None
    # The same counters per rebin chunk, each field (chunks,): what a
    # data-parallel step reduces over its processes before taking the worst.
    chunk_stats: Optional[sf.BinStats] = None


class _Adam:
    """optax.adam(lr) on a list of tensors, updated in place.

    With `device_count` the step count is a 0-dim float64 tensor on the
    params' device, and the bias corrections 1 − b^count are computed from
    it there in float64 and rounded to the params' type, as the Python int
    count gives them: a captured step then replays with the count it has
    reached, and on the CPU the steps are the int count's bit for bit.
    Without it the count is a Python int (the legacy staged fit)."""

    def __init__(self, params: List[torch.Tensor], lr: float, b1=0.9, b2=0.999, eps=1e-8,
                 device_count: bool = False):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]
        self.count = (torch.zeros((), dtype=torch.float64, device=params[0].device)
                      if device_count else 0)

    def set_count(self, n: int) -> None:
        """Set the step count to `n`, on the device when it lives there."""
        if torch.is_tensor(self.count):
            self.count = torch.full((), float(n), dtype=torch.float64, device=self.count.device)
        else:
            self.count = int(n)

    @torch.no_grad()
    def reset(self) -> None:
        """Fresh moments and count, in place (a captured call starts a stage so)."""
        for t in self.m + self.v:
            t.zero_()
        if torch.is_tensor(self.count):
            self.count.zero_()
        else:
            self.count = 0

    @torch.no_grad()
    def load(self, other: "_Adam") -> None:
        """Copy `other`'s moments and count into this optimizer's tensors."""
        torch._foreach_copy_(self.m + self.v, other.m + other.v)
        if torch.is_tensor(other.count):
            self.count.copy_(other.count)
        else:
            self.count.fill_(float(other.count))

    @torch.no_grad()
    def step(self, params: List[torch.Tensor], grads: List[torch.Tensor]) -> None:
        if torch.is_tensor(self.count):
            self.count.add_(1.0)
            bc1 = (1.0 - torch.pow(self.b1, self.count)).to(params[0].dtype)
            bc2 = (1.0 - torch.pow(self.b2, self.count)).to(params[0].dtype)
        else:
            self.count += 1
            bc1 = 1.0 - self.b1**self.count
            bc2 = 1.0 - self.b2**self.count
        for p, g, m, v in zip(params, grads, self.m, self.v):
            m.mul_(self.b1).add_((1.0 - self.b1) * g)
            v.mul_(self.b2).add_((1.0 - self.b2) * (g * g))
            p.add_(-self.lr * ((m / bc1) / (torch.sqrt(v / bc2) + self.eps)))


def _pool_mask(mask: torch.Tensor, factor: int) -> torch.Tensor:
    """(B, S, S) → (B, S/f, S/f) mean pooling."""
    b, s, _ = mask.shape
    t = s // factor
    return mask.reshape(b, t, factor, t, factor).mean(dim=(2, 4))


class _GraphsOff(threading.local):
    depth = 0


_graphs_off = _GraphsOff()


@contextlib.contextmanager
def disable_graphs():
    """Run `refine_batch`'s steps, the refine program and the outer-step
    program eagerly on the card too: the counterpart of
    `jax.disable_jit()`, for holding a captured run against an eager one.
    Nests; applies to the calling thread and to what is built inside it (a
    program's entries run as they were built); inert on the CPU, which
    always runs eagerly."""
    _graphs_off.depth += 1
    try:
        yield
    finally:
        _graphs_off.depth -= 1


def _kind_name(kind) -> str:
    return kind if isinstance(kind, str) else "_".join(map(str, kind))


class _Steps:
    """Runs each kind of closure: on CUDA tensors its first call runs
    eagerly (on a side stream, as a real call) and is then captured into a
    CUDA graph, which every later call of that kind replays; on the CPU, or
    when built under `disable_graphs()`, every call runs eagerly. The
    graphs live as long as this object (the first graph of a device is
    kept, never replayed, to hold the memory pool all graphs share:
    `profiling._graph_pool`). A failed capture raises.

    With `times` (a dict) each graph's `log_compile_time` split is recorded
    there once, under `prefix` + its kind: `lower_s` and `compile_s` at
    its capture, `first_run_s` at its first replay."""

    def __init__(self, device: torch.device, times=None, prefix: str = ""):
        self.device = device
        self.capture = device.type == "cuda" and _graphs_off.depth == 0
        self.graphs = {}
        self.times, self.prefix = times, prefix

    def __call__(self, kind, fn, *args) -> None:
        if not self.capture:
            fn(*args)
            return
        call = self.graphs.get(kind)
        timing = None if self.times is None else self.times.setdefault(
            self.prefix + _kind_name(kind), {})
        if call is None:
            self.graphs[kind] = profiling.capture(fn, *args, device=self.device, times=timing)
        elif timing is not None and "first_run_s" not in timing:
            profiling.timed_replay(call, self.device, timing)
        else:
            call.replay()


class _Static(dict):
    """Named buffers that captured closures write their results into: the
    first (eager) call keeps a copy of each value, every later call copies
    into it, so a replay writes where the first call's value lies."""

    def put(self, name: str, value: torch.Tensor) -> torch.Tensor:
        if name in self:
            self[name].copy_(value)
        else:
            self[name] = value.detach().clone()
        return self[name]


def _record(buf: torch.Tensor, positions: torch.Tensor, step: torch.Tensor, value) -> None:
    """buf[..., step] = value at the device-side step index `step` (0-dim),
    which then advances: a captured step writes where its replay is."""
    buf.copy_(torch.where(positions == step, value[..., None], buf))
    step.add_(1)


def _copy_bins(static, new):
    """Copy every tensor field of `new` bins into `static` (same layout and
    shapes: bins are static in shape, as under jrr_tpu's scan), except the
    capacity counters, which the steps do not read."""
    for name, dst, src in zip(new._fields, static, new):
        if name == "stats" or src is None:
            continue
        if dst.shape != src.shape or dst.dtype != src.dtype:
            raise RuntimeError(f"bins field {name} changed from {tuple(dst.shape)} {dst.dtype} "
                               f"to {tuple(src.shape)} {src.dtype} between rebins")
        dst.copy_(src)


@torch.no_grad()
def _load_inputs(dst, src) -> None:
    """Copy the tensors of `src` (tensors, NamedTuples of tensors or None,
    modules) into the same structure's tensors in `dst`, in one foreach copy."""
    pairs = []

    def walk(d, s):
        if d is None or s is None or d is s:
            return
        if torch.is_tensor(d):
            pairs.append((d, s))
        elif isinstance(d, torch.nn.Module):
            pairs.extend(zip(d.parameters(), s.parameters()))
        else:
            for a, b in zip(d, s):
                walk(a, b)

    walk(dst, src)
    if pairs:
        torch._foreach_copy_([d for d, _ in pairs], [s.detach() for _, s in pairs])


class Refinement:
    """One single-resolution `refine_batch` call: its state and its step
    closures, reusable from batch to batch of one shape.

    Every tensor a closure reads or writes is allocated before the
    closures run: the static inputs (`j_reg_raw`, `init`, `data` and the
    discriminators, read where they lie; `load` copies a new batch into
    them), the leaves, the Adam moments and device-side counts, the loss
    buffers and their device-side step indices, the bins (copied into at
    each rebin), the rebin chunks' counters and the closures' outputs
    (`_Static`). So every closure can be replayed from a CUDA graph: the
    prologue (`start`: mask pooling, `j_reg_norm`, `joints3d_fixed`, stage
    A's camera and fresh Adam state), `stage_a_step(cam_t)`,
    `start_stage_b`, `rebin`, per kind of stage-B step (`stage_b_kind`)
    `stage_b_step(kind)(*leaves)`, and `finish` (the final forward and the
    worst chunk's counters). `run()` drives them through `_Steps`, whose
    graphs live as long as this object; stage A's steps and stage B's
    (`start_stage_b` and the rebins with them) are the spans
    `refine.stage_a` and `refine.stage_b`, each rebin `refine.rebin`
    (`profiling.span`).

    `mask_factor` > 1 mean-pools `data.mask` by that factor in the
    prologue (the coarse phase of coarse-to-fine)."""

    def __init__(self, model, j_reg_raw, init: FrameParams, data: FrameBatch, cfg: RefinerConfig,
                 pose_disc=None, shape_disc=None, jreg_mask: Optional[torch.Tensor] = None,
                 freeze_hand_feet: bool = False, batch_share: float = 1.0, mask_factor: int = 1,
                 times=None, name: str = ""):
        self.model, self.cfg = model, cfg
        self.pose_disc, self.shape_disc = pose_disc, shape_disc
        self.freeze_hand_feet, self.batch_share = freeze_hand_feet, batch_share
        sil = cfg.silhouette
        self.stride = max(1, sil.step_stride)
        self.warm_stride = sil.fine_warm_stride
        if self.warm_stride is not None and sil.fine_warm_frac > 0.0:
            if self.warm_stride < 1:
                raise ValueError(
                    f"fine_warm_stride={self.warm_stride} must be >= 1 when "
                    f"fine_warm_frac={sil.fine_warm_frac} > 0"
                )
            if not 0.0 <= sil.fine_warm_frac <= 1.0:
                raise ValueError(f"fine_warm_frac={sil.fine_warm_frac} must lie in [0, 1]")
            self.warm_steps = int(sil.fine_warm_frac * cfg.stage_b_steps)
        else:
            self.warm_steps = 0

        # Rebin amortization: the candidate lists from a chunk's start stay
        # covering for `inner` steps thanks to the bin margin.
        inner = sil.rebin_interval if cfg.use_silhouette else 1
        inner = max(1, min(inner, cfg.stage_b_steps))
        while cfg.stage_b_steps % inner != 0:
            inner -= 1
        self.inner = inner
        self.use_bins = cfg.use_silhouette and data.mask is not None and inner > 1
        self.spec = losses.rasterizer_spec(cfg)
        # interior_skip exists on the fused amortized-bins path only. None =
        # auto (on exactly there), True = require (raises elsewhere), False = off.
        self.skip_path = self.use_bins and losses.resolve_silhouette_backend(self.spec) == "fused"
        self.interior_skip = self.skip_path if sil.interior_skip is None else sil.interior_skip
        if (
            self.interior_skip and cfg.use_silhouette and data.mask is not None
            and cfg.stage_b_steps > 0 and not self.skip_path
        ):
            raise ValueError(
                "interior_skip=True requires the fused silhouette backend and rebin "
                f"amortization (rebin_interval > 1); got backend={sil.backend!r}, "
                f"rebin_interval={sil.rebin_interval}"
            )

        dev = init.cam_t.device
        self.j_reg_raw, self.init, self.source = j_reg_raw, init, data
        self.jreg_mask, self.mask_factor = jreg_mask, mask_factor
        # The prologue's outputs (`data` gains the pooled mask there).
        self.out = _Static()
        self.data = data
        self.cam_t = init.cam_t.detach().clone().requires_grad_(True)
        self.opt_a = _Adam([self.cam_t], cfg.stage_a_lr, device_count=True)
        self.loss_a = init.cam_t.new_zeros((cfg.stage_a_steps,))
        self.pos_a = torch.arange(cfg.stage_a_steps, device=dev)
        self.index_a = torch.zeros((), dtype=torch.int64, device=dev)
        # Stage B starts from stage A's camera (`start_stage_b` copies it in).
        self.leaves = [x.detach().clone().requires_grad_(True) for x in init]
        self.opt_b = _Adam(self.leaves, cfg.stage_b_lr, device_count=True)
        self.terms_b = init.cam_t.new_zeros((len(LossTerms._fields), cfg.stage_b_steps))
        self.pos_b = torch.arange(cfg.stage_b_steps, device=dev)
        self.index_b = torch.zeros((), dtype=torch.int64, device=dev)
        self.hand_feet = torch.tensor(constants.HAND_FEET_ROT_INDICES, device=dev)
        self.bins = None  # the static bins the stage-B steps read
        # The fused rebins' capacity counters, one column per chunk.
        chunks = cfg.stage_b_steps // inner if self.skip_path else 0
        self.chunk_buf = (torch.zeros((len(sf.BinStats._fields), chunks), dtype=torch.int64,
                                      device=dev) if chunks else None)
        self.pos_c = torch.arange(chunks, device=dev)
        self.index_c = torch.zeros((), dtype=torch.int64, device=dev)
        # No attribute may refer back to this object (a closure over it, a
        # bound method): a reference cycle would leave its graphs to the
        # garbage collector, which may destroy them during a later capture.
        self.steps = _Steps(dev, times, name)

    @torch.no_grad()
    def load(self, j_reg_raw, init: FrameParams, data: FrameBatch, pose_disc=None,
             shape_disc=None) -> None:
        """Copy a new batch (and regressor, and discriminator weights) into
        the static inputs; the prologue of the next `run` starts from them."""
        _load_inputs((self.j_reg_raw, self.init, self.source, self.pose_disc, self.shape_disc),
                     (j_reg_raw, init, data, pose_disc, shape_disc))

    @torch.no_grad()
    def start(self) -> None:
        """The prologue: pooled mask, normalized regressor, stage A's fixed
        joints; stage A's camera and Adam state and every device-side index
        reset."""
        if self.mask_factor > 1:
            pooled = _pool_mask(self.source.mask, self.mask_factor)
            self.data = self.source._replace(mask=self.out.put("mask", pooled))
        j_reg_norm = jreg_lib.normalize_jreg(self.j_reg_raw, self.jreg_mask)
        self.j_reg_norm = self.out.put("j_reg_norm", j_reg_norm)
        self.joints3d_fixed = self.out.put("joints3d_fixed", losses.joints_from_verts(
            self.j_reg_norm, losses.forward_frame(self.model, self.init).vertices))
        self.cam_t.copy_(self.init.cam_t)
        self.opt_a.reset()
        for index in (self.index_a, self.index_b, self.index_c):
            index.zero_()

    def stage_a_step(self, cam_t: torch.Tensor) -> None:
        """One camera-only Adam step on the 2D reprojection loss."""
        pred2d = losses.reproject_joints(self.joints3d_fixed, cam_t, self.cfg)
        loss = torch.mean(losses.j2d_loss(pred2d, self.data.gt_j2d))
        if self.batch_share != 1.0:
            loss = loss * self.batch_share
        (g,) = torch.autograd.grad(loss, [cam_t])
        self.opt_a.step([cam_t], [g])
        _record(self.loss_a, self.pos_a, self.index_a, loss.detach())

    @torch.no_grad()
    def start_stage_b(self) -> None:
        """Stage B's leaves (from stage A's camera) and fresh Adam state."""
        for leaf, x in zip(self.leaves, self.init._replace(cam_t=self.cam_t)):
            leaf.copy_(x)
        self.opt_b.reset()

    def stage_b_kind(self, step_idx: int):
        """(sil_active, sil_scale) of stage-B step `step_idx`: the variants
        the silhouette striding produces, each its own step closure."""
        if self.warm_steps > 0:
            stride_here = self.warm_stride if step_idx < self.warm_steps else self.stride
            return step_idx % stride_here == 0, float(stride_here)
        return (None if self.stride == 1 else step_idx % self.stride == 0), None

    def stage_b_step(self, kind):
        """The stage-B step of one kind: fn(*leaves), an Adam step on the
        five-term loss through the static bins."""
        sil_active, sil_scale = kind

        def step(*leaves):
            p = FrameParams(*leaves)
            total, terms = losses.stage_b_loss(
                self.model, self.j_reg_norm, self.pose_disc, self.shape_disc, p, self.data,
                self.cfg, bins=self.bins, sil_active=sil_active, sil_scale=sil_scale,
            )
            if self.batch_share != 1.0:
                terms = LossTerms(*(t * self.batch_share for t in terms))
                total = terms.total
            grads = list(torch.autograd.grad(total, leaves))
            if self.freeze_hand_feet:
                grads[0] = grads[0].index_fill(1, self.hand_feet, 0.0)
            self.opt_b.step(list(leaves), grads)
            _record(self.terms_b, self.pos_b, self.index_b, torch.stack(terms).detach())

        return step

    @torch.no_grad()
    def rebin(self) -> None:
        """Bin at the current leaves and copy the bins into the static ones
        the steps read (the first call's bins become them); the fused bins'
        counters go into the chunk's column."""
        model, spec = self.model, self.spec
        p_now = FrameParams(*(x.detach() for x in self.leaves))
        verts_now = losses.forward_frame(model, p_now).vertices
        if self.skip_path:
            bins = sf.compute_fused_bins(verts_now, model, p_now.cam_t, spec)
            if self.interior_skip:
                bins = sf.apply_interior_skip(bins, verts_now, model, p_now.cam_t, spec)
            if self.cfg.silhouette.lane_pack:
                # After the skip, so pairs form on the tiles left occupied.
                bins = sf.pack_bins(bins, model.num_verts)
            _record(self.chunk_buf, self.pos_c, self.index_c, torch.stack(tuple(bins.stats)))
        else:  # round-1 bins carry no capacity counters (jrr_tpu :302-306)
            bins = sil_lib.compute_bins(verts_now, model.faces, p_now.cam_t, spec)
        if self.bins is None:
            self.bins = bins
        else:
            _copy_bins(self.bins, bins)

    @torch.no_grad()
    def finish(self) -> None:
        """The final vertices and joints, and the worst chunk's counters."""
        params = FrameParams(*(x.detach() for x in self.leaves))
        vertices = self.out.put("vertices", losses.forward_frame(self.model, params).vertices)
        self.out.put("joints3d", losses.joints_from_verts(self.j_reg_norm, vertices))
        if self.chunk_buf is not None:
            # Worst chunk is the representative per-batch figure.
            self.out.put("bin_stats", self.chunk_buf.amax(dim=1))

    def run(self) -> RefineResult:
        """One call; the result's tensors are this object's buffers, which
        the next `run` overwrites."""
        cfg, steps = self.cfg, self.steps
        steps("start", self.start)
        with profiling.span("refine.stage_a"):
            for _ in range(cfg.stage_a_steps):
                steps("a", self.stage_a_step, self.cam_t)
        with profiling.span("refine.stage_b"):
            steps("start_b", self.start_stage_b)
            closures = {}
            for s in range(cfg.stage_b_steps):
                if self.use_bins and s % self.inner == 0:
                    with profiling.span("refine.rebin"):
                        steps("rebin", self.rebin)
                kind = self.stage_b_kind(s)
                if kind not in closures:
                    closures[kind] = self.stage_b_step(kind)
                steps(("b",) + kind, closures[kind], *self.leaves)
        steps("finish", self.finish)
        return self.result()

    def result(self) -> RefineResult:
        stats = self.chunk_buf is not None
        return RefineResult(
            params=FrameParams(*(x.detach() for x in self.leaves)),
            stage_a_loss=self.loss_a,
            stage_b_terms=LossTerms(*self.terms_b.unbind(0)),
            joints3d=self.out["joints3d"],
            vertices=self.out["vertices"],
            bin_stats=sf.BinStats(*self.out["bin_stats"].unbind(0)) if stats else None,
            chunk_stats=sf.BinStats(*self.chunk_buf.unbind(0)) if stats else None,
        )


class CoarseToFine:
    """Stage B's first `coarse_steps` at image_size/coarse_factor (tile and
    bin margin divided alike, mask mean-pooled, focal auto-scaled), the rest
    at full resolution; Adam is fresh per phase. Each phase is its own
    `Refinement` with its own graphs (their shapes differ); the fine phase
    reads the coarse phase's leaves as its start, and a captured `merge`
    joins the two phases' curves and counters. `load` and `run` as
    `Refinement`'s; the phases are the spans `refine.coarse` and
    `refine.fine`."""

    def __init__(self, model, j_reg_raw, init, data, cfg, coarse_steps, pose_disc=None,
                 shape_disc=None, jreg_mask=None, freeze_hand_feet=False, batch_share=1.0,
                 times=None):
        cfg_coarse, cfg_fine = coarse_to_fine_configs(cfg, coarse_steps)
        shared = dict(pose_disc=pose_disc, shape_disc=shape_disc, jreg_mask=jreg_mask,
                      freeze_hand_feet=freeze_hand_feet, batch_share=batch_share, times=times)
        self.coarse = Refinement(model, j_reg_raw, init, data, cfg_coarse,
                                 mask_factor=cfg.silhouette.coarse_factor, name="coarse_", **shared)
        start = FrameParams(*(x.detach() for x in self.coarse.leaves))
        self.fine = Refinement(model, j_reg_raw, start, data, cfg_fine, name="fine_", **shared)
        self.out = _Static()
        self.steps = _Steps(init.cam_t.device, times)

    def load(self, *args, **kwargs) -> None:
        self.coarse.load(*args, **kwargs)  # the fine phase reads the same inputs

    @torch.no_grad()
    def merge(self) -> None:
        res1, res2 = self.coarse.result(), self.fine.result()
        self.out.put("terms", torch.cat([self.coarse.terms_b, self.fine.terms_b], dim=1))
        if res1.bin_stats is not None and res2.bin_stats is not None:
            self.out.put("bin_stats", torch.maximum(self.coarse.out["bin_stats"],
                                                    self.fine.out["bin_stats"]))
        chunks = [r.chunk_buf for r in (self.coarse, self.fine) if r.chunk_buf is not None]
        if chunks:
            self.out.put("chunks", torch.cat(chunks, dim=1))

    def run(self) -> RefineResult:
        with profiling.span("refine.coarse"):
            res1 = self.coarse.run()
        with profiling.span("refine.fine"):
            res2 = self.fine.run()
        self.steps("merge", self.merge)
        if "bin_stats" in self.out:
            stats = sf.BinStats(*self.out["bin_stats"].unbind(0))
        else:
            stats = res1.bin_stats if res2.bin_stats is None else res2.bin_stats
        chunks = self.out.get("chunks")
        return res2._replace(
            stage_a_loss=res1.stage_a_loss, stage_b_terms=LossTerms(*self.out["terms"].unbind(0)),
            bin_stats=stats, chunk_stats=None if chunks is None else sf.BinStats(*chunks.unbind(0)),
        )


def refiner(model, j_reg_raw, init: FrameParams, data: FrameBatch, cfg: RefinerConfig,
            pose_disc=None, shape_disc=None, jreg_mask: Optional[torch.Tensor] = None,
            freeze_hand_feet: bool = False, batch_share: float = 1.0, times=None):
    """The `Refinement` (or `CoarseToFine`) that runs `refine_batch`'s call,
    reading the given tensors and discriminators as its static inputs."""
    sil = cfg.silhouette
    coarse_steps = int(sil.coarse_frac * cfg.stage_b_steps)
    shared = dict(pose_disc=pose_disc, shape_disc=shape_disc, jreg_mask=jreg_mask,
                  freeze_hand_feet=freeze_hand_feet, batch_share=batch_share, times=times)
    if (
        cfg.use_silhouette
        and data.mask is not None
        and sil.coarse_frac > 0.0
        and coarse_steps > 0
        # Quality floor: below coarse_min_image coarse supervision hurts.
        and sil.image_size // sil.coarse_factor >= sil.coarse_min_image
    ):
        return CoarseToFine(model, j_reg_raw, init, data, cfg, coarse_steps, **shared)
    return Refinement(model, j_reg_raw, init, data, cfg, **shared)


@precision.float32_products()
def refine_batch(
    model,
    j_reg_raw: torch.Tensor,
    init: FrameParams,
    data: FrameBatch,
    cfg: RefinerConfig,
    pose_disc=None,
    shape_disc=None,
    jreg_mask: Optional[torch.Tensor] = None,
    freeze_hand_feet: bool = False,
    batch_share: float = 1.0,
) -> RefineResult:
    """Run stage A + stage B on a batch of frames.

    Float32 products stay float32 on the card: TF32 is off for matmuls and
    cuDNN while this runs (the SMPL and regressor products would otherwise
    keep only ~3 decimal digits, and the graphs are captured with it off),
    and the caller's flags are restored after.

    `batch_share`: this batch's frames over the global batch's, when the
    batch is one process's rows of a data-parallel batch. Each loss (a mean
    over the frames here) is scaled by it, so each frame's gradient is the
    one the global batch's mean gives, and the returned loss curves are
    this process's parts of the global means (their sum over the
    processes). At 1.0 nothing is scaled.

    Each call builds its own `refiner`, whose graphs live for the call; the
    refine program (`compile_refine`) and the outer-step program
    (`trainer.compile_outer_step`) keep one from call to call.
    """
    return refiner(model, j_reg_raw, init, data, cfg, pose_disc, shape_disc, jreg_mask,
                   freeze_hand_feet, batch_share).run()


# ---------------------------------------------------------------------------
# The refine program (the counterpart of jax.jit(refine_batch))
# ---------------------------------------------------------------------------


def _fresh(tree):
    """A copy of a tree of NamedTuples and tuples whose tensors are clones
    (None stays)."""
    if tree is None:
        return None
    if torch.is_tensor(tree):
        return tree.detach().clone()
    items = [_fresh(x) for x in tree]
    return type(tree)(*items) if hasattr(tree, "_fields") else type(tree)(items)


def _shape_key(*trees):
    """What a jit would retrace on: each tensor's shape, dtype and device
    (None for an absent one), and the TF32 flags the products are captured
    under."""
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    leaves = []
    for tree in trees:
        for x in tree:
            leaves.append(None if x is None else (tuple(x.shape), x.dtype, x.device))
    return tuple(leaves) + flags


class _RefineSpec(NamedTuple):
    """What a refine program is compiled for: `refine_batch`'s static
    arguments."""

    cfg: RefinerConfig
    jreg_mask: Optional[torch.Tensor]
    freeze_hand_feet: bool
    batch_share: float


class _RefineEntry:
    """The refine program for one key: its own copies of the regressor,
    the batch and the discriminators, and one `refiner` built over them.
    A call copies the caller's tensors in (`load`), runs the refiner (on
    the card its first call captures, later calls replay) and returns the
    refiner's buffers (`run`), or clones of them, which no later call
    overwrites (`__call__`). The refiner's run is the span `refine`."""

    def __init__(self, spec: _RefineSpec, model, j_reg_raw, init, data, pose_disc, shape_disc,
                 times=None):
        # No reference to the program: an entry that referred back to it
        # would hold its graphs in a reference cycle.
        self.j_reg = j_reg_raw.detach().clone()
        self.init, self.data = _fresh(init), _fresh(data)
        self.pose_disc, self.shape_disc = copy.deepcopy(pose_disc), copy.deepcopy(shape_disc)
        self.refiner = refiner(model, self.j_reg, self.init, self.data, spec.cfg, self.pose_disc,
                               self.shape_disc, spec.jreg_mask, spec.freeze_hand_feet,
                               spec.batch_share, times)

    def refine(self) -> RefineResult:
        """The refiner's run on the inputs copied in last."""
        with precision.float32_products(), profiling.span("refine"):
            return self.refiner.run()

    def run(self, j_reg_raw, init, data, pose_disc, shape_disc) -> RefineResult:
        self.refiner.load(j_reg_raw, init, data, pose_disc, shape_disc)
        return self.refine()

    def __call__(self, j_reg_raw, init, data, pose_disc, shape_disc) -> RefineResult:
        return _fresh(self.run(j_reg_raw, init, data, pose_disc, shape_disc))


class RefineProgram:
    """`refine_batch` compiled for its static arguments: fn(model,
    j_reg_raw, init, data, pose_disc=None, shape_disc=None) → RefineResult,
    equal to `refine_batch(model, j_reg_raw, init, data, cfg, pose_disc,
    shape_disc, jreg_mask, freeze_hand_feet, batch_share)` bit for bit and,
    like a jitted function, functional: the caller's tensors are read,
    never written, the discriminators' weights are read at each call, and
    nothing returned is a buffer a later call overwrites. Each key (the
    model, each input's shape, dtype and device, which discriminators are
    given, the TF32 flags) gets its own `_RefineEntry`; on CUDA tensors it
    captures its graphs at its first call and replays them at every later
    one. On the CPU, or for an entry built under `disable_graphs()`, the
    same closures run eagerly. Dropping the program frees its graphs."""

    def __init__(self, cfg: RefinerConfig, jreg_mask: Optional[torch.Tensor] = None,
                 freeze_hand_feet: bool = False, batch_share: float = 1.0):
        self.spec = _RefineSpec(cfg, jreg_mask, freeze_hand_feet, batch_share)
        self.entries = {}

    def __call__(self, model, j_reg_raw: torch.Tensor, init: FrameParams, data: FrameBatch,
                 pose_disc=None, shape_disc=None) -> RefineResult:
        key = ((id(model), pose_disc is not None, shape_disc is not None)
               + _shape_key((j_reg_raw,), init, data))
        entry = self.entries.get(key)
        if entry is None:
            entry = self.entries[key] = _RefineEntry(self.spec, model, j_reg_raw, init, data,
                                                     pose_disc, shape_disc)
        return entry(j_reg_raw, init, data, pose_disc, shape_disc)


def compile_refine(cfg: RefinerConfig, jreg_mask: Optional[torch.Tensor] = None,
                   freeze_hand_feet: bool = False, batch_share: float = 1.0) -> RefineProgram:
    """The counterpart of `jax.jit(lambda mdl, jr, i, d, pd, sd:
    refine_batch(mdl, jr, i, d, cfg, pd, sd))` (bench.py:67-92,
    tools/c2f_probe.py:117-147): a program that standalone callers build
    once and call again and again."""
    return RefineProgram(cfg, jreg_mask, freeze_hand_feet, batch_share)


def coarse_to_fine_configs(cfg: RefinerConfig, coarse_steps: int):
    """(cfg_coarse, cfg_fine) of the two phases of a coarse-to-fine stage
    B: the first `coarse_steps` steps at image_size/coarse_factor (tile and
    bin margin divided alike, coarse stride, no warm striding), then the
    rest at full resolution with no stage A."""
    sil = cfg.silhouette
    if not 0.0 < sil.coarse_frac < 1.0:
        raise ValueError(f"coarse_frac={sil.coarse_frac} must lie in [0, 1)")
    factor = sil.coarse_factor
    if factor < 2 or sil.image_size % factor or sil.tile_size % factor:
        raise ValueError(
            f"coarse_factor={factor} must be >= 2 and divide both "
            f"image_size={sil.image_size} and tile_size={sil.tile_size}"
        )
    cfg_coarse = dataclasses.replace(
        cfg,
        stage_b_steps=coarse_steps,
        silhouette=dataclasses.replace(
            sil, coarse_frac=0.0, image_size=sil.image_size // factor,
            tile_size=sil.tile_size // factor, bin_margin_px=sil.bin_margin_px / factor,
            step_stride=sil.step_stride if sil.coarse_step_stride is None else sil.coarse_step_stride,
            # Warm striding is a fine-phase feature.
            fine_warm_frac=0.0, fine_warm_stride=None,
        ),
    )
    cfg_fine = dataclasses.replace(
        cfg, stage_a_steps=0, stage_b_steps=cfg.stage_b_steps - coarse_steps,
        silhouette=dataclasses.replace(sil, coarse_frac=0.0),
    )
    return cfg_coarse, cfg_fine


def spin_prediction_to_params(
    spin_pose6d: torch.Tensor, spin_betas: torch.Tensor, spin_camera: torch.Tensor,
    image_size: int = constants.CROP_RES,
) -> FrameParams:
    """SPIN network outputs → initial refinement state
    (reference: scripts/optimize.py:170-182)."""
    return FrameParams(
        pose6d=spin_pose6d[:, 1:],
        orient6d=spin_pose6d[:, :1],
        betas=spin_betas,
        cam_t=camera_lib.weak_perspective_to_translation(spin_camera, image_size),
    )
