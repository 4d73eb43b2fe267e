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
"""

from __future__ import annotations

import contextlib
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
    Without it the count is a Python int (the trainer's optimizers, whose
    counts the train-state files hold)."""

    def __init__(self, params: List[torch.Tensor], lr: float, b1=0.9, b2=0.999, eps=1e-8,
                 device_count: bool = False):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]
        self.count = (torch.zeros((), dtype=torch.float64, device=params[0].device)
                      if device_count else 0)

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
    """Run `refine_batch`'s steps eagerly on the card too: the counterpart
    of `jax.disable_jit()`, for holding a captured run against an eager one.
    Nests; applies to the calling thread; inert on the CPU, which always
    runs eagerly."""
    _graphs_off.depth += 1
    try:
        yield
    finally:
        _graphs_off.depth -= 1


class _Steps:
    """Runs each kind of step: on CUDA tensors its first step runs eagerly
    (on a side stream, as a real step of the refinement) and is then
    captured into a CUDA graph, which every later step of that kind
    replays; on the CPU, or under `disable_graphs()`, every step runs
    eagerly. The graphs live as long as this object, one `refine_batch`
    call (the first graph of a device is kept, never replayed, to hold
    the memory pool all graphs share: `profiling._graph_pool`). A failed
    capture raises."""

    def __init__(self, device: torch.device):
        self.capture = device.type == "cuda" and _graphs_off.depth == 0
        self.graphs = {}

    def __call__(self, kind, fn, *args) -> None:
        if not self.capture:
            fn(*args)
        elif kind in self.graphs:
            self.graphs[kind].replay()
        else:
            self.graphs[kind] = profiling.capture(fn, *args)


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


class Refinement:
    """One single-resolution `refine_batch` call: its state and its step
    closures.

    Every tensor a step reads or writes is allocated before the loop: the
    leaves, the Adam moments and device-side counts, `joints3d_fixed`,
    `j_reg_norm`, the batch, the bins (copied into after each rebin), the
    loss buffers and their device-side step indices. So a step is a
    closure over static buffers, which a CUDA graph can replay:
    `stage_a_step(cam_t)` and, per kind of stage-B step (`stage_b_kind`),
    `stage_b_step(kind)(*leaves)`. `run()` drives them through `_Steps`."""

    def __init__(self, model, j_reg_raw, init: FrameParams, data: FrameBatch, cfg: RefinerConfig,
                 pose_disc=None, shape_disc=None, jreg_mask: Optional[torch.Tensor] = None,
                 freeze_hand_feet: bool = False, batch_share: float = 1.0):
        self.model, self.data, self.cfg = model, data, cfg
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
        self.j_reg_norm = jreg_lib.normalize_jreg(j_reg_raw, jreg_mask)
        with torch.no_grad():
            self.joints3d_fixed = losses.joints_from_verts(
                self.j_reg_norm, losses.forward_frame(model, init).vertices
            )
        self.init = init
        self.cam_t = init.cam_t.detach().clone().requires_grad_(True)
        self.opt_a = _Adam([self.cam_t], cfg.stage_a_lr, device_count=True)
        self.loss_a = init.cam_t.new_zeros((cfg.stage_a_steps,))
        self.pos_a = torch.arange(cfg.stage_a_steps, device=dev)
        self.index_a = torch.zeros((), dtype=torch.int64, device=dev)
        # Stage B starts from stage A's camera: its leaves are made after it.
        self.leaves: List[torch.Tensor] = []
        self.opt_b: Optional[_Adam] = None
        self.terms_b = init.cam_t.new_zeros((len(LossTerms._fields), cfg.stage_b_steps))
        self.pos_b = torch.arange(cfg.stage_b_steps, device=dev)
        self.index_b = torch.zeros((), dtype=torch.int64, device=dev)
        self.hand_feet = torch.tensor(constants.HAND_FEET_ROT_INDICES, device=dev)
        self.bins = None  # the static bins the stage-B steps read
        self.chunk_stats: List[sf.BinStats] = []

    def stage_a_step(self, cam_t: torch.Tensor) -> None:
        """One camera-only Adam step on the 2D reprojection loss."""
        pred2d = losses.reproject_joints(self.joints3d_fixed, cam_t, self.cfg)
        loss = torch.mean(losses.j2d_loss(pred2d, self.data.gt_j2d))
        if self.batch_share != 1.0:
            loss = loss * self.batch_share
        (g,) = torch.autograd.grad(loss, [cam_t])
        self.opt_a.step([cam_t], [g])
        _record(self.loss_a, self.pos_a, self.index_a, loss.detach())

    def start_stage_b(self) -> None:
        """Stage B's leaves (from stage A's camera) and fresh Adam state."""
        params = self.init._replace(cam_t=self.cam_t.detach())
        self.leaves = [x.detach().clone().requires_grad_(True) for x in params]
        self.opt_b = _Adam(self.leaves, self.cfg.stage_b_lr, device_count=True)

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
        """Bin at the current leaves (eagerly) and copy the bins into the
        static ones the steps read (the first rebin's bins become them)."""
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
            self.chunk_stats.append(bins.stats)
        else:  # round-1 bins carry no capacity counters (jrr_tpu :302-306)
            bins = sil_lib.compute_bins(verts_now, model.faces, p_now.cam_t, spec)
        if self.bins is None:
            self.bins = bins
        else:
            _copy_bins(self.bins, bins)

    def run(self) -> RefineResult:
        cfg = self.cfg
        steps = _Steps(self.cam_t.device)
        for _ in range(cfg.stage_a_steps):
            steps("a", self.stage_a_step, self.cam_t)
        self.start_stage_b()
        closures = {}
        for s in range(cfg.stage_b_steps):
            if self.use_bins and s % self.inner == 0:
                self.rebin()
            kind = self.stage_b_kind(s)
            if kind not in closures:
                closures[kind] = self.stage_b_step(kind)
            steps(("b",) + kind, closures[kind], *self.leaves)

        params = FrameParams(*(x.detach() for x in self.leaves))
        with torch.no_grad():
            out = losses.forward_frame(self.model, params)
            joints3d = losses.joints_from_verts(self.j_reg_norm, out.vertices)
        chunk_stats = self.chunk_stats
        return RefineResult(
            params=params,
            stage_a_loss=self.loss_a,
            stage_b_terms=LossTerms(*self.terms_b.unbind(0)),
            joints3d=joints3d,
            vertices=out.vertices,
            # Worst chunk is the representative per-batch figure.
            bin_stats=(
                sf.BinStats(*(torch.stack(col).amax() for col in zip(*chunk_stats)))
                if chunk_stats else None
            ),
            chunk_stats=sf.BinStats(*(torch.stack(col) for col in zip(*chunk_stats)))
            if chunk_stats else None,
        )


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
    """
    sil = cfg.silhouette
    coarse_steps = int(sil.coarse_frac * cfg.stage_b_steps)
    if (
        cfg.use_silhouette
        and data.mask is not None
        and sil.coarse_frac > 0.0
        and coarse_steps > 0
        # Quality floor: below coarse_min_image coarse supervision hurts.
        and sil.image_size // sil.coarse_factor >= sil.coarse_min_image
    ):
        return _refine_coarse_to_fine(
            model, j_reg_raw, init, data, cfg, coarse_steps, pose_disc, shape_disc,
            jreg_mask, freeze_hand_feet, batch_share,
        )
    return Refinement(model, j_reg_raw, init, data, cfg, pose_disc, shape_disc, jreg_mask,
                      freeze_hand_feet, batch_share).run()


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


def _refine_coarse_to_fine(
    model, j_reg_raw, init, data, cfg, coarse_steps, pose_disc, shape_disc,
    jreg_mask, freeze_hand_feet, batch_share,
) -> RefineResult:
    """Stage B's first `coarse_steps` at image_size/coarse_factor (tile and
    bin margin divided alike, mask mean-pooled, focal auto-scaled), the rest
    at full resolution; Adam is fresh per phase. Each phase is its own
    single-resolution call with its own graphs (their shapes differ)."""
    factor = cfg.silhouette.coarse_factor
    cfg_coarse, cfg_fine = coarse_to_fine_configs(cfg, coarse_steps)
    res1 = refine_batch(
        model, j_reg_raw, init, data._replace(mask=_pool_mask(data.mask, factor)),
        cfg_coarse, pose_disc, shape_disc, jreg_mask, freeze_hand_feet, batch_share,
    )
    res2 = refine_batch(
        model, j_reg_raw, res1.params, data, cfg_fine, pose_disc, shape_disc,
        jreg_mask, freeze_hand_feet, batch_share,
    )
    terms = LossTerms(*(
        torch.cat([a, b]) for a, b in zip(res1.stage_b_terms, res2.stage_b_terms)
    ))
    if res1.bin_stats is None or res2.bin_stats is None:
        stats = res1.bin_stats if res2.bin_stats is None else res2.bin_stats
    else:
        stats = sf.BinStats(*(torch.maximum(a, b) for a, b in zip(res1.bin_stats, res2.bin_stats)))
    chunks = [r.chunk_stats for r in (res1, res2) if r.chunk_stats is not None]
    chunks = sf.BinStats(*(torch.cat(col) for col in zip(*chunks))) if chunks else None
    return res2._replace(stage_a_loss=res1.stage_a_loss, stage_b_terms=terms, bin_stats=stats,
                         chunk_stats=chunks)


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
