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
m̂ = m/(1−b1^t), v̂ = v/(1−b2^t), b1 0.9, b2 0.999, eps 1e-8 after the sqrt.
"""

from __future__ import annotations

import dataclasses
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
from jrr_tpu_torch.utils import precision


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
    """optax.adam(lr) on a list of tensors, updated in place."""

    def __init__(self, params: List[torch.Tensor], lr: float, b1=0.9, b2=0.999, eps=1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]
        self.count = 0

    @torch.no_grad()
    def step(self, params: List[torch.Tensor], grads: List[torch.Tensor]) -> None:
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


def _leaves(params: FrameParams) -> List[torch.Tensor]:
    return [x.detach().clone().requires_grad_(True) for x in params]


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
    keep only ~3 decimal digits), and the caller's flags are restored after.

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

    j_reg_norm = jreg_lib.normalize_jreg(j_reg_raw, jreg_mask)

    # ---- Stage A: camera-only 2D alignment -------------------------------
    with torch.no_grad():
        joints3d_fixed = losses.joints_from_verts(
            j_reg_norm, losses.forward_frame(model, init).vertices
        )
    cam_t = init.cam_t.detach().clone().requires_grad_(True)
    opt_a = _Adam([cam_t], cfg.stage_a_lr)
    loss_a = []
    for _ in range(cfg.stage_a_steps):
        pred2d = losses.reproject_joints(joints3d_fixed, cam_t, cfg)
        loss = torch.mean(losses.j2d_loss(pred2d, data.gt_j2d))
        if batch_share != 1.0:
            loss = loss * batch_share
        (g,) = torch.autograd.grad(loss, [cam_t])
        opt_a.step([cam_t], [g])
        loss_a.append(loss.detach())
    params = init._replace(cam_t=cam_t.detach())

    # ---- Stage B: full five-term refinement ------------------------------
    leaves = _leaves(params)
    opt_b = _Adam(leaves, cfg.stage_b_lr)
    stride = max(1, sil.step_stride)
    warm_stride = sil.fine_warm_stride
    if warm_stride is not None and sil.fine_warm_frac > 0.0:
        if warm_stride < 1:
            raise ValueError(
                f"fine_warm_stride={warm_stride} must be >= 1 when "
                f"fine_warm_frac={sil.fine_warm_frac} > 0"
            )
        if not 0.0 <= sil.fine_warm_frac <= 1.0:
            raise ValueError(f"fine_warm_frac={sil.fine_warm_frac} must lie in [0, 1]")
        warm_steps = int(sil.fine_warm_frac * cfg.stage_b_steps)
    else:
        warm_steps = 0
    hand_feet = list(constants.HAND_FEET_ROT_INDICES)

    def step_b(step_idx: int, bins) -> LossTerms:
        if warm_steps > 0:
            stride_here = warm_stride if step_idx < warm_steps else stride
            sil_active, sil_scale = step_idx % stride_here == 0, float(stride_here)
        else:
            sil_active = None if stride == 1 else step_idx % stride == 0
            sil_scale = None
        p = FrameParams(*leaves)
        total, terms = losses.stage_b_loss(
            model, j_reg_norm, pose_disc, shape_disc, p, data, cfg,
            bins=bins, sil_active=sil_active, sil_scale=sil_scale,
        )
        if batch_share != 1.0:
            terms = LossTerms(*(t * batch_share for t in terms))
            total = terms.total
        grads = list(torch.autograd.grad(total, leaves))
        if freeze_hand_feet:
            grads[0] = grads[0].clone()
            grads[0][:, hand_feet, :] = 0.0
        opt_b.step(leaves, grads)
        return LossTerms(*(t.detach() for t in terms))

    # Rebin amortization: the candidate lists from a chunk's start stay
    # covering for `inner` steps thanks to the bin margin.
    inner = sil.rebin_interval if cfg.use_silhouette else 1
    inner = max(1, min(inner, cfg.stage_b_steps))
    while cfg.stage_b_steps % inner != 0:
        inner -= 1
    use_bins = cfg.use_silhouette and data.mask is not None and inner > 1
    spec = losses.rasterizer_spec(cfg)
    # interior_skip exists on the fused amortized-bins path only. None = auto
    # (on exactly there), True = require (raises elsewhere), False = off.
    skip_path = use_bins and losses.resolve_silhouette_backend(spec) == "fused"
    interior_skip = skip_path if sil.interior_skip is None else sil.interior_skip
    if (
        interior_skip and cfg.use_silhouette and data.mask is not None
        and cfg.stage_b_steps > 0 and not skip_path
    ):
        raise ValueError(
            "interior_skip=True requires the fused silhouette backend and rebin "
            f"amortization (rebin_interval > 1); got backend={sil.backend!r}, "
            f"rebin_interval={sil.rebin_interval}"
        )

    terms_b: List[LossTerms] = []
    chunk_stats: List[sf.BinStats] = []
    if use_bins:
        for chunk in range(cfg.stage_b_steps // inner):
            with torch.no_grad():
                p_now = FrameParams(*(x.detach() for x in leaves))
                verts_now = losses.forward_frame(model, p_now).vertices
                if skip_path:
                    bins = sf.compute_fused_bins(verts_now, model, p_now.cam_t, spec)
                    if interior_skip:
                        bins = sf.apply_interior_skip(bins, verts_now, model, p_now.cam_t, spec)
                    if sil.lane_pack:
                        # After the skip, so pairs form on the tiles left occupied.
                        bins = sf.pack_bins(bins, model.num_verts)
                    chunk_stats.append(bins.stats)
                else:  # round-1 bins carry no capacity counters (jrr_tpu :302-306)
                    bins = sil_lib.compute_bins(verts_now, model.faces, p_now.cam_t, spec)
            for s in range(inner):
                terms_b.append(step_b(chunk * inner + s, bins))
    else:
        for s in range(cfg.stage_b_steps):
            terms_b.append(step_b(s, None))

    params = FrameParams(*(x.detach() for x in leaves))
    with torch.no_grad():
        out = losses.forward_frame(model, params)
        joints3d = losses.joints_from_verts(j_reg_norm, out.vertices)
    empty = joints3d.new_zeros((0,))
    return RefineResult(
        params=params,
        stage_a_loss=torch.stack(loss_a) if loss_a else empty,
        stage_b_terms=(
            LossTerms(*(torch.stack(col) for col in zip(*terms_b)))
            if terms_b else LossTerms(*([empty] * 6))
        ),
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


def _refine_coarse_to_fine(
    model, j_reg_raw, init, data, cfg, coarse_steps, pose_disc, shape_disc,
    jreg_mask, freeze_hand_feet, batch_share,
) -> RefineResult:
    """Stage B's first `coarse_steps` at image_size/coarse_factor (tile and
    bin margin divided alike, mask mean-pooled, focal auto-scaled), the rest
    at full resolution; Adam is fresh per phase."""
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
