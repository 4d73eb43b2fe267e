"""Outer training step: refinement + discriminator updates + J-regressor
step, and the closed-form regressor fit (counterpart of
jrr_tpu/refine/trainer.py; reference scripts/optimize.py:148-337).

Per batch, `outer_step`:
1. refines the batch (stage A + stage B) from its SPIN initialization with
   the state's regressor and discriminators held fixed;
2. takes one LSGAN Adam step on each discriminator, SPIN parameters as
   "real" and the refined ones as "fake" (optimize.py:276-293);
3. takes one Adam step on the raw regressor against the pelvis-centred GT
   joints, through mask → ReLU → row-norm, on the detached refined vertices
   (optimize.py:300-312, the intended working update);
4. evaluates MPJPE/PA-MPJPE before and after the regressor step.

The three optimizers are the engine's optax-formula `_Adam`. `outer_step`
leaves its input state as it was and returns a new one (copies of the
discriminators and optimizer moments, updated in place).

With a distributed `mesh` (parallel/mesh.py) the batch is this process's
rows of the global batch: every mean is scaled by the rows' share of the
global batch, the three gradients are summed over the processes in one
all-reduce before the Adam steps, and the metrics, loss curves and
rasterizer counters are reduced once at the end (one sum, one maximum),
so every process leaves with the same state and jrr_tpu's global metrics.

`jreg_lstsq_accumulate`/`jreg_lstsq_solve` fit the regressor in closed form
from summed normal-equation statistics, projected onto the per-joint
simplex that `normalize_jreg` deploys.
"""

from __future__ import annotations

import copy
from typing import NamedTuple, Optional

import torch

from jrr_tpu_torch.config import PipelineConfig
from jrr_tpu_torch.evals import metrics as metrics_lib
from jrr_tpu_torch.models import discriminator as disc_lib
from jrr_tpu_torch.ops import jreg as jreg_lib
from jrr_tpu_torch.parallel import mesh as mesh_lib
from jrr_tpu_torch.refine import engine, losses
from jrr_tpu_torch.refine.losses import FrameBatch, FrameParams
from jrr_tpu_torch.render import silhouette_fused as sf


class TrainState(NamedTuple):
    j_reg_raw: torch.Tensor  # (17, V) trainable raw regressor
    jreg_opt: engine._Adam
    pose_disc: disc_lib.PoseDiscriminator
    pose_disc_opt: engine._Adam  # moments in `pose_disc.parameters()` order
    shape_disc: disc_lib.ShapeDiscriminator
    shape_disc_opt: engine._Adam
    step: int


class OuterMetrics(NamedTuple):
    joint_loss: torch.Tensor
    pose_disc_gen_loss: torch.Tensor
    shape_disc_gen_loss: torch.Tensor
    pose_discriminator_loss: torch.Tensor
    shape_discriminator_loss: torch.Tensor
    j_regressor_error: torch.Tensor
    mpjpe_before_jreg_step: torch.Tensor
    pampjpe_before_jreg_step: torch.Tensor
    mpjpe_after_jreg_step: torch.Tensor
    pampjpe_after_jreg_step: torch.Tensor
    mpjpe_init: torch.Tensor  # MPJPE of the SPIN initialization (for context)
    # Rasterizer capacity counters (worst rebin chunk of the fused path; 0 on
    # the round-1 path, whose bins carry none).
    rasterizer_dropped: torch.Tensor
    rasterizer_max_faces_per_tile: torch.Tensor
    rasterizer_interior_skipped: torch.Tensor


def init_train_state(j_reg_init: torch.Tensor, cfg: PipelineConfig, seed: int = 0) -> TrainState:
    """Fresh optimizers and discriminators (seeds `seed`, `seed + 1`) on
    the device of `j_reg_init`."""
    dev = j_reg_init.device
    pose_disc = disc_lib.PoseDiscriminator(seed=seed, device=dev)
    shape_disc = disc_lib.ShapeDiscriminator(seed=seed + 1, device=dev)
    j_reg = j_reg_init.detach().clone()
    return TrainState(
        j_reg_raw=j_reg,
        jreg_opt=engine._Adam([j_reg], cfg.jreg.lr),
        pose_disc=pose_disc,
        pose_disc_opt=engine._Adam(list(pose_disc.parameters()), cfg.discriminator.lr),
        shape_disc=shape_disc,
        shape_disc_opt=engine._Adam(list(shape_disc.parameters()), cfg.discriminator.lr),
        step=0,
    )


def jreg_supervision_loss(j_reg_raw, vertices, gt_j3d_mm, jreg_mask=None) -> torch.Tensor:
    """MSE(move_pelvis(J(raw) · verts), gt/1000) (reference: scripts/optimize.py:306-309)."""
    joints = jreg_lib.apply_jreg(jreg_lib.normalize_jreg(j_reg_raw, jreg_mask), vertices)
    gt = jreg_lib.move_pelvis(gt_j3d_mm) / 1000.0
    return torch.mean((jreg_lib.move_pelvis(joints) - gt) ** 2)


def _disc_grads(disc, real_in, fake_in, share):
    """The LSGAN loss (scaled by `share`) and its gradients."""
    params = list(disc.parameters())
    loss = disc_lib.discriminator_loss(disc(real_in), disc(fake_in))
    if share != 1.0:
        loss = loss * share
    return loss.detach(), list(torch.autograd.grad(loss, params))


def _disc_step(disc, opt, grads):
    """One Adam step on copies of `disc` and `opt`: (new disc, new opt)."""
    disc, opt = copy.deepcopy(disc), copy.deepcopy(opt)
    opt.step(list(disc.parameters()), grads)
    return disc, opt


_COUNTERS = tuple(f for f in sf.BinStats._fields if f != "max_faces_per_tile")


def sum_means_and_counters(mesh, means, chunk_stats):
    """Batch means and rasterizer counters over every process's frames:
    one sum of the means (scaled shares, through float64) and of the
    counters per rebin chunk (exact in float64), then one maximum of each
    chunk's largest candidate count, and the worst chunk as `refine_batch`
    takes it. Returns (summed means, BinStats or None)."""
    counters = [] if chunk_stats is None else [getattr(chunk_stats, f) for f in _COUNTERS]
    summed = mesh_lib.sum_over_ranks(mesh, [m.double() for m in means] + counters)
    n = len(means)
    means = [total.to(m.dtype) for total, m in zip(summed[:n], means)]
    if chunk_stats is None:
        return means, None
    top = mesh_lib.max_over_ranks(mesh, [chunk_stats.max_faces_per_tile])[0]
    per_chunk = chunk_stats._replace(max_faces_per_tile=top, **dict(zip(_COUNTERS, summed[n:])))
    return means, sf.BinStats(*(col.amax() for col in per_chunk))


def outer_step(
    state: TrainState,
    model,
    spin_init: FrameParams,
    data: FrameBatch,
    cfg: PipelineConfig,
    jreg_mask: Optional[torch.Tensor] = None,
    mesh: Optional[mesh_lib.Mesh] = None,
):
    """One outer iteration on a batch. Returns (state, OuterMetrics, RefineResult).

    With a distributed `mesh`, `spin_init` and `data` are this process's
    rows and the result's params, joints and vertices stay so; the state
    and the metrics are global (module docstring)."""
    distributed = mesh is not None and mesh.distributed
    share = 1.0 / mesh.world_size if distributed else 1.0
    # --- 1. Refinement (the shared state as constants) ----------------------
    result = engine.refine_batch(
        model, state.j_reg_raw.detach(), spin_init, data, cfg.refiner,
        state.pose_disc, state.shape_disc, jreg_mask=jreg_mask, batch_share=share,
    )
    refined = result.params
    verts = result.vertices.detach()

    # --- 2. Discriminator gradients (SPIN = real, refined = fake) -----------
    with torch.enable_grad():
        spin_rot6d = torch.cat([spin_init.orient6d, spin_init.pose6d], dim=1)
        refined_rot6d = torch.cat([refined.orient6d, refined.pose6d], dim=1).detach()
        pd_loss, pd_grads = _disc_grads(state.pose_disc, spin_rot6d, refined_rot6d, share)
        sd_loss, sd_grads = _disc_grads(state.shape_disc, spin_init.betas,
                                        refined.betas.detach(), share)

        # --- 3. J-regressor gradient on the detached refined vertices -------
        j_reg = state.j_reg_raw.detach().clone().requires_grad_(True)
        jr_loss = jreg_supervision_loss(j_reg, verts, data.gt_j3d, jreg_mask)
        if share != 1.0:
            jr_loss = jr_loss * share
        (jr_grad,) = torch.autograd.grad(jr_loss, [j_reg])
    if distributed:
        pd_grads, sd_grads, (jr_grad,) = mesh_lib.sum_over_ranks(
            mesh, [pd_grads, sd_grads, [jr_grad]])
    pose_disc, pose_disc_opt = _disc_step(state.pose_disc, state.pose_disc_opt, pd_grads)
    shape_disc, shape_disc_opt = _disc_step(state.shape_disc, state.shape_disc_opt, sd_grads)
    j_reg = j_reg.detach()
    jreg_opt = copy.deepcopy(state.jreg_opt)
    jreg_opt.step([j_reg], [jr_grad])

    with torch.no_grad():
        def evaluate(j_raw, vertices):
            joints = jreg_lib.apply_jreg(jreg_lib.normalize_jreg(j_raw, jreg_mask), vertices)
            errors = metrics_lib.evaluate(joints, data.gt_j3d)
            if share != 1.0:
                errors = errors._replace(mpjpe=errors.mpjpe * share,
                                         pa_mpjpe=errors.pa_mpjpe * share)
            return errors

        eval_before = evaluate(state.j_reg_raw, verts)
        eval_after = evaluate(j_reg, verts)
        # Context: the SPIN init under the pre-update regressor.
        eval_init = evaluate(state.j_reg_raw, losses.forward_frame(model, spin_init).vertices)

    new_state = TrainState(
        j_reg_raw=j_reg, jreg_opt=jreg_opt,
        pose_disc=pose_disc, pose_disc_opt=pose_disc_opt,
        shape_disc=shape_disc, shape_disc_opt=shape_disc_opt,
        step=state.step + 1,
    )
    # Final stage-B values are the mean of the last fine-stride window: under
    # silhouette striding the trajectory carries a sawtooth at the stride
    # cadence, and the window mean does not depend on the parity of
    # stage_b_steps (reduces to [-1] at stride 1; jrr_tpu :201-213).
    rcfg = cfg.refiner
    terms = result.stage_b_terms
    if rcfg.stage_b_steps > 0:
        tail = max(1, rcfg.silhouette.step_stride) if rcfg.use_silhouette else 1
        tail = min(tail, rcfg.stage_b_steps)
        final = lambda x: torch.mean(x[-tail:])  # noqa: E731
    else:
        final = lambda x: x.new_zeros(())  # noqa: E731
    zero = torch.zeros((), dtype=torch.int64, device=verts.device)
    stats = result.bin_stats
    if distributed:
        # One sum over the processes for every mean, the loss curves and the
        # counters; one maximum.
        means = [pd_loss, sd_loss, jr_loss.detach(), eval_before.mpjpe, eval_before.pa_mpjpe,
                 eval_after.mpjpe, eval_after.pa_mpjpe, eval_init.mpjpe, result.stage_a_loss,
                 *terms]
        means, reduced_stats = sum_means_and_counters(mesh, means, result.chunk_stats)
        pd_loss, sd_loss, jr_loss, mb, pb, ma, pa, mi, stage_a, *summed_terms = means
        terms = type(terms)(*summed_terms)
        eval_before = eval_before._replace(mpjpe=mb, pa_mpjpe=pb)
        eval_after = eval_after._replace(mpjpe=ma, pa_mpjpe=pa)
        eval_init = eval_init._replace(mpjpe=mi)
        result = result._replace(stage_a_loss=stage_a, stage_b_terms=terms)
        if reduced_stats is not None:
            stats = reduced_stats
            result = result._replace(bin_stats=stats)
    metrics = OuterMetrics(
        joint_loss=final(terms.j3d),
        pose_disc_gen_loss=final(terms.pose_disc),
        shape_disc_gen_loss=final(terms.shape_disc),
        pose_discriminator_loss=pd_loss,
        shape_discriminator_loss=sd_loss,
        j_regressor_error=jr_loss.detach(),
        mpjpe_before_jreg_step=eval_before.mpjpe,
        pampjpe_before_jreg_step=eval_before.pa_mpjpe,
        mpjpe_after_jreg_step=eval_after.mpjpe,
        pampjpe_after_jreg_step=eval_after.pa_mpjpe,
        mpjpe_init=eval_init.mpjpe,
        rasterizer_dropped=zero if stats is None else stats.total_dropped(),
        rasterizer_max_faces_per_tile=zero if stats is None else stats.max_faces_per_tile,
        rasterizer_interior_skipped=zero if stats is None else stats.interior_skipped_tiles,
    )
    return new_state, metrics, result


# ---------------------------------------------------------------------------
# Least-squares regressor fit
# ---------------------------------------------------------------------------


class JRegLstsqAccumulator(NamedTuple):
    """Sufficient statistics of the ridge fit min_W Σ_b ‖verts_bᵀ W − Y_b‖²:
    gram (V, V) = Σ_b verts_b verts_bᵀ, rhs (V, 17) = Σ_b verts_b Y_b and the
    frame count. Plain sums: batches (and processes) add them up."""

    gram: torch.Tensor
    rhs: torch.Tensor
    count: torch.Tensor

    @staticmethod
    def zero(num_verts: int, num_joints: int = 17, device="cuda") -> "JRegLstsqAccumulator":
        return JRegLstsqAccumulator(
            gram=torch.zeros(num_verts, num_verts, device=device),
            rhs=torch.zeros(num_verts, num_joints, device=device),
            count=torch.zeros((), device=device),
        )


def jreg_lstsq_accumulate(acc: JRegLstsqAccumulator, vertices, gt_j3d_mm, pelvis_ref, reduce=None):
    """Add a batch: vertices (B, V, 3) refined pseudo-GT, gt_j3d_mm (B, 17, 3),
    pelvis_ref (B, 1, 3) the pelvis in vertex space (meters) from the
    current regressor. The target re-anchors the centred GT there:
    Y = gt_centred + pelvis_ref. `reduce` (a sum over processes, when each
    holds some rows of the batch) is applied to the batch's statistics
    before they are added, so every process holds the global sums."""
    target = jreg_lib.move_pelvis(gt_j3d_mm) / 1000.0 + pelvis_ref
    batch = JRegLstsqAccumulator(
        gram=torch.einsum("bvc,bwc->vw", vertices, vertices),
        rhs=torch.einsum("bvc,bjc->vj", vertices, target),
        count=torch.full((), float(vertices.shape[0]), device=vertices.device),
    )
    if reduce is not None:
        batch = reduce(batch)
    return JRegLstsqAccumulator(
        gram=acc.gram + batch.gram, rhs=acc.rhs + batch.rhs, count=acc.count + batch.count
    )


def _project_columns_to_simplex(w: torch.Tensor) -> torch.Tensor:
    """Euclidean projection of each column of (V, J) onto {x ≥ 0, Σx = 1}
    (sort and threshold, Duchi et al. 2008)."""
    u = torch.sort(w, dim=0, descending=True).values
    css = torch.cumsum(u, dim=0) - 1.0
    idx = torch.arange(1, w.shape[0] + 1, dtype=w.dtype, device=w.device)[:, None]
    rho = torch.sum((u - css / idx) > 0, dim=0)  # ≥ 1
    tau = torch.gather(css, 0, (rho - 1)[None, :]) / rho.to(w.dtype)
    return torch.clamp_min(w - tau, 0.0)


def jreg_lstsq_solve(acc: JRegLstsqAccumulator, ridge: float = 1e-4, nnls_steps: int = 200):
    """Fit the regressor over the deployed class: the per-joint simplex
    {w ≥ 0, Σw = 1} that `normalize_jreg` maps every raw regressor onto
    (jrr_tpu :311-363). The ridge solve gives the unconstrained minimizer,
    the start of projected gradient descent on the normal-equation
    quadratic (step 1/λmax by 20 power iterations). Returns (17, V), rows
    already stochastic.

    The (V, V) Cholesky solve runs in float64 (JAX solves in float32): at
    V = 6890 the Gram matrix has rank ≤ 3·frames and a ridge-sized floor,
    a condition number near float32's 1/eps.
    """
    if float(acc.count) == 0.0:
        raise ValueError(
            "jreg_lstsq_solve called with an empty accumulator (count=0): no "
            "batches were accumulated; a fit would return a zero regressor"
        )
    v = acc.gram.shape[0]
    n = torch.clamp_min(acc.count, 1.0)
    a = acc.gram / n + ridge * torch.eye(v, dtype=acc.gram.dtype, device=acc.gram.device)
    b = acc.rhs / n
    chol = torch.linalg.cholesky(a.double())
    w = torch.cholesky_solve(b.double(), chol).to(a.dtype)  # (V, 17), unconstrained

    z = torch.full((v, 1), 1.0 / v**0.5, dtype=a.dtype, device=a.device)
    for _ in range(20):
        z = a @ z
        z = z / torch.linalg.norm(z)
    step = 1.0 / (torch.sum(z * (a @ z)) + 1e-12)

    w = _project_columns_to_simplex(w)
    for _ in range(nnls_steps):
        w = _project_columns_to_simplex(w - step * (a @ w - b))
    return w.T
