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

The three optimizers are the engine's optax-formula `_Adam`, their step
counts on the device (a captured step replays with the count it has
reached; the train-state files hold jrr_tpu's int32 counts). `outer_step`
leaves its input state as it was and returns a new one (copies of the
discriminators and optimizer moments, updated in place).

`compile_outer_step` is the counterpart of jrr_tpu's
`jax.jit(outer_step)` (jrr_tpu/pipeline.py:204-206): one program per run,
captured as CUDA graphs at its first batch of each shape and replayed for
every later batch, equal to `outer_step` bit for bit; `compile_accumulate`
is `jax.jit(jreg_lstsq_accumulate)`'s (:211).

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
from jrr_tpu_torch.refine.engine import _fresh, _shape_key
from jrr_tpu_torch.refine.losses import FrameBatch, FrameParams
from jrr_tpu_torch.render import silhouette_fused as sf
from jrr_tpu_torch.utils import profiling


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
    """Fresh optimizers (step counts on the device) and discriminators
    (seeds `seed`, `seed + 1`) on the device of `j_reg_init`."""
    dev = j_reg_init.device
    pose_disc = disc_lib.PoseDiscriminator(seed=seed, device=dev)
    shape_disc = disc_lib.ShapeDiscriminator(seed=seed + 1, device=dev)
    j_reg = j_reg_init.detach().clone()
    adam = lambda params, lr: engine._Adam(params, lr, device_count=True)  # noqa: E731
    return TrainState(
        j_reg_raw=j_reg,
        jreg_opt=adam([j_reg], cfg.jreg.lr),
        pose_disc=pose_disc,
        pose_disc_opt=adam(list(pose_disc.parameters()), cfg.discriminator.lr),
        shape_disc=shape_disc,
        shape_disc_opt=adam(list(shape_disc.parameters()), cfg.discriminator.lr),
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


def _outer_grads(disc_pair, spin_init, refined, verts, j_reg, gt_j3d, jreg_mask, share):
    """Steps 2-3: the LSGAN losses and gradients of both discriminators
    (SPIN = real, refined = fake) and the regressor's supervision loss and
    gradient at `j_reg` on the detached refined vertices. Returns
    (pd_loss, pd_grads, sd_loss, sd_grads, jr_loss, jr_grad)."""
    pose_disc, shape_disc = disc_pair
    with torch.enable_grad():
        spin_rot6d = torch.cat([spin_init.orient6d, spin_init.pose6d], dim=1)
        refined_rot6d = torch.cat([refined.orient6d, refined.pose6d], dim=1).detach()
        pd_loss, pd_grads = _disc_grads(pose_disc, spin_rot6d, refined_rot6d, share)
        sd_loss, sd_grads = _disc_grads(shape_disc, spin_init.betas, refined.betas.detach(), share)
        j_reg = j_reg.requires_grad_(True)
        jr_loss = jreg_supervision_loss(j_reg, verts, gt_j3d, jreg_mask)
        if share != 1.0:
            jr_loss = jr_loss * share
        (jr_grad,) = torch.autograd.grad(jr_loss, [j_reg])
    return pd_loss, pd_grads, sd_loss, sd_grads, jr_loss.detach(), jr_grad


@torch.no_grad()
def _init_vertices(model, spin_init):
    """The SPIN initialization's vertices (for `mpjpe_init`)."""
    return losses.forward_frame(model, spin_init).vertices


@torch.no_grad()
def _evaluate(j_raw, vertices, gt_j3d, jreg_mask, share):
    """Step 4: MPJPE / PA-MPJPE of the regressor on the vertices (scaled
    by `share`). Its Procrustes SVD waits for the host on the card."""
    joints = jreg_lib.apply_jreg(jreg_lib.normalize_jreg(j_raw, jreg_mask), vertices)
    errors = metrics_lib.evaluate(joints, gt_j3d)
    if share != 1.0:
        errors = errors._replace(mpjpe=errors.mpjpe * share, pa_mpjpe=errors.pa_mpjpe * share)
    return errors


def _final_values(rcfg, terms, stats, device):
    """The metrics read off the refinement: the final stage-B values of the
    j3d and both discriminator terms, and the three rasterizer counters
    (zeros without counters).

    Final stage-B values are the mean of the last fine-stride window: under
    silhouette striding the trajectory carries a sawtooth at the stride
    cadence, and the window mean does not depend on the parity of
    stage_b_steps (reduces to [-1] at stride 1; jrr_tpu :201-213)."""
    if rcfg.stage_b_steps > 0:
        tail = max(1, rcfg.silhouette.step_stride) if rcfg.use_silhouette else 1
        tail = min(tail, rcfg.stage_b_steps)
        final = lambda x: torch.mean(x[-tail:])  # noqa: E731
    else:
        final = lambda x: x.new_zeros(())  # noqa: E731
    zero = torch.zeros((), dtype=torch.int64, device=device)
    counters = (zero,) * 3 if stats is None else (
        stats.total_dropped(), stats.max_faces_per_tile, stats.interior_skipped_tiles)
    return (final(terms.j3d), final(terms.pose_disc), final(terms.shape_disc)) + counters


def _metrics(final, pd_loss, sd_loss, jr_loss, eval_before, eval_after, eval_init):
    joint, pose_gen, shape_gen, dropped, max_faces, skipped = final
    return OuterMetrics(
        joint_loss=joint,
        pose_disc_gen_loss=pose_gen,
        shape_disc_gen_loss=shape_gen,
        pose_discriminator_loss=pd_loss,
        shape_discriminator_loss=sd_loss,
        j_regressor_error=jr_loss,
        mpjpe_before_jreg_step=eval_before.mpjpe,
        pampjpe_before_jreg_step=eval_before.pa_mpjpe,
        mpjpe_after_jreg_step=eval_after.mpjpe,
        pampjpe_after_jreg_step=eval_after.pa_mpjpe,
        mpjpe_init=eval_init.mpjpe,
        rasterizer_dropped=dropped,
        rasterizer_max_faces_per_tile=max_faces,
        rasterizer_interior_skipped=skipped,
    )


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


def _sum_over_processes(mesh, pd_loss, sd_loss, jr_loss, evals, result):
    """The distributed step's one sum and one maximum of every mean, loss
    curve and counter. Returns (pd_loss, sd_loss, jr_loss, evals, result)
    with global values."""
    eval_before, eval_after, eval_init = evals
    terms = result.stage_b_terms
    means = [pd_loss, sd_loss, jr_loss, eval_before.mpjpe, eval_before.pa_mpjpe,
             eval_after.mpjpe, eval_after.pa_mpjpe, eval_init.mpjpe, result.stage_a_loss, *terms]
    means, reduced_stats = sum_means_and_counters(mesh, means, result.chunk_stats)
    pd_loss, sd_loss, jr_loss, mb, pb, ma, pa, mi, stage_a, *summed_terms = means
    evals = (eval_before._replace(mpjpe=mb, pa_mpjpe=pb),
             eval_after._replace(mpjpe=ma, pa_mpjpe=pa), eval_init._replace(mpjpe=mi))
    result = result._replace(stage_a_loss=stage_a, stage_b_terms=type(terms)(*summed_terms))
    if reduced_stats is not None:
        result = result._replace(bin_stats=reduced_stats)
    return pd_loss, sd_loss, jr_loss, evals, result


def outer_step(
    state: TrainState,
    model,
    spin_init: FrameParams,
    data: FrameBatch,
    cfg: PipelineConfig,
    jreg_mask: Optional[torch.Tensor] = None,
    mesh: Optional[mesh_lib.Mesh] = None,
):
    """One outer iteration on a batch, eagerly. Returns (state,
    OuterMetrics, RefineResult). The reference the outer-step program
    (`compile_outer_step`) is held against.

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
    verts = result.vertices.detach()

    # --- 2-3. Discriminator and J-regressor gradients -----------------------
    j_reg = state.j_reg_raw.detach().clone()
    pd_loss, pd_grads, sd_loss, sd_grads, jr_loss, jr_grad = _outer_grads(
        (state.pose_disc, state.shape_disc), spin_init, result.params, verts, j_reg,
        data.gt_j3d, jreg_mask, share)
    if distributed:
        pd_grads, sd_grads, (jr_grad,) = mesh_lib.sum_over_ranks(
            mesh, [pd_grads, sd_grads, [jr_grad]])
    pose_disc, pose_disc_opt = _disc_step(state.pose_disc, state.pose_disc_opt, pd_grads)
    shape_disc, shape_disc_opt = _disc_step(state.shape_disc, state.shape_disc_opt, sd_grads)
    j_reg = j_reg.detach()
    jreg_opt = copy.deepcopy(state.jreg_opt)
    jreg_opt.step([j_reg], [jr_grad])

    # --- 4. Metrics -----------------------------------------------------------
    evals = (
        _evaluate(state.j_reg_raw, verts, data.gt_j3d, jreg_mask, share),
        _evaluate(j_reg, verts, data.gt_j3d, jreg_mask, share),
        # Context: the SPIN init under the pre-update regressor.
        _evaluate(state.j_reg_raw, _init_vertices(model, spin_init), data.gt_j3d, jreg_mask,
                  share),
    )
    new_state = TrainState(
        j_reg_raw=j_reg, jreg_opt=jreg_opt,
        pose_disc=pose_disc, pose_disc_opt=pose_disc_opt,
        shape_disc=shape_disc, shape_disc_opt=shape_disc_opt,
        step=state.step + 1,
    )
    if distributed:
        # One sum over the processes for every mean, the loss curves and the
        # counters; one maximum.
        pd_loss, sd_loss, jr_loss, evals, result = _sum_over_processes(
            mesh, pd_loss, sd_loss, jr_loss, evals, result)
    final = _final_values(cfg.refiner, result.stage_b_terms, result.bin_stats, verts.device)
    return new_state, _metrics(final, pd_loss, sd_loss, jr_loss, *evals), result


# ---------------------------------------------------------------------------
# The outer-step program (the counterpart of jax.jit(outer_step))
# ---------------------------------------------------------------------------


def _static_opt(opt: engine._Adam) -> engine._Adam:
    """A copy of `opt` whose count lives on the device (a capture replays it)."""
    out = copy.deepcopy(opt)
    if not torch.is_tensor(out.count):
        out.count = torch.full((), float(out.count), dtype=torch.float64, device=out.m[0].device)
    return out


class _OuterEntry(engine._RefineEntry):
    """The program for one batch shape: a refine program's entry (its own
    copies of the regressor, both discriminators and the batch, and the
    refinement, `engine.refiner`, reused), the three Adam states, and the
    outer segments' graphs; the regressor, discriminators and Adam states
    are updated in place.

    A call copies the caller's state and batch in, runs the refinement's
    graphs, then the outer segment: both LSGAN gradients and Adam steps,
    the regressor's gradient and Adam step, the SPIN init's vertices and
    the final-window means and counters, one graph. Under a distributed
    mesh it is three: `grads`, then the gradients' all-reduce (eager),
    `update`, and after the evaluations and the metrics' reduction (eager)
    `finish`. The three evaluations run eagerly between the graphs: their
    Procrustes SVD synchronizes with the host. What it returns is cloned
    out of the buffers.

    A call is the span `outer.step` (`profiling.span`), its phases the
    spans `outer.load` (the copies in), `refine` (the refinement's,
    `engine._RefineEntry.refine`), `outer.segment`, `outer.evaluate` and
    `outer.copy_out` (the state's copies, the result's clones)."""

    def __init__(self, program: "_Spec", times, state: TrainState, model, spin_init, data):
        super().__init__(
            engine._RefineSpec(program.cfg.refiner, program.jreg_mask, False, program.share),
            model, state.j_reg_raw, spin_init, data, state.pose_disc, state.shape_disc, times)
        # The program's settings, not the program: an entry that referred
        # back to it would hold its graphs in a reference cycle.
        self.program, self.model = program, model
        self.jreg_opt = _static_opt(state.jreg_opt)
        self.pose_disc_opt = _static_opt(state.pose_disc_opt)
        self.shape_disc_opt = _static_opt(state.shape_disc_opt)
        self.steps = engine._Steps(state.j_reg_raw.device, times)
        self.out = engine._Static()
        self.fin = engine._Static()

    def grads(self) -> None:
        p, res = self.program, self.result
        pd_loss, pd_grads, sd_loss, sd_grads, jr_loss, jr_grad = _outer_grads(
            (self.pose_disc, self.shape_disc), self.init, res.params, res.vertices.detach(),
            self.j_reg.detach(), self.data.gt_j3d, p.jreg_mask, p.share)
        put = self.out.put
        for name, value in (("pd_loss", pd_loss), ("sd_loss", sd_loss), ("jr_loss", jr_loss)):
            put(name, value)
        self.grad_tree = [[put(f"pd_grad{i}", g) for i, g in enumerate(pd_grads)],
                          [put(f"sd_grad{i}", g) for i, g in enumerate(sd_grads)],
                          [put("jr_grad", jr_grad)]]
        put("init_vertices", _init_vertices(self.model, self.init))

    def update(self) -> None:
        (pd_grads, sd_grads, (jr_grad,)) = self.grad_tree
        self.pose_disc_opt.step(list(self.pose_disc.parameters()), pd_grads)
        self.shape_disc_opt.step(list(self.shape_disc.parameters()), sd_grads)
        self.jreg_opt.step([self.j_reg], [jr_grad])

    def finish(self, terms, stats) -> None:
        final = _final_values(self.program.cfg.refiner, terms, stats, self.j_reg.device)
        for i, value in enumerate(final):
            self.out.put(f"final{i}", value)

    def outer(self) -> None:
        self.grads()
        self.update()
        self.finish(self.result.stage_b_terms, self.result.bin_stats)

    def __call__(self, state: TrainState, spin_init, data):
        p = self.program
        with profiling.span("outer.step"):
            with profiling.span("outer.load"):
                for mine, theirs in ((self.jreg_opt, state.jreg_opt),
                                     (self.pose_disc_opt, state.pose_disc_opt),
                                     (self.shape_disc_opt, state.shape_disc_opt)):
                    mine.load(theirs)
                self.refiner.load(state.j_reg_raw, spin_init, data, state.pose_disc,
                                  state.shape_disc)
            self.result = self.refine()
            with profiling.span("outer.segment"):
                if not p.distributed:
                    self.steps("outer", self.outer)
                else:
                    self.steps("grads", self.grads)
                    engine._load_inputs(self.grad_tree,
                                        mesh_lib.sum_over_ranks(p.mesh, self.grad_tree))
                    self.steps("update", self.update)
            verts = self.result.vertices
            with profiling.span("outer.evaluate"):
                evals = (
                    _evaluate(state.j_reg_raw, verts, data.gt_j3d, p.jreg_mask, p.share),
                    _evaluate(self.j_reg, verts, data.gt_j3d, p.jreg_mask, p.share),
                    _evaluate(state.j_reg_raw, self.out["init_vertices"], data.gt_j3d,
                              p.jreg_mask, p.share),
                )
            with profiling.span("outer.copy_out"):
                new_state = TrainState(
                    j_reg_raw=self.j_reg.clone(), jreg_opt=copy.deepcopy(self.jreg_opt),
                    pose_disc=copy.deepcopy(self.pose_disc),
                    pose_disc_opt=copy.deepcopy(self.pose_disc_opt),
                    shape_disc=copy.deepcopy(self.shape_disc),
                    shape_disc_opt=copy.deepcopy(self.shape_disc_opt), step=state.step + 1,
                )
                result = _fresh(self.result)
                losses_ = [self.out[k].clone() for k in ("pd_loss", "sd_loss", "jr_loss")]
            if p.distributed:
                with profiling.span("outer.segment"):
                    *losses_, evals, result = _sum_over_processes(p.mesh, *losses_, evals,
                                                                  result)
                    put = self.fin.put
                    terms = type(result.stage_b_terms)(*(
                        put(f"term{i}", t) for i, t in enumerate(result.stage_b_terms)))
                    stats = None if result.bin_stats is None else sf.BinStats(*(
                        put(f"stat{i}", s) for i, s in enumerate(result.bin_stats)))
                    self.steps("finish", self.finish, terms, stats)
            final = [self.out[f"final{i}"].clone() for i in range(6)]
            return new_state, _metrics(final, *losses_, *evals), result


class _Spec(NamedTuple):
    """What an outer-step program is compiled for."""

    cfg: PipelineConfig
    jreg_mask: Optional[torch.Tensor]
    mesh: Optional[mesh_lib.Mesh]
    distributed: bool
    share: float


class OuterProgram:
    """`outer_step` compiled for one run: fn(state, model, spin_init, data)
    → (state, OuterMetrics, RefineResult), equal to
    `outer_step(state, model, spin_init, data, cfg, jreg_mask, mesh)` and,
    like a jitted function, functional: the caller's state and batch are
    read, never written, and nothing returned is a buffer a later call
    overwrites. On CUDA tensors each batch shape (and model, and TF32
    setting) gets its own `_OuterEntry`, captured as CUDA graphs at its
    first call and replayed at every later one; on the CPU, or when built
    under `engine.disable_graphs()`, the same closures run eagerly.

    `compile_times`: per batch size, each graph's `log_compile_time` split
    (`lower_s`, `compile_s` at its capture, `first_run_s` at its first
    replay)."""

    def __init__(self, cfg: PipelineConfig, jreg_mask: Optional[torch.Tensor] = None,
                 mesh: Optional[mesh_lib.Mesh] = None):
        distributed = mesh is not None and mesh.distributed
        self.spec = _Spec(cfg, jreg_mask, mesh, distributed,
                          1.0 / mesh.world_size if distributed else 1.0)
        self.entries = {}
        self.compile_times = {}

    def __call__(self, state: TrainState, model, spin_init: FrameParams, data: FrameBatch):
        key = (id(model),) + _shape_key(spin_init, data)
        entry = self.entries.get(key)
        if entry is None:
            times = self.compile_times.setdefault(f"batch_{spin_init.cam_t.shape[0]}", {})
            entry = self.entries[key] = _OuterEntry(self.spec, times, state, model, spin_init,
                                                    data)
        return entry(state, spin_init, data)


def compile_outer_step(cfg: PipelineConfig, jreg_mask: Optional[torch.Tensor] = None,
                       mesh: Optional[mesh_lib.Mesh] = None) -> OuterProgram:
    """The outer-step program of one run (jrr_tpu/pipeline.py:204-206)."""
    return OuterProgram(cfg, jreg_mask, mesh)


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


def _lstsq_batch(vertices, gt_j3d_mm, pelvis_ref) -> JRegLstsqAccumulator:
    """One batch's statistics (`jreg_lstsq_accumulate`)."""
    target = jreg_lib.move_pelvis(gt_j3d_mm) / 1000.0 + pelvis_ref
    return JRegLstsqAccumulator(
        gram=torch.einsum("bvc,bwc->vw", vertices, vertices),
        rhs=torch.einsum("bvc,bjc->vj", vertices, target),
        count=torch.full((), float(vertices.shape[0]), device=vertices.device),
    )


def jreg_lstsq_accumulate(acc: JRegLstsqAccumulator, vertices, gt_j3d_mm, pelvis_ref, reduce=None):
    """Add a batch: vertices (B, V, 3) refined pseudo-GT, gt_j3d_mm (B, 17, 3),
    pelvis_ref (B, 1, 3) the pelvis in vertex space (meters) from the
    current regressor. The target re-anchors the centred GT there:
    Y = gt_centred + pelvis_ref. `reduce` (a sum over processes, when each
    holds some rows of the batch) is applied to the batch's statistics
    before they are added, so every process holds the global sums."""
    batch = _lstsq_batch(vertices, gt_j3d_mm, pelvis_ref)
    if reduce is not None:
        batch = reduce(batch)
    return JRegLstsqAccumulator(
        gram=acc.gram + batch.gram, rhs=acc.rhs + batch.rhs, count=acc.count + batch.count
    )


class _AccumulateEntry:
    """`jreg_lstsq_accumulate` for one batch shape: static copies of the
    accumulator and the batch, and its graph (two under a distributed
    mesh: the batch's statistics, then, after their all-reduce, the sums)."""

    def __init__(self, mesh, times, acc, batch):
        self.mesh = mesh
        self.acc = _fresh(acc)
        self.batch = _fresh(batch)
        self.out = engine._Static()
        self.steps = engine._Steps(acc.gram.device, times)

    @torch.no_grad()
    def statistics(self) -> None:
        batch = _lstsq_batch(*self.batch)
        self.stats = JRegLstsqAccumulator(*(self.out.put(f, x) for f, x in batch._asdict().items()))

    @torch.no_grad()
    def add(self) -> None:
        for total, part in zip(self.acc, self.stats):
            total.add_(part)

    def accumulate(self) -> None:
        self.statistics()
        self.add()

    def __call__(self, acc, batch) -> JRegLstsqAccumulator:
        engine._load_inputs((self.acc, self.batch), (acc, batch))
        mesh = self.mesh
        if mesh is None or not mesh.distributed:
            self.steps("accumulate", self.accumulate)
        else:
            self.steps("statistics", self.statistics)
            engine._load_inputs(self.stats, mesh_lib.sum_over_ranks(mesh, self.stats))
            self.steps("add", self.add)
        return _fresh(self.acc)


class AccumulateProgram:
    """`jreg_lstsq_accumulate` compiled for one run, as jrr_tpu jits it
    (jrr_tpu/pipeline.py:211): fn(acc, vertices, gt_j3d_mm, pelvis_ref) →
    the new accumulator, equal to `jreg_lstsq_accumulate(acc, vertices,
    gt_j3d_mm, pelvis_ref, reduce)` with `reduce` the sum over the mesh's
    processes, and functional as `OuterProgram` is: one entry per batch
    shape, captured at its first call on the card."""

    def __init__(self, mesh: Optional[mesh_lib.Mesh] = None):
        self.mesh = mesh
        self.entries = {}
        self.compile_times = {}

    def __call__(self, acc: JRegLstsqAccumulator, vertices, gt_j3d_mm, pelvis_ref):
        batch = (vertices, gt_j3d_mm, pelvis_ref)
        key = _shape_key(acc, batch)
        entry = self.entries.get(key)
        if entry is None:
            times = self.compile_times.setdefault(f"batch_{vertices.shape[0]}", {})
            entry = self.entries[key] = _AccumulateEntry(self.mesh, times, acc, batch)
        return entry(acc, batch)


def compile_accumulate(mesh: Optional[mesh_lib.Mesh] = None) -> AccumulateProgram:
    """The lstsq accumulate of one run (jrr_tpu/pipeline.py:211)."""
    return AccumulateProgram(mesh)


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
