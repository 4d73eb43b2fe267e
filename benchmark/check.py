"""How `correct` is decided: the first steps of the timed program against
the plain reference from the same inputs.

Set-up drives the program through its first `steps` outer steps on the
pool's first batches, and the window carries on from the same state. Once
the window has closed and the program is freed, the reference runs the
same steps from the same initial state and batches, and these numbers
compare the two:

- `first_loss_gap`: the first step's refinement, before its Adam steps
  amplify rounding: the largest relative gap of stage A's first loss and
  of stage B's terms (total, j2d, j3d, pose and shape prior) at its first
  step, which stage A's 1000 camera steps lead to;
- `loss_gap`: over those steps, the largest relative gap of the three
  trained losses (pose prior, shape prior, regressor);
- `grad_gap`: the first gradient each leaf's Adam received (read back from
  its first moment after one step), worst leaf: |norm(program) -
  norm(reference)| over the larger of the reference's norm of that leaf
  and of the median leaf;
- `grad_median_gap`: the same gap of the median leaf, steady from seed
  to seed where the worst leaf's is not: the shape prior's gradient sums
  one term a frame through ReLUs, and a frame whose refined betas sit at
  a unit's kink falls on one side or the other by rounding (PERF.md §2);
- `change_gap`: the same measure of each leaf's change after the last
  step, over the leaves whose first reference gradient is at least a
  thousandth of the median leaf's;
- `pgt_gap`: the relative gap of the refined meshes' mean vertex error
  against the ground truth over those batches (the pseudo-ground truth);
- `frame_gap`: the same error frame by frame, the largest gap in mm over
  those batches' frames: one frame's answer gone wrong;
- `eval_gap`: the step's evaluations (MPJPE and PA-MPJPE of the regressor
  before and after its step on the refined meshes, MPJPE at the
  initialisation), the largest relative gap over those steps.

A cell's limits file holds a limit for each number that its readings on
the card separate from the control's or a fault's (PERF.md §2); the
others are computed and printed, and decide nothing.
"""

from __future__ import annotations

import statistics
from typing import Dict, List, NamedTuple

import torch

from benchmark.reference import body as body_lib
from benchmark.reference import outer as ref

LOSSES = ("pose_discriminator_loss", "shape_discriminator_loss", "j_regressor_error")
EVALS = ("mpjpe_before_jreg_step", "pampjpe_before_jreg_step", "mpjpe_after_jreg_step",
         "pampjpe_after_jreg_step", "mpjpe_init")
NUMBERS = ("first_loss_gap", "loss_gap", "grad_gap", "grad_median_gap", "change_gap", "pgt_gap",
           "frame_gap", "eval_gap")
# Leaves whose reference gradient is under this share of the median leaf's
# move by round-off alone, and are left out of `change_gap`.
STILL_LEAF = 1e-3


class Readings(NamedTuple):
    """One side's readings of the first steps."""

    losses: List[Dict[str, float]]  # per step, the LOSSES
    first: List[Dict[str, float]]  # per step, the refinement's first losses (program.FIRST_TERMS)
    first_grads: Dict[str, torch.Tensor]  # leaf -> gradient of step 1
    start: Dict[str, torch.Tensor]  # leaf -> value before step 1
    end: Dict[str, torch.Tensor]  # leaf -> value after the last step
    pgt_mm: List[float]  # per step, mean vertex error against the ground truth
    frame_mm: List[torch.Tensor]  # per step, (B,) each frame's mean vertex error, on the host
    evals: List[Dict[str, float]]  # per step, the EVALS


def reference_leaves(state: ref.State) -> Dict[str, torch.Tensor]:
    out = {"j_reg": state.j_reg}
    out.update({f"pose.{k}": v for k, v in state.pose_w.items()})
    out.update({f"shape.{k}": v for k, v in state.shape_w.items()})
    return out


def reference_first_grads(state: ref.State) -> Dict[str, torch.Tensor]:
    out = {"j_reg": ref.first_gradients(state.jreg_opt)[0]}
    out.update(dict(zip([f"pose.{k}" for k in state.pose_w], ref.first_gradients(state.pose_opt))))
    out.update(dict(zip([f"shape.{k}" for k in state.shape_w],
                        ref.first_gradients(state.shape_opt))))
    return out


def reference_batch(scene, k: int) -> ref.Batch:
    rows = scene.batch_rows(k)
    f = scene.frames
    return ref.Batch(tuple(x[rows] for x in f.init), f.gt_j2d[rows], f.gt_j3d[rows],
                     f.mask[rows])


def frame_mm(verts, gt_verts) -> torch.Tensor:
    """(B,) each frame's mean vertex error against the ground truth, mm, on the host."""
    return ((verts - gt_verts).norm(dim=-1).mean(dim=-1) * 1000.0).cpu()


def run_reference(scene, config: dict, steps: int, nx=None, fault=None, alter=None,
                  evaluate=None) -> Readings:
    """The reference's readings of the first `steps` steps, in float32 with
    TF32 off unless `nx` asks for the control's TF32. `fault(k, batch,
    gt_verts) -> (batch, gt_verts)` changes step k's batch, `alter` the
    refinement's answer and `evaluate` the evaluations (`outer.outer_step`):
    faults the check must catch."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    nx = nx or body_lib.Numerics()
    cfg = config["pipeline"]
    state = ref.initial_state(scene.j_reg_init, scene.pose_w, scene.shape_w, cfg)
    start = {k: v.clone() for k, v in reference_leaves(state).items()}
    losses, first, pgt, frames, evals, grads = [], [], [], [], [], None
    for k in range(steps):
        batch = reference_batch(scene, k)
        gt_verts = scene.frames.gt_verts[scene.batch_rows(k)]
        if fault is not None:
            batch, gt_verts = fault(k, batch, gt_verts)
        state, numbers, _, verts = ref.outer_step(nx, scene.body, state, batch, cfg, alter,
                                                  evaluate)
        losses.append({n: float(numbers[n]) for n in LOSSES})
        evals.append({n: float(numbers[n]) for n in EVALS})
        first.append({n: float(v) for n, v in numbers["first"].items()})
        frames.append(frame_mm(verts, gt_verts))
        pgt.append(float(frames[-1].mean()))
        if k == 0:
            grads = reference_first_grads(state)
    return Readings(losses, first, grads, start, reference_leaves(state), pgt, frames, evals)


def _gap(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def _norm(x) -> float:
    return float(torch.linalg.vector_norm(x.double()))


def compare(got: Readings, want: Readings) -> Dict[str, float]:
    """The numbers of `got` (the program's, or a control's) against `want`
    (the reference's)."""
    first_loss_gap = max(_gap(got.first[0][n], w) for n, w in want.first[0].items())
    loss_gap = max(_gap(g[n], w[n]) for g, w in zip(got.losses, want.losses) for n in LOSSES)
    grad_norms = {k: _norm(v) for k, v in want.first_grads.items()}
    median_grad = statistics.median(grad_norms.values())
    grad_gaps = [abs(_norm(got.first_grads[k]) - n) / max(n, median_grad)
                 for k, n in grad_norms.items()]
    moving = [k for k, n in grad_norms.items() if n >= STILL_LEAF * median_grad]
    want_change = {k: _norm(want.end[k] - want.start[k]) for k in moving}
    median_change = statistics.median(want_change.values())
    change_gap = max(abs(_norm(got.end[k] - got.start[k]) - n) / max(n, median_change)
                     for k, n in want_change.items())
    pgt_gap = _gap(sum(got.pgt_mm) / len(got.pgt_mm), sum(want.pgt_mm) / len(want.pgt_mm))
    frame_gap = max(float((g[:len(w)] - w[:len(g)]).abs().max())
                    for g, w in zip(got.frame_mm, want.frame_mm))
    eval_gap = max(_gap(g[n], w[n]) for g, w in zip(got.evals, want.evals) for n in EVALS)
    return dict(first_loss_gap=first_loss_gap, loss_gap=loss_gap, grad_gap=max(grad_gaps),
                grad_median_gap=statistics.median(grad_gaps), change_gap=change_gap,
                pgt_gap=pgt_gap, frame_gap=frame_gap, eval_gap=eval_gap)


def verdict(numbers: Dict[str, float], limits: Dict[str, float]):
    """(correct, {name: {"value", "limit"}}): every number that has a limit
    at or under it."""
    table = {n: {"value": numbers[n], "limit": limits[n]} for n in NUMBERS if n in limits}
    ok = all(v["value"] <= v["limit"] for v in table.values())
    return ok, table
