"""Protocol-2 evaluation harness (counterpart of jrr_tpu/evals/harness.py:40-181;
reference scripts/test.py:33-138).

`evaluate_regressors` scores any number of (17, V) regressors over one pass
of the initializer's predictions: per batch, one SMPL forward, every
regressor applied to the same vertices, and one (K, 2) array of batch-mean
MPJPE / PA-MPJPE pulled to the host. The means are averaged per batch, as
the reference prints them. The consumer evals (VIBE/MEVA, harness.py:184-274)
are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional

import numpy as np
import torch

from jrr_tpu_torch.evals import metrics as metrics_lib
from jrr_tpu_torch.models import smpl as smpl_lib
from jrr_tpu_torch.ops import jreg as jreg_lib
from jrr_tpu_torch.ops import rotations


@dataclasses.dataclass
class EvalResult:
    mpjpe: float
    pa_mpjpe: float
    num_frames: int


@dataclasses.dataclass
class BeforeAfter:
    before: EvalResult
    after: EvalResult

    def summary(self) -> str:
        # The reference's report structure (scripts/test.py:125-138).
        return (
            f"MPJPE\n{self.before.mpjpe:.4f}\nPAMPJPE\n{self.before.pa_mpjpe:.4f}\n\n"
            f"after\nMPJPE\n{self.after.mpjpe:.4f}\nPAMPJPE\n{self.after.pa_mpjpe:.4f}"
        )


class _MeanAccumulator:
    """Uniform mean of per-batch means, reference-exact: scripts/test.py
    adds `np.mean(error)` per batch and divides by the batch count. Equal
    to frame weighting for equal batches; a ragged last batch keeps the
    reference's convention so printed numbers match digit for digit."""

    def __init__(self):
        self.mpjpe_sum = 0.0
        self.pampjpe_sum = 0.0
        self.n = 0
        self.batches = 0

    def add_means(self, mpjpe_mean: float, pampjpe_mean: float, count: int):
        self.mpjpe_sum += float(mpjpe_mean)
        self.pampjpe_sum += float(pampjpe_mean)
        self.n += count
        self.batches += 1

    def result(self) -> EvalResult:
        b = max(self.batches, 1)
        return EvalResult(self.mpjpe_sum / b, self.pampjpe_sum / b, self.n)


def _vertices(model: smpl_lib.SMPLModel, pose6d, betas) -> torch.Tensor:
    rotmats = rotations.rot6d_to_rotmat(pose6d)
    return smpl_lib.smpl_forward(model, betas, rotmats[:, :1], rotmats[:, 1:]).vertices


def smpl_joint_fn(model: smpl_lib.SMPLModel):
    """(pose6d24, betas, j_reg_norm) → (B, 17, 3) joints in meters."""

    @torch.no_grad()
    def fn(pose6d, betas, j_reg_norm):
        return jreg_lib.apply_jreg(j_reg_norm, _vertices(model, pose6d, betas))

    return fn


@torch.no_grad()
def _batch_means(model, pose6d, betas, gt_j3d_mm, j_reg_norms) -> np.ndarray:
    """One SMPL forward, K regressors scored on the same vertices: (K, 2)
    batch-mean [MPJPE, PA-MPJPE], pulled to the host in one copy."""
    vertices = _vertices(model, pose6d, betas)
    rows = []
    for norm in j_reg_norms:
        errors = metrics_lib.evaluate(jreg_lib.apply_jreg(norm, vertices), gt_j3d_mm)
        rows.append(torch.stack([
            torch.mean(errors.per_frame_mpjpe), torch.mean(errors.per_frame_pa_mpjpe)
        ]))
    return torch.stack(rows).cpu().numpy()


def evaluate_regressors(
    model: smpl_lib.SMPLModel,
    predictions: Iterable[Dict[str, np.ndarray]],
    j_regs,
    jreg_mask: Optional[torch.Tensor] = None,
) -> List[EvalResult]:
    """Score every regressor of `j_regs` over one pass of `predictions`
    (dicts with 'pose6d' (B, 24, 6), 'betas' (B, 10), 'gt_j3d' (B, 17, 3)
    mm), on the model's device. Returns one EvalResult per regressor."""
    dev = model.v_template.device
    as_t = lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev)  # noqa: E731
    norms = torch.stack([jreg_lib.normalize_jreg(as_t(j), jreg_mask) for j in j_regs])
    accs = [_MeanAccumulator() for _ in j_regs]
    for batch in predictions:
        pose6d = as_t(batch["pose6d"])
        means = _batch_means(model, pose6d, as_t(batch["betas"]), as_t(batch["gt_j3d"]), norms)
        for k, acc in enumerate(accs):
            acc.add_means(means[k, 0], means[k, 1], pose6d.shape[0])
    return [acc.result() for acc in accs]


def evaluate_regressor_pair(
    model: smpl_lib.SMPLModel,
    predictions: Iterable[Dict[str, np.ndarray]],
    j_reg_initial,
    j_reg_retrained,
    jreg_mask: Optional[torch.Tensor] = None,
) -> BeforeAfter:
    """SPIN-path protocol-2 eval (reference: scripts/test.py:76-138)."""
    before, after = evaluate_regressors(
        model, predictions, [j_reg_initial, j_reg_retrained], jreg_mask
    )
    return BeforeAfter(before=before, after=after)
