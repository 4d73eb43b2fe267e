"""Protocol-2 evaluation harness and the consumer evals (counterpart of
jrr_tpu/evals/harness.py:40-274; reference scripts/test.py:33-301).

`evaluate_regressors` scores any number of (17, V) regressors over one pass
of the initializer's predictions: per batch, one SMPL forward, every
regressor applied to the same vertices, and one (K, 2) array of batch-mean
MPJPE / PA-MPJPE pulled to the host. `evaluate_consumer` and
`evaluate_consumer_sequences` score the initial and retrained regressors
through video models (VIBE/MEVA, `evals/consumers.py`), every model on one
pass of the batches, one call per batch and model for both regressors. The means are averaged per batch, as the reference
prints them.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterable, List, Mapping, Optional

import numpy as np
import torch

from jrr_tpu_torch import resolve_device
from jrr_tpu_torch.evals import metrics as metrics_lib
from jrr_tpu_torch.models import smpl as smpl_lib
from jrr_tpu_torch.ops import jreg as jreg_lib
from jrr_tpu_torch.ops import rotations
from jrr_tpu_torch.utils import precision


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


def _as_device(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _pair_norms(j_reg_initial, j_reg_retrained, device):
    """The two regressors normalized and stacked on `device`: by default the
    initial regressor's, when it is a tensor, else the card."""
    if device is None:
        device = j_reg_initial.device if torch.is_tensor(j_reg_initial) else "cuda"
    device = resolve_device(device)
    return torch.stack([jreg_lib.normalize_jreg(_as_device(j, device))
                        for j in (j_reg_initial, j_reg_retrained)]), device


@torch.no_grad()
def _consumer_means(kp3d_all: torch.Tensor, gt_mm: torch.Tensor) -> np.ndarray:
    """(2, B, 17, 3) joints in meters → (2, 2) batch-mean [MPJPE, PA-MPJPE]
    of the pelvis-centred joints, pulled in one copy."""
    rows = []
    for kp3d in kp3d_all:
        errors = metrics_lib.evaluate(jreg_lib.move_pelvis(kp3d), gt_mm)
        rows.append(torch.stack([errors.per_frame_mpjpe.mean(), errors.per_frame_pa_mpjpe.mean()]))
    return torch.stack(rows).cpu().numpy()


class _PairAccumulators:
    """Before and after means of each named consumer."""

    def __init__(self, names):
        self.accs = {name: (_MeanAccumulator(), _MeanAccumulator()) for name in names}

    def add(self, name: str, kp3d_all: torch.Tensor, gt_mm: torch.Tensor) -> None:
        means = _consumer_means(kp3d_all, gt_mm)
        for k, acc in enumerate(self.accs[name]):
            acc.add_means(means[k, 0], means[k, 1], gt_mm.shape[0])

    def results(self) -> Dict[str, BeforeAfter]:
        return {name: BeforeAfter(before=b.result(), after=a.result())
                for name, (b, a) in self.accs.items()}


def evaluate_consumer(
    consumers: Mapping[str, Callable],
    batches: Iterable[Dict[str, np.ndarray]],
    j_reg_initial,
    j_reg_retrained,
    device=None,
) -> Dict[str, BeforeAfter]:
    """VIBE/MEVA-style eval (reference: scripts/test.py:237-301): the
    regressors are normalized once, predictions pelvis-centred, before and
    after scored on the same batches. Every consumer of `consumers` (name →
    consumer) is scored on one pass of the batches, where jrr_tpu takes one
    consumer per pass; returns name → BeforeAfter. `consumer(spin_image,
    norms)` takes the ImageNet-normalized (B, 3, 224, 224) crops and the
    stacked (2, 17, V) regressors and returns (2, B, 17, 3): ONE call scores
    both, since the trunk does not depend on the regressor. Batches hold
    'spin_image' and 'gt_j3d' (mm), as arrays or tensors; they are moved to
    `device` (by default the initial regressor's when it is a tensor, else
    the card)."""
    norms, dev = _pair_norms(j_reg_initial, j_reg_retrained, device)
    accs = _PairAccumulators(consumers)
    for batch in batches:
        img = _as_device(batch["spin_image"], dev)
        gt = _as_device(batch["gt_j3d"], dev)
        for name, consumer in consumers.items():
            accs.add(name, consumer(img, norms), gt)
    return accs.results()


def evaluate_consumer_sequences(
    seq_consumers: Mapping[str, Callable],
    batches: Iterable[Dict[str, np.ndarray]],
    j_reg_initial,
    j_reg_retrained,
    seqlen: int = 16,
    device=None,
) -> Dict[str, BeforeAfter]:
    """Video-sequence consumer eval (reference: scripts/test.py:254-273),
    every sequence consumer on one pass, as `evaluate_consumer`: each
    batch's frames (in temporal order) are cut into (B // seqlen, seqlen)
    chunks, `seq_consumer(video, norms)` runs the real sequences and
    returns (2, C, T, 17, 3), and the first frame of every chunk is scored
    (the reference's kp_3d[:, 0]). Frames that do not fill a chunk are
    dropped, as the reference's chunking drops them."""
    norms, dev = _pair_norms(j_reg_initial, j_reg_retrained, device)
    accs = _PairAccumulators(seq_consumers)
    for batch in batches:
        img = _as_device(batch["spin_image"], dev)
        gt = _as_device(batch["gt_j3d"], dev)
        n_chunks = img.shape[0] // seqlen
        if n_chunks == 0:
            continue
        video = img[: n_chunks * seqlen].reshape((n_chunks, seqlen) + img.shape[1:])
        gt_first = gt[: n_chunks * seqlen].reshape((n_chunks, seqlen) + gt.shape[1:])[:, 0]
        for name, seq_consumer in seq_consumers.items():
            accs.add(name, seq_consumer(video, norms)[:, :, 0], gt_first)
    return accs.results()


def make_spin_consumer(model: smpl_lib.SMPLModel, spin_model):
    """The SPIN network (`models.spin.SPIN`) as a frame-level consumer."""
    joints = smpl_joint_fn(model)

    def consumer(spin_image, j_regressor):
        with torch.inference_mode(), precision.float32_products():
            pose6d, betas, _ = spin_model(spin_image)
            return joints(pose6d, betas, j_regressor)

    return consumer


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
