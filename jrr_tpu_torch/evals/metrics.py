"""MPJPE / PA-MPJPE (counterpart of jrr_tpu/evals/metrics.py:27; reference
scripts/utils.py:117-145): predictions in meters, targets in millimeters,
both pelvis-centred at joint 0, per-frame mean joint error, batch mean,
reported in millimeters."""

from __future__ import annotations

from typing import NamedTuple

import torch

from jrr_tpu_torch.ops import procrustes


class PoseErrors(NamedTuple):
    mpjpe: torch.Tensor  # scalar, millimeters
    pa_mpjpe: torch.Tensor  # scalar, millimeters
    per_frame_mpjpe: torch.Tensor  # (B,), millimeters
    per_frame_pa_mpjpe: torch.Tensor  # (B,), millimeters


def evaluate(pred_j3d_m: torch.Tensor, target_j3d_mm: torch.Tensor) -> PoseErrors:
    """pred (B, J, 3) in meters; target (B, J, 3) in millimeters."""
    pred = pred_j3d_m - pred_j3d_m[:, :1]
    target = target_j3d_mm / 1000.0
    target = target - target[:, :1]
    err = torch.sqrt(torch.sum((pred - target) ** 2, dim=-1)).mean(dim=-1)  # (B,) meters
    aligned = procrustes.similarity_align(pred, target)
    err_pa = torch.sqrt(torch.sum((aligned - target) ** 2, dim=-1)).mean(dim=-1)
    return PoseErrors(
        mpjpe=torch.mean(err) * 1000.0,
        pa_mpjpe=torch.mean(err_pa) * 1000.0,
        per_frame_mpjpe=err * 1000.0,
        per_frame_pa_mpjpe=err_pa * 1000.0,
    )
