"""Warp-matrix builders and random perturbations (counterpart of
jrr_tpu/data/perturbation.py; reference scripts/perturbation_helper.py:11-210):
vec → 3×3 builders for translation, rotation and similarity transforms, and
random similarity perturbations for warp augmentation.

The random draws come from an explicit `torch.Generator` where jrr_tpu
draws from a JAX key, so one seed gives other numbers in the two packages.
"""

from __future__ import annotations

from typing import Optional

import torch

from jrr_tpu_torch import resolve_device
from jrr_tpu_torch.data.crop import similarity_vec_to_mat  # re-export

__all__ = [
    "similarity_vec_to_mat", "translation_vec_to_mat", "rotation_vec_to_mat",
    "gen_random_perturbation",
]


def translation_vec_to_mat(vec: torch.Tensor) -> torch.Tensor:
    """(B, 2) [dx, dy] → (B, 3, 3)."""
    dx, dy = vec[:, 0], vec[:, 1]
    zero, one = torch.zeros_like(dx), torch.ones_like(dx)
    return torch.stack([one, zero, dx, zero, one, dy, zero, zero, one], -1).reshape(-1, 3, 3)


def rotation_vec_to_mat(vec: torch.Tensor) -> torch.Tensor:
    """(B, 3) [θ, dx, dy] → (B, 3, 3) = R(θ)·T(dx, dy)
    (reference: scripts/perturbation_helper.py:159-182)."""
    theta, dx, dy = vec[:, 0], vec[:, 1], vec[:, 2]
    cos, sin = torch.cos(theta), torch.sin(theta)
    zero, one = torch.zeros_like(theta), torch.ones_like(theta)
    r = torch.stack([cos, -sin, zero, sin, cos, zero, zero, zero, one], -1).reshape(-1, 3, 3)
    t = torch.stack([one, zero, dx, zero, one, dy, zero, zero, one], -1).reshape(-1, 3, 3)
    return r @ t


def gen_random_perturbation(
    batch: int,
    max_rotation: float = 0.1,
    max_scale_delta: float = 0.1,
    max_translation: float = 0.1,
    generator: Optional[torch.Generator] = None,
    device="cuda",
) -> torch.Tensor:
    """Random similarity perturbations (B, 3, 3): θ, the two scales' deltas
    and the translation each uniform in ±their maximum, drawn in that order
    from `generator` (a generator on `device`; None: the default one)."""
    dev = resolve_device(device)

    def uniform(shape, bound):
        u = torch.rand(shape, generator=generator, device=dev)
        return (2.0 * u - 1.0) * bound

    theta = uniform((batch,), max_rotation)
    scale = 1.0 + uniform((batch, 2), max_scale_delta)
    trans = uniform((batch, 2), max_translation)
    return similarity_vec_to_mat(torch.cat([theta[:, None], scale, trans], dim=1))
