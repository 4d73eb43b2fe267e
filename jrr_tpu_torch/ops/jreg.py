"""Joint-regressor application (counterpart of jrr_tpu/ops/jreg.py:27-81).

The (17, 6890) regressor is masked, passed through ReLU, row-normalized and
applied to vertices as a dense product (reference: scripts/utils.py:85-103).

Reference quirk preserved: `find_j_reg_mask` returns all-ones
(scripts/utils.py:182-187), so by default the "keep zeros zero" constraint is
inert; `jreg_mask(intended=True)` builds the mask the code meant.
"""

from __future__ import annotations

from typing import Optional

import torch


def jreg_mask(j_reg: torch.Tensor, intended: bool = False) -> torch.Tensor:
    if not intended:
        return torch.ones_like(j_reg)
    return torch.where(j_reg == 0, 0.0, 1.0).to(j_reg.dtype)


def normalize_jreg(j_reg: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """mask → ReLU → row-normalize; no epsilon, as the reference divides by
    the raw row sum (scripts/utils.py:87-92)."""
    if mask is not None:
        j_reg = j_reg * mask
    j_reg = torch.relu(j_reg)
    return j_reg / torch.sum(j_reg, dim=1, keepdim=True)


def apply_jreg(j_reg_normalized: torch.Tensor, vertices: torch.Tensor) -> torch.Tensor:
    """(..., J, V) × (B, V, 3) → (..., B, J, 3)."""
    return torch.einsum("...jv,bvc->...bjc", j_reg_normalized, vertices)


def move_pelvis(j3ds: torch.Tensor) -> torch.Tensor:
    """Root-center joints at joint 0 (reference: scripts/utils.py:106-114)."""
    return j3ds - j3ds[..., :1, :]
