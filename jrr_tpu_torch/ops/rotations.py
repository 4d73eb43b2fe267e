"""Rotation representations used by the refinement path: 6D ↔ rotmat and
axis-angle → rotmat (counterpart of jrr_tpu/ops/rotations.py:29-58).

Shape-polymorphic over leading batch dims, float32.
"""

from __future__ import annotations

import numpy as np
import torch

from jrr_tpu_torch import resolve_device

_EPS = 1e-12  # torch F.normalize default eps (reference: scripts/utils.py:201-202)


def _safe_normalize(v: torch.Tensor, eps: float = _EPS) -> torch.Tensor:
    norm = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    return v / torch.clamp_min(norm, eps)


def rot6d_to_rotmat(x: torch.Tensor) -> torch.Tensor:
    """(..., 6) → (..., 3, 3): x read as (3, 2) whose columns are the raw
    axes; output columns are (b1, b2, b1×b2) (reference: scripts/utils.py:198-204)."""
    m = x.reshape(x.shape[:-1] + (3, 2))
    a1 = m[..., 0]
    a2 = m[..., 1]
    b1 = _safe_normalize(a1)
    b2 = _safe_normalize(a2 - torch.sum(b1 * a2, dim=-1, keepdim=True) * b1)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], dim=-1)


def rotmat_to_rot6d(r: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) → (..., 6), inverse layout of `rot6d_to_rotmat`."""
    return r[..., :2].reshape(r.shape[:-2] + (6,))


def axis_angle_to_quat(aa: torch.Tensor) -> torch.Tensor:
    """(..., 3) → (..., 4) unit quaternion (w, x, y, z), safe at θ=0."""
    sq = torch.sum(aa * aa, dim=-1, keepdim=True)
    theta = torch.sqrt(torch.clamp_min(sq, _EPS))
    half = 0.5 * theta
    small = sq < 1e-8
    k = torch.where(small, 0.5 - sq / 48.0, torch.sin(half) / theta)
    w = torch.where(small, 1.0 - sq / 8.0, torch.cos(half))
    return torch.cat([w, aa * k], dim=-1)


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) quaternion (w, x, y, z) → (..., 3, 3). Normalizes the input."""
    q = _safe_normalize(q)
    w, x, y, z = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        dim=-1,
    )
    return m.reshape(q.shape[:-1] + (3, 3))


def axis_angle_to_rotmat(aa: torch.Tensor) -> torch.Tensor:
    """Rodrigues via the quaternion route (no 1/θ): (..., 3) → (..., 3, 3)."""
    return quat_to_rotmat(axis_angle_to_quat(aa))


def random_rotmat(
    rng: np.random.Generator, shape: tuple = (), device="cuda"
) -> torch.Tensor:
    """Uniform random rotations from numpy-seeded unit quaternions."""
    q = torch.as_tensor(rng.normal(size=shape + (4,)).astype(np.float32),
                        device=resolve_device(device))
    return quat_to_rotmat(q)
