"""Rotation representations: 6D ↔ rotmat, axis-angle ↔ quaternion ↔ rotmat
(counterpart of jrr_tpu/ops/rotations.py:29-139).

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


def rotmat_to_quat(r: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) → (..., 4) unit quaternion (w, x, y, z), w ≥ 0.

    Shepperd's extraction without branches: all four candidate
    constructions are built and the one with the largest pivot (the
    diagonal term 4·q_i²) is taken per rotation, so it stays exact near
    180° where the trace term vanishes."""
    m00, m01, m02 = r[..., 0, 0], r[..., 0, 1], r[..., 0, 2]
    m10, m11, m12 = r[..., 1, 0], r[..., 1, 1], r[..., 1, 2]
    m20, m21, m22 = r[..., 2, 0], r[..., 2, 1], r[..., 2, 2]
    tr = m00 + m11 + m22
    qw = torch.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], dim=-1)
    qx = torch.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20], dim=-1)
    qy = torch.stack([m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21], dim=-1)
    qz = torch.stack([m10 - m01, m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22], dim=-1)
    pivots = torch.stack(
        [1.0 + tr, 1.0 + m00 - m11 - m22, 1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22],
        dim=-1,
    )
    best = torch.argmax(pivots, dim=-1)  # the first of equal pivots, as jnp.argmax
    cands = torch.stack([qw, qx, qy, qz], dim=-2)  # (..., 4 candidates, 4)
    q = torch.take_along_dim(cands, best[..., None, None], dim=-2)[..., 0, :]
    q = _safe_normalize(q)
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)


def quat_to_axis_angle(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) quaternion → (..., 3) axis-angle with θ in [0, π], safe at
    the identity (θ/sin(θ/2) → 2 + θ²/12 there)."""
    q = _safe_normalize(q)
    q = q * torch.where(q[..., :1] < 0, -1.0, 1.0)
    w = torch.clamp(q[..., :1], -1.0, 1.0)
    xyz = q[..., 1:]
    sin_half_sq = torch.sum(xyz * xyz, dim=-1, keepdim=True)
    sin_half = torch.sqrt(torch.clamp_min(sin_half_sq, _EPS))
    theta = 2.0 * torch.atan2(sin_half, w)
    small = sin_half_sq < 1e-8
    scale = torch.where(small, 2.0 + sin_half_sq / 1.5, theta / sin_half)
    return xyz * scale


def rotmat_to_axis_angle(r: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) → (..., 3)."""
    return quat_to_axis_angle(rotmat_to_quat(r))


def random_rotmat(
    rng: np.random.Generator, shape: tuple = (), device="cuda"
) -> torch.Tensor:
    """Uniform random rotations from numpy-seeded unit quaternions."""
    q = torch.as_tensor(rng.normal(size=shape + (4,)).astype(np.float32),
                        device=resolve_device(device))
    return quat_to_rotmat(q)
