"""Batched similarity (Procrustes) alignment (counterpart of
jrr_tpu/ops/procrustes.py:14; reference scripts/eval_utils.py:7-58)."""

from __future__ import annotations

import torch


def similarity_align(s1: torch.Tensor, s2: torch.Tensor) -> torch.Tensor:
    """s1, s2 (B, N, 3) → s1 mapped onto s2 by the best scale, rotation and
    translation. The (B, 3, 3) SVDs run batched; the reflection fix puts
    the sign of det(U Vᵀ) into the last singular vector
    (scripts/eval_utils.py:39-44)."""
    x1 = s1.transpose(-1, -2)  # (B, 3, N)
    x2 = s2.transpose(-1, -2)
    mu1 = x1.mean(dim=-1, keepdim=True)
    mu2 = x2.mean(dim=-1, keepdim=True)
    x1c = x1 - mu1
    x2c = x2 - mu2
    var1 = torch.sum(x1c**2, dim=(-1, -2))
    k = torch.einsum("bin,bjn->bij", x1c, x2c)  # (B, 3, 3)
    u, _, vh = torch.linalg.svd(k)
    v = vh.transpose(-1, -2)
    det = torch.linalg.det(torch.einsum("bij,bkj->bik", u, v))
    ones = torch.ones_like(det)
    d = torch.stack([ones, ones, torch.sign(det)], dim=-1)
    r = torch.einsum("bij,bj,bkj->bik", v, d, u)  # V diag(d) Uᵀ
    scale = torch.diagonal(r @ k, dim1=-2, dim2=-1).sum(-1) / var1
    t = mu2 - scale[..., None, None] * (r @ mu1)
    return (scale[..., None, None] * (r @ x1) + t).transpose(-1, -2)
