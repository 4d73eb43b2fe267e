"""Plain SMPL body, regressor, camera and priors (float32, plain torch).

The body follows the published SMPL model (Loper et al. 2015): shape
blend shapes, rest joints by the joint regressor, pose blend shapes on
vec(R - I), forward kinematics over the 24-joint tree and linear blend
skinning with the rest-pose correction. Rotations come from the 6D
representation of Zhou et al. 2019 as SPIN reads it (scripts/utils.py:198-204
of the method: the six numbers as a 3x2 matrix whose columns are
Gram-Schmidt-ed). The camera is the method's pytorch3d 0.3.0 convention
(scripts/renderer.py:10-51): SMPL points flipped in x and y and doubled,
translated by the camera vector, projected with focal/size in NDC, then
(S-1)/2 (1 - ndc) on the screen.

Every product goes through `Numerics.einsum`, which in the control's
precision rounds each operand (forward and backward) to TF32's 10-bit
mantissa, as cuBLAS does with TF32 on.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

PARENTS = (-1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17, 18, 19, 20, 21)


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to the nearest TF32 value (10 mantissa bits, ties to even)."""
    bits = x.detach().float().contiguous().view(torch.int32)
    bits = bits + 0x0FFF + ((bits >> 13) & 1)
    return (bits & -8192).view(torch.float32)


class _TF32Einsum(torch.autograd.Function):
    """Two-operand einsum with TF32 operands in both directions."""

    @staticmethod
    def forward(ctx, eq, a, b):
        ins, out = eq.split("->")
        sa, sb = ins.split(",")
        ctx.specs = (sa, sb, out)
        ra, rb = round_tf32(a), round_tf32(b)
        ctx.save_for_backward(ra, rb)
        return torch.einsum(eq, ra, rb)

    @staticmethod
    def backward(ctx, g):
        sa, sb, out = ctx.specs
        ra, rb = ctx.saved_tensors
        rg = round_tf32(g)
        ga = torch.einsum(f"{out},{sb}->{sa}", rg, rb) if ctx.needs_input_grad[1] else None
        gb = torch.einsum(f"{out},{sa}->{sb}", rg, ra) if ctx.needs_input_grad[2] else None
        return None, ga, gb


class Numerics:
    """How the reference computes its products: float32 (`tf32=False`, the
    configuration's precision, TF32 off) or the control's TF32."""

    def __init__(self, tf32: bool = False):
        self.tf32 = tf32

    def einsum(self, eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.tf32:
            return _TF32Einsum.apply(eq, a, b)
        return torch.einsum(eq, a, b)


class Body(NamedTuple):
    v_template: torch.Tensor  # (V, 3)
    shapedirs: torch.Tensor  # (V, 3, betas)
    posedirs: torch.Tensor  # (9 (J - 1), 3 V)
    j_regressor: torch.Tensor  # (J, V), the body's own 24 joints
    lbs_weights: torch.Tensor  # (V, J)
    faces: torch.Tensor  # (F, 3) int64


def _unit(v: torch.Tensor) -> torch.Tensor:
    return v / torch.clamp_min(torch.linalg.vector_norm(v, dim=-1, keepdim=True), 1e-12)


def rotmat_from_6d(x: torch.Tensor) -> torch.Tensor:
    """(..., 6) -> (..., 3, 3): columns b1 = a1/|a1|, b2 = the unit part of
    a2 orthogonal to b1, b3 = b1 x b2, where a1 = x[0::2], a2 = x[1::2]."""
    a1, a2 = x[..., 0::2], x[..., 1::2]
    b1 = _unit(a1)
    b2 = _unit(a2 - (b1 * a2).sum(-1, keepdim=True) * b1)
    b3 = torch.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], dim=-1)


def smpl_vertices(nx: Numerics, body: Body, betas, orient6d, pose6d) -> torch.Tensor:
    """(B, V, 3) posed vertices in metres."""
    b = betas.shape[0]
    nv = body.v_template.shape[0]
    rot = rotmat_from_6d(torch.cat([orient6d, pose6d], dim=1))  # (B, J, 3, 3)
    v_shaped = body.v_template + nx.einsum("bs,vcs->bvc", betas, body.shapedirs)
    joints = nx.einsum("jv,bvc->bjc", body.j_regressor, v_shaped)
    eye = torch.eye(3, dtype=rot.dtype, device=rot.device)
    feature = (rot[:, 1:] - eye).reshape(b, -1)
    v_posed = v_shaped + nx.einsum("bp,pk->bk", feature, body.posedirs).reshape(b, nv, 3)
    world_r = [rot[:, 0]]
    world_t = [joints[:, 0]]
    for k in range(1, len(PARENTS)):
        p = PARENTS[k]
        world_r.append(nx.einsum("bij,bjk->bik", world_r[p], rot[:, k]))
        bone = joints[:, k] - joints[:, p]
        world_t.append(nx.einsum("bij,bj->bi", world_r[p], bone) + world_t[p])
    gr = torch.stack(world_r, dim=1)  # (B, J, 3, 3)
    gt = torch.stack(world_t, dim=1)  # (B, J, 3)
    offset = gt - nx.einsum("bjik,bjk->bji", gr, joints)
    affine = torch.cat([gr.reshape(b, -1, 9), offset], dim=-1)  # (B, J, 12)
    per_vertex = nx.einsum("vj,bjd->bvd", body.lbs_weights, affine)
    rot_v = per_vertex[..., :9].reshape(b, nv, 3, 3)
    return nx.einsum("bvik,bvk->bvi", rot_v, v_posed) + per_vertex[..., 9:]


def normalized_regressor(raw: torch.Tensor) -> torch.Tensor:
    """ReLU, then each row divided by its sum (scripts/utils.py:85-103)."""
    pos = torch.relu(raw)
    return pos / pos.sum(dim=1, keepdim=True)


def regress(nx: Numerics, regressor: torch.Tensor, verts: torch.Tensor) -> torch.Tensor:
    return nx.einsum("jv,bvc->bjc", regressor, verts)


def centred(joints: torch.Tensor) -> torch.Tensor:
    return joints - joints[:, :1]


def screen(points: torch.Tensor, cam_t: torch.Tensor, size: int, focal: float) -> torch.Tensor:
    """SMPL-frame points (B, N, 3) -> screen pixels (B, N, 2) of a size² image."""
    flip = torch.tensor([-2.0, -2.0, 2.0], dtype=points.dtype, device=points.device)
    cam = points * flip + cam_t[:, None, :]
    ndc = (focal / size) * cam[..., :2] / cam[..., 2:3]
    return (size - 1.0) / 2.0 * (1.0 - ndc)


# --- the adversarial priors (scripts/discriminator.py of the method) ---------


def _linear(nx: Numerics, x, w, bias):
    return nx.einsum("...i,oi->...o", x, w) + bias


def pose_prior(nx: Numerics, w: dict, rot6d: torch.Tensor) -> torch.Tensor:
    """(B, 24, 6) -> (B, 25) sigmoid scores [global, joint 0..23]: a shared
    per-joint 6-32-32 MLP, a global 768-1024-1024-1 head and 24 per-joint
    32-1 heads."""
    h = torch.relu(_linear(nx, rot6d, w["conv1.weight"], w["conv1.bias"]))
    h = torch.relu(_linear(nx, h, w["conv2.weight"], w["conv2.bias"]))  # (B, 24, 32)
    g = torch.relu(_linear(nx, h.reshape(h.shape[0], -1), w["fc1.weight"], w["fc1.bias"]))
    g = torch.relu(_linear(nx, g, w["fc2.weight"], w["fc2.bias"]))
    g = _linear(nx, g, w["fc3.weight"], w["fc3.bias"])  # (B, 1)
    per_joint = nx.einsum("bjh,jh->bj", h, w["joint_w"]) + w["joint_b"]
    return torch.sigmoid(torch.cat([g, per_joint], dim=1))


def shape_prior(nx: Numerics, w: dict, betas: torch.Tensor) -> torch.Tensor:
    """(B, 10) -> (B, 1): a 10-10-5-1 MLP, sigmoid."""
    h = torch.relu(_linear(nx, betas, w["fc1.weight"], w["fc1.bias"]))
    h = torch.relu(_linear(nx, h, w["fc2.weight"], w["fc2.bias"]))
    return torch.sigmoid(_linear(nx, h, w["fc3.weight"], w["fc3.bias"]))
