"""SMPL body model (counterpart of jrr_tpu/models/smpl.py).

    v_shaped = T + S·β                      (shape blendshapes)
    J_rest   = J_reg_smpl · v_shaped        (rest joints)
    v_posed  = v_shaped + P·vec(R − I)      (pose blendshapes)
    G_k      = FK over the 24-joint tree    (unrolled chain of 3×3 products)
    verts    = LBS(W, A, v_posed)           ((V,24)@(24,12) product + affine)

`synthetic_smpl_model` is the same numpy generator as the JAX package's, so
one seed gives the same arrays in both packages.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

import numpy as np
import torch

from jrr_tpu_torch import constants, resolve_device

SMPL_PARENTS: Tuple[int, ...] = (
    -1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17, 18, 19, 20, 21
)

# Approximate T-pose rest joints (meters) in SMPL joint order, used by the
# synthetic model so its limbs spread like a real body.
_TPOSE_JOINTS = (
    (0.00, 0.00, 0.0), (0.07, -0.08, 0.0), (-0.07, -0.08, 0.0), (0.00, 0.12, 0.0),
    (0.10, -0.50, 0.0), (-0.10, -0.50, 0.0), (0.00, 0.25, 0.0), (0.10, -0.90, 0.0),
    (-0.10, -0.90, 0.0), (0.00, 0.35, 0.0), (0.12, -0.95, 0.12), (-0.12, -0.95, 0.12),
    (0.00, 0.50, 0.0), (0.06, 0.45, 0.0), (-0.06, 0.45, 0.0), (0.00, 0.65, 0.0),
    (0.18, 0.45, 0.0), (-0.18, 0.45, 0.0), (0.45, 0.45, 0.0), (-0.45, 0.45, 0.0),
    (0.70, 0.45, 0.0), (-0.70, 0.45, 0.0), (0.80, 0.45, 0.0), (-0.80, 0.45, 0.0),
)


@dataclasses.dataclass(frozen=True)
class SMPLModel:
    """SMPL arrays as tensors on one device, plus the static topology."""

    v_template: torch.Tensor  # (V, 3)
    shapedirs: torch.Tensor  # (V, 3, n_betas)
    posedirs: torch.Tensor  # (9*(J-1), V*3)
    j_regressor: torch.Tensor  # (J, V)
    lbs_weights: torch.Tensor  # (V, J)
    faces: torch.Tensor  # (F, 3) int64
    j_regressor_extra: Optional[torch.Tensor]  # (9, V) or None
    parents: Tuple[int, ...] = SMPL_PARENTS
    # Morton-order vertex permutation (V,) int64 consumed by the fused
    # page-gather rasterizer (render/silhouette_fused.py).
    vertex_perm: Optional[torch.Tensor] = None

    @property
    def num_verts(self) -> int:
        return self.v_template.shape[0]

    @property
    def num_joints(self) -> int:
        return self.j_regressor.shape[0]


@dataclasses.dataclass(frozen=True)
class SMPLOutput:
    vertices: torch.Tensor  # (B, V, 3)
    joints: torch.Tensor  # (B, J, 3) posed kinematic joints
    v_shaped: torch.Tensor  # (B, V, 3)


def _fk(
    rotmats: torch.Tensor, j_rest: torch.Tensor, parents: Tuple[int, ...]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward kinematics: (B, J, 3, 3) local rotations + (B, J, 3) rest joints
    → (R_global (B, J, 3, 3), t_global (B, J, 3))."""
    num_joints = len(parents)
    rel_t = j_rest - torch.cat(
        [j_rest[:, :1], j_rest[:, [parents[k] for k in range(1, num_joints)]]], dim=1
    )
    rs = [rotmats[:, 0]]
    ts = [j_rest[:, 0]]
    for k in range(1, num_joints):
        p = parents[k]
        rs.append(torch.einsum("bij,bjk->bik", rs[p], rotmats[:, k]))
        ts.append(torch.einsum("bij,bj->bi", rs[p], rel_t[:, k]) + ts[p])
    return torch.stack(rs, dim=1), torch.stack(ts, dim=1)


def smpl_forward(
    model: SMPLModel,
    betas: torch.Tensor,
    global_orient: torch.Tensor,
    body_pose: torch.Tensor,
) -> SMPLOutput:
    """betas (B, n_betas), rotation matrices (B, 1, 3, 3) / (B, J-1, 3, 3)."""
    b = betas.shape[0]
    rotmats = torch.cat([global_orient, body_pose], dim=1)  # (B, J, 3, 3)

    v_shaped = model.v_template[None] + torch.einsum("bs,vcs->bvc", betas, model.shapedirs)
    j_rest = torch.einsum("jv,bvc->bjc", model.j_regressor, v_shaped)

    ident = torch.eye(3, dtype=rotmats.dtype, device=rotmats.device)
    pose_feature = (rotmats[:, 1:] - ident).reshape(b, -1)  # (B, 9*(J-1))
    v_posed = v_shaped + (pose_feature @ model.posedirs).reshape(b, model.num_verts, 3)

    r_glob, t_glob = _fk(rotmats, j_rest, model.parents)

    # Skinning transforms with rest-pose correction: A_k = [R_k | t_k − R_k·j_rest_k].
    a_t = t_glob - torch.einsum("bjik,bjk->bji", r_glob, j_rest)
    a_flat = torch.cat([r_glob.reshape(b, model.num_joints, 9), a_t], dim=-1)  # (B, J, 12)
    t_vert = torch.einsum("vj,bjd->bvd", model.lbs_weights, a_flat)  # (B, V, 12)
    rot_v = t_vert[..., :9].reshape(b, model.num_verts, 3, 3)
    verts = torch.einsum("bvik,bvk->bvi", rot_v, v_posed) + t_vert[..., 9:]
    return SMPLOutput(vertices=verts, joints=t_glob, v_shaped=v_shaped)


def _part1by2(x: np.ndarray) -> np.ndarray:
    """Spread the low 10 bits of x two apart (Morton-code helper)."""
    x = x.astype(np.uint64) & 0x3FF
    x = (x | (x << 16)) & 0x30000FF
    x = (x | (x << 8)) & 0x300F00F
    x = (x | (x << 4)) & 0x30C30C3
    x = (x | (x << 2)) & 0x9249249
    return x


def vertex_locality_perm(v_template: np.ndarray) -> np.ndarray:
    """Morton (z-order) permutation of vertices by rest-template position.

    numpy with a stable argsort on purpose: the rasterizer's page tables (and
    so the bins contract shared with the JAX package) depend on this order.
    """
    v = np.asarray(v_template, dtype=np.float64)
    lo = v.min(axis=0)
    extent = np.maximum(v.max(axis=0) - lo, 1e-9)
    q = np.clip(((v - lo) / extent * 1023.0), 0, 1023).astype(np.uint64)
    code = _part1by2(q[:, 0]) | (_part1by2(q[:, 1]) << 1) | (_part1by2(q[:, 2]) << 2)
    return np.argsort(code, kind="stable").astype(np.int32)


def synthetic_smpl_model(
    seed: int = 0,
    num_verts: int = constants.NUM_SMPL_VERTS,
    num_joints: int = constants.NUM_SMPL_JOINTS,
    num_betas: int = constants.NUM_BETAS,
    num_faces: Optional[int] = None,
    device="cuda",
) -> SMPLModel:
    """Structurally consistent synthetic SMPL-like model (the real arrays are
    license-gated): tube surfaces along a T-pose skeleton, faces joining
    nearest neighbours. The numpy draws are those of
    jrr_tpu.models.smpl.synthetic_smpl_model (thin appendages not ported)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    if num_joints == constants.NUM_SMPL_JOINTS:
        parents = SMPL_PARENTS
    else:
        parents = (-1,) + tuple(
            rng.integers(0, k, dtype=np.int64).item() for k in range(1, num_joints)
        )
    if num_faces is None:
        num_faces = 2 * num_verts - 4 if num_verts < 200 else constants.NUM_SMPL_FACES
        num_faces = min(num_faces, max(4, 2 * num_verts))

    if num_joints == len(_TPOSE_JOINTS):
        j_rest = np.asarray(_TPOSE_JOINTS, dtype=np.float32)
        j_rest = j_rest + rng.normal(scale=0.01, size=j_rest.shape).astype(np.float32)
    else:
        j_rest = np.zeros((num_joints, 3), dtype=np.float32)
        for k in range(1, num_joints):
            j_rest[k] = j_rest[parents[k]] + rng.normal(scale=0.12, size=3)
        extent = float(np.max(j_rest.max(axis=0) - j_rest.min(axis=0)))
        j_rest *= 1.7 / max(extent, 1e-6)

    vert_joint = rng.integers(0, num_joints, size=num_verts)
    parent_of = np.asarray([p if p >= 0 else 0 for p in parents])
    parent_of_v = parent_of[vert_joint]
    along = rng.uniform(0.0, 1.0, size=(num_verts, 1)).astype(np.float32)
    base = j_rest[vert_joint] * (1.0 - along) + j_rest[parent_of_v] * along
    dirs = rng.normal(size=(num_verts, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    torso = np.isin(vert_joint, (0, 3, 6, 9, 12)) & (num_joints == 24)
    radius = np.where(
        torso[:, None],
        rng.uniform(0.09, 0.14, size=(num_verts, 1)),
        rng.uniform(0.04, 0.07, size=(num_verts, 1)),
    )
    v_template = (base + dirs * radius).astype(np.float32)

    w = np.zeros((num_verts, num_joints), dtype=np.float32)
    w[np.arange(num_verts), vert_joint] = 0.8
    w[np.arange(num_verts), parent_of[vert_joint]] += 0.2
    w /= w.sum(axis=1, keepdims=True)

    jr = np.zeros((num_joints, num_verts), dtype=np.float32)
    for k in range(num_joints):
        d = np.linalg.norm(v_template - j_rest[k], axis=1)
        idx = np.argsort(d)[:8]
        jr[k, idx] = 1.0 / len(idx)

    shapedirs = rng.normal(scale=0.01, size=(num_verts, 3, num_betas)).astype(np.float32)
    posedirs = rng.normal(
        scale=1e-3, size=(9 * (num_joints - 1), num_verts * 3)
    ).astype(np.float32)
    # Faces join an anchor to two of its 8 nearest vertices (a surface mesh,
    # not body-sized random triangles); 8-NN in anchor chunks.
    anchors = rng.integers(0, num_verts, size=num_faces)
    nn = np.empty((num_faces, 8), dtype=np.int64)
    for lo in range(0, num_faces, 1024):
        hi = min(lo + 1024, num_faces)
        d2 = np.sum((v_template[anchors[lo:hi], None, :] - v_template[None, :, :]) ** 2, axis=-1)
        d2[np.arange(hi - lo), anchors[lo:hi]] = np.inf
        part = np.argpartition(d2, 8, axis=1)[:, :8]
        order = np.argsort(np.take_along_axis(d2, part, axis=1), axis=1)
        nn[lo:hi] = np.take_along_axis(part, order, axis=1)
    pick = rng.permuted(np.tile(np.arange(8), (num_faces, 1)), axis=1)[:, :2]
    faces = np.stack(
        [anchors, np.take_along_axis(nn, pick[:, :1], 1)[:, 0],
         np.take_along_axis(nn, pick[:, 1:2], 1)[:, 0]], axis=1
    )
    extra = None
    if num_verts == constants.NUM_SMPL_VERTS:
        extra = np.zeros((9, num_verts), dtype=np.float32)
        extra[np.arange(9), rng.integers(0, num_verts, size=9)] = 1.0

    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    return SMPLModel(
        v_template=t(v_template),
        shapedirs=t(shapedirs),
        posedirs=t(posedirs),
        j_regressor=t(jr),
        lbs_weights=t(w),
        faces=t(faces.astype(np.int64)),
        j_regressor_extra=None if extra is None else t(extra),
        parents=parents,
        vertex_perm=t(vertex_locality_perm(v_template).astype(np.int64)),
    )


def load_smpl_npz(
    npz_path: str,
    num_betas: int = constants.NUM_BETAS,
    j_regressor_extra_path: Optional[str] = None,
    device="cuda",
) -> SMPLModel:
    """Load a converted SMPL model (.npz from jrr_tpu's `convert_smpl_pickle`)."""
    dev = resolve_device(device)
    with np.load(npz_path) as data:
        data = dict(data)
    posedirs = data["posedirs"]
    if posedirs.ndim == 3:  # (V, 3, 207) → (207, V*3), smplx storage order
        posedirs = posedirs.reshape(-1, posedirs.shape[-1]).T
    parents = data["kintree_parents"].astype(np.int64)
    parents[0] = -1
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)  # noqa: E731
    extra = None
    if j_regressor_extra_path is not None:
        extra = t(np.load(j_regressor_extra_path))
    return SMPLModel(
        v_template=t(data["v_template"]),
        shapedirs=t(data["shapedirs"][..., :num_betas]),
        posedirs=t(posedirs),
        j_regressor=t(data["j_regressor"]),
        lbs_weights=t(data["lbs_weights"]),
        faces=torch.as_tensor(np.asarray(data["faces"], np.int64), device=dev),
        j_regressor_extra=extra,
        parents=tuple(int(p) for p in parents),
        vertex_perm=torch.as_tensor(
            vertex_locality_perm(data["v_template"]).astype(np.int64), device=dev
        ),
    )


def resolve_smpl_model(config_root: str = "data", device="cuda", **kwargs) -> SMPLModel:
    """The real converted model at <config_root>/body_model/smpl_neutral.npz
    if present, else the synthetic stand-in."""
    npz = os.path.join(config_root, "body_model", "smpl_neutral.npz")
    if os.path.exists(npz):
        return load_smpl_npz(npz, device=device, **kwargs)
    return synthetic_smpl_model(device=device)
