"""SMPL body model (counterpart of jrr_tpu/models/smpl.py).

    v_shaped = T + S·β                      (shape blendshapes)
    J_rest   = J_reg_smpl · v_shaped        (rest joints)
    v_posed  = v_shaped + P·vec(R − I)      (pose blendshapes)
    G_k      = FK over the 24-joint tree    (unrolled chain of 3×3 products)
    verts    = LBS(W, A, v_posed)           (Σ_j W[v,j]·A_j, then the affine map)

`lbs_skin` runs the last line: on the card through the CUDA kernel pair
(csrc/lbs_skin.cu), on the CPU through the plain version `lbs_skin_plain`.

`synthetic_smpl_model` is the same numpy generator as the JAX package's, so
one seed gives the same arrays in both packages. `convert_smpl_pickle`
turns the official chumpy-pickled SMPL `.pkl` into the `.npz` that
`load_smpl_npz` reads, with neither chumpy nor scipy installed.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
from typing import Optional, Tuple

import numpy as np
import torch

from jrr_tpu_torch import constants, kernels, resolve_device

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

# Extra keypoint vertices appended by smplx's VertexJointSelector (public smplx
# model facts; order = 5 face, 6 feet, 10 finger tips → smplx joints 24..44).
EXTRA_JOINT_VERTEX_IDS: Tuple[int, ...] = (
    332, 6260, 2800, 4071, 583,            # nose, right eye, left eye, right ear, left ear
    3216, 3226, 3387, 6617, 6624, 6787,    # L big toe, L small toe, L heel, R big toe, R small toe, R heel
    2746, 2319, 2445, 2556, 2673,          # left thumb/index/middle/ring/pinky tips
    6191, 5782, 5905, 6016, 6133,          # right thumb/index/middle/ring/pinky tips
)

# SPIN's 49-joint gather over [45 smplx joints ++ 9 extra-regressor joints]
# (reference: scripts/smpl.py:12-49 JOINT_MAP/JOINT_NAMES order).
SPIN_49_JOINT_MAP: Tuple[int, ...] = (
    24, 12, 17, 19, 21, 16, 18, 20, 0, 2, 5, 8, 1, 4, 7, 25, 26, 27, 28, 29, 30,
    31, 32, 33, 34, 8, 5, 45, 46, 4, 7, 21, 19, 17, 16, 18, 20, 47, 48, 49, 50,
    51, 52, 53, 24, 26, 25, 28, 27,
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

    def __post_init__(self):
        # The parents of joints 1.. as an index on the arrays' device, made
        # here: `_fk` gathers by it inside captured CUDA graphs, which
        # refuse the host-to-device copy of a Python list index.
        object.__setattr__(self, "parent_index", torch.tensor(
            self.parents[1:], dtype=torch.int64, device=self.v_template.device))

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
    rotmats: torch.Tensor, j_rest: torch.Tensor, parents: Tuple[int, ...],
    parent_index: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward kinematics: (B, J, 3, 3) local rotations + (B, J, 3) rest joints
    → (R_global (B, J, 3, 3), t_global (B, J, 3)); `parent_index` holds
    parents[1:] on the joints' device."""
    num_joints = len(parents)
    rel_t = j_rest - torch.cat([j_rest[:, :1], j_rest[:, parent_index]], dim=1)
    rs = [rotmats[:, 0]]
    ts = [j_rest[:, 0]]
    for k in range(1, num_joints):
        p = parents[k]
        rs.append(torch.einsum("bij,bjk->bik", rs[p], rotmats[:, k]))
        ts.append(torch.einsum("bij,bj->bi", rs[p], rel_t[:, k]) + ts[p])
    return torch.stack(rs, dim=1), torch.stack(ts, dim=1)


def lbs_skin_plain(weights: torch.Tensor, a_flat: torch.Tensor, v_posed: torch.Tensor) -> torch.Tensor:
    """Linear-blend skinning: weights (V, J), a_flat (B, J, 12) the joints'
    affine transforms [R (row-major) | t], v_posed (B, V, 3) → verts (B, V, 3)
    = T_rot·v_posed + T_t with T = Σ_j weights[:, j]·a_flat[:, j]."""
    t_vert = torch.einsum("vj,bjd->bvd", weights, a_flat)  # (B, V, 12)
    rot_v = t_vert[..., :9].reshape(*t_vert.shape[:2], 3, 3)
    return torch.einsum("bvik,bvk->bvi", rot_v, v_posed) + t_vert[..., 9:]


class _LBSSkin(torch.autograd.Function):
    """`lbs_skin_plain` on CUDA tensors through the kernel pair
    `kernels.lbs_skin_fwd` / `lbs_skin_bwd`, which raise on what they do not
    take. The weights take no gradient."""

    @staticmethod
    def forward(ctx, weights, a_flat, v_posed):
        weights, a_flat, v_posed = weights.contiguous(), a_flat.contiguous(), v_posed.contiguous()
        ctx.save_for_backward(weights, a_flat, v_posed)
        return kernels.lbs_skin_fwd(weights, a_flat, v_posed)

    @staticmethod
    def backward(ctx, g):
        da, dv_posed = kernels.lbs_skin_bwd(*ctx.saved_tensors, g.contiguous())
        return None, da, dv_posed


def lbs_skin(weights: torch.Tensor, a_flat: torch.Tensor, v_posed: torch.Tensor) -> torch.Tensor:
    """`lbs_skin_plain`, differentiable in a_flat and v_posed: the kernel pair
    on CUDA tensors, the plain version (through autograd) on CPU tensors."""
    if weights.requires_grad:
        raise ValueError("lbs_skin takes no gradient in the skinning weights")
    if not v_posed.is_cuda:
        return lbs_skin_plain(weights, a_flat, v_posed)
    return _LBSSkin.apply(weights, a_flat, v_posed)


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

    r_glob, t_glob = _fk(rotmats, j_rest, model.parents, model.parent_index)

    # Skinning transforms with rest-pose correction: A_k = [R_k | t_k − R_k·j_rest_k].
    a_t = t_glob - torch.einsum("bjik,bjk->bji", r_glob, j_rest)
    a_flat = torch.cat([r_glob.reshape(b, model.num_joints, 9), a_t], dim=-1)  # (B, J, 12)
    verts = lbs_skin(model.lbs_weights, a_flat, v_posed)
    return SMPLOutput(vertices=verts, joints=t_glob, v_shaped=v_shaped)


def smpl_joints49(
    model: SMPLModel, output: SMPLOutput, joint_map: Tuple[int, ...] = SPIN_49_JOINT_MAP
) -> torch.Tensor:
    """SPIN-convention 49-joint output (reference: scripts/smpl.py:72-85):
    a gather over [FK24 ++ 21 selected vertices ++ 9 extra-regressor joints].
    Requires `model.j_regressor_extra`."""
    if model.j_regressor_extra is None:
        raise ValueError("model has no j_regressor_extra; load it to use 49-joint output")
    vertex_joints = output.vertices[:, list(EXTRA_JOINT_VERTEX_IDS)]
    extra = torch.einsum("jv,bvc->bjc", model.j_regressor_extra, output.vertices)
    all_joints = torch.cat([output.joints, vertex_joints, extra], dim=1)
    return all_joints[:, list(joint_map)]


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
    thin_appendage_radius: float = 0.0,
    return_aux: bool = False,
):
    """Structurally consistent synthetic SMPL-like model (the real arrays are
    license-gated): tube surfaces along a T-pose skeleton, faces joining
    nearest neighbours. The numpy draws are those of
    jrr_tpu.models.smpl.synthetic_smpl_model.

    `thin_appendage_radius > 0` (meters) moves two thirds of each hand and
    foot tip joint's vertices (at least 8) onto a thin tube of that radius,
    0.18 m long, along the tip's bone: finger-scale structures, ~2 px wide
    at radius 0.01 on a SPIN crop. The faces join them into a surface as
    they join the rest. With `return_aux=True` returns (model,
    {"appendage_verts": indices, "appendage_groups": [indices per tip]})."""
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

    appendage_verts = np.zeros((0,), np.int64)
    appendage_groups = []
    if thin_appendage_radius > 0.0:
        if num_joints != constants.NUM_SMPL_JOINTS:
            raise ValueError("thin appendages need the 24-joint SMPL tree")
        for k in (22, 23, 10, 11):  # SMPL tips: hands, then feet
            vk = np.where(vert_joint == k)[0]
            take = vk[: max(8, (2 * len(vk)) // 3)]
            if len(take) == 0:
                continue
            d = j_rest[k] - j_rest[parents[k]]
            d = d / max(float(np.linalg.norm(d)), 1e-6)
            t = rng.uniform(0.0, 1.0, size=(len(take), 1)).astype(np.float32)
            ring = rng.normal(size=(len(take), 3)).astype(np.float32)
            ring -= (ring @ d)[:, None] * d  # the component across the bone
            ring /= np.linalg.norm(ring, axis=1, keepdims=True) + 1e-9
            v_template[take] = (
                j_rest[k] + d[None, :] * (t * 0.18) + ring * thin_appendage_radius
            ).astype(np.float32)
            appendage_groups.append(take)
        if appendage_groups:
            appendage_verts = np.concatenate(appendage_groups)

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
    model = SMPLModel(
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
    if return_aux:
        return model, {"appendage_verts": appendage_verts, "appendage_groups": appendage_groups}
    return model


# ---------------------------------------------------------------------------
# The official SMPL pickle → npz
# ---------------------------------------------------------------------------


class _ChumpyUnpickler(pickle.Unpickler):
    """Unpickles the official SMPL .pkl without chumpy or scipy installed.

    Its arrays are chumpy objects, whose state dict holds the ndarray under
    'x', and its J_regressor a scipy.sparse.csc_matrix, whose state holds
    data, indices, indptr and the shape. `find_class` returns stand-ins
    that keep just those: the 2015 Python-2 pickles name the class in
    `scipy.sparse.csc`, newer ones in `scipy.sparse._csc`."""

    class _Ch:
        def __setstate__(self, state):
            self.data = np.asarray(state.get("x")) if isinstance(state, dict) else None

    class _Csc:
        def __setstate__(self, state):
            self.state = state

        def todense(self) -> np.ndarray:
            st = self.state
            shape = tuple(int(n) for n in st.get("_shape", st.get("shape")))
            data, indices = np.asarray(st["data"]), np.asarray(st["indices"], np.int64)
            indptr = np.asarray(st["indptr"], np.int64)
            out = np.zeros(shape, dtype=data.dtype)
            cols = np.repeat(np.arange(shape[1]), np.diff(indptr))
            np.add.at(out, (indices, cols), data)  # duplicates add, as scipy's todense does
            return out

    def find_class(self, module, name):
        if module.startswith("chumpy"):
            return _ChumpyUnpickler._Ch
        if module == "scipy.sparse.csc" or (
            module.startswith("scipy.sparse") and name == "csc_matrix"
        ):
            return _ChumpyUnpickler._Csc
        return super().find_class(module, name)


def _to_dense(x) -> np.ndarray:
    if hasattr(x, "todense"):
        return np.asarray(x.todense())
    if hasattr(x, "data") and not isinstance(x, np.ndarray):
        return np.asarray(x.data)
    return np.asarray(x)


def convert_smpl_pickle(pkl_path: str, npz_path: str) -> None:
    """One-time converter: official SMPL .pkl (chumpy) → plain .npz, with
    jrr_tpu's keys, dtypes and layouts (so either package's `load_smpl_npz`
    reads it)."""
    with open(pkl_path, "rb") as f:
        data = _ChumpyUnpickler(f, encoding="latin1").load()
    np.savez(
        npz_path,
        v_template=_to_dense(data["v_template"]).astype(np.float32),
        shapedirs=_to_dense(data["shapedirs"]).astype(np.float32),
        posedirs=_to_dense(data["posedirs"]).astype(np.float32),
        j_regressor=_to_dense(data["J_regressor"]).astype(np.float32),
        lbs_weights=_to_dense(data["weights"]).astype(np.float32),
        faces=_to_dense(data["f"]).astype(np.int32),
        kintree_parents=np.asarray(data["kintree_table"])[0].astype(np.int64),
    )


def load_smpl_npz(
    npz_path: str,
    num_betas: int = constants.NUM_BETAS,
    j_regressor_extra_path: Optional[str] = None,
    device="cuda",
) -> SMPLModel:
    """Load a converted SMPL model (.npz from `convert_smpl_pickle`, this
    package's or jrr_tpu's)."""
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
