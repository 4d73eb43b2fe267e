"""The legacy GT-creation pipeline's capabilities (counterpart of
jrr_tpu/refine/legacy.py; reference scripts/create_smpl_gt.py), the
quaternion-parameterized ancestor of the main optimizer:

- `perspective_projection`: K·(R·X + t) pinhole projection (:248-270);
- `estimate_translation`: the closed-form least-squares camera translation
  from 3D joints and 2D keypoints (:229-245 calls a helper that is
  commented out; this is the intended SMPLify/SPIN closed form);
- `find_error_to_gt`: MSE centred at the midpoint of joints 0 and 3
  (:568-579);
- `find_joints_quat`: the SMPL forward on per-joint quaternions (:582-596);
- `find_translation_and_pose`: camera translation first, then pose and
  translation, with the hand and feet pose gradients zeroed (:648-766,
  :757), each stage with the engine's optax-formula Adam;
- `convert_back_to_original_dimensions`: crop coordinates back to the
  source frame (:35-61).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Union

import torch

from jrr_tpu_torch import constants
from jrr_tpu_torch.models import smpl as smpl_lib
from jrr_tpu_torch.ops import jreg as jreg_lib
from jrr_tpu_torch.ops import rotations
from jrr_tpu_torch.refine.engine import _Adam
from jrr_tpu_torch.utils import precision


def perspective_projection(
    points: torch.Tensor,  # (B, N, 3)
    rotation: torch.Tensor,  # (B, 3, 3)
    translation: torch.Tensor,  # (B, 3)
    focal_length,  # (B,) or scalar
    camera_center: torch.Tensor,  # (B, 2)
) -> torch.Tensor:
    """Pinhole projection K·(R·X + t) → (B, N, 2) pixels."""
    p = torch.einsum("bij,bnj->bni", rotation, points) + translation[:, None]
    p = p / p[..., 2:3]
    f = torch.broadcast_to(torch.as_tensor(focal_length, dtype=p.dtype, device=p.device),
                           p.shape[:1])
    x = f[:, None] * p[..., 0] + camera_center[:, None, 0]
    y = f[:, None] * p[..., 1] + camera_center[:, None, 1]
    return torch.stack([x, y], dim=-1)


def estimate_translation(
    joints_3d: torch.Tensor,  # (B, N, 3) model joints (camera-rotation-free)
    joints_2d: torch.Tensor,  # (B, N, 2) pixel coords
    focal_length: Union[float, torch.Tensor] = constants.FOCAL_LENGTH,
    camera_center: Optional[torch.Tensor] = None,  # (B, 2); default 0
    weights: Optional[torch.Tensor] = None,  # (B, N) confidences
) -> torch.Tensor:
    """Closed-form least-squares T per frame such that K·(X+T) ≈ x_2d: per
    joint f·(X+T)_xy − (x2d − c)·(X+T)_z = 0, linear in T, solved through
    the 3×3 weighted normal equations."""
    b, n = joints_3d.shape[:2]
    dev, dt = joints_3d.device, joints_3d.dtype
    f = torch.broadcast_to(torch.as_tensor(focal_length, dtype=dt, device=dev), (b,))
    if camera_center is None:
        camera_center = torch.zeros((b, 2), dtype=dt, device=dev)
    if weights is None:
        weights = torch.ones((b, n), dtype=dt, device=dev)

    uv = joints_2d - camera_center[:, None]
    x, y, z = joints_3d.unbind(-1)
    u, v = uv.unbind(-1)
    fb = f[:, None]
    zeros = torch.zeros_like(u)
    # Rows: [f, 0, −u]·T = u·z − f·x ; [0, f, −v]·T = v·z − f·y
    a_rows = torch.stack(
        [
            torch.stack([fb * torch.ones_like(u), zeros, -u], dim=-1),
            torch.stack([zeros, fb * torch.ones_like(v), -v], dim=-1),
        ],
        dim=2,
    ).reshape(b, 2 * n, 3)
    b_rows = torch.stack([u * z - fb * x, v * z - fb * y], dim=2).reshape(b, 2 * n)
    w_rows = torch.repeat_interleave(weights, 2, dim=1)
    aw = a_rows * w_rows[..., None]
    ata = torch.einsum("bni,bnj->bij", aw, a_rows)
    atb = torch.einsum("bni,bn->bi", aw, b_rows)
    eye = torch.eye(3, dtype=dt, device=dev)
    return torch.linalg.solve(ata + 1e-8 * eye, atb[..., None])[..., 0]


def find_error_to_gt(pred_j3d: torch.Tensor, gt_j3d: torch.Tensor) -> torch.Tensor:
    """MSE after centring each skeleton at the midpoint of joints 0 and 3."""
    def center(j):
        return j - (j[:, 0:1] + j[:, 3:4]) / 2.0

    return torch.mean((center(pred_j3d) - center(gt_j3d)) ** 2)


def find_joints_quat(
    model: smpl_lib.SMPLModel,
    betas: torch.Tensor,
    orient_quat: torch.Tensor,  # (B, 1, 4)
    pose_quat: torch.Tensor,  # (B, 23, 4)
    j_reg_raw: torch.Tensor,
    jreg_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The regressed joints of a quaternion-parameterized body."""
    out = smpl_lib.smpl_forward(
        model, betas, rotations.quat_to_rotmat(orient_quat), rotations.quat_to_rotmat(pose_quat)
    )
    return jreg_lib.apply_jreg(jreg_lib.normalize_jreg(j_reg_raw, jreg_mask), out.vertices)


class StagedFitResult(NamedTuple):
    orient_quat: torch.Tensor
    pose_quat: torch.Tensor
    translation: torch.Tensor
    stage1_loss: torch.Tensor  # (steps1,)
    stage2_loss: torch.Tensor  # (steps2,)


@precision.float32_products()
def find_translation_and_pose(
    model: smpl_lib.SMPLModel,
    gt_j3d_mm: torch.Tensor,  # (B, 17, 3)
    init_orient_quat: torch.Tensor,  # (B, 1, 4)
    init_pose_quat: torch.Tensor,  # (B, 23, 4)
    init_translation: torch.Tensor,  # (B, 3)
    betas: torch.Tensor,  # (B, 10) held fixed
    j_reg_raw: torch.Tensor,
    steps_translation: int = 100,
    steps_pose: int = 100,
    lr: float = 1e-2,
    freeze_hand_feet: bool = True,
) -> StagedFitResult:
    """Staged fit: the camera translation first, then the orient and pose
    quaternions with the translation, the hand and feet pose gradients
    zeroed; fresh Adam per stage. Each loss is the one before its step.
    TF32 stays off while it runs."""
    gt = jreg_lib.move_pelvis(gt_j3d_mm) / 1000.0

    def loss_fn(orient_q, pose_q, t):
        j = find_joints_quat(model, betas, orient_q, pose_q, j_reg_raw) + t[:, None]
        return torch.mean((jreg_lib.move_pelvis(j) - gt) ** 2)

    def run(params, steps, frozen):
        params = [p.detach().clone().requires_grad_(True) for p in params]
        opt = _Adam(params, lr)
        losses = []
        for _ in range(steps):
            loss = loss_fn(*(params if len(params) == 3 else frozen + params))
            grads = list(torch.autograd.grad(loss, params))
            if len(params) == 3 and freeze_hand_feet:
                grads[1] = grads[1].clone()
                grads[1][:, list(constants.HAND_FEET_ROT_INDICES)] = 0.0
            opt.step(params, grads)
            losses.append(loss.detach())
        empty = gt.new_zeros((0,))
        return [p.detach() for p in params], torch.stack(losses) if losses else empty

    # Stage 1: translation only (the pelvis-centred loss makes it gauge-free;
    # kept for parity with the reference's staging).
    (t_fit,), l1 = run([init_translation], steps_translation,
                       [init_orient_quat.detach(), init_pose_quat.detach()])
    # Stage 2: orient + pose quaternions (+ translation).
    (orient_q, pose_q, t_fit), l2 = run([init_orient_quat, init_pose_quat, t_fit], steps_pose, [])
    return StagedFitResult(orient_quat=orient_q, pose_quat=pose_q, translation=t_fit,
                           stage1_loss=l1, stage2_loss=l2)


def convert_back_to_original_dimensions(
    j2d_crop: torch.Tensor,  # (B, N, 2) coords in the crop (crop_res²)
    min_x: torch.Tensor, min_y: torch.Tensor, scale: torch.Tensor,  # from find_crop
    crop_res: int = constants.CROP_RES,
) -> torch.Tensor:
    """Inverse of data/crop.reposition_j2d."""
    factor = constants.IMG_RES / crop_res
    x = j2d_crop[..., 0] * factor * scale[..., None] + min_x[..., None]
    y = j2d_crop[..., 1] * factor * scale[..., None] + min_y[..., None]
    return torch.stack([x, y], dim=-1)
