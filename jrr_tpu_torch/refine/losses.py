"""Loss terms of the two-stage refinement (counterpart of
jrr_tpu/refine/losses.py:32-234; reference scripts/optimize.py:220-253).

One SMPL forward feeds every term. Losses are per-frame means averaged over
frames, which keeps frames independent (with per-frame Adam normalisation
the trajectories equal the reference's batch-wide MSE).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from jrr_tpu_torch.config import RefinerConfig
from jrr_tpu_torch.models import smpl as smpl_lib
from jrr_tpu_torch.ops import jreg as jreg_lib
from jrr_tpu_torch.ops import rotations
from jrr_tpu_torch.render import camera as camera_lib
from jrr_tpu_torch.render import silhouette as sil_lib
from jrr_tpu_torch.render import silhouette_fused as sf


class FrameBatch(NamedTuple):
    """Per-frame supervision (batch-first)."""

    gt_j2d: torch.Tensor  # (B, 17, 2) crop-space pixels
    gt_j3d: torch.Tensor  # (B, 17, 3) millimeters
    mask: Optional[torch.Tensor] = None  # (B, S, S) silhouette in [0, 1]


class FrameParams(NamedTuple):
    """The optimized per-frame state (reference: scripts/optimize.py:177-185)."""

    pose6d: torch.Tensor  # (B, 23, 6)
    orient6d: torch.Tensor  # (B, 1, 6)
    betas: torch.Tensor  # (B, 10)
    cam_t: torch.Tensor  # (B, 3)


class LossTerms(NamedTuple):
    total: torch.Tensor
    j2d: torch.Tensor
    j3d: torch.Tensor
    silhouette: torch.Tensor
    pose_disc: torch.Tensor
    shape_disc: torch.Tensor


def forward_frame(model: smpl_lib.SMPLModel, params: FrameParams) -> smpl_lib.SMPLOutput:
    """Rotations + one SMPL forward shared by every loss term."""
    orient = rotations.rot6d_to_rotmat(params.orient6d)
    pose = rotations.rot6d_to_rotmat(params.pose6d)
    return smpl_lib.smpl_forward(model, params.betas, orient, pose)


def joints_from_verts(j_reg_norm: torch.Tensor, vertices: torch.Tensor) -> torch.Tensor:
    return jreg_lib.apply_jreg(j_reg_norm, vertices)


def reproject_joints(joints3d, cam_t, cfg: RefinerConfig) -> torch.Tensor:
    """(B, J, 3) SMPL-frame joints → (B, J, 2) screen coordinates."""
    screen = camera_lib.project_points_screen(
        joints3d, cam_t, cfg.camera.image_size, cfg.camera.focal_length
    )
    return screen[..., :2]


def j2d_loss(pred_2d, gt_j2d) -> torch.Tensor:
    return torch.mean((pred_2d - gt_j2d) ** 2, dim=(-1, -2))  # (B,)


def j3d_loss(pred_joints_m, gt_j3d_mm) -> torch.Tensor:
    """Pelvis-centred MSE against GT in meters (reference: scripts/optimize.py:238-239)."""
    pred = jreg_lib.move_pelvis(pred_joints_m)
    gt = jreg_lib.move_pelvis(gt_j3d_mm) / 1000.0
    return torch.mean((pred - gt) ** 2, dim=(-1, -2))  # (B,)


def rasterizer_spec(cfg: RefinerConfig) -> sil_lib.RasterizerSpec:
    # The silhouette camera sees the 2D-joint camera's frustum at its own
    # resolution, so focal scales with the size ratio (a downscale, not a crop).
    focal = cfg.camera.focal_length * cfg.silhouette.image_size / cfg.camera.image_size
    return sil_lib.RasterizerSpec(
        image_size=cfg.silhouette.image_size,
        sigma=cfg.silhouette.sigma,
        blur_radius=cfg.silhouette.blur_radius,
        tile_size=cfg.silhouette.tile_size,
        faces_per_tile=cfg.silhouette.faces_per_tile,
        focal_length=focal,
        bin_margin_px=cfg.silhouette.bin_margin_px,
        max_tiles_per_face=cfg.silhouette.max_tiles_per_face,
        pages_per_tile=cfg.silhouette.pages_per_tile,
        backend=cfg.silhouette.backend,
    )


def resolve_silhouette_backend(spec: sil_lib.RasterizerSpec) -> str:
    """"auto"/"fused" → the fused page-gather path; "pallas" → the round-1
    tile path; "xla" → the XLA tile loop, or the round-1 route where the
    engine passes bins (jrr_tpu :114-117)."""
    if spec.backend in ("auto", "fused"):
        return "fused"
    if spec.backend in ("pallas", "xla"):
        return spec.backend
    raise ValueError(f"silhouette backend {spec.backend!r}: one of 'auto', 'fused', "
                     "'pallas', 'xla'")


def silhouette_loss(model, vertices, cam_t, mask, cfg: RefinerConfig, bins=None) -> torch.Tensor:
    """Per-frame MSE between the soft silhouette and the GT mask
    (reference: scripts/optimize.py:234-247): in tile space on the fused
    path, in image space through `render_mesh_silhouette` on the others
    (`bins` is then a `silhouette.BinState`). The mask is supervision: its
    gradient is stopped."""
    mask = mask.detach()
    spec = rasterizer_spec(cfg)
    backend = resolve_silhouette_backend(spec)
    if backend == "fused":
        mask_tiles = sf.image_to_tiles(mask, spec.tile_size)
        return sf.silhouette_sq_err_fused(vertices, model, cam_t, mask_tiles, spec, bins=bins)
    render = sil_lib.render_mesh_silhouette(vertices, model.faces, cam_t,
                                            spec._replace(backend=backend), bins=bins)
    return torch.mean((render - mask) ** 2, dim=(-1, -2))  # (B,)


def stage_b_loss(
    model,
    j_reg_norm,
    pose_disc,
    shape_disc,
    params: FrameParams,
    data: FrameBatch,
    cfg: RefinerConfig,
    bins=None,
    sil_active: Optional[bool] = None,
    sil_scale: Optional[float] = None,
):
    """Five-term objective (reference: scripts/optimize.py:252-253).
    Returns (scalar, LossTerms).

    `sil_active` (None or bool): with silhouette striding the engine passes
    whether this step rasterizes; active steps scale the term by the stride
    (`sil_scale`, default `step_stride`), inactive steps skip the rasterizer.
    """
    out = forward_frame(model, params)
    joints = joints_from_verts(j_reg_norm, out.vertices)
    l_j2d = j2d_loss(reproject_joints(joints, params.cam_t, cfg), data.gt_j2d)
    l_j3d = j3d_loss(joints, data.gt_j3d)

    if cfg.use_silhouette and data.mask is not None and sil_active is not False:
        l_sil = silhouette_loss(model, out.vertices, params.cam_t, data.mask, cfg, bins=bins)
        if sil_active is not None:
            scale = float(max(1, cfg.silhouette.step_stride)) if sil_scale is None else sil_scale
            l_sil = l_sil * scale
    else:
        l_sil = torch.zeros_like(l_j3d)

    if cfg.use_discriminators and pose_disc is not None:
        rot6d_full = torch.cat([params.orient6d, params.pose6d], dim=1)
        l_pd = torch.mean((pose_disc(rot6d_full) - 1.0) ** 2, dim=(-1, -2))
        l_sd = torch.mean((shape_disc(params.betas) - 1.0) ** 2, dim=-1)
    else:
        l_pd = torch.zeros_like(l_j3d)
        l_sd = torch.zeros_like(l_j3d)

    w = cfg.loss_weights
    per_frame = (
        l_j2d * w.j2d + l_sil * w.silhouette + l_j3d * w.j3d
        + l_pd * w.pose_disc + l_sd * w.shape_disc
    )
    terms = LossTerms(
        total=torch.mean(per_frame),
        j2d=torch.mean(l_j2d),
        j3d=torch.mean(l_j3d),
        silhouette=torch.mean(l_sil),
        pose_disc=torch.mean(l_pd),
        shape_disc=torch.mean(l_sd),
    )
    return terms.total, terms

