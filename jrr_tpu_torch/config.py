"""Frozen dataclass configuration of the refinement path.

Copies of `CameraConfig`, `SilhouetteConfig`, `LossWeights`,
`RefinerConfig`, `DiscriminatorConfig`, `JRegConfig`, `DataConfig`,
`MeshConfig` and `PipelineConfig` from jrr_tpu/config.py with the same
defaults; the reasons for each default (and the measurements behind them)
are documented there.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class CameraConfig:
    """Perspective camera conventions (reference: scripts/renderer.py:18-20,35-37)."""

    focal_length: float = 5000.0
    image_size: int = 224
    flip_scale: tuple = (-2.0, -2.0, 2.0)


@dataclasses.dataclass(frozen=True)
class SilhouetteConfig:
    """Soft-silhouette rasterizer settings (reference: scripts/mesh_renderer.py:28-38)."""

    image_size: int = 224
    sigma: float = 1e-4  # blend sigma, NDC² units
    blur_radius: float = 1e-4  # outside distance band, NDC²
    faces_per_tile: int = 96
    tile_size: int = 8
    rebin_interval: int = 50
    bin_margin_px: float = 8.0
    max_tiles_per_face: int = 4
    pages_per_tile: int = 16
    # "auto"/"fused": fused page-gather path; "pallas": round-1 tile path
    # (CUDA kernels for CUDA tensors, plain versions for CPU tensors);
    # "xla": the round-1 path when stage B rebins, else the XLA tile loop.
    backend: str = "auto"
    step_stride: int = 2
    coarse_step_stride: Optional[int] = 4
    fine_warm_frac: float = 0.0
    fine_warm_stride: Optional[int] = None
    coarse_frac: float = 0.5
    coarse_factor: int = 2
    # None = auto (on with the fused amortized-bins path), True = require, False = off.
    interior_skip: Optional[bool] = None
    # Pair tiles with ≤ 64 core candidates into one 128-lane row of the
    # loss+grad kernel (`silhouette_fused.pack_bins`, packed after the
    # interior skip at each fused rebin); no effect with backend="pallas".
    lane_pack: bool = False
    coarse_min_image: int = 112


@dataclasses.dataclass(frozen=True)
class LossWeights:
    """Stage-B loss weights (reference: scripts/optimize.py:252-253)."""

    j2d: float = 1.0 / 100.0
    silhouette: float = 100.0
    j3d: float = 10000.0
    pose_disc: float = 10.0
    shape_disc: float = 10.0


@dataclasses.dataclass(frozen=True)
class RefinerConfig:
    """Two-stage Adam refinement schedule (reference: scripts/optimize.py:187-265)."""

    stage_a_steps: int = 1000
    stage_b_steps: int = 100
    stage_a_lr: float = 1e-2
    stage_b_lr: float = 1e-2
    loss_weights: LossWeights = dataclasses.field(default_factory=LossWeights)
    camera: CameraConfig = dataclasses.field(default_factory=CameraConfig)
    silhouette: SilhouetteConfig = dataclasses.field(default_factory=SilhouetteConfig)
    use_silhouette: bool = True
    use_discriminators: bool = True


@dataclasses.dataclass(frozen=True)
class DiscriminatorConfig:
    """Adversarial prior training (reference: scripts/optimize.py:276-293, scripts/args.py:13)."""

    lr: float = 1e-3


@dataclasses.dataclass(frozen=True)
class JRegConfig:
    """Joint-regressor training (reference: scripts/optimize.py:300-312, scripts/args.py:15)."""

    lr: float = 1e-2
    lstsq_ridge: float = 1e-4  # ridge of the least-squares fit path
    # Every N shards, `run_optimize` snapshots the Adam-path regressor to
    # out_dir/jreg_snapshots/snap_<shard>.npz on its writer thread. None = off.
    snapshot_interval: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Input pipeline (reference: scripts/data.py:28-163)."""

    root: str = "data/human3.6m"
    batch_size: int = 256  # --batch_size default (scripts/args.py:8)
    shuffle_seed: int = 0
    prefetch: int = 2
    train_epochs: int = 1  # passes over the split, reshuffled per epoch
    split: str = "validation"  # the reference optimizes over the validation split


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Device settings. The port runs one process per GPU (parallel/):
    `num_devices`, when set, must be the process count of the
    `torch.distributed` group (`pipeline.run_optimize` raises otherwise)."""

    data_axis: str = "data"
    num_devices: Optional[int] = None  # None = the process count (one card without a group)


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    refiner: RefinerConfig = dataclasses.field(default_factory=RefinerConfig)
    discriminator: DiscriminatorConfig = dataclasses.field(default_factory=DiscriminatorConfig)
    jreg: JRegConfig = dataclasses.field(default_factory=JRegConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)
    seed: int = 0
    num_betas: int = 10
