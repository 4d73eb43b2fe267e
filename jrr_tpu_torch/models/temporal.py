"""Temporal (video) pose model, the VIBE-style regressor consumer
(counterpart of jrr_tpu/models/temporal.py:35-133,235-299; reference:
scripts/test.py:141-301 consumes VIBE as a black box taking `J_regressor=`).

Per frame SPIN's ResNet-50 features, a stacked (optionally bidirectional)
GRU over the sequence with a linear + residual projection, and the IEF head
emitting per-frame (pose6d, betas, cam). The modules carry VIBE's key names
(`encoder.gru.weight_ih_l{k}[_reverse]`, …, `encoder.linear.*`,
`regressor.{fc1,fc2,decpose,decshape,deccam}.*`, `regressor.init_*`), so a
published `gen_state_dict` loads by name; the backbone comes from SPIN's
checkpoint, as the reference's VIBE_Demo pulls it
(`evals/consumers.py`).
"""

from __future__ import annotations

import torch
from torch import nn

from jrr_tpu_torch.models import smpl as smpl_lib
from jrr_tpu_torch.models import spin as spin_lib
from jrr_tpu_torch.ops import jreg as jreg_lib
from jrr_tpu_torch.ops import rotations
from jrr_tpu_torch.utils import precision


class TemporalEncoder(nn.Module):
    """VIBE's TemporalEncoder as the reference builds it (add_linear and
    use_residual on): stacked GRU → ReLU → linear back to 2048 → + the
    input, (B, T, 2048) → (B, T, 2048). The ReLU comes FIRST, as in the
    published VIBE; a bidirectional GRU's 2H is mapped back the same way."""

    def __init__(self, hidden_size: int = 1024, n_layers: int = 1, bidirectional: bool = False):
        super().__init__()
        self.gru = nn.GRU(spin_lib.FEATURE_DIM, hidden_size, n_layers, batch_first=True,
                          bidirectional=bidirectional)
        self.linear = nn.Linear(hidden_size * (2 if bidirectional else 1), spin_lib.FEATURE_DIM)

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        h, _ = self.gru(feats)
        return self.linear(torch.relu(h)) + feats


def _per_frame(pose, betas, cam, b: int, t: int):
    return pose.reshape(b, t, 24, 6), betas.reshape(b, t, 10), cam.reshape(b, t, 3)


class TemporalPoseModel(nn.Module):
    """(B, T, 3, H, W) → per-frame (pose6d (B, T, 24, 6), betas, cam)."""

    def __init__(self, hidden_size: int = 1024, n_layers: int = 1, bidirectional: bool = False):
        super().__init__()
        self.backbone = spin_lib.ResNet50()
        self.encoder = TemporalEncoder(hidden_size, n_layers, bidirectional)
        self.regressor = spin_lib.SPINRegressor()

    def from_features(self, feats: torch.Tensor):
        """(B, T, 2048) per-frame backbone features → the per-frame outputs."""
        b, t = feats.shape[:2]
        temporal = self.encoder(feats)
        return _per_frame(*self.regressor(temporal.reshape(b * t, spin_lib.FEATURE_DIM)), b, t)

    def forward(self, video: torch.Tensor):
        b, t = video.shape[:2]
        feats = self.backbone(video.reshape((b * t,) + video.shape[2:]))
        return self.from_features(feats.reshape(b, t, -1))


def vibe_demo_model() -> TemporalPoseModel:
    """The configuration the reference instantiates (scripts/test.py:153-159):
    2-layer unidirectional GRU, hidden 1024."""
    return TemporalPoseModel(hidden_size=1024, n_layers=2, bidirectional=False)


def _joints(smpl_model, pose6d, betas, j_regressor) -> torch.Tensor:
    rotm = rotations.rot6d_to_rotmat(pose6d)
    out = smpl_lib.smpl_forward(smpl_model, betas, rotm[:, :1], rotm[:, 1:])
    return jreg_lib.apply_jreg(j_regressor, out.vertices)


def make_temporal_consumer(smpl_model, model, seqlen: int = 4):
    """Frame-level adapter, the reference's kp_3d[:, 0] of each chunk
    (scripts/test.py:258): every frame is repeated into a length-`seqlen`
    sequence and the first frame's parameters are used.

    jrr_tpu repeats the images and runs the whole model on B·seqlen frames
    (temporal.py:251): at batch 256 and seqlen 16 that is 4096 ResNet-50
    inputs in one call. Here the backbone runs once per frame and its 2048-d
    features are repeated instead; in eval mode a frame's features do not
    depend on the rest of the batch, so it is the same function. Works for
    any model with `backbone` and `from_features` (TemporalPoseModel,
    MEVAPoseModel). Returns (K, B, 17, 3) for a stacked (K, 17, V)
    regressor, float32 products throughout (TF32 off)."""

    def consumer(spin_image: torch.Tensor, j_regressor: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode(), precision.float32_products():
            feats = model.backbone(spin_image)
            video = feats[:, None].expand(-1, seqlen, -1).contiguous()
            pose6d, betas, _ = model.from_features(video)
            return _joints(smpl_model, pose6d[:, 0], betas[:, 0], j_regressor)

    return consumer


def make_sequence_consumer(smpl_model, model):
    """Video-sequence adapter (reference: scripts/test.py:254-258): the model
    consumes real (C, T, 3, H, W) chunks and returns per-frame joints
    (C, T, 17, 3), or (K, C, T, 17, 3) for a stacked regressor; the harness
    picks the frame (`evaluate_consumer_sequences`)."""

    def consumer(video: torch.Tensor, j_regressor: torch.Tensor) -> torch.Tensor:
        c, t = video.shape[:2]
        with torch.inference_mode(), precision.float32_products():
            pose6d, betas, _ = model(video)
            joints = _joints(smpl_model, pose6d.reshape(c * t, 24, 6), betas.reshape(c * t, 10),
                             j_regressor)
            return joints.reshape(joints.shape[:-3] + (c, t) + joints.shape[-2:])

    return consumer
