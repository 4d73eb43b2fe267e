"""MEVA-family temporal pose model, the motion-VAE regressor consumer
(counterpart of jrr_tpu/models/meva.py:42-146; reference: scripts/test.py:
167-195 builds `MEVA_demo` and loads `ckpt['gen_state_dict']`).

Per frame SPIN's ResNet-50 features → VIBE's `TemporalEncoder` → the time
mean mapped to a latent code (`feat_to_latent`, tanh) → the motion VAE's
decoder GRU unrolls it into a coarse rot6d pose sequence → the per-frame
IEF head (`regressor`) refines it, starting from the coarse pose where
VIBE's starts from the mean pose. The modules carry the key names of
jrr_tpu's `convert_torch_meva_checkpoint` (meva.py:160-258): `encoder.*`,
`vae_model.{enc_gru,e_mu,e_logvar,d_init,d_gru,d_out}.*`,
`feat_to_latent.*`, `regressor.*`.
"""

from __future__ import annotations

import torch
from torch import nn

from jrr_tpu_torch.models import spin as spin_lib
from jrr_tpu_torch.models.temporal import TemporalEncoder, _per_frame


class MotionVAE(nn.Module):
    """Sequence VAE on 2048-d features, one encoder GRU layer. encode:
    (B, T, 2048) → (μ, logσ²), both (B, latent); decode: (B, latent) →
    (B, T, 144) rot6d. The decoder GRU starts from
    tanh(d_init(z)) and takes z at every step. Eval mode: z = μ."""

    def __init__(self, latent_dim: int = 1024, hidden_size: int = 1024):
        super().__init__()
        self.enc_gru = nn.GRU(spin_lib.FEATURE_DIM, hidden_size, 1, batch_first=True)
        self.e_mu = nn.Linear(hidden_size, latent_dim)
        self.e_logvar = nn.Linear(hidden_size, latent_dim)
        self.d_init = nn.Linear(latent_dim, hidden_size)
        self.d_gru = nn.GRU(latent_dim, hidden_size, 1, batch_first=True)
        self.d_out = nn.Linear(hidden_size, spin_lib.NUM_POSE_PARAMS)

    def encode(self, seq: torch.Tensor):
        h, _ = self.enc_gru(seq)
        last = h[:, -1]
        return self.e_mu(last), self.e_logvar(last)

    def decode(self, z: torch.Tensor, seqlen: int) -> torch.Tensor:
        h0 = torch.tanh(self.d_init(z))
        inputs = z[:, None].expand(-1, seqlen, -1).contiguous()
        h, _ = self.d_gru(inputs, h0[None].contiguous())
        return self.d_out(h)

    def forward(self, seq: torch.Tensor):
        """Deterministic autoencode: (decode(μ), μ, logσ²)."""
        mu, logvar = self.encode(seq)
        return self.decode(mu, seq.shape[1]), mu, logvar


class MEVAPoseModel(nn.Module):
    """(B, T, 3, H, W) → per-frame (pose6d (B, T, 24, 6), betas, cam)."""

    def __init__(self, hidden_size: int = 1024, n_layers: int = 2,
                 bidirectional: bool = False, latent_dim: int = 1024,
                 vae_hidden: int = 1024):
        super().__init__()
        self.backbone = spin_lib.ResNet50()
        self.encoder = TemporalEncoder(hidden_size, n_layers, bidirectional)
        self.vae_model = MotionVAE(latent_dim=latent_dim, hidden_size=vae_hidden)
        self.feat_to_latent = nn.Linear(spin_lib.FEATURE_DIM, latent_dim)
        self.regressor = spin_lib.SPINRegressor()

    def from_features(self, feats: torch.Tensor):
        """(B, T, 2048) per-frame backbone features → the per-frame outputs."""
        b, t = feats.shape[:2]
        temporal = self.encoder(feats)
        z = torch.tanh(self.feat_to_latent(temporal.mean(dim=1)))
        coarse_pose = self.vae_model.decode(z, t)  # (B, T, 144) rot6d
        out = self.regressor(temporal.reshape(b * t, -1),
                             init_pose=coarse_pose.reshape(b * t, spin_lib.NUM_POSE_PARAMS))
        return _per_frame(*out, b, t)

    def forward(self, video: torch.Tensor):
        b, t = video.shape[:2]
        feats = self.backbone(video.reshape((b * t,) + video.shape[2:]))
        return self.from_features(feats.reshape(b, t, -1))
