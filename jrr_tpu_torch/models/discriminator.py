"""Adversarial pose/shape priors as `nn.Module`s (counterpart of
jrr_tpu/models/discriminator.py:47-94; reference scripts/discriminator.py:7-74).

- Pose: (B, 24, 6) rot6d → shared per-joint MLP 6→32→32 (the reference's 1×1
  convs), a global head 24·32→1024→1024→1 and 24 per-joint Linear(32, 1)
  heads (one einsum over the (24, 32) weight). Output (B, 25, 1) sigmoid
  scores in the order [global, joint0..joint23].
- Shape: β(10)→10→5→1 MLP, sigmoid.

`nn.Linear` stores weights as (out, in) where the JAX package stores
(in, out); `convert.py` transposes. Init is torch's nn.Linear default
U(±1/√fan_in) for weights and biases, drawn from an explicit generator.
"""

from __future__ import annotations

import torch
from torch import nn

from jrr_tpu_torch import resolve_device

NUM_JOINTS = 24
ROT6D = 6
HIDDEN = 32
GLOBAL_HIDDEN = 1024


def _init_uniform(module: nn.Module, generator: torch.Generator) -> None:
    """U(±1/√fan_in) for every Linear (and the per-joint head), in order."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, nn.Linear):
                bound = 1.0 / m.in_features**0.5
                m.weight.uniform_(-bound, bound, generator=generator)
                m.bias.uniform_(-bound, bound, generator=generator)


class PoseDiscriminator(nn.Module):
    def __init__(self, seed: int = 0, device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.conv1 = nn.utils.skip_init(nn.Linear, ROT6D, HIDDEN)
        self.conv2 = nn.utils.skip_init(nn.Linear, HIDDEN, HIDDEN)
        self.fc1 = nn.utils.skip_init(nn.Linear, NUM_JOINTS * HIDDEN, GLOBAL_HIDDEN)
        self.fc2 = nn.utils.skip_init(nn.Linear, GLOBAL_HIDDEN, GLOBAL_HIDDEN)
        self.fc3 = nn.utils.skip_init(nn.Linear, GLOBAL_HIDDEN, 1)
        # Per-joint heads Linear(32, 1) × 24, stored as one (24, 32) weight.
        self.joint_w = nn.Parameter(torch.empty(NUM_JOINTS, HIDDEN))
        self.joint_b = nn.Parameter(torch.empty(NUM_JOINTS))
        gen = torch.Generator().manual_seed(seed)
        _init_uniform(self, gen)
        with torch.no_grad():
            bound = 1.0 / HIDDEN**0.5
            self.joint_w.uniform_(-bound, bound, generator=gen)
            self.joint_b.uniform_(-bound, bound, generator=gen)
        self.to(dev)

    def forward(self, rot6d: torch.Tensor) -> torch.Tensor:
        """rot6d (B, 24, 6) → (B, 25, 1) sigmoid scores."""
        h = torch.relu(self.conv1(rot6d))
        h = torch.relu(self.conv2(h))  # (B, 24, 32)
        g = torch.relu(self.fc1(h.reshape(h.shape[0], NUM_JOINTS * HIDDEN)))
        g = torch.relu(self.fc2(g))
        g = self.fc3(g)  # (B, 1)
        per_joint = torch.einsum("bjh,jh->bj", h, self.joint_w) + self.joint_b
        return torch.sigmoid(torch.cat([g, per_joint], dim=1)[..., None])


class ShapeDiscriminator(nn.Module):
    def __init__(self, seed: int = 0, device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.fc1 = nn.utils.skip_init(nn.Linear, 10, 10)
        self.fc2 = nn.utils.skip_init(nn.Linear, 10, 5)
        self.fc3 = nn.utils.skip_init(nn.Linear, 5, 1)
        _init_uniform(self, torch.Generator().manual_seed(seed))
        self.to(dev)

    def forward(self, betas: torch.Tensor) -> torch.Tensor:
        """betas (B, 10) → (B, 1) sigmoid score."""
        h = torch.relu(self.fc1(betas))
        h = torch.relu(self.fc2(h))
        return torch.sigmoid(self.fc3(h))


def discriminator_loss(real_scores: torch.Tensor, fake_scores: torch.Tensor) -> torch.Tensor:
    """LSGAN: MSE(D(fake), 0) + MSE(D(real), 1) (reference: scripts/optimize.py:279-281)."""
    return torch.mean(fake_scores**2) + torch.mean((real_scores - 1.0) ** 2)
