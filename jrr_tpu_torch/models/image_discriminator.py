"""Image-conditioned silhouette discriminator (counterpart of
jrr_tpu/models/image_discriminator.py; reference scripts/img_disc.py:1-85,
commented out there): a small strided-conv patch discriminator over the
4-channel (RGB ⊕ silhouette) stack, with the LSGAN objectives of the other
priors. Off the pipeline's path, as in jrr_tpu.

XLA's "SAME" padding at stride 2 on an even size pads 0 before and 1 after
each spatial axis; `nn.Conv2d(padding=1)` would pad 1 on both sides and
shift the map, so each layer pads explicitly by XLA's rule.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from jrr_tpu_torch import resolve_device

# (out_channels, stride) per layer; input 4×224² → 1-logit patch map.
_LAYERS: Tuple[Tuple[int, int], ...] = ((32, 2), (64, 2), (128, 2), (128, 2))


def same_padding(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """(before, after) padding of XLA's "SAME" on one axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class ImageDiscriminator(nn.Module):
    """image (B, 3, S, S) + silhouette (B, S, S) → (B,) mean patch score
    (sigmoid). Weights U(±1/√fan_in) from a seeded generator, biases 0, as
    jrr_tpu initializes (its draws come from a JAX key)."""

    def __init__(self, seed: int = 0, in_channels: int = 4, device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        self.convs = nn.ModuleList()
        c_in = in_channels
        for c_out, stride in _LAYERS:
            conv = nn.utils.skip_init(nn.Conv2d, c_in, c_out, 3, stride=stride)
            self.convs.append(conv)
            c_in = c_out
        self.out = nn.utils.skip_init(nn.Conv2d, c_in, 1, 1)
        with torch.no_grad():
            for conv in list(self.convs) + [self.out]:
                bound = 1.0 / (conv.in_channels * conv.kernel_size[0] * conv.kernel_size[1]) ** 0.5
                conv.weight.uniform_(-bound, bound, generator=gen)
                conv.bias.zero_()
        self.to(dev)

    def forward(self, image: torch.Tensor, silhouette: torch.Tensor) -> torch.Tensor:
        x = torch.cat([image, silhouette[:, None]], dim=1)
        for conv in self.convs:
            s = conv.stride[0]
            top, bottom = same_padding(x.shape[-2], 3, s)
            left, right = same_padding(x.shape[-1], 3, s)
            x = F.leaky_relu(conv(F.pad(x, (left, right, top, bottom))), 0.2)
        return torch.sigmoid(torch.mean(self.out(x), dim=(1, 2, 3)))


def init_image_discriminator(seed: int = 0, in_channels: int = 4, device="cuda") -> ImageDiscriminator:
    """The counterpart of jrr_tpu's `init_image_discriminator(key)`."""
    return ImageDiscriminator(seed=seed, in_channels=in_channels, device=device)


def image_discriminator(disc: ImageDiscriminator, image: torch.Tensor,
                        silhouette: torch.Tensor) -> torch.Tensor:
    """The counterpart of jrr_tpu's `image_discriminator(params, image, silhouette)`."""
    return disc(image, silhouette)

