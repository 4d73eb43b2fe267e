"""SPIN initializer network: ResNet-50 backbone + IEF iterative regressor
(counterpart of jrr_tpu/models/spin.py:27-239; architecture of the SPIN
repo's models/hmr.py, reference: scripts/optimize.py:90-94,164-168).

The modules carry the SPIN repo's parameter and buffer names (`conv1`,
`bn1`, `layer{1..4}.{i}.{conv,bn}{1,2,3}`, `layer*.0.downsample.{0,1}`,
`fc1`, `fc2`, `decpose`, `decshape`, `deccam`, `init_pose`/`init_shape`/
`init_cam`), so a published `model_checkpoint.pt` loads by name
(`load_spin_checkpoint`). Inference only: BatchNorm uses its running
statistics (eps 1e-5), as the reference runs `spin_model.eval()` under
`torch.no_grad()`. The dropout layers of hmr's IEF loop are identities in
eval mode and are left out, as in jrr_tpu.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from jrr_tpu_torch import constants, resolve_device
from jrr_tpu_torch.models import convert_util

NUM_POSE_PARAMS = 24 * 6
FEATURE_DIM = 2048
# (blocks, width, stride of the first block) per stage.
STAGES = ((3, 64, 1), (4, 128, 2), (6, 256, 2), (3, 512, 2))
DEFAULT_CAM = (0.9, 0.0, 0.0)
N_ITER = 3  # IEF rounds, hmr's n_iter


class Bottleneck(nn.Module):
    """1×1 → 3×3 (the stride sits here, as in SPIN's hmr) → 1×1, plus the
    residual, projected by `downsample` in a stage's first block."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1, downsample: bool = False):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride=stride, padding=1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(planes * 4)
        self.downsample = nn.Sequential(
            nn.Conv2d(inplanes, planes * 4, 1, stride=stride, bias=False),
            nn.BatchNorm2d(planes * 4),
        ) if downsample else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.bn1(self.conv1(x)))
        y = torch.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        residual = x if self.downsample is None else self.downsample(x)
        return torch.relu(y + residual)


class ResNet50(nn.Module):
    """NCHW image → (B, 2048) globally average-pooled features. The max
    pool pads with −inf, as flax's does."""

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        inplanes = 64
        for k, (blocks, planes, stride) in enumerate(STAGES):
            layers = [Bottleneck(inplanes, planes, stride, downsample=True)]
            inplanes = planes * 4
            layers += [Bottleneck(inplanes, planes) for _ in range(1, blocks)]
            setattr(self, f"layer{k + 1}", nn.Sequential(*layers))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.bn1(self.conv1(x)))
        x = nn.functional.max_pool2d(x, 3, stride=2, padding=1)
        for k in range(len(STAGES)):
            x = getattr(self, f"layer{k + 1}")(x)
        return x.mean(dim=(2, 3))


def _add_ief_layers(module: nn.Module) -> None:
    """Register the IEF head's layers and mean-parameter buffers on `module`
    under hmr's names."""
    module.fc1 = nn.Linear(FEATURE_DIM + NUM_POSE_PARAMS + 13, 1024)
    module.fc2 = nn.Linear(1024, 1024)
    module.decpose = nn.Linear(1024, NUM_POSE_PARAMS)
    module.decshape = nn.Linear(1024, 10)
    module.deccam = nn.Linear(1024, 3)
    module.register_buffer("init_pose", torch.zeros(1, NUM_POSE_PARAMS))
    module.register_buffer("init_shape", torch.zeros(1, 10))
    module.register_buffer("init_cam", torch.tensor([DEFAULT_CAM]))


def _ief(module: nn.Module, feats, init_pose=None, init_shape=None, init_cam=None):
    """N_ITER rounds of [concat → fc1 → fc2 → delta heads] from the given
    start, or from the module's mean-parameter buffers."""
    b = feats.shape[0]
    pose = module.init_pose.expand(b, -1) if init_pose is None else init_pose
    shape = module.init_shape.expand(b, -1) if init_shape is None else init_shape
    cam = module.init_cam.expand(b, -1) if init_cam is None else init_cam
    for _ in range(N_ITER):
        xc = torch.cat([feats, pose, shape, cam], dim=1)
        xc = torch.relu(module.fc1(xc))
        xc = torch.relu(module.fc2(xc))
        pose = module.decpose(xc) + pose
        shape = module.decshape(xc) + shape
        cam = module.deccam(xc) + cam
    return pose, shape, cam


class SPINRegressor(nn.Module):
    """IEF head: (B, 2048) features → (pose6d (B, 144), betas (B, 10),
    cam (B, 3)), starting from the given estimates or the buffers."""

    def __init__(self):
        super().__init__()
        _add_ief_layers(self)

    def forward(self, feats, init_pose=None, init_shape=None, init_cam=None):
        return _ief(self, feats, init_pose, init_shape, init_cam)


class SPIN(ResNet50):
    """hmr: ImageNet-normalized (B, 3, H, W) → (pose6d (B, 24, 6), betas
    (B, 10), cam (B, 3)). The head's layers sit beside the backbone's, as in
    hmr's state dict."""

    def __init__(self):
        super().__init__()
        _add_ief_layers(self)

    def forward(self, image: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        feats = super().forward(image)
        pose, shape, cam = _ief(self, feats)
        return pose.reshape(-1, 24, 6), shape, cam


def backbone_state(spin: SPIN) -> Dict[str, torch.Tensor]:
    """The ResNet-50 part of a SPIN module's state dict, under `ResNet50`'s
    names (the consumers splice it in as their backbone)."""
    with torch.device("meta"):
        keys = ResNet50().state_dict().keys()
    state = spin.state_dict()
    return {k: state[k] for k in keys}


def load_spin_checkpoint(
    path: str, mean_params_path: Optional[str] = None, device="cuda"
) -> SPIN:
    """A SPIN torch file (`model_checkpoint.pt` or the `.pt.tar` variant:
    the hmr state dict under ['model'] or at the root, with or without
    DataParallel `module.` prefixes) → `SPIN` in eval mode on `device`.

    The mean parameters follow jrr_tpu's converter
    (jrr_tpu/models/spin.py:158-230): the npz fields pose/shape/cam of
    `mean_params_path` (SPIN's smpl_mean_params.npz) win over the file's
    init_* buffers; a file with neither gets zero pose and shape and cam
    (0.9, 0, 0). A drifted key layout raises `CheckpointLayoutError` with a
    diff report. The file is read with `weights_only=True`: SPIN's
    checkpoint holds tensors, dicts and numbers only."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    sd = ckpt.get("model", ckpt) if isinstance(ckpt, dict) else ckpt
    view = convert_util.StateDictView(sd, "SPIN checkpoint state_dict")
    model = convert_util.empty_module(SPIN)
    defaults = None
    if "init_pose" not in view:
        defaults = {"init_pose": np.zeros((1, NUM_POSE_PARAMS), np.float32),
                    "init_shape": np.zeros((1, 10), np.float32),
                    "init_cam": np.asarray([DEFAULT_CAM], np.float32)}
    convert_util.load_module(model, view, defaults=defaults)
    if mean_params_path:
        with np.load(mean_params_path) as f:
            with torch.no_grad():
                for field, buf in (("pose", model.init_pose), ("shape", model.init_shape),
                                   ("cam", model.init_cam)):
                    buf.copy_(torch.as_tensor(f[field].astype(np.float32)).reshape(buf.shape))
    return model.eval().to(resolve_device(device))


def normalize_image(image01: torch.Tensor) -> torch.Tensor:
    """[0, 1] RGB (B, 3, H, W) → ImageNet-normalized (reference:
    scripts/optimize.py:141-142)."""
    mean = image01.new_tensor(constants.IMG_NORM_MEAN).reshape(1, 3, 1, 1)
    std = image01.new_tensor(constants.IMG_NORM_STD).reshape(1, 3, 1, 1)
    return (image01 - mean) / std
