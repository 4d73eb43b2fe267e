"""Bundled data (counterpart of jrr_tpu/assets/__init__.py).

`retrained_j_regressor.npz` is the paper's deliverable, the float32
(17, 6890) retrained Human3.6M joint regressor (reference:
models/retrained_J_Regressor.pt, README.md:11-12), a copy of jrr_tpu's
file. It is read from the source tree.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from jrr_tpu_torch import resolve_device

_ASSET_DIR = os.path.dirname(os.path.abspath(__file__))


def load_retrained_j_regressor(device="cuda") -> torch.Tensor:
    """The paper's retrained (17, 6890) joint regressor, float32, on
    `device` (the card unless "cpu" is asked for)."""
    dev = resolve_device(device)
    with np.load(os.path.join(_ASSET_DIR, "retrained_j_regressor.npz")) as f:
        return torch.as_tensor(f["j_regressor"].astype(np.float32), device=dev)
