"""Offline raw-Human3.6M preparation (counterpart of jrr_tpu/data/raw_h36m.py;
reference scripts/data.py:274-382).

`load_raw_h36m` walks processed actor/scene directories, each with an
`annot.h5` (read by `data/hdf5.py`), and returns per frame the image path
(<scene>/imageSequence/<camera>/img_<frame:06d>.jpg), the GT 2D and 3D
joints reindexed to the 17-joint evaluation skeleton (`GT_2_J17`) and the
camera's intrinsics from the scene's `intrinsics/<camera>` dataset
(fx, cx, fy, cy). `load_precomputed_outputs` joins the refined shards of a
previous run (`utils/checkpoint.ShardManifest`). Host side, numpy only.
"""

from __future__ import annotations

import glob
import os
from typing import Dict, List

import numpy as np

from jrr_tpu_torch import constants
from jrr_tpu_torch.data import hdf5

TRAIN_ACTORS = ("S1", "S5", "S6", "S7", "S8")
VAL_ACTORS = ("S9", "S11")


def load_raw_h36m(root: str, split: str = "validation") -> Dict[str, np.ndarray]:
    """root: the directory holding the {actor}/{scene}/annot.h5 trees."""
    actors = TRAIN_ACTORS if split == "train" else VAL_ACTORS
    scenes: List[str] = []
    for actor in actors:
        scenes.extend(sorted(glob.glob(os.path.join(root, actor, "*"))))

    images: List[str] = []
    gt_j3d, gt_j2d, intrinsics = [], [], []
    gt_idx = np.asarray(constants.GT_2_J17)
    for scene in scenes:
        f = hdf5.File(os.path.join(scene, "annot.h5"))
        camera, frame = f.read("camera"), f.read("frame")
        images.extend(
            os.path.join(scene, "imageSequence", str(camera[i]), f"img_{frame[i]:06d}.jpg")
            for i in range(camera.shape[0])
        )
        gt_j2d.append(f.read("pose/2d")[:, gt_idx])
        gt_j3d.append(f.read("pose/3d")[:, gt_idx])
        intr = np.zeros((camera.shape[0], 3, 3), np.float32)
        params = {str(c): f.read(f"intrinsics/{c}") for c in np.unique(camera)}
        for i in range(camera.shape[0]):
            fx, cx, fy, cy = params[str(camera[i])][:4]
            intr[i, 0, 0], intr[i, 0, 2], intr[i, 1, 1], intr[i, 1, 2] = fx, cx, fy, cy
            intr[i, 2, 2] = 1.0
        intrinsics.append(intr)

    return {
        "images": np.asarray(images),
        "gt_j3d": np.concatenate(gt_j3d).astype(np.float32),
        "gt_j2d": np.concatenate(gt_j2d).astype(np.float32),
        "intrinsics": np.concatenate(intrinsics),
    }


def load_precomputed_outputs(out_dir: str) -> Dict[str, np.ndarray]:
    """Every completed shard of a previous run, joined along the frame axis
    ({} when none has completed)."""
    from jrr_tpu_torch.utils.checkpoint import ShardManifest

    man = ShardManifest(out_dir)
    shards = [man.read_shard(i) for i in man.completed()]
    if not shards:
        return {}
    return {k: np.concatenate([s[k] for s in shards]) for k in shards[0]}
