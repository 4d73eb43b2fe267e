"""The production input pipeline on the host runtime (counterpart of
jrr_tpu/data/native_pipeline.py:22-174).

`pack_dataset` turns a converted-layout split (tensors.npz + PNG or JPEG
frames and masks, see data/h36m.py) into one memory-mapped `frames.jrrpack`
of raw uint8 frames; `build_pack2` warps every frame's two crops once into
`frames.jrrpack2`, so that a load is a u8→f32 copy. `PackedH36MDataset`
then serves the reference's 13-key batch contract with the decode and warp
work in the runtime's threads (jrr_tpu_torch/runtime), which release the
interpreter lock: no Python runs per frame. The pack files are jrr_tpu's,
byte for byte.

One quirk of jrr_tpu's native path is kept on purpose: `load_batch` returns
the stored intrinsics, where H36MDataset returns the crop's. Nothing
downstream reads them.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

from jrr_tpu_torch import constants, runtime
from jrr_tpu_torch.data import h36m as h36m_lib


def pack_dataset(root: str, split: str = "validation", out_path: Optional[str] = None) -> str:
    """One-time: the split's frames and masks → a v1 pack (`frames.jrrpack`
    in the split's directory unless `out_path` is given); returns its path."""
    ds = h36m_lib.H36MDataset(root, split)
    if out_path is None:
        out_path = os.path.join(ds.dir, "frames.jrrpack")
    if len(ds) == 0:
        raise ValueError(f"{ds.dir}: no frames to pack")
    writer, shapes = None, None
    try:
        for i in range(len(ds)):
            image, mask = ds.read_frame_u8(i)
            if mask.ndim != 2:  # jrr_tpu keeps the (H, W, C) mask's first row
                mask = mask[0]
            if writer is None:
                shapes = (image.shape, mask.shape)
                writer = runtime.PackWriter(out_path, len(ds), *image.shape, *mask.shape)
            elif (image.shape, mask.shape) != shapes:
                raise ValueError(f"frame {i} is {image.shape} with a {mask.shape} mask; "
                                 f"a pack holds one size, {shapes}")
            writer.append(image, mask)
    finally:
        if writer is not None:
            writer.close()
    return out_path


def build_pack2(
    root: str, split: str = "validation", out_path: Optional[str] = None,
    chunk: int = 256, num_threads: int = 0,
) -> str:
    """One-time: the v1 pack (built first if missing) → the pre-warped v2
    pack: the runtime's warp over every frame at the dataset's own static
    bboxes, its crops quantized to uint8, with the crop meta."""
    ds = h36m_lib.H36MDataset(root, split)
    pack_path = os.path.join(ds.dir, "frames.jrrpack")
    if not os.path.exists(pack_path):
        pack_path = pack_dataset(root, split)
    reader = runtime.PackReader(pack_path, num_threads=num_threads)
    if out_path is None:
        out_path = os.path.join(ds.dir, "frames.jrrpack2")

    def q(x):
        return np.clip(np.rint(x * 255.0), 0, 255).astype(np.uint8)

    n = len(ds)
    writer = runtime.Pack2Writer(out_path, n, constants.CROP_RES, constants.IMAGE_CROP_RES,
                                 reader.img_c, reader.mask_h, reader.mask_w)
    try:
        for i0 in range(0, n, chunk):
            idx = np.arange(i0, min(i0 + chunk, n))
            nb = reader.load_batch(idx, ds.tensors["bboxes"][idx].astype(np.float32),
                                   spin_res=constants.CROP_RES, img_res=constants.IMAGE_CROP_RES)
            meta = np.stack([nb["min_x"], nb["min_y"], nb["scale"]], axis=1)
            writer.append(q(nb["spin_image"]), q(nb["image"]), q(nb["mask"]), meta)
    finally:
        writer.close()
        reader.close()
    return out_path


class PackedH36MDataset:
    """Batch-level dataset over a pack (used directly, not through
    BatchLoader: the runtime assembles whole batches).

    `prewarped="auto"` reads frames.jrrpack2 when it exists, else the raw
    frames.jrrpack; True builds the v2 pack on first use; False reads the v1
    pack (decode + warp per load). A missing v1 pack is built."""

    def __init__(self, root: str, split: str = "validation", num_threads: int = 0,
                 prewarped="auto"):
        if prewarped not in ("auto", True, False):
            raise ValueError(f"prewarped={prewarped!r}: 'auto', True or False")
        self.base = h36m_lib.H36MDataset(root, split)
        pack2_path = os.path.join(self.base.dir, "frames.jrrpack2")
        if prewarped is True and not os.path.exists(pack2_path):
            build_pack2(root, split, num_threads=num_threads)
        self.prewarped = prewarped is True or (
            prewarped == "auto" and os.path.exists(pack2_path))
        if self.prewarped:
            self.reader = runtime.Pack2Reader(pack2_path, num_threads=num_threads)
            return
        pack_path = os.path.join(self.base.dir, "frames.jrrpack")
        if not os.path.exists(pack_path):
            pack_path = pack_dataset(root, split)
        self.reader = runtime.PackReader(pack_path, num_threads=num_threads)

    def __len__(self) -> int:
        return len(self.base)

    def frame_order(self):
        """Temporal identity (seq_ids, frame_nos) or None, from the base
        dataset: the pack stores frames by dataset index."""
        return self.base.frame_order()

    def load_batch(self, indices) -> Dict[str, np.ndarray]:
        t = self.base.tensors
        idx = np.asarray(indices)
        bboxes = t["bboxes"][idx].astype(np.float32)
        if self.prewarped:
            native = self.reader.load_batch(idx)  # bboxes baked in at build
        else:
            native = self.reader.load_batch(
                idx, bboxes, spin_res=constants.CROP_RES, img_res=constants.IMAGE_CROP_RES)

        mask = native["mask"]
        valid = mask[:, 0, 0] != 0
        mask[:, :2, :2] = 0  # the valid-flag marker (reference: scripts/data.py:130-132)

        # j2d into crop coordinates; the runtime's scale is normalized by the
        # pack's own width, the reference's by IMG_RES.
        j2d = t["gt_j2d"][idx].astype(np.float32).copy()
        factor = constants.IMG_RES / constants.CROP_RES
        j2d[..., 0] = (j2d[..., 0] - native["min_x"][:, None]) / native["scale"][:, None] / factor
        j2d[..., 1] = (j2d[..., 1] - native["min_y"][:, None]) / native["scale"][:, None] / factor

        return {
            "bboxes": bboxes,
            "betas": t["betas"][idx].astype(np.float32),
            "cam": t["estimated_translation"][idx].astype(np.float32),
            "gt_j2d": j2d,
            "gt_j3d": t["gt_j3d"][idx].astype(np.float32),
            "valid": valid,
            "mask_rcnn": mask[:, None],
            "image": native["image"],
            "spin_image": native["spin_image"],
            "intrinsics": t["intrinsics"][idx].astype(np.float32),  # stored, not the crop's
            "orient": t["orient"][idx].astype(np.float32),
            "pose": t["pose"][idx].astype(np.float32),
            "inc_gt": np.ones(len(idx), bool),
        }

    def batches(
        self, batch_size: int, seed: int = 0, shuffle: bool = True,
        drop_last: bool = True, num_hosts: int = 1, host_id: int = 0,
        epoch: int = 0,
    ):
        """Batches of one epoch: the (seed, epoch) permutation BatchLoader
        uses, every host computing it and taking its contiguous slice."""
        n = len(self)
        order = np.arange(n)
        if shuffle:
            order = np.random.default_rng((seed, epoch)).permutation(n)
        per = n // num_hosts
        order = order[host_id * per : (host_id + 1) * per]
        for i in range(0, len(order), batch_size):
            chunk = order[i : i + batch_size]
            if drop_last and len(chunk) < batch_size:
                break
            yield self.load_batch(chunk)
