"""Human3.6M precomputed-tensor dataset reader (counterpart of
jrr_tpu/data/h36m.py:45-324; reference scripts/data.py:28-163).

A split directory holds per-frame tensors (bboxes, betas,
estimated_translation, gt_j2d, gt_j3d, intrinsics, orient, pose: N leading)
in tensors.npz, the frame paths in images.json, and on disk the 1000² PNG
frames and their silhouette masks (mask path = image path with
imageSequence → maskSequence). Each item is the reference's 13-key dict:
two bilinear crops (224 SPIN crop, 256 image crop), GT 2D joints moved into
crop coordinates, intrinsics updated for the crop, and the `valid` flag
read from the mask's top-left marker pixel (the marker then zeroed).

Host side only: everything returns numpy, crops run on the CPU. Frames and
masks are PNG (`data/png.py`) or baseline JPEG (`runtime.decode_jpeg`, the
real dataset's format), read without an image library. When the root holds
a `data.h5` beside a split that lists images.json, frames and masks come
from that one file instead (the reference's --compute_canada layout,
scripts/data.py:92-107), read by `data/hdf5.py`: the image at the key of
the image path's last five parts, stored (C, H, W) and used as stored, the
mask at the same key with maskSequence in its third part, divided by 255.
"""

from __future__ import annotations

import json
import os
import queue as queue_mod
import re
import threading
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from jrr_tpu_torch import constants, runtime
from jrr_tpu_torch.data import crop as crop_lib
from jrr_tpu_torch.data import hdf5, png

TENSOR_KEYS = (
    "bboxes", "betas", "estimated_translation", "gt_j2d", "gt_j3d",
    "intrinsics", "orient", "pose",
)


def convert_precomputed_pt(src_dir: str, dst_dir: str) -> None:
    """One-time converter: the reference's torch .pt/.pkl directory → .npz/.json."""
    import pickle

    os.makedirs(dst_dir, exist_ok=True)
    arrays = {}
    for key in TENSOR_KEYS:
        t = torch.load(os.path.join(src_dir, f"{key}.pt"), map_location="cpu")
        arrays[key] = t.numpy()
    np.savez(os.path.join(dst_dir, "tensors.npz"), **arrays)
    for name in ("images", "pixel_annotations"):
        p = os.path.join(src_dir, f"{name}.pkl")
        if os.path.exists(p):
            with open(p, "rb") as f:
                paths = pickle.load(f)
            with open(os.path.join(dst_dir, f"{name}.json"), "w") as f:
                json.dump(list(paths), f)


def _crop_np(image_chw: np.ndarray, bbox: np.ndarray, intrinsics: np.ndarray, img_size: int):
    """Single-frame crop on the host CPU: (image, min_x, min_y, scale, intrinsics)."""
    res = crop_lib.find_crop(
        torch.as_tensor(np.asarray(image_chw, np.float32))[None],
        torch.as_tensor(np.asarray(bbox, np.float32))[None],
        torch.as_tensor(np.asarray(intrinsics, np.float32))[None],
        img_size=img_size,
    )
    return (
        res.image[0].numpy(), float(res.min_x[0]), float(res.min_y[0]), float(res.scale[0]),
        res.intrinsics[0].numpy(),
    )


def read_image(path: str) -> np.ndarray:
    """A frame or mask file → uint8 (H, W[, C]), as imageio.v2.imread reads
    it: .png through data/png.py, .jpg/.jpeg through the runtime's decoder."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".png":
        return png.read(path)
    if ext in (".jpg", ".jpeg"):
        return runtime.decode_jpeg(path)
    raise NotImplementedError(f"{path}: frames are read from .png, .jpg or .jpeg files")


class H36MDataset:
    """Reads one split directory (converted layout)."""

    def __init__(self, root: str, split: str = "validation"):
        sub = "precomputed_train" if split == "train" else "precomputed_val"
        self.dir = os.path.join(root, sub)
        with np.load(os.path.join(self.dir, "tensors.npz")) as f:
            self.tensors = {k: f[k] for k in f.files}
        img_json = os.path.join(self.dir, "images.json")
        self.images: Optional[List[str]] = None
        if os.path.exists(img_json):
            with open(img_json) as f:
                self.images = json.load(f)
        self.h5_path = os.path.join(root, "data.h5")
        self.use_h5 = os.path.exists(self.h5_path) and self.images is not None
        # Indexed once here; group tables and dataset headers fill in as read.
        self.h5 = hdf5.File(self.h5_path) if self.use_h5 else None

    def __len__(self) -> int:
        return self.tensors["gt_j3d"].shape[0]

    def frame_order(self) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """Temporal identity of every frame: (seq_ids, frame_nos) int arrays,
        from seq_id/frame_id in tensors.npz, else from the image paths
        (sequence = directory, frame = trailing integer of the file name);
        None when neither is there."""
        t = self.tensors
        if "seq_id" in t and "frame_id" in t:
            return t["seq_id"].astype(np.int64), t["frame_id"].astype(np.int64)
        if self.images is not None:
            seq_of: Dict[str, int] = {}
            seq_ids = np.empty(len(self.images), np.int64)
            frame_nos = np.empty(len(self.images), np.int64)
            for i, p in enumerate(self.images):
                d, b = os.path.split(p)
                seq_ids[i] = seq_of.setdefault(d, len(seq_of))
                digits = re.findall(r"\d+", b)
                frame_nos[i] = int(digits[-1]) if digits else i
            return seq_ids, frame_nos
        return None

    def load_batch(self, indices) -> Dict[str, np.ndarray]:
        """Stack arbitrary frame indices into one batch dict."""
        return _stack([self[int(i)] for i in indices])

    def read_frame_u8(self, index: int):
        """(image (H, W, C) uint8 cut to the first 1000² pixels, mask (Hm, Wm)
        uint8 as stored); zeros when the split lists no image files. In the
        h5 mode: jrr_tpu's pack conversion of the float frame,
        (image · 255) and (mask · 255) truncated to uint8, the mask (1, Hm, Wm)."""
        if self.images is None:
            r = constants.IMG_RES
            return (np.zeros((r, r, 3), np.uint8),
                    np.zeros((constants.CROP_RES, constants.CROP_RES), np.uint8))
        if self.use_h5:
            image, mask = self._read_h5(index)
            return ((np.transpose(image, (1, 2, 0)) * 255).astype(np.uint8),
                    (mask * 255).astype(np.uint8))
        path = self.images[index]
        image = read_image(path)[: constants.IMG_RES, : constants.IMG_RES]
        head, tail = path.split("imageSequence")
        return image, read_image(f"{head}maskSequence{tail}")

    def _read_h5(self, index: int):
        """(image as stored, float32; mask / 255, float32, (1, Hm, Wm))
        from data.h5 (jrr_tpu/data/h36m.py:152-161)."""
        parts = self.images[index].split("/")[-5:]
        image = self.h5.read("/".join(parts)).astype(np.float32)
        mask = self.h5.read("/".join(parts[:2] + ["maskSequence"] + parts[3:])) / 255.0
        if mask.ndim == 2:
            mask = mask[None]
        return image, mask.astype(np.float32)

    def _read_frame_images(self, index: int):
        """Returns (image (3, 1000, 1000) float [0,1], mask (1, Hm, Wm))."""
        if self.use_h5:
            return self._read_h5(index)
        image, mask = self.read_frame_u8(index)
        image = np.transpose(image, (2, 0, 1)).astype(np.float32) / 255.0
        mask = mask.astype(np.float32) / 255.0
        if mask.ndim == 2:
            mask = mask[None]
        return image.astype(np.float32), mask.astype(np.float32)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        t = self.tensors
        image, mask = self._read_frame_images(index)

        # The valid flag lives in the mask's top-left pixel; zero the marker
        # (reference: scripts/data.py:130-132).
        valid = bool(mask[0, 0, 0] != 0)
        mask = mask.copy()
        mask[:, :2, :2] = 0

        bbox = t["bboxes"][index]
        intr = t["intrinsics"][index]
        spin_image, *_ = _crop_np(image, bbox, intr, constants.CROP_RES)
        image_crop, min_x, min_y, scale, new_intr = _crop_np(
            image, bbox, intr, constants.IMAGE_CROP_RES
        )

        ratio = constants.IMG_RES / constants.CROP_RES
        j2d = t["gt_j2d"][index].astype(np.float32).copy()
        j2d[..., 0] = (j2d[..., 0] - min_x) / scale / ratio
        j2d[..., 1] = (j2d[..., 1] - min_y) / scale / ratio

        return {
            "bboxes": bbox.astype(np.float32),
            "betas": t["betas"][index].astype(np.float32),
            "cam": t["estimated_translation"][index].astype(np.float32),
            "gt_j2d": j2d,
            "gt_j3d": t["gt_j3d"][index].astype(np.float32),
            "valid": valid,
            "mask_rcnn": mask,
            "image": image_crop,
            "spin_image": spin_image,
            "intrinsics": new_intr.astype(np.float32),
            "orient": t["orient"][index].astype(np.float32),
            "pose": t["pose"][index].astype(np.float32),
            "inc_gt": True,
        }


def _stack(items) -> Dict[str, np.ndarray]:
    out = {}
    for k in items[0]:
        vals = [it[k] for it in items]
        out[k] = np.stack(vals) if isinstance(vals[0], np.ndarray) else np.asarray(vals)
    return out


class BatchLoader:
    """Shuffling, prefetching batch iterator (reference:
    scripts/optimize.py:136-139). Every host computes the same permutation
    from (seed, epoch) and takes its contiguous slice. Batches load on a
    background thread; an exception there is raised in the consumer."""

    def __init__(
        self, dataset, batch_size: int, seed: int = 0, shuffle: bool = True,
        drop_last: bool = False, num_hosts: int = 1, host_id: int = 0,
        prefetch: int = 2,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.seed = seed
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_hosts = num_hosts
        self.host_id = host_id
        self.prefetch = prefetch
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        """Reseed the shuffle per epoch: a permutation derived from (seed, epoch)."""
        self.epoch = int(epoch)

    def _indices(self) -> np.ndarray:
        n = len(self.dataset)
        idx = np.arange(n)
        if self.shuffle:
            idx = np.random.default_rng((self.seed, self.epoch)).permutation(n)
        per_host = n // self.num_hosts
        return idx[self.host_id * per_host : (self.host_id + 1) * per_host]

    def __len__(self) -> int:
        n = len(self._indices())
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _load_batch(self, batch_idx: np.ndarray) -> Dict[str, np.ndarray]:
        return _stack([self.dataset[int(i)] for i in batch_idx])

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        idx = self._indices()
        batches = [idx[i : i + self.batch_size] for i in range(0, len(idx), self.batch_size)]
        if self.drop_last:
            batches = [b for b in batches if len(b) == self.batch_size]
        return background_iter(map(self._load_batch, batches), self.prefetch)


def background_iter(iterable, depth: int = 2):
    """Iterate `iterable` on a background thread through a queue of `depth`
    items. An exception in the thread is raised in the consumer; closing the
    generator early (or an exception in the consumer) stops the thread."""
    q: queue_mod.Queue = queue_mod.Queue(maxsize=max(1, depth))
    done, stop = object(), threading.Event()
    err: list = []

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue_mod.Full:
                continue
        return False

    def worker():
        try:
            for item in iterable:
                if not put(item):
                    return
        except BaseException as e:  # handed to the consumer, which raises it
            err.append(e)
        put(done)

    def consume():
        thread = threading.Thread(target=worker, daemon=True)
        thread.start()
        try:
            while True:
                item = q.get()
                if item is done:
                    if err:
                        raise err[0]
                    return
                yield item
        finally:
            stop.set()
            thread.join()

    return consume()


def sequence_chunk_indices(
    seq_ids: np.ndarray, frame_nos: np.ndarray, seqlen: int
) -> np.ndarray:
    """(num_chunks, seqlen) dataset indices for the sequence-consumer eval.

    Per sequence: frames sorted by frame number, truncated to a multiple of
    `seqlen` (the reference's chunking drops remainders too, reference:
    scripts/test.py:254-273). Chunks never cross a sequence boundary."""
    chunks = []
    for s in np.unique(seq_ids):
        idx = np.nonzero(seq_ids == s)[0]
        idx = idx[np.argsort(frame_nos[idx], kind="stable")]
        n = (len(idx) // seqlen) * seqlen
        if n:
            chunks.append(idx[:n].reshape(-1, seqlen))
    if not chunks:
        return np.zeros((0, seqlen), np.int64)
    return np.concatenate(chunks, axis=0)


def ordered_sequence_batches(
    load_fn, order: Tuple[np.ndarray, np.ndarray], batch_size: int, seqlen: int
) -> Iterator[Dict[str, np.ndarray]]:
    """Non-shuffling batches for `evaluate_consumer_sequences`: each joins
    whole temporally ordered chunks (a multiple of `seqlen` frames, never
    crossing a sequence), at most `batch_size` frames per batch.

    `load_fn(indices) -> batch dict`, e.g. `H36MDataset.load_batch`;
    `order` is the dataset's `frame_order()`."""
    chunks = sequence_chunk_indices(order[0], order[1], seqlen)
    per = max(1, batch_size // seqlen)
    for i in range(0, len(chunks), per):
        yield load_fn(chunks[i : i + per].reshape(-1))
