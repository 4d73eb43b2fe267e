"""ctypes bindings and build of the host runtime (counterpart of
jrr_tpu/runtime/__init__.py): the pack readers and writers, the threaded
bilinear crop warp, and a baseline JPEG decoder (`decode_jpeg`).

`jrr_runtime.cc` says what lives natively and why. The library builds at
first use with g++ (the flags of jrr_tpu's build, so both give the same
floats) into `jrr_tpu_torch/_build/`, again whenever the source is newer
than the library; a failed build raises with g++'s output. Every call
releases the interpreter lock while the native code runs.
"""

from __future__ import annotations

import ctypes
import os
import struct
import subprocess
import tempfile
import threading
from typing import Optional, Tuple, Union

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "jrr_runtime.cc")
_BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
_LIB = os.path.join(_BUILD_DIR, "libjrr_runtime.so")
GXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-shared", "-fPIC", "-pthread")
_MAGIC = 0x314B434150525252
_MAGIC2 = 0x324B434150525252
_HEADER = "<QQIIIII4x"  # magic, frames, then five uint32 (40 bytes)

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def default_threads() -> int:
    """The readers' and the warp's thread count unless one is given."""
    return min(8, os.cpu_count() or 1)


def build_library(force: bool = False) -> str:
    """Compile jrr_runtime.cc into _build/ when the library is missing or
    older than the source; returns its path. Concurrent builds (test
    workers) each write a file of their own and rename it into place."""
    with _lock:
        if force or not os.path.exists(_LIB) or os.path.getmtime(_LIB) < os.path.getmtime(_SRC):
            os.makedirs(_BUILD_DIR, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
            os.close(fd)
            try:
                proc = subprocess.run(["g++", *GXX_FLAGS, _SRC, "-o", tmp],
                                      capture_output=True, text=True)
            except FileNotFoundError as e:
                os.remove(tmp)
                raise RuntimeError("g++ not found: the host runtime cannot be built") from e
            if proc.returncode != 0:
                os.remove(tmp)
                raise RuntimeError(
                    f"g++ failed to build {_SRC} ({proc.returncode}):\n{proc.stderr}")
            os.replace(tmp, _LIB)
    return _LIB


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(build_library())
    p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    signatures = {
        "jrr_warp_batch": (None, [p, i64, i, i, i, p, p, i, i, i]),
        "jrr_pack_open": (p, [ctypes.c_char_p]),
        "jrr_pack_num_frames": (i64, [p]),
        "jrr_pack_close": (None, [p]),
        "jrr_pack_load_batch": (None, [p, p, i64, p, p, i, p, i, p, p, i]),
        "jrr_pack2_open": (p, [ctypes.c_char_p]),
        "jrr_pack2_num_frames": (i64, [p]),
        "jrr_pack2_close": (None, [p]),
        "jrr_pack2_load_batch": (None, [p, p, i64, p, p, p, p, i]),
        "jrr_jpeg_info": (i, [p, i64, p, p, p, p, i]),
        "jrr_decode_jpeg": (i, [p, i64, p, i64, p, i]),
    }
    for name, (restype, argtypes) in signatures.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes
    _lib = lib
    return lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def _threads(num_threads: int) -> int:
    return num_threads if num_threads > 0 else default_threads()


def warp_batch(
    images_u8: np.ndarray, homographies: np.ndarray, out_shape: Tuple[int, int],
    num_threads: int = 0,
) -> np.ndarray:
    """(B, H, W, C) uint8 + (B, 3, 3) → (B, C, OH, OW) float32 in [0, 1]."""
    lib = _load()
    images_u8 = np.ascontiguousarray(images_u8, dtype=np.uint8)
    homo = np.ascontiguousarray(homographies, dtype=np.float32)
    b, h, w, c = images_u8.shape
    if homo.shape != (b, 3, 3):
        raise ValueError(f"homographies of shape {homo.shape} for {b} images")
    oh, ow = out_shape
    out = np.empty((b, c, oh, ow), np.float32)
    lib.jrr_warp_batch(_ptr(images_u8), b, h, w, c, _ptr(homo), _ptr(out), oh, ow,
                       _threads(num_threads))
    return out


class PackWriter:
    """Streaming writer of the raw-frame pack (v1): a 40-byte header, then
    per frame the (H, W, C) uint8 image and the (MH, MW) uint8 mask."""

    def __init__(self, path: str, num_frames: int, img_h: int, img_w: int, img_c: int,
                 mask_h: int, mask_w: int):
        self._f = open(path, "wb")
        self._f.write(struct.pack(_HEADER, _MAGIC, num_frames, img_h, img_w, img_c,
                                  mask_h, mask_w))

    def append(self, image_u8: np.ndarray, mask_u8: np.ndarray) -> None:
        self._f.write(np.ascontiguousarray(image_u8, dtype=np.uint8).tobytes())
        self._f.write(np.ascontiguousarray(mask_u8, dtype=np.uint8).tobytes())

    def close(self) -> None:
        self._f.close()


def write_pack(path: str, images_u8: np.ndarray, masks_u8: np.ndarray) -> None:
    """One-shot v1 pack: (N, H, W, C) images + (N, MH, MW) masks, uint8."""
    n, h, w, c = images_u8.shape
    writer = PackWriter(path, n, h, w, c, *masks_u8.shape[1:])
    try:
        for image, mask in zip(images_u8, masks_u8):
            writer.append(image, mask)
    finally:
        writer.close()


class Pack2Writer:
    """Streaming writer of the pre-warped pack (v2): per frame the uint8 CHW
    crops with the warp already applied and the float32 crop meta. Decode
    and warp are paid once here; `Pack2Reader.load_batch` is then a u8→f32
    conversion."""

    def __init__(self, path: str, num_frames: int, spin_res: int, img_res: int,
                 channels: int, mask_h: int, mask_w: int):
        self._f = open(path, "wb")
        self._f.write(struct.pack(_HEADER, _MAGIC2, num_frames, spin_res, img_res, channels,
                                  mask_h, mask_w))

    def append(self, spin_u8: np.ndarray, image_u8: np.ndarray,
               mask_u8: np.ndarray, meta_f32: np.ndarray) -> None:
        """A chunk of frames: (B,C,S,S) + (B,C,I,I) + (B,MH,MW) u8, (B,3) f32."""
        for k in range(spin_u8.shape[0]):
            self._f.write(np.ascontiguousarray(spin_u8[k]).tobytes())
            self._f.write(np.ascontiguousarray(image_u8[k]).tobytes())
            self._f.write(np.ascontiguousarray(mask_u8[k]).tobytes())
            self._f.write(np.ascontiguousarray(meta_f32[k], dtype=np.float32).tobytes())

    def close(self) -> None:
        self._f.close()


def write_pack2(path: str, spin_u8: np.ndarray, image_u8: np.ndarray, mask_u8: np.ndarray,
                meta_f32: np.ndarray) -> None:
    """One-shot v2 pack (small datasets, tests); see Pack2Writer."""
    n, c, s, _ = spin_u8.shape
    writer = Pack2Writer(path, n, s, image_u8.shape[-1], c, mask_u8.shape[1], mask_u8.shape[2])
    try:
        writer.append(spin_u8, image_u8, mask_u8, np.asarray(meta_f32, np.float32))
    finally:
        writer.close()


class _Reader:
    """A memory-mapped pack opened through the runtime (`kind` "pack" or
    "pack2"); the header's five sizes become `fields`."""

    def __init__(self, path: str, kind: str, fields, num_threads: int):
        self._lib = _load()
        self._close_fn = getattr(self._lib, f"jrr_{kind}_close")
        self._handle = getattr(self._lib, f"jrr_{kind}_open")(os.fsencode(path))
        if not self._handle:
            raise IOError(f"failed to open {kind}: {path}")
        self.num_frames = int(getattr(self._lib, f"jrr_{kind}_num_frames")(self._handle))
        with open(path, "rb") as f:
            sizes = struct.unpack("<QQIIIII", f.read(36))[2:]
        for name, value in zip(fields, sizes):
            setattr(self, name, value)
        self.num_threads = _threads(num_threads)

    def _indices(self, indices) -> np.ndarray:
        idx = np.ascontiguousarray(indices, dtype=np.int64)
        if idx.ndim != 1 or (idx.size and (idx.min() < 0 or idx.max() >= self.num_frames)):
            raise IndexError(f"frame indices outside [0, {self.num_frames})")
        return idx

    @staticmethod
    def _result(spin, image, mask, meta):
        return {"spin_image": spin, "image": image, "mask": mask,
                "min_x": meta[:, 0].copy(), "min_y": meta[:, 1].copy(),
                "scale": meta[:, 2].copy()}

    def close(self) -> None:
        if self._handle:
            self._close_fn(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class PackReader(_Reader):
    """The raw-frame pack (v1), memory-mapped; batches warped by the
    runtime's threads."""

    def __init__(self, path: str, num_threads: int = 0):
        super().__init__(path, "pack", ("img_h", "img_w", "img_c", "mask_h", "mask_w"),
                         num_threads)

    def load_batch(self, indices, bboxes: np.ndarray, spin_res: int = 224,
                   img_res: int = 256):
        """dict(spin_image, image, mask, min_x, min_y, scale) for the frames
        `indices`, cropped to `bboxes` (B, 4) (min_y, min_x, max_y, max_x)."""
        idx = self._indices(indices)
        b = len(idx)
        bb = np.ascontiguousarray(bboxes, dtype=np.float32)
        if bb.shape != (b, 4):
            raise ValueError(f"bboxes of shape {bb.shape} for {b} frames")
        spin = np.empty((b, self.img_c, spin_res, spin_res), np.float32)
        image = np.empty((b, self.img_c, img_res, img_res), np.float32)
        mask = np.empty((b, self.mask_h, self.mask_w), np.float32)
        meta = np.empty((b, 3), np.float32)
        self._lib.jrr_pack_load_batch(
            self._handle, _ptr(idx), b, _ptr(bb), _ptr(spin), spin_res, _ptr(image), img_res,
            _ptr(mask), _ptr(meta), self.num_threads,
        )
        return self._result(spin, image, mask, meta)


class Pack2Reader(_Reader):
    """The pre-warped pack (v2), memory-mapped: a load is a u8→f32 copy."""

    def __init__(self, path: str, num_threads: int = 0):
        super().__init__(path, "pack2", ("spin_res", "img_res", "img_c", "mask_h", "mask_w"),
                         num_threads)

    def load_batch(self, indices):
        """The contract of PackReader.load_batch, the bboxes baked in."""
        idx = self._indices(indices)
        b = len(idx)
        spin = np.empty((b, self.img_c, self.spin_res, self.spin_res), np.float32)
        image = np.empty((b, self.img_c, self.img_res, self.img_res), np.float32)
        mask = np.empty((b, self.mask_h, self.mask_w), np.float32)
        meta = np.empty((b, 3), np.float32)
        self._lib.jrr_pack2_load_batch(
            self._handle, _ptr(idx), b, _ptr(spin), _ptr(image), _ptr(mask), _ptr(meta),
            self.num_threads,
        )
        return self._result(spin, image, mask, meta)


class JpegError(ValueError):
    """A file that is not a readable JPEG."""


def decode_jpeg(src: Union[str, os.PathLike, bytes]) -> np.ndarray:
    """A baseline JPEG (a path, or the file's bytes) → uint8 (H, W, 3), or
    (H, W) for a 1-component file, as imageio.v2.imread gives it.

    A feature outside the decoder's scope (progressive, arithmetic coding,
    lossless, 12-bit, CMYK, ...) raises NotImplementedError, a damaged file
    JpegError, each naming the file and the reason."""
    if isinstance(src, (bytes, bytearray, memoryview)):
        name, data = "<bytes>", bytes(src)
    else:
        name = os.fspath(src)
        with open(name, "rb") as f:
            data = f.read()
    lib = _load()
    buf = np.frombuffer(data, np.uint8)
    err = ctypes.create_string_buffer(256)
    dims = [ctypes.c_int() for _ in range(3)]

    def check(rc):
        if rc == 1:
            raise NotImplementedError(f"{name}: {err.value.decode()} is not supported")
        if rc != 0:
            raise JpegError(f"{name}: {err.value.decode()}")

    check(lib.jrr_jpeg_info(_ptr(buf), buf.size, *(ctypes.byref(x) for x in dims), err,
                            len(err)))
    h, w, c = (x.value for x in dims)
    out = np.empty((h, w, c) if c > 1 else (h, w), np.uint8)
    check(lib.jrr_decode_jpeg(_ptr(buf), buf.size, _ptr(out), out.size, err, len(err)))
    return out
