"""Build, load and launch the hand-written CUDA kernels (csrc/*.cu).

The library is compiled at first use with `nvcc` for sm_90a into `_build/`
(listed in .gitignore), one file per source hash, and loaded with ctypes:
pointers and the stream as c_void_p, ints as c_int, floats as c_float. Each
wrapper checks its tensors, allocates its outputs, launches on the current
stream, raises if the launch reported an error, and counts its launches in
a plain integer attribute `launches`. Wrappers take CUDA tensors only: the
plain versions live beside their callers in render/silhouette_fused.py.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent
SOURCE = _PKG / "csrc" / "silhouette_fused.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_LANES = 128
_MAX_PAGES = 32  # kMaxPages in the .cu source
_MAX_T2 = 256  # kMaxT2
_FIXED_SCALE = 2.0**32  # kFixedScale: the loss kernel's int64 gradient sums

_lib = None
build_info: dict = {}  # seconds and ptxas report of this process's build


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin)")
    return path


def build() -> Path:
    """Compile the kernel library if this source has no build yet; returns
    its path and records the build in `build_info`."""
    src = SOURCE.read_bytes()
    out = BUILD_DIR / f"libjrr_silhouette_{hashlib.sha256(src).hexdigest()[:16]}.so"
    if out.exists():
        return out
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    build_info.update(seconds=time.perf_counter() - t0, ptxas=proc.stderr)
    return out


def nvcc_release() -> str:
    """The toolkit release `nvcc --version` reports (e.g. "12.4")."""
    version = subprocess.run([_nvcc(), "--version"], capture_output=True, text=True).stdout
    m = re.search(r"release ([0-9.]+)", version)
    return m.group(1) if m else version.strip()


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.jrr_fused_alpha_fwd.argtypes = [p] * 6 + [i] * 5 + [f, f, i, p]
        lib.jrr_fused_alpha_fwd.restype = i
        lib.jrr_fused_lossgrad.argtypes = [p] * 9 + [i] * 5 + [f, f, i, p]
        lib.jrr_fused_lossgrad.restype = i
        lib.jrr_cuda_error_string.argtypes = [i]
        lib.jrr_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check_bins(tx, ty, pages, idx, origin, tile):
    """Validate the bins-contract tensors; returns (B, G², PG, P̂)."""
    dev = tx.device
    for name, t, dtype in (
        ("tx", tx, torch.float32), ("ty", ty, torch.float32), ("pages", pages, torch.int32),
        ("idx", idx, torch.int32), ("origin", origin, torch.float32),
    ):
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name} must be a CUDA tensor on {dev}, got {t.device}")
        if t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous {dtype}, got {t.dtype}")
    b, pg, lanes = tx.shape
    g2, p_hat = pages.shape[1:]
    if ty.shape != tx.shape or lanes != _LANES:
        raise ValueError(f"tables must be (B, PG, {_LANES}), got {tuple(tx.shape)}")
    if idx.shape != (b, g2, 3, _LANES):
        raise ValueError(f"idx must be (B, G², 3, {_LANES}), got {tuple(idx.shape)}")
    if pages.shape[0] != b or origin.shape != (b, g2, 2):
        raise ValueError("pages/origin batch or tile count disagree with idx")
    if not 1 <= p_hat <= _MAX_PAGES or not 1 <= tile * tile <= _MAX_T2:
        raise ValueError(f"need 1 <= P̂ <= {_MAX_PAGES} and tile² <= {_MAX_T2}")
    if b > 65535:
        raise ValueError("at most 65535 frames per launch")
    return b, g2, pg, p_hat


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        msg = _load().jrr_cuda_error_string(rc).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {rc} ({msg})")


def fused_alpha_fwd(tx, ty, pages, idx, origin, tile, inv_sigma, blur_px2, dump_page):
    """α tiles (B, G², T²) — replaces jrr_tpu silhouette_fused._fused_fwd_kernel."""
    b, g2, pg, p_hat = _check_bins(tx, ty, pages, idx, origin, tile)
    out = torch.empty(b, g2, tile * tile, device=tx.device, dtype=torch.float32)
    if b * g2 == 0:
        return out
    lib = _load()
    with torch.cuda.device(tx.device):
        rc = lib.jrr_fused_alpha_fwd(
            tx.data_ptr(), ty.data_ptr(), pages.data_ptr(), idx.data_ptr(),
            origin.data_ptr(), out.data_ptr(), b, g2, pg, p_hat, tile,
            inv_sigma, blur_px2, dump_page, torch.cuda.current_stream(tx.device).cuda_stream,
        )
        fused_alpha_fwd.launches += 1
    _raise_on(rc, "fused_alpha_fwd")
    return out


fused_alpha_fwd.launches = 0


def _fixed_point_bound(g2: int, tile: int, inv_sigma: float) -> float:
    """Largest |dΣerr/d(table entry)| the loss kernel can accumulate, for
    masks in [-1, 1]. Per (pixel, lane) and corner coordinate the kernel adds
    at most 4·|dL/dp|·inv_sigma·√dmin·p(1−p) with |dL/dp| ≤ 4 and
    p(1−p) ≤ exp(−dmin·inv_sigma), i.e. ≤ 16·0.43·√inv_sigma; an entry
    gathers at most T² pixels of every slot (G²·3·128) of its frame."""
    return 7.0 * math.sqrt(inv_sigma) * tile * tile * g2 * 3 * _LANES


def check_mask_range(mask_tiles) -> None:
    """Raise unless every mask value lies in [-1, 1], the range the overflow
    bound of the loss kernel's fixed-point sums assumes. On the card the
    check runs as a device-side assert, so the host does not wait for it."""
    torch._assert_async(
        torch.all((mask_tiles >= -1.0) & (mask_tiles <= 1.0)),
        "fused_lossgrad: mask values must lie in [-1, 1]",
    )


def fused_lossgrad(tx, ty, pages, idx, origin, mask_tiles, tile, inv_sigma, blur_px2, dump_page):
    """(err (B, G²), dtx, dty) — per occupied tile Σ(α − mask)² (0 for empty
    tiles) and dΣerr/d(tx, ty); replaces jrr_tpu
    silhouette_fused._fused_lossgrad_kernel. Mask values must lie in [-1, 1]
    (`check_mask_range`)."""
    b, g2, pg, p_hat = _check_bins(tx, ty, pages, idx, origin, tile)
    if (mask_tiles.device != tx.device or mask_tiles.dtype != torch.float32
            or not mask_tiles.is_contiguous() or mask_tiles.shape != (b, g2, tile * tile)):
        raise ValueError("mask_tiles must be contiguous f32 (B, G², T²) on the tables' device")
    if _fixed_point_bound(g2, tile, inv_sigma) >= 2.0**63 / _FIXED_SCALE:
        raise ValueError(f"gradient sums could overflow int64 fixed point (inv_sigma={inv_sigma})")
    check_mask_range(mask_tiles)
    err = torch.zeros(b, g2, device=tx.device, dtype=torch.float32)
    dtx = torch.zeros(tx.shape, device=tx.device, dtype=torch.int64)
    dty = torch.zeros(ty.shape, device=ty.device, dtype=torch.int64)
    if b * g2 == 0:
        return err, dtx.float(), dty.float()
    lib = _load()
    with torch.cuda.device(tx.device):
        rc = lib.jrr_fused_lossgrad(
            tx.data_ptr(), ty.data_ptr(), pages.data_ptr(), idx.data_ptr(),
            origin.data_ptr(), mask_tiles.data_ptr(), err.data_ptr(), dtx.data_ptr(),
            dty.data_ptr(), b, g2, pg, p_hat, tile, inv_sigma, blur_px2, dump_page,
            torch.cuda.current_stream(tx.device).cuda_stream,
        )
        fused_lossgrad.launches += 1
    _raise_on(rc, "fused_lossgrad")
    # int64 → f32 rounds once; the power-of-two scale is exact.
    return err, dtx.float().mul_(1.0 / _FIXED_SCALE), dty.float().mul_(1.0 / _FIXED_SCALE)


fused_lossgrad.launches = 0

# The wrappers whose launches a run can count, in the order they are reported.
WRAPPERS = (fused_lossgrad, fused_alpha_fwd)


def reset_launches() -> None:
    for w in WRAPPERS:
        w.launches = 0
