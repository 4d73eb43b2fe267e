"""Build, load and launch the hand-written CUDA kernels (csrc/*.cu).

The library is compiled at first use with `nvcc` for sm_90a into `_build/`
(listed in .gitignore), one file per hash of all sources and headers: one
`nvcc -c` per source, all started together, then one link. It is loaded
with ctypes: pointers and the stream as c_void_p, ints as c_int, floats as
c_float. Each wrapper checks its tensors, allocates its outputs, launches on
the current stream, raises if the launch reported an error, and counts its
launches in a plain integer attribute `launches`. Wrappers take CUDA tensors
only: the plain versions live beside their callers in render/.
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
CSRC = _PKG / "csrc"
SOURCES = tuple(sorted(CSRC.glob("*.cu")))
HEADERS = tuple(sorted(CSRC.glob("*.cuh")))
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_LANES = 128
_MAX_PAGES = 32  # kMaxPages in silhouette_fused.cu
_MAX_T2 = 256  # kMaxT2 in coverage.cuh
_FIXED_SCALE = 2.0**32  # kFixedScale: the fused gradient kernels' int64 sums

_lib = None
build_info: dict = {}  # seconds and ptxas report of this process's build


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin)")
    return path


def _sources_hash() -> str:
    h = hashlib.sha256()
    for path in SOURCES + HEADERS:
        h.update(path.name.encode() + b"\0" + path.read_bytes() + b"\0")
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernel library if these sources have no build yet;
    returns its path and records the build in `build_info`."""
    out = BUILD_DIR / f"libjrr_kernels_{_sources_hash()}.so"
    if out.exists():
        return out
    nvcc = _nvcc()
    obj_dir = BUILD_DIR / f"obj.{os.getpid()}"
    obj_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    objs = [obj_dir / f"{src.stem}.o" for src in SOURCES]
    procs = [
        subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for src, obj in zip(SOURCES, objs)
    ]
    reports = []
    for src, proc in zip(SOURCES, procs):
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src.name} ({proc.returncode}):\n{stdout}\n{stderr}")
        reports.append(f"== {src.name}\n{stderr}")
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    shutil.rmtree(obj_dir, ignore_errors=True)
    build_info.update(seconds=time.perf_counter() - t0, ptxas="".join(reports))
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
        for name, argtypes in (
            ("jrr_fused_alpha_fwd", [p] * 6 + [i] * 5 + [f, f, i, p]),
            ("jrr_fused_lossgrad", [p] * 9 + [i] * 5 + [f, f, i, p]),
            ("jrr_fused_alpha_bwd", [p] * 8 + [i] * 5 + [f, f, i, p]),
            ("jrr_tiles_alpha_fwd", [p] * 4 + [i] * 2 + [f, f, p]),
            ("jrr_tiles_alpha_bwd", [p] * 5 + [i] * 2 + [f, f, p]),
        ):
            getattr(lib, name).argtypes = argtypes
            getattr(lib, name).restype = i
        lib.jrr_cuda_error_string.argtypes = [i]
        lib.jrr_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check_cuda(dev, **tensors) -> None:
    """Raise unless every tensor is a contiguous CUDA tensor of its dtype on `dev`."""
    for name, (t, dtype) in tensors.items():
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name} must be a CUDA tensor on {dev}, got {t.device}")
        if t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous {dtype}, got {t.dtype}")


def _check_bins(tx, ty, pages, idx, origin, tile):
    """Validate the bins-contract tensors; returns (B, G², PG, P̂)."""
    f32, i32 = torch.float32, torch.int32
    _check_cuda(tx.device, tx=(tx, f32), ty=(ty, f32), pages=(pages, i32), idx=(idx, i32),
                origin=(origin, f32))
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


def _fixed_point_bound(g2: int, tile: int, inv_sigma: float, g_max: float = 4.0) -> float:
    """Largest |dL/d(table entry)| a fused gradient kernel can accumulate
    when |dL/dα| ≤ g_max per pixel (the loss kernel: |2(α − mask)| ≤ 4 for
    masks in [-1, 1]). Per (pixel, lane) and corner coordinate the kernel
    adds at most 4·|dL/dp|·inv_sigma·√dmin·p(1−p) with |dL/dp| ≤ g_max and
    p(1−p) ≤ exp(−dmin·inv_sigma), i.e. ≤ 1.75·g_max·√inv_sigma; an entry
    gathers at most T² pixels of every slot (G²·3·128) of its frame."""
    return 1.75 * g_max * math.sqrt(inv_sigma) * tile * tile * g2 * 3 * _LANES


def grad_limit(g2: int, tile: int, inv_sigma: float) -> float:
    """Largest |dL/dα| whose fixed-point sums cannot overflow int64 in
    `fused_alpha_bwd` (about 70 at 224²/tile 8, 140 at 112²/tile 4)."""
    return 2.0**63 / _FIXED_SCALE / _fixed_point_bound(g2, tile, inv_sigma, 1.0)


def check_mask_range(mask_tiles) -> None:
    """Raise unless every mask value lies in [-1, 1], the range the overflow
    bound of the loss kernel's fixed-point sums assumes. On the card the
    check runs as a device-side assert, so the host does not wait for it."""
    torch._assert_async(
        torch.all((mask_tiles >= -1.0) & (mask_tiles <= 1.0)),
        "fused_lossgrad: mask values must lie in [-1, 1]",
    )


def check_grad_range(g, limit: float) -> None:
    """Raise unless every |dL/dα| is below `limit` (`grad_limit`), the range
    in which the α VJP's fixed-point sums cannot overflow; a device-side
    assert on the card, as `check_mask_range`. NaN fails it too."""
    torch._assert_async(
        torch.all(g.abs() < limit), f"fused_alpha_bwd: |dL/dalpha| must stay below {limit:.6g}"
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


def fused_alpha_bwd(tx, ty, pages, idx, origin, g, tile, inv_sigma, blur_px2, dump_page):
    """(dtx, dty) (B, PG, 128) — the VJP of `fused_alpha_fwd` for
    g = dL/dα (B, G², T²); replaces jrr_tpu
    silhouette_fused._fused_bwd_kernel. |g| must stay below `grad_limit`
    (`check_grad_range`)."""
    b, g2, pg, p_hat = _check_bins(tx, ty, pages, idx, origin, tile)
    _check_cuda(tx.device, g=(g, torch.float32))
    if g.shape != (b, g2, tile * tile):
        raise ValueError(f"g must be (B, G², T²) = {(b, g2, tile * tile)}, got {tuple(g.shape)}")
    check_grad_range(g, grad_limit(g2, tile, inv_sigma))
    dtx = torch.zeros(tx.shape, device=tx.device, dtype=torch.int64)
    dty = torch.zeros(ty.shape, device=ty.device, dtype=torch.int64)
    if b * g2 == 0:
        return dtx.float(), dty.float()
    lib = _load()
    with torch.cuda.device(tx.device):
        rc = lib.jrr_fused_alpha_bwd(
            tx.data_ptr(), ty.data_ptr(), pages.data_ptr(), idx.data_ptr(),
            origin.data_ptr(), g.data_ptr(), dtx.data_ptr(), dty.data_ptr(),
            b, g2, pg, p_hat, tile, inv_sigma, blur_px2, dump_page,
            torch.cuda.current_stream(tx.device).cuda_stream,
        )
        fused_alpha_bwd.launches += 1
    _raise_on(rc, "fused_alpha_bwd")
    return dtx.float().mul_(1.0 / _FIXED_SCALE), dty.float().mul_(1.0 / _FIXED_SCALE)


fused_alpha_bwd.launches = 0


def _check_tiles(origin, tri, valid, tile) -> int:
    """Validate the round-1 packed tile tensors; returns the tile count N."""
    f32 = torch.float32
    _check_cuda(origin.device, origin=(origin, f32), tri=(tri, f32), valid=(valid, f32))
    n = origin.shape[0]
    if origin.shape != (n, 2) or tri.shape != (n, 6, _LANES) or valid.shape != (n, 1, _LANES):
        raise ValueError(
            f"need origin (N, 2), tri (N, 6, {_LANES}), valid (N, 1, {_LANES}); got "
            f"{tuple(origin.shape)}, {tuple(tri.shape)}, {tuple(valid.shape)}"
        )
    if not 1 <= tile * tile <= _MAX_T2:
        raise ValueError(f"need tile² <= {_MAX_T2}")
    if n >= 2**31:
        raise ValueError("at most 2³¹ − 1 tiles per launch")
    return n


def tiles_alpha_fwd(origin, tri, valid, tile, inv_sigma, blur_px2):
    """α (N, T²) of pre-gathered triangle rows — replaces jrr_tpu
    silhouette_pallas._fwd_kernel."""
    n = _check_tiles(origin, tri, valid, tile)
    out = torch.empty(n, tile * tile, device=origin.device, dtype=torch.float32)
    if n == 0:
        return out
    lib = _load()
    with torch.cuda.device(origin.device):
        rc = lib.jrr_tiles_alpha_fwd(
            origin.data_ptr(), tri.data_ptr(), valid.data_ptr(), out.data_ptr(), n, tile,
            inv_sigma, blur_px2, torch.cuda.current_stream(origin.device).cuda_stream,
        )
        tiles_alpha_fwd.launches += 1
    _raise_on(rc, "tiles_alpha_fwd")
    return out


tiles_alpha_fwd.launches = 0


def tiles_alpha_bwd(origin, tri, valid, g, tile, inv_sigma, blur_px2):
    """dL/dtri (N, 6, 128) for g = dL/dα (N, T²) — replaces jrr_tpu
    silhouette_pallas._bwd_kernel (exact-argmin tie routing)."""
    n = _check_tiles(origin, tri, valid, tile)
    _check_cuda(origin.device, g=(g, torch.float32))
    if g.shape != (n, tile * tile):
        raise ValueError(f"g must be (N, T²) = {(n, tile * tile)}, got {tuple(g.shape)}")
    dtri = torch.empty(tri.shape, device=tri.device, dtype=torch.float32)
    if n == 0:
        return dtri
    lib = _load()
    with torch.cuda.device(origin.device):
        rc = lib.jrr_tiles_alpha_bwd(
            origin.data_ptr(), tri.data_ptr(), valid.data_ptr(), g.data_ptr(), dtri.data_ptr(),
            n, tile, inv_sigma, blur_px2, torch.cuda.current_stream(origin.device).cuda_stream,
        )
        tiles_alpha_bwd.launches += 1
    _raise_on(rc, "tiles_alpha_bwd")
    return dtri


tiles_alpha_bwd.launches = 0

# The wrappers whose launches a run can count, in the order they are reported.
WRAPPERS = (fused_lossgrad, fused_alpha_fwd, fused_alpha_bwd, tiles_alpha_fwd, tiles_alpha_bwd)


def reset_launches() -> None:
    for w in WRAPPERS:
        w.launches = 0
