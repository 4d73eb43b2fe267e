"""Build, load and launch the hand-written CUDA kernels (csrc/*.cu).

The library is compiled at first use with `nvcc` for sm_90a into `_build/`
(listed in .gitignore), one file per hash of all sources and headers: one
`nvcc -c` per source, all started together, then one link. It is loaded
with ctypes: pointers and the stream as c_void_p, ints as c_int (element
counts as c_longlong), floats as c_float. Each wrapper checks its tensors,
allocates its outputs, launches on the current stream, raises if the launch
reported an error, and counts its launches in a plain integer attribute
`launches`. Wrappers take CUDA tensors only: the plain versions live beside
their callers in render/ and probes/.
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


def build(force: bool = False) -> Path:
    """Compile the kernel library if these sources have no build yet, or
    anew with `force`; returns its path and records the build in
    `build_info`."""
    out = BUILD_DIR / f"libjrr_kernels_{_sources_hash()}.so"
    if out.exists() and not force:
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
        p, i, f, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
        for name, argtypes in (
            ("jrr_fused_alpha_fwd", [p] * 6 + [i] * 5 + [f, f, i, p]),
            ("jrr_fused_lossgrad", [p] * 9 + [i] * 5 + [f, f, i, p]),
            ("jrr_fused_lossgrad_packed", [p] * 12 + [i] * 5 + [f, f, i, p]),
            ("jrr_fused_alpha_bwd", [p] * 8 + [i] * 5 + [f, f, i, p]),
            ("jrr_tiles_alpha_fwd", [p] * 4 + [i] * 2 + [f, f, p]),
            ("jrr_tiles_alpha_bwd", [p] * 5 + [i] * 2 + [f, f, p]),
            ("jrr_paged_gather_rmw", [p] * 6 + [i, i, i, f, p]),
            ("jrr_row_gather", [p] * 3 + [i, p]),
            ("jrr_dyn_slice", [p] * 3 + [i, i, p]),
            ("jrr_lane_gather", [p] * 3 + [i, i, p]),
            ("jrr_select_reduce", [p] * 3 + [i, p]),
            ("jrr_rmw_rows", [p] * 4 + [i, i, i, f, p]),
            ("jrr_elementwise", [p, p, ll, p]),
            ("jrr_fma_chain", [p, p, ll, i, i, p]),
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


def from_fixed_point(table):
    """An int64 fixed-point table (value·2³²) as float32: int64 → f32 rounds
    once; the power-of-two scale is exact."""
    return table.float().mul_(1.0 / _FIXED_SCALE)


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
    return err, from_fixed_point(dtx), from_fixed_point(dty)


fused_lossgrad.launches = 0


def fused_lossgrad_packed(tx, ty, pages, idx, origin, origin_b, flags, buddy, mask_tiles, tile,
                          inv_sigma, blur_px2, dump_page, k_half=64):
    """(err (B, G²), dtx, dty) on the lane-packed layout (`pack_bins`): per
    occupied row Σ(α − mask)², both tiles' for a primary row (0 for empty
    and buddy rows), and dΣerr/d(tx, ty); replaces jrr_tpu
    silhouette_fused._fused_lossgrad_packed_kernel. The kernel splits a
    row's 128 lanes on a warp boundary, so `k_half` must be 64. Mask values
    must lie in [-1, 1] and buddy ids in [0, G²) (device-side asserts)."""
    if k_half != _LANES // 2:
        raise ValueError(f"the packed kernel needs k_half == {_LANES // 2}, got {k_half}")
    b, g2, pg, p_hat = _check_bins(tx, ty, pages, idx, origin, tile)
    _check_cuda(tx.device, origin_b=(origin_b, torch.float32), flags=(flags, torch.int32),
                buddy=(buddy, torch.int32), mask_tiles=(mask_tiles, torch.float32))
    if origin_b.shape != (b, g2, 2) or flags.shape != (b, g2) or buddy.shape != (b, g2):
        raise ValueError("need origin_b (B, G², 2), flags and buddy (B, G²)")
    if mask_tiles.shape != (b, g2, tile * tile):
        raise ValueError("mask_tiles must be (B, G², T²)")
    if _fixed_point_bound(g2, tile, inv_sigma) >= 2.0**63 / _FIXED_SCALE:
        raise ValueError(f"gradient sums could overflow int64 fixed point (inv_sigma={inv_sigma})")
    check_mask_range(mask_tiles)
    torch._assert_async(torch.all((buddy >= 0) & (buddy < g2)),
                        "fused_lossgrad_packed: buddy ids must lie in [0, G²)")
    err = torch.zeros(b, g2, device=tx.device, dtype=torch.float32)
    dtx = torch.zeros(tx.shape, device=tx.device, dtype=torch.int64)
    dty = torch.zeros(ty.shape, device=ty.device, dtype=torch.int64)
    if b * g2 == 0:
        return err, dtx.float(), dty.float()
    lib = _load()
    with torch.cuda.device(tx.device):
        rc = lib.jrr_fused_lossgrad_packed(
            tx.data_ptr(), ty.data_ptr(), pages.data_ptr(), idx.data_ptr(), origin.data_ptr(),
            origin_b.data_ptr(), flags.data_ptr(), buddy.data_ptr(), mask_tiles.data_ptr(),
            err.data_ptr(), dtx.data_ptr(), dty.data_ptr(), b, g2, pg, p_hat, tile, inv_sigma,
            blur_px2, dump_page, torch.cuda.current_stream(tx.device).cuda_stream,
        )
        fused_lossgrad_packed.launches += 1
    _raise_on(rc, "fused_lossgrad_packed")
    return err, from_fixed_point(dtx), from_fixed_point(dty)


fused_lossgrad_packed.launches = 0


def fused_alpha_bwd(tx, ty, pages, idx, origin, g, tile, inv_sigma, blur_px2, dump_page):
    """(dtx, dty) (B, PG, 128) — the VJP of `fused_alpha_fwd` for
    g = dL/dα (B, G², T²); replaces jrr_tpu
    silhouette_fused._fused_bwd_kernel. The kernel runs `fused_lossgrad`'s
    near-pair passes with dL/dα read from g, so at g = 2·(α − mask), α from
    `fused_alpha_fwd`, it returns that kernel's gradients bit for bit. |g|
    must stay below `grad_limit` (`check_grad_range`)."""
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
    return from_fixed_point(dtx), from_fixed_point(dty)


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


# ---------------------------------------------------------------------------
# Probe kernels (csrc/probes.cu): the rasterizer's primitives one at a time,
# on N tile blocks of (8, 128); their plain versions are in probes/.
# ---------------------------------------------------------------------------

_PROBE_ROWS = 8  # kRows in probes.cu: rows per tile block, page ids per tile
_MAX_TABLE_ROWS = 64  # kMaxTableRows in probes.cu


def _probe_launch(wrapper, dev, entry: str, *args) -> None:
    """Call C entry `entry` on the current stream of `dev`, count the launch
    on `wrapper` and raise if the launch failed."""
    lib = _load()
    with torch.cuda.device(dev):
        rc = getattr(lib, entry)(*args, torch.cuda.current_stream(dev).cuda_stream)
        wrapper.launches += 1
    _raise_on(rc, entry)


def _check_blocks(**tensors) -> int:
    """Each tensor a contiguous CUDA (N, 8, 128) block array of its dtype,
    all on one device; returns N."""
    first = next(iter(tensors.values()))[0]
    _check_cuda(first.device, **tensors)
    n = first.shape[0]
    for name, (t, _) in tensors.items():
        if t.shape != (n, _PROBE_ROWS, _LANES):
            raise ValueError(f"{name} must be (N, {_PROBE_ROWS}, {_LANES}), got {tuple(t.shape)}")
    if not 0 < n < 2**31:
        raise ValueError(f"need 0 < N < 2³¹ tiles, got {n}")
    return n


def _check_pages(pages, n: int, rows: int) -> None:
    """(N, 8) int32 page ids for a table of 1 to 64 rows."""
    _check_cuda(pages.device, pages=(pages, torch.int32))
    if pages.shape != (n, _PROBE_ROWS):
        raise ValueError(f"pages must be (N, {_PROBE_ROWS}) = {(n, _PROBE_ROWS)}, got {tuple(pages.shape)}")
    if not 1 <= rows <= _MAX_TABLE_ROWS:
        raise ValueError(f"need 1 <= table rows <= {_MAX_TABLE_ROWS}, got {rows}")


def _check_table(table, pages, n: int) -> int:
    """A (R, 128) f32 table beside (N, 8) page ids; returns R."""
    _check_cuda(pages.device, table=(table, torch.float32))
    if table.dim() != 2 or table.shape[1] != _LANES:
        raise ValueError(f"table must be (R, {_LANES}), got {tuple(table.shape)}")
    rows = table.shape[0]
    _check_pages(pages, n, rows)
    return rows


def _check_aligned(probe: str, **tensors) -> None:
    """`probe` reads these tensors as 16-byte vectors (int4, float4): their
    data must be 16-byte aligned."""
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{probe} reads {name} as 16-byte vectors: its data must be "
                             "16-byte aligned")


def _partials(dev, rows: int):
    """(CTAs, rows, 128) int64 partial tables of a persistent RMW probe,
    one CTA per SM; every entry is written by the kernel."""
    ctas = torch.cuda.get_device_properties(dev).multi_processor_count
    return torch.empty(ctas, rows, _LANES, device=dev, dtype=torch.int64)


def paged_gather_rmw(pages, idx, table):
    """(out (N, 8, 128) f32, dtab (R, 128) int64): out[n, r, k] =
    table[pages[n, i >> 7], i & 127] for i = idx[n, r, k] (taken modulo
    8·128), then dtab[pages[n, p]] += llrint(0.5·out[n, p]·2³²) over every
    tile and p, the fixed-point table itself (`from_fixed_point` converts
    it) — replaces tools/kernel_probe.py::gather_kernel. One CTA per SM
    holds the table and sums its share of the tiles in shared memory; a
    second kernel adds the CTAs' tables."""
    n = _check_blocks(idx=(idx, torch.int32))
    rows = _check_table(table, pages, n)
    _check_aligned("paged_gather_rmw", pages=pages)
    partial = _partials(idx.device, rows)
    out = torch.empty(idx.shape, device=idx.device, dtype=torch.float32)
    dtab = torch.empty(rows, _LANES, device=idx.device, dtype=torch.int64)
    # Page ids and |table| are checked in the kernel (device asserts): no
    # sum of 8N terms 0.5·table with |table| below table_limit overflows.
    table_limit = 2.0**63 / _FIXED_SCALE / (0.5 * _PROBE_ROWS * n)
    _probe_launch(paged_gather_rmw, idx.device, "jrr_paged_gather_rmw", pages.data_ptr(),
                  idx.data_ptr(), table.data_ptr(), out.data_ptr(), partial.data_ptr(),
                  dtab.data_ptr(), n, rows, partial.shape[0], table_limit)
    return out, dtab


def take_along_axis(x, index, axis: int):
    """out = take_along_axis(x, index, axis) on (N, 8, 128) blocks, along
    lanes (axis 2, the lane gather that `onehot_gather` launches too) or
    rows (axis 1), indices taken modulo the axis length — replaces
    tools/kernel_probe.py::taa_kernel."""
    if axis not in (1, 2):
        raise ValueError(f"axis must be 1 or 2, got {axis}")
    n = _check_blocks(x=(x, torch.float32), index=(index, torch.int32))
    out = torch.empty_like(x)
    if axis == 2:
        _check_aligned("take_along_axis", x=x, index=index)
        _probe_launch(take_along_axis, x.device, "jrr_lane_gather", x.data_ptr(), index.data_ptr(),
                      out.data_ptr(), n, 0)
    else:
        _probe_launch(take_along_axis, x.device, "jrr_row_gather", x.data_ptr(), index.data_ptr(),
                      out.data_ptr(), n)
    return out


def dyn_slice(pages, table):
    """out[n, p] = table[pages[n, p]] (N, 8, 128) — replaces the A probe
    (k_dynslice) of tools/kernel_probe2.py. A persistent grid, the table
    resident in each CTA's shared memory, rows written whole; the kernel
    checks that page ids lie in [0, table rows) (device asserts)."""
    n = pages.shape[0]
    rows = _check_table(table, pages, n)
    if not 0 < n < 2**31:
        raise ValueError(f"need 0 < N < 2³¹ tiles, got {n}")
    _check_aligned("dyn_slice", pages=pages, table=table)
    out = torch.empty(n, _PROBE_ROWS, _LANES, device=pages.device, dtype=torch.float32)
    _probe_launch(dyn_slice, pages.device, "jrr_dyn_slice", pages.data_ptr(), table.data_ptr(),
                  out.data_ptr(), n, rows)
    return out


def onehot_gather(x, il):
    """out[n, r, k] = x[n, r, il[n, r, k]], and 0 where il lies outside
    [0, 128): the function of the one-hot product Σ_l x[n, r, l]·(l ==
    il[n, r, k]), computed as a lane gather (no product) — replaces the B
    probe (k_onehot) of tools/kernel_probe2.py."""
    n = _check_blocks(x=(x, torch.float32), il=(il, torch.int32))
    _check_aligned("onehot_gather", x=x, il=il)
    out = torch.empty_like(x)
    _probe_launch(onehot_gather, x.device, "jrr_lane_gather", x.data_ptr(), il.data_ptr(),
                  out.data_ptr(), n, 1)
    return out


def select_reduce(x, isub):
    """out[n, r, k] = Σ_s (s == isub[n, r, k])·x[n, s, k] — replaces the D
    probe (k_selred) of tools/kernel_probe2.py."""
    n = _check_blocks(x=(x, torch.float32), isub=(isub, torch.int32))
    out = torch.empty_like(x)
    _probe_launch(select_reduce, x.device, "jrr_select_reduce", x.data_ptr(), isub.data_ptr(),
                  out.data_ptr(), n)
    return out


def rmw_rows(pages, x, rows: int):
    """(rows, 128) int64: out[pages[n, p]] += llrint(x[n, p]·2³²) over
    every tile and p, the fixed-point table itself (`from_fixed_point`
    converts it) — replaces the E probe (k_rmw) of tools/kernel_probe2.py.
    One CTA per SM sums its share of the tiles into shared memory; a second
    kernel adds the CTAs' tables."""
    n = _check_blocks(x=(x, torch.float32))
    _check_pages(pages, n, rows)
    _check_aligned("rmw_rows", pages=pages)
    partial = _partials(x.device, rows)
    out = torch.empty(rows, _LANES, device=x.device, dtype=torch.int64)
    # Page ids and |x| are checked in the kernel (device asserts): no sum
    # of 8N terms below x_limit overflows.
    x_limit = 2.0**63 / _FIXED_SCALE / (_PROBE_ROWS * n)
    _probe_launch(rmw_rows, x.device, "jrr_rmw_rows", pages.data_ptr(), x.data_ptr(),
                  partial.data_ptr(), out.data_ptr(), n, rows, partial.shape[0], x_limit)
    return out


def elementwise_baseline(x):
    """2x + 1 — replaces the F probe (k_base) of tools/kernel_probe2.py."""
    _check_cuda(x.device, x=(x, torch.float32))
    if x.numel() % 4:
        raise ValueError("elementwise_baseline takes a multiple of 4 elements")
    out = torch.empty_like(x)
    _probe_launch(elementwise_baseline, x.device, "jrr_elementwise", x.data_ptr(), out.data_ptr(),
                  x.numel())
    return out


def _fma_chain(wrapper, x, reps: int, bf16: bool):
    _check_cuda(x.device, x=(x, torch.float32))
    if x.numel() == 0 or x.numel() % 4:
        raise ValueError("the FMA chains take a positive multiple of 4 elements")
    if reps < 0:
        raise ValueError(f"reps must be >= 0, got {reps}")
    _check_aligned("the FMA chains", x=x)
    out = torch.empty_like(x)
    _probe_launch(wrapper, x.device, "jrr_fma_chain", x.data_ptr(), out.data_ptr(), x.numel(),
                  reps, int(bf16))
    return out


def fma_chain_f32(x, reps: int):
    """`reps` steps of acc = fmaf(acc, c1, c2), y = fmaf(y, c2, c1) from
    acc = y = x, then acc + y — replaces tools/bf16_vpu_probe.py::_kernel
    in float32 (`fma_chain_kernel<ChainF32, ...>`: the probe's 200 steps
    unrolled completely, other lengths in unrolled chunks)."""
    return _fma_chain(fma_chain_f32, x, reps, False)


def fma_chain_bf16(x, reps: int):
    """`fma_chain_f32` in packed bf16 (`__hfma2`, two elements per
    instruction; x rounded to bf16 first, acc + y in f32; the same kernel
    template, `fma_chain_kernel<ChainBf16, ...>`) — the bfloat16 case of
    tools/bf16_vpu_probe.py::_kernel."""
    return _fma_chain(fma_chain_bf16, x, reps, True)


PROBES = (paged_gather_rmw, take_along_axis, dyn_slice, onehot_gather, select_reduce, rmw_rows,
          elementwise_baseline, fma_chain_f32, fma_chain_bf16)
for _w in PROBES:
    _w.launches = 0

# The wrappers whose launches a run can count, in the order they are reported.
WRAPPERS = (fused_lossgrad, fused_alpha_fwd, fused_alpha_bwd, tiles_alpha_fwd, tiles_alpha_bwd,
            fused_lossgrad_packed) + PROBES


def reset_launches() -> None:
    for w in WRAPPERS:
        w.launches = 0
