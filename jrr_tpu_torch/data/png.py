"""8-bit PNG reading and writing with the standard library's zlib and numpy.

The dataset stores frames and silhouette masks as PNG files; this codec
reads and writes them without an image library. It handles the subset the
dataset uses: 8 bits per sample, grayscale (type 0), RGB (2), grayscale +
alpha (4) and RGBA (6), not interlaced. Anything else raises.

The writer uses filter 0 (None) on every row and zlib level 1, which
compresses a 1000² fixture frame ~3.5× faster than zlib's default level 6
(tests/torch_pipeline_report.py). The reader undoes all five filter types: None, Sub and
Up are vectorized along a row; Average and Paeth depend on the pixel to
their left through a non-linear step, so they run a loop along the row over
Python ints (~0.3 µs per byte; tests/torch_pipeline_report.py times a
dataset item).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # color type → samples per pixel


def _chunk(kind: bytes, data: bytes) -> bytes:
    crc = zlib.crc32(data, zlib.crc32(kind)) & 0xFFFFFFFF
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", crc)


def encode(image: np.ndarray) -> bytes:
    """(H, W) or (H, W, C) uint8, C in 1-4 → PNG bytes (filter 0 on every row)."""
    image = np.asarray(image)
    if image.dtype != np.uint8:
        raise ValueError(f"png.encode takes uint8 images, got {image.dtype}")
    if image.ndim == 2:
        image = image[..., None]
    if image.ndim != 3 or image.shape[2] not in (1, 2, 3, 4):
        raise ValueError(f"png.encode takes (H, W) or (H, W, 1-4) arrays, got {image.shape}")
    h, w, c = image.shape
    color_type = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    rows = np.zeros((h, 1 + w * c), np.uint8)  # column 0: filter type 0
    rows[:, 1:] = image.reshape(h, w * c)
    return (
        _SIGNATURE
        + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0))
        + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 1))
        + _chunk(b"IEND", b"")
    )


def write(path: str, image: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode(image))


def _unfilter_average(raw: bytes, prev: bytes, bpp: int) -> bytearray:
    out = bytearray(raw)
    for i in range(bpp):
        out[i] = (out[i] + (prev[i] >> 1)) & 0xFF
    for i in range(bpp, len(out)):
        out[i] = (out[i] + ((out[i - bpp] + prev[i]) >> 1)) & 0xFF
    return out


def _unfilter_paeth(raw: bytes, prev: bytes, bpp: int) -> bytearray:
    """With p = a + b − c: |p − a| = |b − c|, |p − b| = |a − c| and
    |p − c| = |(b − c) + (a − c)|, so only a's terms change along the row."""
    out = bytearray(raw)
    for i in range(bpp):  # a = c = 0: the predictor is b
        out[i] = (out[i] + prev[i]) & 0xFF
    for i in range(bpp, len(out)):
        a, b, c = out[i - bpp], prev[i], prev[i - bpp]
        pa, pb = b - c, a - c
        pc = pa + pb
        if pa < 0:
            pa = -pa
        if pb < 0:
            pb = -pb
        if pc < 0:
            pc = -pc
        if pa <= pb and pa <= pc:
            out[i] = (out[i] + a) & 0xFF
        elif pb <= pc:
            out[i] = (out[i] + b) & 0xFF
        else:
            out[i] = (out[i] + c) & 0xFF
    return out


_SLOW = {3: _unfilter_average, 4: _unfilter_paeth}


def decode(data: bytes) -> np.ndarray:
    """PNG bytes → (H, W) uint8 for grayscale, (H, W, C) for the other types."""
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file (bad signature)")
    pos, header, idat = 8, None, []
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        kind = data[pos + 4 : pos + 8]
        body = data[pos + 8 : pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length : pos + 12 + length])
        if zlib.crc32(body, zlib.crc32(kind)) & 0xFFFFFFFF != crc:
            raise ValueError(f"PNG chunk {kind!r}: CRC mismatch")
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError("PNG without an IHDR chunk")
    w, h, depth, color_type, _, _, interlace = header
    if depth != 8 or color_type not in _CHANNELS or interlace != 0:
        raise NotImplementedError(
            f"PNG with bit depth {depth}, color type {color_type}, interlace {interlace}: "
            "only 8-bit gray/RGB/gray+alpha/RGBA without interlacing is read"
        )
    bpp = _CHANNELS[color_type]
    stride = w * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (stride + 1):
        raise ValueError(f"PNG data holds {raw.size} bytes, expected {h * (stride + 1)}")
    raw = raw.reshape(h, stride + 1)
    kinds, rows = raw[:, 0], raw[:, 1:]
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        kind, row = int(kinds[y]), rows[y]
        if kind == 0:
            out[y] = row
        elif kind == 1:
            out[y] = np.cumsum(row.reshape(w, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif kind == 2:
            out[y] = row + prev
        elif kind in _SLOW:
            out[y] = np.frombuffer(_SLOW[kind](row.tobytes(), prev.tobytes(), bpp), np.uint8)
        else:
            raise ValueError(f"PNG row {y}: unknown filter type {kind}")
        prev = out[y]
    return out.reshape(h, w) if bpp == 1 else out.reshape(h, w, bpp)


def read(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode(f.read())
