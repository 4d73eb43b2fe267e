"""HDF5 reading with the standard library's zlib and numpy.

The dataset's single-file mode (`data.h5`) and raw Human3.6M's per-scene
`annot.h5` are HDF5 files, which jrr_tpu reads with h5py. This reader takes
their place in the port. It handles what h5py writes by default, plus the
chunked form a large data.h5 uses:

- superblock versions 0 and 1 (an HDF5 user block before it included);
- version 1 object headers, with their continuation blocks;
- symbol-table groups at any depth and size: version 1 B-trees of any
  height over SNOD leaves, names in a local heap;
- the compact, contiguous and chunked layouts (layout message version 3);
  chunks are indexed by a version 1 B-tree, may be edge chunks or missing
  (read as the fill value) and carry a filter mask each; the deflate,
  shuffle and fletcher32 filters are undone, the checksum checked;
- scalar and simple dataspaces;
- fixed-point and IEEE float data of 1, 2, 4 or 8 bytes, either byte order.

A dataset whose storage was never written (an undefined address) reads as
its fill value, as h5py reads it. Anything else raises NotImplementedError
naming the file and the feature: version 2 and 3 superblocks and version 2
object headers (h5py's libver="latest", and its groups and datasets made
with track_order=True), groups of link messages (compact or dense link
storage), string,
compound, enum, reference, variable-length, array, bitfield and opaque
types, shared header messages, virtual layouts, szip, lzf, n-bit,
scale-offset and other filters, soft links. Header messages
this reader does not use (attributes, times, group info, ...) are skipped
by their recorded size.

`File(path)` reads the superblock when it is made. A group's link table is
read the first time a path goes through it, a dataset's header the first
time it is read, and both are kept. Every call opens the file, reads with
`os.pread` and closes it again: one `File` serves any number of threads and
holds no descriptor between calls. Only the standard library and numpy are
used.
"""

from __future__ import annotations

import contextlib
import os
import struct
import zlib
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np

_SIGNATURE = b"\x89HDF\r\n\x1a\n"

# Header message types (HDF5 file format specification, section IV.A.2).
_DATASPACE, _LINK_INFO, _DATATYPE, _FILL_OLD, _FILL = 0x01, 0x02, 0x03, 0x04, 0x05
_LINK, _LAYOUT, _FILTERS, _CONTINUATION, _SYMBOL_TABLE = 0x06, 0x08, 0x0B, 0x10, 0x11

_DEFLATE, _SHUFFLE, _FLETCHER32 = 1, 2, 3
_FILTER_NAMES = {4: "szip", 5: "n-bit", 6: "scale-offset", 307: "bzip2", 32000: "lzf",
                 32001: "blosc", 32004: "lz4", 32015: "zstd"}
_CLASS_NAMES = {2: "time", 3: "string", 4: "bitfield", 5: "opaque", 6: "compound",
                7: "reference", 8: "enum", 9: "variable-length", 10: "array"}
# IEEE formats: size → (bit offset, precision, exponent location, exponent
# size, mantissa location, mantissa size, exponent bias, sign location).
_IEEE = {2: (0, 16, 10, 5, 0, 10, 15, 15), 4: (0, 32, 23, 8, 0, 23, 127, 31),
         8: (0, 64, 52, 11, 0, 52, 1023, 63)}


class _Dataset(NamedTuple):
    dtype: np.dtype
    shape: Tuple[int, ...]
    layout: str  # "compact", "contiguous" or "chunked"
    address: Optional[int]  # contiguous data or the chunk B-tree; None = never written
    data: bytes  # compact data
    chunk: Tuple[int, ...]  # chunk shape (chunked)
    filters: Tuple[Tuple[int, Tuple[int, ...]], ...]  # (filter id, client data), in write order
    fill: Optional[bytes]  # the fill value's bytes, None = zeros


def _prod(xs) -> int:
    n = 1
    for x in xs:
        n *= int(x)
    return n


def _fletcher32(data: bytes) -> int:
    """HDF5's Fletcher-32 (H5_checksum_fletcher32): big-endian 16-bit words,
    an odd last byte as the high byte of a word, sums kept in 1..65535
    (0 only for an all-zero input), returned as (sum2 << 16) | sum1."""
    words = np.frombuffer(data[: len(data) & ~1], ">u2").astype(np.int64)
    if len(data) & 1:
        words = np.concatenate([words, np.asarray([data[-1] << 8], np.int64)])
    m = len(words)
    s1 = s2 = 0
    block = 1 << 16  # keeps each block's weighted sum below 2^63
    for lo in range(0, m, block):
        w = words[lo : lo + block]
        total = int(w.sum())
        # Σ (m − i)·w_i over the block, from its offsets within the block.
        s2 += (m - lo) * total - int((np.arange(len(w), dtype=np.int64) * w).sum())
        s1 += total

    def fold(s: int) -> int:
        return 0 if s == 0 else (s - 1) % 65535 + 1

    return (fold(s2) << 16) | fold(s1)


def _unshuffle(raw: bytes, itemsize: int) -> bytes:
    """Undo the shuffle filter: the bytes of each element position stored
    together, byte 0 of every element first; a tail shorter than one
    element of every column is stored as is."""
    n = len(raw) // itemsize
    if itemsize <= 1 or n <= 1:
        return raw
    body = np.frombuffer(raw, np.uint8, count=n * itemsize).reshape(itemsize, n)
    return body.T.tobytes() + raw[n * itemsize :]


class File:
    """An HDF5 file, read on demand (see the module docstring for the scope).

    `read(name)` returns the dataset at `name` (a "/"-separated path, with
    or without the leading "/") as a numpy array of its stored dtype (byte
    order included) and shape; `datasets(group)` lists every dataset path
    below a group."""

    def __init__(self, path):
        self.path = os.fspath(path)
        self._groups: Dict[int, Dict[str, Tuple[str, object]]] = {}
        self._datasets: Dict[int, _Dataset] = {}
        with self._open() as fd:
            self._read_superblock(fd)

    # -- low-level reads ---------------------------------------------------

    @contextlib.contextmanager
    def _open(self):
        """A descriptor of the file for one call."""
        fd = os.open(self.path, os.O_RDONLY)
        try:
            yield fd
        finally:
            os.close(fd)

    def _refuse(self, feature: str, where: str = "") -> NotImplementedError:
        at = f" ({where})" if where else ""
        return NotImplementedError(f"{self.path}{at}: {feature} is not supported by jrr_tpu_torch's "
                                   "HDF5 reader")

    def _corrupt(self, what: str) -> OSError:
        return OSError(f"{self.path}: {what}")

    def _pread(self, fd: int, address: int, n: int, absolute: bool = False) -> bytes:
        offset = address if absolute else self._base + address
        out = os.pread(fd, n, offset)
        while len(out) < n:
            more = os.pread(fd, n - len(out), offset + len(out))
            if not more:
                raise self._corrupt(f"truncated: {n} bytes wanted at {offset}")
            out += more
        return out

    def _uint(self, buf: bytes, pos: int, size: int) -> int:
        return int.from_bytes(buf[pos : pos + size], "little")

    def _addr(self, buf: bytes, pos: int) -> Optional[int]:
        """An address field, None when undefined (all bits set)."""
        value = self._uint(buf, pos, self._so)
        return None if value == (1 << (8 * self._so)) - 1 else value

    # -- superblock ----------------------------------------------------------

    def _read_superblock(self, fd: int) -> None:
        size = os.fstat(fd).st_size
        at = 0
        while at + 8 <= size:  # at 0, 512, 1024, 2048, ...
            if os.pread(fd, 8, at) == _SIGNATURE:
                break
            at = 512 if at == 0 else 2 * at
        else:
            raise self._corrupt("no HDF5 signature")
        head = self._pread(fd, at, 24, absolute=True)
        version = head[8]
        if version not in (0, 1):
            raise self._refuse(f"superblock version {version} (a file of libver='latest')")
        self._so, self._sl = head[13], head[14]
        if self._so not in (2, 4, 8) or self._sl not in (2, 4, 8):
            raise self._corrupt(f"sizes of offsets {self._so} and lengths {self._sl}")
        pos = 24 + (4 if version == 1 else 0)
        need = pos + 4 * self._so + 2 * self._so + 24
        buf = self._pread(fd, at, need, absolute=True)
        self._base = self._uint(buf, pos, self._so)
        root_entry = pos + 4 * self._so  # after the four addresses, base address first
        root = self._addr(buf, root_entry + self._so)
        if root is None:
            raise self._corrupt("undefined root group")
        self._root = root

    # -- object headers -----------------------------------------------------

    def _messages(self, fd: int, address: int, where: str) -> List[Tuple[int, int, bytes]]:
        """Every (type, flags, body) of the version 1 object header at
        `address`, continuation blocks followed."""
        prefix = self._pread(fd, address, 16)
        if prefix[:4] == b"OHDR":
            raise self._refuse("version 2 object headers (libver='latest', track_order=True)", where)
        if prefix[0] != 1:
            raise self._corrupt(f"object header version {prefix[0]} at {address} ({where})")
        blocks = [(address + 16, struct.unpack_from("<I", prefix, 8)[0])]
        out = []
        while blocks:
            start, length = blocks.pop(0)
            buf = self._pread(fd, start, length)
            pos = 0
            while pos + 8 <= length:
                mtype, msize, mflags = struct.unpack_from("<HHB", buf, pos)
                body = buf[pos + 8 : pos + 8 + msize]
                if len(body) != msize:
                    raise self._corrupt(f"header message overruns its block at {start + pos}")
                pos += 8 + msize
                if mtype == _CONTINUATION:
                    blocks.append((self._addr(body, 0), self._uint(body, self._so, self._sl)))
                elif mtype:
                    out.append((mtype, mflags, body))
        return out

    # -- groups --------------------------------------------------------------

    def _links(self, fd: int, address: int, where: str) -> Dict[str, Tuple[str, object]]:
        """A group's links {name: (kind, target)}: kind "hard" with the
        target's header address, or "soft"; read once, then kept."""
        links = self._groups.get(address)
        if links is not None:
            return links
        msgs = self._messages(fd, address, where)
        types = {m[0] for m in msgs}
        links = {}
        if _SYMBOL_TABLE in types:
            body = next(m[2] for m in msgs if m[0] == _SYMBOL_TABLE)
            heap = self._local_heap(fd, self._addr(body, self._so))
            btree = self._addr(body, 0)
            if btree is not None:
                self._walk_group_btree(fd, btree, heap, links)
        elif _LINK_INFO in types or _LINK in types:
            raise self._refuse("a group of link messages (compact or dense link storage)", where)
        else:
            raise KeyError(f"{self.path}: {where or '/'} is not a group")
        # Concurrent first reads build equal tables; either may be kept.
        self._groups[address] = links
        return links

    def _local_heap(self, fd: int, address: int) -> bytes:
        head = self._pread(fd, address, 8 + 2 * self._sl + self._so)
        if head[:4] != b"HEAP":
            raise self._corrupt(f"no local heap at {address}")
        seg_size = self._uint(head, 8, self._sl)
        return self._pread(fd, self._addr(head, 8 + 2 * self._sl), seg_size)

    def _heap_name(self, heap: bytes, offset: int) -> str:
        end = heap.find(b"\0", offset)
        return heap[offset : end if end >= 0 else len(heap)].decode("utf-8")

    def _btree_node(self, fd: int, address: int, node_type: int, key_size: int):
        """(level, [(key bytes, child address), ...]) of a version 1 B-tree
        node: entry i's key is the one before its child."""
        head_size = 8 + 2 * self._so
        head = self._pread(fd, address, head_size)
        if head[:4] != b"TREE" or head[4] != node_type:
            raise self._corrupt(f"no type-{node_type} B-tree node at {address}")
        level, used = head[5], struct.unpack_from("<H", head, 6)[0]
        step = key_size + self._so
        body = self._pread(fd, address + head_size, used * step + key_size)
        entries = [(body[i * step : i * step + key_size], self._addr(body, i * step + key_size))
                   for i in range(used)]
        return level, entries

    def _walk_group_btree(self, fd: int, address: int, heap: bytes, links) -> None:
        level, entries = self._btree_node(fd, address, 0, self._sl)
        for _, child in entries:
            if level:
                self._walk_group_btree(fd, child, heap, links)
                continue
            head = self._pread(fd, child, 8)
            if head[:4] != b"SNOD":
                raise self._corrupt(f"no symbol table node at {child}")
            n = struct.unpack_from("<H", head, 6)[0]
            size = 2 * self._so + 24
            buf = self._pread(fd, child + 8, n * size)
            for i in range(n):
                entry = i * size
                name = self._heap_name(heap, self._uint(buf, entry, self._so))
                cache_type = struct.unpack_from("<I", buf, entry + 2 * self._so)[0]
                # Cache type 2 marks a soft link (its target in the heap).
                links[name] = (("soft", None) if cache_type == 2
                               else ("hard", self._addr(buf, entry + self._so)))

    def _resolve(self, fd: int, name: str) -> int:
        """Header address of the object at path `name`."""
        address, walked = self._root, ""
        for part in (p for p in name.split("/") if p):
            links = self._links(fd, address, walked)
            walked = f"{walked}/{part}"
            if part not in links:
                raise KeyError(f"{self.path}: no object {walked!r}")
            kind, target = links[part]
            if kind != "hard":
                raise self._refuse(f"a {kind} link", walked)
            address = target
        return address

    # -- datasets ------------------------------------------------------------

    def _dataset(self, fd: int, header: int, where: str) -> _Dataset:
        """The dataset whose object header is at `header`; read once, then kept."""
        ds = self._datasets.get(header)
        if ds is not None:
            return ds
        msgs = {}
        for mtype, mflags, body in self._messages(fd, header, where):
            if mtype in (_DATASPACE, _DATATYPE, _FILL_OLD, _FILL, _LAYOUT, _FILTERS):
                if mflags & 0x02:
                    raise self._refuse("shared header messages (a committed datatype)", where)
                msgs.setdefault(mtype, body)
        if _LAYOUT not in msgs:
            raise KeyError(f"{self.path}: {where} is not a dataset")
        if _DATASPACE not in msgs or _DATATYPE not in msgs:
            raise self._corrupt(f"{where}: a dataset without a dataspace or datatype")
        dtype = self._datatype(msgs[_DATATYPE], where)
        shape = self._dataspace(msgs[_DATASPACE], where)
        fill = self._fill(msgs.get(_FILL), msgs.get(_FILL_OLD), where)
        filters = self._filters(msgs[_FILTERS], where) if _FILTERS in msgs else ()
        lay = msgs[_LAYOUT]
        if lay[0] != 3:
            raise self._refuse(f"data layout message version {lay[0]}", where)
        address, data, chunk = None, b"", ()
        if lay[1] == 0:
            kind = "compact"
            data = lay[4 : 4 + struct.unpack_from("<H", lay, 2)[0]]
        elif lay[1] == 1:
            kind = "contiguous"
            address = self._addr(lay, 2)
        elif lay[1] == 2:
            kind = "chunked"
            rank = lay[2]
            address = self._addr(lay, 3)
            dims = struct.unpack_from(f"<{rank}I", lay, 3 + self._so)
            chunk = tuple(int(d) for d in dims[:-1])
            if len(chunk) != len(shape):
                raise self._corrupt(f"{where}: chunk rank {len(chunk)} for shape {shape}")
        else:
            raise self._refuse("the virtual layout" if lay[1] == 3 else f"layout class {lay[1]}",
                               where)
        ds = _Dataset(dtype, shape, kind, address, data, chunk, filters, fill)
        self._datasets[header] = ds
        return ds

    def _datatype(self, b: bytes, where: str) -> np.dtype:
        cls, bits = b[0] & 0x0F, b[1] | b[2] << 8 | b[3] << 16
        size = struct.unpack_from("<I", b, 4)[0]
        if cls == 0:
            offset, precision = struct.unpack_from("<HH", b, 8)
            if size not in (1, 2, 4, 8) or offset or precision != 8 * size:
                raise self._refuse(f"a {precision}-bit integer at offset {offset} in {size} "
                                   "bytes", where)
            order = ">" if bits & 1 else "<"
            return np.dtype(f"{order}{'i' if bits & 0x08 else 'u'}{size}")
        if cls == 1:
            if bits & 0x40:
                raise self._refuse("VAX-order floats", where)
            props = struct.unpack_from("<HHBBBBI", b, 8) + ((bits >> 8) & 0xFF,)
            if _IEEE.get(size) != props or (bits >> 4) & 3 != 2:
                raise self._refuse(f"a non-IEEE {size}-byte float", where)
            return np.dtype(f"{'>' if bits & 1 else '<'}f{size}")
        raise self._refuse(f"the {_CLASS_NAMES.get(cls, f'class-{cls}')} datatype", where)

    def _dataspace(self, b: bytes, where: str) -> Tuple[int, ...]:
        version, rank = b[0], b[1]
        if version == 1:
            pos = 8
        elif version == 2:
            if b[3] == 2:
                raise self._refuse("a null dataspace", where)
            pos = 4
        else:
            raise self._corrupt(f"{where}: dataspace version {version}")
        return tuple(self._uint(b, pos + i * self._sl, self._sl) for i in range(rank))

    def _fill(self, new: Optional[bytes], old: Optional[bytes], where: str) -> Optional[bytes]:
        if new is not None:
            version = new[0]
            if version in (1, 2):
                if not new[3]:  # no fill value defined
                    return None
                size = struct.unpack_from("<i", new, 4)[0]
                return new[8 : 8 + size] if size > 0 else None
            if version == 3:
                if not new[1] & 0x20:
                    return None
                size = struct.unpack_from("<i", new, 2)[0]
                return new[6 : 6 + size] if size > 0 else None
            raise self._corrupt(f"{where}: fill value message version {version}")
        if old is not None:
            size = struct.unpack_from("<I", old, 0)[0]
            return old[4 : 4 + size] if size else None
        return None

    def _filters(self, b: bytes, where: str):
        version, n = b[0], b[1]
        if version not in (1, 2):
            raise self._corrupt(f"{where}: filter pipeline version {version}")
        pos, out = (8 if version == 1 else 2), []
        for _ in range(n):
            fid = struct.unpack_from("<H", b, pos)[0]
            if version == 1 or fid >= 256:
                name_len = struct.unpack_from("<H", b, pos + 2)[0]
                pos += 4
            else:
                name_len = 0
                pos += 2
            _, ncd = struct.unpack_from("<HH", b, pos)
            pos += 4
            pos += (name_len + 7) // 8 * 8 if version == 1 else name_len
            cd = struct.unpack_from(f"<{ncd}I", b, pos)
            pos += 4 * ncd + (4 if version == 1 and ncd % 2 else 0)
            if fid not in (_DEFLATE, _SHUFFLE, _FLETCHER32):
                raise self._refuse(f"the {_FILTER_NAMES.get(fid, f'id-{fid}')} filter", where)
            out.append((fid, tuple(int(c) for c in cd)))
        return tuple(out)

    def _chunks(self, fd: int, address: int, rank: int, out: list) -> None:
        """(size, filter mask, offsets, address) of every chunk under the
        chunk B-tree node at `address`."""
        key_size = 8 + 8 * (rank + 1)
        level, entries = self._btree_node(fd, address, 1, key_size)
        for key, child in entries:
            if level:
                self._chunks(fd, child, rank, out)
            else:
                size, mask = struct.unpack_from("<II", key, 0)
                out.append((size, mask, struct.unpack_from(f"<{rank}Q", key, 8), child))

    def _decode_chunk(self, raw: bytes, mask: int, ds: _Dataset, where: str) -> bytes:
        """Undo the filters in reverse order, skipping those `mask` marks."""
        for i in reversed(range(len(ds.filters))):
            if mask >> i & 1:
                continue
            fid, cd = ds.filters[i]
            if fid == _FLETCHER32:
                if len(raw) < 4:
                    raise self._corrupt(f"{where}: a chunk shorter than its checksum")
                body, stored = raw[:-4], struct.unpack("<I", raw[-4:])[0]
                want = _fletcher32(body)
                # HDF5 also accepts the checksum with each 16-bit half's bytes swapped.
                swapped = ((want & 0x00FF00FF) << 8) | ((want >> 8) & 0x00FF00FF)
                if stored not in (want, swapped):
                    raise self._corrupt(f"{where}: fletcher32 checksum mismatch")
                raw = body
            elif fid == _SHUFFLE:
                raw = _unshuffle(raw, cd[0] if cd else ds.dtype.itemsize)
            else:
                try:
                    raw = zlib.decompress(raw)
                except zlib.error as e:
                    raise self._corrupt(f"{where}: deflate: {e}") from None
        return raw

    def _filled(self, ds: _Dataset) -> np.ndarray:
        if ds.fill is None or len(ds.fill) != ds.dtype.itemsize:
            return np.zeros(ds.shape, ds.dtype)
        return np.full(ds.shape, np.frombuffer(ds.fill, ds.dtype)[0], ds.dtype)

    def _read_data(self, fd: int, ds: _Dataset, where: str) -> np.ndarray:
        nbytes = _prod(ds.shape) * ds.dtype.itemsize
        if ds.layout == "compact":
            if len(ds.data) < nbytes:
                raise self._corrupt(f"{where}: compact data of {len(ds.data)} bytes")
            return np.frombuffer(ds.data, ds.dtype, count=_prod(ds.shape)).reshape(ds.shape).copy()
        if ds.address is None:
            return self._filled(ds)
        if ds.layout == "contiguous":
            raw = self._pread(fd, ds.address, nbytes)
            return np.frombuffer(raw, ds.dtype).reshape(ds.shape).copy()
        out = self._filled(ds)
        chunks: list = []
        self._chunks(fd, ds.address, len(ds.shape), chunks)
        chunk_bytes = _prod(ds.chunk) * ds.dtype.itemsize
        for size, mask, offsets, address in chunks:
            raw = self._decode_chunk(self._pread(fd, address, size), mask, ds, where)
            if len(raw) < chunk_bytes:
                raise self._corrupt(f"{where}: a chunk of {len(raw)} bytes, {chunk_bytes} wanted")
            block = np.frombuffer(raw, ds.dtype, count=_prod(ds.chunk)).reshape(ds.chunk)
            # Edge chunks are stored whole; keep the part inside the dataset.
            inside = tuple(slice(0, max(0, min(c, n - o)))
                           for c, n, o in zip(ds.chunk, ds.shape, offsets))
            out[tuple(slice(o, o + s.stop) for o, s in zip(offsets, inside))] = block[inside]
        return out

    # -- the interface -------------------------------------------------------

    def read(self, name: str) -> np.ndarray:
        """The dataset at path `name` as a new numpy array."""
        with self._open() as fd:
            return self._read_data(fd, self._dataset(fd, self._resolve(fd, name), name), name)

    def datasets(self, group: str = "/") -> List[str]:
        """The paths (no leading "/") of every dataset at or below `group`."""
        out: List[str] = []
        with self._open() as fd:
            self._collect(fd, self._resolve(fd, group), group.strip("/"), out)
        return out

    def _collect(self, fd: int, address: int, path: str, out: List[str]) -> None:
        try:
            links = self._links(fd, address, path)
        except KeyError:  # not a group
            self._dataset(fd, address, path)
            out.append(path)
            return
        for name, (kind, target) in links.items():
            child = f"{path}/{name}" if path else name
            if kind != "hard":
                raise self._refuse(f"a {kind} link", child)
            self._collect(fd, target, child, out)
