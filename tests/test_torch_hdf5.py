"""The port's HDF5 reader (jrr_tpu_torch/data/hdf5.py) against h5py, and the
data.h5 mode of its H36MDataset against jrr_tpu's, on the CPU.

Tolerances: the reader's arrays equal h5py's, dtype (byte order included),
shape and every value (0 values differ). h5-mode batches as
tests/test_torch_data.py holds the PNG mode: warped crops 2e-4, crop
intrinsics 1e-3, gt_j2d 1e-4 px, every other key equal; the frames the
pack is built from equal jrr_tpu's pack conversion exactly.
"""

import json
import os
import shutil

import numpy as np
import pytest

from jrr_tpu.data import h36m as jh36m
from jrr_tpu_torch.data import h36m, hdf5, native_pipeline

h5py = pytest.importorskip("h5py")

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "h5")


def _same(got, want, what=""):
    assert got.dtype == want.dtype and got.shape == want.shape, (what, got.dtype, want.dtype,
                                                                 got.shape, want.shape)
    np.testing.assert_array_equal(got, want, err_msg=what)


def _against_h5py(path):
    """Every dataset of `path` read by both; returns the count."""
    f = hdf5.File(path)
    names = f.datasets()
    with h5py.File(path, "r") as ref:
        links = []  # every path, also several to one dataset
        ref.visit_links(links.append)
        assert sorted(names) == sorted(n for n in links if isinstance(ref[n], h5py.Dataset))
        for name in names:
            _same(f.read(name), ref[name][()], name)
    return len(names)


def test_committed_layouts_equal_h5py_and_their_decodes():
    path = os.path.join(DATA, "layouts.h5")
    assert _against_h5py(path) > 1100
    f = hdf5.File(path)
    with open(os.path.join(DATA, "layouts_decodes.json")) as fp:
        names = json.load(fp)
    with np.load(os.path.join(DATA, "layouts_decodes.npz")) as decodes:
        for key, name in names.items():
            got = (np.stack([f.read(f"big/e{i:04d}") for i in range(1100)]) if name == "big/*"
                   else f.read(name))
            _same(got, decodes[key], name)
    # The 1100-link group's B-tree has inner nodes above its leaves' nodes.
    with f._open() as fd:
        msgs = f._messages(fd, f._resolve(fd, "big"), "big")
        table = next(body for mtype, _, body in msgs if mtype == 0x11)
        level, _ = f._btree_node(fd, f._addr(table, 0), 0, f._sl)
    assert level >= 1
    with pytest.raises(KeyError, match="deep/a/missing"):
        f.read("/deep/a/missing")


def _write_case(path, case):
    rng = np.random.default_rng(7)
    kw = {}
    if case == "userblock":
        kw["userblock_size"] = 512
    with h5py.File(path, "w", **kw) as f:
        if case == "many_datasets":  # 1500 distinct datasets: B-tree splits at every level
            g = f.create_group("cam/54138969")
            for i in range(1500):
                g[f"img_{i:06d}.jpg"] = np.int32(i * 7 - 3)
        elif case == "chunked_edges":
            for code in ("u1", "<i2", ">u2", "<f4", ">f8", ">i8"):
                data = (rng.normal(scale=50, size=(3, 41, 29)) * (rng.uniform(size=(3, 41, 29))
                                                                   > 0.6)).astype(code)
                f.create_dataset(f"gz/{code}", data=data, chunks=(2, 16, 8), compression="gzip",
                                 compression_opts=int(rng.integers(1, 10)), shuffle=True)
                f.create_dataset(f"fl/{code}", data=data, chunks=(3, 7, 29), fletcher32=True)
        elif case == "frames":  # data.h5's shapes: float frames (3, H, W), masks (1, H, W)
            img = np.zeros((3, 120, 90), np.float32)
            img[:, 30:80, 20:60] = rng.uniform(size=(3, 50, 40))
            f.create_dataset("S9/Eating/imageSequence/54/img_000001.jpg", data=img,
                             chunks=(3, 64, 64), compression="gzip", shuffle=True)
            f["S9/Eating/maskSequence/54/img_000001.jpg"] = (img[:1] > 0) * np.float32(255)
        elif case == "userblock":
            f["x"] = rng.normal(size=(4, 5))
            f.create_dataset("y", data=np.arange(50, dtype="<u4"), chunks=(16,),
                             compression="gzip")


@pytest.mark.parametrize("case", ["many_datasets", "chunked_edges", "frames", "userblock"])
def test_reader_equals_h5py(tmp_path, case):
    path = str(tmp_path / "x.h5")
    _write_case(path, case)
    assert _against_h5py(path) >= 2


def test_reader_from_threads(tmp_path):
    from concurrent.futures import ThreadPoolExecutor

    path = str(tmp_path / "x.h5")
    _write_case(path, "chunked_edges")
    f = hdf5.File(path)
    names = f.datasets() * 4
    with ThreadPoolExecutor(8) as pool:
        got = list(pool.map(f.read, names))
    with h5py.File(path, "r") as ref:
        for name, a in zip(names, got):
            _same(a, ref[name][()], name)


def test_fletcher32_mismatch_raises(tmp_path):
    path = str(tmp_path / "x.h5")
    with h5py.File(path, "w") as f:
        f.create_dataset("x", data=np.arange(64, dtype="<i4"), chunks=(64,), fletcher32=True)
    with h5py.File(path, "r") as f:
        offset = f["x"].id.get_chunk_info(0).byte_offset
    with open(path, "r+b") as fp:  # flip one data byte of the chunk
        fp.seek(offset + 5)
        b = fp.read(1)
        fp.seek(offset + 5)
        fp.write(bytes([b[0] ^ 0x10]))
    with pytest.raises(OSError, match="fletcher32"):
        hdf5.File(path).read("x")


def _refused(tmp_path, case):
    path = str(tmp_path / "x.h5")
    libver = "latest" if case == "superblock" else None
    with h5py.File(path, "w", libver=libver) as f:
        if case == "superblock":
            f["x"] = np.arange(3)
        elif case == "object_header":
            f.create_group("x", track_order=True)
        elif case in ("compound", "string", "variable-length", "enum", "array", "opaque",
                      "reference"):
            data = {
                "compound": np.zeros(2, [("a", "<i4"), ("b", "<f4")]),
                "string": np.asarray([b"ab", b"cd"]),
                "enum": np.asarray([True, False]),
                "opaque": np.void(b"\x01\x02"),
            }
            if case == "variable-length":
                f.create_dataset("x", data=["a", "bcd"], dtype=h5py.string_dtype())
            elif case == "array":
                tid = h5py.h5t.array_create(h5py.h5t.STD_I32LE, (3,))
                h5py.h5d.create(f.id, b"x", tid, h5py.h5s.create_simple((2,)))
            elif case == "reference":
                f["t"] = 1
                f.create_dataset("x", data=[f["t"].ref], dtype=h5py.ref_dtype)
            else:
                f["x"] = data[case]
        elif case in ("lzf", "szip", "scale-offset"):
            opts = {"lzf": dict(compression="lzf"), "szip": dict(compression="szip"),
                    "scale-offset": dict(scaleoffset=2)}[case]
            f.create_dataset("x", data=np.arange(64, dtype="<f4"), chunks=(16,), **opts)
        elif case == "soft":
            f["t"] = 1
            f["x"] = h5py.SoftLink("/t")
        elif case == "shared":
            f["t"] = np.dtype("<f4")  # a committed datatype
            f.create_dataset("x", shape=(2,), dtype=f["t"])
    return path


@pytest.mark.parametrize("case, feature", [
    ("superblock", "superblock version 3"),
    ("object_header", "version 2 object headers"),
    ("compound", "compound datatype"),
    ("string", "string datatype"),
    ("variable-length", "variable-length datatype"),
    ("enum", "enum datatype"),
    ("array", "array datatype"),
    ("opaque", "opaque datatype"),
    ("reference", "reference datatype"),
    ("lzf", "lzf filter"),
    ("szip", "szip filter"),
    ("scale-offset", "scale-offset filter"),
    ("soft", "soft link"),
    ("shared", "shared header messages"),
])
def test_refusals_name_the_file_and_feature(tmp_path, case, feature):
    path = _refused(tmp_path, case)
    with pytest.raises(NotImplementedError, match=feature) as err:
        hdf5.File(path).read("x")
    assert path in str(err.value)


@pytest.mark.parametrize("name, feature", [("latest.h5", "superblock version 3"),
                                           ("compound.h5", "compound datatype")])
def test_committed_refusals(name, feature):
    with pytest.raises(NotImplementedError, match=feature):
        hdf5.File(os.path.join(DATA, name)).read("x")


@pytest.fixture(scope="module")
def h5_root(tmp_path_factory):
    """A copy of the committed 4-frame data.h5 dataset (packs are built into it)."""
    root = str(tmp_path_factory.mktemp("h5") / "dataset")
    shutil.copytree(os.path.join(DATA, "dataset"), root)
    return root


def _hold_batch(got, want):
    assert set(got) == set(want)
    for key in want:
        tol = {"image": 2e-4, "spin_image": 2e-4, "intrinsics": 1e-3, "gt_j2d": 1e-4}.get(key)
        if tol is None:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        else:
            np.testing.assert_allclose(got[key], want[key], atol=tol, rtol=0, err_msg=key)


def test_h5_mode_batches_equal_jax(h5_root):
    want = jh36m.H36MDataset(h5_root, "validation")
    got = h36m.H36MDataset(h5_root, "validation")
    assert want.use_h5 and got.use_h5 and len(got) == 4
    idx = np.asarray([2, 0])
    _hold_batch(got.load_batch(idx), want.load_batch(idx))
    for i in range(len(got)):  # the un-warped frames exactly
        for g, w in zip(got._read_frame_images(i), want._read_frame_images(i)):
            _same(g, w, f"frame {i}")
    assert got.frame_order()[1].tolist() == want.frame_order()[1].tolist()
    with np.load(os.path.join(DATA, "dataset_batch.npz")) as f:
        _hold_batch(got.load_batch(np.arange(4)), dict(f))


def test_h5_mode_packs_jax_conversion(h5_root):
    """pack_dataset reads the frames through the reader and stores
    jrr_tpu's conversion, (x · 255) truncated to uint8."""
    ds = h36m.H36MDataset(h5_root, "validation")
    jds = jh36m.H36MDataset(h5_root, "validation")
    path = native_pipeline.pack_dataset(h5_root)
    from jrr_tpu_torch import runtime

    reader = runtime.PackReader(path, num_threads=1)
    try:
        for i in range(len(ds)):
            img, mask = jds._read_frame_images(i)
            image_u8, mask_u8 = ds.read_frame_u8(i)
            np.testing.assert_array_equal(image_u8, (np.transpose(img, (1, 2, 0)) * 255).astype(np.uint8))
            np.testing.assert_array_equal(mask_u8[0], (mask[0] * 255).astype(np.uint8))
        batch = reader.load_batch(np.arange(4), ds.tensors["bboxes"].astype(np.float32),
                                  spin_res=224, img_res=256)
        assert np.isfinite(batch["spin_image"]).all() and batch["spin_image"].max() > 0.5
    finally:
        reader.close()
