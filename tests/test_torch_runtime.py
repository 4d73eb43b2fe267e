"""The port's host runtime (jrr_tpu_torch.runtime) against jrr_tpu's on the
CPU: both libraries are built here with the same g++ flags, and ISO C++17
keeps floating-point contraction off, so every comparison is exact:
- `warp_batch` on seeded random uint8 images and perspective homographies;
- the v1 and v2 pack files written from one JAX-written fixture directory,
  byte for byte, each package reading the other's, batches equal;
- 1 and 4 threads equal; two readers with different thread counts loading
  at once from two Python threads give the batches they give alone (the
  port makes a pool per thread count once and never frees it; jrr_tpu
  rebuilds its one pool when the count changes, under running batches).
"""

import os
import sys
import threading

import numpy as np
import pytest

from jrr_tpu import runtime as jruntime
from jrr_tpu.data import fixtures as jfixtures
from jrr_tpu.data import native_pipeline as jnative
from jrr_tpu.models import smpl as jsmpl
from jrr_tpu_torch import runtime
from jrr_tpu_torch.data import native_pipeline


@pytest.fixture(scope="module")
def packs(tmp_path_factory):
    """A JAX-written fixture directory (6 frames) and the v1 and v2 packs
    each package writes from it."""
    root = str(tmp_path_factory.mktemp("fixtures"))
    model = jsmpl.synthetic_smpl_model(seed=0, num_verts=256, num_faces=500)
    jfixtures.write_fixture_dataset(root, num_frames=6, seed=3, model=model)
    out = tmp_path_factory.mktemp("packs")
    paths = {"root": root}
    paths["jax1"] = jnative.pack_dataset(root, out_path=str(out / "jax.jrrpack"))
    paths["port1"] = native_pipeline.pack_dataset(root, out_path=str(out / "port.jrrpack"))
    # Both v2 builds read the split's own frames.jrrpack, which JAX writes.
    paths["jax2"] = jnative.build_pack2(root, out_path=str(out / "jax.jrrpack2"), chunk=4)
    paths["port2"] = native_pipeline.build_pack2(root, out_path=str(out / "port.jrrpack2"),
                                                 chunk=4)
    return paths


def _bboxes(n, seed=0):
    rng = np.random.default_rng(seed)
    lo = rng.uniform(-60, 700, size=(n, 2))
    side = rng.uniform(150, 500, size=(n, 1)) * rng.uniform(0.8, 1.2, size=(n, 2))
    return np.concatenate([lo, lo + side], 1).astype(np.float32)


def _assert_batches_equal(got, want):
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def _homographies(rng, b):
    hom = np.tile(np.eye(3, dtype=np.float32), (b, 1, 1))
    hom[:, :2, :2] += rng.normal(scale=0.3, size=(b, 2, 2))
    hom[:, :2, 2] = rng.normal(scale=0.4, size=(b, 2))
    hom[:, 2, :2] = rng.normal(scale=0.1, size=(b, 2))
    return hom.astype(np.float32)


@pytest.mark.parametrize("channels", [1, 3])
def test_warp_batch_equals_jax(channels):
    rng = np.random.default_rng(channels)
    images = rng.integers(0, 256, size=(5, 61, 83, channels), dtype=np.uint8)
    hom = _homographies(rng, 5)
    want = jruntime.warp_batch(images, hom, (40, 52))
    for threads in (1, 4):
        np.testing.assert_array_equal(runtime.warp_batch(images, hom, (40, 52), threads), want)


@pytest.mark.parametrize("version", [1, 2])
def test_pack_files_are_byte_identical(packs, version):
    with open(packs[f"jax{version}"], "rb") as f, open(packs[f"port{version}"], "rb") as g:
        jax_bytes, port_bytes = f.read(), g.read()
    assert len(port_bytes) > 40 and port_bytes == jax_bytes


def test_each_package_reads_the_others_v1_pack(packs):
    idx = np.array([5, 0, 3, 3, 1])
    bb = _bboxes(len(idx))
    port = runtime.PackReader(packs["jax1"], num_threads=3)
    jax = jruntime.PackReader(packs["port1"], num_threads=3)
    assert port.num_frames == jax.num_frames == 6
    assert (port.img_h, port.img_w, port.img_c, port.mask_h, port.mask_w) == (
        jax.img_h, jax.img_w, jax.img_c, jax.mask_h, jax.mask_w)
    got = port.load_batch(idx, bb, spin_res=112, img_res=128)
    _assert_batches_equal(got, jax.load_batch(idx, bb, spin_res=112, img_res=128))
    assert got["image"].shape == (5, 3, 128, 128) and got["image"].max() > 0.5


def test_each_package_reads_the_others_v2_pack(packs):
    idx = np.array([2, 4, 0, 5])
    port = runtime.Pack2Reader(packs["jax2"])
    jax = jruntime.Pack2Reader(packs["port2"])
    assert (port.spin_res, port.img_res, port.img_c) == (224, 256, 3) == (
        jax.spin_res, jax.img_res, jax.img_c)
    _assert_batches_equal(port.load_batch(idx), jax.load_batch(idx))


def test_writers_match_jax_on_random_arrays(tmp_path):
    rng = np.random.default_rng(7)
    images = rng.integers(0, 256, size=(3, 20, 30, 3), dtype=np.uint8)
    masks = rng.integers(0, 256, size=(3, 8, 9), dtype=np.uint8)
    runtime.write_pack(str(tmp_path / "a"), images, masks)
    jruntime.write_pack(str(tmp_path / "b"), images, masks)
    crops = [rng.integers(0, 256, size=(3, 3, s, s), dtype=np.uint8) for s in (6, 7)]
    meta = rng.normal(size=(3, 3)).astype(np.float32)
    runtime.write_pack2(str(tmp_path / "c"), *crops, masks, meta)
    jruntime.write_pack2(str(tmp_path / "d"), *crops, masks, meta)
    for mine, theirs in ("ab", "cd"):
        assert (tmp_path / mine).read_bytes() == (tmp_path / theirs).read_bytes()


def test_one_and_four_threads_are_equal(packs):
    idx = np.arange(6)[::-1]
    bb = _bboxes(6, seed=1)
    _assert_batches_equal(runtime.PackReader(packs["port1"], num_threads=1).load_batch(idx, bb),
                          runtime.PackReader(packs["port1"], num_threads=4).load_batch(idx, bb))
    _assert_batches_equal(runtime.Pack2Reader(packs["port2"], num_threads=1).load_batch(idx),
                          runtime.Pack2Reader(packs["port2"], num_threads=4).load_batch(idx))


def test_readers_with_different_thread_counts_load_at_once(packs):
    """Two readers (2 and 5 threads) and a warp (3 threads) in three Python
    threads, with a short switch interval: every load equals its load alone."""
    v1 = runtime.PackReader(packs["port1"], num_threads=2)
    v2 = runtime.Pack2Reader(packs["port2"], num_threads=5)
    idx, bb = np.array([1, 4, 2, 0, 5, 3]), _bboxes(6, seed=2)
    rng = np.random.default_rng(3)
    images = rng.integers(0, 256, size=(7, 33, 41, 3), dtype=np.uint8)
    hom = _homographies(rng, 7)
    jobs = {
        "v1": (lambda: v1.load_batch(idx, bb, spin_res=64, img_res=80)),
        "v2": (lambda: v2.load_batch(idx)),
        "warp": (lambda: {"out": runtime.warp_batch(images, hom, (24, 24), 3)}),
    }
    alone = {name: job() for name, job in jobs.items()}
    errors = []

    def repeat(name):
        try:
            for _ in range(25):
                _assert_batches_equal(jobs[name](), alone[name])
        except Exception as e:  # reported by the main thread
            errors.append((name, e))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=repeat, args=(name,)) for name in jobs]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors


def test_readers_refuse_bad_input(packs, tmp_path):
    reader = runtime.PackReader(packs["port1"])
    with pytest.raises(IndexError):
        reader.load_batch(np.array([0, 6]), _bboxes(2))
    with pytest.raises(ValueError, match="bboxes"):
        reader.load_batch(np.array([0, 1]), _bboxes(3))
    with pytest.raises(IndexError):
        runtime.Pack2Reader(packs["port2"]).load_batch(np.array([-1]))
    # A v1 pack is not a v2 pack, and neither is a text file.
    with pytest.raises(IOError, match="pack2"):
        runtime.Pack2Reader(packs["port1"])
    (tmp_path / "x").write_text("not a pack")
    with pytest.raises(IOError, match="pack"):
        runtime.PackReader(str(tmp_path / "x"))


def test_a_failed_build_raises_with_the_compilers_output(tmp_path, monkeypatch):
    bad = tmp_path / "broken.cc"
    bad.write_text("int main( {\n")
    monkeypatch.setattr(runtime, "_SRC", str(bad))
    monkeypatch.setattr(runtime, "_BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(runtime, "_LIB", str(tmp_path / "build" / "lib.so"))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed(.|\n)*error"):
        runtime.build_library()
    assert os.listdir(tmp_path / "build") == []


def test_the_library_is_rebuilt_when_the_source_is_newer(tmp_path, monkeypatch):
    src = tmp_path / "lib.cc"
    src.write_text('extern "C" int answer() { return 42; }\n')
    monkeypatch.setattr(runtime, "_SRC", str(src))
    monkeypatch.setattr(runtime, "_BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(runtime, "_LIB", str(tmp_path / "build" / "lib.so"))
    lib = runtime.build_library()
    first = os.path.getmtime(lib)
    assert runtime.build_library() == lib and os.path.getmtime(lib) == first
    os.utime(src, (first + 10, first + 10))
    runtime.build_library()
    assert os.path.getmtime(lib) > first
