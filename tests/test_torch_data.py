"""The port's data path against jrr_tpu on the CPU: the PNG codec, the crop
and bilinear warp, the fixtures, the dataset reader and the batch loader.

Tolerances: PNG pixels equal. The bilinear sampler on one grid 1e-6. The
sampling grids 5e-7 (a few float32 ulp: XLA's CPU division is not
correctly rounded, so jnp.linspace(-1, 1, 224) differs from the correctly
rounded −(1 − i/223) + i/223 in 137 of 223 points;
tests/torch_pipeline_report.py measures it). Warped and cropped
values 2e-4: a grid error of 2.4e-7 is 1.2e-4 px at 500 px per grid unit,
and a value moves at most that far for images in [0, 1] (neighbour steps
≤ 1). Crop intrinsics 1e-3 (values ~1e3 in float32), origins and gt_j2d
1e-4 px, masks and every other dataset key equal.
"""

import json
import os
import struct
import zlib

import numpy as np
import pytest
import torch

from jrr_tpu.data import crop as jcrop
from jrr_tpu.data import fixtures as jfixtures
from jrr_tpu.data import h36m as jh36m
from jrr_tpu.models import smpl as jsmpl
from jrr_tpu.ops import sampling as jsampling
from jrr_tpu_torch.data import crop, fixtures, h36m, png
from jrr_tpu_torch.models import smpl
from jrr_tpu_torch.ops import sampling

imageio = pytest.importorskip("imageio.v2")


def _filter_types(data: bytes) -> set:
    """The filter type byte of every row of an 8-bit PNG."""
    pos, idat, header = 8, [], None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        kind, body = data[pos + 4 : pos + 8], data[pos + 8 : pos + 8 + length]
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        pos += 12 + length
    w, h, _, color_type, *_ = header
    stride = w * {0: 1, 2: 3, 4: 2, 6: 4}[color_type] + 1
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, stride)
    return set(raw[:, 0].tolist())


@pytest.mark.parametrize("shape", [(224, 224), (61, 37), (48, 40, 3), (33, 20, 4), (16, 16, 2)])
def test_png_written_by_port_reads_back_through_imageio(tmp_path, shape):
    img = np.random.default_rng(0).integers(0, 256, shape).astype(np.uint8)
    path = str(tmp_path / "x.png")
    png.write(path, img)
    np.testing.assert_array_equal(np.asarray(imageio.imread(path)), img)
    np.testing.assert_array_equal(png.read(path), img)


@pytest.mark.parametrize("kind", ["gray", "rgb"])
def test_png_written_by_imageio_reads_through_port(tmp_path, kind):
    """imageio's adaptive filters, Paeth rows included, undone exactly."""
    rng = np.random.default_rng(1)
    if kind == "gray":
        img = np.zeros((224, 224), np.uint8)
        img[50:150, 60:170] = 255
        img[100:120] = rng.integers(0, 256, (20, 224))
    else:
        img = np.zeros((300, 280, 3), np.uint8)
        img[50:250, 40:200] = 180
        img[120:160, :, 1] = rng.integers(0, 256, (40, 280))
    path = str(tmp_path / "x.png")
    imageio.imwrite(path, img)
    with open(path, "rb") as f:
        assert 4 in _filter_types(f.read())  # Paeth rows present
    np.testing.assert_array_equal(png.read(path), img)


def _reference_filter(kind, row, prev, bpp):
    """The PNG spec's filters, one byte at a time (the encoder side)."""
    out = bytearray(len(row))
    for i in range(len(row)):
        a = row[i - bpp] if i >= bpp else 0
        b = prev[i]
        c = prev[i - bpp] if i >= bpp else 0
        if kind == 0:
            pred = 0
        elif kind == 1:
            pred = a
        elif kind == 2:
            pred = b
        elif kind == 3:
            pred = (a + b) // 2
        else:
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        out[i] = (row[i] - pred) % 256
    return bytes([kind]) + bytes(out)


@pytest.mark.parametrize("channels", [1, 3])
def test_png_reader_undoes_all_five_filters(channels):
    """Rows filtered with None, Sub, Up, Average and Paeth in turn."""
    rng = np.random.default_rng(2)
    h, w = 15, 23
    img = rng.integers(0, 256, (h, w, channels)).astype(np.uint8)
    stride = w * channels
    rows, prev = [], bytes(stride)
    for y in range(h):
        row = img[y].reshape(-1).tobytes()
        rows.append(_reference_filter(y % 5, row, prev, channels))
        prev = row
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 0 if channels == 1 else 2, 0, 0, 0)
    data = png._SIGNATURE + png._chunk(b"IHDR", ihdr) + png._chunk(
        b"IDAT", zlib.compress(b"".join(rows))) + png._chunk(b"IEND", b"")
    got = png.decode(data)
    np.testing.assert_array_equal(got, img[..., 0] if channels == 1 else img)


def test_png_refuses_what_it_cannot_read():
    good = png.encode(np.zeros((4, 4), np.uint8))
    bad_crc = bytearray(good)
    bad_crc[-20] ^= 1  # inside the IDAT body
    with pytest.raises(ValueError, match="CRC"):
        png.decode(bytes(bad_crc))
    sixteen = png._SIGNATURE + png._chunk(
        b"IHDR", struct.pack(">IIBBBBB", 4, 4, 16, 0, 0, 0, 0)) + png._chunk(b"IEND", b"")
    with pytest.raises(NotImplementedError, match="bit depth 16"):
        png.decode(sixteen)


def _crop_inputs(seed=0, batch=3):
    rng = np.random.default_rng(seed)
    image = rng.uniform(size=(batch, 3, 1000, 1000)).astype(np.float32)
    lo = rng.uniform(-80, 600, size=(batch, 2))
    side = rng.uniform(150, 500, size=(batch, 1))
    bbox = np.concatenate([lo, lo + side * rng.uniform(0.8, 1.2, size=(batch, 2))], 1)
    intr = np.tile(np.array([[1100, 0, 500], [0, 1100, 500], [0, 0, 1]], np.float32), (batch, 1, 1))
    intr[:, :2, 2] += rng.normal(scale=10, size=(batch, 2))
    return image, bbox.astype(np.float32), intr.astype(np.float32)


@pytest.mark.parametrize("img_size", [224, 256])
def test_find_crop_matches_jax(img_size):
    image, bbox, intr = _crop_inputs()
    want = jcrop.find_crop(image, bbox, intr, img_size=img_size)
    got = crop.find_crop(torch.as_tensor(image), torch.as_tensor(bbox), torch.as_tensor(intr),
                         img_size=img_size)
    np.testing.assert_allclose(got.image.numpy(), np.asarray(want.image), atol=2e-4)
    for key in ("min_x", "min_y", "scale"):
        np.testing.assert_allclose(getattr(got, key).numpy(), np.asarray(getattr(want, key)),
                                   atol=1e-4, err_msg=key)
    np.testing.assert_allclose(got.intrinsics.numpy(), np.asarray(want.intrinsics), atol=1e-3)
    j2d = np.random.default_rng(3).uniform(0, 1000, size=(3, 17, 2)).astype(np.float32)
    np.testing.assert_allclose(
        crop.reposition_j2d(torch.as_tensor(j2d), got.min_x, got.min_y, got.scale).numpy(),
        np.asarray(jcrop.reposition_j2d(j2d, want.min_x, want.min_y, want.scale)), atol=1e-4,
    )


def _homographies(rng):
    """Perspective homographies: rotation and shear, a divide by w ≠ 1."""
    hom = np.tile(np.eye(3, dtype=np.float32), (2, 1, 1))
    hom[:, :2, :2] += rng.normal(scale=0.2, size=(2, 2, 2))
    hom[:, :2, 2] = rng.normal(scale=0.3, size=(2, 2))
    hom[:, 2, :2] = rng.normal(scale=0.05, size=(2, 2))
    return hom


def test_warp_image_matches_jax():
    """Uniform noise with NaN pixels in the source: the grids agree to a few
    ulp, the sampler on JAX's grid to 1e-6, the warp to 2e-4, and the scrub
    leaves zeros where JAX does."""
    rng = np.random.default_rng(4)
    image = rng.uniform(size=(2, 3, 1000, 1000)).astype(np.float32)
    image[0, :, 400:420, 500:530] = np.nan
    hom = _homographies(rng)
    grid = np.array(jsampling.make_warp_grid(hom, (224, 200)))
    np.testing.assert_allclose(
        sampling.make_warp_grid(torch.as_tensor(hom), (224, 200)).numpy(), grid, atol=5e-7)
    clean = np.nan_to_num(image)
    np.testing.assert_allclose(
        sampling.grid_sample(torch.as_tensor(clean), torch.as_tensor(grid)).numpy(),
        np.asarray(jsampling.grid_sample(clean, grid)), atol=1e-6)
    want = np.asarray(jsampling.warp_image(image, hom, (224, 200)))
    got = sampling.warp_image(torch.as_tensor(image), torch.as_tensor(hom), (224, 200)).numpy()
    assert not np.isnan(got).any()
    np.testing.assert_array_equal(got == 0, want == 0)
    np.testing.assert_allclose(got, want, atol=2e-4)


@pytest.fixture(scope="module")
def jax_fixture_root(tmp_path_factory):
    """8 frames in two sequences, written by JAX's fixtures (imageio PNGs)."""
    root = str(tmp_path_factory.mktemp("jax_fixtures"))
    model = jsmpl.synthetic_smpl_model(seed=0, num_verts=256, num_faces=500)
    jfixtures.write_fixture_dataset(root, num_frames=8, seed=0, model=model)
    return root


@pytest.fixture(scope="module")
def port_fixture_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("port_fixtures"))
    model = smpl.synthetic_smpl_model(seed=0, num_verts=256, num_faces=500, device="cpu")
    fixtures.write_fixture_dataset(root, num_frames=8, seed=0, model=model)
    return root


def _assert_items_match(got, want):
    assert set(got) == set(want)
    for key in want:
        if key in ("image", "spin_image"):
            np.testing.assert_allclose(got[key], want[key], atol=2e-4, err_msg=key)
        elif key == "gt_j2d":
            np.testing.assert_allclose(got[key], want[key], atol=1e-4, err_msg=key)
        elif key == "intrinsics":
            np.testing.assert_allclose(got[key], want[key], atol=1e-3, err_msg=key)
        else:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_dataset_items_match_jax(writer, jax_fixture_root, port_fixture_root):
    """Both packages' H36MDataset read one fixture directory alike, whether
    JAX's fixtures (imageio PNGs) or the port's (its own PNG writer) wrote it."""
    root = jax_fixture_root if writer == "jax" else port_fixture_root
    jds, ds = jh36m.H36MDataset(root), h36m.H36MDataset(root)
    assert len(ds) == len(jds) == 8
    for a, b in zip(ds.frame_order(), jds.frame_order()):
        np.testing.assert_array_equal(a, b)
    for i in range(len(ds)):
        item = ds[i]
        assert item["valid"] and item["mask_rcnn"].shape == (1, 224, 224)
        assert item["image"].shape == (3, 256, 256) and item["spin_image"].shape == (3, 224, 224)
        _assert_items_match(item, jds[i])
    _assert_items_match(ds.load_batch([5, 2]), jds.load_batch([5, 2]))


def test_port_fixtures_are_self_consistent(port_fixture_root):
    """The schema of JAX's fixtures, and masks that are renders: the
    silhouette covers the 2D joints' neighbourhood and the marker pixel set."""
    with np.load(os.path.join(port_fixture_root, "precomputed_val", "tensors.npz")) as f:
        keys = set(f.files)
    assert keys == set(h36m.TENSOR_KEYS) | {"seq_id", "frame_id"}
    with open(os.path.join(port_fixture_root, "precomputed_val", "images.json")) as f:
        images = json.load(f)
    assert [os.path.basename(os.path.dirname(p)) for p in images] == ["seq000"] * 4 + ["seq001"] * 4
    mask = png.read(images[0].replace("imageSequence", "maskSequence"))
    assert mask.shape == (224, 224) and mask[0, 0] == 255 and 0.02 < (mask > 127).mean() < 0.9


@pytest.mark.parametrize("epoch", [0, 1, 3])
def test_batch_loader_matches_jax(epoch, jax_fixture_root):
    """The same (seed, epoch) permutation, batch count and, at epoch 0, batches."""
    jloader = jh36m.BatchLoader(jh36m.H36MDataset(jax_fixture_root), 3, seed=5, drop_last=True)
    loader = h36m.BatchLoader(h36m.H36MDataset(jax_fixture_root), 3, seed=5, drop_last=True)
    jloader.set_epoch(epoch)
    loader.set_epoch(epoch)
    np.testing.assert_array_equal(loader._indices(), jloader._indices())
    assert len(loader) == len(jloader) == 2
    if epoch == 0:
        got, want = list(loader), list(jloader)
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g["gt_j3d"], w["gt_j3d"])


def test_batch_loader_raises_the_worker_exception():
    """An exception while loading a batch reaches the consumer (jrr_tpu's
    loader thread ends the iteration quietly instead)."""

    class Broken:
        def __len__(self):
            return 4

        def __getitem__(self, i):
            if i == 2:
                raise KeyError("frame 2 is missing")
            return {"x": np.zeros(1)}

    loader = h36m.BatchLoader(Broken(), 1, shuffle=False)
    with pytest.raises(KeyError, match="frame 2"):
        list(loader)


def test_background_iter_stops_its_thread_when_closed():
    import threading

    before = threading.active_count()
    it = h36m.background_iter(iter(range(1000)), depth=1)
    assert next(it) == 0
    it.close()
    assert threading.active_count() == before


def test_unported_frame_sources_raise(tmp_path, port_fixture_root):
    """A data.h5 is read as HDF5 now (tests/test_torch_hdf5.py holds that
    mode against jrr_tpu's): one that is not HDF5 raises naming the file.
    Frame files other than PNG or JPEG raise."""
    import shutil

    root = str(tmp_path / "r")
    shutil.copytree(port_fixture_root, root)
    h5_path = os.path.join(root, "data.h5")
    open(h5_path, "w").close()
    with pytest.raises(OSError, match="no HDF5 signature") as err:
        h36m.H36MDataset(root)
    assert h5_path in str(err.value)
    os.remove(h5_path)
    images = os.path.join(root, "precomputed_val", "images.json")
    with open(images) as f:
        paths = json.load(f)
    with open(images, "w") as f:
        json.dump([p.replace(".png", ".bmp") for p in paths], f)
    with pytest.raises(NotImplementedError, match=".png, .jpg or .jpeg"):
        h36m.H36MDataset(root)[0]
