"""The port's JPEG decoder (jrr_tpu_torch.runtime.decode_jpeg) against
imageio.v2.imread (PIL on libjpeg-turbo), which jrr_tpu's dataset reader
uses, on the CPU.

Files encoded by PIL at quality 75 and 95, in 4:4:4, 4:2:2, 4:2:0 and gray,
with and without restart markers, at odd sizes (and at widths of 1-3
pixels, where libjpeg replicates chroma instead of interpolating); an
extended-sequential (SOF1) file with a 16-bit quantization table; the
committed files of tests/data/jpeg (tests/make_jpeg_fixtures.py). Each
decode is held within 1 level of imageio's, and the count of values that
differ is recorded as a property of the test (the decoder follows
libjpeg's integer arithmetic, so it is 0 on every file here). Progressive, CMYK,
arithmetic-coded and 12-bit files are refused by name.

Then the dataset: a JAX-written fixture directory rewritten as JPEG
(frames and masks) reads through both packages' H36MDataset alike, at
tests/test_torch_data.py's tolerances, and both packages pack it into the
same bytes.
"""

import hashlib
import io
import json
import os
import shutil

import numpy as np
import pytest
from PIL import Image

from jrr_tpu.data import fixtures as jfixtures
from jrr_tpu.data import h36m as jh36m
from jrr_tpu.data import native_pipeline as jnative
from jrr_tpu.models import smpl as jsmpl
from jrr_tpu_torch import runtime
from jrr_tpu_torch.data import h36m, native_pipeline

from tests.test_torch_data import _assert_items_match

imageio = pytest.importorskip("imageio.v2")

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "jpeg")
SUBSAMPLING = {"444": 0, "422": 1, "420": 2}


def _photo(h, w, channels, seed):
    """Smooth gradients with Gaussian texture, as a photo has both."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([np.sin(x / 13.0 + k) * np.cos(y / 19.0 - k) for k in range(channels)], -1)
    img = img * 90 + 128 + rng.normal(scale=20, size=(h, w, channels))
    img = np.clip(img, 0, 255).astype(np.uint8)
    return img[..., 0] if channels == 1 else img


def _encode(img, **options) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", **options)
    return buf.getvalue()


def _hold(got, want, request, name):
    """Within 1 level of imageio's decode; records how many values differ
    as a property of the test (junit XML, legacy family)."""
    assert got.shape == want.shape and got.dtype == np.uint8
    gap = np.abs(got.astype(np.int16) - want.astype(np.int16))
    request.node.user_properties.append((f"{name}_differing_values", int((gap > 0).sum())))
    assert gap.max() <= 1, (name, int(gap.max()), int((gap > 0).sum()))


@pytest.mark.parametrize("restart", [False, True], ids=["no_rst", "rst"])
@pytest.mark.parametrize("kind", ["444", "422", "420", "gray"])
@pytest.mark.parametrize("quality", [75, 95])
def test_decode_matches_imageio(quality, kind, restart, request):
    img = _photo(59, 83, 1 if kind == "gray" else 3, seed=quality)
    options = dict(quality=quality)
    if kind != "gray":
        options["subsampling"] = SUBSAMPLING[kind]
    if restart:
        options["restart_marker_blocks"] = 2
    data = _encode(img, **options)
    assert (b"\xff\xdd" in data) == restart  # DRI
    _hold(runtime.decode_jpeg(data), imageio.imread(io.BytesIO(data)), request,
          f"q{quality}_{kind}")


@pytest.mark.parametrize("shape", [(1, 1), (3, 2), (2, 3), (17, 3), (5, 33)])
@pytest.mark.parametrize("kind", ["422", "420"])
def test_decode_matches_imageio_at_tiny_sizes(shape, kind, request):
    data = _encode(_photo(*shape, 3, seed=shape[1]), quality=90, subsampling=SUBSAMPLING[kind])
    _hold(runtime.decode_jpeg(data), imageio.imread(io.BytesIO(data)), request, kind)


def test_extended_sequential_with_16_bit_tables(request):
    """SOF1 with a 16-bit DQT: PIL writes both when a table entry exceeds 255."""
    tables = [list(range(2, 66)), [200 + 3 * i for i in range(64)]]
    data = _encode(_photo(45, 71, 3, seed=4), qtables=tables, subsampling=1)
    assert b"\xff\xc1" in data
    starts = [i for i in range(len(data) - 4) if data[i : i + 2] == b"\xff\xdb"]
    assert [data[i + 4] >> 4 for i in starts] == [0, 1]  # an 8-bit and a 16-bit table
    _hold(runtime.decode_jpeg(data), imageio.imread(io.BytesIO(data)), request, "sof1")


def _rewrite(data: bytes, marker: bytes, offset: int, value: int) -> bytes:
    i = data.index(marker)
    out = bytearray(data)
    out[i + offset] = value
    return bytes(out)


@pytest.mark.parametrize("feature", ["progressive", "cmyk", "arithmetic", "12-bit"])
def test_unsupported_files_are_refused_by_name(tmp_path, feature):
    rgb = _photo(24, 40, 3, seed=1)
    if feature == "progressive":
        data, match = _encode(rgb, progressive=True), "progressive"
    elif feature == "cmyk":
        buf = io.BytesIO()
        Image.fromarray(rgb).convert("CMYK").save(buf, "JPEG")
        data, match = buf.getvalue(), "CMYK"
    elif feature == "arithmetic":  # SOF0 → SOF9: the same header, another coder
        data, match = _rewrite(_encode(rgb), b"\xff\xc0", 1, 0xC9), "arithmetic"
    else:  # the frame's sample precision byte
        data, match = _rewrite(_encode(rgb), b"\xff\xc0", 4, 12), "12-bit"
    path = tmp_path / f"{feature}.jpg"
    path.write_bytes(data)
    with pytest.raises(NotImplementedError, match=match) as info:
        runtime.decode_jpeg(str(path))
    assert str(path) in str(info.value)


def test_damaged_files_raise(tmp_path):
    data = _encode(_photo(24, 40, 3, seed=2))
    with pytest.raises(runtime.JpegError, match="SOI"):
        runtime.decode_jpeg(b"\x89PNG\r\n\x1a\n")
    with pytest.raises(runtime.JpegError):
        runtime.decode_jpeg(data[: len(data) // 3])
    with pytest.raises(NotImplementedError, match=".png, .jpg or .jpeg"):
        h36m.read_image(str(tmp_path / "frame.bmp"))


@pytest.mark.parametrize("name", ["mask_224x224_gray", "odd_157x93_422_rst"])
def test_committed_files_decode_as_committed(name, request):
    with np.load(os.path.join(DATA, "decodes.npz")) as f:
        want = f[name]
    path = os.path.join(DATA, f"{name}.jpg")
    got = runtime.decode_jpeg(path)
    _hold(got, want, request, name)
    _hold(got, imageio.imread(path), request, f"{name}_live")


def test_committed_frame_decodes_as_committed(request):
    """The 1000² 4:2:0 frame: its decode's SHA-256 is committed (the array
    would outweigh the files); against imageio live, within 1 level."""
    name = "frame_1000x1000_420"
    with open(os.path.join(DATA, "decodes.json")) as f:
        want = json.load(f)[name]
    path = os.path.join(DATA, f"{name}.jpg")
    got = runtime.decode_jpeg(path)
    _hold(got, imageio.imread(path), request, name)
    assert list(got.shape) == want["shape"]
    assert got.sum(axis=(0, 1), dtype=np.int64).tolist() == want["channel_sums"]
    assert hashlib.sha256(got.tobytes()).hexdigest() == want["sha256"]


@pytest.fixture(scope="module")
def jpeg_root(tmp_path_factory):
    """JAX's fixtures (8 frames, two sequences) with every frame and mask
    rewritten as a baseline JPEG (4:2:0, quality 90) and images.json
    pointing at them."""
    root = str(tmp_path_factory.mktemp("jpeg_fixtures"))
    model = jsmpl.synthetic_smpl_model(seed=0, num_verts=256, num_faces=500)
    jfixtures.write_fixture_dataset(root, num_frames=8, seed=1, model=model)
    listing = os.path.join(root, "precomputed_val", "images.json")
    with open(listing) as f:
        paths = json.load(f)
    jpegs = []
    for path in paths:
        head, tail = path.split("imageSequence")
        for src in (path, f"{head}maskSequence{tail}"):
            dst = src[: -len(".png")] + ".jpg"
            Image.open(src).save(dst, "JPEG", quality=90, subsampling=2)
            os.remove(src)
        jpegs.append(path[: -len(".png")] + ".jpg")
    with open(listing, "w") as f:
        json.dump(jpegs, f)
    return root


def test_dataset_items_on_jpeg_frames_match_jax(jpeg_root):
    ds, jds = h36m.H36MDataset(jpeg_root), jh36m.H36MDataset(jpeg_root)
    assert ds.images[0].endswith(".jpg") and len(ds) == len(jds) == 8
    for i in range(len(ds)):
        item = ds[i]
        assert item["mask_rcnn"].shape == (1, 224, 224)
        _assert_items_match(item, jds[i])
    _assert_items_match(ds.load_batch([7, 0]), jds.load_batch([7, 0]))


def test_packs_of_jpeg_frames_are_byte_identical(jpeg_root, tmp_path):
    root = str(tmp_path / "fixtures")
    shutil.copytree(jpeg_root, root)
    mine = native_pipeline.pack_dataset(root, out_path=str(tmp_path / "port.jrrpack"))
    theirs = jnative.pack_dataset(root, out_path=str(tmp_path / "jax.jrrpack"))
    with open(mine, "rb") as f, open(theirs, "rb") as g:
        assert f.read() == g.read()
