"""Writes the committed HDF5 test files of tests/data/h5/ with h5py, and what
h5py and jrr_tpu read from them beside them:

- layouts.h5: every layout jrr_tpu_torch/data/hdf5.py reads: integers and
  floats of 1-8 bytes in both byte orders, scalars, the compact and
  contiguous layouts, datasets never written (read as their fill value),
  chunked datasets with edge chunks, missing chunks, deflate + shuffle,
  fletcher32, a chunk stored with its deflate skipped (filter mask 1), a
  resizable one, groups five deep with attributes, and a group of 1100
  links (a symbol table B-tree of several levels), each to one of seven
  datasets; layouts_decodes.npz holds h5py's decode of each dataset
  (keys listed in layouts_decodes.json, the big group's values stacked);
- latest.h5 (libver="latest": a version 3 superblock) and compound.h5 (a
  compound datatype): two files the reader must refuse;
- dataset/: a 4-frame dataset written by jrr_tpu's fixtures and repacked
  into the single-file data.h5 as tests/test_h5_mode.py does, chunked
  (3, 256, 256) with deflate and shuffle; dataset_batch.npz holds
  jrr_tpu's H36MDataset batch of its four frames;
- raw/: processed Human3.6M trees (S1, S9 and S11 scenes with annot.h5 on
  the layout of tests/test_aux_components.py); raw_expected.npz holds
  jrr_tpu's `load_raw_h36m` of each split, image paths relative to raw/.

    python tests/make_h5_fixtures.py

Needs h5py, imageio and JAX (on the CPU). tests/test_torch_hdf5.py,
tests/test_torch_raw_h36m.py and chip_smoke.py's h5_check read the files.
The data is drawn from seeds; rerunning rewrites the same values.
"""

import json
import os
import shutil
import sys

import h5py
import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "data", "h5")
BIG_GROUP = 1100  # > 1000 links: the group's B-tree grows past one level
FRAMES = 4


def write_layouts(path: str) -> None:
    rng = np.random.default_rng(0)
    with h5py.File(path, "w") as f:
        f.attrs["title"] = "layouts"
        for code in ("u1", "i1", "u2", "i2", "u4", "i4", "u8", "i8"):
            info = np.iinfo(code)
            data = rng.integers(info.min, info.max, size=(5, 7), dtype=code, endpoint=True)
            f[f"ints/{code}"] = data
            f[f"big_endian/{code}"] = data.astype(">" + code)
        for code in ("f2", "f4", "f8"):
            data = rng.normal(scale=100, size=(3, 4, 5)).astype(code)
            f[f"floats/{code}"] = data
            f[f"big_endian/{code}"] = data.astype(">" + code)
        f["scalar/f8"] = np.float64(-2.75)
        f["scalar/i4"] = np.int32(-123456)
        dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
        dcpl.set_layout(h5py.h5d.COMPACT)
        f.create_dataset("compact/i2", data=np.arange(-20, 20, dtype="i2").reshape(8, 5),
                         dcpl=dcpl)
        f.create_dataset("unwritten/contiguous", shape=(5, 3), dtype="f4", fillvalue=2.5)
        f.create_dataset("unwritten/chunked", shape=(6,), dtype="<i8", chunks=(4,), fillvalue=-1)
        f.create_dataset("unwritten/default", shape=(2, 2), dtype=">u2")
        chunked = f.create_group("chunked")
        chunked.attrs["note"] = np.arange(3)
        image = rng.uniform(size=(37, 23, 3)).astype("f4")
        image[5:20, 3:9] = 0.0
        chunked.create_dataset("gzip_shuffle", data=image, chunks=(8, 8, 3), compression="gzip",
                               shuffle=True)
        chunked.create_dataset("plain", data=rng.integers(-999, 999, size=(10, 7), dtype="i2"),
                               chunks=(4, 4))
        chunked.create_dataset("fletcher32", data=rng.normal(size=(9, 11)), chunks=(4, 5),
                               fletcher32=True)
        chunked.create_dataset("all_three", data=rng.integers(0, 1 << 30, size=(13, 6),
                                                              dtype="i4").astype(">i4"),
                               chunks=(5, 4), compression="gzip", compression_opts=9,
                               shuffle=True, fletcher32=True)
        partial = chunked.create_dataset("partial", shape=(9, 9), dtype="f8", chunks=(4, 4),
                                         fillvalue=9.0)
        partial[0:4, 4:8] = rng.normal(size=(4, 4))
        partial[8, 8] = -1.0
        resizable = chunked.create_dataset("resizable", data=np.arange(12, dtype="u4").reshape(3, 4),
                                           maxshape=(None, 4), chunks=(2, 4))
        resizable.resize((5, 4))
        resizable[3:] = 77
        skipped = chunked.create_dataset("mask_skipped", shape=(4, 4), dtype="<u2", chunks=(2, 4),
                                         compression="gzip")
        skipped[0:2] = 5
        # The second chunk stored raw, its deflate marked skipped.
        raw = np.arange(8, dtype="<u2").reshape(2, 4)
        skipped.id.write_direct_chunk((2, 0), raw.tobytes(), filter_mask=1)
        f.create_dataset("deep/a/b/c/d/leaf", data=np.arange(6, dtype="f8"))
        f["deep/a"].attrs["depth"] = 1
        targets = [f.create_dataset(f"targets/v{j}", data=np.int32(1000 + j)) for j in range(7)]
        big = f.create_group("big")
        for i in range(BIG_GROUP):
            big[f"e{i:04d}"] = targets[(i * 3) % 7]


def h5py_decodes(path: str) -> dict:
    out = {}
    with h5py.File(path, "r") as f:
        def visit(name, obj):
            if isinstance(obj, h5py.Dataset) and not name.startswith("big/"):
                out[name] = obj[()]
        f.visititems(visit)
        out["big/*"] = np.stack([f[f"big/e{i:04d}"][()] for i in range(BIG_GROUP)])
    return out


def write_refused() -> None:
    with h5py.File(os.path.join(OUT, "latest.h5"), "w", libver="latest") as f:
        f["x"] = np.arange(4)
    with h5py.File(os.path.join(OUT, "compound.h5"), "w") as f:
        f["x"] = np.zeros(3, dtype=[("a", "<i4"), ("b", "<f8")])


def write_dataset(root: str) -> None:
    """jrr_tpu's fixture dataset, its frames repacked into data.h5 and the
    PNGs removed (images.json keeps five-part paths for the h5 keys)."""
    import imageio.v2 as imageio

    from jrr_tpu.data import fixtures, h36m

    tmp = root + ".png"
    shutil.rmtree(tmp, ignore_errors=True)
    shutil.rmtree(root, ignore_errors=True)
    fixtures.write_fixture_dataset(tmp, num_frames=FRAMES, seed=9)
    png = h36m.H36MDataset(tmp, "validation")
    os.makedirs(os.path.join(root, "precomputed_val"))
    shutil.copy(os.path.join(tmp, "precomputed_val", "tensors.npz"),
                os.path.join(root, "precomputed_val", "tensors.npz"))
    opts = dict(compression="gzip", shuffle=True)
    paths = []
    with h5py.File(os.path.join(root, "data.h5"), "w") as f:
        for i, path in enumerate(png.images):
            img = imageio.imread(path)
            head, tail = path.split("imageSequence")
            mask = imageio.imread(f"{head}maskSequence{tail}")
            key = f"S9/scene/imageSequence/54/img_{i:06d}.png"
            f.create_dataset(key, data=np.transpose(img, (2, 0, 1)).astype(np.float32) / 255.0,
                             chunks=(3, 256, 256), **opts)
            f.create_dataset(key.replace("imageSequence", "maskSequence"),
                             data=mask[None].astype(np.float32), chunks=(1, 224, 224), **opts)
            paths.append(f"/x/{key}")
    with open(os.path.join(root, "precomputed_val", "images.json"), "w") as fp:
        json.dump(paths, fp)
    shutil.rmtree(tmp)
    ds = h36m.H36MDataset(root, "validation")
    assert ds.use_h5
    batch = ds.load_batch(np.arange(FRAMES))
    np.savez_compressed(os.path.join(OUT, "dataset_batch.npz"), **batch)


def write_raw(root: str) -> None:
    from jrr_tpu.data import raw_h36m

    shutil.rmtree(root, ignore_errors=True)
    rng = np.random.default_rng(3)
    scenes = {"S1": ("Directions", "Walking 1"), "S9": ("Eating", "Sitting 2"), "S11": ("Posing",)}
    for actor, names in scenes.items():
        for scene in names:
            d = os.path.join(root, actor, scene)
            os.makedirs(d)
            n = int(rng.integers(3, 7))
            cams = np.asarray([54138969, 55011271, 58860488, 60457274])
            with h5py.File(os.path.join(d, "annot.h5"), "w") as f:
                f["camera"] = rng.choice(cams, size=n)
                f["frame"] = np.sort(rng.choice(np.arange(1, 3000), size=n, replace=False))
                f["pose/2d"] = rng.normal(scale=300, size=(n, 32, 2))
                f["pose/3d"] = rng.normal(scale=500, size=(n, 32, 3)).astype(np.float32)
                g = f.create_group("intrinsics")
                for cam in cams:
                    g[str(cam)] = rng.uniform(400, 1200, size=4)
    expected = {}
    for split in ("train", "validation"):
        out = raw_h36m.load_raw_h36m(root, split)
        out["images"] = np.asarray([os.path.relpath(p, root) for p in out["images"]])
        expected.update({f"{split}/{k}": v for k, v in out.items()})
    np.savez_compressed(os.path.join(OUT, "raw_expected.npz"), **expected)


def main():
    sys.path.insert(0, os.path.dirname(HERE))
    import jax

    jax.config.update("jax_platforms", "cpu")
    os.makedirs(OUT, exist_ok=True)
    layouts = os.path.join(OUT, "layouts.h5")
    write_layouts(layouts)
    decodes = h5py_decodes(layouts)
    names = sorted(decodes)
    with open(os.path.join(OUT, "layouts_decodes.json"), "w") as f:
        json.dump({f"a{i:03d}": name for i, name in enumerate(names)}, f, indent=1)
    np.savez_compressed(os.path.join(OUT, "layouts_decodes.npz"),
                        **{f"a{i:03d}": decodes[name] for i, name in enumerate(names)})
    write_refused()
    write_dataset(os.path.join(OUT, "dataset"))
    write_raw(os.path.join(OUT, "raw"))


if __name__ == "__main__":
    main()
