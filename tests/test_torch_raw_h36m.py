"""The port's raw-Human3.6M preparation (jrr_tpu_torch/data/raw_h36m.py)
against jrr_tpu's on the CPU: every returned array equal (paths, GT joints
reindexed by GT_2_J17, per-camera intrinsics), and the refined shards of a
run joined equally."""

import os

import numpy as np
import pytest

from jrr_tpu.data import raw_h36m as jraw
from jrr_tpu.utils.checkpoint import ShardManifest as JManifest
from jrr_tpu_torch import constants
from jrr_tpu_torch.data import raw_h36m

h5py = pytest.importorskip("h5py")

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "h5")


def _equal(got, want):
    assert set(got) == set(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_index_map_is_jax_s():
    from jrr_tpu import constants as jconstants

    assert constants.GT_2_J17 == jconstants.GT_2_J17


@pytest.mark.parametrize("split", ["validation", "train"])
def test_load_raw_equals_jax(tmp_path, split):
    """The layout of tests/test_aux_components.py's raw test, one scene per
    actor of both splits, plus a scene of 1100 frames."""
    rng = np.random.default_rng(5)
    for actor, n in (("S9", 5), ("S11", 1100), ("S1", 4), ("S8", 3)):
        scene = tmp_path / actor / "scene1"
        os.makedirs(scene)
        with h5py.File(scene / "annot.h5", "w") as f:
            f["camera"] = rng.choice([54, 55, 58], size=n)
            f["frame"] = np.arange(1, n + 1)
            f["pose/2d"] = rng.normal(size=(n, 32, 2))
            f["pose/3d"] = rng.normal(size=(n, 32, 3))
            g = f.create_group("intrinsics")
            for cam in ("54", "55", "58"):
                g[cam] = rng.uniform(400, 1200, size=4)
    got = raw_h36m.load_raw_h36m(str(tmp_path), split)
    _equal(got, jraw.load_raw_h36m(str(tmp_path), split))
    assert got["gt_j3d"].shape[1:] == (17, 3) and got["intrinsics"][0, 2, 2] == 1.0


def test_committed_tree_equals_jax_committed_output():
    root = os.path.join(DATA, "raw")
    with np.load(os.path.join(DATA, "raw_expected.npz")) as f:
        expected = dict(f)
    for split in ("train", "validation"):
        got = raw_h36m.load_raw_h36m(root, split)
        got["images"] = np.asarray([os.path.relpath(p, root) for p in got["images"]])
        _equal(got, {k.split("/", 1)[1]: v for k, v in expected.items()
                     if k.startswith(split + "/")})


def test_load_precomputed_outputs_equals_jax(tmp_path):
    man = JManifest(str(tmp_path))
    man.write_shard(1, {"betas": np.ones((4, 10)), "cam_t": np.zeros((4, 3), np.float32)})
    man.write_shard(0, {"betas": np.zeros((4, 10)), "cam_t": np.ones((4, 3), np.float32)})
    _equal(raw_h36m.load_precomputed_outputs(str(tmp_path)),
           jraw.load_precomputed_outputs(str(tmp_path)))
    assert raw_h36m.load_precomputed_outputs(str(tmp_path / "none")) == {}
