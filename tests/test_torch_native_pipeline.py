"""The port's pack loader (jrr_tpu_torch.data.native_pipeline) against
jrr_tpu's on the CPU, on one JAX-written fixture directory (8 frames, two
sequences):
- PackedH36MDataset batches in all three `prewarped` modes, every key equal
  (the runtimes agree bit for bit, tests/test_torch_runtime.py), the stored
  intrinsics included (jrr_tpu's native quirk, kept);
- `batches()` over two epochs, equal batch for batch;
- `run_pipeline(loader="native")` against jrr_tpu's on that directory, the
  port starting from JAX's initial TrainState, at the tolerances of
  tests/test_torch_pipeline.py's python-loader runs (without the
  silhouette: parameters 1e-4, the Adam-path regressor 1e-5 relative, the
  lstsq regressor 2.5e-3, evals 1e-3 mm and 0.05 mm; with it at 112²:
  parameters 1e-3, evals 0.05 mm). The port reads the packs JAX wrote;
- `loader="auto"` takes the v1 pack when the split has one, the v2 pack
  when it has that too, and the python loader otherwise.
"""

import shutil

import numpy as np
import pytest

from jrr_tpu.data import fixtures as jfixtures
from jrr_tpu.data import native_pipeline as jnative
from jrr_tpu.models import smpl as jsmpl
from jrr_tpu_torch import pipeline
from jrr_tpu_torch.data import h36m, native_pipeline

from tests.test_torch_pipeline import (  # noqa: F401
    PARAMS, _assert_evals, _close_rel, _jax_cfg, _port_cfg, _port_run, _run_both, _shards,
    port_root)


@pytest.fixture(scope="module")
def jax_root(tmp_path_factory):
    """JAX's demo fixtures (8 frames, seed 0, the demo's true regressor)."""
    root = str(tmp_path_factory.mktemp("fixtures"))
    model = jsmpl.synthetic_smpl_model(seed=0, num_verts=256, num_faces=500)
    j_true = pipeline._demo_regressor(model.num_verts, np.random.default_rng(0))
    jfixtures.write_fixture_dataset(root, num_frames=8, seed=0, model=model, j_reg_raw=j_true)
    return root


@pytest.fixture(scope="module")
def datasets(jax_root, tmp_path_factory):
    """(port, JAX) PackedH36MDataset per mode, each package on its own copy
    of the fixtures, building its own packs."""
    roots = {}
    for who in ("port", "jax"):
        roots[who] = str(tmp_path_factory.mktemp(who) / "fixtures")
        shutil.copytree(jax_root, roots[who])
    out = {}
    for mode in (False, True, "auto"):  # "auto" finds the v2 pack True built
        out[mode] = (native_pipeline.PackedH36MDataset(roots["port"], prewarped=mode),
                     jnative.PackedH36MDataset(roots["jax"], prewarped=mode))
    return out


def _assert_equal(got, want):
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


@pytest.mark.parametrize("mode", [False, True, "auto"], ids=["v1", "v2", "auto"])
def test_packed_batches_equal_jax(datasets, mode):
    ds, jds = datasets[mode]
    assert ds.prewarped == jds.prewarped == (mode is not False)
    assert len(ds) == len(jds) == 8
    idx = np.array([6, 1, 3, 3, 0])
    got = ds.load_batch(idx)
    _assert_equal(got, jds.load_batch(idx))
    assert got["image"].shape == (5, 3, 256, 256) and got["spin_image"].shape == (5, 3, 224, 224)
    assert got["mask_rcnn"].shape == (5, 1, 224, 224) and got["valid"].all()
    np.testing.assert_array_equal(got["intrinsics"], ds.base.tensors["intrinsics"][idx])
    for a, b in zip(ds.frame_order(), jds.frame_order()):
        np.testing.assert_array_equal(a, b)


def test_packed_batches_stay_near_the_python_loader(datasets):
    """jrr_tpu's own tolerances (tests/test_native_pipeline.py): v1 against
    the python loader's crops 2e-2 and gt_j2d 0.5 px, v2 against v1 1.01/255."""
    v1, v2 = datasets[False][0], datasets[True][0]
    idx = np.array([0, 5, 2])
    py = v1.base.load_batch(idx)
    a, b = v1.load_batch(idx), v2.load_batch(idx)
    for key in ("image", "spin_image"):
        np.testing.assert_allclose(a[key], py[key], atol=2e-2, err_msg=key)
        np.testing.assert_allclose(b[key], a[key], atol=1.01 / 255, err_msg=key)
    np.testing.assert_allclose(a["gt_j2d"], py["gt_j2d"], atol=0.5)
    np.testing.assert_allclose(b["mask_rcnn"], a["mask_rcnn"], atol=1.01 / 255)
    for key in ("gt_j2d", "betas", "cam", "gt_j3d"):
        np.testing.assert_allclose(b[key], a[key], atol=1e-6, err_msg=key)


@pytest.mark.parametrize("mode", [False, True], ids=["v1", "v2"])
def test_batches_follow_jax_over_two_epochs(datasets, mode):
    ds, jds = datasets[mode]
    for epoch in (0, 1):
        got = list(ds.batches(3, seed=5, epoch=epoch))
        want = list(jds.batches(3, seed=5, epoch=epoch))
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            _assert_equal(g, w)
    order = h36m.BatchLoader(ds.base, 3, seed=5, drop_last=True)._indices()
    first = next(ds.batches(3, seed=5))
    np.testing.assert_array_equal(first["gt_j3d"], ds.base.tensors["gt_j3d"][order[:3]])


@pytest.fixture(scope="module")
def native_runs(jax_root, tmp_path_factory):
    """Both packages' run_pipeline(demo=True, loader="native") on one
    fixture directory, per configuration, once per module."""
    root = str(tmp_path_factory.mktemp("native_runs") / "fixtures")
    shutil.copytree(jax_root, root)
    configs = {"no_silhouette": _jax_cfg(False, 15),
               "silhouette_112": _jax_cfg(True, 3, image_size=112)}
    done = {}

    def run(name):
        if name not in done:
            with pytest.MonkeyPatch.context() as mp:
                done[name] = _run_both(tmp_path_factory.mktemp(name), mp, configs[name], root,
                                       loader="native")
        return done[name]

    return run


def test_native_pipeline_matches_jax_without_silhouette(native_runs):
    jarts, arts, jlstsq = native_runs("no_silhouette")
    assert arts.loader == "pack"
    np.testing.assert_array_equal(arts.j_reg_initial, jarts.j_reg_initial)
    for got, want in zip(_shards(arts.out_dir), _shards(jarts.out_dir)):
        np.testing.assert_array_equal(got["gt_j3d"], want["gt_j3d"])
        for k in PARAMS:
            np.testing.assert_allclose(got[k], want[k], atol=1e-4, err_msg=k)
    _close_rel(arts.j_reg_final, jarts.j_reg_final, 1e-5)
    np.testing.assert_allclose(arts.j_reg_lstsq, jarts.j_reg_lstsq, atol=2.5e-3)
    _assert_evals(arts, jarts, jlstsq, 1e-3, 0.05)


def test_native_pipeline_matches_jax_with_silhouette(native_runs):
    jarts, arts, jlstsq = native_runs("silhouette_112")
    assert arts.loader == "pack"
    for got, want in zip(_shards(arts.out_dir), _shards(jarts.out_dir)):
        for k in PARAMS:
            np.testing.assert_allclose(got[k], want[k], atol=1e-3, err_msg=k)
    _assert_evals(arts, jarts, jlstsq, 0.05, 0.05)


def test_auto_takes_the_pack(tmp_path, port_root):
    """No pack: the python loader. frames.jrrpack: the v1 pack. With
    frames.jrrpack2 too: the v2 pack. The three runs' stored-estimate
    evals agree (the packs move the crops, not the stored tensors)."""
    root = str(tmp_path / "fixtures")
    shutil.copytree(port_root, root)
    cfg = _port_cfg(use_silhouette=False)
    runs = {}
    for step in ("python", "pack", "pack2"):
        if step == "pack":
            native_pipeline.pack_dataset(root)
        elif step == "pack2":
            native_pipeline.build_pack2(root)
        runs[step] = _port_run(cfg, root, str(tmp_path / step), loader="auto")
        assert runs[step].loader == step
    for step in ("pack", "pack2"):
        assert runs[step].eval_before_after.before == runs["python"].eval_before_after.before
