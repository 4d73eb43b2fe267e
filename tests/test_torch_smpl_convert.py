"""The port's SMPL pickle converter, thin-appendage generator and shipped
regressor against jrr_tpu on the CPU.

- Both packages' `convert_smpl_pickle` write equal arrays, key for key and
  dtype for dtype, from two pickles: the small one of
  tests/test_converters.py (its csc_matrix renamed to the 2015 module path
  `scipy.sparse.csc`) and the full-width real-layout one of
  tests/test_smpl_golden.py (`scipy.sparse._csc`).
- The port's forward on the converted full-width model is within 1e-5 m of
  tests/torch_lbs_replay.py's float64 replay on the pickle's own arrays.
- A subprocess in which scipy and chumpy cannot be imported converts the
  small pickle to the same arrays.
- `synthetic_smpl_model(thin_appendage_radius=…, return_aux=True)` equals
  jrr_tpu's at the same seed, arrays and aux exactly; at radius 0 the model
  is the one the call without the new arguments gives, bit for bit.
- `load_retrained_j_regressor` equals jrr_tpu's asset and passes
  tests/test_assets.py's checks through the port's `normalize_jreg`.
"""

import os
import pickle
import subprocess
import sys
import types

import numpy as np
import pytest
import scipy.sparse
import torch

from jrr_tpu import assets as jassets
from jrr_tpu.models import smpl as jsmpl
from jrr_tpu_torch import assets
from jrr_tpu_torch.models import smpl
from jrr_tpu_torch.ops import jreg as tjreg
from tests import torch_lbs_replay as replay

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NPZ_KEYS = ("v_template", "shapedirs", "posedirs", "j_regressor", "lbs_weights", "faces",
            "kintree_parents")


def _fake_chumpy():
    """A throwaway `chumpy` module, so the pickle stream carries real
    chumpy.Ch records; removed again before any conversion."""
    chumpy = types.ModuleType("chumpy")

    class Ch:
        def __init__(self, x):
            self.x = np.asarray(x)

    Ch.__module__ = "chumpy"
    Ch.__qualname__ = "Ch"
    chumpy.Ch = Ch
    return chumpy, Ch


def _dump(payload, path, chumpy, legacy_csc=False):
    sys.modules["chumpy"] = chumpy
    try:
        blob = pickle.dumps(payload, protocol=2)
    finally:
        del sys.modules["chumpy"]
    if legacy_csc:  # the module path of the 2015 Python-2 pickles
        new = b"cscipy.sparse._csc\ncsc_matrix\n"
        assert new in blob
        blob = blob.replace(new, b"cscipy.sparse.csc\ncsc_matrix\n")
    with open(path, "wb") as f:
        f.write(blob)


@pytest.fixture(scope="module")
def pickles(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("smpl_pickles")
    chumpy, Ch = _fake_chumpy()
    # tests/test_converters.py's pickle.
    v, j = 24, 4
    rng = np.random.default_rng(1)
    small = {
        "v_template": Ch(rng.normal(size=(v, 3))),
        "shapedirs": Ch(rng.normal(size=(v, 3, 10))),
        "posedirs": Ch(rng.normal(size=(v, 3, 9 * (j - 1)))),
        "J_regressor": scipy.sparse.csc_matrix(np.abs(rng.normal(size=(j, v)))
                                               * (rng.uniform(size=(j, v)) < 0.3)),
        "weights": Ch(np.abs(rng.normal(size=(v, j)))),
        "f": np.zeros((10, 3), np.int64),
        "kintree_table": np.vstack([[2**32 - 1, 0, 0, 1], np.arange(4)]),
    }
    _dump(small, str(tmp / "small.pkl"), chumpy, legacy_csc=True)
    # tests/test_smpl_golden.py's full-width pickle in the official layout.
    v, j = 6890, 24
    syn = smpl.synthetic_smpl_model(seed=3, num_verts=v, device="cpu")
    raw = dict(
        v_template=syn.v_template.numpy().astype(np.float64),
        shapedirs=syn.shapedirs.numpy().astype(np.float64),
        posedirs=syn.posedirs.numpy().astype(np.float64).T.reshape(v, 3, 9 * (j - 1)),
        j_regressor=syn.j_regressor.numpy().astype(np.float64),
        weights=syn.lbs_weights.numpy().astype(np.float64),
        parents=np.asarray(smpl.SMPL_PARENTS, np.int64),
    )
    golden = {
        "v_template": Ch(raw["v_template"]), "shapedirs": Ch(raw["shapedirs"]),
        "posedirs": Ch(raw["posedirs"]), "J_regressor": scipy.sparse.csc_matrix(raw["j_regressor"]),
        "weights": Ch(raw["weights"]), "f": syn.faces.numpy(),
        "kintree_table": np.vstack([np.where(raw["parents"] < 0, 2**32 - 1, raw["parents"]),
                                    np.arange(j)]),
    }
    _dump(golden, str(tmp / "golden.pkl"), chumpy)
    out = {}
    for name in ("small", "golden"):
        pkl = str(tmp / f"{name}.pkl")
        smpl.convert_smpl_pickle(pkl, str(tmp / f"{name}_port.npz"))
        jsmpl.convert_smpl_pickle(pkl, str(tmp / f"{name}_jax.npz"))
        out[name] = pkl
    return tmp, out, raw


@pytest.mark.parametrize("name", ["small", "golden"])
def test_converters_write_equal_arrays(pickles, name):
    tmp, _, _ = pickles
    with np.load(tmp / f"{name}_port.npz") as a, np.load(tmp / f"{name}_jax.npz") as b:
        assert sorted(a.files) == sorted(b.files) == sorted(NPZ_KEYS)
        for k in NPZ_KEYS:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_small_pickle_loads_in_both_packages(pickles):
    tmp, _, _ = pickles
    model = smpl.load_smpl_npz(str(tmp / "small_port.npz"), device="cpu")
    jmodel = jsmpl.load_smpl_npz(str(tmp / "small_port.npz"))
    assert model.posedirs.shape == (27, 72) and model.parents[0] == -1
    for f in ("v_template", "shapedirs", "posedirs", "j_regressor", "lbs_weights", "faces"):
        np.testing.assert_array_equal(getattr(model, f).numpy(), np.asarray(getattr(jmodel, f)))
    assert model.parents == jmodel.parents


@pytest.mark.parametrize("batch_seed", [0, 1])
def test_converted_forward_matches_float64_replay(pickles, batch_seed):
    """1e-5 m, tests/test_smpl_golden.py's bar."""
    tmp, _, raw = pickles
    model = smpl.load_smpl_npz(str(tmp / "golden_port.npz"), device="cpu")
    rng = np.random.default_rng(42 + batch_seed)
    betas = rng.normal(size=(3, 10))
    pose = rng.normal(scale=0.3, size=(3, 24, 3))
    pose[0, 5] = 0.0
    rots = replay.rodrigues(torch.from_numpy(pose))
    want = replay.lbs_replay(
        torch.from_numpy(betas), rots, *(torch.from_numpy(raw[k]) for k in (
            "v_template", "shapedirs", "posedirs", "j_regressor")),
        raw["parents"], torch.from_numpy(raw["weights"]), pose2rot=False,
    )
    out = smpl.smpl_forward(model, torch.as_tensor(betas, dtype=torch.float32),
                            rots[:, :1].float(), rots[:, 1:].float())
    err = np.abs(out.vertices.double().numpy() - want[0].numpy()).max()
    assert err <= 1e-5, err
    err_j = np.abs(out.joints.double().numpy() - want[1].numpy()).max()
    assert err_j <= 1e-5, err_j


def test_converter_needs_no_scipy(pickles):
    tmp, pkls, _ = pickles
    out = str(tmp / "small_noscipy.npz")
    code = (
        "import sys\n"
        "sys.modules['scipy'] = None\nsys.modules['chumpy'] = None\n"
        "from jrr_tpu_torch.models.smpl import convert_smpl_pickle\n"
        f"convert_smpl_pickle({pkls['small']!r}, {out!r})\n"
        "assert sys.modules['scipy'] is None\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    with np.load(out) as a, np.load(tmp / "small_jax.npz") as b:
        for k in NPZ_KEYS:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _model_arrays(model):
    fields = ("v_template", "shapedirs", "posedirs", "j_regressor", "lbs_weights", "faces",
              "j_regressor_extra", "vertex_perm")
    return {f: np.asarray(getattr(model, f)) for f in fields if getattr(model, f) is not None}


@pytest.mark.parametrize("radius", [0.01, 0.03])
def test_thin_appendages_equal_jax(radius):
    kw = dict(seed=0, num_verts=1200, num_faces=2400, thin_appendage_radius=radius,
              return_aux=True)
    model, aux = smpl.synthetic_smpl_model(device="cpu", **kw)
    jmodel, jaux = jsmpl.synthetic_smpl_model(**kw)
    got, want = _model_arrays(model), _model_arrays(jmodel)
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], want[k].astype(got[k].dtype), err_msg=k)
    np.testing.assert_array_equal(aux["appendage_verts"], jaux["appendage_verts"])
    assert len(aux["appendage_groups"]) == len(jaux["appendage_groups"]) == 4
    for a, b in zip(aux["appendage_groups"], jaux["appendage_groups"]):
        np.testing.assert_array_equal(a, b)
    # Four tips, at least 8 moved vertices each.
    assert len(aux["appendage_verts"]) >= 32


def test_radius_zero_is_unchanged():
    kw = dict(seed=2, num_verts=600, num_faces=1200)
    base = smpl.synthetic_smpl_model(device="cpu", **kw)
    model, aux = smpl.synthetic_smpl_model(device="cpu", thin_appendage_radius=0.0,
                                           return_aux=True, **kw)
    a, b = _model_arrays(base), _model_arrays(model)
    for k in a:
        assert torch.equal(torch.as_tensor(a[k]), torch.as_tensor(b[k])), k
    assert aux["appendage_verts"].size == 0 and aux["appendage_groups"] == []
    want = _model_arrays(jsmpl.synthetic_smpl_model(**kw))
    for k in a:
        np.testing.assert_array_equal(a[k], want[k].astype(a[k].dtype), err_msg=k)
    with pytest.raises(ValueError, match="24-joint"):
        smpl.synthetic_smpl_model(num_verts=96, num_joints=10, thin_appendage_radius=0.01,
                                  device="cpu")


def test_retrained_regressor_asset():
    j = assets.load_retrained_j_regressor(device="cpu")
    want = jassets.load_retrained_j_regressor()
    assert j.shape == (17, 6890) and j.dtype == torch.float32
    np.testing.assert_array_equal(j.numpy(), want)
    assert (j != 0).float().mean() < 0.05
    n = tjreg.normalize_jreg(j)
    np.testing.assert_allclose(n.sum(dim=1).numpy(), 1.0, atol=1e-5)
    assert bool((n >= 0).all())
    with open(os.path.join(ROOT, "jrr_tpu_torch", "assets", "retrained_j_regressor.npz"), "rb") as f, \
            open(os.path.join(ROOT, "jrr_tpu", "assets", "retrained_j_regressor.npz"), "rb") as g:
        assert f.read() == g.read()
