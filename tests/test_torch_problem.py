"""The port's synthetic problem (`jrr_tpu_torch/problem.py`) against
`__graft_entry__._synthetic_problem` on the CPU, small (96 vertices, 32²,
batch 4). Both scenes: the regressor, betas and camera equal jrr_tpu's
draws bit for bit, and so does the realistic scene's init noise (each
package's init equals its truth plus the same numpy draws exactly). The
rotations jrr_tpu draws with jax.random differ by design, so jrr_tpu's
ground-truth params are passed across to `render_data`: vertices within
1e-6 m, joints within 1e-3 mm, their reprojection within 1e-4 px; the
mask rendered from jrr_tpu's vertices within the render tests' 1e-5, and
from the port's own within 1e-4 (2.4e-7 m of vertex rounding moves edge
pixels by up to 2.5e-5 on the realistic scene's stretched triangles).
`return_gt` and the `model` override behave as in jrr_tpu.
"""

import dataclasses

import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from jrr_tpu_torch import problem
from jrr_tpu_torch.models import smpl
from jrr_tpu_torch.refine import losses
from jrr_tpu_torch.render import silhouette as sil_lib
from test_torch_spin import torch_threads

BATCH, V, SIZE, SEED = 4, 96, 32, 0
FIELDS = ("pose6d", "orient6d", "betas", "cam_t")
NOISE = dict(zip(FIELDS, (0.06, 0.03, 0.1, 0.05)))


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Two torch threads: Tier-1 runs six test processes at once."""
    with torch_threads():
        yield


def _np(x):
    return np.asarray(x.detach().cpu().numpy() if torch.is_tensor(x) else x)


def _both(scene, seed=SEED, **kw):
    port = problem.synthetic_problem(batch=BATCH, num_verts=V, image_size=SIZE, seed=seed,
                                     device="cpu", scene=scene, return_gt=True, **kw)
    jax_ = ge._synthetic_problem(batch=BATCH, num_verts=V, image_size=SIZE, seed=seed,
                                 scene=scene, return_gt=True, **kw)
    return port, jax_


def _draws(seed, scene):
    """The shared generator's draws in jrr_tpu's order: the regressor, the
    drift poses, betas, camera, then the realistic init noise."""
    rng = np.random.default_rng(seed)
    for _ in range(17):
        rng.choice(V, size=8, replace=False)
        rng.uniform(0.5, 1.0, 8)
    if scene == "drift":
        rng.normal(scale=0.25, size=(BATCH, 23, 3))
    rng.normal(size=(BATCH, 10))
    for _ in range(3):
        rng.uniform(size=BATCH)
    shapes = dict(pose6d=(BATCH, 23, 6), orient6d=(BATCH, 1, 6), betas=(BATCH, 10),
                  cam_t=(BATCH, 3))
    return {f: rng.normal(scale=NOISE[f], size=shapes[f]).astype(np.float32) for f in FIELDS}


@pytest.mark.parametrize("scene", ["realistic", "drift"])
@pytest.mark.parametrize("seed", [0, 5])
def test_draws_equal_jax(scene, seed):
    (_, jreg, _, init, _, params, _), (_, jjreg, _, jinit, _, jparams, _) = _both(scene, seed)
    assert np.array_equal(_np(jreg), np.asarray(jjreg))
    for f in ("betas", "cam_t"):
        assert np.array_equal(_np(getattr(params, f)), np.asarray(getattr(jparams, f))), f
        assert np.array_equal(_np(getattr(init, f)), np.asarray(getattr(jinit, f))), f
    if scene == "realistic":
        noise = _draws(seed, scene)
        for f in FIELDS:
            assert np.array_equal(_np(getattr(init, f)), _np(getattr(params, f)) + noise[f]), f
            assert np.array_equal(np.asarray(getattr(jinit, f)),
                                  np.asarray(getattr(jparams, f)) + noise[f]), f
        assert float(_np(params.betas).std()) > 0.25  # σ 0.4, not the drift's 0.3
    else:
        # Small-angle poses from the same numpy draws; the constant offsets.
        np.testing.assert_allclose(_np(params.pose6d), np.asarray(jparams.pose6d), atol=1e-6)
        for f, d in zip(FIELDS, (0.03, 0.02, 0.05, 0.05)):
            np.testing.assert_array_equal(_np(getattr(init, f)), _np(getattr(params, f)) + d)


@pytest.mark.parametrize("scene", ["realistic", "drift"])
def test_data_of_jax_params(scene):
    (model, jreg, cfg, _, _, _, _), (jmodel, _, _, _, jdata, jparams, jverts) = _both(scene)
    params = losses.FrameParams(*(torch.as_tensor(np.array(getattr(jparams, f)))
                                  for f in FIELDS))
    data, verts = problem.render_data(model, jreg, params, cfg)
    np.testing.assert_allclose(_np(verts), np.asarray(jverts), atol=1e-6)
    np.testing.assert_allclose(_np(data.gt_j3d), np.asarray(jdata.gt_j3d), atol=1e-3)  # mm
    np.testing.assert_allclose(_np(data.gt_j2d), np.asarray(jdata.gt_j2d), atol=1e-4)
    np.testing.assert_allclose(_np(data.mask), np.asarray(jdata.mask), atol=1e-4)
    assert float(_np(data.mask).sum()) > 10.0
    spec = sil_lib.RasterizerSpec(image_size=SIZE, tile_size=8,
                                  faces_per_tile=cfg.silhouette.faces_per_tile)
    mask = sil_lib.render_mesh_silhouette(torch.as_tensor(np.array(jverts)), model.faces,
                                          params.cam_t, spec)
    np.testing.assert_allclose(_np(mask), np.asarray(jdata.mask), atol=1e-5)


def test_realistic_scene_own_draws_are_a_posed_body():
    """The port's own realistic frames: rotations from numpy (seed + 2),
    orthonormal, far from rest, and a rendered body in every frame."""
    model, _, _, init, data, params, verts = problem.synthetic_problem(
        batch=BATCH, num_verts=V, image_size=SIZE, device="cpu", scene="realistic",
        return_gt=True)
    rot = _np(params.pose6d).reshape(BATCH, 23, 3, 2)
    np.testing.assert_allclose(np.einsum("bjki,bjkl->bjil", rot, rot),
                               np.broadcast_to(np.eye(2), (BATCH, 23, 2, 2)), atol=1e-5)
    rest = np.zeros((3, 2), np.float32)
    rest[0, 0] = rest[1, 1] = 1.0
    assert float(np.abs(rot - rest).mean()) > 0.3  # fully random, not small-angle
    assert verts.shape == (BATCH, V, 3) and (_np(data.mask).reshape(BATCH, -1).sum(1) > 1).all()


def test_return_gt_and_model_override():
    model = smpl.synthetic_smpl_model(seed=SEED, num_verts=V, num_faces=120, device="cpu")
    base = problem.synthetic_problem(batch=BATCH, num_verts=V, image_size=SIZE, device="cpu")
    over = problem.synthetic_problem(batch=BATCH, num_verts=V, image_size=SIZE, model=model,
                                     device="unused", return_gt=True)
    jbase = ge._synthetic_problem(batch=BATCH, num_verts=V, image_size=SIZE)
    jover = ge._synthetic_problem(batch=BATCH, num_verts=V, image_size=SIZE, return_gt=True,
                                  model=jbase[0])
    assert len(base) == len(jbase) == 5 and len(over) == len(jover) == 7
    assert over[0] is model and jover[0] is jbase[0]
    for a, b in zip(list(base[3]) + list(base[4]), list(over[3]) + list(over[4])):
        assert torch.equal(a, b)
    # The ground truth returned is what the data came from.
    data, verts = problem.render_data(over[0], over[1], over[5], over[2])
    assert torch.equal(verts, over[6]) and torch.equal(data.gt_j3d, over[4].gt_j3d)

    small = smpl.synthetic_smpl_model(seed=SEED, num_verts=64, device="cpu")
    with pytest.raises(ValueError, match="64 verts, expected 96"):
        problem.synthetic_problem(batch=BATCH, num_verts=V, image_size=SIZE, model=small)
    import jrr_tpu.models.smpl as jsmpl
    with pytest.raises(ValueError, match="64 verts, expected 96"):
        ge._synthetic_problem(batch=BATCH, num_verts=V, image_size=SIZE,
                              model=jsmpl.synthetic_smpl_model(seed=SEED, num_verts=64))
    for make in (lambda: problem.synthetic_problem(batch=1, num_verts=V, image_size=SIZE,
                                                   device="cpu", scene="tpu"),
                 lambda: ge._synthetic_problem(batch=1, num_verts=V, image_size=SIZE,
                                               scene="tpu")):
        with pytest.raises(ValueError, match="unknown scene"):
            make()


def test_drift_is_the_default_and_takes_perturb():
    kw = dict(batch=BATCH, num_verts=V, image_size=SIZE, device="cpu")
    default = problem.synthetic_problem(**kw)
    drift = problem.synthetic_problem(scene="drift", perturb=(0.03, 0.02, 0.05, 0.05), **kw)
    other = problem.synthetic_problem(perturb=(0.0, 0.0, 0.0, 0.1), return_gt=True, **kw)
    for a, b in zip(list(default[3]) + list(default[4]), list(drift[3]) + list(drift[4])):
        assert torch.equal(a, b)
    init, params = other[3], other[5]
    assert torch.equal(init.pose6d, params.pose6d) and torch.equal(init.betas, params.betas)
    assert torch.equal(init.cam_t, params.cam_t + 0.1)
    assert dataclasses.is_dataclass(default[2])
