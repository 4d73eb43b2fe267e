"""The port's legacy GT-creation functions (refine/legacy.py) against
jrr_tpu on the CPU: tests/test_legacy.py's cases run against the port, and
each function is held to jrr_tpu's on the same numpy-seeded inputs — within
1e-5 (projection, translation, error, quaternion joints, crop inverse) and
within 1e-4 for the staged fit (both loss curves and the fitted
quaternions), which also leaves the hand and feet quaternions where they
started. The fit's translation is not identifiable: the loss is
pelvis-centred, so its gradient is float32 rounding noise, which Adam turns
into steps of up to ±lr in either package. It is held by that bound."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jrr_tpu import constants
from jrr_tpu.data import crop as jcrop
from jrr_tpu.models import smpl as jsmpl
from jrr_tpu.ops import rotations as jrot
from jrr_tpu.refine import legacy as jlegacy
from test_torch_spin import torch_threads
from jrr_tpu_torch import convert
from jrr_tpu_torch.data import crop
from jrr_tpu_torch.refine import legacy


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Two torch threads: Tier-1 runs six test processes at once
    (tests/test_torch_spin.py's reason)."""
    with torch_threads():
        yield


def _t(x):
    return torch.tensor(np.asarray(x))


def test_perspective_projection_identity():
    pts = torch.tensor([[[0.1, -0.2, 0.0]]])
    rot = torch.eye(3)[None]
    out = legacy.perspective_projection(pts, rot, torch.tensor([[0.0, 0.0, 5.0]]), 5000.0,
                                        torch.tensor([[112.0, 112.0]]))
    np.testing.assert_allclose(out[0, 0].numpy(), [5000 * 0.1 / 5 + 112, 5000 * -0.2 / 5 + 112],
                               rtol=1e-5)


def test_perspective_projection_matches_jax():
    rng = np.random.default_rng(6)
    pts = rng.normal(scale=0.3, size=(3, 17, 3)).astype(np.float32)
    rot = np.asarray(jrot.random_rotmat(jax.random.PRNGKey(2), (3,)))
    t = np.stack([rng.uniform(-0.2, 0.2, 3), rng.uniform(-0.2, 0.2, 3),
                  rng.uniform(4, 8, 3)], -1).astype(np.float32)
    f = rng.uniform(900, 1100, 3).astype(np.float32)
    cc = rng.uniform(100, 120, (3, 2)).astype(np.float32)
    got = legacy.perspective_projection(_t(pts), _t(rot), _t(t), _t(f), _t(cc)).numpy()
    want = np.asarray(jlegacy.perspective_projection(*(jnp.asarray(x) for x in (pts, rot, t, f, cc))))
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max())


def _translation_case(seed, b):
    rng = np.random.default_rng(seed)
    x3d = rng.normal(scale=0.3, size=(b, 17, 3)).astype(np.float32)
    t_true = np.stack([rng.uniform(-0.3, 0.3, b), rng.uniform(-0.3, 0.3, b),
                       rng.uniform(4, 8, b)], axis=-1).astype(np.float32)
    cam = x3d + t_true[:, None]
    return x3d, 5000.0 * cam[..., :2] / cam[..., 2:], t_true


def test_estimate_translation_recovers_exact():
    x3d, x2d, t_true = _translation_case(0, 4)
    t_est = legacy.estimate_translation(_t(x3d), _t(x2d), 5000.0)
    np.testing.assert_allclose(t_est.numpy(), t_true, atol=1e-3)


def test_estimate_translation_weighted():
    rng = np.random.default_rng(1)
    x3d = rng.normal(scale=0.3, size=(2, 17, 3)).astype(np.float32)
    t_true = np.asarray([[0.1, -0.1, 5.0]] * 2, np.float32)
    cam = x3d + t_true[:, None]
    x2d = 5000.0 * cam[..., :2] / cam[..., 2:]
    x2d[:, 0] += 500.0  # a corrupt joint with weight 0
    w = np.ones((2, 17), np.float32)
    w[:, 0] = 0.0
    t_est = legacy.estimate_translation(_t(x3d), _t(x2d), 5000.0, weights=_t(w))
    np.testing.assert_allclose(t_est.numpy(), t_true, atol=1e-3)


@pytest.mark.parametrize("weighted", [False, True])
def test_estimate_translation_matches_jax(weighted):
    x3d, x2d, _ = _translation_case(8, 5)
    rng = np.random.default_rng(9)
    x2d = (x2d + rng.normal(scale=2.0, size=x2d.shape)).astype(np.float32)
    cc = rng.uniform(-5, 5, (5, 2)).astype(np.float32)
    w = rng.uniform(0.2, 1.0, (5, 17)).astype(np.float32) if weighted else None
    got = legacy.estimate_translation(_t(x3d), _t(x2d), 1100.0, camera_center=_t(cc),
                                      weights=None if w is None else _t(w)).numpy()
    want = np.asarray(jlegacy.estimate_translation(
        jnp.asarray(x3d), jnp.asarray(x2d), 1100.0, camera_center=jnp.asarray(cc),
        weights=None if w is None else jnp.asarray(w)))
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max())


def test_find_error_to_gt():
    rng = np.random.default_rng(2)
    j = rng.normal(size=(3, 17, 3)).astype(np.float32)
    assert float(legacy.find_error_to_gt(_t(j) + torch.tensor([0.5, -1.0, 2.0]), _t(j))) < 1e-10
    k = rng.normal(size=(3, 17, 3)).astype(np.float32)
    np.testing.assert_allclose(float(legacy.find_error_to_gt(_t(j), _t(k))),
                               float(jlegacy.find_error_to_gt(jnp.asarray(j), jnp.asarray(k))),
                               rtol=1e-5)


@pytest.fixture(scope="module")
def staged():
    """tests/test_legacy.py's staged-fit problem, run by both packages from
    the same arrays (the quaternions drawn by JAX, the noise by numpy)."""
    jmodel = jsmpl.synthetic_smpl_model(seed=3, num_verts=96, num_faces=120)
    model = convert.smpl_model(jmodel, device="cpu")
    rng = np.random.default_rng(3)
    b = 3
    j_reg = np.zeros((17, 96), np.float32)
    for j in range(17):
        j_reg[j, rng.choice(96, 6, replace=False)] = rng.uniform(0.5, 1.0, 6)
    q_orient = np.asarray(jrot.rotmat_to_quat(jrot.random_rotmat(jax.random.PRNGKey(0), (b, 1))))
    q_pose = np.asarray(jrot.rotmat_to_quat(jrot.random_rotmat(jax.random.PRNGKey(1), (b, 23))))
    betas = rng.normal(scale=0.4, size=(b, 10)).astype(np.float32)
    gt_mm = np.asarray(jlegacy.find_joints_quat(
        jmodel, jnp.asarray(betas), jnp.asarray(q_orient), jnp.asarray(q_pose),
        jnp.asarray(j_reg))) * 1000.0
    init = dict(
        orient=(q_orient + rng.normal(scale=0.03, size=q_orient.shape)).astype(np.float32),
        pose=(q_pose + rng.normal(scale=0.05, size=q_pose.shape)).astype(np.float32),
        t=np.zeros((b, 3), np.float32),
    )
    args = (gt_mm, init["orient"], init["pose"], init["t"], betas, j_reg)
    kw = dict(steps_translation=20, steps_pose=120)
    want = jlegacy.find_translation_and_pose(jmodel, *(jnp.asarray(a) for a in args), **kw)
    got = legacy.find_translation_and_pose(model, *(_t(a) for a in args), **kw)
    return dict(model=model, jmodel=jmodel, args=args, got=got,
                want=type(want)(*(np.asarray(x) for x in want)))


def test_find_joints_quat_matches_jax(staged):
    gt_mm, orient, pose, _, betas, j_reg = staged["args"]
    got = legacy.find_joints_quat(staged["model"], _t(betas), _t(orient), _t(pose), _t(j_reg))
    want = np.asarray(jlegacy.find_joints_quat(staged["jmodel"], *(jnp.asarray(a) for a in (
        betas, orient, pose, j_reg))))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_staged_fit_recovers_pose(staged):
    """tests/test_legacy.py's case: the pose loss falls below 0.3 of its
    start, the quaternions stay finite, and the frozen rows do not move."""
    res = staged["got"]
    assert float(res.stage2_loss[-1]) < float(res.stage2_loss[0]) * 0.3
    assert bool(torch.isfinite(res.pose_quat).all())
    idx = list(constants.HAND_FEET_ROT_INDICES)
    np.testing.assert_array_equal(res.pose_quat[:, idx].numpy(), staged["args"][2][:, idx])


@pytest.mark.parametrize("field", ["stage1_loss", "stage2_loss", "orient_quat", "pose_quat"])
def test_staged_fit_matches_jax(staged, field):
    got = getattr(staged["got"], field).numpy()
    want = getattr(staged["want"], field)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_staged_fit_translation_is_a_gauge(staged):
    """Both packages' translations stay within (20 + 120)·lr of the start,
    and shifting every frame's translation leaves the joints' loss as it
    is (float32 rounding aside)."""
    for res in (staged["got"].translation.numpy(), staged["want"].translation):
        assert np.abs(res).max() <= 140 * 1e-2 + 1e-6
    gt_mm, orient, pose, _, betas, j_reg = staged["args"]
    j = legacy.find_joints_quat(staged["model"], _t(betas), _t(orient), _t(pose), _t(j_reg))
    a = legacy.find_error_to_gt(j, _t(gt_mm) / 1000.0)
    b = legacy.find_error_to_gt(j + torch.tensor([0.3, -0.2, 0.5]), _t(gt_mm) / 1000.0)
    np.testing.assert_allclose(float(a), float(b), rtol=1e-5)


def test_convert_back_roundtrip():
    bbox = np.asarray([[100.0, 200.0, 500.0, 600.0]], np.float32)
    intr = np.eye(3, dtype=np.float32)[None]
    res = jcrop.find_crop(jnp.zeros((1, 1, 1000, 1000)), jnp.asarray(bbox), jnp.asarray(intr),
                          img_size=224)
    src = np.asarray([[[400.0, 300.0], [250.0, 150.0]]], np.float32)
    crop_coords = crop.reposition_j2d(_t(src), _t(res.min_x), _t(res.min_y), _t(res.scale))
    back = legacy.convert_back_to_original_dimensions(
        crop_coords, _t(res.min_x), _t(res.min_y), _t(res.scale))
    np.testing.assert_allclose(back.numpy(), src, atol=1e-3)
    want = np.asarray(jlegacy.convert_back_to_original_dimensions(
        jnp.asarray(crop_coords.numpy()), res.min_x, res.min_y, res.scale))
    np.testing.assert_allclose(back.numpy(), want, atol=1e-5 * np.abs(want).max())
