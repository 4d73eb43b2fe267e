"""The port's body and geometry against jrr_tpu on the CPU (atol 1e-5):
rotations, SMPL forward (96 vertices and the full 6890), the regressor,
the camera and both discriminators, on the same numpy-seeded inputs after
conversion by jrr_tpu_torch.convert."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jrr_tpu.models import discriminator as disc
from jrr_tpu.models import smpl as smpl_mod
from jrr_tpu.ops import jreg, rotations
from jrr_tpu.render import camera
from jrr_tpu_torch import convert
from jrr_tpu_torch.models import discriminator as tdisc
from jrr_tpu_torch.models import smpl as tsmpl
from jrr_tpu_torch.ops import jreg as tjreg
from jrr_tpu_torch.ops import rotations as trot
from jrr_tpu_torch.render import camera as tcamera

ATOL = 1e-5


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=atol)


def test_rotations_match_jax():
    rng = np.random.default_rng(0)
    x6 = rng.normal(size=(5, 7, 6)).astype(np.float32)
    aa = np.concatenate(
        [rng.normal(size=(5, 3)), np.zeros((1, 3)), 1e-5 * rng.normal(size=(1, 3))]
    ).astype(np.float32)
    _close(trot.rot6d_to_rotmat(torch.as_tensor(x6)), rotations.rot6d_to_rotmat(jnp.asarray(x6)))
    r = rotations.rot6d_to_rotmat(jnp.asarray(x6))
    _close(trot.rotmat_to_rot6d(torch.as_tensor(np.array(r))), rotations.rotmat_to_rot6d(r))
    _close(trot.axis_angle_to_rotmat(torch.as_tensor(aa)), rotations.axis_angle_to_rotmat(jnp.asarray(aa)))
    # numpy-seeded random rotations are proper rotations
    rm = trot.random_rotmat(np.random.default_rng(1), (4,), device="cpu")
    _close(rm @ rm.transpose(-1, -2), np.broadcast_to(np.eye(3), (4, 3, 3)))
    _close(torch.linalg.det(rm), np.ones(4))


def test_synthetic_model_matches_jax():
    jm = smpl_mod.synthetic_smpl_model(seed=3, num_verts=96, num_faces=160)
    tm = tsmpl.synthetic_smpl_model(seed=3, num_verts=96, num_faces=160, device="cpu")
    for field in ("v_template", "shapedirs", "posedirs", "j_regressor", "lbs_weights",
                  "faces", "vertex_perm"):
        np.testing.assert_array_equal(getattr(tm, field).numpy(), np.asarray(getattr(jm, field)))
    assert tm.parents == jm.parents


@pytest.mark.parametrize("num_verts", [96, 6890])
def test_smpl_forward_matches_jax(num_verts):
    faces = 160 if num_verts == 96 else None
    jm = smpl_mod.synthetic_smpl_model(seed=3, num_verts=num_verts, num_faces=faces)

    rng = np.random.default_rng(4)
    b = 2
    betas = rng.normal(scale=0.5, size=(b, 10)).astype(np.float32)
    rot = np.array(rotations.axis_angle_to_rotmat(
        jnp.asarray(rng.normal(scale=0.4, size=(b, 24, 3)).astype(np.float32))
    ))
    want = smpl_mod.smpl_forward(jm, jnp.asarray(betas), jnp.asarray(rot[:, :1]), jnp.asarray(rot[:, 1:]))
    got = tsmpl.smpl_forward(
        convert.smpl_model(jm, device="cpu"), torch.as_tensor(betas),
        torch.as_tensor(rot[:, :1]), torch.as_tensor(rot[:, 1:]),
    )
    _close(got.vertices, want.vertices)
    _close(got.joints, want.joints)
    _close(got.v_shaped, want.v_shaped)


def test_jreg_and_camera_match_jax():
    rng = np.random.default_rng(5)
    j_reg = rng.normal(size=(17, 96)).astype(np.float32)
    j_reg[:, :8] = np.abs(j_reg[:, :8]) + 0.1  # every row keeps a positive sum
    verts = rng.normal(size=(3, 96, 3)).astype(np.float32)
    cam_t = np.stack(
        [rng.uniform(-0.1, 0.1, 3), rng.uniform(-0.1, 0.1, 3), rng.uniform(20, 40, 3)], axis=-1
    ).astype(np.float32)

    jn = jreg.normalize_jreg(jnp.asarray(j_reg), jreg.jreg_mask(jnp.asarray(j_reg)))
    tn = tjreg.normalize_jreg(torch.as_tensor(j_reg), tjreg.jreg_mask(torch.as_tensor(j_reg)))
    _close(tn, jn)
    _close(tjreg.jreg_mask(torch.as_tensor(j_reg), intended=True),
           jreg.jreg_mask(jnp.asarray(j_reg), intended=True))
    joints = jreg.apply_jreg(jn, jnp.asarray(verts))
    tjoints = tjreg.apply_jreg(tn, torch.as_tensor(verts))
    _close(tjoints, joints)
    _close(tjreg.move_pelvis(tjoints), jreg.move_pelvis(joints))
    for size, focal in ((224, 5000.0), (112, 2500.0)):
        want = camera.project_points_screen(jnp.asarray(verts), jnp.asarray(cam_t), size, focal)
        got = tcamera.project_points_screen(torch.as_tensor(verts), torch.as_tensor(cam_t), size, focal)
        _close(got, want, atol=1e-4)  # pixels of magnitude ~100: 1e-6 relative
    spin_cam = np.asarray([[0.9, 0.01, -0.02], [1.1, -0.03, 0.0]], np.float32)
    _close(tcamera.weak_perspective_to_translation(torch.as_tensor(spin_cam)),
           camera.weak_perspective_to_translation(jnp.asarray(spin_cam)), atol=1e-4)


def test_discriminators_match_jax():
    # numpy-drawn params in the JAX layout ((in, out) weights) — the JAX
    # functions take any dict of arrays; jax.random init is slow on the CPU.
    rng = np.random.default_rng(6)
    shapes = {k: np.shape(v) for k, v in jax.eval_shape(
        disc.init_pose_discriminator, jax.random.PRNGKey(0)).items()}
    pose_p = {k: rng.uniform(-0.1, 0.1, size=s).astype(np.float32) for k, s in shapes.items()}
    shape_p = {k: rng.uniform(-0.5, 0.5, size=np.shape(v)).astype(np.float32)
               for k, v in jax.eval_shape(disc.init_shape_discriminator, jax.random.PRNGKey(0)).items()}
    rot6d = rng.normal(size=(4, 24, 6)).astype(np.float32)
    betas = rng.normal(size=(4, 10)).astype(np.float32)
    tpose = convert.pose_discriminator(pose_p, device="cpu")
    tshape = convert.shape_discriminator(shape_p, device="cpu")
    _close(tpose(torch.as_tensor(rot6d)), disc.pose_discriminator(pose_p, jnp.asarray(rot6d)))
    _close(tshape(torch.as_tensor(betas)), disc.shape_discriminator(shape_p, jnp.asarray(betas)))
    # Own init: torch-default bounds, deterministic per seed.
    a, b = tdisc.PoseDiscriminator(seed=1, device="cpu"), tdisc.PoseDiscriminator(seed=1, device="cpu")
    assert torch.equal(a.fc1.weight, b.fc1.weight)
    assert float(a.fc1.weight.detach().abs().max()) <= 1.0 / np.sqrt(768)
