"""Linear-blend skinning on the CPU (`models/smpl.py::lbs_skin`): CPU
tensors take the plain version `lbs_skin_plain` (the einsum pair) through
autograd, which the CUDA kernel pair (csrc/lbs_skin.cu) is held against on
the card (tests/test_torch_lbs_skin_card.py).

- `smpl_forward`'s vertices and their VJP in betas, global orientation and
  body pose against jax.vjp of jrr_tpu's `smpl_forward` (float32, within
  REL_TOL of the largest entry), at 96 and 6890 vertices, 1 and 5 frames,
  SMPL's 24-joint tree and an 11-joint tree;
- `smpl_forward` on the CPU launches no kernel and gives the einsum pair's
  vertices bit for bit;
- the weights take no gradient, and the kernel wrappers refuse CPU tensors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jrr_tpu.models import smpl as jsmpl
from jrr_tpu.ops import rotations as jrot
from jrr_tpu_torch import convert, kernels
from jrr_tpu_torch.models import smpl

REL_TOL = 1e-5  # float32 in another summation order: up to 3.7e-6 (betas' VJP, 6890 vertices)


def _inputs(num_verts, batch, num_joints, dtype, seed=0):
    """A model's skinning weights (rows summing to 1) and numpy-seeded
    rigid transforms, posed vertices and a cotangent."""
    model = smpl.synthetic_smpl_model(seed=seed, num_verts=num_verts, num_joints=num_joints,
                                      num_faces=160, device="cpu")
    rng = np.random.default_rng(seed + 1)
    rot, _ = np.linalg.qr(rng.normal(size=(batch, num_joints, 3, 3)))
    t = rng.normal(scale=0.5, size=(batch, num_joints, 3))
    a_flat = np.concatenate([rot.reshape(batch, num_joints, 9), t], axis=-1)
    v_posed = rng.normal(scale=0.5, size=(batch, num_verts, 3))
    g = rng.normal(size=(batch, num_verts, 3))
    t_ = lambda x: torch.as_tensor(x, dtype=dtype)  # noqa: E731
    return model.lbs_weights.to(dtype), t_(a_flat), t_(v_posed), t_(g)


def _rel(got, want) -> float:
    return float((got.double() - want.double()).abs().max() / want.double().abs().max())


@pytest.mark.parametrize("num_joints", [24, 11], ids=["smpl24", "tree11"])
@pytest.mark.parametrize("batch", [1, 5])
@pytest.mark.parametrize("num_verts", [96, 6890])
def test_smpl_forward_vjp_matches_jax(num_verts, batch, num_joints):
    jm = jsmpl.synthetic_smpl_model(seed=5, num_verts=num_verts, num_joints=num_joints,
                                    num_faces=160)
    rng = np.random.default_rng(num_verts + batch + num_joints)
    betas = rng.normal(scale=0.5, size=(batch, 10)).astype(np.float32)
    rot = np.array(jrot.axis_angle_to_rotmat(
        jnp.asarray(rng.normal(scale=0.6, size=(batch, num_joints, 3)).astype(np.float32))))
    g = rng.normal(size=(batch, num_verts, 3)).astype(np.float32)

    def jax_vertices(betas, orient, pose):
        return jsmpl.smpl_forward(jm, betas, orient, pose).vertices

    want, vjp = jax.vjp(jax_vertices, jnp.asarray(betas), jnp.asarray(rot[:, :1]),
                        jnp.asarray(rot[:, 1:]))
    want_grads = vjp(jnp.asarray(g))
    args = [torch.as_tensor(x).requires_grad_(True) for x in (betas, rot[:, :1], rot[:, 1:])]
    got = smpl.smpl_forward(convert.smpl_model(jm, device="cpu"), *args).vertices
    got_grads = torch.autograd.grad(got, args, torch.as_tensor(g))
    assert _rel(got.detach(), torch.as_tensor(np.asarray(want))) <= REL_TOL
    for x, y in zip(got_grads, want_grads):
        assert _rel(x, torch.as_tensor(np.asarray(y))) <= REL_TOL


def test_smpl_forward_on_cpu_is_the_einsum_pair_and_launches_nothing(monkeypatch):
    model = smpl.synthetic_smpl_model(seed=2, num_verts=96, num_faces=160, device="cpu")
    rng = np.random.default_rng(3)
    rot, _ = np.linalg.qr(rng.normal(size=(4, 24, 3, 3)))
    rot = torch.as_tensor(rot * np.sign(np.linalg.det(rot))[..., None, None], dtype=torch.float32)
    betas = torch.as_tensor(rng.normal(size=(4, 10)), dtype=torch.float32)
    before = {w: w.launches for w in kernels.SKIN}
    out = smpl.smpl_forward(model, betas, rot[:, :1], rot[:, 1:])
    assert {w: w.launches for w in kernels.SKIN} == before

    # The same forward through the einsum pair: the same bits.
    monkeypatch.setattr(smpl, "lbs_skin", smpl.lbs_skin_plain)
    want = smpl.smpl_forward(model, betas, rot[:, :1], rot[:, 1:])
    torch.testing.assert_close(out.vertices, want.vertices, rtol=0, atol=0)


def test_skinning_weights_take_no_gradient():
    w, a, vp, _ = _inputs(96, 2, 24, torch.float32)
    with pytest.raises(ValueError, match="no gradient"):
        smpl.lbs_skin(w.requires_grad_(True), a, vp)


def test_skin_kernel_wrappers_refuse_cpu_tensors():
    w, a, vp, g = _inputs(96, 2, 24, torch.float32)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.lbs_skin_fwd(w, a, vp)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.lbs_skin_bwd(w, a, vp, g)
    assert all(w.launches == 0 for w in kernels.SKIN)
