"""The port's SMPL forward (rotation-matrix path) against the float64 LBS
replay of tests/torch_lbs_replay.py at ≤ 1e-5 m on vertices and joints, the
bar tests/test_smpl_golden.py:113-138 holds the JAX package to. The port has
no pickle converter or npz loader, so its model is built here from the same
float64 arrays the replay reads, stored the way the official pickle stores
them and cast to float32."""

import numpy as np
import pytest
import torch

from jrr_tpu_torch.models import smpl
from tests import torch_lbs_replay as replay

V, J, NB = 6890, 24, 10
B = 3


@pytest.fixture(scope="module")
def golden():
    rng = np.random.default_rng(42)
    syn = smpl.synthetic_smpl_model(seed=3, num_verts=V, device="cpu")
    raw = dict(
        v_template=syn.v_template.double().numpy(),
        shapedirs=syn.shapedirs.double().numpy(),  # (V, 3, 10)
        # The port stores posedirs (207, V·3); the pickle stores (V, 3, 207).
        posedirs=syn.posedirs.double().numpy().T.reshape(V, 3, 9 * (J - 1)),
        j_regressor=syn.j_regressor.double().numpy(),
        weights=syn.lbs_weights.double().numpy(),
        faces=syn.faces.numpy(),
        parents=np.asarray(smpl.SMPL_PARENTS, np.int64),
    )
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32)  # noqa: E731
    model = smpl.SMPLModel(
        v_template=f32(raw["v_template"]),
        shapedirs=f32(raw["shapedirs"]),
        # smplx's storage order: reshape(-1, 207).T
        posedirs=f32(raw["posedirs"].reshape(-1, 9 * (J - 1)).T),
        j_regressor=f32(raw["j_regressor"]),
        lbs_weights=f32(raw["weights"]),
        faces=torch.as_tensor(raw["faces"]),
        j_regressor_extra=None,
        parents=tuple(int(p) for p in raw["parents"]),
    )
    betas = rng.normal(scale=1.0, size=(B, NB))
    pose_aa = rng.normal(scale=0.3, size=(B, J, 3))
    pose_aa[0, 5] = 0.0  # the zero-rotation Rodrigues branch
    return model, raw, betas, pose_aa


def _replay(raw, betas, rots):
    return replay.lbs_replay(
        torch.from_numpy(betas), torch.from_numpy(rots),
        *(torch.from_numpy(raw[k]) for k in ("v_template", "shapedirs", "posedirs", "j_regressor")),
        raw["parents"], torch.from_numpy(raw["weights"]), pose2rot=False,
    )


def _port(model, betas, rots):
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32)  # noqa: E731
    return smpl.smpl_forward(model, f32(betas), f32(rots[:, :1]), f32(rots[:, 1:]))


def test_rotmat_path_matches_float64_replay(golden):
    model, raw, betas, pose_aa = golden
    rots = replay.rodrigues(torch.from_numpy(pose_aa)).numpy()
    out = _port(model, betas, rots)
    verts64, joints64 = _replay(raw, betas, rots)
    assert np.abs(out.vertices.double().numpy() - verts64.numpy()).max() < 1e-5
    assert np.abs(out.joints.double().numpy() - joints64.numpy()).max() < 1e-5


def test_single_joint_bend_matches_float64_replay(golden):
    """The pose blendshapes' storage order: bending one joint moves the
    vertices by that joint's posedirs columns only."""
    model, raw, _, _ = golden
    aa = np.zeros((1, J, 3))
    aa[0, 1] = (0.7, -0.2, 0.4)
    rots = replay.rodrigues(torch.from_numpy(aa)).numpy()
    betas = np.zeros((1, NB))
    out = _port(model, betas, rots)
    verts64, joints64 = _replay(raw, betas, rots)
    assert np.abs(out.vertices.double().numpy() - verts64.numpy()).max() < 1e-5
    assert np.abs(out.joints.double().numpy() - joints64.numpy()).max() < 1e-5
