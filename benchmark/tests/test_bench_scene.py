"""The scene and the pool: the same for one seed, different for two; the
poses within their ranges of motion, the regressor's rows on their joints."""

import math

import pytest
import torch

from benchmark import scene as scene_lib
from benchmark.reference import body as body_lib


def _flat(scene):
    f = scene.frames
    return [*scene.body, scene.j_reg_true, scene.j_reg_init, *scene.pose_w.values(),
            *scene.shape_w.values(), *f.init, *f.gt, f.gt_verts, f.gt_j2d, f.gt_j3d, f.mask]


def test_same_seed_same_scene_other_seed_other_frames(tiny_cell):
    cell = tiny_cell(verts=200, faces=80, batch=3, pool=2)
    a = scene_lib.make_scene(2**31 + 11, cell.config, cell.traffic, "cpu")
    b = scene_lib.make_scene(2**31 + 11, cell.config, cell.traffic, "cpu")
    c = scene_lib.make_scene(2**31 + 12, cell.config, cell.traffic, "cpu")
    for x, y in zip(_flat(a), _flat(b)):
        assert torch.equal(x, y)
    # One model in every run; the frames are the seed's.
    weights = 6 + 2 + len(a.pose_w) + len(a.shape_w)
    for x, y in zip(_flat(a)[:weights], _flat(c)[:weights]):
        assert torch.equal(x, y)
    for x, y in zip(_flat(a)[weights:], _flat(c)[weights:]):
        assert not torch.equal(x, y)


def test_pool_shapes_and_supervision(tiny_cell):
    cell = tiny_cell(verts=600, faces=80, batch=3, pool=2)
    s = scene_lib.make_scene(5, cell.config, cell.traffic, "cpu")
    assert s.frames.init[0].shape == (6, 23, 6) and s.frames.gt_verts.shape == (6, 600, 3)
    assert s.frames.mask.shape == (6, 224, 224)
    assert set(s.frames.mask.unique().tolist()) <= {0.0, 1.0} and s.frames.mask.sum() > 0
    assert s.batch_rows(3) == slice(3, 6)
    depth = s.frames.gt[3][:, 2]
    assert bool(((depth >= 36) & (depth <= 60)).all())
    # Faces join vertices of one bone (their skinning owner).
    owner = s.body.lbs_weights.argmax(dim=1)
    assert bool((owner[s.body.faces] == owner[s.body.faces[:, :1]]).all())


def test_joint_angles_within_their_ranges(tiny_cell):
    cell = tiny_cell(verts=200, faces=80)
    sizes = cell.config["body"]
    gt = scene_lib.realistic_params(torch.Generator().manual_seed(7), 64, sizes, cell.traffic, "cpu")
    rot = body_lib.rotmat_from_6d(gt[0])  # (64, 23, 3, 3)
    ranges = scene_lib.joint_ranges(cell.traffic["pose"], 23, "cpu")
    # Knees (pose joints 3 and 4) bend about x alone, forward of straight.
    knee = rot[:, 3]
    assert torch.allclose(knee[:, 0], torch.tensor([1.0, 0.0, 0.0]).expand(64, 3), atol=1e-5)
    angle = torch.rad2deg(torch.atan2(knee[:, 2, 1], knee[:, 1, 1]))
    lo, hi = ranges[3, 0].tolist()
    assert bool(((angle >= lo - 1e-3) & (angle <= hi + 1e-3)).all()) and float(angle.std()) > 10
    # Each joint turns by no more than its ranges allow, all three at their extremes.
    most = torch.rad2deg(torch.acos(((rot.diagonal(dim1=-2, dim2=-1).sum(-1) - 1) / 2).clamp(-1, 1)))
    bound = ranges.abs().amax(dim=-1).norm(dim=-1)
    assert bool((most <= bound + 1e-2).all())
    assert math.isclose(float(scene_lib.euler_rotmats(torch.tensor([0.0, 0.0, 90.0]))[1, 0]), 1.0,
                        abs_tol=1e-6)


def test_regressor_rows_lie_on_their_joints(tiny_cell):
    cell = tiny_cell(verts=2000, faces=400)
    s = scene_lib.make_scene(3, cell.config, cell.traffic, "cpu")
    reg = body_lib.normalized_regressor(s.j_reg_true)
    assert int((s.j_reg_true > 0).sum(dim=1).min()) == 8
    rest = s.body.j_regressor @ s.body.v_template
    anchors = torch.stack([(rest[a] + rest[b]) / 2 for a, b in scene_lib.H36M_ANCHORS])
    assert float((reg @ s.body.v_template - anchors).norm(dim=-1).max()) < 0.1  # metres
    # The joints spread over the body, not at its centroid.
    assert float((reg @ s.body.v_template)[:, :2].std(dim=0).min()) > 0.1  # the T-pose is flat in z


def test_unknown_scene_raises(tiny_cell):
    cell = tiny_cell(verts=200, faces=80)
    with pytest.raises(ValueError):
        scene_lib.make_scene(1, cell.config, dict(cell.traffic, scene="drift"), "cpu")
