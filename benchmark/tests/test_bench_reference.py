"""The plain reference against the port's plain paths at a tiny size, on
the CPU: the body, the priors, the silhouette, and whole outer steps."""

import pytest
import torch

from benchmark import check, harness, program as program_lib, scene as scene_lib
from benchmark.reference import body as body_lib
from benchmark.reference import raster


@pytest.fixture
def built(tiny_cell):
    cell = tiny_cell(verts=600, faces=200)
    scene = scene_lib.make_scene(21, cell.config, cell.traffic, "cpu")
    return cell, scene, program_lib.Program(scene, cell.config, "cpu")


def test_body_and_priors_match_the_port(built):
    from jrr_tpu_torch.refine import losses

    cell, scene, prog = built
    init, _, _ = prog.batch(0)
    nx = body_lib.Numerics()
    mine = body_lib.smpl_vertices(nx, scene.body, init.betas, init.orient6d, init.pose6d)
    theirs = losses.forward_frame(prog.model, init).vertices
    assert float((mine - theirs).abs().max()) < 1e-6
    rot6d = torch.cat([init.orient6d, init.pose6d], dim=1)
    pd = body_lib.pose_prior(nx, scene.pose_w, rot6d)
    assert float((pd - prog.state0.pose_disc(rot6d)[..., 0]).abs().max()) < 1e-6
    sd = body_lib.shape_prior(nx, scene.shape_w, init.betas)
    assert float((sd - prog.state0.shape_disc(init.betas)).abs().max()) < 1e-6


def test_silhouette_matches_the_dense_oracle(built):
    from jrr_tpu_torch.render import camera, silhouette

    cell, scene, prog = built
    init, data, _ = prog.batch(0)
    verts = body_lib.smpl_vertices(body_lib.Numerics(), scene.body, init.betas, init.orient6d,
                                   init.pose6d)
    for size in (224, 112):
        focal = 5000.0 * size / 224
        sp = raster.spec(size, 1e-4, 1e-4)
        spec = silhouette.RasterizerSpec(image_size=size, sigma=1e-4, blur_radius=1e-4,
                                         focal_length=focal)
        screen = camera.project_points_screen(verts, init.cam_t, size, focal)
        xy = body_lib.screen(verts, init.cam_t, size, focal)
        assert float((xy - screen[..., :2]).abs().max()) < 1e-4
        leaf = screen.detach().requires_grad_(True)
        dense = torch.stack([silhouette.render_silhouette_dense(leaf[i], prog.model.faces, spec)
                             for i in range(leaf.shape[0])])
        mask = data.mask if size == 224 else data.mask.reshape(4, 112, 2, 112, 2).mean((2, 4))
        want = ((dense - mask) ** 2).mean(dim=(1, 2))
        (g_want,) = torch.autograd.grad(want.sum(), [leaf])
        got, g_got = raster.loss_and_grad(screen[..., :2], scene.body.faces, mask, sp)
        assert float((raster.alpha(screen[..., :2], scene.body.faces, sp) - dense).abs().max()) < 1e-5
        assert float((got - want).abs().max()) < 1e-6
        assert float((g_got - g_want[..., :2]).norm()) < 1e-3 * float(g_want.norm())


def _numbers(cell, seed=3):
    """The check's numbers of the port's first steps against the reference's."""
    scene = scene_lib.make_scene(seed, cell.config, cell.traffic, "cpu")
    steps = cell.limits["steps"]
    got, _, _ = harness.first_steps(program_lib.Program(scene, cell.config, "cpu"), steps)
    return check.compare(got, check.run_reference(scene, cell.config, steps))


def test_outer_steps_match_without_the_silhouette(tiny_cell):
    numbers = _numbers(tiny_cell("outer.nosil.b256"))
    assert numbers.pop("frame_gap") < 1e-3, numbers  # mm
    assert max(numbers.values()) < 1e-5, numbers


def test_outer_steps_match_with_the_silhouette_where_capacity_holds(tiny_cell):
    """With the rasterizer's capacities above what the small body needs, the
    port's fused silhouette (its plain version here) is the reference's."""
    numbers = _numbers(tiny_cell(silhouette=True, unbounded=True))
    assert numbers["first_loss_gap"] < 1e-5, numbers
    assert max(numbers[n] for n in ("grad_gap", "change_gap", "pgt_gap")) < 5e-3, numbers
    assert numbers["frame_gap"] < 1.0, numbers  # mm
    assert numbers["loss_gap"] < 2e-2, numbers
