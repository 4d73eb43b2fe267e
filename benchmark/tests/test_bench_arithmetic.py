"""The yardstick's arithmetic held to counts made another way at a tiny
size: the product FLOPs against torch's FlopCounterMode over the
reference's own products, and the outer step's by hand."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import roofline, scene as scene_lib
from benchmark.reference import body as body_lib


def _counted(fn):
    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


@pytest.fixture
def small():
    gen = torch.Generator().manual_seed(3)
    sizes = dict(num_verts=40, num_faces=30, num_joints=24, num_betas=10)
    body = scene_lib.make_body(gen, "cpu", sizes)
    b = 3
    params = (scene_lib.rot6d(scene_lib.random_rotmats(gen, (b, 23), "cpu")),
              scene_lib.rot6d(scene_lib.random_rotmats(gen, (b, 1), "cpu")),
              torch.randn(b, 10, generator=gen))
    return body, params, b


def test_body_forward_and_backward_flops(small):
    body, (pose, orient, betas), b = small
    nx = body_lib.Numerics()
    fwd = 2 * b * roofline.smpl_macs(40, 24, 10)
    assert _counted(lambda: body_lib.smpl_vertices(nx, body, betas, orient, pose)) == fwd
    leaves = [x.clone().requires_grad_(True) for x in (betas, orient, pose)]

    def both():
        v = body_lib.smpl_vertices(nx, body, *leaves)
        torch.autograd.grad(v.sum(), leaves)

    assert _counted(both) == fwd + 2 * b * roofline.smpl_macs(40, 24, 10, backward=True)


def test_prior_flops():
    gen = torch.Generator().manual_seed(4)
    pose_w, shape_w = scene_lib.make_priors(gen, "cpu")
    nx = body_lib.Numerics()
    x = torch.randn(5, 24, 6, requires_grad=True)
    y = torch.randn(5, 10, requires_grad=True)
    assert _counted(lambda: body_lib.pose_prior(nx, pose_w, x)) == 2 * 5 * roofline.pose_prior_macs()
    assert _counted(lambda: body_lib.shape_prior(nx, shape_w, y)) == 2 * 5 * roofline.shape_prior_macs()

    def lsgan():  # weight gradients, inputs constant
        w = {k: v.clone().requires_grad_(True) for k, v in pose_w.items()}
        out = body_lib.pose_prior(nx, w, x.detach())
        torch.autograd.grad(out.sum(), list(w.values()))

    assert _counted(lsgan) == 2 * 5 * (3 * roofline.pose_prior_macs() - 24 * 6 * 32)


def test_outer_step_flops_by_hand(tiny_cell):
    cell = tiny_cell(verts=40, faces=30)
    v, j, nb, r = 40, 24, 10, 17
    fwd, bwd = roofline.smpl_macs(v, j, nb), roofline.smpl_macs(v, j, nb, backward=True)
    pose, shape, reg = roofline.pose_prior_macs(), roofline.shape_prior_macs(), 17 * 40 * 3
    stage_b = fwd + bwd + 2 * reg + 2 * pose + 2 * shape
    outer = 2 * (3 * pose - 24 * 6 * 32) + 2 * (3 * shape - 100) + 2 * reg + fwd + 3 * reg
    assert roofline.outer_step_flops(cell.config, 4) == 2 * 4 * (8 * stage_b + 2 * (fwd + reg) + outer)
    assert r == cell.config["body"]["regressor_joints"]
    # SMPL's own products at its published sizes, by hand.
    assert fwd == 3 * 40 * 10 + 3 * 24 * 40 + 207 * 3 * 40 + 12 * 40 * 24 + 36 * 23 + 9 * 24 + 9 * 40

