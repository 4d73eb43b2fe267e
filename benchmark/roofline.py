"""The yardstick's arithmetic: the card's peaks and the model FLOPs of an
outer step counted from shapes.

Peak: one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at its 700 W
limit): 67 TFLOP/s float32 outside the tensor cores (the port runs with
TF32 off).

Model FLOPs count the products (2 per multiply-add) of the mathematics the
configuration states, as many times as its schedule needs them: stage B's
forward and backward (gradients of the refined parameters only: the body's
arrays, the regressor and the priors are constants there), the initial
joints and final vertices of the refinement, the two priors' LSGAN
forwards and backwards on real and fake, the regressor's gradient, the
initial vertices and three regressions of the evaluations. Elementwise work,
Adam, the Procrustes SVDs and the silhouette are not counted. Stage A's 2D
reprojection holds no product.
"""

from __future__ import annotations

F32_FLOP_PER_S = 67e12


def smpl_macs(v: int, j: int, nb: int, backward: bool = False) -> int:
    """Multiply-adds of one frame's body forward, or of its backward to the
    shape and pose parameters."""
    p = 9 * (j - 1)
    # Products whose two operands both carry the parameters' gradient
    # (forward kinematics, the joint offsets, the final per-vertex rotation)
    # take two products in the backward, the others one.
    both = 27 * (j - 1) + 9 * (j - 1) + 9 * j + 9 * v
    once = 3 * v * nb + 3 * j * v + p * 3 * v + 12 * v * j
    return once + (2 * both if backward else both)


def pose_prior_macs() -> int:
    return 24 * 6 * 32 + 24 * 32 * 32 + 24 * 32 * 1024 + 1024 * 1024 + 1024 + 24 * 32


def shape_prior_macs() -> int:
    return 10 * 10 + 10 * 5 + 5


def outer_step_flops(config: dict, batch: int) -> int:
    """Model FLOPs of one outer step on `batch` frames."""
    body = config["body"]
    r = config["pipeline"]["refiner"]
    v, j, nb, nr = body["num_verts"], body["num_joints"], body["num_betas"], body["regressor_joints"]
    reg = nr * v * 3
    fwd = smpl_macs(v, j, nb)
    bwd = smpl_macs(v, j, nb, backward=True)
    priors = r["use_discriminators"]
    pose, shape = (pose_prior_macs(), shape_prior_macs()) if priors else (0, 0)
    stage_b = fwd + bwd + 2 * reg + 2 * pose + 2 * shape
    refine = r["stage_b_steps"] * stage_b + 2 * (fwd + reg)
    # LSGAN: forward, weight gradients, and the activations' gradients of
    # every layer after the first, on real and on fake.
    lsgan = 2 * (3 * pose_prior_macs() - 24 * 6 * 32) + 2 * (3 * shape_prior_macs() - 10 * 10)
    outer = lsgan + 2 * reg + fwd + 3 * reg
    return 2 * batch * (refine + outer)

