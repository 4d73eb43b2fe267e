"""The flagship workload's unit as a plain function with example arguments
(counterpart of `__graft_entry__.entry()`, __graft_entry__.py:143-169).

`entry()` returns `(fn, example_args)`: `fn(*example_args)` is the full
five-term stage-B objective (SMPL forward, joint regression, 2D
reprojection, the 224² soft-silhouette render, live pose and shape
adversarial priors) on the full-size body, `losses.stage_b_loss`. On the
card its silhouette term runs the fused loss kernel. The multi-device dry
run and the synthetic problem have their counterparts in
`parallel/dryrun.py` and `problem.synthetic_problem`.
"""

from __future__ import annotations

from jrr_tpu_torch import problem as problem_lib
from jrr_tpu_torch import resolve_device
from jrr_tpu_torch.models import discriminator
from jrr_tpu_torch.ops import jreg as jreg_lib
from jrr_tpu_torch.refine import losses
from jrr_tpu_torch.utils import precision

BATCH, NUM_VERTS, IMAGE_SIZE = 8, 6890, 224
POSE_DISC_SEED, SHAPE_DISC_SEED = 7, 8


def entry(device=None):
    """(fn, (init, j_reg_norm, data, model, pose_disc, shape_disc)) of the
    synthetic problem at batch 8, 6890 vertices and 224², the regressor
    normalized, discriminators from seeds 7 and 8; `fn` returns
    (total, LossTerms) with float32 products. On the card unless `device`
    says otherwise (None: "cuda"; a missing card raises)."""
    dev = resolve_device("cuda" if device is None else device)
    model, j_reg, cfg, init, data = problem_lib.synthetic_problem(
        batch=BATCH, num_verts=NUM_VERTS, image_size=IMAGE_SIZE, device=dev)
    j_reg_norm = jreg_lib.normalize_jreg(j_reg)
    pose_disc = discriminator.PoseDiscriminator(seed=POSE_DISC_SEED, device=dev)
    shape_disc = discriminator.ShapeDiscriminator(seed=SHAPE_DISC_SEED, device=dev)

    def fn(params, j_reg_norm, data, model, pose_disc, shape_disc):
        with precision.float32_products():
            return losses.stage_b_loss(model, j_reg_norm, pose_disc, shape_disc, params, data, cfg)

    return fn, (init, j_reg_norm, data, model, pose_disc, shape_disc)
