"""The port's refine_batch against jrr_tpu on the CPU, at the golden test's
tolerances (atol 5e-4 on params and joints3d, 1e-4 on the stage-B curve):

- the golden problem (tests/make_golden.py: fused silhouette, rebin 5,
  stride 2, interior skip) reproduces tests/golden_refinement.npz;
- a coarse-to-fine problem (image 32 → 16, coarse stride 4, rebin 2,
  interior skip, live discriminators) follows JAX's own refine_batch.
"""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

import make_golden
from jrr_tpu.models import discriminator as disc
from jrr_tpu.refine import engine
from jrr_tpu_torch import convert
from jrr_tpu_torch.refine import engine as tengine

PARAMS = ("pose6d", "orient6d", "betas", "cam_t")


def _port_run(model, j_reg, cfg, init, data, pose_p=None, shape_p=None):
    res = tengine.refine_batch(
        convert.smpl_model(model, device="cpu"), torch.as_tensor(np.array(j_reg)),
        convert.frame_params(init, device="cpu"), convert.frame_batch(data, device="cpu"),
        convert.refiner_config(cfg),
        None if pose_p is None else convert.pose_discriminator(pose_p, device="cpu"),
        None if shape_p is None else convert.shape_discriminator(shape_p, device="cpu"),
    )
    out = {k: getattr(res.params, k).numpy() for k in PARAMS}
    out["joints3d"] = res.joints3d.numpy()
    out["stage_b_total"] = res.stage_b_terms.total.numpy()
    return out, res


def _assert_golden_close(got, want):
    for key in PARAMS + ("joints3d",):
        np.testing.assert_allclose(got[key], want[key], atol=5e-4, err_msg=key)
    np.testing.assert_allclose(got["stage_b_total"], want["stage_b_total"], atol=1e-4,
                               err_msg="loss curve")


def test_reproduces_golden_refinement():
    model, j_reg, cfg, init, data, _ = make_golden.build_problem()
    got, _ = _port_run(model, j_reg, cfg, init, data)
    path = os.path.join(os.path.dirname(__file__), "golden_refinement.npz")
    with np.load(path) as f:
        _assert_golden_close(got, dict(f))


def test_refine_rejects_masks_outside_the_kernel_range():
    from jrr_tpu_torch import problem

    model, j_reg, cfg, init, data = problem.synthetic_problem(
        batch=1, num_verts=96, image_size=32, device="cpu"
    )
    # The loss kernel's range check, held on the CPU path too.
    with pytest.raises(RuntimeError, match="mask"):
        tengine.refine_batch(model, j_reg, init, data._replace(mask=data.mask + 2.0), cfg)


def test_coarse_to_fine_path_matches_jax():
    model, j_reg, cfg, init, data, _ = make_golden.build_problem()
    cfg = dataclasses.replace(
        cfg, stage_a_steps=10, stage_b_steps=8, use_discriminators=True,
        silhouette=dataclasses.replace(
            cfg.silhouette, coarse_min_image=16, rebin_interval=2, bin_margin_px=4.0,
        ),
    )
    pose_p = disc.init_pose_discriminator(jax.random.PRNGKey(7))
    shape_p = disc.init_shape_discriminator(jax.random.PRNGKey(8))
    want = engine.refine_batch(model, j_reg, init, data, cfg, pose_p, shape_p)
    got, res = _port_run(model, j_reg, cfg, init, data, pose_p, shape_p)
    _assert_golden_close(got, {
        **{k: np.asarray(getattr(want.params, k)) for k in PARAMS},
        "joints3d": np.asarray(want.joints3d),
        "stage_b_total": np.asarray(want.stage_b_terms.total),
    })
    for name, a, b in zip(want.bin_stats._fields, res.bin_stats, want.bin_stats):
        assert int(a) == int(b), name
    # Both phases ran: coarse stride 4 over 4 steps, fine stride 2 over 4.
    assert res.stage_b_terms.silhouette.shape == (8,)
    active = (res.stage_b_terms.silhouette.numpy() != 0).tolist()
    assert active == [True, False, False, False, True, False, True, False]
