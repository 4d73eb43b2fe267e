"""The port's refine_batch against jrr_tpu on the CPU, at the golden test's
tolerances (atol 5e-4 on params and joints3d, 1e-4 on the stage-B curve):

- the golden problem (tests/make_golden.py: fused silhouette, rebin 5,
  stride 2, interior skip) reproduces tests/golden_refinement.npz;
- a coarse-to-fine problem (image 32 → 16, coarse stride 4, rebin 2,
  interior skip, live discriminators) follows JAX's own refine_batch;
- in float64, a small scene (128 vertices, 4 frames at 64², rebin 5) follows
  JAX's float64 refinement to 1e-5 over 5 stage-B steps;
- `silhouette.backend="xla"` follows JAX's at rebin_interval 1 (every
  stage-B step through the XLA tile loop) and 2 (the round-1 route), and
  at 2 equals the port's own "pallas" refinement bit for bit;
- refine_batch turns TF32 off only while it runs.
"""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

import make_golden
from jrr_tpu import config as cfg_lib
from jrr_tpu.data import fixtures
from jrr_tpu.models import discriminator as disc
from jrr_tpu.models import smpl as smpl_mod
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


def _xla_problem(rebin: int):
    """The round-1 parity problem of tests/test_torch_render.py (golden scene,
    10 + 8 steps, no coarse phase) on the XLA backend."""
    model, j_reg, cfg, init, data, _ = make_golden.build_problem()
    sil = dataclasses.replace(cfg.silhouette, backend="xla", rebin_interval=rebin, coarse_frac=0.0)
    return model, j_reg, dataclasses.replace(cfg, stage_a_steps=10, stage_b_steps=8,
                                             silhouette=sil), init, data


@pytest.mark.parametrize("rebin", [1, 2])
def test_refine_batch_xla_matches_jax(rebin):
    model, j_reg, cfg, init, data = _xla_problem(rebin)
    want = engine.refine_batch(model, j_reg, init, data, cfg)
    got, res = _port_run(model, j_reg, cfg, init, data)
    _assert_golden_close(got, {**{k: np.asarray(getattr(want.params, k)) for k in PARAMS},
                               "joints3d": np.asarray(want.joints3d),
                               "stage_b_total": np.asarray(want.stage_b_terms.total)})
    assert int((res.stage_b_terms.silhouette != 0).sum()) >= 3
    if rebin > 1:  # the same computation as "pallas", bit for bit
        pallas = dataclasses.replace(cfg, silhouette=dataclasses.replace(cfg.silhouette,
                                                                         backend="pallas"))
        other, _ = _port_run(model, j_reg, pallas, init, data)
        for key in got:
            np.testing.assert_array_equal(other[key], got[key], err_msg=key)


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


def _float64(x):
    x = np.asarray(x)
    return x.astype(np.float64) if np.issubdtype(x.dtype, np.floating) else x


def _to_double(t):
    return t.double() if torch.is_tensor(t) and t.is_floating_point() else t


def test_float64_small_scene_matches_jax():
    """The scene of test_lane_pack.py::test_engine_lane_pack_runs_cpu (a
    128-vertex synthetic SMPL, 4 frames at 64², init offset +0.02, tile 8,
    rebin 5, faces_per_tile 96) refined by both packages in float64, 5 + 5
    steps: the parameters agree to 1e-5. In float32 the two part through
    rounding alone (3e-4 after 5 stage-B steps, as far as JAX's own float32
    run lies from its float64 one), so float64 is where a port fault shows.
    The problem is built in 32-bit mode: under x64 the fixture draws other
    numbers."""
    model = smpl_mod.synthetic_smpl_model(seed=0, num_verts=128, num_faces=200)
    j_reg = np.zeros((17, 128), np.float32)
    rng = np.random.default_rng(0)
    for j in range(17):
        j_reg[j, rng.choice(128, 4, replace=False)] = 1.0
    gt, data = fixtures.make_synthetic_frames(model, j_reg, 4, seed=1, image_size=64)
    init = jax.tree.map(lambda x: x + 0.02, gt)
    cfg = cfg_lib.RefinerConfig(
        stage_a_steps=5, stage_b_steps=5, use_discriminators=False,
        silhouette=cfg_lib.SilhouetteConfig(image_size=64, tile_size=8, rebin_interval=5,
                                            coarse_frac=0.0, interior_skip=False),
    )
    model, init, data = jax.tree.map(np.asarray, (model, init, data))
    with jax.enable_x64(True):
        args = jax.tree.map(lambda x: jax.numpy.asarray(_float64(x)), (model, j_reg, init, data))
        want = engine.refine_batch(*args[:2], *args[2:], cfg)
        want = {k: np.asarray(getattr(want.params, k)) for k in PARAMS}
    assert want["pose6d"].dtype == np.float64
    tm = convert.smpl_model(model, device="cpu")
    tm = dataclasses.replace(tm, **{f.name: _to_double(getattr(tm, f.name))
                                    for f in dataclasses.fields(tm)})
    ti = convert.frame_params(init, device="cpu")
    td = convert.frame_batch(data, device="cpu")
    got = tengine.refine_batch(
        tm, torch.as_tensor(j_reg, dtype=torch.float64), type(ti)(*map(_to_double, ti)),
        type(td)(*map(_to_double, td)), convert.refiner_config(cfg),
    )
    assert int((got.stage_b_terms.silhouette != 0).sum()) == 3  # stride 2 over 5 steps
    for key in PARAMS:
        assert getattr(got.params, key).dtype == torch.float64
        np.testing.assert_allclose(getattr(got.params, key).numpy(), want[key], atol=1e-5,
                                   rtol=0, err_msg=key)


@pytest.mark.parametrize("outcome", ["returns", "raises"])
def test_refine_batch_restores_tf32_flags(outcome, monkeypatch):
    """refine_batch runs with TF32 off for matmuls and cuDNN and leaves both
    flags as the caller set them, on return and when an exception is
    raised inside the call (here the mask range check)."""
    from jrr_tpu_torch import problem

    model, j_reg, cfg, init, data = problem.synthetic_problem(
        batch=1, num_verts=96, image_size=32, device="cpu"
    )
    cfg = dataclasses.replace(cfg, stage_a_steps=2, stage_b_steps=2)
    if outcome == "raises":
        data = data._replace(mask=data.mask + 2.0)
    flags = (torch.backends.cuda.matmul, torch.backends.cudnn)
    inside = []
    step = tengine._Adam.step

    def recording_step(self, params, grads):
        inside.append(tuple(f.allow_tf32 for f in flags))
        return step(self, params, grads)

    monkeypatch.setattr(tengine._Adam, "step", recording_step)
    saved = tuple(f.allow_tf32 for f in flags)
    try:
        for f in flags:
            f.allow_tf32 = True
        if outcome == "raises":
            with pytest.raises(RuntimeError, match="mask"):
                tengine.refine_batch(model, j_reg, init, data, cfg)
        else:
            tengine.refine_batch(model, j_reg, init, data, cfg)
        after = tuple(f.allow_tf32 for f in flags)
    finally:
        for f, v in zip(flags, saved):
            f.allow_tf32 = v
    assert inside and set(inside) == {(False, False)}
    assert after == (True, True)
