"""The port's lane packing against jrr_tpu on the CPU:

- `pack_bins` equals JAX's exactly, every packed field (the scenes of
  test_lane_pack.py, and a 1024-vertex scene whose small page lists make
  some pairs fail the page-union limit);
- the plain packed loss+grad against JAX's interpret-mode packed kernel, at
  bin time and on drifted tables, with faces_per_tile 64 (packing drops
  nothing) and 96 (packing thins margin candidates): err rtol 1e-5,
  gradients at the kernel test's criterion (atol 3e-4·max + rtol 2e-4;
  the tie routing differs, ROADMAP Queue 3);
- the port's packed against its unpacked loss at bin time (the exactness
  contract of test_lane_pack.py: err rtol 2e-5, gradients atol 5e-5·max);
- `refine_batch(lane_pack=True)` against JAX's, whose CPU path computes the
  unpacked loss: with faces_per_tile 64 the two are the same function
  (golden tolerances, atol 5e-4 on params and joints, 1e-4 on the curve),
  and against the port's own unpacked refinement (1e-5).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import make_golden
from jrr_tpu import config as cfg_lib
from jrr_tpu.data import fixtures
from jrr_tpu.models import smpl as smpl_mod
from jrr_tpu.refine import engine
from jrr_tpu.render import silhouette as sil
from jrr_tpu.render import silhouette_fused as sf
from jrr_tpu_torch import convert
from jrr_tpu_torch.refine import engine as tengine
from jrr_tpu_torch.render import silhouette_fused as tsf
from test_lane_pack import _bins_and_tables, _problem
from test_torch_silhouette import _port, _t

PACKED = ("p_pages", "p_idx", "p_origin_b", "p_flags", "p_buddy", "p_num_pairs")


def _dense_problem(seed=2):
    """256 vertices, 1024 faces on a 32² image: many tiles hold more than 64
    candidates (truncated at 96) with at most 64 core ones, so packing
    thins their margin candidates."""
    model = smpl_mod.synthetic_smpl_model(seed=seed, num_verts=256, num_faces=1024)
    rng = np.random.default_rng(seed)
    verts = model.v_template[None] + jnp.asarray(
        rng.normal(scale=0.01, size=(2, 256, 3)).astype(np.float32)
    )
    cam_t = jnp.asarray(np.stack(
        [rng.uniform(-0.05, 0.05, 2), rng.uniform(-0.05, 0.05, 2), rng.uniform(18, 22, 2)], axis=-1
    ).astype(np.float32))
    spec = sil.RasterizerSpec(image_size=32, tile_size=8, faces_per_tile=96, sigma=1e-4,
                              blur_radius=2e-4, bin_margin_px=8.0)
    return model, verts, cam_t, spec


def _packed_pair(model, verts, cam_t, spec):
    """(JAX packed bins, the port's packed bins) of one scene."""
    want = sf.pack_bins(sf.compute_fused_bins(verts, model, cam_t, spec), model.num_verts)
    tm, tv, tc, tspec = _port(model, verts, cam_t, spec)
    got = tsf.pack_bins(tsf.compute_fused_bins(tv, tm, tc, tspec), tm.num_verts)
    return want, got


def _assert_packed_equal(want, got):
    for field in PACKED:
        np.testing.assert_array_equal(
            getattr(got, field).numpy(), np.asarray(getattr(want, field)), err_msg=field
        )


@pytest.mark.parametrize("seed", [0, 3, 5])
def test_pack_bins_equal_jax(seed):
    want, got = _packed_pair(*_problem(seed=seed))
    assert int(np.asarray(want.p_num_pairs).sum()) > 0
    _assert_packed_equal(want, got)
    # The unpacked fields stay as they were.
    for field in ("pages", "idx", "origin", "core_count"):
        np.testing.assert_array_equal(getattr(got, field).numpy(), np.asarray(getattr(want, field)))


def test_pack_bins_equal_jax_when_page_unions_overflow():
    model, verts, cam_t, spec = _problem(seed=1, num_verts=1024)
    want, got = _packed_pair(model, verts, cam_t, spec._replace(pages_per_tile=4))
    _assert_packed_equal(want, got)
    # Some packable tiles had a buddy but stayed unpacked: their page union
    # exceeded P̂ − 1 = 3 pages.
    dump = sf.dump_page_id(model.num_verts)
    packable = (np.asarray(want.pages[:, :, 0]) != dump) & (np.asarray(want.core_count) <= 64)
    with_buddy = packable.sum(axis=1) // 2 * 2
    assert (2 * np.asarray(want.p_num_pairs) < with_buddy).any()


def test_dense_scene_thins_candidates():
    """The dense scene packs tiles whose unpacked rows hold more than 64
    real candidates, so packed and unpacked differ after drift."""
    model, verts, cam_t, spec = _dense_problem()
    want, got = _packed_pair(model, verts, cam_t, spec)
    _assert_packed_equal(want, got)
    real = (np.asarray(want.idx)[:, :, 0, :] >> 7) != want.pages.shape[2] - 1
    assert ((np.asarray(want.p_flags) > 0) & (real.sum(-1) > 64)).any()


def _lossgrad_case(dense, drift):
    problem = _dense_problem() if dense else _problem(seed=3)
    model = problem[0]
    bins, tx, ty, inv_sigma, blur_px2 = _bins_and_tables(*problem)
    packed = sf.pack_bins(bins, model.num_verts)
    rng = np.random.default_rng(7)
    if drift and dense:  # a 6 px shift (inside the 8 px margin) brings thinned candidates in
        tx = tx + 6.0
    elif drift:  # N(0, 0.5 px) per vertex, as test_lane_pack.py
        tx = tx + jnp.asarray(rng.normal(scale=0.5, size=tx.shape).astype(np.float32))
        ty = ty + jnp.asarray(rng.normal(scale=0.5, size=ty.shape).astype(np.float32))
    spec = problem[3]
    mask = jnp.asarray(rng.uniform(
        0, 1, size=(tx.shape[0], bins.pages.shape[1], spec.tile_size**2)).astype(np.float32))
    return packed, tx, ty, mask, spec.tile_size, inv_sigma, blur_px2, sf.dump_page_id(model.num_verts)


def _port_packed(packed, tx, ty, mask, tile, inv_sigma, blur_px2):
    return tsf.fused_lossgrad_packed_plain(
        _t(tx), _t(ty), *(_t(getattr(packed, f)) for f in ("p_pages", "p_idx", "origin")),
        *(_t(getattr(packed, f)) for f in ("p_origin_b", "p_flags", "p_buddy")), _t(mask),
        tile, inv_sigma, blur_px2,
    )


@pytest.mark.parametrize("drift", [False, True], ids=["bin_time", "drifted"])
@pytest.mark.parametrize("dense", [False, True], ids=["fpt64", "fpt96"])
def test_plain_packed_lossgrad_matches_interpret_kernel(dense, drift):
    packed, tx, ty, mask, tile, inv_sigma, blur_px2, dump = _lossgrad_case(dense, drift)
    # chunk=1: the result does not depend on it, and interpret mode traces less.
    err, dtx, dty = sf._fused_lossgrad_packed_impl(
        tx, ty, packed, mask, tile, inv_sigma, blur_px2, dump, 1, True,
    )
    got = _port_packed(packed, tx, ty, mask, tile, inv_sigma, blur_px2)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(err), rtol=1e-5)
    for a, b in zip(got[1:], (dtx, dty)):
        scale = np.abs(np.asarray(b)).max() + 1e-12
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=3e-4 * scale, rtol=2e-4)
    if dense and drift:
        # Packing thinned candidates that drift moved into reach.
        unpacked = tsf.fused_lossgrad_plain(
            _t(tx), _t(ty), _t(packed.pages), _t(packed.idx), _t(packed.origin), _t(mask),
            tile, inv_sigma, blur_px2,
        )
        assert not np.allclose(got[0].numpy(), unpacked[0].numpy(), rtol=1e-3)


@pytest.mark.parametrize("dense", [False, True], ids=["fpt64", "fpt96"])
def test_port_packed_equals_unpacked_at_bin_time(dense):
    packed, tx, ty, mask, tile, inv_sigma, blur_px2, _ = _lossgrad_case(dense, drift=False)
    got = _port_packed(packed, tx, ty, mask, tile, inv_sigma, blur_px2)
    want = tsf.fused_lossgrad_plain(
        _t(tx), _t(ty), _t(packed.pages), _t(packed.idx), _t(packed.origin), _t(mask),
        tile, inv_sigma, blur_px2,
    )
    np.testing.assert_allclose(got[0].numpy(), want[0].numpy(), rtol=2e-5)
    for a, b in zip(got[1:], want[1:]):
        scale = float(b.abs().max()) + 1e-12
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=5e-5 * scale)


def test_refine_lane_pack_matches_jax():
    """The golden problem (tests/make_golden.py) at faces_per_tile 64 with
    lane packing: the port packs at each rebin and runs the packed plain
    version, JAX's CPU path runs its unpacked twin; with at most 64
    candidates a tile loses nothing to packing, so both compute one loss."""
    model, j_reg, cfg, init, data, _ = make_golden.build_problem()
    cfg = dataclasses.replace(cfg, silhouette=dataclasses.replace(
        cfg.silhouette, faces_per_tile=64, lane_pack=True))
    want = engine.refine_batch(model, j_reg, init, data, cfg)
    calls = []
    real = tsf.pack_bins
    try:
        tsf.pack_bins = lambda *a, **k: calls.append(1) or real(*a, **k)
        got = tengine.refine_batch(
            convert.smpl_model(model, device="cpu"), torch.as_tensor(np.array(j_reg)),
            convert.frame_params(init, device="cpu"), convert.frame_batch(data, device="cpu"),
            convert.refiner_config(cfg),
        )
    finally:
        tsf.pack_bins = real
    assert len(calls) == cfg.stage_b_steps // cfg.silhouette.rebin_interval  # one per rebin
    for key in ("pose6d", "orient6d", "betas", "cam_t"):
        np.testing.assert_allclose(getattr(got.params, key).numpy(),
                                   np.asarray(getattr(want.params, key)), atol=5e-4, err_msg=key)
    np.testing.assert_allclose(got.joints3d.numpy(), np.asarray(want.joints3d), atol=5e-4)
    np.testing.assert_allclose(got.stage_b_terms.total.numpy(),
                               np.asarray(want.stage_b_terms.total), atol=1e-4)
    assert float(got.stage_b_terms.silhouette.abs().sum()) > 0


def test_refine_lane_pack_equals_unpacked():
    """The scene of test_engine_lane_pack_runs_cpu at faces_per_tile 64: the
    port's packed refinement follows its unpacked one to 1e-5 (the lane
    product is reassociated), as JAX's does on the TPU by contract."""
    model = smpl_mod.synthetic_smpl_model(seed=0, num_verts=128, num_faces=200)
    j_reg = np.zeros((17, 128), np.float32)
    rng = np.random.default_rng(0)
    for j in range(17):
        j_reg[j, rng.choice(128, 4, replace=False)] = 1.0
    gt, data = fixtures.make_synthetic_frames(model, j_reg, 4, seed=1, image_size=64)
    init = jax.tree.map(lambda x: x + 0.02, gt)
    sil_cfg = cfg_lib.SilhouetteConfig(
        image_size=64, tile_size=8, rebin_interval=5, coarse_frac=0.0, interior_skip=False,
        faces_per_tile=64,
    )
    cfg = convert.refiner_config(cfg_lib.RefinerConfig(
        stage_a_steps=5, stage_b_steps=10, silhouette=sil_cfg, use_discriminators=False))
    args = (convert.smpl_model(model, device="cpu"), torch.as_tensor(j_reg),
            convert.frame_params(init, device="cpu"), convert.frame_batch(data, device="cpu"))
    off = tengine.refine_batch(*args, cfg)
    on = tengine.refine_batch(*args, dataclasses.replace(
        cfg, silhouette=dataclasses.replace(cfg.silhouette, lane_pack=True)))
    np.testing.assert_allclose(on.joints3d.numpy(), off.joints3d.numpy(), atol=1e-5)
    np.testing.assert_allclose(on.stage_b_terms.total.numpy(), off.stage_b_terms.total.numpy(),
                               rtol=1e-5)
