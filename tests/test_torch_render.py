"""The port's round-1 tile rasterizer and the fused α VJP against jrr_tpu on
the CPU: round-1 bins equal exactly (small model and full width), the
scatter-free slot-gather backward equals autograd's index backward, the
plain tile α against the interpret-mode Pallas forward kernel (atol 1e-5)
and its gradient against JAX's autodiff twin and the interpret-mode backward
kernel (the JAX kernel test's criterion), whole renders against JAX and the
dense oracle, the gradient of `silhouette_tiles_fused` against jax.grad, and
`refine_batch` with `backend="pallas"` against JAX's."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import make_golden
from jrr_tpu.models import smpl as smpl_mod
from jrr_tpu.refine import engine
from jrr_tpu.render import silhouette as sil
from jrr_tpu.render import silhouette_fused as sf
from jrr_tpu.render import silhouette_pallas as sp
from jrr_tpu_torch import convert
from jrr_tpu_torch.refine import engine as tengine
from jrr_tpu_torch.refine import losses as tlosses
from jrr_tpu_torch.render import silhouette as tsil
from jrr_tpu_torch.render import silhouette_fused as tsf
from jrr_tpu_torch.render import silhouette_pallas as tsp
from test_silhouette_fused import _problem

PARAMS = ("pose6d", "orient6d", "betas", "cam_t")


def _t(x):
    return torch.as_tensor(np.array(x))


def _tspec(spec):
    return tsil.RasterizerSpec(**{f: getattr(spec, f) for f in tsil.RasterizerSpec._fields})


def _full_problem(batch=1, seed=0):
    """Full-width synthetic body (6890 vertices, 13776 faces) at 224², the
    shipped fine geometry (tile 8, K 96, bin margin 8 px)."""
    model = smpl_mod.synthetic_smpl_model(seed=seed)
    rng = np.random.default_rng(seed)
    verts = model.v_template[None] + jnp.asarray(
        rng.normal(scale=0.01, size=(batch, model.num_verts, 3)).astype(np.float32)
    )
    cam_t = jnp.asarray(np.stack(
        [rng.uniform(-0.1, 0.1, batch), rng.uniform(-0.1, 0.1, batch), rng.uniform(36, 60, batch)],
        axis=-1,
    ).astype(np.float32))
    spec = sil.RasterizerSpec(image_size=224, tile_size=8, faces_per_tile=96, bin_margin_px=8.0)
    return model, verts, cam_t, spec


def _consts(spec):
    px_to_ndc2 = (2.0 / spec.image_size) ** 2
    return px_to_ndc2 / spec.sigma, (spec.blur_radius / px_to_ndc2 if spec.blur_radius > 0 else 0.0)


@pytest.mark.parametrize("size", ["small", "full"])
def test_compute_bins_equal_jax(size):
    model, verts, cam_t, spec = _problem(seed=2) if size == "small" else _full_problem()
    want = sil.compute_bins(verts, model.faces, cam_t, spec)
    got = tsil.compute_bins(_t(verts), _t(model.faces).long(), _t(cam_t), _tspec(spec))
    if size == "full":
        assert int(jnp.sum(want.sel_valid)) > 10_000  # a real body's worth of candidates
    for field in tsil.BinState._fields:
        np.testing.assert_array_equal(getattr(got, field).numpy(), np.asarray(getattr(want, field)),
                                      err_msg=field)


def test_slot_gather_backward_equals_index_backward():
    model, verts, cam_t, spec = _problem(seed=4)
    bins = tsil.compute_bins(_t(verts), _t(model.faces).long(), _t(cam_t), _tspec(spec))
    rng = np.random.default_rng(1)
    b, f = verts.shape[0], model.faces.shape[0]
    xy = torch.as_tensor(rng.normal(size=(b, f, 6)).astype(np.float32), dtype=torch.float32)
    # Invalid slots gather face 0 but carry no cotangent on the render path.
    g = torch.as_tensor(rng.normal(size=tuple(bins.sel_face.shape) + (6,)).astype(np.float32))
    g = g * bins.sel_valid[..., None]

    a = xy.clone().requires_grad_(True)
    out = tsil._slot_gather(a, bins.sel_face, bins.slot_of_pair)
    (got,) = torch.autograd.grad(torch.sum(out * g), [a])
    c = xy.clone().requires_grad_(True)
    ref = c[torch.arange(b)[:, None, None], bins.sel_face.long()]
    (want,) = torch.autograd.grad(torch.sum(ref * g), [c])
    np.testing.assert_array_equal(out.detach().numpy(), ref.detach().numpy())
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=1e-6)
    assert float(got.abs().sum()) > 0


def _packed(seed):
    """The packed tile inputs of a small problem (round-1 bins, 32 tiles)."""
    model, verts, cam_t, spec = _problem(seed=seed)
    bins = sil.compute_bins(verts, model.faces, cam_t, spec)
    vs = jax.vmap(lambda v, c: sil.camera_lib.project_points_screen(
        v[None], c[None], spec.image_size, spec.focal_length)[0])(verts, cam_t)
    xy, _ = jax.vmap(lambda v: sil._face_screen_verts(v, model.faces))(vs)
    sel_xy = jax.vmap(lambda x, s: x[s])(xy, bins.sel_face)
    tri, valid, _ = jax.vmap(sp.pack_tri)(sel_xy, bins.sel_valid)
    n = tri.shape[0] * tri.shape[1]
    flat = lambda x: x.reshape((n,) + x.shape[2:])  # noqa: E731
    return flat(bins.origin), flat(tri), flat(valid), spec, sel_xy, bins.sel_valid


@pytest.mark.parametrize("seed", [0, 3])
def test_plain_tiles_alpha_matches_interpret_kernel(seed):
    origin, tri, valid, spec, sel_xy, sel_valid = _packed(seed)
    inv_sigma, blur_px2 = _consts(spec)
    want = sp.tiles_alpha_pallas(origin, tri, valid, spec.tile_size, inv_sigma, blur_px2, 8, True)
    got = tsp.tiles_alpha(_t(origin), _t(tri), _t(valid), spec.tile_size, inv_sigma, blur_px2)
    assert float(jnp.max(want)) > 0.5
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    # The port's pack_tri lays out the same rows.
    ttri, tvalid, k_pad = tsp.pack_tri(_t(sel_xy), _t(sel_valid))
    assert k_pad == 128
    np.testing.assert_array_equal(ttri.reshape(tri.shape).numpy(), np.asarray(tri))
    np.testing.assert_array_equal(tvalid.reshape(valid.shape).numpy(), np.asarray(valid))


def _random_tiles(seed, n=8, tile=4, k=128):
    """Random triangles around each tile, ~10% of the lanes valid, so α
    stays off saturation. Seed 6 has no near-tie within the Pallas backward
    kernel's 1e-4 band (seeds 5, 7 and 8 do)."""
    rng = np.random.default_rng(seed)
    origin = rng.uniform(0, 16, size=(n, 2)).astype(np.float32)
    centre = origin[:, None, None, :] + tile / 2 + rng.normal(scale=4.0, size=(n, k, 1, 2))
    corners = centre + rng.normal(scale=1.5, size=(n, k, 3, 2))
    tri = corners.reshape(n, k, 6).transpose(0, 2, 1).astype(np.float32)
    valid = (rng.uniform(size=(n, 1, k)) < 0.1).astype(np.float32)
    g = rng.normal(size=(n, tile * tile)).astype(np.float32)
    return origin, tri, valid, g, tile


def test_plain_tiles_alpha_gradient_matches_jax():
    origin, tri, valid, g, tile = _random_tiles(seed=6)
    inv_sigma, blur_px2 = 0.8, 1.5

    def jloss(t, fn):
        return jnp.sum(fn(jnp.asarray(origin), t, jnp.asarray(valid)) * g)

    twin = lambda o, t, v: sil._tiles_alpha_xla(o, t, v, tile, inv_sigma, blur_px2)  # noqa: E731
    kern = lambda o, t, v: sp.tiles_alpha_pallas(o, t, v, tile, inv_sigma, blur_px2, 1, True)  # noqa: E731
    want_twin = np.asarray(jax.grad(jloss)(jnp.asarray(tri), twin))
    want_kern = np.asarray(jax.grad(jloss)(jnp.asarray(tri), kern))

    t = _t(tri).requires_grad_(True)
    alpha = tsp.tiles_alpha(_t(origin), t, _t(valid), tile, inv_sigma, blur_px2)
    (got,) = torch.autograd.grad(torch.sum(alpha * _t(g)), [t])
    scale = np.abs(want_twin).max()
    assert scale > 1e-3
    for want in (want_twin, want_kern):
        np.testing.assert_allclose(got.numpy(), want, atol=3e-4 * scale, rtol=2e-4)
    assert not got.numpy()[np.broadcast_to(valid == 0, tri.shape)].any()


@pytest.mark.parametrize("with_bins", [False, True])
def test_render_mesh_silhouette_matches_jax_and_dense(with_bins):
    model, verts, cam_t, spec = _problem(batch=3, seed=6)
    # Frame 1 sits behind the camera (every face culled); frame 2 is shifted
    # half off screen.
    cam_t = cam_t.at[1, 2].set(-20.0).at[2, 0].set(0.2)
    jspec = spec._replace(backend="pallas")
    bins = sil.compute_bins(verts, model.faces, cam_t, spec) if with_bins else None
    want = sil.render_mesh_silhouette(verts, model.faces, cam_t, jspec, bins=bins)
    dense = sil.render_mesh_silhouette(verts, model.faces, cam_t, spec, dense=True)

    faces = _t(model.faces).long()
    tbins = tsil.compute_bins(_t(verts), faces, _t(cam_t), _tspec(spec)) if with_bins else None
    got = tsil.render_mesh_silhouette(_t(verts), faces, _t(cam_t), _tspec(spec), bins=tbins)
    tdense = tsil.render_mesh_silhouette(_t(verts), faces, _t(cam_t), _tspec(spec), dense=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(dense), atol=1e-5)
    np.testing.assert_allclose(tdense.numpy(), np.asarray(dense), atol=1e-5)
    assert float(got[0].max()) > 0.5 and float(got[1].max()) == 0.0
    assert 0.0 < float(got[2].sum()) < float(got[0].sum())


def test_render_backend_xla_is_not_ported():
    model, verts, cam_t, spec = _problem(batch=1)
    with pytest.raises(NotImplementedError, match="xla"):
        tsil.render_mesh_silhouette(_t(verts), _t(model.faces).long(), _t(cam_t),
                                    _tspec(spec)._replace(backend="xla"))


def test_fused_tiles_alpha_gradient_matches_jax():
    """Row 3's plain version: the gradient of Σ w·silhouette_tiles_fused."""
    model, verts, cam_t, spec = _problem(seed=7)
    g2 = (spec.image_size // spec.tile_size) ** 2
    w = np.random.default_rng(2).uniform(-1, 1, size=(verts.shape[0], g2, 64)).astype(np.float32)
    jv, jg = jax.value_and_grad(
        lambda v: jnp.sum(sf.silhouette_tiles_fused(v, model, cam_t, spec) * w)
    )(verts)
    tm = convert.smpl_model(model, device="cpu")
    tv = _t(verts).requires_grad_(True)
    tval = torch.sum(tsf.silhouette_tiles_fused(tv, tm, _t(cam_t), _tspec(spec)) * _t(w))
    (tg,) = torch.autograd.grad(tval, [tv])
    np.testing.assert_allclose(float(tval.detach()), float(jv), rtol=1e-5)
    scale = np.abs(np.asarray(jg)).max()
    assert scale > 0
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=3e-4 * scale, rtol=2e-4)


def _pallas_problem(coarse: bool):
    model, j_reg, cfg, init, data, _ = make_golden.build_problem()
    sil_cfg = dataclasses.replace(cfg.silhouette, backend="pallas", rebin_interval=2)
    if coarse:
        sil_cfg = dataclasses.replace(sil_cfg, coarse_min_image=16)
    else:
        sil_cfg = dataclasses.replace(sil_cfg, coarse_frac=0.0)
    cfg = dataclasses.replace(cfg, stage_a_steps=10, stage_b_steps=8, silhouette=sil_cfg)
    return model, j_reg, cfg, init, data


@pytest.mark.parametrize("coarse", [False, True], ids=["c2f_off", "c2f_on"])
def test_refine_batch_pallas_matches_jax(coarse):
    model, j_reg, cfg, init, data = _pallas_problem(coarse)
    want = engine.refine_batch(model, j_reg, init, data, cfg)
    got = tengine.refine_batch(
        convert.smpl_model(model, device="cpu"), _t(j_reg), convert.frame_params(init, device="cpu"),
        convert.frame_batch(data, device="cpu"), convert.refiner_config(cfg),
    )
    for key in PARAMS:
        np.testing.assert_allclose(getattr(got.params, key).numpy(),
                                   np.asarray(getattr(want.params, key)), atol=5e-4, err_msg=key)
    np.testing.assert_allclose(got.stage_b_terms.total.numpy(), np.asarray(want.stage_b_terms.total),
                               atol=1e-4)
    assert got.bin_stats is None and want.bin_stats is None
    assert int((got.stage_b_terms.silhouette != 0).sum()) >= 3


def test_interior_skip_true_raises_on_round1_path():
    model, j_reg, cfg, init, data = _pallas_problem(False)
    cfg = dataclasses.replace(cfg, silhouette=dataclasses.replace(cfg.silhouette, interior_skip=True))
    with pytest.raises(ValueError, match="interior_skip=True"):
        tengine.refine_batch(
            convert.smpl_model(model, device="cpu"), _t(j_reg),
            convert.frame_params(init, device="cpu"), convert.frame_batch(data, device="cpu"),
            convert.refiner_config(cfg),
        )
    with pytest.raises(NotImplementedError, match="xla"):
        tlosses.resolve_silhouette_backend(tsil.RasterizerSpec(backend="xla"))


def test_problem_mask_is_the_round1_render_of_jax():
    """problem.py renders its mask as __graft_entry__ does: the JAX
    problem's own mask from its ground-truth vertices and camera."""
    import __graft_entry__ as ge

    model, _, cfg, _, data, params, verts = ge._synthetic_problem(
        batch=2, num_verts=96, image_size=32, return_gt=True
    )
    spec = tsil.RasterizerSpec(image_size=32, tile_size=8, faces_per_tile=64)
    got = tsil.render_mesh_silhouette(_t(verts), _t(model.faces).long(), _t(params.cam_t), spec)
    assert float(got.sum()) > 10.0
    np.testing.assert_allclose(got.numpy(), np.asarray(data.mask), atol=1e-5)


def test_fused_alpha_grad_limit_and_range_check():
    from jrr_tpu_torch import kernels
    from jrr_tpu_torch.config import SilhouetteConfig

    sil_cfg = SilhouetteConfig()
    f = sil_cfg.coarse_factor
    for size, tile in ((sil_cfg.image_size, sil_cfg.tile_size),
                       (sil_cfg.image_size // f, sil_cfg.tile_size // f)):
        inv_sigma = (2.0 / size) ** 2 / sil_cfg.sigma
        limit = kernels.grad_limit((size // tile) ** 2, tile, inv_sigma)
        assert limit > 50.0  # far above a loss's |dL/dα|
        assert kernels._fixed_point_bound((size // tile) ** 2, tile, inv_sigma, limit) <= 2.0**31
    kernels.check_grad_range(torch.tensor([0.5, -3.0]), 4.0)
    for bad in (5.0, float("nan")):
        with pytest.raises(RuntimeError, match="dL/dalpha"):
            kernels.check_grad_range(torch.tensor([0.5, bad]), 4.0)


def test_new_kernel_wrappers_refuse_cpu_tensors():
    from jrr_tpu_torch import kernels

    origin, tri, valid = torch.zeros(2, 2), torch.zeros(2, 6, 128), torch.zeros(2, 1, 128)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.tiles_alpha_fwd(origin, tri, valid, 8, 1.0, 0.0)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.tiles_alpha_bwd(origin, tri, valid, torch.zeros(2, 64), 8, 1.0, 0.0)
    z = torch.zeros(1, 8, 128)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.fused_alpha_bwd(
            z, z, torch.zeros(1, 1, 16, dtype=torch.int32),
            torch.zeros(1, 1, 3, 128, dtype=torch.int32), torch.zeros(1, 1, 2),
            torch.zeros(1, 1, 64), 8, 1.0, 0.0, 1,
        )
    assert kernels.tiles_alpha_fwd.launches == kernels.tiles_alpha_bwd.launches == 0
    assert kernels.fused_alpha_bwd.launches == 0
