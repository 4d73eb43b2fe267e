"""The port's fused rasterizer against jrr_tpu on the CPU: bins equal exactly,
plain α against the interpret-mode Pallas forward kernel (atol 1e-5), plain
loss+grad against the interpret-mode loss+grad kernel (the JAX kernel test's
criterion), the high-level loss entry with the interior skip, and the loss
kernel's cull (`coverage.near_box`) against JAX's coverage: every pair with
p > 0 lies in its face's pixel box."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jrr_tpu.render import camera as camera_lib
from jrr_tpu.render import silhouette_fused as sf
from jrr_tpu.render import silhouette_pallas as sp
from jrr_tpu_torch import convert
from jrr_tpu_torch.render import coverage
from jrr_tpu_torch.render import silhouette as tsil
from jrr_tpu_torch.render import silhouette_fused as tsf
from test_interior_skip import _problem as _blob_problem
from test_silhouette_fused import _problem


def _t(x):
    return torch.as_tensor(np.array(x))


def _port(model, verts, cam_t, spec):
    tspec = tsil.RasterizerSpec(**{f: getattr(spec, f) for f in tsil.RasterizerSpec._fields})
    return convert.smpl_model(model, device="cpu"), _t(verts), _t(cam_t), tspec


def _tables(model, verts, cam_t, spec):
    verts_screen = camera_lib.project_points_screen(
        verts, cam_t, spec.image_size, spec.focal_length
    )
    tx, ty = sf.build_tables(verts_screen, model.vertex_perm)
    px_to_ndc2 = (2.0 / spec.image_size) ** 2
    return tx, ty, px_to_ndc2 / spec.sigma, spec.blur_radius / px_to_ndc2


@pytest.mark.parametrize(
    "num_verts,spec_kw",
    [(96, {}), (96, {"faces_per_tile": 1}), (1024, {"pages_per_tile": 2}),
     (1024, {"max_tiles_per_face": 1, "pages_per_tile": 8}),
     (96, {"bin_margin_px": 4.0})],
    ids=["healthy", "truncating", "page_overflow", "span_clipped", "margin"],
)
def test_bins_equal_jax(num_verts, spec_kw):
    model, verts, cam_t, spec = _problem(num_verts=num_verts, seed=1)
    spec = spec._replace(**spec_kw)
    want = sf.compute_fused_bins(verts, model, cam_t, spec)
    tm, tv, tc, tspec = _port(model, verts, cam_t, spec)
    got = tsf.compute_fused_bins(tv, tm, tc, tspec)
    for field in ("origin", "pages", "idx", "core_count"):
        np.testing.assert_array_equal(getattr(got, field).numpy(), np.asarray(getattr(want, field)))
    for name, a, b in zip(sf.BinStats._fields, got.stats, want.stats):
        assert int(a) == int(b), name
    # tables too
    tx, ty, _, _ = _tables(model, verts, cam_t, spec)
    ttx, tty = tsf.build_tables(
        tsf.camera_lib.project_points_screen(tv, tc, tspec.image_size, tspec.focal_length),
        tm.vertex_perm,
    )
    np.testing.assert_allclose(ttx.numpy(), np.asarray(tx), rtol=1e-6, atol=1e-4)
    np.testing.assert_allclose(tty.numpy(), np.asarray(ty), rtol=1e-6, atol=1e-4)


def test_interior_skip_equal_jax():
    # A dense blob whose interior tiles saturate at α≡1.
    model, verts, cam_t, spec = _blob_problem()
    bins = sf.compute_fused_bins(verts, model, cam_t, spec)
    want = sf.apply_interior_skip(bins, verts, model, cam_t, spec)
    tm, tv, tc, tspec = _port(model, verts, cam_t, spec)
    got = tsf.apply_interior_skip(tsf.compute_fused_bins(tv, tm, tc, tspec), tv, tm, tc, tspec)
    assert int(want.stats.interior_skipped_tiles) > 0
    assert bool(jnp.any(want.sat_tiles))
    for field in ("pages", "idx", "sat_tiles"):
        np.testing.assert_array_equal(getattr(got, field).numpy(), np.asarray(getattr(want, field)))
    assert int(got.stats.interior_skipped_tiles) == int(want.stats.interior_skipped_tiles)


@pytest.mark.parametrize("seed", [0, 3])
def test_plain_alpha_matches_interpret_kernel(seed):
    model, verts, cam_t, spec = _problem(seed=seed)
    bins = sf.compute_fused_bins(verts, model, cam_t, spec)
    tx, ty, inv_sigma, blur_px2 = _tables(model, verts, cam_t, spec)
    want = sf.fused_tiles_alpha(
        tx, ty, bins.pages, bins.idx, bins.origin, spec.tile_size, inv_sigma, blur_px2,
        sf.dump_page_id(96), 8, True,
    )
    got = tsf.fused_tiles_alpha(
        _t(tx), _t(ty), _t(bins.pages), _t(bins.idx), _t(bins.origin),
        spec.tile_size, inv_sigma, blur_px2, sf.dump_page_id(96),
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def _lossgrad_inputs(seed=4):
    model, verts, cam_t, spec = _problem(seed=seed)
    bins = sf.compute_fused_bins(verts, model, cam_t, spec)
    tx, ty, inv_sigma, blur_px2 = _tables(model, verts, cam_t, spec)
    mask = jnp.asarray(
        np.random.default_rng(9).uniform(
            0, 1, size=(tx.shape[0], bins.pages.shape[1], spec.tile_size**2)
        ).astype(np.float32)
    )
    return tx, ty, bins, spec, inv_sigma, blur_px2, mask


def test_plain_lossgrad_matches_interpret_kernel():
    tx, ty, bins, spec, inv_sigma, blur_px2, mask = _lossgrad_inputs()
    # chunk=1: the kernel's result does not depend on it; interpret mode
    # traces 8x less code than at chunk 8.
    err, dtx, dty = sf._fused_lossgrad_impl(
        tx, ty, bins.pages, bins.idx, bins.origin, mask, spec.tile_size, inv_sigma, blur_px2,
        sf.dump_page_id(96), 1, True,
    )
    got = tsf.fused_lossgrad_plain(
        _t(tx), _t(ty), _t(bins.pages), _t(bins.idx), _t(bins.origin), _t(mask),
        spec.tile_size, inv_sigma, blur_px2,
    )
    np.testing.assert_allclose(got[0].numpy(), np.asarray(err), rtol=1e-5)
    for a, b in zip(got[1:], (dtx, dty)):
        scale = np.abs(np.asarray(b)).max() + 1e-12
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=3e-4 * scale, rtol=2e-4)


def test_plain_lossgrad_all_empty_tiles():
    """All tiles empty (every page the dump page, binning's dump idx
    pattern): α≡0, so err is Σmask² per frame and the gradient is zero."""
    tx, ty, bins, spec, inv_sigma, blur_px2, mask = _lossgrad_inputs(seed=6)
    dump = sf.dump_page_id(96)
    pages = torch.full(tuple(bins.pages.shape), dump, dtype=torch.int32)
    corner = torch.arange(3, dtype=torch.int32).reshape(1, 1, 3, 1)
    idx = ((pages.shape[2] - 1) * 128 + corner).expand(tuple(bins.idx.shape)).contiguous()
    err, dtx, dty = tsf.fused_lossgrad_plain(
        _t(tx), _t(ty), pages, idx, _t(bins.origin), _t(mask), spec.tile_size, inv_sigma, blur_px2,
    )
    np.testing.assert_allclose(err.numpy(), np.sum(np.asarray(mask) ** 2, axis=(-1, -2)), rtol=1e-5)
    assert not dtx.any() and not dty.any()


def test_corner_row_grads_match_autograd():
    """The hand-derived backward the CUDA loss kernel runs equals autograd of
    the plain α (criterion of the JAX kernel tests: tie splits differ)."""
    rng = np.random.default_rng(5)
    n, tile, k = 6, 4, 16
    centre = rng.uniform(2, 10, size=(n, 1, 1, 2))
    tri = torch.as_tensor((centre + rng.normal(scale=3.0, size=(n, 3, k, 2))).astype(np.float32))
    rows = [tri[:, c, :, j] for c in range(3) for j in range(2)]  # ax ay bx by cx cy (n, k)
    origin = torch.as_tensor(rng.uniform(0, 8, size=(n, 2)).astype(np.float32))
    g = torch.as_tensor(rng.normal(size=(n, tile * tile)).astype(np.float32))
    inv_sigma, blur_px2 = 2.0, 1.5

    leaf = [r.clone().requires_grad_(True) for r in rows]
    alpha = tsil._tiles_alpha_xla(
        origin, torch.stack(leaf, dim=1), torch.ones(n, 1, k), tile, inv_sigma, blur_px2
    )
    want = torch.autograd.grad(torch.sum(alpha * g), leaf)

    i = torch.arange(tile * tile)
    px_x = origin[:, 0:1, None] + (i % tile).float()[None, :, None]
    px_y = origin[:, 1:2, None] + (i // tile).float()[None, :, None]
    p, _, dmin, inside, edges = coverage.coverage_rows(
        px_x, px_y, tuple(r[:, None, :] for r in rows), inv_sigma=inv_sigma, blur_px2=blur_px2
    )
    got = coverage.corner_row_grads(g[..., None], p, dmin, inside, edges, inv_sigma=inv_sigma)
    for a, b in zip(got, want):
        scale = float(b.abs().max()) + 1e-12
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=3e-4 * scale, rtol=2e-4)


def test_corner_row_grads_near_tie_against_jax_band():
    """Where the port's routing departs from the Pallas kernels'. Lane 0:
    a pixel inside a triangle whose edges AB and CA lie 6e-4 apart in d²
    (within JAX's band 1e-4·(1+dmin), not equal). The port, like autograd,
    routes the whole min-distance gradient to AB; JAX splits it evenly over
    AB and CA. Lane 1: no near-tie, where both agree."""
    from jrr_tpu.render import silhouette_pallas as sp

    # Corners (ax, ay, bx, by, cx, cy) per lane; one pixel at (3, 3).
    tri = np.array([[0.0, 1e-4, 20.0, 1e-4, 0.0, 20.0],
                    [1.0, 0.5, 7.0, 1.5, 2.5, 8.0]], np.float32).T  # (6, K)
    inv_sigma, blur_px2 = 0.1, 50.0
    g = np.array([[0.7]], np.float32)

    jp, _, jdmin, jinside, jedges = sp._coverage_rows(
        jnp.full((1, 2), 3.0), jnp.full((1, 2), 3.0), tuple(jnp.asarray(tri[i:i + 1]) for i in range(6)),
        inv_sigma=inv_sigma, blur_px2=blur_px2,
    )
    band = [np.asarray(r)[0] for r in sp._corner_row_grads(
        jnp.asarray(g), jp, jdmin, jinside, jedges, inv_sigma=inv_sigma, k_pad=2
    )]
    rows = [torch.as_tensor(tri[i:i + 1]) for i in range(6)]
    px = torch.full((1, 2), 3.0)
    p, _, dmin, inside, edges = coverage.coverage_rows(px, px, rows, inv_sigma=inv_sigma, blur_px2=blur_px2)
    assert 0.0 < float(p[0, 0]) < 1.0 and bool(inside[0, 0])
    exact = [r.numpy() for r in coverage.corner_row_grads(torch.as_tensor(g), p, dmin, inside, edges,
                                                             inv_sigma=inv_sigma)]

    leaf = [torch.as_tensor(tri[i]).clone().requires_grad_(True) for i in range(6)]
    alpha = tsil._tiles_alpha_xla(torch.full((1, 2), 3.0), torch.stack(leaf)[None], torch.ones(1, 1, 2),
                                  1, inv_sigma, blur_px2)
    want = [t.numpy() for t in torch.autograd.grad(torch.sum(alpha * float(g[0, 0])), leaf)]

    ax, ay, bx, by, cx, cy = range(6)
    for i in range(6):  # the port is autograd's routing on both lanes
        np.testing.assert_allclose(exact[i], want[i], rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(exact[i][1], band[i][1], rtol=1e-5, atol=1e-7)
    # Lane 0: the port gives edge AB all of it (B twice JAX's half), edge CA none (C zero).
    for i in (bx, by):
        np.testing.assert_allclose(exact[i][0], 2.0 * band[i][0], rtol=1e-5)
    assert abs(band[by][0]) > 1e-3
    for i in (cx, cy):
        assert exact[i][0] == 0.0
    assert abs(band[cx][0]) > 1e-3


def test_sq_err_entry_with_sat_tiles_matches_jax():
    model, verts, cam_t, spec = _blob_problem(seed=1)
    bins = sf.apply_interior_skip(
        sf.compute_fused_bins(verts, model, cam_t, spec), verts, model, cam_t, spec
    )
    assert bool(jnp.any(bins.sat_tiles))
    g2 = bins.pages.shape[1]
    mask = jnp.asarray(
        np.random.default_rng(13).uniform(0, 1, size=(verts.shape[0], g2, 64)).astype(np.float32)
    )
    w = np.random.default_rng(3).uniform(0.5, 1.5, size=(verts.shape[0],)).astype(np.float32)

    def jloss(v):
        return jnp.sum(sf.silhouette_sq_err_fused(v, model, cam_t, mask, spec, bins=bins) * w)

    jv, jg = jax.value_and_grad(jloss)(verts)

    tm, tv, tc, tspec = _port(model, verts, cam_t, spec)
    tbins = tsf.apply_interior_skip(tsf.compute_fused_bins(tv, tm, tc, tspec), tv, tm, tc, tspec)
    tv = tv.clone().requires_grad_(True)
    tval = torch.sum(tsf.silhouette_sq_err_fused(tv, tm, tc, _t(mask), tspec, bins=tbins) * _t(w))
    (tg,) = torch.autograd.grad(tval, [tv])
    np.testing.assert_allclose(float(tval.detach()), float(jv), rtol=1e-5)
    scale = np.abs(np.asarray(jg)).max()
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=3e-4 * scale, rtol=2e-4)


def test_tile_roundtrip():
    img = torch.as_tensor(np.random.default_rng(0).normal(size=(3, 32, 32)).astype(np.float32))
    back = tsf.tiles_to_image(tsf.image_to_tiles(img, 8), 32, 8)
    np.testing.assert_array_equal(back.numpy(), img.numpy())
    want = sf.image_to_tiles(jnp.asarray(img.numpy()), 8)
    np.testing.assert_array_equal(tsf.image_to_tiles(img, 8).numpy(), np.asarray(want))


def test_fixed_point_range_covers_shipped_geometries():
    """The loss kernel's int64 fixed-point gradient sums (scale 2^32) cannot
    overflow at the shipped fine (224²/tile 8) and coarse (112²/tile 4)
    geometries."""
    from jrr_tpu_torch import kernels
    from jrr_tpu_torch.config import SilhouetteConfig

    sil = SilhouetteConfig()
    f = sil.coarse_factor
    for size, tile in ((sil.image_size, sil.tile_size), (sil.image_size // f, sil.tile_size // f)):
        inv_sigma = (2.0 / size) ** 2 / sil.sigma
        assert kernels._fixed_point_bound((size // tile) ** 2, tile, inv_sigma) < 2.0**31


def test_kernel_wrappers_refuse_cpu_tensors():
    from jrr_tpu_torch import kernels

    z = torch.zeros(1, 8, 128)
    pages = torch.zeros(1, 1, 16, dtype=torch.int32)
    idx = torch.zeros(1, 1, 3, 128, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.fused_alpha_fwd(z, z, pages, idx, torch.zeros(1, 1, 2), 8, 1.0, 0.0, 1)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.fused_lossgrad_packed(
            z, z, pages, idx, torch.zeros(1, 1, 2), torch.zeros(1, 1, 2),
            torch.zeros(1, 1, dtype=torch.int32), torch.zeros(1, 1, dtype=torch.int32),
            torch.zeros(1, 1, 64), 8, 1.0, 0.0, 1,
        )
    i8 = torch.zeros(1, 8, dtype=torch.int32)
    block = torch.zeros(1, 8, 128, dtype=torch.int32)
    table = torch.zeros(56, 128)
    for call in (
        lambda: kernels.paged_gather_rmw(i8, block, table),
        lambda: kernels.take_along_axis(z, block, 2),
        lambda: kernels.dyn_slice(i8, table),
        lambda: kernels.onehot_gather(z, block),
        lambda: kernels.select_reduce(z, block),
        lambda: kernels.rmw_rows(i8, z, 56),
        lambda: kernels.elementwise_baseline(z),
        lambda: kernels.fma_chain_f32(z, 2),
        lambda: kernels.fma_chain_bf16(z, 2),
    ):
        with pytest.raises(ValueError, match="CUDA"):
            call()
    assert all(w.launches == 0 for w in kernels.WRAPPERS)


# ---------------------------------------------------------------------------
# The CUDA loss kernel visits only the (pixel, lane) pairs in the face's
# pixel box; coverage.near_box is its test in torch. A pair with p > 0
# outside the box would lose its share of α and its gradient.
# ---------------------------------------------------------------------------


def _tile_grid(origin, tile):
    """Pixel coordinates (N, T², 1) of tiles at origin (N, 2), as the kernels
    place them (origin + column, origin + row)."""
    i = torch.arange(tile * tile)
    px_x = origin[:, 0:1, None] + (i % tile).float()[None, :, None]
    px_y = origin[:, 1:2, None] + (i // tile).float()[None, :, None]
    return px_x, px_y


def _covered_and_near(tri, origin, tile, inv_sigma, blur_px2):
    """(p > 0 by JAX's coverage, near_box) for tiles tri (N, 6, K) at origin
    (N, 2): two (N, T², K) bool tensors."""
    px_x, px_y = _tile_grid(origin, tile)
    rows = tuple(tri[:, j, None, :] for j in range(6))
    p = sp._coverage_rows(jnp.asarray(px_x.numpy()), jnp.asarray(px_y.numpy()),
                          tuple(jnp.asarray(r.numpy()) for r in rows),
                          inv_sigma=inv_sigma, blur_px2=blur_px2)[0]
    near = coverage.near_box(px_x, px_y, rows, blur_px2=blur_px2)
    return torch.as_tensor(np.asarray(p) > 0), near


@pytest.fixture(scope="module")
def full_width_inputs():
    """The kernel inputs of the full-width synthetic problem at batch 2 at
    the first rebin of each c2f phase (fused bins after the interior skip),
    as chip_smoke.py builds them at batch 256."""
    import chip_smoke
    from jrr_tpu_torch import problem

    prob = problem.synthetic_problem(batch=2, seed=0, device="cpu")
    return {g: chip_smoke._kernel_inputs(prob, g) for g in ("fine", "coarse")}


@pytest.mark.parametrize("geometry", ["fine", "coarse"])
def test_near_box_holds_every_pair_jax_covers(full_width_inputs, geometry):
    """At 224²/tile 8 and 112²/tile 4: every (pixel, lane) of an occupied
    tile with p > 0 in JAX's coverage lies in the lane's pixel box, and the
    box keeps a small share of the pairs (the cull does cut)."""
    x = full_width_inputs[geometry]
    occupied = x["pages"][:, :, 0] != x["dump"]
    tri = tsf._gather_tri(x["tx"], x["ty"], x["pages"], x["idx"])[occupied]
    covered, near = _covered_and_near(tri, x["origin"][occupied], x["tile"], x["inv_sigma"],
                                      x["blur_px2"])
    assert int(covered.sum()) > 10000
    assert not bool((covered & ~near).any())
    assert float(near.float().mean()) < 0.15


@pytest.mark.parametrize("geometry", ["fine", "coarse"])
def test_pair_counts_order_active_near_pairs(full_width_inputs, geometry):
    """chip_smoke's bound counts: pairs with 0 < p < 1 ≤ pairs in the box ≤
    all real-lane pairs."""
    import chip_smoke

    pairs, near, active, occupied = chip_smoke._pair_counts(full_width_inputs[geometry])
    assert 0 < active <= near < pairs and occupied > 0


_BOX_R = 1.25  # blur radius of the constructed cases: √blur_px2 exactly
_BOX_CASES = {
    # Vertex B = (9.75, 4.5) is the face's rightmost point and C = (8, 6.25)
    # its lowest: pixels (11, 4.5) and (8, 7.5) lie exactly √blur_px2 from
    # the face along an axis (d² == blur_px2 in float32, so p > 0).
    "axis_distance": ([[8.0, 4.0, 9.75, 4.5, 8.0, 6.25]], (0.0, 0.5), 16),
    # A point face (inside everywhere: every cross product is 0) and a
    # collinear one on pixel row y = 3.5 (inside along the whole row).
    "zero_area": ([[5.3, 7.7, 5.3, 7.7, 5.3, 7.7], [2.0, 3.5, 5.0, 3.5, 8.0, 3.5]], (0.0, 0.5), 16),
    # A face across the left border of the tile at (8, 8).
    "tile_border": ([[6.5, 9.0, 9.5, 9.25, 7.0, 11.0]], (8.0, 8.0), 8),
    # The bins' far-off-screen dump triangle (render/silhouette_fused.py).
    "dump": ([[0.0, -1.0e6, 8.0, -1.0e6, 0.0, -1.0e6 + 8.0]], (216.0, 216.0), 8),
}


@pytest.mark.parametrize("case", sorted(_BOX_CASES))
def test_near_box_constructed_cases(case):
    faces, origin, tile = _BOX_CASES[case]
    tri = torch.tensor(faces, dtype=torch.float32).T[None]  # (1, 6, K)
    org = torch.tensor([origin], dtype=torch.float32)
    covered, near = _covered_and_near(tri, org, tile, 2.0, _BOX_R**2)
    covered, near = covered[0], near[0]  # (T², K)
    assert not bool((covered & ~near).any())

    def pixel(x, y):
        return int(round(y - origin[1])) * tile + int(round(x - origin[0]))

    if case == "axis_distance":
        for x, y in ((11.0, 4.5), (8.0, 7.5)):
            assert covered[pixel(x, y), 0] and near[pixel(x, y), 0]
        for x, y in ((12.0, 4.5), (8.0, 8.5)):  # 2.25 px away: outside both
            assert not covered[pixel(x, y), 0] and not near[pixel(x, y), 0]
    elif case == "zero_area":
        assert bool(covered[:, 0].all())  # the point face covers the whole tile
        assert covered[pixel(15.0, 3.5), 1]  # 7 px past the segment's end
        assert bool(near.all())
    elif case == "tile_border":
        cols = near[:, 0].reshape(tile, tile).any(dim=0)
        rows = near[:, 0].reshape(tile, tile).any(dim=1)
        assert cols.tolist() == [True] * 3 + [False] * 5  # x = 8, 9, 10 ≤ 9.5 + 1.25
        assert rows.tolist() == [True] * 5 + [False] * 3  # y = 8 .. 12 ≤ 11 + 1.25
        assert bool(covered.any())
    else:
        assert not bool(near.any()) and not bool(covered.any())
