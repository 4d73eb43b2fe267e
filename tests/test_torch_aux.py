"""The port's off-path modules against jrr_tpu on the CPU: the image
discriminator, the perturbation builders, linearized sampling and the viz
PNGs. jrr_tpu's own cases (tests/test_aux_components.py TestPerturbation,
TestViz, TestImageDiscriminator; tests/test_data.py's linearized cases) run
against the port, and each function is held to jrr_tpu's on the same
numpy-seeded inputs:

- image discriminator: jrr_tpu's params through
  `convert.image_discriminator_from_jax`, score and silhouette gradient
  within 1e-5, at sizes where XLA's "SAME" pads (0, 1) (even) and (1, 1)
  (odd);
- perturbation builders within 1e-6; the random draw from a
  `torch.Generator` is held by jrr_tpu's near-identity case;
- linearized sampling with jrr_tpu's `jax.random.normal` noise fed in:
  value within 1e-5 (equal to bilinear), grid and image gradients within
  1e-5 relative to their largest; on 256² frames, where jrr_tpu's float32
  ridge solve is ill-conditioned, the port's grid gradient within 2e-5 of
  the float64 solution of jrr_tpu's system;
- viz: the PNGs equal in pixels to jrr_tpu's for the same arrays, also
  from tensors.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jrr_tpu.data import perturbation as jpert
from jrr_tpu.models import image_discriminator as jimgd
from jrr_tpu.ops import sampling as jsampling
from jrr_tpu.utils import viz as jviz
from test_torch_spin import torch_threads
from jrr_tpu_torch import convert
from jrr_tpu_torch.data import perturbation
from jrr_tpu_torch.models import image_discriminator as imgd
from jrr_tpu_torch.ops import sampling
from jrr_tpu_torch.utils import viz


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Two torch threads: Tier-1 runs six test processes at once
    (tests/test_torch_spin.py's reason)."""
    with torch_threads():
        yield


def _t(x, grad=False):
    return torch.tensor(np.asarray(x), requires_grad=grad)


class TestPerturbation:
    def test_translation_mat(self):
        m = perturbation.translation_vec_to_mat(torch.tensor([[0.5, -0.2]])).numpy()[0]
        np.testing.assert_allclose(m, [[1, 0, 0.5], [0, 1, -0.2], [0, 0, 1]], atol=1e-6)

    def test_rotation_mat(self):
        theta = 0.3
        m = perturbation.rotation_vec_to_mat(torch.tensor([[theta, 0.0, 0.0]])).numpy()[0]
        c, s = np.cos(theta), np.sin(theta)
        np.testing.assert_allclose(m[:2, :2], [[c, -s], [s, c]], atol=1e-6)

    def test_random_perturbation_near_identity(self):
        gen = torch.Generator().manual_seed(0)
        mats = perturbation.gen_random_perturbation(16, 0.05, 0.05, 0.05, generator=gen,
                                                    device="cpu").numpy()
        assert mats.shape == (16, 3, 3)
        assert np.abs(mats - np.eye(3)).max() < 0.25
        again = perturbation.gen_random_perturbation(
            16, 0.05, 0.05, 0.05, generator=torch.Generator().manual_seed(0), device="cpu")
        np.testing.assert_array_equal(mats, again.numpy())

    @pytest.mark.parametrize("fn", ["translation_vec_to_mat", "rotation_vec_to_mat",
                                    "similarity_vec_to_mat"])
    def test_builders_match_jax(self, fn):
        width = {"translation_vec_to_mat": 2, "rotation_vec_to_mat": 3,
                 "similarity_vec_to_mat": 5}[fn]
        vec = np.random.default_rng(5).normal(scale=0.3, size=(8, width)).astype(np.float32)
        got = getattr(perturbation, fn)(_t(vec)).numpy()
        want = np.asarray(getattr(jpert, fn)(jnp.asarray(vec)))
        np.testing.assert_allclose(got, want, atol=1e-6)


class TestImageDiscriminator:
    def test_forward_and_grad(self):
        """jrr_tpu's case on the port's own module."""
        disc = imgd.init_image_discriminator(seed=0, device="cpu")
        img = torch.zeros((2, 3, 64, 64))
        sil = (torch.ones((2, 64, 64)) * 0.5).requires_grad_(True)
        out = imgd.image_discriminator(disc, img, sil)
        assert out.shape == (2,)
        assert bool(((out > 0) & (out < 1)).all())
        (g,) = torch.autograd.grad(torch.mean((out - 1.0) ** 2), [sil])
        assert bool(torch.isfinite(g).all()) and float(g.abs().sum()) > 0

    @pytest.mark.parametrize("size", [64, 45])
    def test_matches_jax(self, size):
        params = jimgd.init_image_discriminator(jax.random.PRNGKey(3))
        disc = convert.image_discriminator_from_jax(params, device="cpu")
        rng = np.random.default_rng(size)
        img = rng.uniform(size=(2, 3, size, size)).astype(np.float32)
        sil = rng.uniform(size=(2, size, size)).astype(np.float32)

        def jloss(s):
            return jnp.mean((jimgd.image_discriminator(params, jnp.asarray(img), s) - 1.0) ** 2)

        want = np.asarray(jimgd.image_discriminator(params, jnp.asarray(img), jnp.asarray(sil)))
        want_g = np.asarray(jax.grad(jloss)(jnp.asarray(sil)))
        s = _t(sil, grad=True)
        out = disc(_t(img), s)
        (g,) = torch.autograd.grad(torch.mean((out - 1.0) ** 2), [s])
        np.testing.assert_allclose(out.detach().numpy(), want, atol=1e-5)
        np.testing.assert_allclose(g.numpy(), want_g, atol=1e-5 * np.abs(want_g).max())

    def test_same_padding_is_xlas(self):
        assert imgd.same_padding(64, 3, 2) == (0, 1)
        assert imgd.same_padding(45, 3, 2) == (1, 1)
        assert imgd.same_padding(7, 1, 1) == (0, 0)


class TestLinearizedSampling:
    def test_value_equals_bilinear(self):
        rng = np.random.default_rng(2)
        img = _t(rng.uniform(size=(1, 2, 12, 12)).astype(np.float32))
        grid = _t(rng.uniform(-0.9, 0.9, size=(1, 5, 5, 2)).astype(np.float32))
        a = sampling.grid_sample(img, grid, mode="bilinear")
        b = sampling.grid_sample(img, grid, mode="linearized",
                                 generator=torch.Generator().manual_seed(0))
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)

    def test_gradient_finite_nonzero(self):
        rng = np.random.default_rng(3)
        img = _t(rng.uniform(size=(1, 1, 12, 12)).astype(np.float32))
        grid = _t(rng.uniform(-0.5, 0.5, size=(1, 4, 4, 2)).astype(np.float32), grad=True)
        out = sampling.grid_sample(img, grid, mode="linearized",
                                   generator=torch.Generator().manual_seed(1))
        (g,) = torch.autograd.grad(out.sum(), [grid])
        assert bool(torch.isfinite(g).all()) and float(g.abs().sum()) > 0

    @pytest.mark.parametrize("batch", [1, 3])
    def test_matches_jax_with_its_noise(self, batch):
        rng = np.random.default_rng(10 + batch)
        img = rng.uniform(size=(batch, 2, 12, 14)).astype(np.float32)
        grid = rng.uniform(-0.8, 0.8, size=(batch, 5, 6, 2)).astype(np.float32)
        w = rng.normal(size=(batch, 2, 5, 6)).astype(np.float32)
        key = jax.random.PRNGKey(7)
        # jrr_tpu's draw: one key per frame, (num_aux,) + grid.shape[1:] normals.
        noise = np.stack([np.asarray(jax.random.normal(k, (4, 5, 6, 2)))
                          for k in jax.random.split(key, batch)])

        def jloss(i, g):
            return jnp.sum(jsampling.grid_sample(i, g, mode="linearized", key=key) * w)

        jimg, jgrid = jnp.asarray(img), jnp.asarray(grid)
        want = np.asarray(jsampling.grid_sample(jimg, jgrid, mode="linearized", key=key))
        want_gi, want_gg = (np.asarray(x) for x in jax.grad(jloss, argnums=(0, 1))(jimg, jgrid))
        ti, tg = _t(img, grad=True), _t(grid, grad=True)
        out = sampling.linearized_sample(ti, tg, _t(noise))
        gi, gg = torch.autograd.grad((out * _t(w)).sum(), [ti, tg])
        np.testing.assert_allclose(out.detach().numpy(), want, atol=1e-5)
        np.testing.assert_allclose(gg.numpy(), want_gg, atol=1e-5 * np.abs(want_gg).max())
        np.testing.assert_allclose(gi.numpy(), want_gi, atol=1e-5 * np.abs(want_gi).max())

    def test_grid_gradient_on_large_frames_is_float64s(self):
        """On 256² frames jrr_tpu's ridge system has a condition number near
        1e4, which its float32 solve feels; the port forms and solves the
        same system in float64. Its grid gradient lies within 2e-5 of the
        float64 evaluation of jrr_tpu's system (relative to the largest
        entry; the float32 samples' own rounding is most of that), and
        within 1e-5 of jrr_tpu's float32 gradient's distance from it."""
        rng = np.random.default_rng(0)
        b, h, o = 2, 256, 32
        img = rng.uniform(size=(b, 3, h, h)).astype(np.float32)
        grid = rng.uniform(-0.9, 0.9, size=(b, o, o, 2)).astype(np.float32)
        w = rng.normal(size=(b, 3, o, o)).astype(np.float32)
        key = jax.random.PRNGKey(3)
        noise = np.stack([np.asarray(jax.random.normal(k, (4, o, o, 2)))
                          for k in jax.random.split(key, b)])
        g = _t(grid, grad=True)
        out = sampling.linearized_sample(_t(img), g, _t(noise))
        (got,) = torch.autograd.grad((out * _t(w)).sum(), [g])
        # jrr_tpu's system in grid units, in float64.
        off = torch.as_tensor(np.concatenate([np.zeros_like(noise[:, :1]), noise * (2.0 / h)], 1),
                              dtype=torch.float64)
        samples = sampling._bilinear(
            torch.as_tensor(img, dtype=torch.float64).repeat_interleave(5, 0),
            (torch.as_tensor(grid, dtype=torch.float64)[:, None] + off).reshape(b * 5, o, o, 2),
        ).reshape(b, 5, 3, o, o)
        x = torch.cat([off, torch.ones_like(off[..., :1])], -1)
        jac = torch.linalg.solve(
            torch.einsum("bahwi,bahwj->bhwij", x, x) + 1e-6 * torch.eye(3, dtype=torch.float64),
            torch.einsum("bahwi,bachw->bhwic", x, samples))[..., :2, :]
        want = torch.einsum("bhwdc,bchw->bhwd", jac, torch.as_tensor(w, dtype=torch.float64)).numpy()
        jgot = np.asarray(jax.grad(lambda q: jnp.sum(jsampling.grid_sample(
            jnp.asarray(img), q, mode="linearized", key=key) * w))(jnp.asarray(grid)))
        top = np.abs(want).max()
        err, jerr = np.abs(got.numpy() - want).max() / top, np.abs(jgot - want).max() / top
        assert err <= 2e-5, err
        assert err <= jerr + 1e-5, (err, jerr)

    def test_warp_image_linearized(self):
        rng = np.random.default_rng(4)
        img = _t(rng.uniform(size=(2, 3, 16, 16)).astype(np.float32))
        h = _t(np.eye(3, dtype=np.float32)[None].repeat(2, 0) + rng.normal(
            scale=0.02, size=(2, 3, 3)).astype(np.float32))
        a = sampling.warp_image(img, h, (8, 8))
        b = sampling.warp_image(img, h, (8, 8), mode="linearized",
                                generator=torch.Generator().manual_seed(2))
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)
        with pytest.raises(ValueError, match="unknown sampling mode"):
            sampling.grid_sample(img, torch.zeros(2, 4, 4, 2), mode="nearest")


def _png_pixels(path):
    import matplotlib.image

    return matplotlib.image.imread(path)


def _same_pngs(dir_a, dir_b, names):
    for name in names:
        a, b = _png_pixels(os.path.join(dir_a, name)), _png_pixels(os.path.join(dir_b, name))
        assert a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)


class TestViz:
    def test_silhouette_comparison(self, tmp_path):
        pytest.importorskip("matplotlib")
        render = np.random.default_rng(0).random((2, 32, 32)).astype(np.float32)
        mask = np.random.default_rng(1).random((2, 32, 32)).astype(np.float32)
        j2d = np.random.default_rng(2).uniform(0, 32, size=(2, 17, 2))
        viz.save_silhouette_comparison(torch.as_tensor(render), torch.as_tensor(mask),
                                       str(tmp_path / "port"), joints_2d=torch.as_tensor(j2d))
        jviz.save_silhouette_comparison(render, mask, str(tmp_path / "jax"), joints_2d=j2d)
        assert os.path.exists(tmp_path / "port" / "000_silhouette.png")
        _same_pngs(tmp_path / "port", tmp_path / "jax", ["000_silhouette.png", "001_silhouette.png"])

    def test_joints_overlay_and_pointcloud(self, tmp_path):
        pytest.importorskip("matplotlib")
        img = np.random.default_rng(5).random((1, 3, 32, 32)).astype(np.float32)
        js = np.random.default_rng(3).uniform(0, 32, size=(1, 17, 2))
        pts = np.random.default_rng(4).normal(size=(100, 3))
        for pkg, out in ((viz, "port"), (jviz, "jax")):
            conv = torch.as_tensor if pkg is viz else np.asarray
            pkg.save_joints_overlay(conv(img), [conv(js)], str(tmp_path / out))
            pkg.save_pointcloud(conv(pts), str(tmp_path / out / "pc.png"), gt_points=conv(pts[:5]))
        assert os.path.exists(tmp_path / "port" / "000_joints.png")
        _same_pngs(tmp_path / "port", tmp_path / "jax", ["000_joints.png", "pc.png"])
