"""The port's outer training step, regressor fit and pose metrics against
jrr_tpu on the CPU. `outer_step` starts from a JAX state one step in (Adam
moments live), carried across by `convert.train_state`: new regressor,
discriminator params and Adam moments within 1e-5 relative (in norm, per
tensor), every
`OuterMetrics` field within 1e-3 (mm fields) or 1e-5 (losses), refined
params within 5e-4. Train-state files move both ways: a jrr_tpu npz
restores in the port equal to its arrays and steps on as jrr_tpu's state
does; a port-written file restores in jrr_tpu equal to the port's state."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jrr_tpu.evals import metrics
from jrr_tpu.ops import procrustes
from jrr_tpu.refine import trainer
from jrr_tpu.utils import checkpoint as jckpt
from jrr_tpu_torch import convert
from jrr_tpu_torch.evals import metrics as tmetrics
from jrr_tpu_torch.ops import procrustes as tprocrustes
from jrr_tpu_torch.refine import trainer as ttrainer
from jrr_tpu_torch.utils import checkpoint as tckpt
from test_torch_spin import torch_threads
from test_trainer import _setup

PARAMS = ("pose6d", "orient6d", "betas", "cam_t")


def _t(x):
    return torch.as_tensor(np.array(x))


def _close_rel(got, want, rel=1e-5, err_msg=""):
    """‖got − want‖ ≤ rel·‖want‖ over the whole tensor. (Elementwise, an
    Adam step moves an entry whose gradient is ~0 by up to ±lr on a
    last-bit difference of that gradient: m̂/√v̂ is of order 1 either way.)"""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, err_msg
    err = np.linalg.norm(got - want)
    assert err <= rel * np.linalg.norm(want), (err_msg, err, np.linalg.norm(want))


def _pose_tree(disc):
    """Port pose-discriminator parameters as the JAX param dict's layout."""
    return {
        "w1": disc.conv1.weight.T, "b1": disc.conv1.bias, "w2": disc.conv2.weight.T,
        "b2": disc.conv2.bias, "wj": disc.joint_w, "bj": disc.joint_b,
        "wg1": disc.fc1.weight.T, "bg1": disc.fc1.bias, "wg2": disc.fc2.weight.T,
        "bg2": disc.fc2.bias, "wg3": disc.fc3.weight.T, "bg3": disc.fc3.bias,
    }


def _shape_tree(disc):
    return {f"{p}{i}": (layer.weight.T if p == "w" else layer.bias)
            for i, layer in enumerate((disc.fc1, disc.fc2, disc.fc3), start=1) for p in "wb"}


def _moments_tree(opt, disc, tree_of):
    """The port's Adam moments as JAX-layout dicts (mu, nu)."""
    names = [n for n, _ in disc.named_parameters()]
    out = []
    for moments in (opt.m, opt.v):
        by_name = dict(zip(names, moments))
        shadow = type(disc)(device="cpu")
        with torch.no_grad():
            for name, p in shadow.named_parameters():
                p.copy_(by_name[name])
        out.append({k: v.detach().numpy() for k, v in tree_of(shadow).items()})
    return out


@pytest.fixture(scope="module")
def outer_inputs():
    return _setup()


@pytest.fixture(scope="module")
def outer_pair(outer_inputs):
    model, j_reg, gt, init, data, cfg = outer_inputs
    j_reg0 = j_reg + 0.05 * jnp.abs(jax.random.normal(jax.random.PRNGKey(9), j_reg.shape))
    state0 = trainer.init_train_state(jax.random.PRNGKey(0), j_reg0, cfg)
    # Jitted as jrr_tpu's run_optimize runs it: one compile for both steps.
    step = jax.jit(lambda s, m, i, d: trainer.outer_step(s, m, i, d, cfg))
    state1, _, _ = step(state0, model, init, data)
    want_state, want_m, want_res = step(state1, model, init, data)

    tcfg = convert.pipeline_config(cfg)
    tstate1 = convert.train_state(state1, tcfg, device="cpu")
    got_state, got_m, got_res = ttrainer.outer_step(
        tstate1, convert.smpl_model(model, device="cpu"), convert.frame_params(init, device="cpu"),
        convert.frame_batch(data, device="cpu"), tcfg,
    )
    return (state1, tstate1), (want_state, want_m, want_res), (got_state, got_m, got_res)


def test_train_state_converts_exactly(outer_pair):
    (state1, tstate1), _, _ = outer_pair
    np.testing.assert_array_equal(tstate1.j_reg_raw.numpy(), np.asarray(state1.j_reg_raw))
    assert tstate1.step == 1 and tstate1.jreg_opt.count == 1
    for key, value in _pose_tree(tstate1.pose_disc).items():
        np.testing.assert_array_equal(value.detach().numpy(), np.asarray(state1.pose_disc[key]))
    mu, nu = _moments_tree(tstate1.pose_disc_opt, tstate1.pose_disc, _pose_tree)
    for key in mu:
        np.testing.assert_array_equal(mu[key], np.asarray(state1.pose_disc_opt[0].mu[key]))
        np.testing.assert_array_equal(nu[key], np.asarray(state1.pose_disc_opt[0].nu[key]))


def test_outer_step_state_matches_jax(outer_pair):
    _, (want, _, _), (got, _, _) = outer_pair
    assert got.step == int(want.step) == 2
    _close_rel(got.j_reg_raw.numpy(), want.j_reg_raw, err_msg="j_reg_raw")
    _close_rel(got.jreg_opt.m[0].numpy(), want.jreg_opt[0].mu, err_msg="jreg mu")
    _close_rel(got.jreg_opt.v[0].numpy(), want.jreg_opt[0].nu, err_msg="jreg nu")
    assert got.jreg_opt.count == int(want.jreg_opt[0].count) == 2
    for name, disc, opt, tree_of, jparams, jopt in (
        ("pose", got.pose_disc, got.pose_disc_opt, _pose_tree, want.pose_disc, want.pose_disc_opt),
        ("shape", got.shape_disc, got.shape_disc_opt, _shape_tree, want.shape_disc,
         want.shape_disc_opt),
    ):
        for key, value in tree_of(disc).items():
            _close_rel(value.detach().numpy(), jparams[key], err_msg=f"{name} {key}")
        mu, nu = _moments_tree(opt, disc, tree_of)
        for key in mu:
            _close_rel(mu[key], jopt[0].mu[key], err_msg=f"{name} mu {key}")
            _close_rel(nu[key], jopt[0].nu[key], err_msg=f"{name} nu {key}")
        assert opt.count == int(jopt[0].count) == 2


def test_jax_train_state_file_restores_and_steps_on(outer_pair, outer_inputs, tmp_path):
    """jrr_tpu's npz of its state one step in (save_pytree_npz, what its
    save_train_state writes without orbax) restores in the port with every
    array equal, and the port's next outer_step from it follows jrr_tpu's."""
    (state1, tstate1), (want, want_m, _), _ = outer_pair
    model, _, _, init, data, cfg = outer_inputs
    path = str(tmp_path / "state_00000001.npz")
    jckpt.save_pytree_npz(path, state1)
    tcfg = convert.pipeline_config(cfg)
    template = ttrainer.init_train_state(torch.zeros_like(tstate1.j_reg_raw), tcfg, seed=5)
    back = tckpt.restore_train_state(path, template)
    arrays = convert.train_state_arrays(back)
    with np.load(path) as f:
        assert set(f.files) == set(arrays)
        for key in f.files:
            assert arrays[key].dtype == f[key].dtype, key
            np.testing.assert_array_equal(arrays[key], f[key], err_msg=key)
    got, got_m, _ = ttrainer.outer_step(
        back, convert.smpl_model(model, device="cpu"), convert.frame_params(init, device="cpu"),
        convert.frame_batch(data, device="cpu"), tcfg,
    )
    assert got.step == 2 and got.pose_disc_opt.count == 2
    _close_rel(got.j_reg_raw.numpy(), want.j_reg_raw, err_msg="j_reg_raw")
    want_arrays = jckpt._flatten(want)
    for key, value in convert.train_state_arrays(got).items():
        _close_rel(value, want_arrays[key], err_msg=key)
    for field in want_m._fields:
        atol = 1e-3 if "mpjpe" in field else 1e-5
        np.testing.assert_allclose(float(getattr(got_m, field)), float(getattr(want_m, field)),
                                   atol=atol, rtol=1e-5, err_msg=field)


def test_port_train_state_file_restores_in_jax(outer_pair, tmp_path):
    _, (want, _, _), (got, _, _) = outer_pair
    path = tckpt.save_train_state(str(tmp_path / "ck"), got, got.step)
    assert path.endswith("state_00000002.npz")
    back = jckpt.restore_train_state(path, jax.tree.map(jnp.zeros_like, want))
    assert jax.tree.structure(back) == jax.tree.structure(want)
    flat, arrays = jckpt._flatten(back), convert.train_state_arrays(got)
    assert set(arrays) == set(flat)
    for key, value in arrays.items():
        assert value.dtype == flat[key].dtype, key
        np.testing.assert_array_equal(flat[key], value, err_msg=key)
    assert int(back.step) == 2 and int(back.pose_disc_opt[0].count) == 2


def test_outer_step_metrics_and_refinement_match_jax(outer_pair):
    (state1, tstate1), (_, want_m, want_res), (_, got_m, got_res) = outer_pair
    for field in want_m._fields:
        atol = 1e-3 if "mpjpe" in field else 1e-5
        np.testing.assert_allclose(float(getattr(got_m, field)), float(getattr(want_m, field)),
                                   atol=atol, rtol=1e-5, err_msg=field)
    for key in PARAMS:
        np.testing.assert_allclose(getattr(got_res.params, key).numpy(),
                                   np.asarray(getattr(want_res.params, key)), atol=5e-4, err_msg=key)
    # The input state is left as it was.
    np.testing.assert_array_equal(tstate1.j_reg_raw.numpy(), np.asarray(state1.j_reg_raw))
    assert tstate1.step == 1 and tstate1.pose_disc_opt.count == 1


def test_jreg_supervision_loss_matches_jax():
    model, j_reg, gt, init, data, cfg = _setup(batch=2)
    verts = np.random.default_rng(3).normal(scale=0.3, size=(2, 96, 3)).astype(np.float32)
    want = trainer.jreg_supervision_loss(j_reg, jnp.asarray(verts), data.gt_j3d)
    got = ttrainer.jreg_supervision_loss(_t(j_reg), _t(verts), _t(data.gt_j3d))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_lstsq_fit_matches_jax():
    rng = np.random.default_rng(4)
    b, v = 40, 96
    verts = rng.normal(scale=0.3, size=(b, v, 3)).astype(np.float32)
    gt_mm = rng.normal(scale=300.0, size=(b, 17, 3)).astype(np.float32)
    pelvis = rng.normal(scale=0.1, size=(b, 1, 3)).astype(np.float32)
    acc = trainer.JRegLstsqAccumulator.zero(v)
    tacc = ttrainer.JRegLstsqAccumulator.zero(v, device="cpu")
    for sl in (slice(0, 25), slice(25, b)):  # two batches: the sums add
        acc = trainer.jreg_lstsq_accumulate(acc, verts[sl], gt_mm[sl], pelvis[sl])
        tacc = ttrainer.jreg_lstsq_accumulate(tacc, _t(verts[sl]), _t(gt_mm[sl]), _t(pelvis[sl]))
    for field in acc._fields:
        _close_rel(getattr(tacc, field).numpy(), getattr(acc, field), err_msg=field)
    want = np.asarray(trainer.jreg_lstsq_solve(acc, ridge=1e-4, nnls_steps=50))
    got = ttrainer.jreg_lstsq_solve(tacc, ridge=1e-4, nnls_steps=50).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)
    np.testing.assert_allclose(got.sum(axis=1), 1.0, atol=1e-5)
    with pytest.raises(ValueError, match="empty accumulator"):
        ttrainer.jreg_lstsq_solve(ttrainer.JRegLstsqAccumulator.zero(v, device="cpu"))


def test_project_columns_to_simplex_matches_jax():
    w = np.random.default_rng(5).normal(size=(50, 17)).astype(np.float32)
    want = np.asarray(trainer._project_columns_to_simplex(jnp.asarray(w)))
    got = ttrainer._project_columns_to_simplex(_t(w)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    np.testing.assert_allclose(got.sum(axis=0), 1.0, atol=1e-5)
    assert got.min() >= 0.0


@pytest.mark.parametrize("reflect", [False, True])
def test_similarity_align_and_evaluate_match_jax(reflect):
    rng = np.random.default_rng(6)
    s2 = rng.normal(size=(4, 17, 3)).astype(np.float32)
    rot = np.linalg.qr(rng.normal(size=(4, 3, 3)))[0]
    rot *= np.sign(np.linalg.det(rot))[:, None, None]  # proper rotations
    if reflect:  # a mirrored copy: the best proper rotation cannot undo it
        rot = rot @ np.diag([1.0, 1.0, -1.0])
    s1 = (1.3 * s2 @ rot.transpose(0, 2, 1) + 0.2
          + rng.normal(scale=0.01, size=s2.shape)).astype(np.float32)
    want = np.asarray(procrustes.similarity_align(jnp.asarray(s1), jnp.asarray(s2)))
    got = tprocrustes.similarity_align(_t(s1), _t(s2)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    if not reflect:
        np.testing.assert_allclose(got, s2, atol=0.05)

    want_e = metrics.evaluate(jnp.asarray(s1), jnp.asarray(s2 * 1000.0))
    got_e = tmetrics.evaluate(_t(s1), _t(s2 * 1000.0))
    for field in want_e._fields:
        np.testing.assert_allclose(getattr(got_e, field).numpy(), np.asarray(getattr(want_e, field)),
                                   rtol=1e-5, atol=1e-3, err_msg=field)


def test_outer_step_with_silhouette_counters():
    """The rasterizer counters come from the refinement's bin stats: the
    fused path reports them, the round-1 path reports zeros."""
    from jrr_tpu_torch import config, problem

    model, j_reg, cfg, init, data = problem.synthetic_problem(
        batch=2, num_verts=96, image_size=32, device="cpu"
    )
    cfg = dataclasses.replace(cfg, stage_a_steps=3, stage_b_steps=4, silhouette=dataclasses.replace(
        cfg.silhouette, rebin_interval=2, coarse_frac=0.0))
    for backend in ("auto", "pallas"):
        rcfg = dataclasses.replace(cfg, silhouette=dataclasses.replace(cfg.silhouette, backend=backend))
        pcfg = config.PipelineConfig(refiner=rcfg)
        state = ttrainer.init_train_state(j_reg, pcfg)
        new, m, res = ttrainer.outer_step(state, model, init, data, pcfg)
        assert new.step == 1 and all(bool(torch.isfinite(x)) for x in m)
        if backend == "auto":
            assert int(m.rasterizer_max_faces_per_tile) == int(res.bin_stats.max_faces_per_tile) > 0
        else:
            assert res.bin_stats is None and int(m.rasterizer_max_faces_per_tile) == 0


FIT_FRAMES, FIT_HELDOUT = 512, 256
FIT_CHUNK = 128


@pytest.fixture(scope="module")
def full_width_frames():
    """The 6890-vertex synthetic body, the demo's true and perturbed
    regressors (`pipeline.demo_regressors`), the true vertices of
    FIT_FRAMES + FIT_HELDOUT drift-scene poses (small-angle joint rotations,
    σ 0.25 rad; a uniformly random orientation; betas σ 0.3) with no
    refinement, and the true regressor's joints in mm."""
    from jrr_tpu_torch.models import smpl
    from jrr_tpu_torch.ops import jreg as tjreg
    from jrr_tpu_torch.ops import rotations
    from jrr_tpu_torch.pipeline import demo_regressors
    from jrr_tpu_torch.refine import losses
    from jrr_tpu_torch.utils import precision

    frames = FIT_FRAMES + FIT_HELDOUT
    model = smpl.synthetic_smpl_model(seed=0, device="cpu")
    j_true, j_init = demo_regressors(model.num_verts, 0)
    rng = np.random.default_rng(11)
    t = lambda a: torch.as_tensor(a.astype(np.float32))  # noqa: E731
    verts = []
    with torch_threads(), torch.no_grad(), precision.float32_products():
        for i in range(0, frames, FIT_CHUNK):
            b = min(FIT_CHUNK, frames - i)
            pose = rotations.rotmat_to_rot6d(rotations.axis_angle_to_rotmat(
                t(rng.normal(scale=0.25, size=(b, 23, 3)))))
            orient = rotations.rotmat_to_rot6d(rotations.random_rotmat(rng, (b, 1), device="cpu"))
            betas = t(rng.normal(scale=0.3, size=(b, 10)))
            params = losses.FrameParams(pose, orient, betas, torch.zeros(b, 3))
            verts.append(losses.forward_frame(model, params).vertices)
        verts = torch.cat(verts)
        gt_mm = tjreg.apply_jreg(tjreg.normalize_jreg(t(j_true)), verts) * 1000.0
    return j_true, j_init, verts, gt_mm


@torch.no_grad()
def _anchored_statistics(j_anchor, verts, gt_mm):
    """The lstsq statistics of the first FIT_FRAMES frames, the centred
    joints re-anchored at `j_anchor`'s pelvis."""
    from jrr_tpu_torch.ops import jreg as tjreg
    from jrr_tpu_torch.utils import precision

    norm = tjreg.normalize_jreg(torch.as_tensor(np.asarray(j_anchor)))
    acc = ttrainer.JRegLstsqAccumulator.zero(verts.shape[1], device=verts.device)
    with precision.float32_products():
        for i in range(0, FIT_FRAMES, FIT_CHUNK):
            rows = slice(i, i + FIT_CHUNK)
            pelvis = tjreg.apply_jreg(norm, verts[rows])[:, :1]
            acc = ttrainer.jreg_lstsq_accumulate(acc, verts[rows], gt_mm[rows], pelvis)
    return acc


@torch.no_grad()
def _mpjpe(j_reg, verts, gt_mm) -> float:
    from jrr_tpu_torch.ops import jreg as tjreg
    from jrr_tpu_torch.utils import precision

    norm = tjreg.normalize_jreg(torch.as_tensor(np.asarray(j_reg)))
    with precision.float32_products():
        return float(tmetrics.evaluate(tjreg.apply_jreg(norm, verts), gt_mm).mpjpe)


@pytest.fixture
def few_threads():
    """Two torch threads: Tier-1 runs six test processes at once."""
    with torch_threads():
        yield


@pytest.mark.parametrize("anchor", ["true", "training"])
def test_lstsq_fit_at_full_width(full_width_frames, few_threads, anchor):
    """The fit at V = 6890 on true vertices: the same accumulated
    statistics solved by the port (float64 Cholesky) and by jrr_tpu
    (float32). The system is rank-deficient (rank ≤ 3·512 < 6890), so the
    weights are not identified, but the fitted function is, and the port's
    is no worse than jrr_tpu's + 1 mm in sample and on held-out frames,
    from a perturbed start above 150 mm.

    The targets re-anchor the centred GT at a pelvis (`pelvis_ref`). At the
    true regressor's pelvis both fits score under 25 mm. At the training
    regressor's (the perturbed one, as `run_optimize` passes its refined
    joints' pelvis) the simplex fit cannot follow the offset: both
    packages then land near 49 mm, which is the anchor's, not the solve's.
    With `-s` the test prints its readings, one JSON line per anchor."""
    j_true, j_init, verts, gt_mm = full_width_frames
    tacc = _anchored_statistics(j_true if anchor == "true" else j_init, verts, gt_mm)
    ours = ttrainer.jreg_lstsq_solve(tacc)
    acc = trainer.JRegLstsqAccumulator(*(jnp.asarray(x.numpy()) for x in tacc))
    theirs = np.array(trainer.jreg_lstsq_solve(acc))
    reading = {"anchor": anchor, "frames": FIT_FRAMES, "heldout": FIT_HELDOUT}
    for split, rows in (("in_sample", slice(0, FIT_FRAMES)), ("heldout", slice(FIT_FRAMES, None))):
        start, port, jax_ = (_mpjpe(j, verts[rows], gt_mm[rows])
                             for j in (j_init, ours.numpy(), theirs))
        reading[split] = {"start_mm": start, "port_mm": port, "jrr_tpu_mm": jax_}
        assert start > 150.0, start
        assert port <= jax_ + 1.0, (port, jax_)
        if anchor == "true":
            assert port < 25.0 and jax_ < 25.0, (port, jax_)
        else:
            assert port < start / 2 and jax_ < start / 2, (port, jax_, start)
    print(json.dumps(reading))
    np.testing.assert_allclose(ours.sum(1).numpy(), 1.0, atol=1e-5)
