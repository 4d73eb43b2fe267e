"""The port's protocol-2 harness, checkpoints, logging, profiling hooks and
configuration against jrr_tpu on the CPU.

Tolerances: every EvalResult within 1e-4 mm of JAX's (the same seeded
predictions and regressors; ragged batches too), and the summary text
equal on equal numbers; joints of `smpl_joint_fn` 1e-6 m;
`spin_prediction_to_params` 1e-6; shard manifests, train states (in
jrr_tpu's layout, and the port's earlier one) and metric records exact.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jrr_tpu import config as jcfg_lib
from jrr_tpu.evals import harness as jharness
from jrr_tpu.models import smpl as jsmpl
from jrr_tpu.ops import jreg as jjreg
from jrr_tpu.ops import rotations as jrot
from jrr_tpu.refine import engine as jengine
from jrr_tpu.refine import trainer as jtrainer
from jrr_tpu.utils import checkpoint as jckpt
from jrr_tpu.utils import logging as jlogging
from jrr_tpu_torch import config as cfg_lib
from jrr_tpu_torch import convert
from jrr_tpu_torch.evals import harness
from jrr_tpu_torch.models import smpl as tsmpl
from jrr_tpu_torch.refine import engine, trainer
from jrr_tpu_torch.utils import checkpoint as ckpt
from jrr_tpu_torch.utils import logging as tlogging
from jrr_tpu_torch.utils import profiling


def _model_and_regressors(num_verts=128, seed=0):
    """As tests/test_harness_pipeline.py: a true regressor, a perturbed one,
    and a third with a negative entry (the ReLU in normalize_jreg)."""
    model = jsmpl.synthetic_smpl_model(seed=seed, num_verts=num_verts, num_faces=200)
    rng = np.random.default_rng(seed)
    j_true = np.zeros((17, num_verts), np.float32)
    for j in range(17):
        j_true[j, rng.choice(num_verts, 6, replace=False)] = rng.uniform(0.5, 1.0, 6)
    j_bad = j_true + np.abs(rng.normal(scale=0.2, size=j_true.shape)).astype(np.float32)
    j_neg = j_bad + rng.normal(scale=0.05, size=j_true.shape).astype(np.float32)
    return model, [j_true, j_bad, j_neg]


def _predictions(model, j_true, sizes, seed=1):
    """Seeded predictions whose gt comes from the true regressor (numpy draws)."""
    rng = np.random.default_rng(seed)
    out = []
    for b in sizes:
        rot = jrot.rotmat_to_rot6d(jrot.random_rotmat(jax.random.PRNGKey(seed + b), (b, 24)))
        betas = rng.normal(scale=0.3, size=(b, 10)).astype(np.float32)
        rotm = jrot.rot6d_to_rotmat(rot)
        verts = jsmpl.smpl_forward(model, jnp.asarray(betas), rotm[:, :1], rotm[:, 1:]).vertices
        gt = jjreg.apply_jreg(jjreg.normalize_jreg(jnp.asarray(j_true)), verts) * 1000.0
        gt = np.array(gt) + rng.normal(scale=5.0, size=gt.shape).astype(np.float32)
        out.append({"pose6d": np.array(rot), "betas": betas, "gt_j3d": gt})
    return out


@pytest.mark.parametrize("sizes", [(4, 4), (6, 2), (5,)], ids=["equal", "ragged", "one"])
def test_evaluate_regressors_matches_jax(sizes):
    """One pass, three regressors; the ragged case keeps the reference's mean
    of per-batch means (tests/test_harness_pipeline.py:56)."""
    model, regs = _model_and_regressors()
    preds = _predictions(model, regs[0], sizes)
    want = jharness.evaluate_regressors(model, preds, regs)
    got = harness.evaluate_regressors(convert.smpl_model(model, device="cpu"), preds, regs)
    for g, w in zip(got, want):
        assert g.num_frames == w.num_frames == sum(sizes)
        np.testing.assert_allclose([g.mpjpe, g.pa_mpjpe], [w.mpjpe, w.pa_mpjpe], atol=1e-4)
    if len(sizes) == 2:  # the batch-mean convention, not frame weighting
        singles = [harness.evaluate_regressors(convert.smpl_model(model, device="cpu"), [p],
                                               regs[:1])[0].mpjpe for p in preds]
        np.testing.assert_allclose(got[0].mpjpe, np.mean(singles), rtol=1e-6)


def test_regressor_pair_and_summary_match_jax():
    model, regs = _model_and_regressors()
    preds = _predictions(model, regs[0], (4, 3))
    want = jharness.evaluate_regressor_pair(model, preds, regs[1], regs[0])
    got = harness.evaluate_regressor_pair(convert.smpl_model(model, device="cpu"), preds,
                                          regs[1], regs[0])
    for g, w in ((got.before, want.before), (got.after, want.after)):
        np.testing.assert_allclose([g.mpjpe, g.pa_mpjpe], [w.mpjpe, w.pa_mpjpe], atol=1e-4)
    assert got.after.mpjpe < got.before.mpjpe
    # The text format, on the same numbers (4 decimals: values 1e-5 apart
    # may print differently).
    same = harness.BeforeAfter(*(harness.EvalResult(**dataclasses.asdict(r))
                                 for r in (want.before, want.after)))
    assert same.summary() == want.summary()


def test_smpl_joint_fn_matches_jax():
    model, regs = _model_and_regressors()
    p = _predictions(model, regs[0], (3,))[0]
    norm = jjreg.normalize_jreg(jnp.asarray(regs[1]))
    want = jharness.smpl_joint_fn(model)(jnp.asarray(p["pose6d"]), jnp.asarray(p["betas"]), norm)
    got = harness.smpl_joint_fn(convert.smpl_model(model, device="cpu"))(
        torch.as_tensor(p["pose6d"]), torch.as_tensor(p["betas"]),
        torch.as_tensor(np.array(norm)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_spin_prediction_to_params_matches_jax():
    rng = np.random.default_rng(2)
    pose = rng.normal(size=(3, 24, 6)).astype(np.float32)
    betas = rng.normal(size=(3, 10)).astype(np.float32)
    cam = np.stack([rng.uniform(0.7, 1.2, 3), rng.normal(size=3), rng.normal(size=3)], -1)
    cam = cam.astype(np.float32)
    want = jengine.spin_prediction_to_params(pose, betas, cam)
    got = engine.spin_prediction_to_params(*map(torch.as_tensor, (pose, betas, cam)))
    for key in want._fields:
        np.testing.assert_allclose(getattr(got, key).numpy(), np.asarray(getattr(want, key)),
                                   atol=1e-6, rtol=1e-6, err_msg=key)


def test_pipeline_config_carries_every_field():
    src = jcfg_lib.PipelineConfig(
        jreg=jcfg_lib.JRegConfig(lr=3e-3, snapshot_interval=4),
        data=jcfg_lib.DataConfig(batch_size=8, shuffle_seed=3, prefetch=1, train_epochs=2,
                                 split="train"),
        mesh=jcfg_lib.MeshConfig(num_devices=1),
        seed=5, num_betas=10,
    )
    assert dataclasses.asdict(convert.pipeline_config(src)) == dataclasses.asdict(src)
    assert dataclasses.asdict(cfg_lib.PipelineConfig()) == dataclasses.asdict(
        jcfg_lib.PipelineConfig())


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_shard_manifest_moves_between_packages(tmp_path, writer):
    """A refined-shard directory written by either package is read by the other."""
    rng = np.random.default_rng(3)
    shards = {sid: {"pose6d": rng.normal(size=(2, 23, 6)).astype(np.float32),
                    "gt_j3d": rng.normal(size=(2, 17, 3)).astype(np.float32)}
              for sid in (0, 2)}
    out = str(tmp_path / "refined")
    first, second = (jckpt, ckpt) if writer == "jax" else (ckpt, jckpt)
    man = first.ShardManifest(out)
    for sid, arrays in shards.items():
        man.write_shard(sid, arrays)
    other = second.ShardManifest(out)
    assert other.completed() == [0, 2] and other.is_done(2) and not other.is_done(1)
    for sid, arrays in shards.items():
        back = other.read_shard(sid)
        for key, value in arrays.items():
            np.testing.assert_array_equal(back[key], value)
    other.write_shard(1, shards[0])  # and it resumes the other's manifest
    assert man.completed() == [0, 1, 2]


def _stepped_state():
    """A port TrainState one outer step in (live Adam moments, step 1)."""
    cfg = cfg_lib.PipelineConfig()
    j = torch.as_tensor(np.random.default_rng(4).uniform(size=(17, 32)).astype(np.float32))
    state = trainer.init_train_state(j, cfg, seed=3)
    g = lambda p: torch.full_like(p, 0.5)  # noqa: E731
    for disc, opt in ((state.pose_disc, state.pose_disc_opt), (state.shape_disc, state.shape_disc_opt)):
        params = list(disc.parameters())
        opt.step(params, [g(p) for p in params])
    state.jreg_opt.step([state.j_reg_raw], [g(state.j_reg_raw)])
    return state._replace(step=1), cfg


def _flat(state):
    return ckpt._flatten(state)


def test_train_state_round_trips_exactly(tmp_path):
    state, cfg = _stepped_state()
    path = ckpt.save_train_state(str(tmp_path / "ck"), state, state.step)
    assert os.path.basename(path) == "state_00000001.npz"
    with np.load(path) as f:  # jrr_tpu's layout
        assert ".pose_disc_opt[0].mu['wg1']" in f.files and f[".step"].dtype == np.int32
    template = trainer.init_train_state(torch.zeros(17, 32), cfg, seed=9)
    back = ckpt.restore_train_state(path, template)
    assert back.step == 1 and back.jreg_opt.count == 1 and back.pose_disc_opt.count == 1
    want, got = _flat(state), _flat(back)
    assert set(got) == set(want) and len(want) > 20
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    # The restored moments drive the restored modules' parameters.
    params = list(back.shape_disc.parameters())
    back.shape_disc_opt.step(params, [torch.ones_like(p) for p in params])
    assert back.shape_disc_opt.count == 2


def test_train_state_from_jax_restores(tmp_path):
    """jrr_tpu's npz of its initial state restores in the port, every array
    equal (tests/test_torch_trainer.py steps on from one a step in)."""
    jstate = jtrainer.init_train_state(jax.random.PRNGKey(0), jnp.ones((17, 32)),
                                       jcfg_lib.PipelineConfig())
    path = str(tmp_path / "state_00000000.npz")
    jckpt.save_pytree_npz(path, jstate)
    template = trainer.init_train_state(torch.zeros(17, 32), cfg_lib.PipelineConfig())
    back = ckpt.restore_train_state(path, template)
    assert back.step == 0 and back.jreg_opt.count == 0 and back.jreg_opt.lr == template.jreg_opt.lr
    want = jckpt._flatten(jstate)
    got = convert.train_state_arrays(back)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    np.testing.assert_array_equal(back.pose_disc.fc1.weight.detach().numpy(),
                                  np.asarray(jstate.pose_disc["wg1"]).T)


def test_committed_jax_train_state_restores_in_both():
    """tests/data/train_state (tests/make_state_fixture.py, V = 96), which
    chip_smoke.py restores on the card: jrr_tpu and the port read it alike,
    every array equal to the file's."""
    path = os.path.join(os.path.dirname(__file__), "data", "train_state", "state_00000001.npz")
    jtemplate = jtrainer.init_train_state(jax.random.PRNGKey(1), jnp.zeros((17, 96)),
                                          jcfg_lib.PipelineConfig())
    jback = jckpt._flatten(jckpt.restore_train_state(path, jtemplate))
    back = ckpt.restore_train_state(
        path, trainer.init_train_state(torch.zeros(17, 96), cfg_lib.PipelineConfig()))
    got = convert.train_state_arrays(back)
    with np.load(path) as f:
        assert set(f.files) == set(got) == set(jback)
        for key in f.files:
            np.testing.assert_array_equal(got[key], f[key], err_msg=key)
            np.testing.assert_array_equal(jback[key], f[key], err_msg=key)
    assert back.step == 1 and back.pose_disc_opt.count == 1
    assert 0 < int((back.pose_disc_opt.m[2] != 0).sum()) < back.pose_disc_opt.m[2].numel()


def test_train_state_from_another_layout_raises(tmp_path):
    """An orbax directory (jrr_tpu's format when orbax imports) raises,
    naming the jrr_tpu calls that turn it into an npz; so does an npz whose
    arrays do not fit the template."""
    template = trainer.init_train_state(torch.zeros(17, 32), cfg_lib.PipelineConfig())
    with pytest.raises(ValueError, match="orbax.*restore_train_state.*save_pytree_npz"):
        ckpt.restore_train_state(str(tmp_path / "state_00000000"), template)
    jstate = jtrainer.init_train_state(jax.random.PRNGKey(0), jnp.ones((17, 40)),
                                       jcfg_lib.PipelineConfig())
    path = str(tmp_path / "state_00000000.npz")
    jckpt.save_pytree_npz(path, jstate)
    with pytest.raises(ValueError, match=r"\.j_reg_raw is \(17, 40\)"):
        ckpt.restore_train_state(path, template)


def test_train_state_in_the_earlier_port_layout_restores(tmp_path):
    """Files of the port's earlier key layout ("jreg_opt/m/0", ...) resume."""
    state, cfg = _stepped_state()
    path = str(tmp_path / "state_00000001.npz")
    ckpt.save_pytree_npz(path, state)
    with np.load(path) as f:
        assert "jreg_opt/m/0" in f.files and "pose_disc/fc1.weight" in f.files
    back = ckpt.restore_train_state(path, trainer.init_train_state(torch.zeros(17, 32), cfg))
    want, got = _flat(state), _flat(back)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_metrics_records_match_jax(tmp_path):
    values = {name: float(i) + 0.25 for i, name in enumerate(trainer.OuterMetrics._fields)}
    want = jlogging.outer_metrics_record(jtrainer.OuterMetrics(**values))
    got = tlogging.outer_metrics_record(trainer.OuterMetrics(**values))
    assert got == want
    path = str(tmp_path / "m.jsonl")
    log = tlogging.MetricsLogger(path=path, echo=False)
    log.log({"mpjpe": torch.tensor(3.5), "note": "x"}, step=2)
    log.close()
    with open(path) as f:
        rec = json.loads(f.readline())
    assert rec["step"] == 2 and rec["mpjpe"] == 3.5 and rec["note"] == "x"


def test_profiling_hooks(tmp_path):
    timer = profiling.StepTimer(frames_per_step=4, warmup=1)
    assert timer.rates()["frames_per_sec"] == 0.0
    with profiling.trace(str(tmp_path / "tr")):
        for _ in range(3):
            with profiling.annotate("step"):
                torch.ones(8).sum()
            timer.tick()
    rates = timer.rates()
    assert rates["frames_per_sec"] == pytest.approx(4 * rates["steps_per_sec"])
    with open(tmp_path / "tr" / "trace.json") as f:
        assert "step" in f.read()


def test_load_smpl_npz_matches_jax(tmp_path):
    """A converted-model npz (posedirs in the (V, 3, 207) storage order,
    12 betas cut to 10, an extra regressor) loads alike in both packages;
    without the file, resolve_smpl_model falls back to the synthetic body."""
    src = jsmpl.synthetic_smpl_model(seed=3, num_verts=64, num_faces=100)
    rng = np.random.default_rng(6)
    v = src.v_template.shape[0]
    path = str(tmp_path / "body_model" / "smpl_neutral.npz")
    os.makedirs(os.path.dirname(path))
    np.savez(
        path, v_template=np.asarray(src.v_template),
        shapedirs=rng.normal(size=(v, 3, 12)).astype(np.float32),
        posedirs=np.asarray(src.posedirs).T.reshape(v, 3, -1),
        j_regressor=np.asarray(src.j_regressor), lbs_weights=np.asarray(src.lbs_weights),
        faces=np.asarray(src.faces, np.int32),
        kintree_parents=np.asarray((4294967295,) + tuple(src.parents[1:]), np.int64),
    )
    extra = str(tmp_path / "extra.npy")
    np.save(extra, rng.uniform(size=(9, v)).astype(np.float32))
    want = jsmpl.load_smpl_npz(path, j_regressor_extra_path=extra)
    got = tsmpl.resolve_smpl_model(str(tmp_path), device="cpu", j_regressor_extra_path=extra)
    for f in dataclasses.fields(want):
        w, g = getattr(want, f.name), getattr(got, f.name)
        if f.name == "parents":
            assert g == w
        else:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=f.name)
    assert tsmpl.resolve_smpl_model(str(tmp_path / "none"), device="cpu").num_verts == 6890
