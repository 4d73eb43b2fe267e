"""The port's multi-process data parallelism (jrr_tpu_torch/parallel/,
`run_optimize` under torch.distributed) against the one-process port and
jrr_tpu on the CPU.

- `feasible_device_count` and `host_shard_slice` give jrr_tpu's answers on
  a grid of inputs; without a process group the mesh is one process, and a
  device count above 1 raises with the torchrun command.
- Everything else runs in ONE 2-process gloo group, started once for the
  module (tests/torch_dist_worker.py through `multihost.launch_local`: a
  file:// init method in tmp_path, a 240 s deadline after which every
  process is killed):
  - the sharded outer step at tests/test_parallel.py's problem (batch 16,
    96 vertices, 5 + 8 steps, no silhouette, discriminators on) against the
    port's one-process step and jrr_tpu's 8-device sharded step: j_reg
    atol 1e-5, refined params atol 1e-4, MPJPE rtol 1e-4 / atol 1e-3, the
    discriminators and Adam moments within 1e-4 in norm; both ranks leave
    the same state bit for bit;
  - the sharded refinement against the one-process refinement (the same
    tolerances, its loss curve within 1e-5 relative);
  - the accumulator summed over the ranks against the one-process sum,
    within 1e-6 relative;
  - `global_batch_from_local` as tests/test_multihost.py holds jrr_tpu's;
  - `run_optimize` over four fixture shards with the silhouette: the files
    of a one-process run, shards and regressor within the tolerances above,
    written by rank 0 alone;
  - resume after a crash in the third outer step, with and without an
    accumulator checkpoint after every shard: bit for bit the
    uninterrupted 2-process run (state, accumulator, fit, every file);
  - the CLI's demo in the group: rank 0 alone prints the MPJPE block and
    writes the metrics file and the outputs.
- A 1-process gloo group in this process: `run_optimize` leaves the plain
  run's files, state and accumulator bit for bit.
"""

import dataclasses
import os
import sys

import jax
import numpy as np
import pytest
import torch

from jrr_tpu.parallel import data_parallel as jdp, mesh as jmesh
from jrr_tpu.refine import trainer as jtrainer
from test_torch_spin import torch_threads
from jrr_tpu_torch import convert, pipeline
from jrr_tpu_torch.data import fixtures
from jrr_tpu_torch.models import smpl
from jrr_tpu_torch.parallel import data_parallel, mesh as mesh_lib, multihost
from jrr_tpu_torch.refine import engine, trainer
from tests import test_parallel as tp
from tests import torch_dist_worker as worker

@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Two torch threads: Tier-1 runs six test processes at once
    (tests/test_torch_spin.py's reason)."""
    with torch_threads():
        yield


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
DEADLINE_S = 240.0
MODEL_FIELDS = ("v_template", "shapedirs", "posedirs", "j_regressor", "lbs_weights", "faces",
                "vertex_perm", "parents")


def _model_arrays(model):
    return {f"model.{f}": np.asarray(getattr(model, f)) for f in MODEL_FIELDS}


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """The worker's inputs, written by this process: tests/test_parallel.py's
    problem and JAX's initial state (the arrays JAX draws), the lstsq
    batch, and the demo body's fixture dataset."""
    in_dir = tmp_path_factory.mktemp("dist_in")
    jmodel, j_reg, init, data, jcfg = tp._problem(16)
    cfg = worker.outer_cfg()
    assert convert.pipeline_config(jcfg) == cfg
    jstate = jtrainer.init_train_state(jax.random.PRNGKey(3), j_reg, jcfg)
    state = convert.train_state(jstate, cfg, device="cpu")
    np.savez(in_dir / "outer_inputs.npz", **_model_arrays(jmodel),
             **{f"state{k}": v for k, v in convert.train_state_arrays(state).items()},
             **{f"init.{k}": np.asarray(v) for k, v in init._asdict().items()},
             **{f"data.{k}": np.asarray(getattr(data, k)) for k in ("gt_j2d", "gt_j3d")})
    rng = np.random.default_rng(4)
    np.savez(in_dir / "acc_inputs.npz", verts=rng.normal(size=(8, 96, 3)).astype(np.float32),
             gt=rng.normal(scale=300.0, size=(8, 17, 3)).astype(np.float32),
             pelvis=rng.normal(scale=0.1, size=(8, 1, 3)).astype(np.float32))
    model = smpl.synthetic_smpl_model(seed=0, num_verts=256, num_faces=500, device="cpu")
    j_true = pipeline._demo_regressor(model.num_verts, np.random.default_rng(0))
    fixtures.write_fixture_dataset(str(in_dir / "fixtures"), num_frames=8, seed=0, model=model,
                                   j_reg_raw=j_true, device="cpu")
    j_reg0 = (j_true + np.random.default_rng(1).normal(scale=0.05, size=j_true.shape)
              * (j_true > 0)).astype(np.float32)
    np.savez(in_dir / "run_inputs.npz", **_model_arrays(model), j_reg=j_reg0)
    return in_dir, jstate, jmodel, init, data, jcfg


@pytest.fixture(scope="module")
def group(inputs, tmp_path_factory):
    """The 2-process group's outputs (every case of the worker, one launch)."""
    in_dir = inputs[0]
    out = tmp_path_factory.mktemp("dist_out")
    env = dict(os.environ, OMP_NUM_THREADS="2")
    init = "file://" + str(tmp_path_factory.mktemp("dist_store") / "store")
    res = multihost.launch_local(
        [sys.executable, "-m", "tests.torch_dist_worker", str(in_dir), str(out)], WORLD,
        DEADLINE_S, init_method=init, env=env, cwd=ROOT)
    assert res.returncodes == [0] * WORLD, "\n".join(
        f"rank {r} rc {rc}:\n{log['stderr'][-3000:]}"
        for r, (rc, log) in enumerate(zip(res.returncodes, res.logs)))
    for r, log in enumerate(res.logs):
        (out / f"stdout_rank{r}.txt").write_text(log["stdout"])
    return out


def _load(out, name, rank=0):
    with np.load(out / f"{name}_rank{rank}.npz") as f:
        return dict(f)


# ---------------------------------------------------------------------------
# No process group
# ---------------------------------------------------------------------------


def test_feasible_device_count_matches_jax():
    for batch in range(1, 65):
        for available in range(1, 11):
            assert mesh_lib.feasible_device_count(batch, available) == \
                jmesh.feasible_device_count(batch, available), (batch, available)


def test_host_shard_slice_matches_jax():
    for batch in (8, 16, 256, 257):
        for hosts in (1, 2, 4, 8):
            for host in range(hosts):
                assert data_parallel.host_shard_slice(batch, hosts, host) == \
                    jdp.host_shard_slice(batch, hosts, host)


def test_one_process_without_a_group(tmp_path):
    assert not mesh_lib.initialized()
    multihost.initialize()  # nothing configured: no group
    assert not mesh_lib.initialized()
    assert multihost.process_info() == {"process_index": 0, "process_count": 1,
                                        "local_device_count": 1, "global_device_count": 1}
    mesh = mesh_lib.make_mesh(device="cpu")
    assert (mesh.world_size, mesh.rank, mesh.distributed) == (1, 0, False)
    x = torch.arange(6.0).reshape(3, 2)
    assert mesh_lib.sum_over_ranks(mesh, [x])[0] is x
    assert torch.equal(mesh_lib.shard_batch(mesh, {"x": x})["x"], x)
    with pytest.raises(ValueError, match="torchrun --nproc_per_node=2"):
        mesh_lib.make_mesh(2, device="cpu")
    cfg = dataclasses.replace(worker.run_cfg(), mesh=dataclasses.replace(
        worker.run_cfg().mesh, num_devices=2))
    model = smpl.synthetic_smpl_model(seed=0, num_verts=96, num_faces=160, device="cpu")
    with pytest.raises(ValueError, match="torchrun --nproc_per_node=2"):
        pipeline.run_optimize(cfg, model, np.zeros((17, 96), np.float32), iter(()),
                              str(tmp_path))


# ---------------------------------------------------------------------------
# The 2-process group
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def one_process(inputs):
    """The port's one-process outer step and refinement on the same inputs."""
    in_dir = inputs[0]
    model, state, init, data = worker.load_outer_inputs(str(in_dir))
    s, m, r = trainer.outer_step(state, model, init, data, worker.outer_cfg())
    ref = engine.refine_batch(model, state.j_reg_raw, init, data, worker.outer_cfg().refiner)
    return s, m, r, ref


@pytest.fixture(scope="module")
def jax_sharded(inputs):
    """jrr_tpu's step on the 8-device CPU mesh, as tests/test_parallel.py runs it."""
    _, jstate, jmodel, init, data, jcfg = inputs
    mesh = jmesh.make_mesh()
    step = jdp.make_sharded_outer_step(mesh, jcfg)
    s, m, r = step(jmesh.replicate(mesh, jstate), jmesh.replicate(mesh, jmodel),
                   jmesh.shard_batch(mesh, init), jmesh.shard_batch(mesh, data))
    return s, m, r


def test_ranks_leave_the_same_state(group):
    a, b = _load(group, "outer", 0), _load(group, "outer", 1)
    assert int(a["local_rows"]) == int(b["local_rows"]) == 16 // WORLD
    for k in a:
        if k.startswith(("state.", "metric.", "params.")) or k in ("stage_a_loss", "stage_b_total"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert int(a["state.step"]) == 1


def _held(out, j_reg, params, mpjpe, pampjpe=None):
    np.testing.assert_allclose(out["state.j_reg_raw"], j_reg, atol=1e-5)
    for k, v in params.items():
        np.testing.assert_allclose(out[f"params.{k}"], v, atol=1e-4, err_msg=k)
    np.testing.assert_allclose(float(out["metric.mpjpe_after_jreg_step"]), mpjpe,
                               rtol=1e-4, atol=1e-3)


def test_sharded_outer_step_matches_one_process(group, one_process):
    s, m, r, _ = one_process
    out = _load(group, "outer")
    _held(out, s.j_reg_raw.numpy(), {k: v.numpy() for k, v in r.params._asdict().items()},
          float(m.mpjpe_after_jreg_step))
    for k in m._fields:
        np.testing.assert_allclose(float(out[f"metric.{k}"]), float(getattr(m, k)),
                                   rtol=1e-4, atol=1e-3, err_msg=k)
    np.testing.assert_allclose(out["stage_b_total"], r.stage_b_terms.total.numpy(), rtol=1e-5)
    # Discriminators and Adam moments: the one-process state within 1e-4 in
    # norm (the gradients are sums of the two halves' scaled means).
    want = convert.train_state_arrays(s)
    for k, v in want.items():
        got = out[f"state{k}"]
        assert np.linalg.norm(got - v) <= 1e-4 * max(np.linalg.norm(v), 1e-30), k


def test_sharded_outer_step_matches_jax_8_devices(group, jax_sharded):
    s, m, r = jax_sharded
    _held(_load(group, "outer"), np.asarray(s.j_reg_raw),
          {k: np.asarray(getattr(r.params, k)) for k in ("pose6d", "orient6d", "betas", "cam_t")},
          float(m.mpjpe_after_jreg_step))


def test_sharded_refine(group, one_process):
    ref = one_process[3]
    a, b = _load(group, "refine", 0), _load(group, "refine", 1)
    np.testing.assert_array_equal(a["stage_b_total"], b["stage_b_total"])
    np.testing.assert_allclose(a["stage_b_total"], ref.stage_b_terms.total.numpy(), rtol=1e-5)
    np.testing.assert_allclose(a["stage_a_loss"], ref.stage_a_loss.numpy(), rtol=1e-5)
    pose = np.concatenate([a["pose6d"], b["pose6d"]])
    np.testing.assert_allclose(pose, ref.params.pose6d.numpy(), atol=1e-4)


def test_accumulator_sums_over_ranks(group, inputs):
    with np.load(inputs[0] / "acc_inputs.npz") as f:
        t = {k: torch.as_tensor(f[k]) for k in f.files}
    acc = trainer.JRegLstsqAccumulator.zero(96, device="cpu")
    for sl in (slice(0, 4), slice(4, None)):
        acc = trainer.jreg_lstsq_accumulate(acc, t["verts"][sl], t["gt"][sl], t["pelvis"][sl])
    a, b = _load(group, "acc", 0), _load(group, "acc", 1)
    for k in ("gram", "rhs", "count"):
        np.testing.assert_array_equal(a[k], b[k])
        want = getattr(acc, k).numpy()
        assert np.linalg.norm(a[k] - want) <= 1e-6 * np.linalg.norm(want), k


def test_global_batch_from_local(group):
    """tests/test_multihost.py's case: the global array equals the stacked
    local rows, and its sum the sum of the rows."""
    for rank in range(WORLD):
        out = _load(group, "gather", rank)
        np.testing.assert_array_equal(out["x"], np.arange(16, dtype=np.float32).reshape(16, 1))
        assert float(out["total"]) == float(np.arange(16).sum())
        assert int(out["info.process_index"]) == rank
        assert int(out["info.process_count"]) == int(out["info.global_device_count"]) == WORLD


def _files(out_dir):
    files = {}
    for sub in ("refined", "jreg_snapshots", "ckpt"):
        for name in sorted(os.listdir(os.path.join(out_dir, sub))):
            path = os.path.join(out_dir, sub, name)
            if name.endswith(".npz"):
                with np.load(path) as f:
                    files[f"{sub}/{name}"] = dict(f)
            else:
                with open(path) as f:
                    files[f"{sub}/{name}"] = f.read()
    with open(os.path.join(out_dir, "resume.json")) as f:
        files["resume.json"] = f.read()
    return files


@pytest.fixture(scope="module")
def one_process_run(inputs, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("one_process_run"))
    model, j_reg, batches = worker.run_inputs(str(inputs[0]))
    state, acc, _ = pipeline.run_optimize(worker.run_cfg(), model, j_reg, iter(batches), out)
    return out, state, acc


def test_run_optimize_two_processes_matches_one(group, one_process_run):
    out1, state1, acc1 = one_process_run
    want, got = _files(out1), _files(str(group / "run"))
    assert sorted(got) == sorted(want)
    assert got["resume.json"] == want["resume.json"]
    for name, w in want.items():
        if not isinstance(w, dict):
            continue
        g = got[name]
        assert g.keys() == w.keys(), name
        for k in w:
            if k in ("gt_j3d", "shard", ".step") or k.endswith("count"):
                np.testing.assert_array_equal(g[k], w[k], err_msg=f"{name}:{k}")
            elif k in ("j_regressor", ".j_reg_raw"):
                np.testing.assert_allclose(g[k], w[k], atol=1e-5, err_msg=f"{name}:{k}")
            elif name.startswith("refined/"):
                np.testing.assert_allclose(g[k], w[k], atol=1e-4, err_msg=f"{name}:{k}")
            else:  # the discriminators and Adam moments, within 1e-4 in norm
                norm = max(np.linalg.norm(w[k]), 1e-30)
                assert np.linalg.norm(g[k] - w[k]) <= 1e-4 * norm, f"{name}:{k}"
    run = _load(group, "run")
    np.testing.assert_allclose(run["state.j_reg_raw"], state1.j_reg_raw.numpy(), atol=1e-5)
    for k in ("gram", "rhs", "count"):
        want_k = getattr(acc1, k).numpy()
        assert np.linalg.norm(run[f"acc.{k}"] - want_k) <= 1e-5 * np.linalg.norm(want_k), k
    for k in run:
        np.testing.assert_array_equal(run[k], _load(group, "run", 1)[k], err_msg=k)


@pytest.mark.parametrize("case", worker.RESUME_CASES)
def test_resume_two_processes_bit_for_bit(group, case):
    want, got = _files(str(group / "run")), _files(str(group / f"resume_{case}"))
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        g = got[name]
        if isinstance(w, dict):
            assert g.keys() == w.keys(), name
            for k in w:
                np.testing.assert_array_equal(g[k], w[k], err_msg=f"{name}:{k}")
        else:
            assert g == w, name
    for rank in range(WORLD):
        a, b = _load(group, "run", rank), _load(group, f"resume_{case}", rank)
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    if case == "acc_checkpoint":
        with np.load(group / f"resume_{case}" / "jreg_acc_ckpt.npz") as f:
            assert int(f["upto"]) == 3


def test_cli_in_a_group_prints_and_writes_on_rank_0(group):
    stdout = [(group / f"stdout_rank{r}.txt").read_text() for r in range(WORLD)]
    assert "\nafter\nMPJPE\n" in stdout[0] and "after (lstsq fit)" in stdout[0]
    assert "MPJPE" not in stdout[1] and stdout[1].strip() == "rank 1 cli"
    with open(group / "cli" / "metrics.jsonl") as f:
        assert len(f.readlines()) == 2  # one record per shard of 4
    with np.load(group / "cli" / "retrained_j_regressor.npz") as f:
        assert f["j_regressor"].shape == (17, 256) and np.isfinite(f["j_regressor_lstsq"]).all()
    assert sorted(os.listdir(group / "cli" / "refined")) == [
        "manifest.json", "shard_000000.npz", "shard_000001.npz"]


def test_one_process_group_is_the_plain_run_bit_for_bit(inputs, one_process_run, tmp_path):
    """A run in a 1-process group (every collective issued, each mean
    scaled by 1.0) leaves the plain run's files, state and accumulator bit
    for bit. The group lives in this process only for the run."""
    import datetime

    import torch.distributed as dist

    out1, state1, acc1 = one_process_run
    model, j_reg, batches = worker.run_inputs(str(inputs[0]))
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", world_size=1,
                            rank=0, timeout=datetime.timedelta(seconds=120))
    try:
        out = str(tmp_path / "run")
        state, acc, _ = pipeline.run_optimize(worker.run_cfg(), model, j_reg, iter(batches), out)
    finally:
        dist.destroy_process_group()
    want, got = _files(out1), _files(out)
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        if isinstance(w, dict):
            for k in w:
                np.testing.assert_array_equal(got[name][k], w[k], err_msg=f"{name}:{k}")
        else:
            assert got[name] == w, name
    for k in ("gram", "rhs", "count"):
        assert torch.equal(getattr(acc, k), getattr(acc1, k)), k
    assert torch.equal(state.j_reg_raw, state1.j_reg_raw)
