"""Crash-safe resume of the port's `run_optimize` (a deliberate divergence
from jrr_tpu, whose run saves its train state only at the end, restarts
Adam after a mid-run crash and writes snapshots and states straight to
their final paths: jrr_tpu/pipeline.py:272,395).

A run of four shards (the demo fixtures at batch 2, snapshots every second
shard) is interrupted in one of four ways and then resumed with the same
arguments:
- `outer_step`: the third outer step raises (no accumulator checkpoint yet);
- `acc_checkpoint`: the same with an accumulator checkpoint after every
  shard, so the resume restores it and skips the shards it holds;
- `snapshot_write`: the writer dies inside the regressor snapshot of shard
  1, leaving a truncated temporary file beside its final path;
- `state_write`: the writer dies inside the train state after shard 1,
  after shard 1's snapshot; a resume drops that snapshot before its first
  write, so a resume that dies in its first outer step leaves none.
No `snap_*.npz` or `state_*.npz` at a final path may fail to load after the
crash. The resumed run must end with the train state, the lstsq
accumulator and its fit, the shard files and the `jreg_snapshots/`
directory of a run that was never interrupted, bit for bit (the CPU's
float32 arithmetic repeats exactly). jrr_tpu restores the port's states
(tests/test_torch_eval.py and test_torch_trainer.py hold that layout).
"""

import os

import numpy as np
import pytest
import torch

from jrr_tpu_torch import config as cfg_lib
from jrr_tpu_torch import convert, pipeline
from jrr_tpu_torch.data import fixtures, h36m
from jrr_tpu_torch.models import smpl
from jrr_tpu_torch.refine import trainer
from jrr_tpu_torch.utils import checkpoint as ckpt_lib

SHARDS = 4


def _cfg():
    return cfg_lib.PipelineConfig(
        refiner=cfg_lib.RefinerConfig(stage_a_steps=4, stage_b_steps=2, use_silhouette=False),
        jreg=cfg_lib.JRegConfig(snapshot_interval=2),
        data=cfg_lib.DataConfig(batch_size=2),
    )


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The demo's body, regressor and fixtures (8 frames, as the port's
    demo writes them) as four batches of 2."""
    model = smpl.synthetic_smpl_model(seed=0, num_verts=256, num_faces=500, device="cpu")
    j_reg = pipeline._demo_regressor(model.num_verts, np.random.default_rng(0))
    root = fixtures.write_fixture_dataset(str(tmp_path_factory.mktemp("fixtures")), num_frames=8,
                                          seed=0, model=model, j_reg_raw=j_reg, device="cpu")
    batches = list(h36m.BatchLoader(h36m.H36MDataset(root), 2, drop_last=True))
    assert len(batches) == SHARDS
    return model, j_reg, batches


def _run(setup, out_dir):
    model, j_reg, batches = setup
    return pipeline.run_optimize(_cfg(), model, j_reg, iter(batches), out_dir)


def _outcome(out_dir, state, acc):
    """Everything a run leaves that resume must reproduce."""
    files = {}
    with open(os.path.join(out_dir, "resume.json")) as f:
        files["resume.json"] = f.read()
    for sub in ("refined", "jreg_snapshots", "ckpt"):
        for name in sorted(os.listdir(os.path.join(out_dir, sub))):
            path = os.path.join(out_dir, sub, name)
            if name.endswith(".npz"):
                with np.load(path) as f:
                    files[f"{sub}/{name}"] = dict(f)
            else:
                files[f"{sub}/{name}"] = open(path).read()
    fit = trainer.jreg_lstsq_solve(acc, _cfg().jreg.lstsq_ridge)
    return dict(state=convert.train_state_arrays(state), acc=[t.numpy() for t in acc],
                fit=fit.numpy(), files=files)


def _assert_equal(got, want):
    assert got["state"].keys() == want["state"].keys()
    for k in want["state"]:
        np.testing.assert_array_equal(got["state"][k], want["state"][k], err_msg=k)
    for g, w in zip(got["acc"], want["acc"]):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got["fit"], want["fit"])
    assert sorted(got["files"]) == sorted(want["files"])
    for name, w in want["files"].items():
        g = got["files"][name]
        if isinstance(w, dict):
            assert g.keys() == w.keys(), name
            for k in w:
                np.testing.assert_array_equal(g[k], w[k], err_msg=f"{name}:{k}")
        else:
            assert g == w, name


@pytest.fixture(scope="module")
def uninterrupted(setup, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("uninterrupted"))
    state, acc, _ = _run(setup, out)
    return _outcome(out, state, acc)


def test_an_uninterrupted_run_leaves_one_state_and_its_marker(uninterrupted):
    files = uninterrupted["files"]
    assert sorted(n for n in files if n.startswith(("ckpt/", "jreg_snapshots/"))) == [
        "ckpt/state_00000004.npz", "jreg_snapshots/snap_00001.npz", "jreg_snapshots/snap_00003.npz"]
    assert files["resume.json"] == '{"state": "state_00000004.npz", "shard": 3}'
    assert int(uninterrupted["state"][".step"]) == SHARDS


def _crash_in_write(monkeypatch, name):
    """The writer dies inside the write of `name`: half of the file stands
    at its temporary path, nothing at its final one."""
    write = ckpt_lib.savez_atomic

    def crashing(path, **arrays):
        if os.path.basename(path) != name:
            return write(path, **arrays)
        write(path + ".whole.npz", **arrays)
        with open(path + ".whole.npz", "rb") as f:
            data = f.read()
        os.remove(path + ".whole.npz")
        with open(path + ".tmp.npz", "wb") as f:
            f.write(data[: len(data) // 2])
        raise OSError(f"crash inside the write of {name}")

    monkeypatch.setattr(ckpt_lib, "savez_atomic", crashing)


@pytest.mark.parametrize("case", ["outer_step", "acc_checkpoint", "snapshot_write",
                                  "state_write"])
def test_a_crashed_run_resumes_bit_for_bit(setup, uninterrupted, tmp_path, monkeypatch, case):
    out = str(tmp_path / "run")
    if case == "acc_checkpoint":
        monkeypatch.setattr(pipeline, "ACC_CKPT_EVERY", 1)
    with monkeypatch.context() as crash:
        if case in ("outer_step", "acc_checkpoint"):
            step, calls = trainer.outer_step, []

            def crashing_step(*args, **kwargs):
                calls.append(1)
                if len(calls) == 3:
                    raise RuntimeError("crash in the third outer step")
                return step(*args, **kwargs)

            crash.setattr(trainer, "outer_step", crashing_step)
            match = "third outer step"
        else:
            _crash_in_write(crash, "snap_00001.npz" if case == "snapshot_write"
                            else "state_00000002.npz")
            match = "async shard writer failed"
        with pytest.raises(RuntimeError, match=match):
            _run(setup, out)

    # Whatever stands at a final path is whole.
    finals = [os.path.join(out, sub, n) for sub in ("jreg_snapshots", "ckpt")
              if os.path.isdir(os.path.join(out, sub))
              for n in os.listdir(os.path.join(out, sub)) if n.endswith(".npz")
              and not n.endswith(".tmp.npz")]
    for path in finals:
        with np.load(path) as f:
            [f[k] for k in f.files]
    done = ckpt_lib.ShardManifest(os.path.join(out, "refined")).completed()
    if case == "acc_checkpoint":
        with np.load(os.path.join(out, "jreg_acc_ckpt.npz")) as f:
            assert int(f["upto"]) == 1
    assert done == [0, 1]
    snaps = os.path.join(out, "jreg_snapshots")
    if case == "snapshot_write":
        assert os.listdir(snaps) == ["snap_00001.npz.tmp.npz"]
    if case == "state_write":
        assert os.listdir(snaps) == ["snap_00001.npz"]

        def dead_step(*args, **kwargs):
            raise RuntimeError("crash in the first outer step")

        with monkeypatch.context() as crash:
            crash.setattr(trainer, "outer_step", dead_step)
            with pytest.raises(RuntimeError, match="first outer step"):
                _run(setup, out)
        assert os.listdir(snaps) == []

    state, acc, _ = _run(setup, out)
    _assert_equal(_outcome(out, state, acc), uninterrupted)


def test_a_state_saved_at_the_end_of_a_run_resumes_as_jrr_tpu_does(setup, tmp_path, monkeypatch):
    """A directory with no resume.json (jrr_tpu's, or the port's before
    mid-run checkpoints): the state it holds includes every completed
    shard, which resume replays into the accumulator with no outer step."""
    out = str(tmp_path / "run")
    _, acc_first, _ = _run(setup, out)
    os.remove(os.path.join(out, "resume.json"))
    def no_outer_step(*args, **kwargs):
        raise AssertionError("a shard the state includes ran outer_step")

    monkeypatch.setattr(trainer, "outer_step", no_outer_step)
    state, acc, _ = _run(setup, out)
    assert state.step == SHARDS
    for g, w in zip(acc, acc_first):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
