"""The port's regressor-recovery tool (`jrr_tpu_torch/probes/recovery.py`)
against jrr_tpu's (`tools/recovery_bench.py`) on the CPU.

One toy run of the port's tool, build → run → analyze in process, at a size
whose full-prefix fit is identified (8 frames · 3 coordinates > 16
vertices): 8 training frames, 4 held out, 2 epochs of batch 4 (4 shards),
5 + 2 steps, the shipped 224² silhouette. Its report keeps the contract of
tests/test_recovery_bench.py. jrr_tpu's `phase_analyze`, loaded from the
tool by path, then reads a copy of the same artifacts, and its report is
held row by row against the port's: every row with no solve (the perturbed
start, Adam final, the oracle, each adam@k) within 1e-3 mm, and each
lstsq@k within LSTSQ_MM (the port solves in float64, jrr_tpu in float32).
"""

import argparse
import contextlib
import importlib.util
import io
import json
import os
import shutil

import numpy as np
import pytest

from jrr_tpu_torch.probes import recovery
from test_torch_spin import torch_threads

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOL = os.path.join(ROOT, "tools", "recovery_bench.py")
V, TRAIN, HELDOUT, EPOCHS, BATCH = 16, 8, 4, 2, 4
SHARDS = EPOCHS * TRAIN // BATCH
NO_SOLVE_MM = 1e-3
# The lstsq rows of the two packages: the port's float64 Cholesky against
# jrr_tpu's float32 solve of the same statistics (1.9e-3 mm apart at most
# when written, the weights' distances to the oracle 3.1e-5).
LSTSQ_MM = 1e-2
LSTSQ_DIST = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Two torch threads: Tier-1 runs six test processes at once."""
    with torch_threads():
        yield


def _jax_tool():
    spec = importlib.util.spec_from_file_location("recovery_bench_under_test", TOOL)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    # Unrounded reports: the module's `round` shadows the builtin.
    mod.round = lambda x, ndigits=None: x
    return mod


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("recovery") / "root")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        recovery.main([
            "--phase", "all", "--root", root, "--train-frames", str(TRAIN),
            "--heldout-frames", str(HELDOUT), "--epochs", str(EPOCHS), "--batch", str(BATCH),
            "--num-verts", str(V), "--stage-a", "5", "--stage-b", "2",
            "--device", "cpu",
        ])
    return root, out.getvalue()


def test_recovery_tool_contract(toy):
    root, stdout = toy
    records = [json.loads(line) for line in stdout.splitlines() if line.startswith("{")]
    metric = [r for r in records if r.get("metric") == "product_pipeline_frames_per_sec_per_chip"]
    assert len(metric) == 1 and metric[0]["value"] > 0

    rep = json.load(open(os.path.join(root, "run", "recovery_analysis.json")))
    assert rep["n_shards"] == SHARDS
    for split in ("heldout", "train"):
        rows = rep["splits"][split]
        assert rows["oracle (true)"]["weight_rel_dist_to_oracle"] == 0.0
        for name in ("init (perturbed)", "adam final", f"lstsq@{SHARDS}"):
            assert name in rows and "mpjpe" in rows[name]
            assert np.isfinite(rows[name]["mpjpe"])
        assert "gap_closed_frac" in rows["adam final"]
        assert "gap_closed_frac" in rows[f"lstsq@{SHARDS}"]
        # One Adam-path snapshot per epoch.
        assert sorted(k for k in rows if k.startswith("adam@")) == ["adam@2", "adam@4"]
        assert rows["adam@4"]["mpjpe"] == rows["adam final"]["mpjpe"]
        assert [k for k in rows if k.startswith("lstsq@")] == ["lstsq@1", "lstsq@2", "lstsq@4"]
    assert set(rep["on_refined_vertices"]) == {"init", "adam", "lstsq", "oracle"}
    # The online accumulator against the replay: the same sums in the same
    # order, solved in float64 both times.
    assert rep["run_lstsq_matches_replay_rel"] == 0.0


def test_recovery_reports_match_jax(toy, tmp_path):
    from jrr_tpu_torch.models import smpl

    root, _ = toy
    ours, theirs = str(tmp_path / "port"), str(tmp_path / "jax")
    shutil.copytree(root, ours)
    shutil.copytree(root, theirs)
    got = recovery.analyze_root(ours, smpl.synthetic_smpl_model(seed=0, num_verts=V, device="cpu"),
                                BATCH, exact=True, log=None)
    with contextlib.redirect_stdout(io.StringIO()):
        _jax_tool().phase_analyze(argparse.Namespace(root=theirs, num_verts=V, batch=BATCH))
    want = json.load(open(os.path.join(theirs, "run", "recovery_analysis.json")))

    assert got["n_shards"] == want["n_shards"] == SHARDS
    for split in ("heldout", "train"):
        g, w = got["splits"][split], want["splits"][split]
        assert list(g) == list(w), split
        for name in g:
            tol = LSTSQ_MM if name.startswith("lstsq@") else NO_SOLVE_MM
            for key in ("mpjpe", "pa_mpjpe"):
                assert abs(g[name][key] - w[name][key]) <= tol, (split, name, key, g[name], w[name])
            assert g[name]["weight_rel_dist_to_oracle"] == pytest.approx(
                w[name]["weight_rel_dist_to_oracle"],
                abs=LSTSQ_DIST if name.startswith("lstsq@") else 1e-6)
        assert g["adam final"]["gap_closed_frac"] == pytest.approx(
            w["adam final"]["gap_closed_frac"], abs=1e-4)
    for name, row in got["on_refined_vertices"].items():
        for key in ("mpjpe", "pa_mpjpe"):
            assert abs(row[key] - want["on_refined_vertices"][name][key]) <= NO_SOLVE_MM, name


@pytest.mark.parametrize("num_verts", [64, 6890])
def test_true_regressor_is_the_jax_tool_s(num_verts):
    want = _jax_tool()._true_regressor(num_verts)
    got = recovery.true_regressor(num_verts)
    assert got.dtype == want.dtype and np.array_equal(got, want)
