"""The port's coarse-to-fine probe (`jrr_tpu_torch/probes/c2f_probe.py`)
against jrr_tpu's tool (`tools/c2f_probe.py`) on the CPU.

The tool runs once, in process (loaded by path, `round` replaced), at batch
2, 64 vertices, 64², 5 + 4 steps: control_single_res and c2f_frac0.5_f2
(its coarse half at 32², the floor lowered to reach it). jrr_tpu's problem
of that call is carried into the port (test_torch_silhouette_quality's
`carried_problem`), whose `measure` runs the same two configurations: the
scores within the quality test's tolerances, the rasterizer's capacity
counters equal. The three-level chain runs on the port only, through
`main --sweep` (jrr_tpu's tool runs it only after three more variants,
beyond this file's time).
"""

import os

import numpy as np
import pytest

from jrr_tpu_torch.probes import c2f_probe, quality
from test_torch_silhouette_quality import (IMAGE, SMALL, STAGE_A, STAGE_B,
                                           assert_scores_close, carried_problem, load_tool,
                                           run_port, run_tool, union_pixels)
from test_torch_spin import torch_threads

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOL = os.path.join(ROOT, "tools", "c2f_probe.py")
RUNS = ("control_single_res", "c2f_frac0.5_f2")
STATS = ("truncated_tiles", "span_clipped", "dropped_slots", "max_faces_per_tile")


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    with torch_threads():
        yield


@pytest.fixture(scope="module")
def runs():
    want = run_tool(load_tool(TOOL, "c2f_probe_under_test"), SMALL)
    problem, _ = carried_problem()
    problem = quality.with_steps(problem, STAGE_A, STAGE_B)
    got = {
        "control_single_res": c2f_probe.measure(
            problem, "control_single_res",
            c2f_probe.rcfg(problem.cfg, STAGE_A, STAGE_B, coarse_frac=0.0)),
        "c2f_frac0.5_f2": c2f_probe.measure(
            problem, "c2f_frac0.5_f2", c2f_probe.c2f_config(problem.cfg, IMAGE, 0.5, 2)),
    }
    return {w["run"]: w for w in want}, got, problem


@pytest.mark.parametrize("run", RUNS)
def test_runs_match_jax(runs, run):
    want, got, problem = runs
    line, res = got[run]
    assert_scores_close(line, want[run], union_pixels(problem, res.vertices, res.params.cam_t))
    for key in STATS:
        assert line[key] == want[run][key], (key, line, want[run])


def test_c2f_ran_a_coarse_phase(runs):
    """`c2f_config` lowers the coarse floor to image // factor, so at 64²
    the c2f run takes the coarse path (32²) and parts from the control."""
    _, got, _ = runs
    control, c2f = got["control_single_res"][1], got["c2f_frac0.5_f2"][1]
    assert c2f.stage_b_terms.silhouette.shape == control.stage_b_terms.silhouette.shape == (STAGE_B,)
    assert not np.allclose(c2f.params.betas.numpy(), control.params.betas.numpy())


def test_main_prints_the_tools_keys_and_runs_the_sweep(runs):
    """`main` at the tool's arguments prints the tool's lines and keys;
    `--sweep` adds the other variants and the chain."""
    want = list(runs[0].values())
    lines = run_port(c2f_probe.main, SMALL + ["--sweep"])
    assert [list(line) for line in lines[:2]] == [list(line) for line in want]
    assert [line["run"] for line in lines] == list(RUNS) + [
        "c2f_frac0.7_f2", "c2f_frac0.5_f4", f"c2f_3level_{IMAGE // 4}_{IMAGE // 2}_{IMAGE}"]
    for line in lines:
        assert all(np.isfinite(line[k]) for k in ("mpjpe_mm", "vert_mm", "sil_mse", "iou"))
        assert all(key in line for key in STATS)
    assert "exec_seconds" not in lines[-1]


def test_three_level_chain_phases(runs, monkeypatch):
    """Each phase of the chain starts from the previous one's params, at
    image/4, image/2 and the full image: 35%, 35% and the rest of stage B,
    stage A in the first only."""
    problem = quality.with_steps(runs[2], STAGE_A, 10)
    b = problem.init.cam_t.shape[0]
    seen = []
    real = quality.refine

    def spy(p, cfg, init=None):
        seen.append((cfg.stage_a_steps, cfg.stage_b_steps, cfg.silhouette.image_size,
                     cfg.silhouette.tile_size, cfg.silhouette.bin_margin_px,
                     tuple(p.data.mask.shape), init))
        return real(p, cfg, init)

    monkeypatch.setattr(quality, "refine", spy)
    line, _ = c2f_probe.three_level(problem, IMAGE)
    tile, margin = problem.cfg.silhouette.tile_size, problem.cfg.silhouette.bin_margin_px
    assert [s[:6] for s in seen] == [
        (STAGE_A, 3, IMAGE // 4, tile // 4, margin / 4, (b, IMAGE // 4, IMAGE // 4)),
        (0, 3, IMAGE // 2, tile // 2, margin / 2, (b, IMAGE // 2, IMAGE // 2)),
        (0, 4, IMAGE, tile, margin, (b, IMAGE, IMAGE)),
    ]
    assert seen[0][6] is problem.init and seen[1][6] is not None
    assert line["run"] == f"c2f_3level_{IMAGE // 4}_{IMAGE // 2}_{IMAGE}"
    assert seen[2][6] is not seen[1][6] and np.isfinite(line["vert_mm"])
