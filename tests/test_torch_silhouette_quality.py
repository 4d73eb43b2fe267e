"""The port's silhouette quality probe (`jrr_tpu_torch/probes/silhouette_quality.py`
and `probes/quality.py`) against jrr_tpu's tool (`tools/silhouette_quality.py`)
on the CPU.

The tool runs once, in process (loaded by path, its `round` replaced so its
lines are unrounded), at batch 2, 64 vertices, 64², 5 + 4 steps, configs
no_sil, ref_exact_full and r4_shipped_c4, production regime. The same
problem, built by `__graft_entry__._synthetic_problem` with the tool's
arguments and jrr_tpu's discriminators from PRNGKey(7) and PRNGKey(8), is
carried into the port (`convert`), whose `sweep` runs it in both regimes:
the port's own problem draws the body's orientation from numpy, not
jax.random, so it is not jrr_tpu's. Each production row and the init line
are held to the tool's within MM_TOL on mpjpe_mm / vert_mm, MSE_TOL on
sil_mse and one pixel of the union on iou. The no_j3d rows differ from
them only by the j3d weight that `config` sets, which
`test_configs_equal_the_tools` holds for every configuration in both
regimes (against the tool's own `config`, taken from its source). r4_lanepack is
left out of the refinement subset: the port's plain route runs the
lane-packed loss when bins carry a packed layout, jrr_tpu off the TPU the
unpacked twin (tests/test_torch_lane_pack.py holds the two).
"""

import argparse
import ast
import contextlib
import dataclasses
import importlib.util
import io
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from jrr_tpu.models import discriminator as jdisc
from jrr_tpu.models import smpl as jsmpl
from jrr_tpu_torch import convert
from jrr_tpu_torch.probes import quality
from jrr_tpu_torch.probes import silhouette_quality as sq
from jrr_tpu_torch.refine import losses
from test_torch_spin import torch_threads

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOL = os.path.join(ROOT, "tools", "silhouette_quality.py")
BATCH, V, IMAGE, STAGE_A, STAGE_B, BETAS = 2, 64, 64, 5, 4, 0.6
SMALL = ["--batch", str(BATCH), "--num-verts", str(V), "--image", str(IMAGE),
         "--stage-a", str(STAGE_A), "--stage-b", str(STAGE_B)]
CONFIGS = ("no_sil", "ref_exact_full", "r4_shipped_c4")
# Measured when written: ≤ 1.2e-3 mm, ≤ 3e-7 on sil_mse, iou equal.
MM_TOL = 0.01
MSE_TOL = 1e-6
SCORES = ("mpjpe_mm", "vert_mm", "sil_mse", "iou")


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Two torch threads: Tier-1 runs six test processes at once."""
    with torch_threads():
        yield


def load_tool(path, name):
    """A tool loaded by path, its `round` replaced so its lines are unrounded."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.round = lambda x, ndigits=None: x
    return mod


def run_tool(mod, argv):
    """The JSON lines the tool's main() prints for `argv`."""
    out, saved = io.StringIO(), sys.argv
    sys.argv = [mod.__file__] + list(argv)
    try:
        with contextlib.redirect_stdout(out):
            mod.main()
    finally:
        sys.argv = saved
    return [json.loads(line) for line in out.getvalue().splitlines() if line.startswith("{")]


def run_port(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(list(argv) + ["--device", "cpu"])
    return [json.loads(line) for line in out.getvalue().splitlines() if line.startswith("{")]


def carried_problem(batch=BATCH, num_verts=V, image=IMAGE, seed=0, betas=BETAS):
    """jrr_tpu's problem of the tools (and their discriminators) in the port."""
    model, j_reg, cfg0, init, data, _, gt_verts = ge._synthetic_problem(
        batch=batch, num_verts=num_verts, image_size=image, seed=seed, return_gt=True,
        perturb=(0.03, 0.02, betas, 0.05))
    return quality.make_problem(
        convert.smpl_model(model, device="cpu"), torch.as_tensor(np.array(j_reg)),
        convert.refiner_config(cfg0.refiner), convert.frame_params(init, device="cpu"),
        convert.frame_batch(data, device="cpu"), torch.as_tensor(np.array(gt_verts)),
        convert.pose_discriminator(jdisc.init_pose_discriminator(jax.random.PRNGKey(7)),
                                   device="cpu"),
        convert.shape_discriminator(jdisc.init_shape_discriminator(jax.random.PRNGKey(8)),
                                    device="cpu"),
    ), cfg0


def assert_scores_close(got, want, union_pixels):
    """Scores within MM_TOL mm, MSE_TOL, and one pixel of the union on iou."""
    for key in ("mpjpe_mm", "vert_mm"):
        assert abs(got[key] - want[key]) <= MM_TOL, (key, got, want)
    assert abs(got["sil_mse"] - want["sil_mse"]) <= MSE_TOL, (got, want)
    assert abs(got["iou"] - want["iou"]) <= 1.0 / union_pixels, (got, want)


def union_pixels(problem, verts, cam_t):
    """|hard render ∪ mask| of final vertices: the iou's denominator."""
    from jrr_tpu_torch.render import silhouette_fused as sf

    spec = problem.eval_spec
    with torch.no_grad():
        tiles = sf.silhouette_tiles_fused(verts, problem.model, cam_t, spec)
    mask = sf.image_to_tiles(problem.data.mask, spec.tile_size)
    return int(((tiles > 0.5) | (mask > 0.5)).sum())


def _tool_source():
    return ast.parse(open(TOOL).read())


def _literal(node):
    """ast.literal_eval that also reads `dict(k=v, ...)` calls."""
    if isinstance(node, ast.Call) and getattr(node.func, "id", None) == "dict":
        return {kw.arg: ast.literal_eval(kw.value) for kw in node.keywords}
    if isinstance(node, ast.Tuple):
        return tuple(_literal(e) for e in node.elts)
    return ast.literal_eval(node)


def _tool_assignment(name):
    for node in ast.walk(_tool_source()):
        if isinstance(node, ast.Assign) and getattr(node.targets[0], "id", None) == name:
            return node.value
    raise LookupError(name)


def _tool_config(args, cfg0):
    """The tool's own `config` (tools/silhouette_quality.py:155-165), compiled
    from its source with the tool's `args` and `cfg0`."""
    fn = next(n for n in ast.walk(_tool_source())
              if isinstance(n, ast.FunctionDef) and n.name == "config")
    scope = {"dataclasses": dataclasses, "args": args, "cfg0": cfg0}
    exec(compile(ast.Module(body=[fn], type_ignores=[]), TOOL, "exec"), scope)
    return scope["config"]


@pytest.fixture(scope="module")
def runs():
    tool = load_tool(TOOL, "silhouette_quality_under_test")
    want = run_tool(tool, SMALL + ["--configs", *CONFIGS, "--regimes", "production"])
    problem, cfg0 = carried_problem()
    problem = quality.with_steps(problem, STAGE_A, STAGE_B)
    results = {}
    rows = sq.sweep(problem, CONFIGS, None, results=results)
    return want, problem, sq.init_row(problem), rows, results, cfg0


def test_sweeps_equal_the_tools():
    want = [_literal(e) for e in _tool_assignment("all_sweeps").elts]
    assert len(sq.SWEEPS) == len(want) == 21
    for got, w in zip(sq.SWEEPS, want):
        assert got == w, (got, w)
    assert sq.REGIMES == tuple(_literal(e) for e in _tool_assignment("all_regimes").elts)


@pytest.mark.parametrize("regime", [r for r, _ in sq.REGIMES])
def test_configs_equal_the_tools(runs, regime):
    cfg0 = runs[-1]
    tool_config = _tool_config(argparse.Namespace(stage_a=STAGE_A, stage_b=STAGE_B), cfg0)
    j3d_w = dict(sq.REGIMES)[regime]
    base = dataclasses.replace(convert.refiner_config(cfg0.refiner), stage_a_steps=STAGE_A,
                               stage_b_steps=STAGE_B)
    for name, use_sil, blur, stride, extra in sq.SWEEPS:
        got = sq.config(base, use_sil, blur, j3d_w, stride, **extra)
        assert got == convert.refiner_config(tool_config(use_sil, blur, j3d_w, stride, **extra)), name


@pytest.mark.parametrize("config", ("init",) + CONFIGS)
def test_rows_match_jax(runs, config):
    want, problem, init, rows, results, _ = runs
    w = next(r for r in want if r.get("config") == config)
    if config == "init":
        with torch.no_grad():
            verts = losses.forward_frame(problem.model, problem.init).vertices
        got, cam_t = init, problem.init.cam_t
    else:
        got = next(r for r in rows if r["regime"] == "production" and r["config"] == config)
        res = results[("production", config)]
        verts, cam_t = res.vertices, res.params.cam_t
        assert w["regime"] == "production" and w["blur_radius"] == got["blur_radius"]
    assert_scores_close(got, w, union_pixels(problem, verts, cam_t))


def test_sweep_runs_both_regimes(runs):
    """The no_j3d rows: finite, and apart from the production rows wherever
    j3d weighs in (no_sil always)."""
    rows = runs[3]
    names = [s[0] for s in sq.SWEEPS if s[0] in CONFIGS]
    assert [(r["regime"], r["config"]) for r in rows] == [
        (regime, name) for regime, _ in sq.REGIMES for name in names]
    for r in rows:
        assert all(np.isfinite(r[k]) for k in SCORES + ("seconds",)), r
    by = {(r["regime"], r["config"]): r for r in rows}
    assert by[("no_j3d", "no_sil")]["vert_mm"] != by[("production", "no_sil")]["vert_mm"]
    lines = sq.summary(rows)
    assert [s["summary"] for s in lines] == ["production", "no_j3d"]
    for s in lines:
        assert s["helps"] == (s["best_vert_mm"] < s["no_sil_vert_mm"])


def test_main_prints_the_tools_keys(runs):
    """The port's lines at the tool's arguments: the same lines, keys and
    order as the tool's."""
    want = runs[0]
    got = run_port(sq.main, SMALL + ["--configs", *CONFIGS, "--regimes", "production"])
    assert [list(line) for line in got] == [list(line) for line in want]
    assert [line.get("config", line.get("summary")) for line in got] == [
        line.get("config", line.get("summary")) for line in want]


def test_thin_vertex_mm_matches_jax_formula():
    """`thin_vertex_mm` against the tool's `_thin_err` formula on fixed
    arrays (rtol 1e-6: float32 means of the same 30 norms)."""
    rng = np.random.default_rng(3)
    verts, gt = (rng.normal(size=(3, 50, 3)).astype(np.float32) for _ in range(2))
    idx = np.sort(rng.choice(50, size=10, replace=False))
    want = float(jnp.mean(jnp.linalg.norm(jnp.asarray(verts)[:, idx] - jnp.asarray(gt)[:, idx],
                                          axis=-1)) * 1000.0)
    got = quality.thin_vertex_mm(torch.as_tensor(verts), torch.as_tensor(gt), torch.as_tensor(idx))
    assert got == pytest.approx(want, rel=1e-6)


def test_thin_appendage_body_adds_its_column():
    """`--thin-appendage-radius` builds jrr_tpu's thin body (the same
    appendage vertices) and adds vert_mm_thin to the init line and each row."""
    _, aux = jsmpl.synthetic_smpl_model(seed=0, num_verts=V, thin_appendage_radius=0.01,
                                        return_aux=True)
    from jrr_tpu_torch.models import smpl

    _, taux = smpl.synthetic_smpl_model(seed=0, num_verts=V, thin_appendage_radius=0.01,
                                        return_aux=True, device="cpu")
    np.testing.assert_array_equal(np.asarray(taux["appendage_verts"]),
                                  np.asarray(aux["appendage_verts"]))
    lines = run_port(sq.main, SMALL + ["--configs", "no_sil", "--regimes", "production",
                                       "--thin-appendage-radius", "0.01"])
    assert [line.get("config") for line in lines[:2]] == ["init", "no_sil"]
    for line in lines[:2]:
        assert np.isfinite(line["vert_mm_thin"]) and line["vert_mm_thin"] > 0


def test_unknown_names_raise():
    with pytest.raises(ValueError, match="unknown names"):
        sq.main(SMALL + ["--configs", "no_such", "--device", "cpu"])
