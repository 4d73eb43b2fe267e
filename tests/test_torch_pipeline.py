"""The port's product loop (jrr_tpu_torch.pipeline.run_pipeline) against
jrr_tpu's on the CPU, and its port-only behavior.

Both packages run `run_pipeline(demo=True)` on one fixture directory written
by JAX (batch 4, 8 frames, the demo's 256-vertex body), the port starting
from JAX's initial TrainState (carried across with `convert.train_state`).
JAX runs its sharded outer step over the CPU devices of tests/conftest.py,
the port one device, so sums are reordered. Tolerances:
- the initial regressor: equal (the same numpy draws);
- without the silhouette (stage A 30, stage B 15): refined parameters and
  joints 1e-4, the Adam-path regressor 1e-5 relative in norm, the lstsq
  regressor 2.5e-3 absolute (JAX solves in float32, the port in float64:
  on one accumulator the two solves differ by 1.2e-3, the two runs' fits
  by 1.0e-3), the initial and
  Adam-path evals 1e-3 mm, the lstsq eval 0.05 mm;
- with the silhouette at a pooled 112² and 3 stage-B steps: refined
  parameters 1e-3, the evals 0.05 mm. This is JAX's float32 spread (ROADMAP
  Queue 3): on the first batch, JAX's float32 refinement lies 1.6e-4 from
  its float64 one, the port's 1.3e-5 from its own, and the two float64
  refinements 1.4e-7 apart (interior skip off: JAX's float64 path does not
  run with it); over the two outer steps the float32 gap reaches 4.8e-4.
  tests/torch_pipeline_report.py measures these numbers;
- with SPIN initialization (a numpy-seeded SPIN checkpoint whose heads sit
  near the mean parameters) and the VIBE consumer (GRU hidden 8, seqlen 2),
  without the silhouette: refined parameters 1e-4 (the report measures
  1.2e-5), the Adam-path regressor 1e-5 relative, the protocol-2 and both
  consumer evals 1e-3 mm (8.4e-5).
Each configuration runs once per module (`runs`); the tests share it.

Port-only, on the demo fixtures as the port writes them (faster to read,
and the same otherwise but for the poses' draws): a second run resumes
both shards (by replay, or from the
accumulator checkpoint; with SPIN initialization too, consumer evals
included) with no outer step and the same regressors and evals; a changed
data order, a failing shard writer and a failing loader raise; unported
options (the native loader, more than one device) raise
NotImplementedError; the CLI runs the demo on the CPU and refuses a missing
card. chip_smoke.py's holds of the kernels on
the product path's own inputs: the bounds of coverage decisions at their
thresholds on constructed tiles, and the gradient entries a flip reaches.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jrr_tpu import config as jcfg_lib
from jrr_tpu import pipeline as jpipeline
from jrr_tpu.evals import harness as jharness
from jrr_tpu.refine import trainer as jtrainer
from jrr_tpu_torch import config as cfg_lib
from jrr_tpu_torch import convert
from jrr_tpu_torch import pipeline
from jrr_tpu_torch.refine import trainer

from tests.test_torch_consumers import gen_state_dict
from tests.test_torch_spin import _few_threads, write_spin_checkpoint  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARAMS = ("pose6d", "orient6d", "betas", "cam_t", "joints3d")


def _jax_cfg(use_silhouette, stage_b, image_size=224):
    return jcfg_lib.PipelineConfig(
        refiner=dataclasses.replace(
            jcfg_lib.RefinerConfig(), stage_a_steps=30, stage_b_steps=stage_b,
            use_silhouette=use_silhouette, use_discriminators=True,
            silhouette=jcfg_lib.SilhouetteConfig(image_size=image_size),
        ),
        data=jcfg_lib.DataConfig(batch_size=4),
    )


def _jax_lstsq_eval(arts, data_root, cfg):
    """JAX's eval of its lstsq regressor (printed, not returned, by its run)."""
    from jrr_tpu.data import h36m as jh36m
    from jrr_tpu.models import smpl as jsmpl

    loader = jh36m.BatchLoader(jh36m.H36MDataset(data_root), cfg.data.batch_size,
                               seed=cfg.data.shuffle_seed, drop_last=True)
    preds = [
        {"pose6d": np.concatenate([b["orient"].reshape(-1, 1, 6), b["pose"]], axis=1),
         "betas": b["betas"], "gt_j3d": b["gt_j3d"]}
        for b in loader
    ]
    model = jsmpl.synthetic_smpl_model(seed=cfg.seed, num_verts=256, num_faces=500)
    (res,) = jharness.evaluate_regressors(model, preds, [arts.j_reg_lstsq])
    return res


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    """The fixture directory JAX's demo writes (8 frames, seed 0)."""
    from jrr_tpu.data import fixtures as jfixtures
    from jrr_tpu.models import smpl as jsmpl

    root = str(tmp_path_factory.mktemp("fixtures"))
    model = jsmpl.synthetic_smpl_model(seed=0, num_verts=256, num_faces=500)
    j_true = pipeline._demo_regressor(model.num_verts, np.random.default_rng(0))
    jfixtures.write_fixture_dataset(root, num_frames=8, seed=0, model=model, j_reg_raw=j_true)
    return root


@pytest.fixture(scope="module")
def port_root(tmp_path_factory):
    """The same demo fixtures written by the port (its own PNG writer reads
    back ~6× faster than imageio's filtered rows), for the port-only tests."""
    from jrr_tpu_torch.data import fixtures
    from jrr_tpu_torch.models import smpl

    root = str(tmp_path_factory.mktemp("port_fixtures"))
    model = smpl.synthetic_smpl_model(seed=0, num_verts=256, num_faces=500, device="cpu")
    j_true = pipeline._demo_regressor(model.num_verts, np.random.default_rng(0))
    return fixtures.write_fixture_dataset(root, num_frames=8, seed=0, model=model,
                                          j_reg_raw=j_true, device="cpu")


def _run_both(tmp_path, monkeypatch, jcfg, data_root, **options):
    """Both packages' run_pipeline(demo=True, **options) on `data_root`, the
    port from JAX's initial TrainState; with JAX's lstsq eval when the
    stored estimates initialize the run."""
    jarts = jpipeline.run_pipeline(jcfg, data_root=data_root, out_dir=str(tmp_path / "jax"),
                                   demo=True, **options)
    tcfg = convert.pipeline_config(jcfg)

    def jax_initial_state(j_reg_init, cfg, seed=0):
        state = jtrainer.init_train_state(
            jax.random.PRNGKey(seed), jnp.asarray(j_reg_init.numpy()), jcfg
        )
        return convert.train_state(state, cfg, device="cpu")

    monkeypatch.setattr(trainer, "init_train_state", jax_initial_state)
    arts = pipeline.run_pipeline(tcfg, data_root=data_root, out_dir=str(tmp_path / "port"),
                                 demo=True, device="cpu", **options)
    jlstsq = None if "spin_checkpoint" in options else _jax_lstsq_eval(jarts, data_root, jcfg)
    return jarts, arts, jlstsq


@pytest.fixture(scope="module")
def consumer_files(tmp_path_factory):
    """A SPIN checkpoint (heads near the mean parameters) and a VIBE
    gen_state_dict (GRU hidden 8), as tests/test_torch_consumers.py makes them."""
    root = tmp_path_factory.mktemp("consumer_files")
    vibe = str(root / "vibe.pth.tar")
    torch.save({"gen_state_dict": gen_state_dict("vibe"), "performance": np.float64(56.5)}, vibe)
    return {"spin_checkpoint": write_spin_checkpoint(str(root / "spin.pt"), head_scale=1e-3),
            "vibe_checkpoint": vibe}


@pytest.fixture(scope="module")
def runs(data_root, consumer_files, tmp_path_factory):
    """`_run_both` once per configuration for the whole module: stored
    estimates without and with the silhouette, and SPIN initialization with
    the VIBE consumer (seqlen 2) without it."""
    configs = {
        "no_silhouette": (_jax_cfg(False, 15), {}),
        "silhouette_112": (_jax_cfg(True, 3, image_size=112), {}),
        "spin_vibe": (_jax_cfg(False, 15), dict(consumer_files, consumer_seqlen=2)),
    }
    done = {}

    def run(name):
        if name not in done:
            jcfg, options = configs[name]
            with pytest.MonkeyPatch.context() as mp:
                done[name] = _run_both(tmp_path_factory.mktemp(name), mp, jcfg, data_root,
                                       **options)
        return done[name]

    return run


def _shards(out_dir):
    out = []
    for sid in (0, 1):
        with np.load(os.path.join(out_dir, "refined", f"shard_{sid:06d}.npz")) as f:
            out.append(dict(f))
    return out


def _close_rel(got, want, rel):
    err = np.linalg.norm(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    assert err <= rel * np.linalg.norm(want), (err, np.linalg.norm(want))


def _assert_evals(arts, jarts, jlstsq, tol_adam, tol_lstsq):
    pairs = (
        (arts.eval_before_after.before, jarts.eval_before_after.before, tol_adam),
        (arts.eval_before_after.after, jarts.eval_before_after.after, tol_adam),
        (arts.eval_lstsq, jlstsq, tol_lstsq),
    )
    for got, want, tol in pairs:
        assert got.num_frames == want.num_frames == 8
        np.testing.assert_allclose(got.mpjpe, want.mpjpe, atol=tol)
        np.testing.assert_allclose(got.pa_mpjpe, want.pa_mpjpe, atol=tol)


def test_pipeline_matches_jax_without_silhouette(runs):
    jarts, arts, jlstsq = runs("no_silhouette")
    np.testing.assert_array_equal(arts.j_reg_initial, jarts.j_reg_initial)
    for got, want in zip(_shards(arts.out_dir), _shards(jarts.out_dir)):
        np.testing.assert_array_equal(got["gt_j3d"], want["gt_j3d"])
        for k in PARAMS:
            np.testing.assert_allclose(got[k], want[k], atol=1e-4, err_msg=k)
    _close_rel(arts.j_reg_final, jarts.j_reg_final, 1e-5)
    np.testing.assert_allclose(arts.j_reg_lstsq, jarts.j_reg_lstsq, atol=2.5e-3)
    _assert_evals(arts, jarts, jlstsq, 1e-3, 0.05)
    assert arts.eval_before_after.summary().count("\n") == jarts.eval_before_after.summary().count("\n")


def test_pipeline_matches_jax_with_silhouette(runs):
    jarts, arts, jlstsq = runs("silhouette_112")
    np.testing.assert_array_equal(arts.j_reg_initial, jarts.j_reg_initial)
    for got, want in zip(_shards(arts.out_dir), _shards(jarts.out_dir)):
        for k in PARAMS:
            np.testing.assert_allclose(got[k], want[k], atol=1e-3, err_msg=k)
    _assert_evals(arts, jarts, jlstsq, 0.05, 0.05)


def _port_cfg(**refiner):
    return cfg_lib.PipelineConfig(
        refiner=dataclasses.replace(
            cfg_lib.RefinerConfig(), stage_a_steps=4, stage_b_steps=2,
            silhouette=cfg_lib.SilhouetteConfig(image_size=56), **refiner,
        ),
        jreg=cfg_lib.JRegConfig(snapshot_interval=1),
        data=cfg_lib.DataConfig(batch_size=4),
    )


def _port_run(cfg, data_root, out_dir, **kw):
    return pipeline.run_pipeline(cfg, data_root=data_root, out_dir=out_dir, demo=True,
                                 device="cpu", **kw)


def _no_outer_step(*args, **kwargs):
    raise AssertionError("a resumed shard ran outer_step")


@pytest.mark.parametrize("via", ["replay", "acc_checkpoint"])
def test_resume_skips_completed_shards(tmp_path, monkeypatch, port_root, via):
    """The second run refines nothing and gives the same regressors and evals,
    bit for bit: the replayed vertices are the refinement's own."""
    if via == "acc_checkpoint":
        monkeypatch.setattr(pipeline, "ACC_CKPT_EVERY", 1)
    out = str(tmp_path / "run")
    first = _port_run(_port_cfg(), port_root, out)
    assert sorted(os.listdir(os.path.join(out, "jreg_snapshots"))) == [
        "snap_00000.npz", "snap_00001.npz"]
    assert os.listdir(os.path.join(out, "ckpt")) == ["state_00000002.npz"]
    if via == "acc_checkpoint":
        with np.load(os.path.join(out, "jreg_acc_ckpt.npz")) as f:
            assert int(f["upto"]) == 1 and float(f["count"]) == 8
    monkeypatch.setattr(trainer, "outer_step", _no_outer_step)
    second = _port_run(_port_cfg(), port_root, out)
    np.testing.assert_array_equal(second.j_reg_lstsq, first.j_reg_lstsq)
    np.testing.assert_array_equal(second.j_reg_final, first.j_reg_final)
    assert second.eval_before_after == first.eval_before_after
    assert second.eval_lstsq == first.eval_lstsq


def test_resume_refuses_another_data_order(tmp_path, port_root):
    out = str(tmp_path / "run")
    _port_run(_port_cfg(use_silhouette=False), port_root, out)
    other = _port_cfg(use_silhouette=False)
    other = dataclasses.replace(other, data=dataclasses.replace(other.data, shuffle_seed=1))
    with pytest.raises(ValueError, match="saved gt_j3d does not match"):
        _port_run(other, port_root, out)


def test_pipeline_with_spin_and_vibe_matches_jax(runs):
    """SPIN initialization (the network on each batch's crops, main thread)
    and the VIBE consumer evals, frame-level and over real sequences."""
    jarts, arts, _ = runs("spin_vibe")
    for got, want in zip(_shards(arts.out_dir), _shards(jarts.out_dir)):
        for k in PARAMS:
            np.testing.assert_allclose(got[k], want[k], atol=1e-4, err_msg=k)
    _close_rel(arts.j_reg_final, jarts.j_reg_final, 1e-5)
    for got, want in ((arts.eval_before_after.before, jarts.eval_before_after.before),
                      (arts.eval_before_after.after, jarts.eval_before_after.after)):
        np.testing.assert_allclose([got.mpjpe, got.pa_mpjpe], [want.mpjpe, want.pa_mpjpe],
                                   atol=1e-3)
    assert sorted(arts.consumer_evals) == sorted(jarts.consumer_evals) == ["vibe",
                                                                         "vibe (sequence)"]
    for kind, want in jarts.consumer_evals.items():
        got = arts.consumer_evals[kind]
        for g, w in ((got.before, want.before), (got.after, want.after)):
            assert g.num_frames == w.num_frames > 0
            np.testing.assert_allclose([g.mpjpe, g.pa_mpjpe], [w.mpjpe, w.pa_mpjpe], atol=1e-3)
    assert {"consumer_frame", "consumer_sequence"} <= set(arts.seconds)


def test_pipeline_spin_init_differs_from_the_stored_estimates(runs):
    """The shards start from SPIN's estimates: near the mean camera's depth
    (2·5000 / (224·0.9) ≈ 50 m for these near-mean heads), not the stored
    fixtures' 18-28 m."""
    _, arts, _ = runs("spin_vibe")
    first = _shards(arts.out_dir)[0]
    assert np.all(first["cam_t"][:, 2] > 30.0)


def test_resume_with_spin_repeats_bit_for_bit(runs, monkeypatch, consumer_files, data_root):
    """A second port run on the same out dir resumes both shards (no outer
    step, no SPIN on a resumed shard) and repeats the regressors and every
    eval, the consumer evals included."""
    _, first, _ = runs("spin_vibe")
    monkeypatch.setattr(trainer, "outer_step", _no_outer_step)
    cfg = convert.pipeline_config(_jax_cfg(False, 15))
    second = pipeline.run_pipeline(cfg, data_root=data_root, out_dir=first.out_dir, demo=True,
                                   device="cpu", consumer_seqlen=2, **consumer_files)
    np.testing.assert_array_equal(second.j_reg_final, first.j_reg_final)
    np.testing.assert_array_equal(second.j_reg_lstsq, first.j_reg_lstsq)
    assert second.eval_before_after == first.eval_before_after
    assert second.consumer_evals == first.consumer_evals


def test_a_failing_shard_writer_stops_the_run(tmp_path, monkeypatch, port_root):
    def broken(self, shard_id, arrays):
        raise OSError("disk full")

    monkeypatch.setattr(pipeline.ckpt_lib.ShardManifest, "write_shard", broken)
    with pytest.raises(RuntimeError, match="async shard writer failed") as info:
        _port_run(_port_cfg(use_silhouette=False), port_root, str(tmp_path / "run"))
    assert isinstance(info.value.__cause__, OSError)


def test_a_failing_loader_stops_the_run(tmp_path, port_root):
    from jrr_tpu_torch.data import h36m
    from jrr_tpu_torch.models import smpl

    cfg = _port_cfg(use_silhouette=False)
    batches = list(h36m.BatchLoader(h36m.H36MDataset(port_root), 4, drop_last=True))

    def source():
        yield batches[0]
        raise OSError("frame unreadable")

    model = smpl.synthetic_smpl_model(seed=0, num_verts=256, num_faces=500, device="cpu")
    with pytest.raises(OSError, match="frame unreadable"):
        pipeline.run_optimize(cfg, model, np.full((17, 256), 1.0, np.float32), source(),
                              str(tmp_path / "run"))


def test_outside_the_demo_an_initial_regressor_is_required(tmp_path):
    with pytest.raises(ValueError, match="jreg-init"):
        pipeline.run_pipeline(cfg_lib.PipelineConfig(), data_root=str(tmp_path),
                              out_dir=str(tmp_path / "out"), device="cpu")


@pytest.mark.parametrize("option", ["loader_native", "loader_auto_pack", "mesh"])
def test_unported_options_raise(tmp_path, port_root, option):
    import shutil

    cfg, kw, root = _port_cfg(use_silhouette=False), {}, port_root
    if option == "loader_native":
        kw["loader"] = "native"
    elif option == "loader_auto_pack":
        root = str(tmp_path / "fixtures")
        shutil.copytree(port_root, root)
        open(os.path.join(root, "precomputed_val", "frames.jrrpack"), "w").close()
    else:
        cfg = dataclasses.replace(cfg, mesh=cfg_lib.MeshConfig(num_devices=2))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        _port_run(cfg, root, str(tmp_path / "run"), **kw)


def test_cli_demo_runs_on_the_cpu(tmp_path, port_root):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-m", "jrr_tpu_torch.cli", "--demo", "--device", "cpu",
         "--data-root", port_root, "--out", str(tmp_path / "out"),
         "--stage-a-steps", "3", "--stage-b-steps", "2", "--batch-size", "4"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert "MPJPE" in proc.stdout and "\nafter\nMPJPE\n" in proc.stdout
    assert "after (lstsq fit)" in proc.stdout
    with open(tmp_path / "out" / "metrics.jsonl") as f:
        assert len(f.readlines()) == 2  # one record per shard


def test_cli_default_device_needs_a_card(tmp_path, monkeypatch):
    from jrr_tpu_torch import cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["--demo", "--out", str(tmp_path / "out")])
    assert not os.path.exists(tmp_path / "out" / "fixtures")


def _one_tile(corners, origin, blur_px2):
    """One tile of chip_smoke's round-1 layout holding one valid triangle."""
    tri = torch.zeros(1, 6, 128)
    tri[0, :, 0] = torch.tensor(corners, dtype=torch.float32)
    valid = torch.zeros(1, 1, 128)
    valid[0, 0, 0] = 1.0
    return torch.tensor([origin], dtype=torch.float32), tri, valid, 4, 0.8, blur_px2


@pytest.mark.parametrize("case", ["blur_band_edge", "inside_test_edge"])
def test_decision_flip_bounds(case):
    """chip_smoke's holds on the product path's inputs: pixels whose
    coverage decision lies at its threshold (sd2 = blur_px2 exactly; a
    cross product 4 ulp from 0 with blur band 0) get bounds spanning both
    outcomes, the pixels far from every threshold equal bounds; α inside
    the bounds passes, beyond them fails."""
    import chip_smoke
    from jrr_tpu_torch.render import silhouette_pallas as sp

    if case == "blur_band_edge":  # edge y = 0.5 under row 1 of the tile: d² = 0.25 = blur_px2
        args = _one_tile([-8.0, 0.5, 8.0, 0.5, 0.0, -8.0], [0.0, 0.0], 0.25)
        pixels, jump = [4, 5, 6, 7], float(torch.sigmoid(torch.tensor(-0.25 * 0.8)))
        want_kind = 2
    else:  # the tile's diagonal lies 2⁻¹⁸ px above the edge (0, 0)-(16, 16)
        args = _one_tile([0.0, 0.0, 16.0, 16.0, 16.0, 0.0], [8.0, 8.0 + 2.0 ** -18], 0.0)
        pixels, jump, want_kind = [0, 5, 10, 15], 0.5, 1
    lo, hi, kind = chip_smoke._edge_flip_bounds(*args)
    plain = sp.tiles_alpha_plain(*args)
    np.testing.assert_allclose((hi - lo)[0, pixels].numpy(), jump, rtol=1e-5)
    others = torch.ones(16, dtype=torch.bool)
    others[pixels] = False
    assert torch.equal(lo[0, others], hi[0, others])
    assert torch.all((lo <= plain) & (plain <= hi))
    flipped = torch.where(plain == lo, hi, lo)  # every edge pixel decided the other way
    assert all(int(k) & want_kind for k in kind[0, pixels])
    report, edge = chip_smoke._hold_within_flips(flipped, plain, (lo, hi, kind), "case",
                                                 lambda: sp.tiles_alpha_plain(*args))
    assert torch.equal(edge[0], ~others)
    assert (report["edge_pixels"], report["flips"], report["flips_kernel_nearer_f64"]) == (4, 4, 0)
    assert report["flips_inside_test" if want_kind == 1 else "flips_blur_edge"] == 4
    assert report["flip_max_abs_diff"] == pytest.approx(jump, rel=1e-5)
    for pixel in (pixels[0], int(torch.nonzero(others)[0])):  # an edge pixel, another
        beyond = plain.clone()
        beyond[0, pixel] = hi[0, pixel] + 1e-3
        with pytest.raises(AssertionError, match="outside the bounds"):
            chip_smoke._hold_within_flips(beyond, plain, (lo, hi, kind), "case")


def test_flip_reach_marks_the_corners_of_edge_tiles():
    """chip_smoke._flip_reach: the table entries of every corner of every
    candidate of a tile that holds a decision-edge pixel, and no others."""
    import chip_smoke

    pages = torch.tensor([[[2, 0], [1, 2]]], dtype=torch.int32)  # (B=1, G²=2, P̂=2)
    idx = torch.tensor([[[[3, 130]] * 3, [[5, 129]] * 3]], dtype=torch.int32)  # (1, 2, 3, K=2)
    idx[0, 1, 2, 1] = 7  # slot 0 (page 1), lane 7
    reach = chip_smoke._flip_reach(pages, idx, torch.tensor([[False, True]]), (1, 3, 128))
    want = torch.zeros(1, 3 * 128, dtype=torch.bool)
    want[0, [1 * 128 + 5, 2 * 128 + 1, 1 * 128 + 7]] = True
    assert torch.equal(reach.reshape(1, -1), want)
