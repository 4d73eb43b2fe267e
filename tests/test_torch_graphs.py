"""The refinement engine's CUDA-graph structure, held on the CPU:

- (a) the engine's Adam with its step count on the device equals the one
  with a Python int count bit for bit (float32 and float64), and follows
  `optax.adam` over 200 steps on numpy-seeded gradients (1e-5 abs);
- (b) `engine.disable_graphs()` nests and restores its depth, on return
  and on an exception, and is inert on the CPU;
- (c) the launch accounting of a capture: the wrappers' calls inside
  `kernels.captured_launches` net zero, and each replay of a
  `profiling.CapturedCall` adds the graph's counts;
- (d) `profiling.log_compile_time` refuses CPU tensors;
- (e) `refine_batch` on the golden scene's body and silhouette settings
  with 20 stage-B steps at rebin 5
  (four chunks, so the static bins are copied into three times), stride 2
  with a warm stride of 4 over the first half (four stage-B kinds) and
  the hand and foot joints frozen, against jrr_tpu's
  `refine_batch` at the golden tolerances (atol 5e-4 on params and
  joints3d, 1e-4 on the stage-B curve, as tests/test_torch_refine.py, plus
  1e-5 relative on the curve, whose warm steps scale the silhouette ×4);
- (f) the same call with the step runner in capture mode and a stand-in
  for the capture whose "graph" calls the closure again: each kind of step
  is captured once after its first step and replayed for the rest, and the
  result equals the eager run's bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from jrr_tpu import config as cfg_lib
from jrr_tpu.models import smpl as smpl_mod
from jrr_tpu.refine import engine
from jrr_tpu_torch import convert, kernels
from jrr_tpu_torch.ops import jreg as tjreg
from jrr_tpu_torch.ops import rotations as trot
from jrr_tpu_torch.refine import engine as tengine
from jrr_tpu_torch.refine import losses as tlosses
from jrr_tpu_torch.render import silhouette as tsil
from jrr_tpu_torch.utils import profiling
from test_torch_spin import torch_threads

PARAMS = ("pose6d", "orient6d", "betas", "cam_t")


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Torch on few threads: Tier-1 runs six test processes at once, and
    small refinements on every core in each crawled (as in
    test_torch_spin.py)."""
    with torch_threads():
        yield


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_device_count_adam_matches_the_int_count_and_optax(dtype):
    rng = np.random.default_rng(0)
    p0 = rng.normal(size=(256, 3)).astype(np.float32)
    grads = rng.normal(size=(200, 256, 3)).astype(np.float32)

    runs = []
    for device_count in (True, False):
        p = torch.tensor(p0, dtype=dtype)
        adam = tengine._Adam([p], 0.01, device_count=device_count)
        for g in grads:
            adam.step([p], [torch.tensor(g, dtype=dtype)])
        assert float(adam.count) == 200 and torch.is_tensor(adam.count) == device_count
        runs.append(p)
    assert torch.equal(runs[0], runs[1])

    opt = optax.adam(0.01)
    params = jnp.asarray(p0)
    state = opt.init(params)
    for g in grads:
        updates, state = opt.update(jnp.asarray(g), state, params)
        params = optax.apply_updates(params, updates)
    # optax rounds 1 − b^count to float32 before dividing; the engine keeps
    # it in float64 until the division (4.29e-6 apart after 200 steps).
    np.testing.assert_allclose(runs[0].numpy(), np.asarray(params), atol=1e-5, rtol=0)


def test_disable_graphs_nests_and_is_inert_on_the_cpu():
    cuda = torch.device("cuda")
    assert tengine._graphs_off.depth == 0
    assert tengine._Steps(cuda).capture and not tengine._Steps(torch.device("cpu")).capture
    with tengine.disable_graphs():
        with tengine.disable_graphs():
            assert tengine._graphs_off.depth == 2
        assert tengine._graphs_off.depth == 1 and not tengine._Steps(cuda).capture
    assert tengine._graphs_off.depth == 0 and tengine._Steps(cuda).capture
    with pytest.raises(KeyError):
        with tengine.disable_graphs():
            raise KeyError("inside")
    assert tengine._graphs_off.depth == 0

    from jrr_tpu_torch import problem

    model, j_reg, cfg, init, data = problem.synthetic_problem(
        batch=1, num_verts=96, image_size=32, device="cpu")
    cfg = dataclasses.replace(cfg, stage_a_steps=3, stage_b_steps=4)
    eager = tengine.refine_batch(model, j_reg, init, data, cfg)
    with tengine.disable_graphs():
        again = tengine.refine_batch(model, j_reg, init, data, cfg)
    for a, b in zip(eager.params + (eager.stage_a_loss, eager.stage_b_terms.total),
                    again.params + (again.stage_a_loss, again.stage_b_terms.total)):
        assert torch.equal(a, b)


class _FakeGraph:
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


def test_capture_launch_accounting():
    saved = {w: w.launches for w in kernels.WRAPPERS}
    try:
        kernels.reset_launches()
        kernels.fused_alpha_fwd.launches = 2  # counted before the capture
        with kernels.captured_launches() as counts:
            kernels.fused_lossgrad.launches += 3
            kernels.tiles_alpha_fwd.launches += 1
        assert counts == {kernels.fused_lossgrad: 3, kernels.tiles_alpha_fwd: 1}
        assert {w.__name__: w.launches for w in kernels.WRAPPERS if w.launches} == {
            "fused_alpha_fwd": 2}
        graph = _FakeGraph()
        call = profiling.CapturedCall(graph, counts)
        call.replay()
        call.replay()
        assert graph.replays == 2
        assert (kernels.fused_lossgrad.launches, kernels.tiles_alpha_fwd.launches,
                kernels.fused_alpha_fwd.launches) == (6, 2, 2)
        # A capture that fails leaves the counts as they were.
        with pytest.raises(RuntimeError):
            with kernels.captured_launches():
                kernels.fused_lossgrad.launches += 5
                raise RuntimeError("capture failed")
        assert kernels.fused_lossgrad.launches == 6
    finally:
        for w, n in saved.items():
            w.launches = n


def test_log_compile_time_refuses_cpu_tensors():
    x = torch.zeros(3)
    with pytest.raises(ValueError, match="cpu"):
        profiling.log_compile_time(lambda t: t.add_(1.0), x)
    with pytest.raises(ValueError, match="CUDA"):
        profiling.log_compile_time(lambda: None)
    assert float(x.sum()) == 0.0  # nothing ran


def _warm_problem():
    """The golden test's 96-vertex body (the numpy generator both packages
    share) and silhouette settings, 2 frames whose targets and 32² masks
    the port renders from numpy-seeded parameters; 20 + 20 steps, rebin 5,
    stride 2 after a warm stride of 4 over the first 10 stage-B steps.
    Returns jrr_tpu's arguments and the port's."""
    model = smpl_mod.synthetic_smpl_model(seed=11, num_verts=96, num_faces=160)
    cfg = cfg_lib.RefinerConfig(
        stage_a_steps=20, stage_b_steps=20, use_discriminators=False,
        silhouette=cfg_lib.SilhouetteConfig(
            image_size=32, tile_size=8, faces_per_tile=96, sigma=5e-3, blur_radius=0.05,
            rebin_interval=5, bin_margin_px=4.0, fine_warm_frac=0.5, fine_warm_stride=4,
        ),
    )
    rng = np.random.default_rng(11)
    j_reg = np.zeros((17, 96), np.float32)
    for j in range(17):
        j_reg[j, rng.choice(96, 6, replace=False)] = rng.uniform(0.5, 1.0, 6)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32))  # noqa: E731
    gt = tlosses.FrameParams(
        pose6d=trot.rotmat_to_rot6d(trot.random_rotmat(rng, (2, 23), device="cpu")),
        orient6d=trot.rotmat_to_rot6d(trot.random_rotmat(rng, (2, 1), device="cpu")),
        betas=t(rng.normal(scale=0.4, size=(2, 10))),
        cam_t=t(np.stack([rng.uniform(-0.1, 0.1, 2), rng.uniform(-0.1, 0.1, 2),
                          rng.uniform(25, 30, 2)], axis=-1)),
    )
    tmodel, tcfg = convert.smpl_model(model, device="cpu"), convert.refiner_config(cfg)
    verts = tlosses.forward_frame(tmodel, gt).vertices
    joints = tlosses.joints_from_verts(tjreg.normalize_jreg(t(j_reg)), verts)
    data = tlosses.FrameBatch(
        gt_j2d=tlosses.reproject_joints(joints, gt.cam_t, tcfg), gt_j3d=joints * 1000.0,
        mask=tsil.render_mesh_silhouette(verts, tmodel.faces, gt.cam_t,
                                         tlosses.rasterizer_spec(tcfg)),
    )
    init = tlosses.FrameParams(*(x + d for x, d in zip(gt, (0.04, 0.02, 0.05, 0.04))))
    jnp_of = lambda tree: type(tree)(*(jnp.asarray(x.numpy()) for x in tree))  # noqa: E731
    jax_args = (model, jnp.asarray(j_reg), jnp_of(init), jnp_of(data), cfg)
    port_args = (tmodel, t(j_reg), init, data, tcfg)
    return jax_args, port_args


@pytest.fixture(scope="module")
def warm_runs():
    jax_args, args = _warm_problem()
    want = engine.refine_batch(*jax_args, freeze_hand_feet=True)
    got = tengine.refine_batch(*args, freeze_hand_feet=True)
    return want, got, args


def test_refine_batch_over_rebin_chunks_matches_jax(warm_runs):
    want, got, args = warm_runs
    for key in PARAMS:
        np.testing.assert_allclose(getattr(got.params, key).numpy(),
                                   np.asarray(getattr(want.params, key)), atol=5e-4, err_msg=key)
    np.testing.assert_allclose(got.joints3d.numpy(), np.asarray(want.joints3d), atol=5e-4)
    # The warm stride scales the silhouette term by 4, so the curve reaches
    # 12 where the golden scene's stays below 4: 1e-4 plus 1e-5 relative.
    np.testing.assert_allclose(got.stage_b_terms.total.numpy(),
                               np.asarray(want.stage_b_terms.total), atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(got.stage_a_loss.numpy(), np.asarray(want.stage_a_loss),
                               rtol=1e-4)
    # The warm stride (4) over steps 0-9, then stride 2.
    active = (got.stage_b_terms.silhouette.numpy() != 0).tolist()
    assert active == [s % 4 == 0 if s < 10 else s % 2 == 0 for s in range(20)]
    assert got.chunk_stats.max_faces_per_tile.shape == (4,)
    for name, a, b in zip(want.bin_stats._fields, got.bin_stats, want.bin_stats):
        assert int(a) == int(b), name
    hand_feet = list(tengine.constants.HAND_FEET_ROT_INDICES)
    assert torch.equal(got.params.pose6d[:, hand_feet], args[2].pose6d[:, hand_feet])


def test_captured_schedule_replays_each_kind(warm_runs, monkeypatch):
    _, eager, args = warm_runs
    captured = []

    class _Replay:
        def __init__(self, fn, args):
            self.fn, self.args, self.replays = fn, args, 0

        def replay(self):
            self.replays += 1
            self.fn(*self.args)

    def fake_capture(fn, *fn_args):
        fn(*fn_args)  # the eager first step; the capture itself runs nothing
        captured.append(_Replay(fn, fn_args))
        return captured[-1]

    monkeypatch.setattr(tengine._Steps, "__init__",
                        lambda self, device: (setattr(self, "capture", True),
                                              setattr(self, "graphs", {}))[-1])
    monkeypatch.setattr(profiling, "capture", fake_capture)
    got = tengine.refine_batch(*args, freeze_hand_feet=True)
    # Stage A, then stage B's warm active, warm inactive, active, inactive.
    assert [r.replays for r in captured] == [19, 2, 6, 4, 4]
    for a, b in zip(got.params + (got.stage_a_loss,) + tuple(got.stage_b_terms),
                    eager.params + (eager.stage_a_loss,) + tuple(eager.stage_b_terms)):
        assert torch.equal(a, b)
