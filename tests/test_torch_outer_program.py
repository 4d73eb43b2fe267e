"""The outer-step program (`trainer.compile_outer_step`, the counterpart of
jrr_tpu's `jax.jit(outer_step)`) and the captured accumulate
(`trainer.compile_accumulate`), held on the CPU:

- (a) the program chained over 3 batches equals `trainer.outer_step`
  chained over the same batches bit for bit (state, metrics, RefineResult,
  chunk counters, and the accumulate against `jreg_lstsq_accumulate`),
  with the silhouette on (`test_outer_step_with_silhouette_counters`'s
  config), with it on under coarse-to-fine and warm striding, and off;
  each eagerly and with the step runners in capture mode and a stand-in
  for the capture whose "graph" calls its closure again, so a closure that
  read anything but its static buffers would replay stale values;
- (b) one program against jrr_tpu's `jax.jit(trainer.outer_step)` over 2
  batches, each step from jrr_tpu's state before it, within
  `test_outer_step_state_matches_jax`'s tolerances;
- (c) a returned state and result are unchanged by the next call (no
  buffer of the program is handed out);
- (d) a smaller last batch runs in its own entry and equals the eager step;
- (e) `run_optimize` over 3 shards with the program captured (stand-in)
  equals the same run under `engine.disable_graphs()`: files, state and
  accumulator bit for bit;
- (f) device counts in the trainer's optimizers equal Python int counts
  bit for bit after 5 outer steps, and a train-state file holds int32
  counts;
- and refiners and program entries are freed by reference counting (no
  cycle leaves their graphs to the garbage collector).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jrr_tpu.refine import trainer as jtrainer
from jrr_tpu.utils import checkpoint as jckpt
from jrr_tpu_torch import config, convert, problem
from jrr_tpu_torch import pipeline
from jrr_tpu_torch.refine import engine, trainer
from jrr_tpu_torch.utils import checkpoint as ckpt_lib
from jrr_tpu_torch.utils import profiling
from test_torch_resume import _assert_equal, _outcome
from test_torch_spin import torch_threads
from test_torch_trainer import PARAMS, _close_rel, outer_inputs  # noqa: F401 (fixture)

BATCH, STEPS = 2, 3


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Torch on two threads: Tier-1 runs six test processes at once."""
    with torch_threads():
        yield


class _Replay:
    """A stand-in graph: each replay calls the captured closure again."""

    def __init__(self, fn, args):
        self.fn, self.args, self.replays = fn, args, 0

    def replay(self):
        self.replays += 1
        self.fn(*self.args)


@pytest.fixture
def replayed(monkeypatch):
    """Step runners built outside `disable_graphs()` capture, through a
    capture that runs the closure once (its eager first call) and replays
    it by calling it again. Yields the stand-in graphs."""
    captured = []
    init = engine._Steps.__init__

    def capturing(self, device, times=None, prefix=""):
        init(self, device, None, prefix)
        self.capture = engine._graphs_off.depth == 0

    def fake_capture(fn, *args, **options):
        fn(*args)
        captured.append(_Replay(fn, args))
        return captured[-1]

    monkeypatch.setattr(engine._Steps, "__init__", capturing)
    monkeypatch.setattr(profiling, "capture", fake_capture)
    yield captured


def _problem(case, batches=STEPS, last=BATCH):
    """The silhouette-counters test's problem (96 vertices, 32² masks,
    3 + 4 steps, rebin 2), cut into batches of BATCH frames and a last of
    `last`; "c2f" runs coarse-to-fine at 16² with a warm stride, "off"
    without the silhouette."""
    frames = BATCH * (batches - 1) + last
    model, j_reg, cfg, init, data = problem.synthetic_problem(
        batch=frames, num_verts=96, image_size=32, device="cpu")
    sil = dataclasses.replace(cfg.silhouette, rebin_interval=2, coarse_frac=0.0)
    steps = 4
    if case == "c2f":
        steps = 8
        sil = dataclasses.replace(sil, coarse_frac=0.5, coarse_min_image=16, fine_warm_frac=0.5,
                                  fine_warm_stride=2)
    cfg = dataclasses.replace(cfg, stage_a_steps=3, stage_b_steps=steps, silhouette=sil,
                              use_silhouette=case != "off")
    pcfg = config.PipelineConfig(refiner=cfg)
    cuts = [slice(i * BATCH, min((i + 1) * BATCH, frames)) for i in range(batches)]
    parts = [(type(init)(*(x[c] for x in init)),
              type(data)(*(None if x is None else x[c] for x in data))) for c in cuts]
    return model, pcfg, trainer.init_train_state(j_reg, pcfg, seed=3), parts


def _assert_bits(got, want, where=""):
    """Equal trees of NamedTuples, tensors, modules and Adam states, bit
    for bit (dtype included)."""
    if want is None or isinstance(want, (int, float)):
        assert got == want, where
    elif torch.is_tensor(want):
        assert got.dtype == want.dtype and got.shape == want.shape, where
        assert torch.equal(got, want), where
    elif isinstance(want, torch.nn.Module):
        _assert_bits(list(got.parameters()), list(want.parameters()), where)
    elif isinstance(want, engine._Adam):
        _assert_bits([got.count] + got.m + got.v, [want.count] + want.m + want.v, where)
    else:
        names = getattr(want, "_fields", range(len(want)))
        assert len(got) == len(want), where
        for name, g, w in zip(names, got, want):
            _assert_bits(g, w, f"{where}.{name}")


def _chain(step, accumulate, model, state, parts):
    """Outer steps and accumulates over the batches; each step's outputs."""
    acc = trainer.JRegLstsqAccumulator.zero(model.num_verts, device="cpu")
    outs = []
    for init, data in parts:
        state, m, res = step(state, model, init, data)
        acc = accumulate(acc, res.vertices, data.gt_j3d, res.joints3d[:, :1])
        outs.append((state, m, res, acc))
    return outs


def _eager_chain(model, pcfg, state, parts):
    return _chain(lambda s, mo, i, d: trainer.outer_step(s, mo, i, d, pcfg),
                  trainer.jreg_lstsq_accumulate, model, state, parts)


@pytest.fixture(scope="module")
def eager_chains():
    """Each case's problem and eager chain, made once for both modes."""
    chains = {}

    def get(case):
        if case not in chains:
            model, pcfg, state0, parts = _problem(case)
            chains[case] = (model, pcfg, state0, parts, _eager_chain(model, pcfg, state0, parts))
        return chains[case]

    return get


@pytest.mark.parametrize("mode", ["eager", "replayed"])
@pytest.mark.parametrize("case", ["silhouette", "c2f", "off"])
def test_program_equals_outer_step_bit_for_bit(request, eager_chains, case, mode):
    model, pcfg, state0, parts, want = eager_chains(case)
    captured = request.getfixturevalue("replayed") if mode == "replayed" else None
    program = trainer.compile_outer_step(pcfg)
    got = _chain(program, trainer.compile_accumulate(), model, state0, parts)
    for i, (g, w) in enumerate(zip(got, want)):
        _assert_bits(g, w, f"step {i}")
    if case != "off":
        stats = got[-1][2].chunk_stats
        assert stats is not None and stats.max_faces_per_tile.shape == ((2,) if case != "c2f"
                                                                        else (4,))
        assert int(got[-1][1].rasterizer_max_faces_per_tile) > 0
    assert len(program.entries) == 1
    if mode == "replayed":
        # Every closure is captured at the first batch and replayed for the
        # later two: stage A thrice a batch, each kind of stage-B step, the
        # rebins, the prologues and the outer segment once or more a batch.
        assert captured and all(r.replays >= STEPS - 1 for r in captured)
        assert sum(r.replays for r in captured if r.replays == 3 * STEPS - 1) >= 1


def test_returned_values_are_not_overwritten_by_the_next_call(replayed):
    model, pcfg, state, parts = _problem("silhouette")
    program = trainer.compile_outer_step(pcfg)
    kept = []
    for init, data in parts:
        state, m, res = program(state, model, init, data)
        kept.append(((state, m, res), trainer._fresh((state.j_reg_raw, m, res)),
                     [trainer._fresh(list(d.parameters())) for d in (state.pose_disc,
                                                                    state.shape_disc)],
                     [trainer._fresh([o.count] + o.m + o.v) for o in (
                         state.jreg_opt, state.pose_disc_opt, state.shape_disc_opt)]))
    for (state, m, res), values, discs, opts in kept:
        _assert_bits((state.j_reg_raw, m, res), values)
        _assert_bits([list(d.parameters()) for d in (state.pose_disc, state.shape_disc)], discs)
        _assert_bits([[o.count] + o.m + o.v for o in (
            state.jreg_opt, state.pose_disc_opt, state.shape_disc_opt)], opts)


def test_a_smaller_last_batch_gets_its_own_entry(replayed):
    model, pcfg, state0, parts = _problem("silhouette", last=1)
    assert parts[-1][0].cam_t.shape[0] == 1
    want = _eager_chain(model, pcfg, state0, parts)
    program = trainer.compile_outer_step(pcfg)
    got = _chain(program, trainer.compile_accumulate(), model, state0, parts)
    assert len(program.entries) == 2
    for i, (g, w) in enumerate(zip(got, want)):
        _assert_bits(g, w, f"step {i}")


def test_program_matches_jax_over_two_batches(outer_inputs):  # noqa: F811
    """From jrr_tpu's state one step in (as `outer_pair` builds it: Adam
    moments live), one program over two batches, the batch and then its
    frames in reverse order (one shape: one compile, one entry), jitted as
    jrr_tpu's run_optimize runs them (its initial state jitted too, equal
    to the eager one). Each call starts from jrr_tpu's state before that
    step, converted, so each is held at
    `test_outer_step_state_matches_jax`'s tolerances (chained, the two
    packages' rounding compounds: 1.25e-5 relative in one moment after two
    steps)."""
    model, j_reg, gt, init, data, cfg = outer_inputs
    j_reg0 = j_reg + 0.05 * jnp.abs(jax.random.normal(jax.random.PRNGKey(9), j_reg.shape))
    state = jax.jit(lambda k, j: jtrainer.init_train_state(k, j, cfg))(
        jax.random.PRNGKey(0), j_reg0)
    step = jax.jit(lambda s, m, i, d: jtrainer.outer_step(s, m, i, d, cfg))
    state, _, _ = step(state, model, init, data)
    tcfg = convert.pipeline_config(cfg)
    tmodel = convert.smpl_model(model, device="cpu")
    flip = lambda tree: type(tree)(*(None if x is None else x[::-1] for x in tree))  # noqa: E731
    program = trainer.compile_outer_step(tcfg)
    for n, (b_init, b_data) in enumerate([(init, data), (flip(init), flip(data))], start=2):
        tstate = convert.train_state(state, tcfg, device="cpu")
        state, want_m, want_res = step(state, model, b_init, b_data)
        tstate, got_m, got_res = program(tstate, tmodel, convert.frame_params(b_init, "cpu"),
                                         convert.frame_batch(b_data, "cpu"))
        assert tstate.step == int(state.step) == n
        want_arrays = jckpt._flatten(state)
        for key, value in convert.train_state_arrays(tstate).items():
            if key.endswith("count") or key == ".step":
                assert value.dtype == np.int32 and int(value) == n, key
            _close_rel(value, want_arrays[key], err_msg=key)
        for field in want_m._fields:
            atol = 1e-3 if "mpjpe" in field else 1e-5
            np.testing.assert_allclose(float(getattr(got_m, field)),
                                       float(getattr(want_m, field)), atol=atol, rtol=1e-5,
                                       err_msg=field)
        for key in PARAMS:
            np.testing.assert_allclose(getattr(got_res.params, key).numpy(),
                                       np.asarray(getattr(want_res.params, key)), atol=5e-4,
                                       err_msg=key)
    assert len(program.entries) == 1


def _shard_batches():
    """The silhouette problem's 6 frames as `run_optimize`'s host batches
    (the stored-estimate keys a loader gives): three batches of 2."""
    model, pcfg, state0, parts = _problem("silhouette")
    batches = [{"pose": init.pose6d.numpy(), "orient": init.orient6d[:, 0].numpy(),
                "betas": init.betas.numpy(), "cam": init.cam_t.numpy(),
                "gt_j2d": data.gt_j2d.numpy(), "gt_j3d": data.gt_j3d.numpy(),
                "mask_rcnn": data.mask.numpy()} for init, data in parts]
    return model, pcfg, state0.j_reg_raw.numpy(), batches


def test_run_optimize_captured_equals_disable_graphs(replayed, tmp_path):
    model, pcfg, j_reg, batches = _shard_batches()
    cfg = dataclasses.replace(pcfg, jreg=config.JRegConfig(snapshot_interval=1),
                              data=config.DataConfig(batch_size=BATCH))
    outcomes = []
    for name in ("captured", "eager"):
        out = str(tmp_path / name)
        if name == "eager":
            with engine.disable_graphs():
                state, acc, _ = pipeline.run_optimize(cfg, model, j_reg, iter(batches), out)
        else:
            state, acc, _ = pipeline.run_optimize(cfg, model, j_reg, iter(batches), out)
            assert replayed and max(r.replays for r in replayed) > 0
        assert state.step == 3 and float(acc.count) == 6
        outcomes.append(_outcome(out, state, acc))
    _assert_equal(*outcomes)
    assert sorted(n for n in outcomes[0]["files"] if n.startswith("refined/shard")) == [
        f"refined/shard_{i:06d}.npz" for i in range(3)]


def test_device_counts_equal_int_counts_and_files_hold_int32(tmp_path):
    model, pcfg, state0, parts = _problem("off", batches=1)
    init, data = parts[0]
    ints = state0._replace(**{f: engine._Adam.__new__(engine._Adam) for f in (
        "jreg_opt", "pose_disc_opt", "shape_disc_opt")})
    for field in ("jreg_opt", "pose_disc_opt", "shape_disc_opt"):
        opt = getattr(ints, field)
        opt.__dict__.update(getattr(state0, field).__dict__)
        opt.m, opt.v, opt.count = [t.clone() for t in opt.m], [t.clone() for t in opt.v], 0
        assert torch.is_tensor(getattr(state0, field).count)
    runs = []
    for state in (state0, ints):
        for _ in range(5):
            state, _, _ = trainer.outer_step(state, model, init, data, pcfg)
        runs.append(state)
    device, python = runs
    assert torch.is_tensor(device.jreg_opt.count) and isinstance(python.jreg_opt.count, int)
    for field in ("jreg_opt", "pose_disc_opt", "shape_disc_opt"):
        d, p = getattr(device, field), getattr(python, field)
        assert float(d.count) == p.count == 5 and d.count.dtype == torch.float64
        _assert_bits(d.m + d.v, p.m + p.v, field)
    _assert_bits(device.j_reg_raw, python.j_reg_raw)
    _assert_bits([device.pose_disc, device.shape_disc], [python.pose_disc, python.shape_disc])
    path = ckpt_lib.save_train_state(str(tmp_path), device, device.step)
    with np.load(path) as f:
        counts = {k: f[k] for k in f.files if k.endswith(".count")}
    assert len(counts) == 3
    for key, value in counts.items():
        assert value.dtype == np.int32 and int(value) == 5, key
    back = ckpt_lib.restore_train_state(path, state0)
    assert torch.is_tensor(back.jreg_opt.count) and float(back.pose_disc_opt.count) == 5


def test_programs_and_refiners_are_freed_without_the_collector():
    """No reference cycle holds a refiner or a program entry (and so, on
    the card, its graphs): they go when their last reference does, never
    inside a later capture, where the collector destroying a graph
    invalidated the capture on the card."""
    import gc
    import weakref

    model, pcfg, state, parts = _problem("c2f", batches=1)
    init, data = parts[0]
    collecting = gc.isenabled()
    gc.disable()
    try:
        refiner = engine.refiner(model, state.j_reg_raw, init, data, pcfg.refiner)
        refiner.run()
        held = [weakref.ref(x) for x in (refiner, refiner.coarse, refiner.fine)]
        del refiner
        program = trainer.compile_outer_step(pcfg)
        accumulate = trainer.compile_accumulate()
        _, _, res = program(state, model, init, data)
        accumulate(trainer.JRegLstsqAccumulator.zero(model.num_verts, device="cpu"),
                   res.vertices, data.gt_j3d, res.joints3d[:, :1])
        entries = list(program.entries.values()) + list(accumulate.entries.values())
        held += [weakref.ref(x) for x in entries + [entries[0].refiner]]
        del program, accumulate, entries
        assert [ref() is None for ref in held] == [True] * len(held)
    finally:
        if collecting:
            gc.enable()
