"""The refine program (`engine.compile_refine`, the counterpart of jrr_tpu's
`jax.jit(refine_batch)`), held on the CPU:

- (a) on the golden problem (tests/make_golden.py: 96 vertices, 32², 20 +
  20 steps) the program's first call reproduces tests/golden_refinement.npz
  at test_golden.py's tolerances (atol 5e-4 on params and joints3d, 1e-4
  on the stage-B curve), and so does a third call, after a call on other
  inputs;
- (b) three calls on init + 1e-7·(k+1), the discriminators' weights
  changed in place between calls, each equal a fresh `refine_batch` on the
  same inputs bit for bit (params, curves, joints, vertices, counters) on
  every route `engine.refiner` picks: single resolution, coarse-to-fine
  (also with a stand-in capture whose "graphs" call their closures again,
  so later calls replay), lane-packed, round-1 and "xla" at rebin 1;
- (c) a returned result is not overwritten by the next call, and the
  caller's tensors are left as they were;
- (d) one entry per key: the same shape reuses its refiner, another batch
  size or TF32 setting gets its own; TF32 is off inside a call and the
  caller's flags are restored after;
- (e) a program and its entries are freed by reference counting;
- (f) the probes build one program per configuration: `c2f_probe.measure`
  one refiner for both its calls, `silhouette_quality.sweep` one per row.
"""

import contextlib
import dataclasses
import gc
import os
import weakref

import numpy as np
import pytest
import torch

import make_golden
from jrr_tpu_torch import convert, problem
from jrr_tpu_torch.models import discriminator
from jrr_tpu_torch.probes import c2f_probe, quality
from jrr_tpu_torch.probes import silhouette_quality as sq
from jrr_tpu_torch.refine import engine
from jrr_tpu_torch.utils import profiling
from test_torch_outer_program import _assert_bits, _Replay
from test_torch_spin import torch_threads

GOLDEN = os.path.join(os.path.dirname(__file__), "golden_refinement.npz")
PARAMS = ("pose6d", "orient6d", "betas", "cam_t")
CALLS = 3
ROUTES = ("single", "c2f", "c2f_replayed", "lane_pack", "pallas", "xla")


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Torch on two threads: Tier-1 runs six test processes at once."""
    with torch_threads():
        yield


@contextlib.contextmanager
def _stand_in_capture(captured):
    """Step runners built inside capture: each closure's first call runs
    it and "captures" it into a `_Replay` (appended to `captured`), which
    later calls replay by calling the closure again."""
    init = engine._Steps.__init__

    def capturing(self, device, times=None, prefix=""):
        init(self, device, times, prefix)
        self.capture = engine._graphs_off.depth == 0

    def fake_capture(fn, *args, **options):
        fn(*args)
        captured.append(_Replay(fn, args))
        return captured[-1]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(engine._Steps, "__init__", capturing)
        mp.setattr(profiling, "capture", fake_capture)
        yield


def _small(route, batch=2):
    """The port's drift scene at 96 vertices and 32²: 3 + 4 steps at rebin
    2, live discriminators; "c2f" 8 stage-B steps, half at 16² with a warm
    stride of 2 after; the backends' routes at their own settings."""
    model, j_reg, cfg, init, data = problem.synthetic_problem(
        batch=batch, num_verts=96, image_size=32, device="cpu")
    sil = dataclasses.replace(cfg.silhouette, rebin_interval=2, coarse_frac=0.0)
    steps = 4
    if route.startswith("c2f"):
        steps = 8
        sil = dataclasses.replace(sil, coarse_frac=0.5, coarse_min_image=16, fine_warm_frac=0.5,
                                  fine_warm_stride=2)
    elif route == "lane_pack":
        sil = dataclasses.replace(sil, lane_pack=True)
    elif route == "pallas":
        sil = dataclasses.replace(sil, backend="pallas")
    elif route == "xla":
        steps = 2
        sil = dataclasses.replace(sil, backend="xla", rebin_interval=1)
    cfg = dataclasses.replace(cfg, stage_a_steps=3, stage_b_steps=steps, silhouette=sil,
                              use_discriminators=True)
    return model, j_reg, cfg, init, data


def _discriminators():
    return (discriminator.PoseDiscriminator(seed=7, device="cpu"),
            discriminator.ShapeDiscriminator(seed=8, device="cpu"))


@pytest.fixture(scope="module")
def route_runs():
    """Per route: CALLS program calls on init + 1e-7·(k+1), each followed by
    a fresh `refine_batch` on the same inputs, the discriminators' weights
    shifted in place before every call but the first. Each call's result
    is kept as returned and as cloned right after it, with the caller's
    inputs cloned before and after it."""
    runs = {}

    def get(route):
        if route in runs:
            return runs[route]
        model, j_reg, cfg, init, data = _small(route)
        pose_disc, shape_disc = _discriminators()
        program = engine.compile_refine(cfg)
        captured = []
        capture = ((lambda: _stand_in_capture(captured)) if route == "c2f_replayed"
                   else contextlib.nullcontext)
        calls = []
        for k in range(CALLS):
            if k:
                with torch.no_grad():
                    for p in list(pose_disc.parameters()) + list(shape_disc.parameters()):
                        p.add_(1e-3 * k)
            init_k = type(init)(*(x + 1e-7 * (k + 1) for x in init))
            inputs = (j_reg, init_k, data, pose_disc, shape_disc)
            before = engine._fresh([j_reg, init_k, data, list(pose_disc.parameters()),
                                    list(shape_disc.parameters())])
            with capture():
                got = program(model, *inputs)
            kept = engine._fresh(got)
            after = engine._fresh([j_reg, init_k, data, list(pose_disc.parameters()),
                                   list(shape_disc.parameters())])
            want = engine.refine_batch(model, j_reg, init_k, data, cfg, pose_disc, shape_disc)
            calls.append(dict(got=got, kept=kept, want=want, before=before, after=after))
        runs[route] = (program, calls, captured)
        return runs[route]

    return get


@pytest.mark.parametrize("route", ROUTES)
def test_program_equals_refine_batch_bit_for_bit(route_runs, route):
    program, calls, captured = route_runs(route)
    assert len(program.entries) == 1
    if route == "c2f_replayed":  # every kind captured once, replayed by the later calls
        assert captured and all(c.replays >= CALLS - 1 for c in captured)
    kind = engine.CoarseToFine if route.startswith("c2f") else engine.Refinement
    assert isinstance(next(iter(program.entries.values())).refiner, kind)
    for k, call in enumerate(calls):
        _assert_bits(call["got"], call["want"], f"{route} call {k}")
    # The discriminators were live: their term moved between calls.
    terms = [c["got"].stage_b_terms.pose_disc for c in calls]
    assert not torch.equal(terms[0], terms[1])


def test_results_are_not_overwritten_by_later_calls(route_runs):
    """Each call's result, read after every call has run, is what it
    returned (no buffer of the program is handed out)."""
    for route in ("c2f", "c2f_replayed"):
        _, calls, _ = route_runs(route)
        for k, call in enumerate(calls):
            _assert_bits(call["got"], call["kept"], f"{route} call {k}")
        assert not torch.equal(calls[0]["got"].params.pose6d, calls[1]["got"].params.pose6d)


def test_callers_tensors_are_left_as_they_were(route_runs):
    for route in ("single", "c2f_replayed"):
        _, calls, _ = route_runs(route)
        for k, call in enumerate(calls):
            _assert_bits(call["after"], call["before"], f"{route} call {k}")


def _golden_close(res, want):
    for key in PARAMS:
        np.testing.assert_allclose(getattr(res.params, key).numpy(), want[key], atol=5e-4,
                                   err_msg=key)
    np.testing.assert_allclose(res.joints3d.numpy(), want["joints3d"], atol=5e-4,
                               err_msg="joints3d")
    np.testing.assert_allclose(res.stage_b_terms.total.numpy(), want["stage_b_total"], atol=1e-4,
                               err_msg="loss curve")


def test_program_reproduces_golden_refinement():
    """The first call and a third, after a call on other inputs, reproduce
    the golden fixture (jrr_tpu's refinement of this problem)."""
    model, j_reg, cfg, init, data, _ = make_golden.build_problem()
    model = convert.smpl_model(model, device="cpu")
    j_reg = torch.as_tensor(np.array(j_reg))
    init = convert.frame_params(init, device="cpu")
    data = convert.frame_batch(data, device="cpu")
    program = engine.compile_refine(convert.refiner_config(cfg))
    with np.load(GOLDEN) as f:
        want = dict(f)
    first = program(model, j_reg, init, data)
    _golden_close(first, want)
    other = program(model, j_reg, type(init)(*(x + 0.01 for x in init)), data)
    assert not np.allclose(other.params.betas.numpy(), want["betas"], atol=5e-4)
    third = program(model, j_reg, init, data)
    _golden_close(third, want)
    _assert_bits(third, first)
    assert len(program.entries) == 1


def test_one_entry_per_key(monkeypatch):
    """The same shape reuses its entry's refiner; another batch size or
    TF32 setting builds its own. TF32 is off inside every call and the
    caller's flags are back after it."""
    built, inside = [], []
    real_refiner, real_step = engine.refiner, engine._Adam.step

    def counting(*args, **kwargs):
        built.append(args[2].cam_t.shape[0])
        return real_refiner(*args, **kwargs)

    def recording_step(self, params, grads):
        inside.append((torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32))
        return real_step(self, params, grads)

    monkeypatch.setattr(engine, "refiner", counting)
    monkeypatch.setattr(engine._Adam, "step", recording_step)
    model, j_reg, cfg, init, data = _small("single", batch=3)
    cfg = dataclasses.replace(cfg, stage_a_steps=1, stage_b_steps=2)
    program = engine.compile_refine(cfg)
    two = (type(init)(*(x[:2] for x in init)),
           type(data)(*(None if x is None else x[:2] for x in data)))
    flags = (torch.backends.cuda.matmul, torch.backends.cudnn)
    saved = tuple(f.allow_tf32 for f in flags)
    try:
        program(model, j_reg, init, data)
        program(model, j_reg, *two)
        program(model, j_reg, init, data)
        assert built == [3, 2] and len(program.entries) == 2
        for f in flags:
            f.allow_tf32 = True
        program(model, j_reg, init, data)
        after = tuple(f.allow_tf32 for f in flags)
    finally:
        for f, v in zip(flags, saved):
            f.allow_tf32 = v
    assert built == [3, 2, 3] and len(program.entries) == 3
    assert after == (True, True) and set(inside) == {(False, False)}


def test_program_and_entries_are_freed_without_the_collector():
    """No reference cycle holds a program, its entries or their refiners
    (and so, on the card, their graphs): they go with the program's last
    reference."""
    model, j_reg, cfg, init, data = _small("c2f")
    cfg = dataclasses.replace(cfg, stage_a_steps=1)
    collecting = gc.isenabled()
    gc.disable()
    try:
        program = engine.compile_refine(cfg)
        program(model, j_reg, init, data)
        entry = next(iter(program.entries.values()))
        held = [weakref.ref(x) for x in (program, entry, entry.refiner, entry.refiner.coarse,
                                          entry.refiner.fine)]
        del program, entry
        assert [ref() is None for ref in held] == [True] * len(held)
    finally:
        if collecting:
            gc.enable()


def test_probes_build_one_program_per_configuration(monkeypatch):
    """`c2f_probe.measure` makes its two calls through one program (one
    refiner; `exec_seconds` is the replay of what `seconds` captured), and
    `silhouette_quality.sweep` one program per row."""
    built = []
    real = engine.refiner

    def counting(*args, **kwargs):
        built.append(args[4])
        return real(*args, **kwargs)

    monkeypatch.setattr(engine, "refiner", counting)
    probe = quality.with_steps(
        quality.shape_mismatch_problem(2, 64, 64, device="cpu"), 2, 2)
    cfg = c2f_probe.rcfg(probe.cfg, 2, 2, coarse_frac=0.0)
    line, _ = c2f_probe.measure(probe, "control_single_res", cfg)
    assert built == [cfg] and line["exec_seconds"] > 0.0
    rows = sq.sweep(probe, ("no_sil", "r4_shipped_c4"), ("production",))
    assert len(built) == 3 and len(rows) == 2
    assert built[1].use_silhouette is False and built[2].use_silhouette is True
