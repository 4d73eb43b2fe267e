"""The check decides `correct` false for the control and for each fault
the cells can have, at a tiny size on the CPU: the harness's run with the
timed path broken underneath (the look for a card skipped)."""

import argparse
import time

import pytest
import torch

from benchmark import check, harness, program as program_lib, scene as scene_lib
from benchmark.reference import body as body_lib


def _run(cell, seed=4):
    args = argparse.Namespace(workload=cell.name, seed=seed, seconds=0.0, trace=0)
    return harness.run(args, time.perf_counter(), cell=cell, device="cpu")


@pytest.mark.parametrize("name", ["outer.nosil.b256", "outer.nosil.b512"])
def test_sound_run_is_correct(tiny_cell, name):
    res = _run(tiny_cell(name))
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks"
    assert res["attempted"] >= 1 and res["failed"] == 0


def test_state_left_unchanged(tiny_cell, monkeypatch):
    step = program_lib.Program.step

    def unchanged(self, state, k):
        return step(self, state, k)._replace(state=state)

    monkeypatch.setattr(program_lib.Program, "step", unchanged)
    res = _run(tiny_cell())
    assert not res["correct"]
    assert res["checks"]["change_gap"]["value"] == pytest.approx(1.0)


def test_half_the_batch_left_out(tiny_cell, monkeypatch):
    batch = program_lib.Program.batch

    def half(self, k):
        init, data, gt = batch(self, k)
        n = gt.shape[0] // 2
        return type(init)(*(x[:n] for x in init)), type(data)(*(x[:n] for x in data)), gt[:n]

    monkeypatch.setattr(program_lib.Program, "batch", half)
    assert not _run(tiny_cell(batch=8))["correct"]


@pytest.mark.parametrize("name", ["outer.nosil.b256", "outer.nosil.b512"])
def test_answer_altered_where_produced(tiny_cell, monkeypatch, name):
    from jrr_tpu_torch.refine import trainer

    compile_outer_step = trainer.compile_outer_step

    def altered(cfg, *args, **kwargs):
        program = compile_outer_step(cfg, *args, **kwargs)

        def call(state, model, init, data):
            state, metrics, result = program(state, model, init, data)
            verts = result.vertices.clone()
            verts[0] = verts[1]  # a row mix-up: frame 0 gets frame 1's answer
            return state, metrics, result._replace(vertices=verts)

        return call

    monkeypatch.setattr(trainer, "compile_outer_step", altered)
    assert not _run(tiny_cell(name))["correct"]


def test_evaluation_altered_where_produced(tiny_cell, monkeypatch):
    """The step's PA-MPJPE read without its Procrustes alignment."""
    from jrr_tpu_torch.refine import trainer

    evaluate = trainer._evaluate

    def unaligned(*args):
        errors = evaluate(*args)
        return errors._replace(pa_mpjpe=errors.mpjpe)

    monkeypatch.setattr(trainer, "_evaluate", unaligned)
    res = _run(tiny_cell())
    assert not res["correct"]
    assert res["checks"]["eval_gap"]["value"] > res["checks"]["eval_gap"]["limit"]


def test_control_fails(tiny_cell):
    """The reference in TF32 put in the program's place fails the check."""
    cell = tiny_cell()
    scene = scene_lib.make_scene(4, cell.config, cell.traffic, "cpu")
    want = check.run_reference(scene, cell.config, 2)
    control = check.run_reference(scene, cell.config, 2, nx=body_lib.Numerics(tf32=True))
    numbers = check.compare(control, want)
    assert not check.verdict(numbers, cell.limits["limits"])[0], numbers


def test_tf32_rounding():
    x = torch.tensor([1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -11, 1.0 + 2.0 ** -12, -3.0])
    assert body_lib.round_tf32(x).tolist() == [1.0, 1.0 + 2.0 ** -9, 1.0, -3.0]
