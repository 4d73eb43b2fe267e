"""One process of the 2-process gloo group of tests/test_torch_parallel.py.

    python -m tests.torch_dist_worker IN_DIR OUT_DIR

started by `jrr_tpu_torch.parallel.multihost.launch_local` (RANK,
WORLD_SIZE and a file:// init method in the environment). It imports only
the port, so a process loads no JAX and no conftest. It reads the inputs
the test wrote to IN_DIR and runs, in one group and in this order:

- `outer`: `make_sharded_outer_step` on tests/test_parallel.py's problem
  (batch 16, 96 vertices, 5 + 8 steps, no silhouette, discriminators on)
  from the converted JAX train state; rank 0 saves the state, the metrics
  and the refined params gathered to the global batch;
- `refine`: `make_sharded_refine` on the same problem;
- `acc`: the lstsq accumulator of IN_DIR's vertices, each rank adding its
  rows with the sum over the ranks;
- `gather`: `global_batch_from_local` of each rank's rows of arange(16);
- `run`: `run_optimize` over the fixture dataset (four shards of 2, with
  the silhouette), uninterrupted;
- `resume_<case>`: the same run killed in its third outer step (with an
  accumulator checkpoint after every shard in the `acc_checkpoint` case),
  then resumed with the same arguments;
- `cli`: `python -m jrr_tpu_torch.cli --demo --device cpu` on the fixture
  dataset, batch 4 (its group is this one; the CLI ends it).

Each rank writes OUT_DIR/<case>_rank<r>.npz; the runs write into
OUT_DIR/<case>/.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import types

import numpy as np
import torch

from jrr_tpu_torch import cli, config as cfg_lib
from jrr_tpu_torch import convert, pipeline
from jrr_tpu_torch.data import h36m
from jrr_tpu_torch.parallel import data_parallel, mesh as mesh_lib, multihost
from jrr_tpu_torch.refine import losses, trainer

RESUME_CASES = ("outer_step", "acc_checkpoint")


def outer_cfg() -> cfg_lib.PipelineConfig:
    """tests/test_parallel.py's configuration."""
    return dataclasses.replace(
        cfg_lib.PipelineConfig(),
        refiner=dataclasses.replace(cfg_lib.RefinerConfig(), stage_a_steps=5, stage_b_steps=8,
                                    use_silhouette=False, use_discriminators=True),
    )


def run_cfg() -> cfg_lib.PipelineConfig:
    """The run_optimize cases' configuration: the demo's silhouette size,
    short schedules, a snapshot every second shard, batches of 2."""
    return cfg_lib.PipelineConfig(
        refiner=cfg_lib.RefinerConfig(
            stage_a_steps=4, stage_b_steps=2,
            silhouette=cfg_lib.SilhouetteConfig(image_size=56)),
        jreg=cfg_lib.JRegConfig(snapshot_interval=2),
        data=cfg_lib.DataConfig(batch_size=2),
    )


def load_outer_inputs(in_dir: str):
    """(model, state, init, data) of the outer step's problem, on the CPU."""
    with np.load(os.path.join(in_dir, "outer_inputs.npz")) as f:
        a = dict(f)
    model = convert.smpl_model(types.SimpleNamespace(
        **{k[6:]: v for k, v in a.items() if k.startswith("model.")}, j_regressor_extra=None),
        device="cpu")
    state = convert.train_state_from_arrays(
        {k[5:]: v for k, v in a.items() if k.startswith("state.")}, outer_cfg(), device="cpu")
    t = lambda k: torch.as_tensor(a[k])  # noqa: E731
    init = losses.FrameParams(*(t(f"init.{k}") for k in losses.FrameParams._fields))
    data = losses.FrameBatch(gt_j2d=t("data.gt_j2d"), gt_j3d=t("data.gt_j3d"), mask=None)
    return model, state, init, data


def run_inputs(in_dir: str):
    """(model, j_reg, batches) of the run_optimize cases."""
    with np.load(os.path.join(in_dir, "run_inputs.npz")) as f:
        a = dict(f)
    model = convert.smpl_model(types.SimpleNamespace(
        **{k[6:]: v for k, v in a.items() if k.startswith("model.")}, j_regressor_extra=None),
        device="cpu")
    root = os.path.join(in_dir, "fixtures")
    batches = list(h36m.BatchLoader(h36m.H36MDataset(root), run_cfg().data.batch_size,
                                    drop_last=True))
    return model, a["j_reg"], batches


def _save(out_dir, name, rank, **arrays):
    np.savez(os.path.join(out_dir, f"{name}_rank{rank}.npz"), **arrays)


def main(in_dir: str, out_dir: str) -> None:
    torch.set_num_threads(2)
    multihost.initialize(backend="gloo", timeout_s=120)
    try:
        mesh = multihost.global_mesh(device="cpu")
        rank = mesh.rank

        # outer
        model, state, init, data = load_outer_inputs(in_dir)
        step = data_parallel.make_sharded_outer_step(mesh, outer_cfg())
        s, m, r = step(mesh_lib.replicate(mesh, state), mesh_lib.replicate(mesh, model),
                       mesh_lib.shard_batch(mesh, init), mesh_lib.shard_batch(mesh, data))
        params = multihost.global_batch_from_local(mesh, r.params._asdict())
        _save(out_dir, "outer", rank,
              **{f"state{k}": v for k, v in convert.train_state_arrays(s).items()},
              **{f"metric.{k}": v.numpy() for k, v in m._asdict().items()},
              **{f"params.{k}": v.numpy() for k, v in params.items()},
              local_rows=np.asarray(r.params.pose6d.shape[0]),
              stage_a_loss=r.stage_a_loss.numpy(), stage_b_total=r.stage_b_terms.total.numpy())

        # refine
        fn = data_parallel.make_sharded_refine(mesh, outer_cfg().refiner)
        res = fn(mesh_lib.replicate(mesh, model), mesh_lib.replicate(mesh, state.j_reg_raw),
                 mesh_lib.shard_batch(mesh, init), mesh_lib.shard_batch(mesh, data),
                 None, None)
        _save(out_dir, "refine", rank, stage_b_total=res.stage_b_terms.total.numpy(),
              stage_a_loss=res.stage_a_loss.numpy(), pose6d=res.params.pose6d.numpy())

        # acc
        with np.load(os.path.join(in_dir, "acc_inputs.npz")) as f:
            verts, gt, pelvis = (mesh_lib.shard_batch(mesh, f[k]) for k in ("verts", "gt", "pelvis"))
        acc = trainer.JRegLstsqAccumulator.zero(verts.shape[1], device="cpu")
        for sl in (slice(0, 2), slice(2, None)):
            acc = trainer.jreg_lstsq_accumulate(
                acc, verts[sl], gt[sl], pelvis[sl],
                reduce=lambda part: mesh_lib.sum_over_ranks(mesh, part))
        _save(out_dir, "acc", rank, **{k: v.numpy() for k, v in acc._asdict().items()})

        # gather
        rows = data_parallel.host_shard_slice(16, mesh.world_size, rank)
        local = {"x": np.arange(16, dtype=np.float32).reshape(16, 1)[rows]}
        g = multihost.global_batch_from_local(mesh, local)
        _save(out_dir, "gather", rank, x=g["x"].numpy(), total=mesh_lib.sum_over_ranks(
            mesh, [torch.as_tensor(local["x"]).sum()])[0].numpy(), **{
            f"info.{k}": np.asarray(v) for k, v in multihost.process_info().items()})

        # run and resume
        run_model, j_reg, batches = run_inputs(in_dir)

        def run(name):
            return pipeline.run_optimize(run_cfg(), run_model, j_reg, iter(batches),
                                         os.path.join(out_dir, name))

        s, acc, _ = run("run")
        _save(out_dir, "run", rank, **{f"state{k}": v for k, v in
                                       convert.train_state_arrays(s).items()},
              **{f"acc.{k}": v.numpy() for k, v in acc._asdict().items()})
        for case in RESUME_CASES:
            name = f"resume_{case}"
            every, compile_step, calls = (pipeline.ACC_CKPT_EVERY, trainer.compile_outer_step,
                                          [])
            if case == "acc_checkpoint":
                pipeline.ACC_CKPT_EVERY = 1

            def compile_crashing(*args, **kwargs):
                step = compile_step(*args, **kwargs)

                def crashing_step(*args, **kwargs):
                    calls.append(1)
                    if len(calls) == 3:
                        raise RuntimeError("crash in the third outer step")
                    return step(*args, **kwargs)

                return crashing_step

            trainer.compile_outer_step = compile_crashing
            try:
                run(name)
                raise AssertionError("the crash did not stop the run")
            except RuntimeError as e:
                assert "third outer step" in str(e), e
            finally:
                trainer.compile_outer_step = compile_step
            mesh_lib.barrier(mesh)  # both ranks crashed before either resumes
            s, acc, _ = run(name)
            pipeline.ACC_CKPT_EVERY = every
            _save(out_dir, name, rank, **{f"state{k}": v for k, v in
                                          convert.train_state_arrays(s).items()},
                  **{f"acc.{k}": v.numpy() for k, v in acc._asdict().items()})

        # cli (last: it destroys the group)
        print(f"rank {rank} cli", flush=True)
        cli.main(["--demo", "--device", "cpu", "--data-root", os.path.join(in_dir, "fixtures"),
                  "--out", os.path.join(out_dir, "cli"), "--stage-a-steps", "3",
                  "--stage-b-steps", "2", "--batch-size", "4"])
    finally:
        multihost.shutdown()


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
