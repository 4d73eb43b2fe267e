"""Multi-process dry run (counterpart of __graft_entry__.dryrun_multichip):

    python -m jrr_tpu_torch.parallel.dryrun --nproc N [--device cpu]

starts N processes of one group on this host (`multihost.launch_local`:
NCCL, one card each; gloo with `--device cpu`) and runs the data-parallel
outer step in two phases: (1) tiny shapes (96 vertices, 32² silhouette, a
batch of at least 8 that N divides), every sharding and collective of the
step; (2) one full-width outer step (6890 vertices, 224² silhouette, 3 + 3
refinement steps) at one frame per process. Each rank checks that the
state it leaves is the same on every rank and finite; rank 0 prints each
phase's seconds and frames/s.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import torch


def _phase(mesh, batch, num_verts, image_size, seed):
    from jrr_tpu_torch.config import PipelineConfig
    from jrr_tpu_torch.parallel import data_parallel, mesh as mesh_lib
    from jrr_tpu_torch.problem import synthetic_problem
    from jrr_tpu_torch.refine import trainer

    model, j_reg, rcfg, init, data = synthetic_problem(
        batch=batch, num_verts=num_verts, image_size=image_size, seed=seed, device=mesh.device)
    cfg = dataclasses.replace(PipelineConfig(), refiner=rcfg)
    step = data_parallel.make_sharded_outer_step(mesh, cfg)
    state = mesh_lib.replicate(mesh, trainer.init_train_state(j_reg, cfg, seed=seed))
    t0 = time.perf_counter()
    new_state, m, res = step(state, mesh_lib.replicate(mesh, model),
                             mesh_lib.shard_batch(mesh, init), mesh_lib.shard_batch(mesh, data))
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)
    seconds = time.perf_counter() - t0
    assert new_state.step == 1 and res.params.pose6d.shape[0] == batch // mesh.world_size
    assert all(bool(torch.isfinite(x).all()) for x in res.params), "non-finite refined params"
    # The shared state is the same on every rank.
    j = new_state.j_reg_raw
    same = mesh_lib.max_over_ranks(mesh, [j])[0]
    assert torch.equal(same, j), "ranks left different regressors"
    return seconds, float(m.mpjpe_after_jreg_step)


def worker(device: str) -> None:
    from jrr_tpu_torch.parallel import mesh as mesh_lib, multihost

    multihost.initialize(backend="nccl" if device == "cuda" else "gloo", timeout_s=600)
    try:
        mesh = multihost.global_mesh(device=device)
        n = mesh.world_size
        batch = n * max(2, -(-8 // n))
        s1, mpjpe = _phase(mesh, batch, 96, 32, seed=0)
        if mesh.is_lead:
            print(f"dryrun OK (tiny): {n} processes, batch {batch}, {s1:.1f}s, "
                  f"mpjpe_after={mpjpe:.2f}mm", flush=True)
        s2, _ = _phase(mesh, n, 6890, 224, seed=1)
        if mesh.is_lead:
            print(f"dryrun OK (full-size): {n} processes x 1 frame, {s2:.1f}s, "
                  f"{n / s2:.3f} frames/s total ({1.0 / s2:.3f} frames/s/process) on "
                  f"{mesh.device.type}", flush=True)
    finally:
        multihost.shutdown()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--nproc", type=int, default=None,
                   help="processes (default: the host's cards; 2 with --device cpu)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--timeout", type=float, default=900.0, help="seconds before every rank is killed")
    p.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.worker:
        worker(args.device)
        return 0
    from jrr_tpu_torch import resolve_device
    from jrr_tpu_torch.parallel import multihost

    resolve_device(args.device)
    n = args.nproc or (torch.cuda.device_count() if args.device == "cuda" else 2)
    res = multihost.launch_local(
        [sys.executable, "-m", "jrr_tpu_torch.parallel.dryrun", "--worker", "--device", args.device],
        n, args.timeout)
    for rank, (rc, log) in enumerate(zip(res.returncodes, res.logs)):
        sys.stdout.write(log["stdout"])
        if rc != 0:
            sys.stderr.write(f"rank {rank} exited {rc}:\n{log['stderr'][-4000:]}\n")
    return 0 if all(rc == 0 for rc in res.returncodes) else 1


if __name__ == "__main__":
    sys.exit(main())
