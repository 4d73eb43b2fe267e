"""Process-group set-up and local launching (counterpart of
jrr_tpu/parallel/multihost.py).

jrr_tpu runs one process per host over `jax.distributed`; the port runs one
process per GPU over `torch.distributed`. A process group is formed by
`torchrun` (its RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and MASTER_PORT)
or by `launch_local`, which starts the processes itself and names a
`file://` (or any) init method in JRR_DIST_INIT_METHOD. A lone process
with nothing configured stays a plain process: `initialize` does nothing.
Every group gets a timeout, so a rank that dies or disagrees ends the
others' collectives with an error instead of a hang.
"""

from __future__ import annotations

import datetime
import os
import shutil
import subprocess
import tempfile
import time
from typing import Any, Dict, List, NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist

from jrr_tpu_torch.parallel import mesh as mesh_lib

INIT_METHOD_ENV = "JRR_DIST_INIT_METHOD"
# A collective waits at most this long for the other ranks. It covers rank
# 0's protocol-2 eval and fit, which the others wait out at a barrier.
DEFAULT_TIMEOUT_S = 1800.0


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> None:
    """`torch.distributed.init_process_group` from the arguments, else from
    the environment (WORLD_SIZE, RANK; the init method from
    JRR_DIST_INIT_METHOD, else torchrun's env://); a no-op for one process
    with nothing configured, or when a group exists. `coordinator_address`
    is an init-method URL or host:port. `backend`: "nccl" when a card is
    present (this process's card, cuda:LOCAL_RANK, made current), else
    "gloo"."""
    env = os.environ
    if mesh_lib.initialized():
        return
    if coordinator_address is None and num_processes in (None, 1) and "WORLD_SIZE" not in env:
        return
    world = int(num_processes if num_processes is not None else env.get("WORLD_SIZE", 1))
    rank = int(process_id if process_id is not None else env.get("RANK", 0))
    init = coordinator_address or env.get(INIT_METHOD_ENV) or "env://"
    if "://" not in init:
        init = "tcp://" + init
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(int(env.get("LOCAL_RANK", rank % max(torch.cuda.device_count(), 1))))
    dist.init_process_group(backend, init_method=init, world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))


def shutdown() -> None:
    """Destroy the process group, if there is one."""
    if mesh_lib.initialized():
        dist.destroy_process_group()


def process_info() -> dict:
    """jrr_tpu's four keys. Each process drives one device, so the local
    device count is 1 and the global one the process count."""
    world, rank = (dist.get_world_size(), dist.get_rank()) if mesh_lib.initialized() else (1, 0)
    return {"process_index": rank, "process_count": world, "local_device_count": 1,
            "global_device_count": world}


def global_mesh(axis: str = mesh_lib.DATA_AXIS, device="cuda") -> mesh_lib.Mesh:
    """The mesh over every process (frames sharded globally)."""
    return mesh_lib.make_mesh(None, axis=axis, device=device)


def global_batch_from_local(mesh: mesh_lib.Mesh, local_tree: Any,
                            axis: str = mesh_lib.DATA_AXIS) -> Any:
    """The global batch from each process's rows (BatchLoader's
    num_hosts/host_id or `data_parallel.host_shard_slice`), in rank order,
    on this process's device: what `np.asarray` of jrr_tpu's global array
    gives. One all-gather; equal row counts on every process."""
    local = mesh_lib.tree_map(lambda x: mesh_lib._as_tensor(x, mesh.device), local_tree)
    return mesh_lib.gather_rows(mesh, local)


class LaunchResult(NamedTuple):
    returncodes: List[int]
    logs: List[Dict[str, str]]  # per rank: "stdout", "stderr"


def launch_local(
    argv: Sequence[str],
    nproc: int,
    timeout_s: float,
    init_method: Optional[str] = None,
    env: Optional[Dict[str, str]] = None,
    cwd: Optional[str] = None,
) -> LaunchResult:
    """Run `argv` as `nproc` processes of one group on this host (RANK,
    WORLD_SIZE, LOCAL_RANK and JRR_DIST_INIT_METHOD set; `init_method`
    defaults to a file:// store in a new temporary directory). Waits at
    most `timeout_s`: past it, or as soon as one process fails, the rest
    are killed. Raises TimeoutError on the deadline; returns every
    process's exit code and output otherwise."""
    tmp = tempfile.mkdtemp(prefix="jrr_launch_")
    init_method = init_method or "file://" + os.path.join(tmp, "store")
    procs, files = [], []
    try:
        for rank in range(nproc):
            penv = dict(os.environ if env is None else env)
            penv.update(RANK=str(rank), WORLD_SIZE=str(nproc), LOCAL_RANK=str(rank),
                        **{INIT_METHOD_ENV: init_method})
            out = open(os.path.join(tmp, f"rank{rank}.out"), "w+")
            err = open(os.path.join(tmp, f"rank{rank}.err"), "w+")
            files.append((out, err))
            procs.append(subprocess.Popen(list(argv), env=penv, cwd=cwd, stdout=out, stderr=err,
                                          stdin=subprocess.DEVNULL))
        deadline = time.monotonic() + timeout_s
        timed_out = False
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs):
                break  # one failed: the others would wait on it until their timeout
            if time.monotonic() > deadline:
                timed_out = True
                break
            time.sleep(0.05)
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
        logs = []
        for out, err in files:
            out.seek(0)
            err.seek(0)
            logs.append({"stdout": out.read(), "stderr": err.read()})
        if timed_out:
            tails = "\n".join(f"rank {r}: {log['stderr'][-2000:]}" for r, log in enumerate(logs))
            raise TimeoutError(f"{nproc} processes of {list(argv)} ran past {timeout_s} s\n{tails}")
        return LaunchResult([p.returncode for p in procs], logs)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for out, err in files:
            out.close()
            err.close()
        shutil.rmtree(tmp, ignore_errors=True)
