"""Data-parallel wrappers for the refinement engine and the outer training
step (counterpart of jrr_tpu/parallel/data_parallel.py).

jrr_tpu jits each with frames sharded over the mesh and shared state
replicated, and XLA emits the all-reduces. Here each process calls the
wrapper on its rows (`mesh.shard_batch`) and the replicated state
(`mesh.replicate`); the wrappers pass the mesh down, so the loss means are
scaled to the global batch and the shared gradients and metrics are
reduced (refine/trainer.py). The callables take jrr_tpu's arguments and
return its outputs: per-frame results are this process's rows, the state,
the metrics and the loss curves global.
"""

from __future__ import annotations

from jrr_tpu_torch.config import PipelineConfig, RefinerConfig
from jrr_tpu_torch.parallel import mesh as mesh_lib
from jrr_tpu_torch.refine import engine, trainer


def make_sharded_refine(mesh: mesh_lib.Mesh, cfg: RefinerConfig, freeze_hand_feet: bool = False):
    """refine_batch on this process's rows: fn(model, j_reg_raw, init, data,
    pose_disc, shape_disc) → RefineResult with global loss curves and
    rasterizer counters (one sum and one maximum over the processes)."""
    share = 1.0 / mesh.world_size if mesh.distributed else 1.0

    def step(model, j_reg_raw, init, data, pose_disc, shape_disc):
        res = engine.refine_batch(
            model, j_reg_raw, init, data, cfg, pose_disc=pose_disc, shape_disc=shape_disc,
            freeze_hand_feet=freeze_hand_feet, batch_share=share,
        )
        if not mesh.distributed:
            return res
        (stage_a, *terms), stats = trainer.sum_means_and_counters(
            mesh, [res.stage_a_loss, *res.stage_b_terms], res.chunk_stats)
        return res._replace(stage_a_loss=stage_a, stage_b_terms=type(res.stage_b_terms)(*terms),
                            bin_stats=res.bin_stats if stats is None else stats)

    return step


def make_sharded_outer_step(mesh: mesh_lib.Mesh, cfg: PipelineConfig):
    """trainer.outer_step on this process's rows: fn(state, model, spin_init,
    data) → (state, OuterMetrics, RefineResult), the state and metrics the
    same on every process."""

    def step(state, model, spin_init, data):
        return trainer.outer_step(state, model, spin_init, data, cfg, mesh=mesh)

    return step


def host_shard_slice(global_batch: int, num_hosts: int, host_id: int) -> slice:
    """Contiguous per-host slice of the global frame batch."""
    per = global_batch // num_hosts
    return slice(host_id * per, (host_id + 1) * per)
