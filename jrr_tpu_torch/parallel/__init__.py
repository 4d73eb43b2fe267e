"""Multi-GPU execution (counterpart of jrr_tpu/parallel/).

jrr_tpu shards the frame batch over a 1-D device mesh, keeps the regressor
and the discriminators replicated and lets XLA insert the all-reduces. The
port runs one process per GPU under `torch.distributed` (NCCL on the card,
gloo on the CPU), launched by `torchrun` or `multihost.launch_local`: each
process refines its contiguous rows of every batch, and the shared state's
gradients, the batch-mean metrics, the lstsq statistics and the refined
rows meet in a few collectives per outer step, all issued by each process's
main thread in the same order (`mesh.py`, `refine/trainer.py`,
`pipeline.py`). With `torch.distributed` not initialized nothing here
issues a collective and every path is the one-process path.
"""
