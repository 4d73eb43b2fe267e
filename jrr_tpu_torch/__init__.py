"""PyTorch/CUDA port of `jrr_tpu` for one NVIDIA H100.

Mirrors `jrr_tpu/`'s module layout and function names; the JAX package is the
reference each part is held against (tests/test_torch_*.py). This package
imports torch, numpy and the standard library only — never JAX or anything
under `jrr_tpu` — and keeps its own copies of what it needs.

Entry points that create state (`models.smpl.synthetic_smpl_model`,
`problem.synthetic_problem`, the discriminator constructors,
`ops.rotations.random_rotmat`, the probes' input builders,
`data.fixtures.write_fixture_dataset`, `pipeline.run_pipeline` and the CLI
`python -m jrr_tpu_torch.cli`) run on "cuda" unless the caller passes
`device="cpu"` (`--device cpu`); without a card they raise instead of moving
to the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """`device` as a torch.device; a CUDA device without a card raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "jrr_tpu_torch: a CUDA device was requested but torch.cuda is not "
            "available; pass device='cpu' to run on the CPU"
        )
    return dev
