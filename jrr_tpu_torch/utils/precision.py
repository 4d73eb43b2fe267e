"""Float32 products on the card.

cuBLAS and cuDNN may run float32 matmuls and convolutions in TF32 (a 10-bit
mantissa) on Hopper. The refinement, SPIN and the consumers compute in full
float32 instead, as jrr_tpu does on the CPU (ROADMAP Queue 3): each entry
point runs its work inside `float32_products()`.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def float32_products():
    """TF32 off for matmuls and cuDNN inside; the caller's flags restored
    on every exit, exceptions included."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
