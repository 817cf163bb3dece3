"""The matmul precision of a block of code."""

from __future__ import annotations

import contextlib

import torch

__all__ = ["full_f32_matmul"]


@contextlib.contextmanager
def full_f32_matmul():
    """f32 matmuls at full precision (TF32 off) for the duration."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
