"""Elementwise ops of the model's path.

Counterparts of ``blocksparse_tpu/ops/ewops.py`` ``swish``,
``fast_gelu`` and ``float_cast``.  Plain PyTorch, as the JAX package
leaves them to XLA.
"""
from __future__ import annotations

import torch

_FLOATS = (torch.float32, torch.float16, torch.bfloat16)


def swish(x, alpha=1.0, name=None):
    return x * torch.sigmoid(alpha * x)


def fast_gelu(x, name=None):
    """sigmoid-approx gelu == swish(1.702)."""
    return swish(x, alpha=1.702)


def float_cast(x, dtype, dx_dtype=None, name=None):
    """Cast to a float dtype, with an independently chosen dtype for the
    gradient on the way back (default: x's), as the JAX ``float_cast``.
    ``name`` (here and above) is accepted and ignored."""
    if dtype not in _FLOATS:
        raise ValueError("Only float32/float16/bfloat16 supported.")
    if x.dtype == dtype:
        return x
    if dx_dtype is None or dx_dtype == x.dtype:
        return x.to(dtype)
    return _FloatCast.apply(x, dtype, dx_dtype)


class _FloatCast(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, dtype, dx_dtype):
        ctx.dx_dtype = dx_dtype
        return x.to(dtype)

    @staticmethod
    def backward(ctx, dy):
        return dy.to(ctx.dx_dtype), None, None
