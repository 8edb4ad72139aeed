"""Layer norm.

Counterpart of ``blocksparse_tpu/ops/norms.py:layer_norm``.  Plain
PyTorch, as the JAX package leaves it to XLA; its gradient is autograd's.
Statistics are always computed in float32.
"""
from __future__ import annotations

import torch


def layer_norm(x, g, b, axis=1, segments=1, epsilon=1e-6, relu=False,
               atomics=True, bench=0, use_tf=False):
    """Layer norm over the feature axis (0 = feature-major "CN", else the
    last axis), with optional independent segments and fused relu.
    ``atomics``, ``bench`` and ``use_tf`` are the reference's knobs,
    accepted and ignored."""
    x_shape = x.shape
    if axis < 0:
        axis += x.dim()
    K = x_shape[0] if axis == 0 else x_shape[-1]
    if g.numel() != K or b.numel() != K or K % segments:
        raise ValueError("gain/bias must match the feature axis, which "
                         "must divide into segments")
    f32 = torch.float32
    if axis == 0:
        xs = x.reshape(segments, K // segments, -1).to(f32)
        gs = g.reshape(segments, K // segments, 1).to(f32)
        bs = b.reshape(segments, K // segments, 1).to(f32)
        red = 1
    else:
        xs = x.reshape(-1, segments, K // segments).to(f32)
        gs = g.reshape(1, segments, K // segments).to(f32)
        bs = b.reshape(1, segments, K // segments).to(f32)
        red = 2
    mean = xs.mean(dim=red, keepdim=True)
    var = (xs - mean).square().mean(dim=red, keepdim=True)
    y = (xs - mean) * torch.rsqrt(var + epsilon) * gs + bs
    if relu:
        y = torch.relu(y)
    return y.reshape(x_shape).to(x.dtype)
