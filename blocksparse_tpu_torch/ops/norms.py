"""Layer norm and batch norm.

Counterparts of ``blocksparse_tpu/ops/norms.py``: ``layer_norm``,
``batch_norm``, ``batch_norm_inference`` and the NumPy goldens
(``*_test``).  Plain PyTorch, as the JAX package leaves them to XLA;
gradients are autograd's.  Statistics are always computed in float32.
"""
from __future__ import annotations

import numpy as np
import torch

from blocksparse_tpu_torch.utils import reduce_mul


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


def batch_norm_inference(x, g, b, m, v, epsilon=1e-6):
    """NC[DHW] batch norm with given per-channel mean m and variance v."""
    shape = x.shape
    C = shape[1]
    f32 = torch.float32

    def ch(t):
        return t.reshape(1, C, 1).to(f32)
    xr = x.reshape(shape[0], C, -1).to(f32)
    y = (xr - ch(m)) * torch.rsqrt(ch(v) + epsilon) * ch(g) + ch(b)
    return y.reshape(shape).to(x.dtype)


def batch_norm(x, g, b, epsilon=1e-6):
    """NC[DHW] batch norm over the batch and spatial dims; returns (y,
    mean, var), the statistics per channel in f32."""
    shape = x.shape
    C = shape[1]
    f32 = torch.float32
    xr = x.reshape(shape[0], C, -1).to(f32)
    mean = xr.mean(dim=(0, 2), keepdim=True)
    var = (xr - mean).square().mean(dim=(0, 2), keepdim=True)
    y = (xr - mean) * torch.rsqrt(var + epsilon) \
        * g.reshape(1, C, 1).to(f32) + b.reshape(1, C, 1).to(f32)
    return y.reshape(shape).to(x.dtype), mean.reshape(C), var.reshape(C)


# ---------------- NumPy goldens ----------------

def _2d(K, axis, *arrays):
    if axis == 0:
        return [a.reshape(K, -1) for a in arrays]
    return [a.reshape(-1, K) for a in arrays]


def _segments(K, segments, axis):
    K //= segments
    for s in range(segments):
        segK = slice(s * K, s * K + K)
        yield (segK, slice(None)) if axis == 0 else (slice(None), segK)


def layer_norm_test(x, g, b, axis=1, segments=1, epsilon=1e-6, relu=False):
    x_shape = x.shape
    K = x_shape[axis]
    axis = 0 if axis == 0 else 1
    x, = _2d(K, axis, x)
    g, b = (a.reshape((K, 1) if axis == 0 else (1, K)) for a in (g, b))
    y = np.empty_like(x)
    for seg in _segments(K, segments, axis):
        mean = np.mean(x[seg], axis=axis, keepdims=True)
        var = np.var(x[seg], axis=axis, keepdims=True)
        rstd = np.reciprocal(np.sqrt(var + epsilon))
        y[seg] = (x[seg] - mean) * rstd * g[seg] + b[seg]
        if relu:
            y[seg] = np.maximum(y[seg], 0.0)
    return y.reshape(x_shape)


def layer_norm_grad_test(dy, x, g, b, axis=1, segments=1, epsilon=1e-6,
                         relu=False):
    x_shape = x.shape
    K = x_shape[axis]
    axis = 0 if axis == 0 else 1
    dy, x = _2d(K, axis, dy, x)
    g, b = (a.reshape((K, 1) if axis == 0 else (1, K)) for a in (g, b))
    dy = dy.copy()
    dx = np.empty_like(dy)
    dg = np.empty_like(g)
    db = np.empty_like(b)
    Ks = K // segments
    for seg in _segments(K, segments, axis):
        mean = np.mean(x[seg], axis=axis, keepdims=True)
        xstdr = np.reciprocal(np.sqrt(np.var(x[seg], axis=axis,
                                             keepdims=True) + epsilon))
        xhat = (x[seg] - mean) * xstdr
        if relu:
            dy[seg] = dy[seg] * ((xhat * g[seg] + b[seg]) > 0.0)
        dg[seg] = np.sum(dy[seg] * xhat, axis=1 - axis, keepdims=True)
        db[seg] = np.sum(dy[seg], axis=1 - axis, keepdims=True)
        dy[seg] = dy[seg] * g[seg]
        sum1 = np.sum(xhat * dy[seg], axis=axis, keepdims=True)
        sum2 = np.sum(dy[seg], axis=axis, keepdims=True)
        dx[seg] = (dy[seg] - ((xhat * sum1 + sum2) / float(Ks))) * xstdr
    return dx.reshape(x_shape), dg, db


def _nc1(x, *chans):
    N, C = x.shape[0], x.shape[1]
    return [x.reshape(N, C, -1)] + [a.reshape(1, C, 1) for a in chans]


def batch_norm_inf_test(x, g, b, m, v, epsilon=1e-6):
    xs, g, b, m, v = _nc1(x, g, b, m, v)
    rstd = np.reciprocal(np.sqrt(v + epsilon))
    return ((xs - m) * rstd * g + b).reshape(x.shape)


def batch_norm_test(x, g, b, epsilon=1e-6):
    C = x.shape[1]
    xs, g, b = _nc1(x, g, b)
    mean = np.mean(xs, axis=(0, 2), keepdims=True)
    var = np.var(xs, axis=(0, 2), keepdims=True)
    rstd = np.reciprocal(np.sqrt(var + epsilon))
    return ((xs - mean) * rstd * g + b).reshape(x.shape), \
        mean.reshape(C), var.reshape(C)


def batch_norm_grad_test(dy, x, g, m, v, epsilon=1e-6):
    C = x.shape[1]
    rNDHW = 1.0 / reduce_mul(x.shape[2:], x.shape[0])
    dys, = _nc1(dy)
    xs, g, m, v = _nc1(x, g, m, v)
    rstd = np.reciprocal(np.sqrt(v + epsilon))
    xhat = (xs - m) * rstd
    dg = np.sum(dys * xhat, axis=(0, 2), keepdims=True)
    db = np.sum(dys, axis=(0, 2), keepdims=True)
    z = (xhat * dg + db) * rNDHW
    dx = (dys - z) * rstd * g
    return dx.reshape(x.shape), dg.reshape(C), db.reshape(C)
