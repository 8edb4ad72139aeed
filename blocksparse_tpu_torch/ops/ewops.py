"""Elementwise ops.

Counterparts of ``blocksparse_tpu/ops/ewops.py``, plain PyTorch, as the
JAX package leaves them to XLA.  Most are thin wrappers kept for the
public surface; these carry semantics of their own:

* ``float_cast``: independent forward and backward cast dtypes;
* ``dropout``: an explicit mask, returned and taken back for reuse (a
  recomputed forward drops the same elements), broadcast by
  ``mask_shape``;
* ``filter_tensor``: inf/nan scrubbing, saturation and scale, with the
  gradient filtered the same way;
* ``concrete_gate``: the L0-norm hard-concrete gate.

The random ops take a ``torch.Generator`` where the JAX ones take a
``key``; given none they draw from the global generator of their
tensor's device, ``utils.get_entropy(device)``.  ``name`` arguments are
accepted and ignored.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from blocksparse_tpu_torch.utils import get_entropy

_FLOATS = (torch.float32, torch.float16, torch.bfloat16)
_F32 = torch.float32


# ---------------- the unary and binary family ----------------

def add(x, y, name=None): return torch.add(x, y)
def multiply(x, y, name=None): return torch.mul(x, y)
def subtract(x, y, name=None): return torch.sub(x, y)
def divide(x, y, name=None): return torch.div(x, y)
def maximum(x, y, name=None): return torch.maximum(x, y)
def minimum(x, y, name=None): return torch.minimum(x, y)
def negative(x, name=None): return torch.neg(x)
def reciprocal(x, name=None): return torch.reciprocal(x)
def square(x, name=None): return torch.square(x)
def sqrt(x, name=None): return torch.sqrt(x)
def exp(x, name=None): return torch.exp(x)
def log(x, name=None): return torch.log(x)
def sigmoid(x, name=None): return torch.sigmoid(x)
def tanh(x, name=None): return torch.tanh(x)
def relu(x, name=None): return torch.relu(x)


def elu(x, alpha=1.0, name=None):
    return F.elu(x, alpha)


_SQRT_2_OVER_PI = float(np.sqrt(2.0 / np.pi).astype(np.float32))


def gelu(x, alpha=0.044715, name=None):
    """tanh-approx gelu."""
    return 0.5 * x * (1.0 + torch.tanh(
        _SQRT_2_OVER_PI * (x + alpha * x * x * x)))


def swish(x, alpha=1.0, name=None):
    return x * torch.sigmoid(alpha * x)


def fast_gelu(x, name=None):
    """sigmoid-approx gelu == swish(1.702)."""
    return swish(x, alpha=1.702)


def add_n8(xs, name=None):
    if len(xs) > 8:
        raise ValueError("add_n8 takes at most 8 tensors")
    return add_n(list(xs))


def add_n(xs, name=None):
    """Sum of a list of tensors, left to right."""
    xs = list(xs)
    total = xs[0]
    for x in xs[1:]:
        total = total + x
    return total


# ---------------- filter_tensor / scale_tensor ----------------

def _filter_val(x, scale, saturate, zero_infs, zero_nans):
    f = x.to(_F32)
    if zero_infs:
        f = torch.where(torch.isinf(f), torch.zeros_like(f), f)
    if zero_nans:
        f = torch.where(torch.isnan(f), torch.zeros_like(f), f)
    if saturate:
        f = f.clamp(-saturate, saturate)
    return (f * scale).to(x.dtype)


class _FilterTensor(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, scale, saturate, zero_infs, zero_nans):
        ctx.args = (saturate, zero_infs, zero_nans)
        ctx.save_for_backward(scale)
        return _filter_val(x, scale, saturate, zero_infs, zero_nans)

    @staticmethod
    def backward(ctx, dy):
        (scale,) = ctx.saved_tensors
        return _filter_val(dy, scale, *ctx.args), None, None, None, None


def filter_tensor(x, scale=1.0, saturate=0.0, zero_infs=False,
                  zero_nans=False):
    """y = scale · scrub(x), computed in f32 and cast back to x's dtype;
    the gradient is scrubbed and scaled the same way."""
    scale = torch.as_tensor(scale, dtype=_F32, device=x.device)
    return _FilterTensor.apply(x, scale, float(saturate), zero_infs,
                               zero_nans)


filter_tensor_op = filter_tensor


def scale_tensor(x, scale=1.0):
    return filter_tensor(x, scale=scale)


# ---------------- float_cast ----------------

def float_cast(x, dtype, dx_dtype=None, name=None):
    """Cast to a float dtype, with an independently chosen dtype for the
    gradient on the way back (default: x's)."""
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


# ---------------- random draws ----------------

def uniform(shape, device, generator=None):
    """U[0, 1) f32 of ``shape`` on ``device``, drawn from ``generator``
    (on its own device) or from the global entropy generator of
    ``device``."""
    g = get_entropy(device) if generator is None else generator
    return torch.rand(shape, generator=g, device=g.device).to(device)


# ---------------- dropout ----------------

def dropout(x, keep_prob, mask=None, mask_shape=None, generator=None):
    """Returns (y, mask): y = x / keep_prob where the bool mask is set, 0
    elsewhere (the scale in x's dtype, as the JAX op).  Pass the mask
    back to drop the same elements again; without one it is drawn as
    U[0, 1) < keep_prob over ``mask_shape`` (each dim 1 or x's; default
    x's shape)."""
    if mask is None:
        shape = tuple(x.shape)
        if mask_shape is not None and len(mask_shape) > 0:
            for m_dim, x_dim in zip(mask_shape, x.shape):
                if m_dim != 1 and m_dim != x_dim:
                    raise ValueError(f"incompatible mask_shape: {mask_shape}"
                                     f" x.shape: {tuple(x.shape)}")
            shape = tuple(mask_shape)
        mask = uniform(shape, x.device, generator) < float(keep_prob)
    scale = torch.full((), 1.0 / float(keep_prob), dtype=x.dtype,
                       device=x.device)
    y = torch.where(mask, x * scale, torch.zeros((), dtype=x.dtype,
                                                 device=x.device))
    return y, mask


# ---------------- concrete gate (L0 pruning) ----------------

def _concrete_gate(loga, u, tempurature, limit_a, limit_b):
    s = torch.sigmoid((torch.log(u) - torch.log(1.0 - u)
                       + loga.to(_F32)) / tempurature)
    sbar = s * (limit_b - limit_a) + limit_a
    return sbar.clamp(0.0, 1.0).to(loga.dtype)


def concrete_gate(loga, tempurature=2.0 / 3.0, limit_a=-0.1, limit_b=1.1,
                  epsilon=1e-6, generator=None):
    """A hard-concrete gate sample, u ~ U[epsilon, 1 - epsilon)."""
    u = uniform(loga.shape, loga.device, generator)
    u = epsilon + u * ((1.0 - epsilon) - epsilon)
    return _concrete_gate(loga, u, tempurature, limit_a, limit_b)


def concrete_gate_infer(loga, limit_a=-0.1, limit_b=1.1):
    s = torch.sigmoid(loga.to(_F32))
    return (s * (limit_b - limit_a) + limit_a).clamp(0.0, 1.0).to(
        loga.dtype)


# ---------------- bias_relu ----------------

def bias_relu(x, b, axis=-1, relu=False, fast_gelu=False, atomics=True,
              bench=0, use_tf=False):
    """Bias add along ``axis`` and an optional relu or fast gelu.
    ``atomics``, ``bench`` and ``use_tf`` are accepted and ignored."""
    if relu and fast_gelu:
        raise ValueError("relu and fast_gelu can not both be enabled.")
    if b.dim() > 1:
        y = x + b
    else:
        bshape = [1] * x.dim()
        bshape[axis] = b.shape[0]
        y = x + b.reshape(bshape).to(x.dtype)
    if relu:
        y = torch.relu(y)
    elif fast_gelu:
        y = y * torch.sigmoid(1.702 * y)
    return y


# ---------------- fancy_gather ----------------

def fancy_gather(x, idx, use_tf=False):
    """y[i0..ik] = x[i0..ik, idx[i0..ik], ...] (negative ids read 0)."""
    i_rank = idx.dim()
    if x.dim() <= i_rank:
        raise ValueError("x needs more dims than idx")
    idx = idx.clamp(min=0).to(torch.int64)
    expanded = idx.reshape(tuple(idx.shape) + (1,) * (x.dim() - i_rank))
    expanded = expanded.expand(tuple(idx.shape) + (1,)
                               + tuple(x.shape[i_rank + 1:]))
    return torch.gather(x, i_rank, expanded).squeeze(i_rank)


def fancy_gather_test(x, idx):
    """NumPy golden of ``fancy_gather``."""
    x = np.asarray(x)
    idx = np.asarray(idx)
    flat = x.reshape((-1,) + x.shape[idx.ndim + 1:])
    stride = x.shape[idx.ndim]
    base = np.arange(idx.size) * stride + np.maximum(idx.reshape(-1), 0)
    return flat[base].reshape(idx.shape + x.shape[idx.ndim + 1:])


# ---------------- reduce_max ----------------

def reduce_max(x, axis, keepdims=False, use_tf=False):
    """Max over ``axis``; the gradient is shared among tied maxima, as
    JAX's."""
    return torch.amax(x, dim=axis, keepdim=keepdims)


# ---------------- assign_add ----------------

def assign_add(y, x, name=None):
    """y += x in place; returns y."""
    return y.add_(x)


def replace_add_n():
    """The reference patched tf.add_n with its fused trees; nothing to do
    here."""


def restore_add_n():
    """See ``replace_add_n``."""
