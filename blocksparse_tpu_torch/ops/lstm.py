"""Fused LSTM ops.

Counterpart of ``blocksparse_tpu/ops/lstm.py``: the fused gate math
(``fused_lstm_gates``, gate order i, u, f, o, in f32), its NumPy golden,
``split4``/``concat4``, ``sparse_relu``, the dense ``FusedBasicLSTMCell``
and the multi-timestep ``grouped_lstm`` with its 4-segment layer norm on
the gates.  Plain PyTorch, as the JAX package leaves them to XLA;
gradients are autograd's.  JAX's ``lax.scan`` over time is a Python loop
here, and autograd sums a shared kernel's gradients over the timesteps,
so ``group_lstm_grads`` returns its input.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from blocksparse_tpu_torch.ops.norms import layer_norm
from blocksparse_tpu_torch.utils import default_device


def fused_lstm_gates(c, *args, bias=None, forget_bias=1.0, name=None):
    """(c_next, h_next) from the cell state c and the pre-activation gates.

    args: one fused tensor h (N, 4·width), split on axis 1 in gate order
    i, u, f, o, with an optional ``bias`` (4·width,); or the four gate
    tensors (no bias in that form).  Computed in f32; c_next in c's dtype,
    h_next in the (first) gate tensor's."""
    f32 = torch.float32
    if len(args) == 1:
        h = args[0]
        if bias is not None:
            h = h + bias.reshape(1, -1).to(h.dtype)
        i, u, f, o = split4(h.to(f32))
    else:
        if len(args) != 4:
            raise ValueError("args are one fused tensor or i, u, f, o")
        if bias is not None:
            raise ValueError("bias is not enabled with four gate tensors")
        i, u, f, o = (a.to(f32) for a in args)
    c_next = c.to(f32) * torch.sigmoid(f + forget_bias) \
        + torch.sigmoid(i) * torch.tanh(u)
    h_next = torch.tanh(c_next) * torch.sigmoid(o)
    return c_next.to(c.dtype), h_next.to(args[0].dtype)


def lstm_gates_test(c, h, bias=None, forget_bias=1.0):
    """NumPy golden of ``fused_lstm_gates`` (the fused form)."""
    if bias is not None:
        h = h + bias.reshape(1, -1)
    i, u, f, o = np.split(h, 4, axis=1)

    def sig(x):
        return 1.0 / (1.0 + np.exp(-x))
    c_next = c * sig(f + forget_bias) + sig(i) * np.tanh(u)
    h_next = np.tanh(c_next) * sig(o)
    return c_next, h_next


def split4(x):
    """The four equal parts of x along axis 1."""
    if x.shape[1] % 4:
        raise ValueError("axis 1 must split into 4 equal parts")
    return tuple(torch.split(x, x.shape[1] // 4, dim=1))


def concat4(x0, x1, x2, x3):
    return torch.cat([x0, x1, x2, x3], dim=1)


def sparse_relu(x, alpha=1.0):
    """Relu thresholded at each row's mean + alpha·std (population std, in
    f32): max(max(x, cutoff) - cutoff, 0).  The cutoff is detached, so the
    gradient is the thresholded relu's."""
    xf = x.to(torch.float32)
    mean = xf.mean(dim=-1, keepdim=True)
    std = xf.std(dim=-1, keepdim=True, correction=0)
    cutoff = (mean + alpha * std).detach()
    # torch.maximum splits the gradient at ties as jnp.maximum does
    return torch.maximum(torch.maximum(xf, cutoff) - cutoff,
                         xf.new_zeros(())).to(x.dtype)


def sparse_relu_test(x, alpha=1.0):
    axis = x.ndim - 1
    mean = np.mean(x, axis=axis, keepdims=True)
    std = np.std(x, axis=axis, keepdims=True)
    cutoff = mean + alpha * std
    return np.maximum(np.maximum(x, cutoff) - cutoff, 0.0)


class FusedBasicLSTMCell(nn.Module):
    """One dense LSTM step: one matmul for all four gates, then the fused
    gate math.  ``kernel`` (in_width + num_units, 4·num_units) and
    ``bias`` (4·num_units,) start as zeros: load the JAX cell's params
    (``load_state_dict({"kernel": ..., "bias": ...})``), the counterpart
    of its ``init``.  On ``device``, by default the card.

    h, (c, h) = cell(inputs, (c, h))"""

    def __init__(self, num_units, in_width, forget_bias=1.0, device=None):
        super().__init__()
        self.num_units = num_units
        self.forget_bias = forget_bias
        dev = default_device(device, "FusedBasicLSTMCell")
        self.kernel = nn.Parameter(torch.zeros(
            (in_width + num_units, 4 * num_units), device=dev))
        self.bias = nn.Parameter(torch.zeros(4 * num_units, device=dev))

    def forward(self, inputs, state):
        c, h = state
        gates = torch.cat([inputs, h], dim=1) @ self.kernel
        c, h = fused_lstm_gates(c, gates, bias=self.bias,
                                forget_bias=self.forget_bias)
        return h, (c, h)


def grouped_lstm_init(key, in_width, width, layernorm=True,
                      dtype=torch.float32):
    """Params of ``grouped_lstm`` drawn from the ``torch.Generator`` key,
    on its device, with the JAX initialiser's shapes and scales: kernel
    U(±1/sqrt(in_width + width)), bias 0, gain 1 (with layernorm)."""
    scale = 1.0 / np.sqrt(in_width + width)
    dev = key.device
    kernel = torch.rand((in_width + width, 4 * width), generator=key,
                        device=dev) * (2 * scale) - scale
    params = {"kernel": kernel.to(dtype),
              "bias": torch.zeros(4 * width, dtype=dtype, device=dev)}
    if layernorm:
        params["gain"] = torch.ones(4 * width, dtype=dtype, device=dev)
    return params


def grouped_lstm(inputs, width, timesteps, initial_state, params,
                 layernorm=True, forget_bias=1.0):
    """The LSTM over all timesteps, with an optional 4-segment layer norm
    on the gates.  inputs (N, T, in_width); initial_state [c, h], each (N,
    width); params kernel, bias and (with layernorm) gain.  Returns
    (outputs (N, T, width), [c, h])."""
    c, h = initial_state
    w, b, g = params["kernel"], params["bias"], params.get("gain")
    ys = []
    for t in range(inputs.shape[1]):
        gates = torch.cat([inputs[:, t], h], dim=1) @ w
        if layernorm:
            gates = layer_norm(gates, g, b, axis=1, segments=4)
            c, h = fused_lstm_gates(c, gates, forget_bias=forget_bias)
        else:
            c, h = fused_lstm_gates(c, gates, bias=b,
                                    forget_bias=forget_bias)
        ys.append(h)
    return torch.stack(ys, dim=1), [c, h]


def group_lstm_grads(grads, params, scope="grouped_lstm", group_size=None):
    """Returns its input: autograd already sums the shared kernel's
    gradients over the timesteps."""
    return grads
