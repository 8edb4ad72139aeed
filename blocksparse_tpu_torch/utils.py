"""Host-side helpers: shape math, z-order curves, magic division, the
random source of the random ops, and the attention layouts that emulate
a (de)convolution.

Counterpart of ``blocksparse_tpu/utils.py``, kept as the port's own copy
(that module imports jax).  Everything here is plain Python and NumPy
except the entropy source, a seeded ``torch.Generator`` a device that
``dropout``, ``concrete_gate`` and stochastic ``quantize`` draw from when
they are given no generator of their own.
"""
from __future__ import annotations

from functools import reduce
from operator import mul

import numpy as np
import torch


# ------------------------------------------------------------------
# small math helpers
# ------------------------------------------------------------------

def ceil_div(x: int, y: int) -> int:
    return -(-x // y)


def reduce_mul(vals, init=1):
    return reduce(mul, vals, init)


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def z_order_2d(x: int, y: int) -> int:
    """Morton interleave of 2-D coords: the block-id order of
    ``BlocksparseMatMul`` (weight-storage locality)."""
    answer = 0
    bits = max(len(bin(x)), len(bin(y))) - 2
    for i in range(bits):
        mshifted = 1 << i
        answer |= ((x & mshifted) << i) | ((y & mshifted) << (i + 1))
    return answer


def z_order_3d(z: int, y: int, x: int) -> int:
    """Morton interleave of 3-D coords."""
    answer = 0
    bits = max(len(bin(x)), len(bin(y)), len(bin(z))) - 2
    for i in range(bits):
        mshifted = 1 << i
        shift = i << 1
        answer |= (((x & mshifted) << shift)
                   | ((y & mshifted) << (shift + 1))
                   | ((z & mshifted) << (shift + 2)))
    return answer


def magic32u(nmax: int, d: int):
    """(magic, shift) for unsigned division of 0..nmax by d as a multiply
    and a shift."""
    nc = ((nmax + 1) // d) * d - 1
    nbits = len(bin(nmax)) - 2
    for p in range(0, 2 * nbits + 1):
        if 2 ** p > nc * (d - 1 - (2 ** p - 1) % d):
            m = (2 ** p + d - 1 - (2 ** p - 1) % d) // d
            return (m, p)
    raise ValueError("Can't find magic number for division")


def magic64u(d: int):
    nmax = 0xFFFFFFFF if d == 3 else 0x7FFFFFFF
    magic, shift = magic32u(nmax, d)
    if magic != 1:
        shift -= 32
    return (magic, shift)


# ------------------------------------------------------------------
# Entropy: the random source of dropout, concrete_gate and stochastic
# quantize when they are given no generator.  The JAX package keeps a
# PRNG key and folds a counter into it; here each device has its own
# torch.Generator, made at its first use from the one seed, so a draw
# for a tensor on the card happens on the card.
# ------------------------------------------------------------------

# parity constant (the size of the reference's GPU entropy buffer)
entropy_size = 80 * 3 * 1024

_entropy_seed = None
_entropy = {}       # torch.device -> torch.Generator


def default_device(device, what):
    """``device``, by default the CUDA card: a host without one raises
    rather than fall back to the CPU.  ``what`` names the caller in the
    message."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(f"{what} runs on the CUDA card by default and this "
                           f"host has none: pass device=\"cpu\" to run it on "
                           f"the CPU")
    return torch.device("cuda")


def set_entropy(init=None):
    """Seeds the global generators (a random seed when ``init`` is
    None); every device's generator starts again from this seed."""
    global _entropy_seed
    if init is None:
        init = np.random.randint(0, 2 ** 31 - 1)
    _entropy_seed = int(init)
    _entropy.clear()


def _device_key(device):
    device = torch.device("cpu" if device is None else device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def get_entropy(device=None):
    """The global generator of ``device`` (default the CPU), made from the
    seed at its first use; the seed is drawn at the first use of any."""
    if _entropy_seed is None:
        set_entropy()
    device = _device_key(device)
    g = _entropy.get(device)
    if g is None:
        g = _entropy[device] = torch.Generator(device=device).manual_seed(
            _entropy_seed)
    return g


def entropy_state():
    """The seed and the state of every global generator made so far:
    what ``set_entropy_state`` puts back (``recomputable`` replays a
    forward's draws with it)."""
    if _entropy_seed is None:
        set_entropy()
    return _entropy_seed, {d: g.get_state() for d, g in _entropy.items()}


def set_entropy_state(state):
    """Puts the global generators back to ``state``; one made after it
    starts again from its seed."""
    seed, states = state
    for d, g in _entropy.items():
        if d in states:
            g.set_state(states[d])
        else:
            g.manual_seed(seed)


def scalar_constant(value, dtype=torch.float32, name=None):
    """A Python number as a 0-d tensor of ``dtype``; a tensor passes
    through unchanged."""
    if isinstance(value, torch.Tensor):
        return value
    return torch.tensor(value, dtype=dtype)


def reset_scalar_constants():
    """The reference clears its per-graph cache of scalar constants; the
    port keeps none, so this does nothing."""


# ------------------------------------------------------------------
# Conv output-dim math
# ------------------------------------------------------------------

def dilation_size(S, dil=1):
    return S * dil - dil + 1


def out_dim(S, W, pad, std=1, dil=1):
    return ceil_div(W - dilation_size(S, dil) + 1 + 2 * pad, std)


def same_pad(S, dil=1):
    return dilation_size(S, dil) // 2


def backward_pad(S, pad, dil=1):
    return dilation_size(S, dil) - pad - 1


def conv_slice(q, W, S, pad, std=1, dil=1):
    qs = q * std - pad
    ws = []
    for s in range(S):
        w = qs + s * dil
        if 0 <= w < W:
            ws.append(w)
    return ws


def deconv_slice(x, Q, S, bpad, std=1, dil=1):
    xs = x - bpad
    e = []
    for s in range(S):
        q = xs + s * dil
        if q % std == 0:
            q //= std
            if 0 <= q < Q:
                e.append(q)
    return e


# ------------------------------------------------------------------
# Attention layouts that emulate a (de)convolution, to drive
# BlocksparseTransformer.
# ------------------------------------------------------------------

def _find_pad(n_out, size, R, stride, deconv):
    for r in range(R):
        if n_out == out_dim(R, size, r, stride):
            return backward_pad(R, r) if deconv else r
    raise ValueError("Even size filters only work with stride 2.")


def _mask_callback(mask_set):
    def cb(blk_shape, head_idx, qry_idx, key_idx, blk_idx):
        mask = np.zeros(blk_shape, dtype=bool)
        q0 = qry_idx * blk_shape[0]
        k0 = key_idx * blk_shape[1]
        for q, k in np.ndindex(blk_shape):
            if (q0 + q, k0 + k) in mask_set:
                mask[q, k] = 1
        return mask
    return cb


def _conv_geometry(H, W, R, S, stride, blk_size, deconv):
    if not (H % stride == 0 or H == 1) or W % stride:
        raise ValueError("the image must divide by the stride")
    P = H // stride or 1
    Q = W // stride
    if H == 1:
        R, pad_r = 1, 0
    else:
        pad_r = _find_pad(P, H, R, stride, deconv)
    pad_s = _find_pad(Q, W, S, stride, deconv)
    if P * Q % blk_size:
        raise ValueError(f"P:{P} Q:{Q}")
    if H * W % blk_size:
        raise ValueError(f"H:{H} W:{W}")
    return P, Q, R, pad_r, pad_s


def bst_conv_layout(input_h=1, input_w=1, filter_h=1, filter_w=1, stride=1,
                    blk_size=32, autoregressive=True):
    """Block-attention layout and mask callback making attention act like
    a conv: (layout (P·Q/blk, H·W/blk) bool, callback)."""
    H, W, S = input_h, input_w, filter_w
    P, Q, R, pad_r, pad_s = _conv_geometry(H, W, filter_h, S, stride,
                                           blk_size, deconv=False)
    mask_set = set()
    layout = np.zeros((P * Q // blk_size, H * W // blk_size), dtype=bool)
    for p, q in np.ndindex(P, Q):
        for h in conv_slice(p, H, R, pad_r, stride):
            for w in conv_slice(q, W, S, pad_s, stride):
                x = h * W + w
                y = p * Q + q
                if not autoregressive or \
                        p * stride * Q * stride + q * stride >= x:
                    layout[y // blk_size, x // blk_size] = 1
                    mask_set.add((y, x))
    return layout, _mask_callback(mask_set)


def bst_deconv_layout(output_h=1, output_w=1, filter_h=1, filter_w=1,
                      stride=1, blk_size=32, autoregressive=True):
    """Block-attention layout and mask callback emulating a
    deconvolution: (layout (H·W/blk, P·Q/blk) bool, callback)."""
    H, W, S = output_h, output_w, filter_w
    P, Q, R, pad_r, pad_s = _conv_geometry(H, W, filter_h, S, stride,
                                           blk_size, deconv=True)
    mask_set = set()
    layout = np.zeros((H * W // blk_size, P * Q // blk_size), dtype=bool)
    for h, w in np.ndindex(H, W):
        for p in deconv_slice(h, P, R, pad_r, stride):
            for q in deconv_slice(w, Q, S, pad_s, stride):
                y = h * W + w
                x = p * Q + q
                if not autoregressive or \
                        y >= p * stride * Q * stride + q * stride:
                    layout[y // blk_size, x // blk_size] = 1
                    mask_set.add((y, x))
    return layout, _mask_callback(mask_set)
