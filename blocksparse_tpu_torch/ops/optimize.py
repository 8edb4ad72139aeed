"""Fused optimizers: global-norm clipping, Adam (f32, bfloat16 and packed
16-bit slots, gated, quantized), Adafactor, EMA and block pruning.

Counterpart of ``blocksparse_tpu/ops/optimize.py``.  Plain PyTorch, as
the JAX package leaves these to XLA.  Gradients, parameters and state are
dicts of tensors keyed by parameter name (the JAX package's pytrees);
every scalar (norm, norm_scale, grad_scale, the step count) stays a
tensor on the parameters' device, and Python numbers become tensors there
by a fill (``_scalar``), so a step needs no host sync and a CUDA graph can
capture it.

* ``clip_by_global_norm`` returns (global_norm, norm_scale), and
  norm_scale is 0 when the norm is not finite;
* ``adam_apply`` follows the reference math order: scrub -> scale -> v ->
  sigma clip -> m -> param, and a norm_scale of 0 leaves param, m and v
  untouched (the skip the loss-scaling loop uses); a per-block ``gate``
  leaves the blocks it zeroes untouched;
* ``AdamOptimizer`` folds the bias correction into the learning rate and
  keeps the slots of parameters of at least 8K elements in 16 bits when
  asked: bfloat16, or ``packed16``, the reference's mhalf/vhalf formats
  in uint16 (``mhalf_pack`` ... ``vhalf_unpack``, bit for bit the JAX
  package's).  All update math runs in f32 whatever the slots hold.

``torch.optim`` is PyTorch's counterpart of optax's interface, so the
JAX package's ``optax_adam`` and ``optax_adafactor`` become ``FusedAdam``
and ``FusedAdafactor``, ``torch.optim.Optimizer`` subclasses over the
same ``AdamOptimizer`` and ``AdafactorOptimizer`` math.
"""
from __future__ import annotations

import numpy as np
import torch

_F32 = torch.float32
_I32 = torch.int32


def _scalar(x, like):
    """``x`` as an f32 scalar tensor on ``like``'s device: a tensor as it
    is (cast to f32), a Python number by a fill on the device.  Nothing is
    copied from the host, which would wait for the stream and which a
    CUDA graph capture forbids; the value is the same f32 either way."""
    if isinstance(x, torch.Tensor):
        return x.to(device=like.device, dtype=_F32)
    return torch.full((), x, dtype=_F32, device=like.device)


def _scrub(g, saturate=0.0, zero_infs=False, zero_nans=False):
    g = g.to(_F32)
    if zero_infs:
        g = torch.where(torch.isinf(g), torch.zeros_like(g), g)
    if zero_nans:
        g = torch.where(torch.isnan(g), torch.zeros_like(g), g)
    if saturate:
        g = g.clamp(-saturate, saturate)
    return g


def _scaled_grad(grad, grad_scale, norm_scale, like, saturate, zero_infs,
                 zero_nans):
    """(the scrubbed gradient times grad_scale · norm_scale, norm_scale)."""
    ns = _scalar(1.0 if norm_scale is None else norm_scale, like)
    g = _scrub(grad, saturate, zero_infs, zero_nans)
    return g * (_scalar(grad_scale, like) * ns), ns


def _per_block(gate, ndim):
    """A per-block gate (one entry a leading index) as a bool mask that
    broadcasts over a tensor of ``ndim`` dims."""
    return (gate.to(_F32) != 0).reshape((-1,) + (1,) * (ndim - 1))


# ------------------------------------------------------------------
# clip_by_global_norm
# ------------------------------------------------------------------

def clip_by_global_norm(grads, clip_norm=1.0, grad_scale=1.0, saturate=0.0,
                        zero_infs=False, zero_nans=False):
    """(global_norm, norm_scale) over a dict (or list) of gradients, each
    scrubbed and multiplied by ``grad_scale`` first; norm_scale =
    clip / max(norm, clip), and 0 when the norm is not finite."""
    leaves = list(grads.values()) if isinstance(grads, dict) else list(grads)
    gs = _scalar(grad_scale, leaves[0])
    total = torch.zeros((), dtype=_F32, device=leaves[0].device)
    for g in leaves:
        total = total + (_scrub(g, saturate, zero_infs, zero_nans) * gs) \
            .square().sum()
    norm = torch.sqrt(total)
    clip = _scalar(clip_norm, norm)
    norm_scale = clip / torch.maximum(norm, clip)
    norm_scale = torch.where(torch.isfinite(norm), norm_scale,
                             torch.zeros_like(norm_scale))
    return norm, norm_scale


def global_norm(grads, grad_scale=1.0, saturate=0.0, zero_infs=False,
                zero_nans=False):
    return clip_by_global_norm(grads, clip_norm=9e9, grad_scale=grad_scale,
                               saturate=saturate, zero_infs=zero_infs,
                               zero_nans=zero_nans)[0]


ClipGlobalNorm = clip_by_global_norm


# ------------------------------------------------------------------
# Packed 16-bit optimizer-state formats (the reference's mhalf/vhalf):
#   vhalf: 0s/6e/10m unsigned, value = 1.m * 2^(e-60), e in [0, 63]
#   mhalf: 1s/6e/9m  signed,   same exponent range
# Magnitudes round half up onto the mantissa grid, saturate just below
# 16 and flush to zero below 2^-60; stored as uint16.  The arithmetic
# runs in int32 and f32 (shifts on uint16 are not implemented on every
# device) and is exact: exponents come from the f32 bits and powers of
# two are built from bits, so every device gives the JAX package's codes.
# ------------------------------------------------------------------

def _exp2i(e):
    """2^e exactly, for an int32 tensor e in the normal f32 range."""
    return ((e + 127) << 23).view(_F32)


def _frexp_exp(m):
    """frexp's exponent of positive normal f32 values (m = f·2^e, f in
    [0.5, 1))."""
    return ((m.view(_I32) >> 23) & 0xFF) - 126


def _pack16(x, mbits, signed):
    x = x.to(_F32)
    m = x.abs()
    max_val = float(np.float32((2.0 - 2.0 ** -mbits) * 8.0))   # < 16
    m = torch.clamp(m, max=max_val)
    # below 2^-62 the code is 0 whatever the rounding: flushing first
    # keeps every exponent below in the normal range
    m = torch.where(m < 2.0 ** -62, torch.zeros_like(m), m)
    one = torch.ones_like(m)
    ex = _frexp_exp(torch.where(m > 0, m, one))
    ulp = _exp2i(ex - 1 - mbits)
    m = torch.floor(m / ulp + 0.5) * ulp          # round half up
    # all-zero bits mean 0.0, so the smallest code is mantissa 1 at exp 0
    zero = m < 2.0 ** -60 * (1.0 + 2.0 ** -mbits)
    ex = _frexp_exp(torch.where(zero, one, m))
    e6 = torch.clamp(ex - 1 + 60, 0, 63)
    mant = torch.round((m / _exp2i(ex - 1) - 1.0) * (1 << mbits)).to(_I32)
    mant = torch.clamp(mant, max=(1 << mbits) - 1)
    u = (e6 << mbits) | mant
    if signed:
        u = u | ((x < 0).to(_I32) << 15)
    return torch.where(zero, torch.zeros_like(u), u).to(torch.uint16)


def _unpack16(u, mbits, signed):
    u32 = u.to(_I32)
    mant = (u32 & ((1 << mbits) - 1)).to(_F32)
    e6 = (u32 >> mbits) & 0x3F
    val = (1.0 + mant / (1 << mbits)) * _exp2i(e6 - 60)
    if signed:
        val = torch.where(((u32 >> 15) & 1) != 0, -val, val)
    return torch.where(u32 == 0, torch.zeros_like(val), val)


def mhalf_pack(x):
    """f32 -> mhalf-encoded uint16 (Adam mean slots)."""
    return _pack16(x, 9, signed=True)


def mhalf_unpack(u):
    return _unpack16(u, 9, signed=True)


def vhalf_pack(x):
    """f32 -> vhalf-encoded uint16 (Adam variance slots, unsigned)."""
    return _pack16(x, 10, signed=False)


def vhalf_unpack(u):
    return _unpack16(u, 10, signed=False)


# ------------------------------------------------------------------
# Adam
# ------------------------------------------------------------------

def adam_apply(grad, param, m, v, lr, decay_mean=0.9, decay_var=0.999,
               epsilon=1e-8, grad_scale=1.0, clip_sigma=0.0, norm_scale=None,
               gate=None, saturate=0.0, zero_infs=False, zero_nans=False):
    """One fused Adam step; returns new (param, m, v), each in its input's
    dtype.  All update math runs in f32.  ``gate``: one entry a leading
    index of param (a block); where it is 0 nothing changes."""
    g, ns = _scaled_grad(grad, grad_scale, norm_scale, param, saturate,
                         zero_infs, zero_nans)
    m32, v32, p32 = m.to(_F32), v.to(_F32), param.to(_F32)
    v_new = decay_var * v32 + (1.0 - decay_var) * g * g
    sigma = torch.sqrt(v_new)
    if clip_sigma:
        clip = clip_sigma * sigma
        g = torch.minimum(torch.maximum(g, -clip), clip)
    m_new = decay_mean * m32 + (1.0 - decay_mean) * g
    p_new = p32 - _scalar(lr, param) * m_new / (sigma + epsilon)
    if gate is not None:
        on = _per_block(gate, param.dim())
        m_new = torch.where(on, m_new, m32)
        v_new = torch.where(on, v_new, v32)
        p_new = torch.where(on, p_new, p32)
    skip = ns == 0.0
    return (torch.where(skip, p32, p_new).to(param.dtype),
            torch.where(skip, m32, m_new).to(m.dtype),
            torch.where(skip, v32, v_new).to(v.dtype))


adam_op = adam_apply


def lazy_emb_adam_apply(grad, param, m, v, lr, **kwargs):
    """Adam for an embedding whose untouched rows (an all-zero gradient
    row) skip the update entirely: their param, m and v keep their bits."""
    touched = (grad != 0).flatten(1).any(dim=1)
    return adam_apply(grad, param, m, v, lr, gate=touched, **kwargs)


lazy_emb_adam_op = lazy_emb_adam_apply


class AdamOptimizer:
    """Adam with the reference's bias correction folded into the learning
    rate, lr_t = lr·sqrt(1 - beta2^t) / (1 - beta1^t), used functionally:
    ``state = opt.init(params)``, then
    ``params, state = opt.apply(grads, params, state, ...)``.

    state_format (for parameters of at least 8K elements; smaller ones
    keep f32 slots): None/"float32" f32 slots; "bfloat16" (or fp16=True)
    bf16 slots; "packed16" the mhalf/vhalf uint16 formats.  ``gated``
    marks an optimizer fed per-block ``gates`` in ``apply``; the
    ``*_qspec`` quantize the new param, mean and var each step (before
    packing).  ``zero_init_variables`` is accepted: slots always start at
    zero."""

    def __init__(self, learning_rate=3e-4, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, clip_sigmas=0.0, norm_scale=None,
                 grad_scale=1.0, saturate=0.0, zero_infs=False,
                 zero_nans=False, gated=False, param_qspec=None,
                 mean_qspec=None, var_qspec=None, fp16=False,
                 state_format=None, zero_init_variables=False, name="Adam"):
        if state_format is None:
            state_format = "bfloat16" if fp16 else "float32"
        if state_format not in ("float32", "bfloat16", "packed16"):
            raise ValueError(f"unknown state_format {state_format!r}")
        self.learning_rate = learning_rate
        self.beta1, self.beta2 = beta1, beta2
        self.epsilon = epsilon
        self.clip_sigma = clip_sigmas
        self.norm_scale = norm_scale
        self.grad_scale = grad_scale
        self.saturate = saturate
        self.zero_infs = zero_infs
        self.zero_nans = zero_nans
        self.gated = gated
        self.param_qspec = param_qspec
        self.mean_qspec = mean_qspec
        self.var_qspec = var_qspec
        self.state_format = state_format
        self.fp16 = state_format != "float32"
        self.name = name

    def _slot_dtype(self, p):
        if self.fp16 and p.numel() >= 8 * 1024:
            return torch.uint16 if self.state_format == "packed16" \
                else torch.bfloat16
        return _F32

    def init(self, params):
        """Zero mean/var slots for a dict of parameters, and t = 0."""
        first = next(iter(params.values()))

        def slots():
            return {k: torch.zeros(p.shape, dtype=self._slot_dtype(p),
                                   device=p.device)
                    for k, p in params.items()}
        return {"mean": slots(), "var": slots(),
                "t": torch.zeros((), dtype=_I32, device=first.device)}

    def apply(self, grads, params, state, norm_scale=None, grad_scale=None,
              learning_rate=None, gates=None):
        """New (params, state) from dicts of gradients and parameters;
        ``gates`` an optional dict of per-block gates (a key missing from
        it is not gated)."""
        from blocksparse_tpu_torch.ops.quantize import quantize

        t = state["t"] + 1
        tf = t.to(_F32)
        b1p = torch.pow(_scalar(self.beta1, tf), tf)
        b2p = torch.pow(_scalar(self.beta2, tf), tf)
        lr0 = self.learning_rate if learning_rate is None else learning_rate
        lr = _scalar(lr0, tf) * torch.sqrt(1 - b2p) / (1 - b1p)
        ns = norm_scale if norm_scale is not None else self.norm_scale
        gs = grad_scale if grad_scale is not None else self.grad_scale
        new_params, mean, var = {}, {}, {}
        for k, p in params.items():
            m, v = state["mean"][k], state["var"][k]
            packed = m.dtype == torch.uint16
            if packed:
                m, v = mhalf_unpack(m), vhalf_unpack(v)
            p2, m2, v2 = adam_apply(
                grads[k], p, m, v, lr, self.beta1, self.beta2, self.epsilon,
                gs, self.clip_sigma, ns,
                None if gates is None else gates.get(k),
                self.saturate, self.zero_infs, self.zero_nans)
            if self.param_qspec is not None:
                p2 = quantize(p2, self.param_qspec)
            if self.mean_qspec is not None:
                m2 = quantize(m2, self.mean_qspec)
            if self.var_qspec is not None:
                v2 = quantize(v2, self.var_qspec)
            if packed:
                m2, v2 = mhalf_pack(m2), vhalf_pack(v2)
            new_params[k], mean[k], var[k] = p2, m2, v2
        return new_params, {"mean": mean, "var": var, "t": t}


# ------------------------------------------------------------------
# Adafactor
# ------------------------------------------------------------------

def _adafactor_step(p32, g, x, lr, clip_thresh, ns):
    rms_x = torch.sqrt(torch.mean(torch.square(x)))
    p_new = p32 - _scalar(lr, p32) * x / torch.clamp(rms_x / clip_thresh,
                                                     min=1.0)
    return torch.where(ns == 0.0, p32, p_new)


def adafactor2d_apply(param, cv, rv, grad, decay, lr, grad_scale=1.0,
                      clip_thresh=1.0, norm_scale=None, epsilon=1e-30,
                      saturate=0.0, zero_infs=False, zero_nans=False):
    """Factored second-moment update of a 2-D param: column slot cv (1,
    n), row slot rv (m, 1).  Returns (param, cv, rv, x)."""
    g, ns = _scaled_grad(grad, grad_scale, norm_scale, param, saturate,
                         zero_infs, zero_nans)
    cv32, rv32, p32 = cv.to(_F32), rv.to(_F32), param.to(_F32)
    sq = torch.square(g) + epsilon
    c_new = decay * cv32 + (1.0 - decay) * sq.mean(dim=0, keepdim=True)
    r_new = decay * rv32 + (1.0 - decay) * sq.mean(dim=1, keepdim=True)
    ltm = r_new.mean()
    x = g / (torch.sqrt(r_new / ltm) * torch.sqrt(c_new))
    skip = ns == 0.0
    return (_adafactor_step(p32, g, x, lr, clip_thresh, ns).to(param.dtype),
            torch.where(skip, cv32, c_new).to(cv.dtype),
            torch.where(skip, rv32, r_new).to(rv.dtype), x)


def adafactor1d_apply(param, cv, grad, decay, lr, grad_scale=1.0,
                      clip_thresh=1.0, norm_scale=None, epsilon=1e-30,
                      saturate=0.0, zero_infs=False, zero_nans=False):
    """Unfactored variant for 1-D params (as (1, n)): returns (param, cv,
    x)."""
    g, ns = _scaled_grad(grad, grad_scale, norm_scale, param, saturate,
                         zero_infs, zero_nans)
    cv32, p32 = cv.to(_F32), param.to(_F32)
    c_new = decay * cv32 + (1.0 - decay) * (torch.square(g) + epsilon)
    x = g / torch.sqrt(c_new)
    return (_adafactor_step(p32, g, x, lr, clip_thresh, ns).to(param.dtype),
            torch.where(ns == 0.0, cv32, c_new).to(cv.dtype), x)


adafactor2d_op = adafactor2d_apply
adafactor1d_op = adafactor1d_apply


class AdafactorOptimizer:
    """Adafactor, used functionally like ``AdamOptimizer``: 2-D params
    (with more than one row) keep factored row and column slots, 1-D ones
    an unfactored slot; other ranks raise."""

    def __init__(self, learning_rate=5e-4, beta2=0.999, epsilon=1e-30,
                 clip_thresh=1.0, norm_scale=None, grad_scale=1.0,
                 saturate=0.0, zero_infs=False, zero_nans=False,
                 name="Adafactor", zero_init_variables=False):
        self.learning_rate = learning_rate
        self.beta2 = beta2
        self.epsilon = epsilon
        self.clip_thresh = clip_thresh
        self.norm_scale = norm_scale
        self.grad_scale = grad_scale
        self.saturate = saturate
        self.zero_infs = zero_infs
        self.zero_nans = zero_nans
        self.name = name

    def init(self, params):
        def slots(p):
            def zeros(*shape):
                return torch.zeros(shape, dtype=_F32, device=p.device)
            if p.dim() == 2 and p.shape[0] > 1:
                return {"cv": zeros(1, p.shape[1]), "rv": zeros(p.shape[0], 1)}
            if p.dim() in (1, 2):
                return {"cv": zeros(1, p.numel())}
            raise ValueError("only 1 or 2d params are supported")
        first = next(iter(params.values()))
        return {"slots": {k: slots(p) for k, p in params.items()},
                "t": torch.zeros((), dtype=_I32, device=first.device)}

    def apply(self, grads, params, state, norm_scale=None,
              learning_rate=None):
        t = state["t"] + 1
        tf = t.to(_F32)
        d1 = torch.pow(_scalar(self.beta2, tf), tf)
        d2 = torch.pow(_scalar(self.beta2 * self.beta2, tf), tf)
        decay = self.beta2 * (1 - d1) / (1 - d2)
        lr = self.learning_rate if learning_rate is None else learning_rate
        ns = norm_scale if norm_scale is not None else self.norm_scale
        args = (self.grad_scale, self.clip_thresh, ns, self.epsilon,
                self.saturate, self.zero_infs, self.zero_nans)
        new_params, new_slots = {}, {}
        for k, p in params.items():
            slot, g = state["slots"][k], grads[k]
            if "rv" in slot:
                p2, c2, r2, _ = adafactor2d_apply(
                    p, slot["cv"], slot["rv"], g.reshape(p.shape), decay, lr,
                    *args)
                new_params[k], new_slots[k] = p2, {"cv": c2, "rv": r2}
            else:
                p2, c2, _ = adafactor1d_apply(
                    p.reshape(1, -1), slot["cv"], g.reshape(1, -1), decay,
                    lr, *args)
                new_params[k], new_slots[k] = p2.reshape(p.shape), {"cv": c2}
        return new_params, {"slots": new_slots, "t": t}


# ------------------------------------------------------------------
# EMA
# ------------------------------------------------------------------

def ema_op(ema, param, gate=None, decay=0.999):
    """ema = decay·ema + (1 - decay)·param in f32, stored in ema's dtype;
    blocks whose ``gate`` entry is 0 keep their average."""
    e32 = ema.to(_F32)
    new = decay * e32 + (1.0 - decay) * param.to(_F32)
    if gate is not None:
        new = torch.where(_per_block(gate, param.dim()), new, e32)
    return new.to(ema.dtype)


class Ema:
    """Exponential moving average of parameters, used functionally:
    ``state = ema.init(params)``, then ``state = ema.apply(params,
    state)``; ``fp16=True`` keeps the averages in bfloat16."""

    def __init__(self, decay=0.999, gated=False, fp16=False, name="Ema"):
        self.decay = decay
        self.gated = gated
        self.fp16 = fp16
        self.name = name

    def init(self, params):
        dtype = torch.bfloat16 if self.fp16 else _F32
        return {k: p.detach().to(dtype=dtype, copy=True)
                for k, p in params.items()}

    def apply(self, params, state, gates=None, qspec=None):
        new = {k: ema_op(e, params[k],
                         None if gates is None else gates.get(k),
                         decay=self.decay)
               for k, e in state.items()}
        if qspec is not None:
            from blocksparse_tpu_torch.ops.quantize import quantize
            new = {k: quantize(e, qspec) for k, e in new.items()}
        return new

    def average(self, state, path_or_param):
        return state[path_or_param] if isinstance(path_or_param, str) \
            else None

    def params(self, state):
        """The averaged parameters (the state itself), for evaluation."""
        return state


# ------------------------------------------------------------------
# Group lasso and block pruning
# ------------------------------------------------------------------

def _check_param_shape(param, gate=None):
    if not (param.dim() == 3 and param.shape[1] == param.shape[2]
            and param.shape[1] in (8, 16, 32, 64)):
        raise ValueError("param must be (blocks, b, b), b in 8-64")
    if gate is not None and gate.numel() != param.shape[0]:
        raise ValueError("gate needs one entry a block")


def blocksparse_l2_decay(param, gate=None, rate=0.05, epsilon=1e-12):
    """Group-lasso decay: shrink each block toward zero by rate/|block|_2.
    Returns the new param."""
    _check_param_shape(param, gate)
    p = param.to(_F32)
    norm = torch.sqrt(torch.clamp(p.square().sum(dim=(1, 2), keepdim=True),
                                  min=epsilon))
    decayed = p * torch.clamp(1.0 - rate / norm, min=0.0)
    if gate is not None:
        decayed = torch.where(_per_block(gate, 3), decayed, p)
    return decayed.to(param.dtype)


def blocksparse_norm(param, norm="max"):
    _check_param_shape(param)
    p = param.to(_F32)
    if norm.lower() == "l2":
        return torch.sqrt(p.square().sum(dim=(1, 2)))
    return p.abs().amax(dim=(1, 2))


def blocksparse_prune(gate, param, step, sparsity=None, threshold=None,
                      norm="max", frequency=1):
    """Dynamic block pruning: keep the top-k blocks by norm (``sparsity``)
    or those above ``threshold``, at steps that divide by ``frequency``
    (``step`` an int or a device tensor).  Returns the new gate."""
    if (sparsity is None) == (threshold is None):
        raise ValueError("give exactly one of sparsity and threshold")
    norms = blocksparse_norm(param, norm=norm)
    if sparsity is not None:
        k = max(1, int(np.round(np.float32((1.0 - sparsity)
                                           * param.shape[0]))))
        order = torch.argsort(-norms, stable=True)
        ranks = torch.argsort(order, stable=True)
        new_gate = (ranks < k).to(gate.dtype)
    else:
        new_gate = (norms > threshold).to(gate.dtype)
    do_update = torch.as_tensor(step, device=gate.device) % frequency == 0
    return torch.where(do_update, new_gate, gate)


def blocksparse_adam_op(grad, param, m, v, lr_old, lr_new, lr_select=None,
                        decay_mean=0.9, decay_var=0.999, epsilon=1e-8,
                        grad_scale=1.0, norm_scale=None, saturate=0.0,
                        zero_infs=False, zero_nans=False):
    """Adam with two learning rates chosen per block: blocks whose
    ``lr_select`` entry is nonzero take lr_new (freshly grown blocks), the
    rest lr_old.  param/m/v are (blocks, b, b).  Returns (param, m, v)."""
    g, ns = _scaled_grad(grad, grad_scale, norm_scale, param, saturate,
                         zero_infs, zero_nans)
    lr = _scalar(lr_old, param)
    if lr_select is not None:
        lr = torch.where(_per_block(lr_select, param.dim()),
                         _scalar(lr_new, param), lr)
    m32, v32, p32 = m.to(_F32), v.to(_F32), param.to(_F32)
    m_new = decay_mean * m32 + (1.0 - decay_mean) * g
    v_new = decay_var * v32 + (1.0 - decay_var) * g * g
    p_new = p32 - lr * m_new / (torch.sqrt(v_new) + epsilon)
    skip = ns == 0.0
    return (torch.where(skip, p32, p_new).to(param.dtype),
            torch.where(skip, m32, m_new).to(m.dtype),
            torch.where(skip, v32, v_new).to(v.dtype))


# ------------------------------------------------------------------
# torch.optim counterparts of the JAX package's optax adapters
# ------------------------------------------------------------------

class _Fused(torch.optim.Optimizer):
    """A ``torch.optim.Optimizer`` over one of the functional optimizers:
    each parameter with a gradient is stepped on its own, its state the
    functional optimizer's for that one parameter (param_groups' "lr"
    is the learning rate)."""

    def __init__(self, params, opt):
        self.opt = opt
        super().__init__(params, {"lr": opt.learning_rate})

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                if not self.state[p]:
                    self.state[p].update(self.opt.init({0: p}))
                new, st = self.opt.apply({0: p.grad}, {0: p},
                                         self.state[p],
                                         learning_rate=group["lr"])
                p.copy_(new[0])
                self.state[p].update(st)
        return loss


class FusedAdam(_Fused):
    """The counterpart of the JAX package's ``optax_adam``: Adam as
    ``AdamOptimizer`` computes it (``fp16_state``: bf16 slots)."""

    def __init__(self, params, learning_rate=3e-4, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, clip_sigma=0.0, saturate=0.0, zero_infs=False,
                 zero_nans=False, fp16_state=False):
        super().__init__(params, AdamOptimizer(
            learning_rate=learning_rate, beta1=beta1, beta2=beta2,
            epsilon=epsilon, clip_sigmas=clip_sigma, saturate=saturate,
            zero_infs=zero_infs, zero_nans=zero_nans, fp16=fp16_state))


class FusedAdafactor(_Fused):
    """The counterpart of the JAX package's ``optax_adafactor``."""

    def __init__(self, params, learning_rate=5e-4, beta2=0.999,
                 epsilon=1e-30, clip_thresh=1.0):
        super().__init__(params, AdafactorOptimizer(
            learning_rate=learning_rate, beta2=beta2, epsilon=epsilon,
            clip_thresh=clip_thresh))
