"""Global-norm clipping and the fused Adam update, with the semantics the
dynamic loss-scaling loop relies on.

Counterpart of ``blocksparse_tpu/ops/optimize.py:29-311``.  Plain
PyTorch, as the JAX package leaves these to XLA.  Gradients, parameters
and state are dicts of tensors keyed by parameter name (the JAX package's
pytrees); every scalar (norm, norm_scale, grad_scale, the step count)
stays a tensor on the parameters' device, and Python numbers become
tensors there by a fill (``_scalar``), so a step needs no host sync and a
CUDA graph can capture it.

* ``clip_by_global_norm`` returns (global_norm, norm_scale), and
  norm_scale is 0 when the norm is not finite;
* ``adam_apply`` follows the reference math order: scrub -> scale -> v ->
  sigma clip -> m -> param, and a norm_scale of 0 leaves param, m and v
  untouched (the skip the loss-scaling loop uses);
* ``AdamOptimizer`` folds the bias correction into the learning rate.

Only f32 optimizer state is ported: bfloat16 and packed16 slots, gates
(``adam_apply``'s ``gate``, ``AdamOptimizer(gated=True)``) and quantize
specs raise ``NotImplementedError``.
"""
from __future__ import annotations

import torch

_F32 = torch.float32


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


def clip_by_global_norm(grads, clip_norm=1.0, grad_scale=1.0, saturate=0.0,
                        zero_infs=False, zero_nans=False):
    """(global_norm, norm_scale) over a dict of gradients, each scrubbed
    and multiplied by ``grad_scale`` first; norm_scale =
    clip / max(norm, clip), and 0 when the norm is not finite."""
    leaves = list(grads.values())
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


def adam_apply(grad, param, m, v, lr, decay_mean=0.9, decay_var=0.999,
               epsilon=1e-8, grad_scale=1.0, clip_sigma=0.0, norm_scale=None,
               gate=None, saturate=0.0, zero_infs=False, zero_nans=False):
    """One fused Adam step; returns new (param, m, v), each in its input's
    dtype.  All update math runs in f32.  A ``gate`` is not ported and
    raises."""
    if gate is not None:
        raise NotImplementedError("gated Adam (gate) is not ported yet")
    ns = _scalar(1.0 if norm_scale is None else norm_scale, param)
    g = _scrub(grad, saturate, zero_infs, zero_nans)
    g = g * (_scalar(grad_scale, param) * ns)
    m32, v32, p32 = m.to(_F32), v.to(_F32), param.to(_F32)
    v_new = decay_var * v32 + (1.0 - decay_var) * g * g
    sigma = torch.sqrt(v_new)
    if clip_sigma:
        clip = clip_sigma * sigma
        g = torch.minimum(torch.maximum(g, -clip), clip)
    m_new = decay_mean * m32 + (1.0 - decay_mean) * g
    p_new = p32 - _scalar(lr, param) * m_new / (sigma + epsilon)
    skip = ns == 0.0
    return (torch.where(skip, p32, p_new).to(param.dtype),
            torch.where(skip, m32, m_new).to(m.dtype),
            torch.where(skip, v32, v_new).to(v.dtype))


class AdamOptimizer:
    """Adam with the reference's bias correction folded into the learning
    rate, lr_t = lr·sqrt(1 - beta2^t) / (1 - beta1^t), used functionally:
    ``state = opt.init(params)``, then
    ``params, state = opt.apply(grads, params, state, ...)``.  The
    constructor takes the JAX class's arguments; only f32 state is
    ported."""

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
        if state_format != "float32":
            raise NotImplementedError(
                f"{state_format} optimizer slots are not ported yet; the "
                f"port keeps f32 state")
        if gated or any(s is not None for s in (param_qspec, mean_qspec,
                                                var_qspec)):
            raise NotImplementedError("gated Adam and quantize specs are "
                                      "not ported yet")
        self.learning_rate = learning_rate
        self.beta1, self.beta2 = beta1, beta2
        self.epsilon = epsilon
        self.clip_sigma = clip_sigmas
        self.norm_scale = norm_scale
        self.grad_scale = grad_scale
        self.saturate = saturate
        self.zero_infs = zero_infs
        self.zero_nans = zero_nans
        self.state_format = state_format
        self.name = name

    def init(self, params):
        """Zero f32 mean/var slots for a dict of parameters, and t = 0."""
        first = next(iter(params.values()))
        return {"mean": {k: torch.zeros(p.shape, dtype=_F32, device=p.device)
                         for k, p in params.items()},
                "var": {k: torch.zeros(p.shape, dtype=_F32, device=p.device)
                        for k, p in params.items()},
                "t": torch.zeros((), dtype=torch.int32, device=first.device)}

    def apply(self, grads, params, state, norm_scale=None, grad_scale=None,
              learning_rate=None):
        """New (params, state) from dicts of gradients and parameters."""
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
            new_params[k], mean[k], var[k] = adam_apply(
                grads[k], p, state["mean"][k], state["var"][k], lr,
                self.beta1, self.beta2, self.epsilon, gs, self.clip_sigma,
                ns, saturate=self.saturate, zero_infs=self.zero_infs,
                zero_nans=self.zero_nans)
        return new_params, {"mean": mean, "var": var, "t": t}
