"""Quantization research ops: arbitrary float formats and tensor stats.

Counterpart of ``blocksparse_tpu/ops/quantize.py``.  ``quantize``
simulates an (ebits, fbits, emax) float format in float32: relative
mantissa rounding (nearest or stochastic), saturation at the format's
max, flush to zero below its min and optional gradual underflow (the
denorm grid); the backward quantizes the gradient with its own spec.

* Stochastic rounding draws from a ``torch.Generator`` (``generator`` /
  ``b_generator``, the JAX ``key`` / ``b_key``), else from the global
  generator of the tensor's device, ``utils.get_entropy(device)``.
* Powers of two are built exactly (``_pow2``).  The JAX package computes
  them with XLA's ``exp2``, which on the CPU is inexact for most
  exponents (~1e-6 relative) and flushes below 2^-126, so its grid lies
  off the exact one and a value half-way between two grid points may
  round the other way (ROADMAP F4).
* Self-tuning exponents (spec mode 1 or 2) are kept by a
  ``QuantizeTracker``: ``tracker.wrap_jit(step)`` wraps a step callable,
  ``quantize(..., name=)`` inside it reads the named emax and records a
  new estimate from the forward and the gradient stream, and the tracker
  applies the estimates every ``frequency`` calls.  The emax stay device
  tensors: no host read inside a step.
* ``log_stats`` writes its rows on the host; it raises under a CUDA graph
  capture, where it could print nothing.
"""
from __future__ import annotations

import threading
import time

import numpy as np
import torch

from blocksparse_tpu_torch.ops.ewops import uniform

_F32 = torch.float32


class QuantizeSpec:
    """An (ebits, fbits, emax) float format with its rounding and
    tracking options."""

    def __init__(self, ebits=4, fbits=3, emax=None, stochastic=0, denorm=True,
                 frequency=1024, mode=0, bias_pad=2, stdv_mul=4.0, logfile="",
                 copy=None):
        if copy is None:
            if emax is None:
                emax = (1 << (ebits - 1)) - 1  # default symmetric
            self.ebits = ebits
            self.fbits = fbits
            self.emax = emax
            self.stoch = stochastic
            self.denorm = denorm
            self.freq = frequency
            self.mode = mode
            self.bias_pad = bias_pad
            self.stdv_mul = stdv_mul
            self.logfile = logfile
        else:
            self.ebits = copy.ebits
            self.fbits = copy.fbits
            self.emax = copy.emax
            self.stoch = copy.stoch
            self.denorm = copy.denorm
            self.freq = copy.freq
            self.mode = copy.mode
            self.bias_pad = copy.bias_pad
            self.stdv_mul = copy.stdv_mul
            self.logfile = copy.logfile or logfile


def _pow2(e):
    """2^e exactly for an int32 tensor e in [-149, 127], denormals
    included: the product of two normal powers of two built from bits."""
    lo = e >> 1

    def bits(k):
        return ((k + 127) << 23).view(_F32)
    return bits(lo) * bits(e - lo)


def _format_params(ebits, fbits, emax, denorm):
    """(max_float, min_float, bexp_min) of the format: Python numbers for
    a Python emax, f32 tensors for a tensor emax (a tracked one)."""
    max_exp = (1 << ebits) - 1
    if ebits == 8:
        max_exp -= 1
    if isinstance(emax, (int, float)):
        bexp_max = max(emax + 127, max_exp)
        bexp_min = max(bexp_max - max_exp + 1 - (fbits if denorm else 0), 2)
        max_float = float(np.float32(2.0 - 2.0 ** -fbits)
                          * np.float32(2.0) ** (bexp_max - 127))
        min_float = float(np.float32(2.0) ** (bexp_min - 127))
        return max_float, min_float, bexp_min
    bexp_max = torch.clamp(emax.to(_F32) + 127.0, min=float(max_exp))
    bexp_min = torch.clamp(
        bexp_max - max_exp + 1 - (fbits if denorm else 0), min=2.0)

    def pow2(b):
        return _pow2(torch.clamp(b - 127.0, -149, 127).to(torch.int32))
    max_float = float(np.float32(2.0 - 2.0 ** -fbits)) * pow2(bexp_max)
    return max_float, pow2(bexp_min), bexp_min


def quantize_float_sim(x, ebits, fbits, emax, stochastic=0, denorm=True,
                       generator=None):
    """x rounded onto the format's grid (in f32, returned in x's dtype)."""
    max_float, min_float, bexp_min = _format_params(ebits, fbits, emax,
                                                    denorm)
    x32 = x.to(_F32)
    sgn = torch.sign(x32)
    ax = x32.abs()
    if fbits >= 23:
        q = ax                       # full f32 mantissa: range only
    else:
        _, ex = torch.frexp(torch.where(ax > 0, ax, torch.ones_like(ax)))
        ulp = _pow2(torch.clamp(ex - 1 - fbits, min=-149))
        if stochastic:
            r = uniform(x.shape, x.device, generator) * ulp
        else:
            r = 0.5 * ulp
        q = torch.floor((ax + r) / ulp) * ulp
    q = torch.clamp(q, max=max_float)
    q = torch.where(q < min_float, torch.zeros_like(q), q)
    if denorm:
        # round to the fixed denorm quantum near the bottom of the range
        if isinstance(bexp_min, torch.Tensor):
            qd = _pow2(torch.clamp(bexp_min - 127.0, min=-149).to(
                torch.int32))
        else:
            qd = float(np.float32(2.0) ** (bexp_min - 127))
        q = torch.where(q < qd * (2.0 ** fbits) * 2.0,
                        torch.round(q / qd) * qd, q)
    return (sgn * q).to(x.dtype)


def quantize_emax_estimate(x, spec: QuantizeSpec):
    """An exponent max for x (an f32 device scalar): mode 1 from max|x|
    (+ bias_pad), mode 2 from mean + stdv_mul·std of |x|.  No gradient
    flows through it."""
    ax = x.detach().to(_F32).abs()
    if spec.mode == 2:
        target = ax.mean() + spec.stdv_mul * ax.std(unbiased=False)
    else:
        target = ax.max()
    e = torch.floor(torch.log2(torch.clamp(target, min=1e-30)))
    return (e + spec.bias_pad).to(_F32)


# ------------------------------------------------------------------
# Tracked exponents: the step being wrapped runs inside a frame that
# holds the emax read (device tensors) and collects new estimates.
# ------------------------------------------------------------------

_ctx = threading.local()


class _TrackerFrame:
    def __init__(self, state):
        self.state = state        # name -> f32 device scalar
        self.estimates = {}       # name -> f32 device scalar
        self.freqs = {}           # name -> frequency

    def read(self, name, spec):
        self.freqs[name] = spec.freq
        return self.state.get(name, spec.emax)

    def record(self, name, est):
        self.estimates[name] = est


class QuantizeTracker:
    """One emax per named tensor (and one per ``name + "_grad"`` for a
    tracked backward spec).  Usage::

        tracker = QuantizeTracker()
        step = tracker.wrap_jit(step_fn)
        ...inside step_fn:  quantize(x, qspec, bspec, name="q0")

    Specs of mode 1 or 2 with a ``name`` take part; mode-0 specs stay
    static.  An estimate recorded in a call is applied after it, every
    ``frequency`` calls of its name (the first one always), so it is used
    from the next call on.  ``jit_kwargs`` are accepted and ignored."""

    def __init__(self):
        self.emax = {}      # name -> current emax (device scalar)
        self.counts = {}
        self._freqs = {}

    def wrap_jit(self, fn, **jit_kwargs):
        def wrapped(*args, **kwargs):
            frame = _TrackerFrame(dict(self.emax))
            prev = getattr(_ctx, "frame", None)
            _ctx.frame = frame
            try:
                out = fn(*args, **kwargs)
            finally:
                _ctx.frame = prev
            self._freqs.update(frame.freqs)
            self._apply(frame.estimates)
            return out
        return wrapped

    def _apply(self, estimates):
        for name, e in estimates.items():
            c = self.counts.get(name, 0)
            freq = max(int(self._freqs.get(name, 1)), 1)
            if name not in self.emax or c % freq == 0:
                self.emax[name] = e
            self.counts[name] = c + 1

    def emax_of(self, name):
        """The current emax of a tracked tensor (reads it to the host)."""
        return float(self.emax[name])


class _Quantize(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, qspec, b_qspec, emax_f, emax_b, generator,
                b_generator, frame, name):
        ctx.args = (b_qspec, emax_b, b_generator, frame, name)
        return quantize_float_sim(x, qspec.ebits, qspec.fbits, emax_f,
                                  qspec.stoch, qspec.denorm, generator)

    @staticmethod
    def backward(ctx, dy):
        b_qspec, emax_b, b_generator, frame, name = ctx.args
        if frame is not None:
            # the frame rides in ctx: the backward may run on another
            # thread (the autograd engine's device threads)
            frame.record(name + "_grad", quantize_emax_estimate(dy, b_qspec))
        dx = quantize_float_sim(dy, b_qspec.ebits, b_qspec.fbits, emax_b,
                                b_qspec.stoch, b_qspec.denorm, b_generator)
        return (dx,) + (None,) * 8


def quantize(x, qspec: QuantizeSpec, b_qspec: QuantizeSpec = None, name=None,
             generator=None, b_generator=None):
    """x quantized with ``qspec``; its gradient quantized with ``b_qspec``
    (default qspec).  With a ``name`` and self-tuning specs inside a
    ``QuantizeTracker.wrap_jit`` step, emax is read from and estimated
    into the tracker (the forward under ``name``, the gradient under
    ``name + "_grad"``)."""
    if b_qspec is None:
        b_qspec = qspec
    if x.dtype == torch.bfloat16:
        for spec in (qspec, b_qspec):
            if spec.fbits > 7:
                raise ValueError("bfloat only supports up to 7 fractional "
                                 "bits")
    frame = getattr(_ctx, "frame", None)
    emax_f, emax_b = qspec.emax, b_qspec.emax
    track_b = b_qspec.mode != 0 and name is not None and frame is not None
    if qspec.mode != 0 and name is not None and frame is not None:
        emax_f = frame.read(name, qspec)
        frame.record(name, quantize_emax_estimate(x, qspec))
    if track_b:
        emax_b = frame.read(name + "_grad", b_qspec)
    return _Quantize.apply(x, qspec, b_qspec, emax_f, emax_b, generator,
                           b_generator, frame if track_b else None, name)


# ------------------------------------------------------------------
# log_stats: tensor statistics appended to a TSV at a power-of-2 step
# schedule
# ------------------------------------------------------------------

stat_headers = [
    "sat_pct", "ftz_pct", "max", "mean", "stdv", "mean+stdv5",
    "max_stat_lo", "max_stat_hi", "count", "name",
]

_log_init = set()
_log_timestamp = None


def get_timestamp():
    global _log_timestamp
    if _log_timestamp is None:
        _log_timestamp = time.strftime('%Y_%m_%d_%H_%M_%S')
    return _log_timestamp


def tensor_stats(x, sat_val=65504.0, ftz_val=2.0 ** -24):
    """(sat %, flush-to-zero %, max, mean, std) of |x|, f32 device
    scalars."""
    ax = x.to(_F32).abs()
    n = x.numel()
    sat_pct = 100.0 * (ax >= sat_val).sum() / n
    ftz_pct = 100.0 * ((ax > 0) & (ax < ftz_val)).sum() / n
    return sat_pct, ftz_pct, ax.max(), ax.mean(), ax.std(unbiased=False)


class _LogStats(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, emit):
        ctx.emit = emit
        emit(x, "")
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dy):
        ctx.emit(dy, "_grad")
        return dy, None


def log_stats(x, step, sat_val=65504.0, ftz_val=2.0 ** -24, freq=512,
              bfreq=512, logfile="", name=None):
    """Identity that writes a row of ``tensor_stats`` of x (and of its
    gradient, tagged ``name + "_grad"``) at steps that are powers of 2
    or multiples of ``freq``: to ``logfile`` (a TSV, ``%(timestamp)s``
    filled in) or to stdout.  ``step`` is an int or a tensor; reading the
    statistics waits for the device."""
    if freq and round(np.log2(freq)) != np.log2(freq):
        raise ValueError("freq must be 0 or a power of 2")
    name = name or "log_stats"
    if logfile:
        logfile = logfile % {"timestamp": get_timestamp()}
        if logfile not in _log_init:
            with open(logfile, "w") as log:
                log.write("\t".join(stat_headers) + "\n")
            _log_init.add(logfile)

    def emit(t, tag):
        if t.is_cuda and torch.cuda.is_current_stream_capturing():
            raise RuntimeError("log_stats reads its statistics on the host "
                               "and cannot run inside a CUDA graph capture")
        step_v = int(step)
        should = step_v > 0 and (
            (step_v & (step_v - 1)) == 0 or (freq and step_v % freq == 0))
        if not should:
            return
        sat, ftz, mx, mean, stdv = (float(s) for s in tensor_stats(
            t, sat_val, ftz_val))
        row = [f"{sat:.4f}", f"{ftz:.4f}", f"{mx:.6g}", f"{mean:.6g}",
               f"{stdv:.6g}", f"{mean + 5 * stdv:.6g}", "0", "0",
               str(int(np.prod(x.shape))), name + tag]
        if logfile:
            with open(logfile, "a") as log:
                log.write("\t".join(row) + "\n")
        else:
            print("\t".join(row))

    return _LogStats.apply(x, emit)
