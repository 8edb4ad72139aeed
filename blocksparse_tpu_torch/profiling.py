"""Profiling and micro-benchmark utilities.

Counterpart of ``blocksparse_tpu/profiling.py`` on the card's own
clocks: ``Benchmark`` (a timer printing ms / GBps / GFLOPS in the
reference's format) and ``bench_op`` (chained calls, one warm-up) time
with CUDA events; ``trace`` runs ``torch.profiler`` and writes a Chrome
trace; ``memory_analysis`` and ``live_buffers`` read the CUDA caching
allocator's statistics.  A CPU timing is taken only where the caller's
tensors or ``device`` say CPU, and is host time.
"""
from __future__ import annotations

import contextlib
import gc
import os
import tempfile
import time

import torch


def _report(name, ms, nbytes, flops):
    gbps = nbytes / (ms * 1e6) if nbytes else 0.0
    gflops = flops / (ms * 1e6) if flops else 0.0
    print(f"%{ms:9.6f} msecs {gbps:8.1f} GBps {gflops:9.1f} GFLOPS "
          f"({name})")


class Benchmark:
    """Times the ``with`` block (divided by ``repeat``) between CUDA
    events on ``device`` (the current CUDA device by default; a CPU
    device times on the host clock) and prints it with its GB/s and
    GFLOP/s.  ``ms`` holds the time after the block."""

    def __init__(self, name, bytes_accessed=0, flops=0, repeat=1,
                 device=None):
        self.name = name
        self.bytes = bytes_accessed
        self.flops = flops
        self.repeat = max(repeat, 1)
        self.device = torch.device("cuda" if device is None else device)
        self.ms = None

    def __enter__(self):
        if self.device.type == "cuda":
            self._events = [torch.cuda.Event(enable_timing=True)
                            for _ in range(2)]
            self._events[0].record()
        else:
            self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.device.type == "cuda":
            self._events[1].record()
            self._events[1].synchronize()
            ms = self._events[0].elapsed_time(self._events[1])
        else:
            ms = (time.perf_counter() - self.t0) * 1e3
        self.ms = ms / self.repeat
        _report(self.name, self.ms, self.bytes, self.flops)
        return False


def bench_op(fn, *args, iters=20, flops=0, bytes_accessed=0, name=None):
    """Seconds per call of ``fn(*args)``, with each output fed back as
    the next call's first argument (so the first argument must have the
    output's shape and dtype): one warm-up call, then ``iters`` chained
    calls between CUDA events (host clock for CPU tensors)."""
    x, rest = args[0], args[1:]
    x = fn(x, *rest)                       # warm-up: builds, plans
    with Benchmark(name or "bench_op", bytes_accessed, flops, iters,
                   device=x.device) as b:
        for _ in range(iters):
            x = fn(x, *rest)
    if name:
        dt = b.ms / 1e3
        print(f"{name}: {b.ms:.3f} ms"
              + (f"  {flops / dt / 1e12:.2f} TFLOP/s" if flops else "")
              + (f"  {bytes_accessed / dt / 1e9:.1f} GB/s"
                 if bytes_accessed else ""))
    return b.ms / 1e3


@contextlib.contextmanager
def trace(logdir=None):
    """``torch.profiler`` over the block (CPU and, where there is a card,
    CUDA activity); on exit the Chrome trace is written to
    ``logdir/trace.json`` (a new temporary directory by default).  Yields
    logdir."""
    from torch.profiler import ProfilerActivity, profile
    logdir = logdir or tempfile.mkdtemp(prefix="bs_trace_")
    os.makedirs(logdir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield logdir
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def _tensor_bytes(tree):
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(_tensor_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_tensor_bytes(v) for v in tree)
    return 0


def memory_analysis(fn, *args, **kwargs):
    """Device memory of one call of ``fn(*args, **kwargs)`` on the card,
    in bytes: argument_size and output_size (their tensors), temp_size
    (the allocator's peak during the call past what it held before, less
    the outputs) and peak_estimate (arguments + that peak).  None where
    there is no card: the allocator's statistics are the card's."""
    if not torch.cuda.is_available():
        return None
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn(*args, **kwargs)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - before
    res = {"argument_size": _tensor_bytes(list(args) + list(kwargs.values())),
           "output_size": _tensor_bytes(out)}
    res["temp_size"] = max(peak - res["output_size"], 0)
    res["peak_estimate"] = res["argument_size"] + peak
    return res


def live_buffers(backend=None):
    """Live CUDA tensors that Python holds, grouped per device: [(shape,
    dtype, nbytes)], and total_bytes, what the caching allocator has
    handed out on every device (it also counts memory no Python tensor
    holds, as a CUDA graph's pool)."""
    per_dev = {}
    for obj in gc.get_objects():
        if issubclass(type(obj), torch.Tensor) and obj.is_cuda:
            per_dev.setdefault(str(obj.device), []).append(
                (tuple(obj.shape), str(obj.dtype),
                 obj.numel() * obj.element_size()))
    total = sum(torch.cuda.memory_allocated(d)
                for d in range(torch.cuda.device_count())) \
        if torch.cuda.is_available() else 0
    return {"per_device": per_dev, "total_bytes": int(total)}
