"""Gradient utilities: recompute and a gradient entry point.

Counterpart of ``blocksparse_tpu/ops/grads.py``:

* ``recomputable`` runs the wrapped function under
  ``torch.utils.checkpoint`` when called with ``recompute=True`` (the
  JAX ``jax.checkpoint``): its activations are not kept, the backward
  runs its forward again.  The recompute draws what the forward drew:
  the global entropy generators and every ``torch.Generator`` among the
  arguments are set back to their states before the forward (as the
  JAX recompute replays its keys) and put back after it;
* ``gradients`` is ``torch.autograd.grad`` over a dict (or list, or
  single tensor) of inputs, with the JAX function's ``grad_ys``,
  ``stop_grads`` and ``has_aux``.

The reference's aggregation trees and op ordering are the autograd
engine's concern here; ``group_aggregations`` and ``custom_matmul_grad``
are accepted and ignored.
"""
from __future__ import annotations

import contextlib
import functools

import torch
from torch.utils.checkpoint import checkpoint

from blocksparse_tpu_torch.utils import entropy_state, set_entropy_state


class recomputable:
    """Decorator: with ``recompute=True`` (a keyword of the call) the
    function runs under ``torch.utils.checkpoint``."""

    def __init__(self, func):
        functools.update_wrapper(self, func)
        self.func = func

    def __call__(self, *args, **kwargs):
        recompute = kwargs.pop("recompute", False)
        if not recompute:
            return self.func(*args, **kwargs)
        f = functools.partial(self.func, **kwargs) if kwargs else self.func
        replay = _Replay(list(_generators((args, kwargs))))
        return checkpoint(f, *args, use_reentrant=False,
                          context_fn=lambda: (contextlib.nullcontext(),
                                              replay))

    def __get__(self, instance, owner):
        return functools.partial(self.__call__, instance)


def _generators(tree):
    """The ``torch.Generator``s in a tree of arguments."""
    if isinstance(tree, torch.Generator):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _generators(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _generators(v)


class _Replay:
    """The context of a recompute: the global entropy generators and
    ``gens`` are set to their states at construction (before the
    forward) and put back to where they were on the way out."""

    def __init__(self, gens):
        self.gens = gens
        self.saved = self._states()

    def _states(self):
        return entropy_state(), [g.get_state() for g in self.gens]

    def _set(self, states):
        set_entropy_state(states[0])
        for g, s in zip(self.gens, states[1]):
            g.set_state(s)

    def __enter__(self):
        self.now = self._states()
        self._set(self.saved)

    def __exit__(self, *exc):
        self._set(self.now)


def _leaves(tree):
    """(leaves, rebuild) of a tensor, or a dict/list/tuple of them."""
    if isinstance(tree, dict):
        keys = list(tree)
        parts = [_leaves(tree[k]) for k in keys]
    elif isinstance(tree, (list, tuple)):
        keys = None
        parts = [_leaves(t) for t in tree]
    else:
        return [tree], lambda xs: xs[0]
    counts = [len(p[0]) for p in parts]

    def rebuild(xs):
        out, i = [], 0
        for (_, rb), n in zip(parts, counts):
            out.append(rb(xs[i:i + n]))
            i += n
        if keys is not None:
            return dict(zip(keys, out))
        return type(tree)(out)
    return [x for p in parts for x in p[0]], rebuild


def _stops(stop_grads, xs):
    """A bool per leaf of xs: True where ``stop_grads`` (a bool, or a tree
    of bools over xs or a prefix of it; None is False) holds it
    constant."""
    if stop_grads is None or isinstance(stop_grads, bool):
        return [bool(stop_grads)] * len(_leaves(xs)[0])
    if isinstance(xs, dict):
        return [s for k in xs for s in _stops(stop_grads.get(k), xs[k])]
    return [s for sg, x in zip(stop_grads, xs) for s in _stops(sg, x)]


def gradients(fun, xs, grad_ys=None, stop_grads=None, group_aggregations=8,
              custom_matmul_grad=True, has_aux=False):
    """The gradient of ``fun(xs)`` with respect to xs, in xs' structure.

    fun: takes ``xs`` and returns a scalar (or (output, aux) with
    has_aux=True); with ``grad_ys`` the output may be any tree of
    tensors, and grad_ys is the cotangent seeded into the backward.
    stop_grads: True (for all of xs) or a tree of bools over xs: those
    leaves are held constant; their gradients are zeros.
    Returns the gradient tree (and aux if asked)."""
    leaves, rebuild = _leaves(xs)
    stops = _stops(stop_grads, xs)
    inputs = [x.detach() if s else x.detach().requires_grad_()
              for x, s in zip(leaves, stops)]
    with torch.enable_grad():
        out = fun(rebuild(inputs))
    aux = None
    if has_aux:
        out, aux = out
    outs, _ = _leaves(out)
    seeds = None if grad_ys is None else _leaves(grad_ys)[0]
    wrt = [x for x in inputs if x.requires_grad]
    found = iter(torch.autograd.grad(outs, wrt, grad_outputs=seeds,
                                     allow_unused=True) if wrt else ())
    grads = []
    for x in inputs:
        g = next(found) if x.requires_grad else None
        grads.append(torch.zeros_like(x) if g is None else g)
    gx = rebuild(grads)
    return (gx, aux) if has_aux else gx
