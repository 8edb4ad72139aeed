"""GPipe pipeline parallelism over a mesh axis ("pp").

Counterpart of ``blocksparse_tpu/parallel/pipeline.py``.  Each rank along
the "pp" axis holds a contiguous slice of the layers (a stage), and
microbatches stream through the stages: stage s takes microbatch m from
stage s - 1 (stage 0 from ``x_micro[m]``), runs its layers and hands the
result to stage s + 1, by point-to-point sends on the pp group
(``batch_isend_irecv``).

The JAX package runs one SPMD ``lax.scan`` of n_micro + S - 1 ticks,
computing on garbage in the bubble ticks, and derives the backward by
transposing the scan.  Here the schedule is written out instead, as one
``torch.autograd.Function`` that takes the stage's parameters as inputs:

- forward: every microbatch in order, each through ``stage_forward`` (the
  stage function run under autograd on a detached input that requires
  grad, its graph kept), the output sent on;
- backward: the microbatches in reverse, each through ``stage_backward``
  (``torch.autograd.grad`` of the stage's output and aux against dy, the
  next stage's input gradient, and the aux's cotangent, onto its input and
  parameters), the input gradient sent back.

So no rank computes in a bubble, no two ranks need to agree on the order
of autograd's engine, and the gradient is the transposed scan's: a bubble
tick's cotangent is exactly zero there.  Each parameter's gradient adds
the microbatches' in reverse order (the order of the transposed scan), and
the sends move data and add nothing.

The 1/S trick (the JAX module's docstring): the last stage's output is
replicated by ``broadcast_from_last`` (mask, then an all-reduce whose
gradient is an all-reduce of dy, as JAX's transpose of ``psum`` under
``check_vma=False``), and the per-rank loss is scaled by 1/S.  Then a sum
over "pp" of the shared parameters' gradients (embeddings, final norm,
head) is exact, the true cotangent enters the pipeline on the last stage,
and the stage parameters need no sum over "pp".  The input's gradient is
nonzero on stage 0 only, zero (not missing) elsewhere.

``stage_forward``/``stage_backward`` are plain functions, so one process
can drive every stage of a pipeline in turn, handing the activations over
by tensor (``chip_smoke.py`` does so on one card).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from blocksparse_tpu_torch.parallel.collectives import allreduce
from blocksparse_tpu_torch.parallel.mesh import (axis_group, current_mesh,
                                                 mpi_rank, mpi_size)


def stage_parameters(tree):
    """The floating-point tensors of a stage's parameters ``tree`` (dict,
    list or tuple; a module stands for its parameters), in order: what
    ``stage_backward`` takes the gradients of.  Other tensors of the tree
    (a stage's bool dropout masks) ride along to the stage function and
    get no gradient."""
    if isinstance(tree, torch.nn.Module):
        return list(tree.parameters())
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in stage_parameters(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in stage_parameters(v)]
    return [tree] if isinstance(tree, torch.Tensor) \
        and tree.is_floating_point() else []


def stage_forward(stage_fn, stage_params, x, with_aux=False):
    """One stage on one microbatch, kept for ``stage_backward``: returns
    (x_in, y, aux), x_in = x detached and requiring grad, y =
    stage_fn(stage_params, x_in) computed under autograd (its graph
    kept), aux the stage's scalar aux (``with_aux``) or None."""
    x_in = x.detach().requires_grad_(x.is_floating_point())
    with torch.enable_grad():
        out = stage_fn(stage_params, x_in)
    y, aux = out if with_aux else (out, None)
    return x_in, y, aux


def stage_backward(saved, dy, params, daux=None):
    """The backward of one ``stage_forward`` record: (dx, [d param]) for
    the cotangents dy of its output and ``daux`` of its aux (None: the
    aux has none).  ``params``: the stage's parameters (a list of
    tensors); a parameter the stage did not use, or one that needs no
    gradient, gets zeros."""
    x_in, y, aux = saved
    outs, grads = [y], [dy]
    if aux is not None and daux is not None and aux.requires_grad:
        outs.append(aux)
        grads.append(daux.to(aux.dtype))
    wrt = [x_in] + [p for p in params if p.requires_grad]
    got = iter(torch.autograd.grad(outs, wrt, grads, allow_unused=True))
    dx = next(got)
    dps = [next(got) if p.requires_grad else None for p in params]
    dx = torch.zeros_like(x_in) if dx is None else dx
    return dx, [torch.zeros_like(p) if d is None else d
                for p, d in zip(params, dps)]


def _p2p(op, t, peer, group, tag):
    """One point-to-point op on ``group``'s rank ``peer``, waited for."""
    for work in dist.batch_isend_irecv(
            [dist.P2POp(op, t, dist.get_global_rank(group, peer), group,
                        tag=tag)]):
        work.wait()
    return t


def _send(t, peer, group, tag):
    _p2p(dist.isend, t.detach().contiguous(), peer, group, tag)


def _recv(like, peer, group, tag):
    return _p2p(dist.irecv, torch.empty_like(
        like, memory_format=torch.contiguous_format), peer, group, tag)


def _forward(stage_fn, stage_params, x_micro, with_aux, comm, keep):
    """The forward schedule: (outputs (n_micro, ...), aux summed over the
    microbatches (f32), the kept records or None)."""
    group, S, r = comm
    M = x_micro.shape[0]
    ys, records = [], [] if keep else None
    aux = torch.zeros((), dtype=torch.float32, device=x_micro.device)
    for m in range(M):
        h = x_micro[m] if r == 0 else _recv(x_micro[m], r - 1, group, m)
        if keep:
            rec = stage_forward(stage_fn, stage_params, h, with_aux)
            records.append(rec)
            y, a = rec[1].detach(), rec[2]
        else:
            out = stage_fn(stage_params, h)
            y, a = out if with_aux else (out, None)
        if a is not None:
            aux = aux + a.detach().float()
        if r < S - 1:
            _send(y, r + 1, group, m)
        ys.append(y)
    return torch.stack(ys), aux, records


class _GPipe(torch.autograd.Function):
    @staticmethod
    def forward(ctx, stage_fn, stage_params, with_aux, comm, x_micro,
                *params):
        out, aux, records = _forward(stage_fn, stage_params, x_micro,
                                     with_aux, comm, keep=True)
        ctx.records, ctx.comm, ctx.params = records, comm, params
        return out, aux

    @staticmethod
    def backward(ctx, dout, daux):
        group, S, r = ctx.comm
        records, params = ctx.records, ctx.params
        M = len(records)
        dx_micro = [None] * M
        total = None
        for m in reversed(range(M)):
            dy = dout[m]
            if r < S - 1:
                dy = dy + _recv(records[m][1], r + 1, group, M + m)
            dx, dps = stage_backward(records[m], dy, params, daux)
            records[m] = None
            if r > 0:
                _send(dx, r - 1, group, M + m)
                dx = torch.zeros_like(dx)
            dx_micro[m] = dx
            total = dps if total is None else [
                t + d for t, d in zip(total, dps)]
        ctx.records = None
        return (None, None, None, None, torch.stack(dx_micro), *total)


_JOINED = set()   # the pp groups whose ranks have all met once


def _join(group, device):
    """Under NCCL, where ``batch_isend_irecv`` is the first operation on a
    group, every rank of the group must take part in it (torch's rule);
    gpipe's sends are between two neighbours.  So one all-reduce of one
    element over the whole group comes first, once a group."""
    if group not in _JOINED:
        dist.all_reduce(torch.zeros(1, device=device), group=group)
        _JOINED.add(group)


def _pp_axis(axis, n_stages, mesh):
    mesh = current_mesh(mesh)
    S = mpi_size(mesh, axis)
    if n_stages not in (None, S):
        raise ValueError(f"n_stages {n_stages} is not the mesh's {axis} "
                         f"size {S}")
    return axis_group(mesh, axis), S, mpi_rank(axis, mesh)


def gpipe(stage_fn, stage_params, x_micro, *, axis="pp", n_stages=None,
          with_aux=False, mesh=None):
    """Run a shape-preserving stage pipeline over mesh axis ``axis``.

    Args:
      stage_fn: ``(stage_params, h) -> h``, THIS rank's layer slice; it
        preserves h's shape and dtype (identical stages).  With
        ``with_aux``: ``(stage_params, h) -> (h, aux)``, aux a scalar
        auxiliary loss (e.g. MoE load balance).
      stage_params: this rank's parameters (a tensor, a dict, list or
        tuple of them, or a module), passed to stage_fn as they are; the
        gradients reach their floating-point tensors through the pipeline
        (``stage_parameters``).
      x_micro: ``(n_micro, ...)`` microbatched input, the same on every
        rank of the axis; only stage 0 consumes it (its gradient is zero
        on the other stages).
      axis: the pipeline's mesh axis; n_stages: its size (checked), as the
        JAX function takes it; mesh: the ``DeviceMesh`` (default the last
        ``make_mesh``'s).
      with_aux: also return this stage's aux summed over its microbatches.

    Returns:
      ``(n_micro, ...)``: this stage's outputs, which on the last stage
      are the pipeline's (valid only there: ``broadcast_from_last``
      replicates them).  With ``with_aux``: ``(outputs, aux_sum)``, aux_sum
      f32 and distinct per stage (sum it over the axis, never divide by
      S).  Under ``torch.no_grad`` (or with nothing that needs a
      gradient) the forward runs alone and keeps no graph."""
    comm = _pp_axis(axis, n_stages, mesh)
    _join(comm[0], x_micro.device)
    params = stage_parameters(stage_params)
    if torch.is_grad_enabled() and (x_micro.requires_grad or any(
            p.requires_grad for p in params)):
        out, aux = _GPipe.apply(stage_fn, stage_params, with_aux, comm,
                                x_micro, *params)
    else:
        out, aux, _ = _forward(stage_fn, stage_params, x_micro, with_aux,
                               comm, keep=False)
    return (out, aux) if with_aux else out


def broadcast_from_last(y, *, axis="pp", n_stages=None, mesh=None):
    """The last stage's ``y`` on every rank of the axis: the others' are
    masked to zero and the axis summed.  Its gradient (the all-reduce's,
    an all-reduce of dy, then the mask) delivers the summed cotangent to
    the last stage only."""
    group, S, r = _pp_axis(axis, n_stages, mesh)
    mask = float(r == S - 1)
    return allreduce(y * mask, axis=axis, mesh=mesh)


def microbatch(x, n_micro, batch_axis=0):
    """Split ``batch`` into ``(n_micro, batch/n_micro, ...)`` (a view)."""
    if x.shape[batch_axis] % n_micro:
        raise ValueError(f"batch {x.shape[batch_axis]} of {tuple(x.shape)} "
                         f"does not divide by {n_micro} microbatches")
    b = x.shape[batch_axis] // n_micro
    new = x.shape[:batch_axis] + (n_micro, b) + x.shape[batch_axis + 1:]
    return x.reshape(new).movedim(batch_axis, 0) if batch_axis \
        else x.reshape(new)


def unmicrobatch(y, batch_axis=0):
    """Inverse of :func:`microbatch` (batch_axis=0 layout)."""
    if batch_axis != 0:
        raise ValueError(f"unmicrobatch takes batch_axis 0, not "
                         f"{batch_axis}")
    return y.reshape((y.shape[0] * y.shape[1],) + tuple(y.shape[2:]))
