"""Collectives: the reference's ``nccl.py`` surface on ``torch.distributed``.

Counterpart of ``blocksparse_tpu/parallel/collectives.py``.  Each function
takes a mesh axis name (or a tuple of names) and resolves its process
group from the mesh (``mesh=``, by default the last one ``make_mesh``
built).  A collective over a size-1 axis still runs (a copy), so one
program issues the same calls at any mesh shape.

Gradients are those of the JAX functions under ``shard_map``: an
all-reduce's gradient is an all-reduce of dy (the reference's
``nccl.py:70``, and what JAX's transpose of ``psum`` gives with
``check_vma=False``), a reduce-scatter's an all-gather, an all-gather's a
reduce-scatter, an all-to-all's the all-to-all back.  The reference's
deadlock-avoidance machinery (op counters, ``serialize_allreduce_ops``
chains, several communicators) has no role: every rank issues the same
collectives in the same program order, so those functions pass their
arguments through.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from blocksparse_tpu_torch.parallel.mesh import (axis_group, current_mesh,
                                                 mpi_rank, mpi_size)

# the newer names where torch has them (the older ones warn there)
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor
_all_gather = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor


def _group(axis, mesh):
    return axis_group(current_mesh(mesh), axis)


def all_reduce_(x, group):
    """x summed over ``group``, in place; returns x."""
    dist.all_reduce(x, group=group)
    return x


def gather_dim(x, dim, group):
    """The group's x concatenated along ``dim`` in rank order (a view
    whose ``dim`` is not the outermost when dim > 0)."""
    n = dist.get_world_size(group)
    xt = x.movedim(dim, 0).contiguous()
    out = xt.new_empty((n * xt.shape[0],) + tuple(xt.shape[1:]))
    _all_gather(out, xt, group=group)
    return out.movedim(0, dim)


def scatter_sum_dim(x, dim, group):
    """x summed over ``group`` and cut along ``dim`` into the group's
    ranks' pieces: this rank's piece."""
    n = dist.get_world_size(group)
    xt = x.movedim(dim, 0).contiguous()
    if xt.shape[0] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not divide "
                         f"by {n} ranks")
    out = xt.new_empty((xt.shape[0] // n,) + tuple(xt.shape[1:]))
    _reduce_scatter(out, xt, group=group)
    return out.movedim(0, dim)


def all_to_all_dim(x, split_dim, concat_dim, group):
    """The tiled all-to-all (JAX's ``lax.all_to_all(tiled=True)``): x cut
    along ``split_dim`` into the group's n pieces, piece j sent to rank j,
    and the pieces received concatenated along ``concat_dim`` in rank
    order.  One ``all_to_all_single``; it moves data and adds nothing."""
    n = dist.get_world_size(group)
    if x.shape[split_dim] % n:
        raise ValueError(f"dim {split_dim} of {tuple(x.shape)} does not "
                         f"divide by {n} ranks")
    xt = x.movedim(split_dim, 0)
    xt = xt.reshape((n, xt.shape[0] // n) + tuple(xt.shape[1:])).contiguous()
    out = torch.empty_like(xt)
    dist.all_to_all_single(out, xt, group=group)
    return torch.cat([piece.movedim(0, split_dim) for piece in out.unbind(0)],
                     dim=concat_dim)


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.clone(memory_format=torch.contiguous_format),
                           group)

    @staticmethod
    def backward(ctx, dy):
        return all_reduce_(dy.clone(memory_format=torch.contiguous_format),
                           ctx.group), None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return scatter_sum_dim(x, dim, group)

    @staticmethod
    def backward(ctx, dy):
        return gather_dim(dy, ctx.dim, ctx.group), None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return gather_dim(x, dim, group)

    @staticmethod
    def backward(ctx, dy):
        return scatter_sum_dim(dy, ctx.dim, ctx.group), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split_dim, concat_dim, group):
        ctx.dims, ctx.group = (split_dim, concat_dim), group
        return all_to_all_dim(x, split_dim, concat_dim, group)

    @staticmethod
    def backward(ctx, dy):
        split_dim, concat_dim = ctx.dims
        return all_to_all_dim(dy, concat_dim, split_dim, ctx.group), None, \
            None, None


def allreduce(x, op_num=None, num_comms=2, prereduce=0, mpi_ranks=None,
              comm_id=0, logfile=None, axis="dp", mesh=None):
    """x summed over ``axis``; its gradient is an all-reduce of dy.

    ``prereduce`` with a two-axis ``axis`` (fast axis first) runs
    ``hierarchical_allreduce`` (the reference's intra-node reduce,
    inter-node all-reduce, intra-node broadcast); a tuple axis without it
    is one flat all-reduce over both.  op_num, num_comms, mpi_ranks,
    comm_id and logfile are the reference's and change nothing."""
    if prereduce and isinstance(axis, (tuple, list)) and len(axis) == 2:
        return hierarchical_allreduce(x, fast_axis=axis[0],
                                      slow_axis=axis[1], mesh=mesh)
    return _AllReduce.apply(x, _group(axis, mesh))


def hierarchical_allreduce(x, fast_axis="ici", slow_axis="dcn",
                           scatter_dimension=0, mesh=None):
    """Two-level all-reduce: reduce-scatter over the fast axis, all-reduce
    over the slow one, all-gather over the fast one, so only a 1/|fast|
    piece crosses the slow links.  The same sum as the flat all-reduce
    over both axes, up to the order of the additions.  Where x's
    ``scatter_dimension`` does not divide by the fast axis (or x is a
    scalar) it is that flat all-reduce."""
    d = scatter_dimension
    size = mpi_size(mesh, fast_axis)
    if x.dim() == 0 or x.shape[d] % size:
        return allreduce(x, axis=(fast_axis, slow_axis), mesh=mesh)
    part = reduce_scatter(x, axis=fast_axis, scatter_dimension=d, mesh=mesh)
    part = allreduce(part, axis=slow_axis, mesh=mesh)
    return all_gather(part, axis=fast_axis, concat_dimension=d, mesh=mesh)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def group_allreduce(grads, params=None, search_strings=None, cast_all=None,
                    axis="dp", mesh=None):
    """Each tensor of a tree (dict, list or tuple) summed over ``axis``,
    cast to ``cast_all`` first where given (the reference's fp16 bucket
    semantics).  ``params`` and ``search_strings`` (the reference's
    bucketing by name) change nothing."""
    def red(g):
        if cast_all is not None and g.dtype != cast_all:
            g = g.to(cast_all)
        return allreduce(g, axis=axis, mesh=mesh)
    return _tree_map(red, grads)


def sync_variables_op(params, axis="dp", mesh=None):
    """Every rank of ``axis`` takes rank 0's values (a new tree): the
    others' are zeroed and the axis summed, as the JAX function does.
    Run once after init."""
    first = mpi_rank(axis, current_mesh(mesh)) == 0
    group = _group(axis, mesh)

    def bcast(p):
        z = p.detach().clone() if first else torch.zeros_like(p)
        return all_reduce_(z, group)
    return _tree_map(bcast, params)


def sync_globals_zero_init_op(params, axis="dp", mesh=None):
    """The reference's ``sync_globals_zero_init_op``: ``sync_variables_op``
    (for zero-initialised variables the two agree)."""
    return sync_variables_op(params, axis, mesh)


def serialize_allreduce_ops(ops=None):
    """Returns ``ops``: every rank issues its collectives in one program
    order, so the reference's cross-rank ordering pass has nothing to
    do."""
    return ops


def identity_sync(*xs, sync_fwd=False, sync_bwd=False):
    """Returns its arguments (one as itself): PyTorch has no scheduler
    run-ahead for the reference's sync to stop."""
    return xs if len(xs) > 1 else xs[0]


def reduce_scatter(x, axis="dp", scatter_dimension=0, mesh=None):
    """x summed over ``axis``, this rank's 1/N piece along
    ``scatter_dimension`` (which must divide by N); its gradient is an
    all-gather."""
    return _ReduceScatter.apply(x, scatter_dimension, _group(axis, mesh))


def all_gather(x, axis="dp", concat_dimension=0, mesh=None):
    """The inverse of ``reduce_scatter``: the ranks' x concatenated along
    ``concat_dimension`` in rank order; its gradient is a
    reduce-scatter."""
    return _AllGather.apply(x, concat_dimension, _group(axis, mesh))


def all_to_all(x, axis="ep", split_dimension=0, concat_dimension=1,
               mesh=None):
    """The tiled all-to-all over ``axis`` (``all_to_all_dim``): this rank's
    x cut along ``split_dimension`` (which must divide by N), piece j to
    rank j, the pieces received concatenated along ``concat_dimension``
    in rank order.  Its gradient is the all-to-all back (the dimensions
    swapped)."""
    return _AllToAll.apply(x, split_dimension, concat_dimension,
                           _group(axis, mesh))
