"""Sequence-parallel block-sparse attention: the context sharded over a mesh
axis ("sp").

Counterpart of ``blocksparse_tpu/parallel/sequence.py``.  Every rank
keeps its slice of the context of q, k, v and of all activations;
attention is the only op that needs remote context.  Two modes:

- **gather** (``sequence_parallel_attention``): K and V are all-gathered
  along the context, and each rank runs the fused kernels over its own
  query rows.  The backward gathers them again, runs dq and dk/dv on the
  shard, and reduce-scatters dk/dv, in f32, back to their ranks.
- **ring** (``ring_attention``): K and V stay sharded and rotate around
  the ring (rank r sends to r + 1); each rank merges the (out, lse) of
  its query shard against each key chunk in turn, from a finite -1e30
  start, so a pair with no block (its lse -inf) adds nothing.  The
  backward circulates q, dO, lse, D and the f32 dq accumulator, and sums
  dk/dv at home; dq comes out of its kernel in f32
  (``attention_dq(out_dtype=torch.float32)``).

The kernels run on tables that cover one shard (``shard_tables``): the
query rows of the rank's shard, local, against every key block (gather)
or against the key blocks of one chunk, local too (ring).  Each rank
builds only its own, so there is no stacking and no inert padding (the
JAX package's ``MASK_ABSENT`` steps serve its one SPMD program).  A row
with no entry gives zeros (dq, dk/dv) and, forward, zeros and lse -inf.
The tables are the op's kernels' view (``kernel_view``: block size 8 seen
at 16, a shard with an odd number of 8-rows padded with a hidden row of
its own), with the plain versions' block indices beside them, and are
cached on the op per (shards, query shard, key chunk, device).

On CUDA tensors these launch the fused kernels; on CPU tensors they run
the plain versions, as the op's ``attention`` does; with the op's
``impl="xla"``, or past a head size of 128 on the CPU, the plain version
at the op's own block size.  Past hs 128 the card raises, as the fused
kernels do (the JAX sequence-parallel path calls only the fused
kernels).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from blocksparse_tpu_torch.ops.transformer import (_can_fuse, _rowsum,
                                                   _rows_contiguous,
                                                   fused_tables)
from blocksparse_tpu_torch.parallel.collectives import (gather_dim,
                                                        scatter_sum_dim)
from blocksparse_tpu_torch.parallel.mesh import (axis_group, current_mesh,
                                                 mpi_rank, mpi_size)

_NEG = -1e30      # the ring merge's finite start


def shard_tables(bst, n_shards, q_shard, k_chunk=None, device="cpu"):
    """The fused kernels' tables (``ops.transformer.fused_tables``) of
    one shard of ``bst``'s layout: query block-rows [q_shard·B, (q_shard +
    1)·B) of B = ctx_blks_q / n_shards, indexed locally, against every key
    block (``k_chunk`` None: the gather mode's K/V are whole) or against
    the key blocks of chunk ``k_chunk``, indexed locally (ring).  Each
    entry keeps its place in its row, so a shard's rows sum in the order
    of the unsharded layout's.  Also ``nt``, the shard's (q, k) blocks
    per layout head at the op's block size.  Cached on the op."""
    device = torch.device(device)
    key = (n_shards, q_shard, k_chunk, device)
    cache = bst.__dict__.setdefault("_shard_tables", {})
    if key in cache:
        return cache[key]
    if bst.ctx_blks_q % n_shards or bst.ctx_blks_k % n_shards:
        raise ValueError(f"ctx block-rows ({bst.ctx_blks_q}, "
                         f"{bst.ctx_blks_k}) must divide by {n_shards} "
                         f"shards")
    bq = bst.ctx_blks_q // n_shards
    qlo = q_shard * bq
    if k_chunk is None:
        bk, klo = bst.ctx_blks_k, 0
    else:
        bk = bst.ctx_blks_k // n_shards
        klo = k_chunk * bk
    bs = bst.blk_size
    nt, masks = [], []
    for h, blocks in enumerate(bst.nt_list):
        sel = [b for b, (qb, kb) in enumerate(blocks)
               if qlo <= qb < qlo + bq and klo <= kb < klo + bk]
        nt.append([(blocks[b][0] - qlo, blocks[b][1] - klo) for b in sel])
        masks.append(np.ones((len(sel), bs, bs), bool)
                     if bst._mask_blocks is None
                     else np.asarray(bst._mask_blocks[h])[sel]
                     .reshape(len(sel), bs, bs))
    tab = fused_tables(nt, masks, bs, bq, bk, device)
    tab["nt"] = nt
    cache[key] = tab
    return tab


def _kernels(bst, q):
    return bst.impl != "xla" and (q.is_cuda or _can_fuse(
        q.shape[-1] // bst.heads))


def _axis(mesh, axis, n_shards):
    mesh = current_mesh(mesh)
    n = mpi_size(mesh, axis)
    if n_shards not in (None, n):
        raise ValueError(f"n_shards {n_shards} is not the mesh's {axis} "
                         f"size {n}")
    return axis_group(mesh, axis), n, mpi_rank(axis, mesh)


def shard_forward(bst, q, k, v, scale, tab, kernels=None):
    """One shard's fused forward on its tables: (out, lse (batch, heads,
    ctx_q) f32).  ``kernels`` None: the op's route for q."""
    if kernels is None:
        kernels = _kernels(bst, q)
    return bst._fused_fwd(q, k, v, scale, kernels, True, tab)


def shard_backward(bst, q, k, v, do, dvec, lse, scale, tab, kernels=None,
                   dq_dtype=None):
    """One shard's dq and dk/dv (f32) on its tables, from D = ``dvec``."""
    if kernels is None:
        kernels = _kernels(bst, q)
    return bst._fused_bwd(q, k, v, do, None, lse, scale, kernels, tab,
                          dvec=dvec, dq_dtype=dq_dtype)


def merge(out, lse, o_t, lse_t, heads):
    """The streaming-softmax combine of a partial (o_t, lse_t) into the
    running (out f32, lse): returns the new pair.  out, o_t (batch, ctx,
    heads·hs); lse, lse_t (batch, heads, ctx) f32."""
    m = torch.maximum(lse, lse_t)
    new = m + torch.log(torch.exp(lse - m) + torch.exp(lse_t - m))
    batch, ctx, state = out.shape

    def w(a):
        return a.transpose(1, 2)[..., None]           # (batch, ctx, h, 1)
    o = (w(torch.exp(lse - new)) * out.reshape(batch, ctx, heads, -1)
         + w(torch.exp(lse_t - new))
         * o_t.float().reshape(batch, ctx, heads, -1))
    return o.reshape(batch, ctx, state), new


def _rotate(tensors, group, n, r):
    """Each tensor sent to rank r + 1 of the group and its predecessor's
    received in its place (one batch of point-to-point ops)."""
    to = dist.get_global_rank(group, (r + 1) % n)
    frm = dist.get_global_rank(group, (r - 1) % n)
    outs = [torch.empty_like(t, memory_format=torch.contiguous_format)
            for t in tensors]
    ops = []
    for i, (t, o) in enumerate(zip(tensors, outs)):
        ops.append(dist.P2POp(dist.isend, t.contiguous(), to, group, tag=i))
        ops.append(dist.P2POp(dist.irecv, o, frm, group, tag=i))
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return outs


class _GatherAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, bst, scale, group, n, r):
        kernels = _kernels(bst, q)
        tab = shard_tables(bst, n, r, None, q.device)
        y, lse = shard_forward(bst, q, gather_dim(k, 1, group),
                               gather_dim(v, 1, group), scale, tab, kernels)
        ctx.save_for_backward(q, k, v, y, lse)
        ctx.args = (bst, scale, group, tab, kernels)
        return y

    @staticmethod
    def backward(ctx, dy):
        q, k, v, y, lse = ctx.saved_tensors
        bst, scale, group, tab, kernels = ctx.args
        do = _rows_contiguous(dy.to(q.dtype))
        dq, dk, dv = shard_backward(
            bst, q, gather_dim(k, 1, group), gather_dim(v, 1, group), do,
            _rowsum(do, y, bst.heads), lse, scale, tab, kernels)
        dk = scatter_sum_dim(dk.float(), 1, group)
        dv = scatter_sum_dim(dv.float(), 1, group)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None, None, None)


class _RingAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, bst, scale, group, n, r):
        kernels = _kernels(bst, q)
        batch, ctx_q, _ = q.shape
        out = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        lse = torch.full((batch, bst.heads, ctx_q), _NEG,
                         dtype=torch.float32, device=q.device)
        kb, vb = k, v
        for t in range(n):
            j = (r - t) % n                         # the key chunk held
            o_t, lse_t = shard_forward(bst, q, kb, vb, scale,
                                       shard_tables(bst, n, r, j, q.device),
                                       kernels)
            out, lse = merge(out, lse, o_t, lse_t, bst.heads)
            if t < n - 1:
                kb, vb = _rotate([kb, vb], group, n, r)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (bst, scale, group, n, r, kernels)
        return out.to(q.dtype)

    @staticmethod
    def backward(ctx, dy):
        q, k, v, out, lse = ctx.saved_tensors
        bst, scale, group, n, r, kernels = ctx.args
        do = _rows_contiguous(dy.to(q.dtype))
        f32 = torch.float32
        qt, dot, lset, dvec = q, do, lse, _rowsum(do, out, bst.heads)
        dqa = torch.zeros(q.shape, dtype=f32, device=q.device)
        dka = torch.zeros(k.shape, dtype=f32, device=q.device)
        dva = torch.zeros(v.shape, dtype=f32, device=q.device)
        for t in range(n):
            j = (r - t) % n                         # the query shard held
            dq_t, dk_t, dv_t = shard_backward(
                bst, qt, k, v, dot, dvec, lset, scale,
                shard_tables(bst, n, j, r, q.device), kernels, dq_dtype=f32)
            dqa = dqa + dq_t
            dka = dka + dk_t
            dva = dva + dv_t
            if n == 1:
                continue
            if t < n - 1:
                qt, dot, lset, dvec, dqa = _rotate(
                    [qt, dot, lset, dvec, dqa], group, n, r)
            else:                                   # dq goes home
                dqa, = _rotate([dqa], group, n, r)
        return (dqa.to(q.dtype), dka.to(k.dtype), dva.to(v.dtype), None,
                None, None, None, None)


def sequence_parallel_attention(bst, q, k, v, axis="sp", n_shards=None,
                                scale=1.0, mesh=None):
    """Fused sparse attention with the context sharded over mesh axis
    ``axis``: q, k, v are this rank's context shards (batch, ctx/n,
    heads·hs) and the result is its output shard.  K/V are all-gathered
    (forward and again in the backward, whose dk/dv are reduce-scattered
    in f32).  n_shards: the axis size (checked), as the JAX function
    takes it."""
    group, n, r = _axis(mesh, axis, n_shards)
    return _GatherAttention.apply(q, k, v, bst, scale, group, n, r)


def ring_attention(bst, q, k, v, axis="sp", n_shards=None, scale=1.0,
                   mesh=None):
    """Fused sparse attention with q and K/V sharded over ``axis``: K/V
    chunks rotate around the ring, so a rank holds O(ctx/n) of them.
    Arguments as ``sequence_parallel_attention``."""
    group, n, r = _axis(mesh, axis, n_shards)
    return _RingAttention.apply(q, k, v, bst, scale, group, n, r)


def build_sp_schedules(bst, n_shards, device="cpu"):
    """The gather mode's tables of every shard (``shard_tables``), in
    shard order: the counterpart of the JAX builder, whose stacked
    schedules one SPMD program indexes by shard."""
    return [shard_tables(bst, n_shards, i, None, device)
            for i in range(n_shards)]


def build_ring_schedules(bst, n_shards, device="cpu"):
    """The ring's tables of every (query shard, key chunk) pair:
    ``[qi][kj]``."""
    return [[shard_tables(bst, n_shards, qi, kj, device)
             for kj in range(n_shards)] for qi in range(n_shards)]
