"""Fused block-sparse attention, forward and backward: the CUDA kernels
and their plain versions.

``attention_fwd`` replaces the TPU kernel ``fused_attention_fwd``
(``blocksparse_tpu/kernels/bst_attn.py``, body ``_attn_kernel``):
softmax(scale·QKᵀ + mask)·V over each query block-row's key blocks, with
an online softmax so the score tensor never reaches device memory.
``attention_fwd_lse`` (for ``fused_attention_fwd_lse``) also returns the
per-row log-sum-exp in f32, which the backward reads.  One thread block
per (query block-row, batch·head): bf16 and f16 run
``csrc/bst_attn_fwd_mma.cu`` on the tensor cores (``mma.sync``, S and P
in registers, the online softmax on the accumulator fragments, a
``cp.async`` ring of k/v blocks), f32 runs ``csrc/bst_attn_fwd.cu``,
exact on the CUDA cores; both have one C interface.

``attention_dq`` and ``attention_dkv`` replace ``fused_attention_dq`` and
``fused_attention_dkv``: bf16 and f16 run ``csrc/bst_attn_bwd_mma.cu`` on
the tensor cores (``mma.sync``, P and dS in registers, a ``cp.async``
ring of k/v or q/dO blocks), f32 runs ``csrc/bst_attn_bwd.cu``, exact on
the CUDA cores; both have one C interface.  dq walks the query-row (nn)
CSR of the forward; dk/dv walk the key-row (tn) CSR whose mask codes are
classified on the transposed mask blocks, and come out in f32, their key
rows launched in CSR order or in a given order (``launch_order``: the
rows with the most entries first).  dq comes out in q's dtype or, with
``out_dtype=torch.float32``, unrounded in f32 (ring attention sums a
row's dq over several launches).  D = rowsum(dO∘O) is plain torch, as
in ``fused_attention_bwd``.  The kernels take tables whose query and key
contexts differ and whose rows may be empty (a sequence-parallel shard's,
``parallel.sequence.shard_tables``): an empty row stores zeros (and lse
-inf forward).

All kernels read q/k/v/dO in the public (batch, ctx, heads·hs) layout
through their strides, so the column slices of a packed qkv tensor go in
without a copy (the tensor-core kernels copy 16 bytes a thread: a view
whose start or batch or row stride is off 16 bytes goes in as a copy,
``_aligned16``); lse and D are (batch, heads, ctx_q) f32.  The TPU
kernels' q-row pairing, lane folding and stream-vs-resident choice are
TPU mechanics and are not carried over.

The kernels are built for block sizes 16-64 and head sizes 16, 32, 64
and 128.  ``kernel_view`` and ``kernel_head_size`` carry every other
size the reference fuses onto them (block size 8 as a view of the
layout at 16, a head size up to 128 zero-padded), and
``kernel_tables`` builds the view's tables; ``BlocksparseTransformer``
runs its attention through them.

``attention_fwd_plain``, ``attention_fwd_lse_plain`` and
``attention_bwd_plain`` are the plain PyTorch versions: masked per-block
references that materialise the blocked scores.  All define the output
of a query row that sees no key as zeros, its lse as -inf and its
gradients as zeros.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from blocksparse_tpu_torch.kernels import _build

# Per-entry mask codes (same values as the JAX package).
MASK_ABSENT = 0   # padding slot: fully masked
MASK_FULL = 1     # all-visible block
MASK_TRIL = 2     # q >= k within the block (causal diagonal)
MASK_TRIU = 3     # q <= k
MASK_UNIQ0 = 4    # >=4: index code-4 into the unique-block table

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# The sizes the kernels are built for.  The op runs every other size the
# reference fuses through them: block size 8 as a view of the layout at
# block size 16 (``kernel_view``), a head size up to 128 zero-padded to
# the next of HEAD_SIZES (``kernel_head_size``).
BLOCK_SIZES = (16, 32, 64)
HEAD_SIZES = (16, 32, 64, 128)


def kernel_head_size(hs):
    """The head size the kernels run a head of ``hs`` at: the least of
    HEAD_SIZES that holds it.  q, k, v and dO are zero-padded to it: zero
    columns of q and k change no score, zero columns of v give output
    columns that are dropped, and so are dq, dk and dv there.  Raises
    past the largest: there ``BlocksparseTransformer.attention`` runs the
    unfused ops (``kernels/bst_trio.py``), as the reference does."""
    for h in HEAD_SIZES:
        if hs <= h:
            return h
    raise NotImplementedError(
        f"head size {hs} > {HEAD_SIZES[-1]}: the fused kernels stop there; "
        f"attention runs the unfused nt/nn/tn ops past it")


def kernel_view(nt_lists, mask_blocks, bs, ctx_blks_q, ctx_blks_k):
    """The layout as the kernels see it: (nt_lists, masks, bs, ctx_blks_q,
    ctx_blks_k) at a block size the kernels take.

    nt_lists: per layout head, the (q_blk, k_blk) blocks in row order;
    mask_blocks: (lut_heads, blocks, bs, bs) bool in that order (or a
    list of each head's (blocks, bs, bs), where the heads' counts
    differ), or None.
    From block size 16 up the layout is returned as it is (masks a
    list of each head's (blocks, bs, bs) array, or None).  At block size 8
    a 16 x 16 block is present where any of its four 8 x 8 sub-blocks is,
    and its element mask is the union of theirs, an absent sub-block all
    False.  An odd ctx_blks gains one 8-row (8-column) of query (key)
    positions that the masks hide; the caller pads q (k, v) with it and
    drops it from the results.  The heads' block counts may differ."""
    if bs >= BLOCK_SIZES[0]:
        masks = None if mask_blocks is None else list(mask_blocks)
        return list(nt_lists), masks, bs, ctx_blks_q, ctx_blks_k
    kbs = BLOCK_SIZES[0]
    f = kbs // bs
    lists, masks = [], []
    for h, nt in enumerate(nt_lists):
        blocks = {}
        for b, (qb, kb) in enumerate(nt):
            m = blocks.setdefault((qb // f, kb // f),
                                  np.zeros((kbs, kbs), bool))
            r, c = qb % f * bs, kb % f * bs
            m[r:r + bs, c:c + bs] = (True if mask_blocks is None
                                     else mask_blocks[h][b])
        keys = sorted(blocks)
        lists.append(keys)
        masks.append(np.array([blocks[key] for key in keys], bool)
                     .reshape(len(keys), kbs, kbs))
    return lists, masks, kbs, -(-ctx_blks_q // f), -(-ctx_blks_k // f)


def kernel_tables(nt_lists, masks, bs, ctx_blks_q, ctx_blks_k):
    """The kernels' tables of a layout (``kernel_view``'s output), as
    NumPy arrays: the query-row (nn) CSR with its mask codes and table
    and the launch order of its rows (``row_ptr``, ``ent_k``,
    ``ent_code``, ``uniq``, ``order``); the key-row (tn) CSR with the
    transposed codes (``row_ptr_t``, ``ent_q``, ``ent_code_t``,
    ``uniq_t``, ``order_t``); and the plain versions' (lut_heads, blocks)
    block indices ``q_blk``, ``k_blk`` and ``mask`` (None without masks).
    Where the heads' block counts differ, the plain versions' arrays are
    filled out with block (0, 0) under an all-False mask, which adds
    nothing; the CSRs hold only real blocks."""
    lut_heads = len(nt_lists)
    n = max(len(nt) for nt in nt_lists)
    q_blk = np.zeros((lut_heads, n), np.int64)
    k_blk = np.zeros((lut_heads, n), np.int64)
    rows_q = [[[] for _ in range(ctx_blks_q)] for _ in nt_lists]
    rows_k = [[[] for _ in range(ctx_blks_k)] for _ in nt_lists]
    for h, nt in enumerate(nt_lists):
        for b, (qb, kb) in enumerate(nt):
            q_blk[h, b], k_blk[h, b] = qb, kb
            rows_q[h][qb].append((b, kb))
            rows_k[h][kb].append((b, qb))
    if masks is None:
        mask = None
        codes = codes_t = None
        uniq = uniq_t = np.zeros((bs, bs), np.int8)
    else:
        mask = np.zeros((lut_heads, n, bs, bs), bool)
        for h, m in enumerate(masks):
            mask[h, :len(m)] = m
        codes, uniq = classify_mask_blocks(mask, bs)
        codes_t, uniq_t = classify_mask_blocks(
            np.ascontiguousarray(np.transpose(mask, (0, 1, 3, 2))), bs)
    row_ptr, ent_k, ent_code = build_attn_csr(rows_q, codes)
    row_ptr_t, ent_q, ent_code_t = build_attn_csr(rows_k, codes_t)
    return {"row_ptr": row_ptr, "ent_k": ent_k, "ent_code": ent_code,
            "uniq": uniq, "order": launch_order(row_ptr, ctx_blks_q),
            "row_ptr_t": row_ptr_t, "ent_q": ent_q, "ent_code_t": ent_code_t,
            "uniq_t": uniq_t, "order_t": launch_order(row_ptr_t, ctx_blks_k),
            "q_blk": q_blk, "k_blk": k_blk, "mask": mask}


def classify_mask_blocks(mask_blocks, bs):
    """(lut_heads, blocks, bs, bs) bool -> (codes (lut_heads, blocks),
    uniq table (n_uniq*bs, bs) int8)."""
    mb = np.asarray(mask_blocks, bool)
    tril = np.tril(np.ones((bs, bs), bool))
    triu = tril.T
    lut_heads, blocks = mb.shape[:2]
    codes = np.zeros((lut_heads, blocks), np.int32)
    uniq, uniq_of = [], {}
    for h in range(lut_heads):
        for b in range(blocks):
            m = mb[h, b]
            if m.all():
                codes[h, b] = MASK_FULL
            elif (m == tril).all():
                codes[h, b] = MASK_TRIL
            elif (m == triu).all():
                codes[h, b] = MASK_TRIU
            else:
                key = m.tobytes()
                if key not in uniq_of:
                    uniq_of[key] = len(uniq)
                    uniq.append(m)
                codes[h, b] = MASK_UNIQ0 + uniq_of[key]
    if uniq:
        table = np.concatenate([m.astype(np.int8) for m in uniq], axis=0)
    else:
        table = np.zeros((bs, bs), np.int8)
    return codes, table


def build_attn_csr(nn_list_per_head, codes):
    """CSR of each query block-row's key blocks, per layout head.

    nn_list_per_head: [head][q_row] -> [(block_id, k_blk)] in accumulation
    order; codes: (lut_heads, blocks) mask codes or None (all FULL).
    Returns (row_ptr (lut_heads*(rows+1),), ent_k, ent_code) int32 numpy
    arrays; row_ptr holds absolute offsets into the flat entry arrays."""
    row_ptr, ent_k, ent_code = [], [], []
    for h, rows in enumerate(nn_list_per_head):
        for ents in rows:
            row_ptr.append(len(ent_k))
            for bid, kb in ents:
                ent_k.append(kb)
                ent_code.append(MASK_FULL if codes is None else codes[h, bid])
        row_ptr.append(len(ent_k))
    return (np.asarray(row_ptr, np.int32), np.asarray(ent_k, np.int32),
            np.asarray(ent_code, np.int32))


def launch_order(row_ptr, rows):
    """The block-rows of each layout head by entry count, most first
    (stable: ties keep their order): a (lut_heads, rows) int32 array from
    a CSR's row_ptr (``build_attn_csr``), the order in which a kernel
    launches its thread blocks (the forward's query rows, dk/dv's key
    rows), so the longest walks start in the first wave."""
    counts = np.diff(np.asarray(row_ptr).reshape(-1, rows + 1), axis=1)
    return np.argsort(-counts, axis=1, kind="stable").astype(np.int32)


def _blocked(q, k, v, q_blk, k_blk, heads, bs):
    """Gather each layout block's q/k rows: (batch, heads, blocks, bs, hs)
    f32 q and k, and v in its own dtype; plus the block index tensors."""
    f32 = torch.float32
    batch, ctx_q, state = q.shape
    hs = state // heads
    cq, ck = ctx_q // bs, k.shape[1] // bs

    def split(a, cb):
        return a.reshape(batch, cb, bs, heads, hs).permute(0, 3, 1, 2, 4)

    hidx = torch.arange(heads, device=q.device)[:, None]
    qb = q_blk.expand(heads, -1)                   # (heads, blocks)
    kb = k_blk.expand(heads, -1)
    qg = split(q, cq)[:, hidx, qb].to(f32)         # (n, h, blocks, bs, hs)
    kg = split(k, ck)[:, hidx, kb].to(f32)
    vg = split(v, ck)[:, hidx, kb]
    return qg, kg, vg, hidx, qb, kb


def _scatter_rows(blocks, idx, n_rows):
    """Sum (n, h, blocks, bs, hs) block rows into (n, h, n_rows, bs, hs) at
    the block indices idx (heads, blocks), in f32."""
    n, h, nb, bs, hs = blocks.shape
    out = torch.zeros((n, h, n_rows, bs, hs), dtype=torch.float32,
                      device=blocks.device)
    ix = idx[None, :, :, None, None].expand(n, h, nb, bs, hs)
    return out.scatter_add(2, ix, blocks)


def _merge(a5):
    """(n, h, ctx_blks, bs, hs) -> (n, ctx, h*hs)."""
    n, h, cb, bs, hs = a5.shape
    return a5.permute(0, 2, 3, 1, 4).reshape(n, cb * bs, h * hs)


def attention_fwd_lse_plain(q, k, v, q_blk, k_blk, mask, heads, bs, scale):
    """Masked per-block reference of the fused forward, returning
    (out, lse).

    q: (batch, ctx_q, heads*hs); k, v: (batch, ctx_k, heads*hs).
    q_blk, k_blk: (lut_heads, blocks) int64 tensors, the layout's blocks
    in row order (nt_list); mask: (lut_heads, blocks, bs, bs) bool tensor
    or None.  Scores and sums in f32; p is rounded to v's dtype before
    p·v, as the fused kernels do.  lse: (batch, heads, ctx_q) f32.  A
    query row that sees no key gives zeros and lse = -inf."""
    f32 = torch.float32
    batch, ctx_q, state = q.shape
    cq = ctx_q // bs
    qg, kg, vg, _, qb, _ = _blocked(q, k, v, q_blk, k_blk, heads, bs)
    s = torch.einsum("nhbqd,nhbkd->nhbqk", qg, kg) * scale
    if mask is not None:
        s = s.masked_fill(~mask[None], float("-inf"))
    blocks = qb.shape[1]
    idx = qb[None, :, :, None].expand(batch, heads, blocks, bs)
    m = torch.full((batch, heads, cq, bs), float("-inf"), dtype=f32,
                   device=q.device)
    m = m.scatter_reduce(2, idx, s.amax(-1), "amax")
    mg = m.gather(2, idx)
    mg = torch.where(torch.isinf(mg), torch.zeros_like(mg), mg)
    p = torch.exp(s - mg[..., None])               # masked -> 0
    l = torch.zeros_like(m).scatter_add(2, idx, p.sum(-1))
    pv = torch.einsum("nhbqk,nhbkd->nhbqd", p.to(v.dtype).to(f32),
                      vg.to(f32))
    acc = _scatter_rows(pv, qb, cq)
    out = torch.where(l[..., None] > 0, acc / l.clamp_min(1e-30)[..., None],
                      torch.zeros_like(acc))
    lse = torch.where(l > 0, m + torch.log(l.clamp_min(1e-30)),
                      torch.full_like(l, float("-inf")))
    return _merge(out).to(q.dtype), lse.reshape(batch, heads, ctx_q)


def attention_fwd_plain(q, k, v, q_blk, k_blk, mask, heads, bs, scale):
    """The forward of ``attention_fwd_lse_plain`` without the lse."""
    return attention_fwd_lse_plain(q, k, v, q_blk, k_blk, mask, heads, bs,
                                   scale)[0]


def attention_bwd_plain(q, k, v, do, lse, dvec, q_blk, k_blk, mask, heads,
                        bs, scale, dq_dtype=None):
    """Masked per-block reference of the fused backward.

    q, k, v as in ``attention_fwd_lse_plain``; do: the output's gradient,
    shaped like q; lse, dvec: (batch, heads, ctx_q) f32, the forward's lse
    and D = rowsum(do·out).  P = exp(scale·qkᵀ - lse) (0 where masked);
    dS = P·(do·vᵀ - D)·scale.  dq = round(dS)·k (dS rounded to k's dtype),
    dv = round(P)ᵀ·do, dk = round(dS)ᵀ·q, as the fused kernels round.
    Returns dq in q's dtype (or ``dq_dtype``: f32 keeps the sum unrounded,
    as ``attention_dq(out_dtype=torch.float32)``) and dk, dv in f32."""
    f32 = torch.float32
    batch, ctx_q, state = q.shape
    hs = state // heads
    cq, ck = ctx_q // bs, k.shape[1] // bs
    qg, kg, vg, hidx, qb, kb = _blocked(q, k, v, q_blk, k_blk, heads, bs)
    dog = do.reshape(batch, cq, bs, heads, hs).permute(0, 3, 1, 2, 4)[
        :, hidx, qb].to(f32)
    lse_g = lse.reshape(batch, heads, cq, bs)[:, hidx, qb]
    d_g = dvec.reshape(batch, heads, cq, bs)[:, hidx, qb]
    s = torch.einsum("nhbqd,nhbkd->nhbqk", qg, kg) * scale
    p = torch.exp(s - lse_g[..., None])
    vis = torch.ones_like(p, dtype=torch.bool) if mask is None \
        else mask[None].expand_as(p)
    p = torch.where(vis, p, torch.zeros_like(p))
    dp = torch.einsum("nhbqd,nhbkd->nhbqk", dog, vg.to(f32))
    ds = p * (dp - d_g[..., None]) * scale

    def rnd(a, like):
        return a.to(like.dtype).to(f32)
    dq = _scatter_rows(torch.einsum("nhbqk,nhbkd->nhbqd", rnd(ds, k), kg),
                       qb, cq)
    dk = _scatter_rows(torch.einsum("nhbqk,nhbqd->nhbkd", rnd(ds, q), qg),
                       kb, ck)
    dv = _scatter_rows(torch.einsum("nhbqk,nhbqd->nhbkd", rnd(p, do), dog),
                       kb, ck)
    return _merge(dq).to(dq_dtype or q.dtype), _merge(dk), _merge(dv)


_P, _I = ctypes.c_void_p, ctypes.c_int
_FWD_ARGS = [_I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
             _I, _I, ctypes.c_float, _P]
_BWD_ARGS = [_I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
             _P, _P, _I, _I, _I, _I, _I, ctypes.c_float, _P]


def _aligned16(t):
    """t, or a contiguous copy of it where its start or its batch or row
    stride is off 16 bytes: the tensor-core kernels copy 16 bytes a
    thread.  The column slices of a packed qkv go in as they are."""
    es = t.element_size()
    if t.data_ptr() % 16 or any(t.stride(d) * es % 16
                                for d in range(t.dim() - 1)):
        return t.clone(memory_format=torch.contiguous_format)
    return t


def _check(fn, q, k, v, tables, heads, bs, do=None, key_rows=False):
    """Checks shared by the wrappers; ``key_rows``: the CSR runs over key
    block-rows.  Returns (batch, ctx_q, state, hs, lut_heads)."""
    if not q.is_cuda:
        raise ValueError(f"{fn} launches a CUDA kernel: q must be on a CUDA "
                         f"device")
    row_ptr, ent, ent_code, uniq = tables
    acts = (("q", q), ("k", k), ("v", v)) + (() if do is None else
                                              (("do", do),))
    for name, t in acts[1:] + (("row_ptr", row_ptr), ("ent", ent),
                               ("ent_code", ent_code), ("uniq", uniq)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    if q.dtype not in _DTYPE_CODE or any(t.dtype != q.dtype
                                         for _, t in acts):
        raise TypeError(f"{fn} takes f32, bf16 or f16 q/k/v/do of one "
                        f"dtype, got {[t.dtype for _, t in acts]}")
    if q.dim() != 3 or k.dim() != 3 or k.shape != v.shape \
            or k.shape[0] != q.shape[0] or k.shape[2] != q.shape[2] \
            or (do is not None and do.shape != q.shape):
        raise ValueError(f"bad q/k/v/do shapes "
                         f"{[tuple(t.shape) for _, t in acts]}")
    batch, ctx_q, state = q.shape
    if bs not in BLOCK_SIZES:
        raise ValueError(f"the kernels take block sizes {BLOCK_SIZES}, got "
                         f"{bs} (BlocksparseTransformer runs 8 through "
                         f"kernel_view)")
    if state % heads or state // heads not in HEAD_SIZES:
        raise ValueError(f"the kernels take head sizes {HEAD_SIZES}, got "
                         f"{state / heads} (BlocksparseTransformer pads "
                         f"others up to 128 to kernel_head_size)")
    if ctx_q % bs or k.shape[1] % bs:
        raise ValueError("ctx must be a multiple of the block size")
    for name, t in acts:
        if t.stride(2) != 1:
            raise ValueError(f"{name}'s last dim must be contiguous")
    for name, t, dt in (("row_ptr", row_ptr, torch.int32),
                        ("ent", ent, torch.int32),
                        ("ent_code", ent_code, torch.int32),
                        ("uniq", uniq, torch.int8)):
        if t.dtype != dt or not t.is_contiguous():
            raise TypeError(f"{name} must be a contiguous {dt} tensor")
    rows = (k.shape[1] if key_rows else ctx_q) // bs
    if row_ptr.numel() % (rows + 1):
        raise ValueError("row_ptr does not match the block-rows")
    lut_heads = row_ptr.numel() // (rows + 1)
    if lut_heads not in (1, heads):
        raise ValueError(f"{lut_heads} layout heads for {heads} heads")
    return batch, ctx_q, state, state // heads, lut_heads


def _check_order(order, q, lut_heads, rows):
    if order is not None and (
            order.device != q.device or order.dtype != torch.int32
            or not order.is_contiguous()
            or tuple(order.shape) != (lut_heads, rows)):
        raise TypeError(f"order must be a contiguous int32 (lut_heads, "
                        f"{rows}) tensor on {q.device}")


def _fwd(fn, q, k, v, tables, heads, bs, scale, with_lse, order):
    """Checks and launches the forward: bf16 and f16 on
    ``csrc/bst_attn_fwd_mma.cu`` (16-byte aligned views, ``_aligned16``),
    f32 on ``csrc/bst_attn_fwd.cu``; one C signature."""
    batch, ctx_q, state, hs, lut_heads = _check(fn, q, k, v, tables, heads,
                                                bs)
    _check_order(order, q, lut_heads, ctx_q // bs)
    if q.dtype == torch.float32:
        source = "bst_attn_fwd"
    else:
        source = "bst_attn_fwd_mma"
        q, k, v = map(_aligned16, (q, k, v))
    out = torch.empty((batch, ctx_q, state), dtype=q.dtype, device=q.device)
    lse = (torch.empty((batch, heads, ctx_q), dtype=torch.float32,
                       device=q.device) if with_lse else None)
    if batch == 0:
        return out, lse
    row_ptr, ent_k, ent_code, uniq = tables
    strides = (ctypes.c_longlong * 6)(q.stride(0), q.stride(1), k.stride(0),
                                      k.stride(1), v.stride(0), v.stride(1))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _build.function(source, source, _FWD_ARGS)(
            _DTYPE_CODE[q.dtype], bs, hs, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(),
            ctypes.addressof(strides), row_ptr.data_ptr(), ent_k.data_ptr(),
            ent_code.data_ptr(), uniq.data_ptr(),
            None if order is None else order.data_ptr(), batch, heads,
            lut_heads, ctx_q // bs, float(scale), stream)
    if err != 0:
        raise RuntimeError(f"{fn} launch failed: cudaError {err}")
    return out, lse


def attention_fwd(q, k, v, row_ptr, ent_k, ent_code, uniq, heads, bs,
                  scale, order=None):
    """The fused forward on the card (serving: no lse).

    q: (batch, ctx_q, heads*hs), k, v: (batch, ctx_k, heads*hs), f32, bf16
    or f16, one dtype, last dim contiguous (other strides are free).
    row_ptr/ent_k/ent_code: int32 CUDA tensors from ``build_attn_csr``;
    uniq: int8 (n_uniq*bs, bs) CUDA tensor.  order: None (query rows
    launched in CSR order) or the int32 CUDA tensor of
    ``launch_order(row_ptr)``; the order changes no bit.  Returns a
    contiguous (batch, ctx_q, heads*hs).  Raises on anything it does not
    take."""
    out, _ = _fwd("attention_fwd", q, k, v, (row_ptr, ent_k, ent_code, uniq),
                  heads, bs, scale, with_lse=False, order=order)
    attention_fwd.launches += 1
    return out


def attention_fwd_lse(q, k, v, row_ptr, ent_k, ent_code, uniq, heads, bs,
                      scale, order=None):
    """The fused training forward on the card: (out, lse), lse a
    contiguous (batch, heads, ctx_q) f32 (-inf where a row sees no key).
    Takes what ``attention_fwd`` takes."""
    out, lse = _fwd("attention_fwd_lse", q, k, v,
                    (row_ptr, ent_k, ent_code, uniq), heads, bs, scale,
                    with_lse=True, order=order)
    attention_fwd_lse.launches += 1
    return out, lse


def _bwd(fn, which, q, k, v, do, lse, dvec, tables, heads, bs, scale,
         order=None):
    """Checks and launches dq (which 0; which 2 stores it in f32) or
    dk/dv (1): bf16 and f16 on ``csrc/bst_attn_bwd_mma.cu`` (16-byte
    aligned views, ``_aligned16``), f32 on ``csrc/bst_attn_bwd.cu``; one C
    signature."""
    batch, ctx_q, state, hs, lut_heads = _check(
        fn, q, k, v, tables, heads, bs, do=do, key_rows=which == 1)
    for name, t in (("lse", lse), ("dvec", dvec)):
        if t.device != q.device or t.dtype != torch.float32 \
                or not t.is_contiguous() \
                or tuple(t.shape) != (batch, heads, ctx_q):
            raise TypeError(f"{name} must be a contiguous f32 "
                            f"(batch, heads, ctx_q) tensor on {q.device}")
    ctx_k = k.shape[1]
    _check_order(order, q, lut_heads, ctx_k // bs)
    if q.dtype == torch.float32:
        source = "bst_attn_bwd"
    else:
        source = "bst_attn_bwd_mma"
        q, k, v, do, lse, dvec = map(_aligned16, (q, k, v, do, lse, dvec))
    if which != 1:
        outs = (torch.empty((batch, ctx_q, state), dtype=torch.float32
                            if which == 2 else q.dtype, device=q.device),)
    else:
        outs = tuple(torch.empty((batch, ctx_k, state), dtype=torch.float32,
                                 device=q.device) for _ in range(2))
    if batch == 0:
        return outs
    row_ptr, ent, ent_code, uniq = tables
    strides = (ctypes.c_longlong * 8)(q.stride(0), q.stride(1), k.stride(0),
                                      k.stride(1), v.stride(0), v.stride(1),
                                      do.stride(0), do.stride(1))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _build.function(source, source, _BWD_ARGS)(
            _DTYPE_CODE[q.dtype], which, bs, hs, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), do.data_ptr(), lse.data_ptr(), dvec.data_ptr(),
            outs[0].data_ptr(), outs[-1].data_ptr() if which else None,
            ctypes.addressof(strides), row_ptr.data_ptr(), ent.data_ptr(),
            ent_code.data_ptr(), uniq.data_ptr(),
            None if order is None else order.data_ptr(), batch, heads,
            lut_heads, ctx_q // bs, ctx_k // bs, float(scale), stream)
    if err != 0:
        raise RuntimeError(f"{fn} launch failed: cudaError {err}")
    return outs


def attention_dq(q, k, v, do, lse, dvec, row_ptr, ent_k, ent_code, uniq,
                 heads, bs, scale, out_dtype=None):
    """dq on the card, over the forward's nn CSR.  q, k, v, do: as for
    ``attention_fwd`` (do shaped and typed like q); lse, dvec: contiguous
    (batch, heads, ctx_q) f32.  Returns dq, contiguous, in q's dtype, or
    with ``out_dtype=torch.float32`` in f32 (the epilogue stores the f32
    accumulator unrounded: the counterpart of
    ``fused_attention_dq(out_dtype=jnp.float32)``, for ring attention,
    which sums a row's dq over several launches)."""
    if out_dtype not in (None, q.dtype, torch.float32):
        raise TypeError(f"attention_dq stores dq in q's dtype or f32, not "
                        f"{out_dtype}")
    which = 2 if out_dtype == torch.float32 else 0
    dq, = _bwd("attention_dq", which, q, k, v, do, lse, dvec,
               (row_ptr, ent_k, ent_code, uniq), heads, bs, scale)
    attention_dq.launches += 1
    return dq


def attention_dkv(q, k, v, do, lse, dvec, row_ptr_t, ent_q, ent_code_t,
                  uniq_t, heads, bs, scale, order=None):
    """(dk, dv) on the card, in f32, over the key-row (tn) CSR:
    row_ptr_t/ent_q/ent_code_t from ``build_attn_csr`` on the tn list with
    the codes and table of the transposed mask blocks (uniq_t).  order:
    None (key rows launched in CSR order) or the int32 CUDA tensor of
    ``launch_order(row_ptr_t)``; the order changes no sum."""
    dk, dv = _bwd("attention_dkv", 1, q, k, v, do, lse, dvec,
                  (row_ptr_t, ent_q, ent_code_t, uniq_t), heads, bs, scale,
                  order)
    attention_dkv.launches += 1
    return dk, dv


attention_fwd.launches = 0
attention_fwd_lse.launches = 0
attention_dq.launches = 0
attention_dkv.launches = 0
