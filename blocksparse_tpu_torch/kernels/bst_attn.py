"""Fused block-sparse attention, forward and backward: the CUDA kernels
and their plain versions.

``attention_fwd`` replaces the TPU kernel ``fused_attention_fwd``
(``blocksparse_tpu/kernels/bst_attn.py``, body ``_attn_kernel``):
softmax(scale·QKᵀ + mask)·V over each query block-row's key blocks, with
an online softmax so the score tensor never reaches device memory.
``attention_fwd_lse`` (for ``fused_attention_fwd_lse``) also returns the
per-row log-sum-exp in f32, which the backward reads.  bf16 and f16 run
on the tensor cores: at block size 64 ``csrc/bst_attn_fwd_wgmma.cu``
(``wgmma`` fed by TMA, a thread block two query block-rows of one
(batch, head) over the union of their key blocks, ``pair_plan``), at
the other sizes ``csrc/bst_attn_fwd_mma.cu`` (``mma.sync``, one thread
block a block-row); ``attn_kernel`` is the rule.  f32 runs
``csrc/bst_attn_fwd.cu``, exact on the CUDA cores.

``attention_dq`` and ``attention_dkv`` replace ``fused_attention_dq`` and
``fused_attention_dkv``.  dq walks the query-row (nn) CSR of the forward;
dk/dv walk the key-row (tn) CSR whose mask codes are classified on the
transposed mask blocks, and come out in f32.  bf16 and f16 dk/dv run
``csrc/bst_attn_dkv_wgmma.cu`` at bs 64, hs 64 (two key block-rows a
thread block over the union of their query blocks), dq
``csrc/bst_attn_dq_wgmma.cu`` at bs 64 (two query block-rows a thread
block over the union of their key blocks, the forward's pair plan), and
both ``csrc/bst_attn_bwd_mma.cu`` elsewhere (``mma.sync``, P and dS in
registers, a ``cp.async`` ring); ``attn_kernel`` is the rule.  f32 runs
``csrc/bst_attn_bwd.cu``.  dq comes out in q's dtype or, with
``out_dtype=torch.float32``, unrounded in f32 (ring attention sums a
row's dq over several launches).  D = rowsum(dO∘O) is plain torch, as in
``fused_attention_bwd``.  The kernels take tables whose query and key
contexts differ and whose rows may be empty (a sequence-parallel shard's,
``parallel.sequence.shard_tables``): an empty row stores zeros (and lse
-inf forward).

Every wrapper reads its CSR, launch order (``launch_order``: the rows
with the most entries first) and pair plan from the tables
``kernel_tables`` builds, so none launches in CSR order by omission.

All kernels read q/k/v/dO in the public (batch, ctx, heads·hs) layout
through their strides, so the column slices of a packed qkv tensor go in
without a copy (the tensor-core kernels copy 16 bytes a thread or
16-byte rows by TMA: a view whose start or batch or row stride is off 16
bytes goes in as a copy, ``_aligned16``); lse and D are (batch, heads,
ctx_q) f32.  The TPU kernels' q-row pairing, lane folding and
stream-vs-resident choice are TPU mechanics and are not carried over.

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
    NumPy arrays: the block size ``kbs``; the query-row (nn) CSR with its
    mask codes and table, the launch order of its rows and the pair plan
    of the wgmma forward (``row_ptr``, ``ent_k``, ``ent_code``, ``uniq``,
    ``order``, ``pair_rows``, ``pair_ptr``, ``pair_ent``: ``pair_plan``);
    the key-row (tn) CSR with the transposed codes, its order and the
    wgmma dk/dv's pair plan (the same names ending in ``_t``); and the
    plain versions' (lut_heads, blocks) block indices ``q_blk``, ``k_blk``
    and ``mask`` (None without masks).  The wrappers read the order and
    the plan from these tables, so no launch can leave them out.
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
    order = launch_order(row_ptr, ctx_blks_q)
    order_t = launch_order(row_ptr_t, ctx_blks_k)
    tab = {"kbs": bs, "row_ptr": row_ptr, "ent_k": ent_k,
           "ent_code": ent_code, "uniq": uniq, "order": order,
           "row_ptr_t": row_ptr_t, "ent_q": ent_q, "ent_code_t": ent_code_t,
           "uniq_t": uniq_t, "order_t": order_t,
           "q_blk": q_blk, "k_blk": k_blk, "mask": mask}
    for sfx, rp, ent, code, od in (("", row_ptr, ent_k, ent_code, order),
                                   ("_t", row_ptr_t, ent_q, ent_code_t,
                                    order_t)):
        plan = pair_plan(rp, ent, code, od)
        tab.update({name + sfx: a for name, a in plan.items()})
    return tab


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


def _merge_rows(a, b):
    """The union of two block-rows' entries, each a list of (block, code)
    in accumulation order: a list of (block, mask, code_a, code_b), mask
    bit 0 where row a holds the block (code_a its code, else 0) and bit 1
    where row b does.  Both rows' orders are kept; a block both rows hold
    is listed once where their orders allow it (always where both rows
    ascend, as every layout's rows do: the union is then their sorted
    merge), else once for each row."""
    pos_a = {blk: i for i, (blk, _) in enumerate(a)}
    pos_b = {blk: i for i, (blk, _) in enumerate(b)}
    i = j = 0
    out = []
    while i < len(a) or j < len(b):
        if i < len(a) and j < len(b) and a[i][0] == b[j][0]:
            out.append((a[i][0], 3, a[i][1], b[j][1]))
            i, j = i + 1, j + 1
            continue
        if i >= len(a) or j >= len(b):
            take_a = i < len(a)
        else:
            a_later = pos_b.get(a[i][0], -1) > j   # b holds a's block later
            b_later = pos_a.get(b[j][0], -1) > i
            if a_later == b_later:
                # neither shared, or the orders cross (a's block goes alone)
                take_a = a_later or a[i][0] <= b[j][0]
            else:
                take_a = b_later
        if take_a:
            out.append((a[i][0], 1, a[i][1], 0))
            i += 1
        else:
            out.append((b[j][0], 2, 0, b[j][1]))
            j += 1
    return out


def pair_plan(row_ptr, ent, ent_code, order):
    """The wgmma kernels' work plan over a CSR (``build_attn_csr``) whose
    rows launch in ``order`` (``launch_order``: by entry count, most
    first, ties in row order).  A thread block takes two block-rows of
    one (batch, head), one consumer warpgroup each, and walks the union
    of their blocks, so a block both rows hold is loaded once.  Rows are
    paired in their launch order: consecutive rows of ``order`` (so
    adjacent rows wherever their counts tie, as every query-row pair of
    the LM's layout does; its summary key columns, 12-32 entries, pair
    among themselves rather than with their 8-entry neighbours); an odd
    last row pairs with none (-1).  Pairs run longest union first
    (stable).  Returns int32 arrays:

    - ``pair_rows`` (lut_heads, P, 2): the two rows of each pair, by
      rank (P = ceil(rows / 2));
    - ``pair_ptr`` (lut_heads · (P + 1),): each pair's union entries, as
      absolute offsets into ``pair_ent``;
    - ``pair_ent`` (n, 4): each union entry's (block, mask, code_a,
      code_b), ``_merge_rows``'s, each row's entries in its CSR order."""
    order = np.asarray(order)
    lut_heads, rows = order.shape
    rp = np.asarray(row_ptr).reshape(lut_heads, rows + 1)
    ent, ent_code = np.asarray(ent), np.asarray(ent_code)
    n_pairs = (rows + 1) // 2
    pair_rows = np.full((lut_heads, n_pairs, 2), -1, np.int32)
    pair_ptr, pair_ent = [], []
    for h in range(lut_heads):
        def row(r):
            if r < 0:
                return []
            return list(zip(ent[rp[h, r]:rp[h, r + 1]].tolist(),
                            ent_code[rp[h, r]:rp[h, r + 1]].tolist()))
        pairs = []
        for p in range(n_pairs):
            a = int(order[h, 2 * p])
            b = int(order[h, 2 * p + 1]) if 2 * p + 1 < rows else -1
            pairs.append(((a, b), _merge_rows(row(a), row(b))))
        pairs.sort(key=lambda pr: -len(pr[1]))       # stable
        for p, (ab, union) in enumerate(pairs):
            pair_rows[h, p] = ab
            pair_ptr.append(len(pair_ent))
            pair_ent.extend(union)
        pair_ptr.append(len(pair_ent))
    return {"pair_rows": pair_rows,
            "pair_ptr": np.asarray(pair_ptr, np.int32),
            "pair_ent": np.asarray(pair_ent, np.int32).reshape(-1, 4)}


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


# The wgmma kernels (``csrc/bst_attn_fwd_wgmma.cu``,
# ``csrc/bst_attn_dq_wgmma.cu``, ``csrc/bst_attn_dkv_wgmma.cu``) take block
# size 64 and these head sizes; every other bf16/f16 size stays on the
# mma.sync kernels.  dk/dv at hs 128 would hold four 64 x 128 f32
# accumulators in two consumer warpgroups and stays on
# ``bst_attn_bwd_mma.cu``.  The forward also stays on mma.sync under
# FWD_WGMMA_MIN_KEY_BLOCKS key block-rows: its rows then hold a few
# entries, and a thread block's start and end outweigh the loads the pair
# shares (the H100 runs in PERF.md: at an sp-4 ring pair, 8 key blocks,
# the mma.sync forward took 0.0185 ms against 0.0194; with 32, 0.110
# against 0.102).  dq has no such clause: at that ring pair its wgmma
# kernel took 0.0155 ms against 0.0254-0.0259 on mma.sync, and at hs 128
# (64 dq accumulators a consumer thread beside S and dP, no spill) 0.080
# against 0.153.
WGMMA_BLOCK_SIZE = 64
FWD_WGMMA_HEAD_SIZES = (64, 128)
DQ_WGMMA_HEAD_SIZES = (64, 128)
DKV_WGMMA_HEAD_SIZES = (64,)
FWD_WGMMA_MIN_KEY_BLOCKS = 16


def attn_kernel(kind, dtype, bs, hs, key_blocks):
    """The source a launch runs: ``kind`` "fwd" (serving and lse), "dq"
    or "dkv" at block size ``bs``, kernel head size ``hs`` and
    ``key_blocks`` key block-rows (ctx_k / bs) in ``dtype``.  f32:
    ``bst_attn_fwd`` / ``bst_attn_bwd`` (CUDA cores).  bf16 and f16 at bs
    64: ``bst_attn_fwd_wgmma`` at FWD_WGMMA_HEAD_SIZES and at least
    FWD_WGMMA_MIN_KEY_BLOCKS key block-rows, ``bst_attn_dq_wgmma`` at
    DQ_WGMMA_HEAD_SIZES, ``bst_attn_dkv_wgmma`` at DKV_WGMMA_HEAD_SIZES;
    else
    ``bst_attn_fwd_mma`` / ``bst_attn_bwd_mma``.  Shapes only."""
    if kind not in ("fwd", "dq", "dkv"):
        raise ValueError(f"kind is fwd, dq or dkv, not {kind!r}")
    fwd = kind == "fwd"
    if dtype == torch.float32:
        return "bst_attn_fwd" if fwd else "bst_attn_bwd"
    sizes, least = {"fwd": (FWD_WGMMA_HEAD_SIZES, FWD_WGMMA_MIN_KEY_BLOCKS),
                    "dq": (DQ_WGMMA_HEAD_SIZES, 0),
                    "dkv": (DKV_WGMMA_HEAD_SIZES, 0)}[kind]
    if bs == WGMMA_BLOCK_SIZE and hs in sizes and key_blocks >= least:
        return f"bst_attn_{kind}_wgmma"
    return "bst_attn_fwd_mma" if fwd else "bst_attn_bwd_mma"


_P, _I = ctypes.c_void_p, ctypes.c_int
_FWD_ARGS = [_I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
             _I, _I, ctypes.c_float, _P]
_BWD_ARGS = [_I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
             _P, _P, _I, _I, _I, _I, _I, ctypes.c_float, _P]
# the wgmma sources: dtype, hs, q, k, v, (fwd: out, lse | dkv: do, lse,
# dvec, dk, dv), strides, pair_rows, pair_ptr, pair_ent, uniq, batch,
# heads, lut_heads, ctx_blks_q, ctx_blks_k, scale, stream
_FWD_WG_ARGS = [_I, _I] + [_P] * 10 + [_I] * 5 + [ctypes.c_float, _P]
_DKV_WG_ARGS = [_I, _I] + [_P] * 13 + [_I] * 5 + [ctypes.c_float, _P]
# dq's: dtype, which, hs, q, k, v, do, lse, dvec, dq, strides, pair_rows,
# pair_ptr, pair_ent, uniq, the same five ints, scale, stream
_DQ_WG_ARGS = [_I, _I, _I] + [_P] * 12 + [_I] * 5 + [ctypes.c_float, _P]
# the tables each kernel reads (``kernel_tables``' names; dk/dv's end in _t)
_TABLES = ("row_ptr", "ent_k", "ent_code", "uniq", "order", "pair_rows",
           "pair_ptr", "pair_ent")
_TABLES_T = ("row_ptr_t", "ent_q", "ent_code_t", "uniq_t", "order_t",
             "pair_rows_t", "pair_ptr_t", "pair_ent_t")


def _aligned16(t):
    """t, or a contiguous copy of it where its start or its batch or row
    stride is off 16 bytes: the tensor-core kernels copy 16 bytes a
    thread, TMA 16-byte rows.  The column slices of a packed qkv go in as
    they are."""
    es = t.element_size()
    if t.data_ptr() % 16 or any(t.stride(d) * es % 16
                                for d in range(t.dim() - 1)):
        return t.clone(memory_format=torch.contiguous_format)
    return t


def _check(fn, q, k, v, tab, names, heads, do=None, key_rows=False):
    """Checks shared by the wrappers; ``names``: the tables the kernel
    reads (``_TABLES`` or ``_TABLES_T``), ``key_rows``: they run over key
    block-rows.  Returns (batch, ctx_q, state, hs, lut_heads, bs, tables
    by name)."""
    if not q.is_cuda:
        raise ValueError(f"{fn} launches a CUDA kernel: q must be on a CUDA "
                         f"device")
    missing = [n for n in names + ("kbs",) if n not in tab]
    if missing:
        raise KeyError(f"{fn}: the tables lack {missing} (kernel_tables "
                       f"makes them)")
    bs, tables = tab["kbs"], {n: tab[n] for n in names}
    acts = (("q", q), ("k", k), ("v", v)) + (() if do is None else
                                              (("do", do),))
    for name, t in acts[1:] + tuple(tables.items()):
        if not isinstance(t, torch.Tensor) or t.device != q.device:
            raise ValueError(f"{name} must be a tensor on {q.device}")
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
    for name, t in tables.items():
        dt = torch.int8 if name.startswith("uniq") else torch.int32
        if t.dtype != dt or not t.is_contiguous():
            raise TypeError(f"{name} must be a contiguous {dt} tensor")
        if name.startswith("pair_ent") and t.data_ptr() % 16:
            raise ValueError(f"{name} must start on 16 bytes (the wgmma "
                             f"kernels read an entry as one int4)")
    rows = (k.shape[1] if key_rows else ctx_q) // bs
    row_ptr, order, pair_rows = (tables[names[i]] for i in (0, 4, 5))
    if row_ptr.numel() % (rows + 1):
        raise ValueError("row_ptr does not match the block-rows")
    lut_heads = row_ptr.numel() // (rows + 1)
    if lut_heads not in (1, heads):
        raise ValueError(f"{lut_heads} layout heads for {heads} heads")
    if tuple(order.shape) != (lut_heads, rows) or tuple(pair_rows.shape) != (
            lut_heads, (rows + 1) // 2, 2):
        raise ValueError(f"the launch order and pair plan do not match "
                         f"{lut_heads} layout heads of {rows} block-rows")
    return batch, ctx_q, state, state // heads, lut_heads, bs, tables


def _launch(fn, source, args, argtypes, q):
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _build.function(source, source, argtypes)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{fn} launch failed on {source}.cu: cudaError "
                           f"{err}")


def _fwd(fn, q, k, v, tab, heads, scale, with_lse):
    """Checks and launches the forward on ``attn_kernel``'s source:
    bf16 and f16 on ``csrc/bst_attn_fwd_wgmma.cu`` (over the pair plan)
    or ``csrc/bst_attn_fwd_mma.cu`` (query rows in the launch order),
    16-byte aligned views (``_aligned16``); f32 on ``csrc/bst_attn_fwd.cu``
    (one C signature with the mma.sync source).  Returns (out, lse or
    None, source)."""
    batch, ctx_q, state, hs, lut_heads, bs, t = _check(fn, q, k, v, tab,
                                                       _TABLES, heads)
    source = attn_kernel("fwd", q.dtype, bs, hs, k.shape[1] // bs)
    if q.dtype != torch.float32:
        q, k, v = map(_aligned16, (q, k, v))
    out = torch.empty((batch, ctx_q, state), dtype=q.dtype, device=q.device)
    lse = (torch.empty((batch, heads, ctx_q), dtype=torch.float32,
                       device=q.device) if with_lse else None)
    if batch == 0:
        return out, lse, source
    strides = (ctypes.c_longlong * 6)(q.stride(0), q.stride(1), k.stride(0),
                                      k.stride(1), v.stride(0), v.stride(1))
    lse_ptr = None if lse is None else lse.data_ptr()
    if source == "bst_attn_fwd_wgmma":
        args = (_DTYPE_CODE[q.dtype], hs, q.data_ptr(), k.data_ptr(),
                v.data_ptr(), out.data_ptr(), lse_ptr,
                ctypes.addressof(strides), t["pair_rows"].data_ptr(),
                t["pair_ptr"].data_ptr(), t["pair_ent"].data_ptr(),
                t["uniq"].data_ptr(), batch, heads, lut_heads, ctx_q // bs,
                k.shape[1] // bs, float(scale))
        _launch(fn, source, args, _FWD_WG_ARGS, q)
    else:
        args = (_DTYPE_CODE[q.dtype], bs, hs, q.data_ptr(), k.data_ptr(),
                v.data_ptr(), out.data_ptr(), lse_ptr,
                ctypes.addressof(strides), t["row_ptr"].data_ptr(),
                t["ent_k"].data_ptr(), t["ent_code"].data_ptr(),
                t["uniq"].data_ptr(), t["order"].data_ptr(), batch, heads,
                lut_heads, ctx_q // bs, float(scale))
        _launch(fn, source, args, _FWD_ARGS, q)
    return out, lse, source


def attention_fwd(q, k, v, tab, heads, scale):
    """The fused forward on the card (serving: no lse).

    q: (batch, ctx_q, heads*hs), k, v: (batch, ctx_k, heads*hs), f32, bf16
    or f16, one dtype, last dim contiguous (other strides are free).
    tab: the layout's tables on q's device (``kernel_tables`` as tensors:
    ``ops.transformer.fused_tables``, ``BlocksparseTransformer._tables``),
    whose block size ``kbs``, query-row CSR, launch order and pair plan
    the kernel reads; neither the order nor the plan changes a bit.
    Returns a contiguous (batch, ctx_q, heads*hs).  Counts every launch
    in ``launches``, those on ``bst_attn_fwd_wgmma.cu`` also in
    ``launches_wgmma``.  Raises on anything it does not take."""
    out, _, source = _fwd("attention_fwd", q, k, v, tab, heads, scale,
                          with_lse=False)
    attention_fwd.launches += 1
    attention_fwd.launches_wgmma += source.endswith("wgmma")
    return out


def attention_fwd_lse(q, k, v, tab, heads, scale):
    """The fused training forward on the card: (out, lse), lse a
    contiguous (batch, heads, ctx_q) f32 (-inf where a row sees no key).
    Takes what ``attention_fwd`` takes, counts the same way."""
    out, lse, source = _fwd("attention_fwd_lse", q, k, v, tab, heads,
                            scale, with_lse=True)
    attention_fwd_lse.launches += 1
    attention_fwd_lse.launches_wgmma += source.endswith("wgmma")
    return out, lse


def _bwd(fn, which, q, k, v, do, lse, dvec, tab, heads, scale):
    """Checks and launches dq (which 0; which 2 stores it in f32) or
    dk/dv (1) on ``attn_kernel``'s source: bf16 and f16 dq on
    ``csrc/bst_attn_dq_wgmma.cu`` (over the forward's query-row pair
    plan), dk/dv on ``csrc/bst_attn_dkv_wgmma.cu`` (over the key-row pair
    plan), or either on ``csrc/bst_attn_bwd_mma.cu`` (rows in CSR order
    or, dk/dv's, their launch order), 16-byte aligned views
    (``_aligned16``); f32 on ``csrc/bst_attn_bwd.cu`` (one C signature
    with the mma.sync source).  Returns (outputs, source)."""
    batch, ctx_q, state, hs, lut_heads, bs, t = _check(
        fn, q, k, v, tab, _TABLES_T if which == 1 else _TABLES, heads,
        do=do, key_rows=which == 1)
    for name, a in (("lse", lse), ("dvec", dvec)):
        if a.device != q.device or a.dtype != torch.float32 \
                or not a.is_contiguous() \
                or tuple(a.shape) != (batch, heads, ctx_q):
            raise TypeError(f"{name} must be a contiguous f32 "
                            f"(batch, heads, ctx_q) tensor on {q.device}")
    ctx_k = k.shape[1]
    source = attn_kernel("dkv" if which == 1 else "dq", q.dtype, bs, hs,
                         k.shape[1] // bs)
    if q.dtype != torch.float32:
        q, k, v, do, lse, dvec = map(_aligned16, (q, k, v, do, lse, dvec))
    if which != 1:
        outs = (torch.empty((batch, ctx_q, state), dtype=torch.float32
                            if which == 2 else q.dtype, device=q.device),)
    else:
        outs = tuple(torch.empty((batch, ctx_k, state), dtype=torch.float32,
                                 device=q.device) for _ in range(2))
    if batch == 0:
        return outs, source
    strides = (ctypes.c_longlong * 8)(q.stride(0), q.stride(1), k.stride(0),
                                      k.stride(1), v.stride(0), v.stride(1),
                                      do.stride(0), do.stride(1))
    names = _TABLES_T if which == 1 else _TABLES
    if source == "bst_attn_dkv_wgmma":
        args = (_DTYPE_CODE[q.dtype], hs, q.data_ptr(), k.data_ptr(),
                v.data_ptr(), do.data_ptr(), lse.data_ptr(), dvec.data_ptr(),
                outs[0].data_ptr(), outs[1].data_ptr(),
                ctypes.addressof(strides), t["pair_rows_t"].data_ptr(),
                t["pair_ptr_t"].data_ptr(), t["pair_ent_t"].data_ptr(),
                t["uniq_t"].data_ptr(), batch, heads, lut_heads, ctx_q // bs,
                ctx_k // bs, float(scale))
        _launch(fn, source, args, _DKV_WG_ARGS, q)
    elif source == "bst_attn_dq_wgmma":
        args = (_DTYPE_CODE[q.dtype], which, hs, q.data_ptr(), k.data_ptr(),
                v.data_ptr(), do.data_ptr(), lse.data_ptr(), dvec.data_ptr(),
                outs[0].data_ptr(), ctypes.addressof(strides),
                t["pair_rows"].data_ptr(), t["pair_ptr"].data_ptr(),
                t["pair_ent"].data_ptr(), t["uniq"].data_ptr(), batch, heads,
                lut_heads, ctx_q // bs, ctx_k // bs, float(scale))
        _launch(fn, source, args, _DQ_WG_ARGS, q)
    else:
        row_ptr, ent, ent_code, uniq, order = (t[n] for n in names[:5])
        args = (_DTYPE_CODE[q.dtype], which, bs, hs, q.data_ptr(),
                k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                dvec.data_ptr(), outs[0].data_ptr(),
                outs[-1].data_ptr() if which else None,
                ctypes.addressof(strides), row_ptr.data_ptr(),
                ent.data_ptr(), ent_code.data_ptr(), uniq.data_ptr(),
                order.data_ptr() if which == 1 else None, batch, heads,
                lut_heads, ctx_q // bs, ctx_k // bs, float(scale))
        _launch(fn, source, args, _BWD_ARGS, q)
    return outs, source


def attention_dq(q, k, v, do, lse, dvec, tab, heads, scale, out_dtype=None):
    """dq on the card, over the forward's nn CSR of ``tab`` (as for
    ``attention_fwd``).  q, k, v, do: as for ``attention_fwd`` (do shaped
    and typed like q); lse, dvec: contiguous (batch, heads, ctx_q) f32.
    Returns dq, contiguous, in q's dtype, or with
    ``out_dtype=torch.float32`` in f32 (the epilogue stores the f32
    accumulator unrounded: the counterpart of
    ``fused_attention_dq(out_dtype=jnp.float32)``, for ring attention,
    which sums a row's dq over several launches).  Neither the launch
    order nor the pair plan changes a bit.  Counts every launch in
    ``launches``, those on ``bst_attn_dq_wgmma.cu`` also in
    ``launches_wgmma``."""
    if out_dtype not in (None, q.dtype, torch.float32):
        raise TypeError(f"attention_dq stores dq in q's dtype or f32, not "
                        f"{out_dtype}")
    which = 2 if out_dtype == torch.float32 else 0
    (dq,), source = _bwd("attention_dq", which, q, k, v, do, lse, dvec, tab,
                         heads, scale)
    attention_dq.launches += 1
    attention_dq.launches_wgmma += source.endswith("wgmma")
    return dq


def attention_dkv(q, k, v, do, lse, dvec, tab, heads, scale):
    """(dk, dv) on the card, in f32, over the key-row (tn) CSR of ``tab``
    (the transposed mask blocks' codes, ``uniq_t``), its launch order and
    pair plan; neither changes a sum.  Counts every launch in
    ``launches``, those on ``bst_attn_dkv_wgmma.cu`` also in
    ``launches_wgmma``."""
    (dk, dv), source = _bwd("attention_dkv", 1, q, k, v, do, lse, dvec, tab,
                            heads, scale)
    attention_dkv.launches += 1
    attention_dkv.launches_wgmma += source.endswith("wgmma")
    return dk, dv


def wgmma_kernel_info(kind, dtype, hs=64, out_dtype=None):
    """Registers, local (spilled) bytes, dynamic shared memory, resident
    thread blocks an SM and ring slots of the wgmma kernel of ``kind``
    ("fwd" at hs 64 or 128; "dq" at hs 64 or 128, dq stored in
    ``out_dtype``, ``dtype`` or f32; "dkv" at hs 64) in bf16 or f16, as
    the runtime reports them for the built library (on the card only)."""
    info = (ctypes.c_int * 5)()
    code = _DTYPE_CODE[dtype]
    if kind == "fwd":
        err = _build.function("bst_attn_fwd_wgmma", "bst_attn_fwd_wgmma_info",
                              [_I, _I, _P])(code, hs, info)
    elif kind == "dq":
        which = 2 if out_dtype == torch.float32 else 0
        err = _build.function("bst_attn_dq_wgmma", "bst_attn_dq_wgmma_info",
                              [_I, _I, _I, _P])(code, which, hs, info)
    else:
        err = _build.function("bst_attn_dkv_wgmma", "bst_attn_dkv_wgmma_info",
                              [_I, _P])(code, info)
    if err != 0:
        raise RuntimeError(f"wgmma_kernel_info({kind}, {dtype}, {hs}): "
                           f"cudaError {err}")
    return dict(zip(("registers", "local_bytes", "smem_bytes",
                     "blocks_per_sm", "stages"), info))


attention_fwd.launches = 0
attention_fwd_lse.launches = 0
attention_dq.launches = 0
attention_dkv.launches = 0
attention_fwd.launches_wgmma = 0
attention_fwd_lse.launches_wgmma = 0
attention_dq.launches_wgmma = 0
attention_dkv.launches_wgmma = 0
