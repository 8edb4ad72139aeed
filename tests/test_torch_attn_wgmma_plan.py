"""The wgmma attention kernels' host side, on the CPU: the pair plan that
``kernel_tables`` builds for ``csrc/bst_attn_fwd_wgmma.cu`` (over the
query-row CSR) and ``csrc/bst_attn_dq_wgmma.cu`` (the forward's plan) and
``csrc/bst_attn_dkv_wgmma.cu`` (over the key-row CSR), the route rule
``attn_kernel``, and the three kernels' work decomposition.

The kernels run only on the card (``test_torch_cuda.py`` holds them
against the plain versions there).  Here the plan's invariants are
checked on the LM's fixed layout, strided, dense-causal and random
layouts, the bs-8 view, a sequence shard's tables (query and key
contexts differ, empty rows) and per-head layouts: every (row, entry)
appears once, under its row's mask bit and code; each row's entries keep
their CSR order; a union holds each block once; pairs run longest first.
The route rule is pinned by value at the path's shapes.  Then the
kernels' work is replayed in torch item by item and union entry by union
entry (the forward's running max moved once an entry, P rounded to the
input type before P·v; dq's dS and dk/dv's P and dS rounded before their
products, dq rounded once or kept in f32; an entry not the row's block
runs as one with every key hidden) and held against the plain versions
and, at bs 64, against the JAX package's ``fused_attention_fwd_lse``,
``fused_attention_dq`` and ``fused_attention_dkv`` (imported inside
that test, run on the CPU as ``test_torch_attn_fwd.py`` runs them).

Tolerances: f32 1e-5 of max(1, max|ref|) (the same f32 softmax, summed
in other orders); bf16 2e-2, as on the card (P and dS are rounded to bf16
against another running max on each side); lse 1e-4 absolute (f32, from
the unrounded p on every side).  A fully masked query row (F1) gives zeros
and lse -inf; the JAX kernel gives such a row a schedule-dependent value,
so the comparison with JAX leaves it out.
"""
import numpy as np
import pytest
import torch

from blocksparse_tpu_torch import BlocksparseTransformer
from blocksparse_tpu_torch.kernels import bst_attn
from blocksparse_tpu_torch.models.sparse_transformer import (
    causal_subblock_mask, fixed_layout, strided_layout)
from blocksparse_tpu_torch.parallel import sequence as seq

torch.set_num_threads(2)
LOG2E, LN2 = 1.4426950408889634, 0.6931471805599453
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
LSE_TOL = 1e-4
PLANS = (("", "row_ptr", "ent_k", "ent_code", "order"),
         ("_t", "row_ptr_t", "ent_q", "ent_code_t", "order_t"))


def _f1_mask(blk_shape, head, qry, key, blk):
    """Causal diagonal, except that query row 3 of block-row 1 sees no key
    at all."""
    mask = causal_subblock_mask(blk_shape, head, qry, key, blk)
    if qry == 1:
        mask[3, :] = False
    return mask


def _random_layout(blks, seed, heads=1):
    rng = np.random.RandomState(seed)
    lay = (rng.rand(heads, blks, blks) < 0.35).astype(np.int32)
    lay[:, np.arange(blks), np.arange(blks)] = 1
    return lay[0] if heads == 1 else lay


def _np_tables(tab):
    return {k: (v.numpy() if isinstance(v, torch.Tensor) else v)
            for k, v in tab.items()}


def _cases():
    """(name, numpy tables, query block-rows, key block-rows)."""
    out = []
    for name, lay, bs, cb in (
            ("lm_fixed", fixed_layout(32, local_blocks=8), 64,
             causal_subblock_mask),
            ("fixed_odd", fixed_layout(7, local_blocks=3), 16, None),
            ("strided", strided_layout(9, local_blocks=2), 32, None),
            ("dense_causal", np.tril(np.ones((6, 6), np.int32)), 64,
             causal_subblock_mask),
            ("random", _random_layout(8, 3), 64, None),
            ("bs8_view", fixed_layout(9, local_blocks=3), 8,
             causal_subblock_mask)):
        op = BlocksparseTransformer(lay, block_size=bs, heads=2,
                                    mask_callback=cb)
        tab = _np_tables(op._tables("cpu"))
        rows = tab["kctx_q"] // tab["kbs"]
        out.append((name, tab, rows, tab["kctx_k"] // tab["kbs"]))
    op = BlocksparseTransformer(fixed_layout(8, local_blocks=2), block_size=64,
                                heads=2, mask_callback=causal_subblock_mask)
    for r in range(4):
        tab = _np_tables(seq.shard_tables(op, 4, r))
        out.append((f"gather_shard{r}", tab, 2, 8))
    tab = _np_tables(seq.shard_tables(op, 4, 2, 1))
    out.append(("ring_pair_2_1", tab, 2, 2))
    # per-head layouts whose block counts differ
    lay = _random_layout(7, 5, heads=2)
    nt = [list(zip(*np.nonzero(lay[h]))) for h in range(2)]
    out.append(("per_head", bst_attn.kernel_tables(nt, None, 64, 7, 7), 7, 7))
    return out


CASES = _cases()


def _check_plan(tab, sfx, rp_name, ent_name, code_name, order_name, rows):
    rp = tab[rp_name].reshape(-1, rows + 1)
    ent, code = tab[ent_name], tab[code_name]
    pr, pp, pe = (tab[n + sfx] for n in ("pair_rows", "pair_ptr", "pair_ent"))
    lut_heads, n_pairs = rp.shape[0], (rows + 1) // 2
    assert pr.shape == (lut_heads, n_pairs, 2) and pr.dtype == np.int32
    assert pp.shape == (lut_heads * (n_pairs + 1),) and pe.shape[1:] == (4,)
    assert pp[0] == 0 and pp[-1] == len(pe) and (np.diff(pp) >= 0).all()
    for h in range(lut_heads):
        ptr = pp[h * (n_pairs + 1):(h + 1) * (n_pairs + 1)]
        if h:
            assert ptr[0] == pp[h * (n_pairs + 1) - 1]
        # the pairs: every row once, in launch order; -1 only as an odd
        # last row's partner
        seen = pr[h].ravel()
        assert sorted(seen[seen >= 0].tolist()) == list(range(rows))
        assert (seen < 0).sum() == rows % 2
        if rows % 2:
            assert sorted(pr[h, :, 1].tolist())[0] == -1
        # longest union first
        lengths = np.diff(ptr)
        assert (np.diff(lengths) <= 0).all()
        for p in range(n_pairs):
            union = pe[ptr[p]:ptr[p + 1]]
            assert (union[:, 1] != 0).all() and (union[:, 1] < 4).all()
            assert len(set(union[:, 0].tolist())) == len(union)
            for w in range(2):
                r = pr[h, p, w]
                mine = (union[:, 1] >> w & 1).astype(bool)
                assert (union[~mine, 2 + w] == 0).all()
                if r < 0:
                    assert not mine.any()
                    continue
                want = list(zip(ent[rp[h, r]:rp[h, r + 1]].tolist(),
                                code[rp[h, r]:rp[h, r + 1]].tolist()))
                got = list(zip(union[mine, 0].tolist(),
                               union[mine, 2 + w].tolist()))
                assert got == want
    return pe


@pytest.mark.parametrize("name,tab,rows_q,rows_k", CASES,
                         ids=[c[0] for c in CASES])
def test_pair_plan_invariants(name, tab, rows_q, rows_k):
    for (sfx, rp, ent, code, order), rows in zip(PLANS, (rows_q, rows_k)):
        _check_plan(tab, sfx, rp, ent, code, order, rows)


def test_pair_plan_on_the_lm_layout():
    """The LM's layout (fixed, 32 block-rows, 8 local blocks, bs 64):
    the forward's pairs are adjacent query rows, 170 union loads for 312
    entries; dk/dv pairs the summary key columns among themselves, 176
    union loads for 312."""
    tab = _np_tables(BlocksparseTransformer(
        fixed_layout(32, local_blocks=8), block_size=64, heads=8,
        mask_callback=causal_subblock_mask)._tables("cpu"))
    assert len(tab["pair_ent"]) == 170 and len(tab["pair_ent_t"]) == 176
    assert tab["pair_rows"][0, :4].tolist() == [[28, 29], [30, 31], [24, 25],
                                                [26, 27]]
    assert all(abs(a - b) == 1 for a, b in tab["pair_rows"][0].tolist())
    assert tab["pair_rows_t"][0, :3].tolist() == [[0, 4], [8, 12], [16, 20]]
    assert np.diff(tab["pair_ptr"]).tolist() == [15, 15, 14, 14, 13, 13, 12,
                                                 12, 11, 11, 10, 10, 8, 6, 4,
                                                 2]
    assert np.diff(tab["pair_ptr_t"])[:3].tolist() == [32, 24, 16]


def test_merge_keeps_both_orders_when_they_cross():
    """Rows whose orders cross keep both orders; the crossing block is
    listed once for each row."""
    union = bst_attn._merge_rows([(5, 1), (3, 1)], [(3, 2), (5, 2)])
    assert union == [(5, 1, 1, 0), (3, 3, 1, 2), (5, 2, 0, 2)]
    union = bst_attn._merge_rows([(1, 1), (3, 1), (5, 1)],
                                 [(2, 2), (3, 2), (6, 2)])
    assert union == [(1, 1, 1, 0), (2, 2, 0, 2), (3, 3, 1, 2), (5, 1, 1, 0),
                     (6, 2, 0, 2)]


ROUTES = [  # (dtype, bs, hs, key block-rows, kind, source)
    # the LM (8 x 2048, 8 heads of 64; 8 heads of 48 pad to 64) and its
    # pipeline microbatch (2 x 2048): 32 key block-rows
    (torch.bfloat16, 64, 64, 32, "fwd", "bst_attn_fwd_wgmma"),
    (torch.bfloat16, 64, 64, 32, "dkv", "bst_attn_dkv_wgmma"),
    (torch.bfloat16, 64, 64, 32, "dq", "bst_attn_dq_wgmma"),
    (torch.float16, 64, 64, 32, "fwd", "bst_attn_fwd_wgmma"),
    (torch.float16, 64, 64, 32, "dkv", "bst_attn_dkv_wgmma"),
    # sp-4 gather shards: keys whole; ring pairs at sp 4 (8 key blocks)
    # and sp 2 (16)
    (torch.bfloat16, 64, 64, 8, "fwd", "bst_attn_fwd_mma"),
    (torch.bfloat16, 64, 64, 8, "dkv", "bst_attn_dkv_wgmma"),
    (torch.bfloat16, 64, 64, 16, "fwd", "bst_attn_fwd_wgmma"),
    # hs 128
    (torch.bfloat16, 64, 128, 32, "fwd", "bst_attn_fwd_wgmma"),
    (torch.bfloat16, 64, 128, 32, "dkv", "bst_attn_bwd_mma"),
    # hs 16 and 32, bs 32 and 16 (the bs-8 view runs at 16)
    (torch.bfloat16, 64, 32, 32, "fwd", "bst_attn_fwd_mma"),
    (torch.bfloat16, 64, 16, 32, "dkv", "bst_attn_bwd_mma"),
    (torch.bfloat16, 32, 64, 64, "fwd", "bst_attn_fwd_mma"),
    (torch.bfloat16, 32, 64, 64, "dkv", "bst_attn_bwd_mma"),
    (torch.bfloat16, 16, 64, 128, "fwd", "bst_attn_fwd_mma"),
    (torch.bfloat16, 16, 64, 128, "dkv", "bst_attn_bwd_mma"),
    # f32 on the CUDA cores
    (torch.float32, 64, 64, 32, "fwd", "bst_attn_fwd"),
    (torch.float32, 64, 64, 32, "dkv", "bst_attn_bwd"),
    # dq: f16 at the LM's shape; an sp-4 ring pair (8 key blocks) and an
    # sp-2 one (16); hs 128; hs 32, bs 32 and 16 on mma.sync; f32
    (torch.float16, 64, 64, 32, "dq", "bst_attn_dq_wgmma"),
    (torch.bfloat16, 64, 64, 8, "dq", "bst_attn_dq_wgmma"),
    (torch.bfloat16, 64, 64, 16, "dq", "bst_attn_dq_wgmma"),
    (torch.bfloat16, 64, 128, 32, "dq", "bst_attn_dq_wgmma"),
    (torch.bfloat16, 64, 32, 32, "dq", "bst_attn_bwd_mma"),
    (torch.bfloat16, 32, 64, 64, "dq", "bst_attn_bwd_mma"),
    (torch.bfloat16, 16, 64, 128, "dq", "bst_attn_bwd_mma"),
    (torch.float32, 64, 64, 32, "dq", "bst_attn_bwd"),
]


@pytest.mark.parametrize("dtype,bs,hs,key_blocks,kind,source", ROUTES)
def test_route_rule_by_value(dtype, bs, hs, key_blocks, kind, source):
    """``attn_kernel`` at the path's shapes: the LM (bs 64, hs 64, 32 key
    block-rows), its pipeline microbatch (the same), sp-4 gather shards
    (keys whole) and ring pairs (8 key blocks: the forward on mma.sync),
    8 heads of 48 (padded to hs 64), hs 128, bs 32 and 16 (and the bs-8
    view, run at 16), dq (its wgmma kernel at bs 64, hs 64 and 128), and
    f32."""
    assert bst_attn.attn_kernel(kind, dtype, bs, hs, key_blocks) == source
    assert bst_attn.kernel_head_size(48) == 64
    with pytest.raises(ValueError):
        bst_attn.attn_kernel("nt", dtype, bs, hs, key_blocks)


# ---------------- the kernels' work decomposition ----------------

def _visible(code, uniq, bs):
    """The (bs, bs) bool mask of a union entry's code; 0: not the row's
    block, every key hidden."""
    if code == bst_attn.MASK_ABSENT:
        return torch.zeros((bs, bs), dtype=torch.bool)
    tril = torch.ones((bs, bs), dtype=torch.bool).tril()
    if code == bst_attn.MASK_FULL:
        return torch.ones((bs, bs), dtype=torch.bool)
    if code == bst_attn.MASK_TRIL:
        return tril
    if code == bst_attn.MASK_TRIU:
        return tril.T
    u = code - bst_attn.MASK_UNIQ0
    return torch.as_tensor(uniq[u * bs:(u + 1) * bs] != 0)


def _blk(a, r, h, bs, hs):
    return a[:, r * bs:(r + 1) * bs, h * hs:(h + 1) * hs].float()


def _items(tab, sfx, rows, heads):
    """(head, pair's two rows, the union's (block, mask, code_a, code_b)),
    in the kernel's order: pair rank by rank, every head of a rank."""
    pr, pp, pe = (tab[n + sfx] for n in ("pair_rows", "pair_ptr", "pair_ent"))
    lut_heads, n_pairs = pr.shape[:2]
    for p in range(n_pairs):
        for h in range(heads):
            lh = 0 if lut_heads == 1 else h
            lo = pp[lh * (n_pairs + 1) + p]
            yield h, pr[lh, p].tolist(), pe[lo:pp[lh * (n_pairs + 1) + p + 1]]


def _replay_fwd(q, k, v, tab, heads, scale):
    """csrc/bst_attn_fwd_wgmma.cu's work: item by item, each consumer
    warpgroup a row of the pair, union entry by union entry: (out in q's
    dtype, lse f32 (batch, heads, ctx_q))."""
    batch, ctx_q, state = q.shape
    bs, hs = tab["kbs"], state // heads
    rows = ctx_q // bs
    c = max(abs(scale), np.finfo(np.float32).tiny) * LOG2E
    sign = -1.0 if scale < 0 else 1.0
    out = torch.zeros_like(q)
    lse = torch.full((batch, heads, ctx_q), float("-inf"))
    for h, pair, union in _items(tab, "", rows, heads):
        for w, r in enumerate(pair):
            if r < 0:
                continue
            qb = _blk(q, r, h, bs, hs) * sign
            m = torch.full((batch, bs), float("-inf"))
            l = torch.zeros((batch, bs))
            acc = torch.zeros((batch, bs, hs))
            for blk, mask, *codes in union.tolist():
                code = codes[w] if mask >> w & 1 else 0
                s = qb @ _blk(k, blk, h, bs, hs).transpose(1, 2)
                s = s.masked_fill(~_visible(code, tab["uniq"], bs),
                                  float("-inf"))
                m_new = torch.maximum(m, s.amax(-1) * c)
                z = torch.where(m_new == float("-inf"), 0.0, m_new)
                alpha = torch.exp2(m - z)
                p = torch.exp2(s * c - z[..., None])      # unrounded
                l = l * alpha + p.sum(-1)
                acc = acc * alpha[..., None] + \
                    p.to(q.dtype).float() @ _blk(v, blk, h, bs, hs)
                m = m_new
            live = l > 0
            inv = torch.where(live, 1.0 / l.clamp_min(1e-30), 0.0)
            out[:, r * bs:(r + 1) * bs, h * hs:(h + 1) * hs] = \
                (acc * inv[..., None]).to(q.dtype)
            lse[:, h, r * bs:(r + 1) * bs] = torch.where(
                live, m * LN2 + torch.log(l.clamp_min(1e-30)), float("-inf"))
    return out, lse


def _replay_dkv(q, k, v, do, lse, dvec, tab, heads, scale):
    """csrc/bst_attn_dkv_wgmma.cu's work: item by item, each consumer
    warpgroup a key row of the pair, one union entry a step: (dk, dv) f32
    (batch, ctx_k, heads·hs)."""
    batch, ctx_q, state = q.shape
    ctx_k = k.shape[1]
    bs, hs = tab["kbs"], state // heads
    dk = torch.zeros((batch, ctx_k, state))
    dv = torch.zeros((batch, ctx_k, state))
    for h, pair, union in _items(tab, "_t", ctx_k // bs, heads):
        for w, r in enumerate(pair):
            if r < 0:
                continue
            kb, vb = _blk(k, r, h, bs, hs), _blk(v, r, h, bs, hs)
            gk = torch.zeros((batch, bs, hs))
            gv = torch.zeros((batch, bs, hs))
            for blk, mask, *codes in union.tolist():
                code = codes[w] if mask >> w & 1 else 0
                qb, ob = _blk(q, blk, h, bs, hs), _blk(do, blk, h, bs, hs)
                cols = slice(blk * bs, (blk + 1) * bs)
                st = kb @ qb.transpose(1, 2)                 # S^T
                dpt = vb @ ob.transpose(1, 2)                # dP^T
                p = torch.exp(st * scale - lse[:, h, None, cols])
                p = torch.where(_visible(code, tab["uniq_t"], bs), p,
                                torch.zeros_like(p))
                ds = p * (dpt - dvec[:, h, None, cols]) * scale
                gv += p.to(q.dtype).float() @ ob
                gk += ds.to(q.dtype).float() @ qb
            dk[:, r * bs:(r + 1) * bs, h * hs:(h + 1) * hs] = gk
            dv[:, r * bs:(r + 1) * bs, h * hs:(h + 1) * hs] = gv
    return dk, dv


def _replay_dq(q, k, v, do, lse, dvec, tab, heads, scale, out_dtype=None):
    """csrc/bst_attn_dq_wgmma.cu's work: item by item over the forward's
    pair plan, each consumer warpgroup a query row of the pair, one union
    entry a step (an entry not the row's block as one whose keys are all
    hidden): dq (batch, ctx_q, heads·hs) rounded once to q's dtype, or in
    f32 with ``out_dtype=torch.float32``."""
    batch, ctx_q, state = q.shape
    bs, hs = tab["kbs"], state // heads
    dq = torch.zeros((batch, ctx_q, state))
    for h, pair, union in _items(tab, "", ctx_q // bs, heads):
        for w, r in enumerate(pair):
            if r < 0:
                continue
            qb, ob = _blk(q, r, h, bs, hs), _blk(do, r, h, bs, hs)
            rows = slice(r * bs, (r + 1) * bs)
            acc = torch.zeros((batch, bs, hs))
            for blk, mask, *codes in union.tolist():
                code = codes[w] if mask >> w & 1 else 0
                kb, vb = _blk(k, blk, h, bs, hs), _blk(v, blk, h, bs, hs)
                s = qb @ kb.transpose(1, 2)                  # S
                dp = ob @ vb.transpose(1, 2)                 # dP
                # the exp on every element, then the mask's select (with
                # lse = -inf the exp is +inf)
                p = torch.exp(s * scale - lse[:, h, rows, None])
                p = torch.where(_visible(code, tab["uniq"], bs), p,
                                torch.zeros_like(p))
                ds = p * (dp - dvec[:, h, rows, None]) * scale
                acc += ds.to(q.dtype).float() @ kb
            dq[:, rows, h * hs:(h + 1) * hs] = acc
    return dq.to(out_dtype or q.dtype)


def _close(got, want, tol, what):
    scale = max(1.0, float(want.abs().max()))
    err = float((got.float() - want.float()).abs().max())
    assert err <= tol * scale, f"{what}: {err:.3e} > {tol} x {scale:.3e}"


def _inputs(op, dtype, batch, hs, seed, ctx_q=None, ctx_k=None):
    rng = np.random.RandomState(seed)
    ctx_q = ctx_q or op.ctx_blks_q * op.blk_size
    ctx_k = ctx_k or op.ctx_blks_k * op.blk_size
    state = op.heads * hs
    q, do = (torch.from_numpy(rng.standard_normal((batch, ctx_q, state))
                              .astype(np.float32)).to(dtype)
             for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((batch, ctx_k, state))
                             .astype(np.float32)).to(dtype)
            for _ in range(2))
    return q, k, v, do


def _dvec(do, out, heads):
    batch, ctx, state = do.shape
    return (do.float() * out.float()).reshape(batch, ctx, heads, -1).sum(
        -1).transpose(1, 2).contiguous()


REPLAY_CASES = [
    ("fixed", fixed_layout(5, local_blocks=2), 16, 16, _f1_mask, None),
    ("random", _random_layout(5, 7), 16, 16, None, None),
    ("strided_hs", strided_layout(6, local_blocks=2), 32, 8,
     causal_subblock_mask, None),
    ("gather_shard", fixed_layout(8, local_blocks=3), 16, 16,
     causal_subblock_mask, (4, 3, None)),
    ("ring_pair", fixed_layout(8, local_blocks=3), 16, 16,
     causal_subblock_mask, (4, 2, 1)),
    # the wgmma kernels' block size at both dq head sizes; a ring pair
    # whose query rows see no key of the chunk
    ("b64_hs64", fixed_layout(3, local_blocks=2), 64, 64, _f1_mask, None),
    ("b64_hs128_random", _random_layout(3, 9), 64, 128, None, None),
    ("ring_pair_empty", fixed_layout(8, local_blocks=3), 16, 16,
     causal_subblock_mask, (4, 0, 3)),
]


@pytest.mark.parametrize("name,lay,bs,hs,cb,shard", REPLAY_CASES,
                         ids=[c[0] for c in REPLAY_CASES])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("scale", [0.3, -0.2])
def test_replay_matches_plain(name, lay, bs, hs, cb, shard, dtype, scale):
    """The three replays against the plain versions on odd, random,
    strided layouts, F1 rows, bs 64 at hs 64 and 128, and a shard's tables
    (empty rows, ctx_q != ctx_k; a ring pair whose rows see no key, whose
    dq is zero); dq in q's dtype and, in bf16, stored in f32."""
    op = BlocksparseTransformer(lay, block_size=bs, heads=2, mask_callback=cb)
    if shard is None:
        tab = _np_tables(op._tables("cpu"))
        q, k, v, do = _inputs(op, dtype, 2, hs, bs)
        dev_tab = op._tables("cpu")
    else:
        n, r, j = shard
        dev_tab = seq.shard_tables(op, n, r, j)
        tab = _np_tables(dev_tab)
        L = op.ctx_blks_q * bs // n
        q, k, v, do = _inputs(op, dtype, 2, hs, bs, ctx_q=L,
                              ctx_k=L if j is not None else None)
    plain = (dev_tab["q_blk"], dev_tab["k_blk"], dev_tab["mask"], 2, bs,
             scale)
    out, lse = _replay_fwd(q, k, v, tab, 2, scale)
    out_p, lse_p = bst_attn.attention_fwd_lse_plain(q, k, v, *plain)
    _close(out, out_p, TOL[dtype], "out")
    assert torch.equal(torch.isneginf(lse), torch.isneginf(lse_p))
    live = torch.isfinite(lse_p)
    if live.any():
        _close(lse[live], lse_p[live], LSE_TOL, "lse")
    dead = bs + 3
    if cb is _f1_mask:
        assert (out[:, dead] == 0).all()
        assert torch.isneginf(lse[:, :, dead]).all()
    dvec = _dvec(do, out_p, 2)
    dk, dv = _replay_dkv(q, k, v, do, lse_p, dvec, tab, 2, scale)
    dq_p, dk_p, dv_p = bst_attn.attention_bwd_plain(q, k, v, do, lse_p, dvec,
                                                    *plain)
    _close(dk, dk_p, TOL[dtype], "dk")
    _close(dv, dv_p, TOL[dtype], "dv")
    dq = _replay_dq(q, k, v, do, lse_p, dvec, tab, 2, scale)
    assert dq.dtype == dtype
    _close(dq, dq_p, TOL[dtype], "dq")
    if cb is _f1_mask:
        assert (dq[:, dead] == 0).all()
    if name == "ring_pair_empty":
        assert torch.isneginf(lse_p).all() and (dq == 0).all()
    if dtype != torch.float32:
        dq32 = _replay_dq(q, k, v, do, lse_p, dvec, tab, 2, scale,
                          out_dtype=torch.float32)
        assert torch.equal(dq32.to(dtype), dq)
        _close(dq32, bst_attn.attention_bwd_plain(
            q, k, v, do, lse_p, dvec, *plain, dq_dtype=torch.float32)[0],
            TOL[dtype], "dq (f32)")


def _to_flat(a, heads):
    batch, ctx, state = a.shape
    hs = state // heads
    return a.reshape(batch, ctx, heads, hs).transpose(0, 2, 1, 3).reshape(
        batch * heads, ctx, hs)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_replay_matches_jax_at_block_size_64(dtype):
    """ctx 256 at bs 64, a fixed layout with the causal sub-block mask and
    an F1 row, 2 heads of 32: the forward replay's out and lse against JAX
    ``fused_attention_fwd_lse``, the dq replay (in q's dtype and in f32)
    against JAX ``fused_attention_dq`` and the dk/dv replay against JAX
    ``fused_attention_dkv`` (the F1 row left out of the forward's and dq's
    comparisons, its replayed dq zero; its key rows' sums include no term
    of it on either side)."""
    import jax.numpy as jnp
    from blocksparse_tpu import BlocksparseTransformer as JaxBST
    from blocksparse_tpu.kernels import bst_attn as jax_bst_attn
    jnp_dt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    ctx, heads, hs, batch, bs = 256, 2, 32, 1, 64
    layout = fixed_layout(ctx // bs, local_blocks=2)
    ref = JaxBST(layout, block_size=bs, heads=heads, mask_callback=_f1_mask)
    op = BlocksparseTransformer(layout, block_size=bs, heads=heads,
                                mask_callback=_f1_mask)
    q, k, v, do = _inputs(op, dtype, batch, hs, 11)
    scale = 1.0 / np.sqrt(hs)
    tab = _np_tables(op._tables("cpu"))
    out, lse = _replay_fwd(q, k, v, tab, heads, scale)
    live = torch.ones(ctx, dtype=torch.bool)
    live[bs + 3] = False

    def flat(a):
        return jnp.asarray(_to_flat(a.float().numpy(), heads)).astype(jnp_dt)
    yf, lse_f = jax_bst_attn.fused_attention_fwd_lse(
        flat(q), flat(k), flat(v), ref.attn_schedule, heads, scale)
    want = torch.from_numpy(np.array(yf.astype(jnp.float32))).reshape(
        batch, heads, ctx, hs)
    got = torch.from_numpy(_to_flat(out.float().numpy(), heads)).reshape(
        want.shape)
    _close(got[:, :, live], want[:, :, live], TOL[dtype], "out vs JAX")
    lse_want = torch.from_numpy(np.array(lse_f)).reshape(batch, heads, ctx)
    _close(lse[:, :, live], lse_want[:, :, live], LSE_TOL, "lse vs JAX")

    dvec = _dvec(do, out, heads)
    dk, dv = _replay_dkv(q, k, v, do, lse, dvec, tab, heads, scale)
    lse_j = jnp.asarray(lse.numpy().reshape(batch * heads, ctx, 1))
    dvec_j = jnp.asarray(dvec.numpy().reshape(batch * heads, ctx, 1))
    dk_j, dv_j = jax_bst_attn.fused_attention_dkv(
        flat(q), flat(k), flat(v), flat(do), lse_j, dvec_j,
        ref.attn_schedule_tn, heads, scale, out_dtype=jnp.float32)
    for name, a, b in (("dk", dk, dk_j), ("dv", dv, dv_j)):
        b = torch.from_numpy(np.array(b)).reshape(batch, heads, ctx, hs)
        a = torch.from_numpy(_to_flat(a.numpy(), heads)).reshape(b.shape)
        _close(a, b, TOL[dtype], f"{name} vs JAX")
    # in f32 the two epilogues store the same values
    for out_dtype in (None,) if dtype == torch.float32 else (None,
                                                             jnp.float32):
        dq = _replay_dq(q, k, v, do, lse, dvec, tab, heads, scale,
                        out_dtype=out_dtype and torch.float32)
        assert (dq[:, bs + 3] == 0).all()
        dq_j = jax_bst_attn.fused_attention_dq(
            flat(q), flat(k), flat(v), flat(do), lse_j, dvec_j,
            ref.attn_schedule, heads, scale, out_dtype=out_dtype)
        b = torch.from_numpy(np.array(dq_j.astype(jnp.float32))).reshape(
            batch, heads, ctx, hs)
        a = torch.from_numpy(_to_flat(dq.float().numpy(), heads)).reshape(
            b.shape)
        _close(a[:, :, live], b[:, :, live], TOL[dtype],
               f"dq{' (f32)' if out_dtype else ''} vs JAX")
