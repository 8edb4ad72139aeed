"""The unfused ops' launch plan (``kernels/bst_trio.py``: ``launch_plan``,
``trio_tables``' order, plan and plan_t) and the work decomposition the
tensor-core trio kernels run on it, emulated on the CPU.

The plan is host code: the longest-first row order is a stable sort of
the rows by entry count; the items cover every entry of every row
exactly once, in order, a split row's two halves side by side in one
cluster pair.  The emulation walks the plan as ``csrc/bst_nt_mma.cu``
and ``csrc/bst_xn_mma.cu`` do (NT: each item's score blocks on their
own; NN/TN: each item's entries summed in order in f32, a split row's
first half plus its second) and is held against the plain versions
(``bst_nt_plain``, ``bst_xn_plain``: the same f32 sums in another order,
1e-5 of max(1, max|ref|)) and the JAX package's goldens (``nt_test``,
``nn_test``, ``tn_test``, likewise).
"""
import numpy as np
import pytest
import torch
import jax  # noqa: F401  (the conftest keeps JAX on the CPU)

from blocksparse_tpu import BlocksparseTransformer as JaxBST
from blocksparse_tpu.models.sparse_transformer import (
    causal_subblock_mask, fixed_layout)

from blocksparse_tpu_torch import BlocksparseTransformer
from blocksparse_tpu_torch.kernels import bst_trio

torch.set_num_threads(2)
F32_TOL = 1e-5


def _layout(kind, ctx_blks, heads, seed):
    """The LM's fixed layout, or a random one (per head, the same count in
    each) with an empty query row 1 and key row 2 and, for "long", query
    row 0 and key row 0 holding every other block."""
    if kind == "fixed":
        return fixed_layout(ctx_blks, local_blocks=4)
    rng = np.random.RandomState(seed)
    lays = []
    for _ in range(heads):
        lay = (rng.rand(ctx_blks, ctx_blks) < 0.3).astype(np.int32)
        if kind == "long":
            lay[0, :] = lay[:, 0] = 1
        lay[1, :] = 0
        lay[:, 2] = 0
        lays.append(lay)
    want = min(int(lay.sum()) for lay in lays)
    for lay in lays:
        on = np.argwhere(lay[3:, 3:])[:int(lay.sum()) - want] + 3
        lay[on[:, 0], on[:, 1]] = 0
    return np.array(lays)


def _tables(kind, ctx_blks=12, heads=2, seed=0, bs=8):
    op = BlocksparseTransformer(_layout(kind, ctx_blks, heads, seed),
                                block_size=bs, heads=heads)
    return op, bst_trio.trio_tables(op.nt_list, op.ctx_blks_q,
                                    op.ctx_blks_k)


def _split_plan(tri, sfx, rows):
    """(row_ptr (lut_heads, rows + 1), items (lut_heads, n)) of plan{sfx}."""
    rp = tri["row_ptr" + sfx]
    lh = rp.shape[0]
    flat = tri["plan" + sfx]
    return flat[:lh * (rows + 1)].reshape(lh, rows + 1), \
        flat[lh * (rows + 1):].reshape(lh, -1)


def _plan_rows(plan_row, row_ptr):
    """The entry range [e0, e1) of each item of one head's plan (item ->
    range, -1 left out), decoded as the kernels decode it: row * 4 +
    part, part WHOLE, FIRST (the first ceil(count / 2) entries) or
    SECOND (the rest)."""
    out = {}
    for it in plan_row.tolist():
        if it < 0:
            continue
        r, part = divmod(it, 4)
        e0, e1 = int(row_ptr[r]), int(row_ptr[r + 1])
        mid = e0 + (e1 - e0 + 1) // 2
        out[it] = ((e0, e1) if part == bst_trio.WHOLE else
                   (e0, mid) if part == bst_trio.FIRST else (mid, e1))
    return out


KINDS = ["fixed", "random", "long"]


@pytest.mark.parametrize("sfx", ["", "_t"])
@pytest.mark.parametrize("kind", KINDS)
def test_launch_order_is_a_stable_sort_by_count(kind, sfx):
    """order / order_t: a permutation of the rows, entry counts
    non-increasing, ties in row order."""
    op, tri = _tables(kind)
    for rp, order in zip(tri["row_ptr" + sfx], tri["order" + sfx]):
        counts = np.diff(rp)
        assert sorted(order.tolist()) == list(range(len(counts)))
        key = [(-counts[r], r) for r in order]
        assert key == sorted(key)


@pytest.mark.parametrize("sfx", ["", "_t"])
@pytest.mark.parametrize("kind", KINDS)
def test_plan_covers_each_entry_once_in_order(kind, sfx):
    """The plan's row pointers are the CSR's; its items hold every row
    (an empty one too), a split row as its two halves [e0, mid) and
    [mid, e1) in one pair (FIRST first), so each entry is walked once and
    the halves in order; a row is split exactly where it holds two or
    more entries and more than SPLIT_FACTOR times the mean."""
    op, tri = _tables(kind)
    rows = op.ctx_blks_k if sfx else op.ctx_blks_q
    rp, items = _split_plan(tri, sfx, rows)
    np.testing.assert_array_equal(rp, tri["row_ptr" + sfx])
    assert items.shape[1] % 2 == 0
    for h in range(rp.shape[0]):
        counts = np.diff(rp[h])
        ranges = _plan_rows(items[h], rp[h])
        walked = sorted(e for a, b in ranges.values() for e in range(a, b))
        assert walked == list(range(rp[h, -1]))
        seen = sorted({it // 4 for it in ranges})
        assert seen == list(range(rows))
        for pos, it in enumerate(items[h].tolist()):
            if it < 0:
                continue
            r, part = divmod(it, 4)
            long_row = counts[r] >= 2 and \
                counts[r] > bst_trio.SPLIT_FACTOR * counts.mean()
            assert (part != bst_trio.WHOLE) == long_row, (r, part)
            if part == bst_trio.FIRST:
                assert pos % 2 == 0
                assert items[h, pos + 1] == 4 * r + bst_trio.SECOND
                (a, m), (m2, b) = ranges[it], ranges[it + 1]
                assert (a, m2, b) == (rp[h, r], m, rp[h, r + 1])
                assert m - a == (b - a + 1) // 2
    if kind == "long":
        assert (items % 4 == bst_trio.FIRST).any()


def test_plan_of_the_lm_layout_walks_longest_first():
    """The LM's layout (fixed, 32 blocks, 8 local): its query rows (1-14
    entries) go whole, longest first; its key rows of 32, 28, 24 and 20
    entries (past twice the mean of 9.75) go as halves of 16, 14, 12 and
    10, the longest first, and the key rows' largest item is 16."""
    op = BlocksparseTransformer(fixed_layout(32, local_blocks=8),
                                block_size=64, heads=2)
    tri = bst_trio.trio_tables(op.nt_list, 32, 32)
    rp, items = _split_plan(tri, "", 32)
    counts = np.diff(rp[0])
    assert (items[0] % 4 == bst_trio.WHOLE).all()
    assert [counts[it // 4] for it in items[0]] == \
        sorted(counts.tolist(), reverse=True)
    rp, items = _split_plan(tri, "_t", 32)
    ranges = _plan_rows(items[0], rp[0])
    split = [it // 4 for it in items[0] if it % 4 == bst_trio.FIRST]
    assert split == [0, 4, 8, 12]
    assert items[0][:2].tolist() == [bst_trio.FIRST, bst_trio.SECOND]
    assert max(b - a for a, b in ranges.values()) == 16


def _emulate_nt(A, B, tri, heads, bs, rows):
    """NT as the kernel walks the plan: each item's score blocks,
    (batch, heads, blocks, bs, bs) in f32."""
    rp, items = _split_plan(tri, "", rows)
    batch, _, state = A.shape
    hs = state // heads
    blocks = tri["ent_k"].shape[1]
    w = np.full((batch, heads, blocks, bs, bs), np.nan, np.float32)
    for n in range(batch):
        for h in range(heads):
            lh = h if rp.shape[0] > 1 else 0
            for it, (e0, e1) in _plan_rows(items[lh], rp[lh]).items():
                q = A[n, it // 4 * bs:(it // 4 + 1) * bs, h * hs:(h + 1) * hs]
                for e in range(e0, e1):
                    kb = tri["ent_k"][lh, e]
                    k = B[n, kb * bs:(kb + 1) * bs, h * hs:(h + 1) * hs]
                    w[n, h, e] = q @ k.T
    return w


def _emulate_xn(W, X, tri, heads, bs, rows, trans):
    """NN / TN as the kernel walks the plan: each item's entries summed in
    order in f32; a split row is its first half's sum plus its
    second's; rows nothing covers stay NaN."""
    sfx, ew, ex = ("_t", "ent_b", "ent_q") if trans else ("", "ent_e",
                                                         "ent_k")
    rp, items = _split_plan(tri, sfx, rows)
    batch, _, state = X.shape
    hs = state // heads
    y = np.full((batch, rows * bs, state), np.nan, np.float32)
    for n in range(batch):
        for h in range(heads):
            lh = h if rp.shape[0] > 1 else 0
            ranges = _plan_rows(items[lh], rp[lh])
            sums = {}
            for it, (e0, e1) in ranges.items():
                acc = np.zeros((bs, hs), np.float32)
                for e in range(e0, e1):
                    wb = W[n, h, tri[ew][lh, e]]
                    xb = tri[ex][lh, e]
                    xblk = X[n, xb * bs:(xb + 1) * bs, h * hs:(h + 1) * hs]
                    acc += (wb.T if trans else wb) @ xblk
                sums[it] = acc
            for it, acc in sums.items():
                r, part = divmod(it, 4)
                if part == bst_trio.SECOND:
                    continue
                if part == bst_trio.FIRST:
                    acc = acc + sums[it + 1]
                y[n, r * bs:(r + 1) * bs, h * hs:(h + 1) * hs] = acc
    return y


def _close(got, ref, what):
    ref = np.asarray(ref, np.float32)
    got = np.asarray(got, np.float32)
    assert got.shape == ref.shape and np.isfinite(got).all(), what
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=F32_TOL * max(1.0, np.abs(ref).max()),
                               err_msg=what)


@pytest.mark.parametrize("per_head", [False, True])
@pytest.mark.parametrize("bs", [8, 16])
def test_decomposition_matches_plain_and_jax_goldens(bs, per_head):
    """The kernels' decomposition, emulated, on a layout with an empty
    query row, an empty key row and a query row and a key row cut in two
    by the plan: NT, NN and TN against the plain versions and JAX's
    goldens."""
    heads, blks, hs = 2, 12, 16
    layout = _layout("long", blks, heads, seed=bs)
    if not per_head:
        layout = layout[0]
    op = BlocksparseTransformer(layout, block_size=bs, heads=heads,
                                mask_callback=causal_subblock_mask)
    jop = JaxBST(layout, block_size=bs, heads=heads,
                 mask_callback=causal_subblock_mask)
    tri = bst_trio.trio_tables(op.nt_list, blks, blks)
    for sfx in ("", "_t"):
        _, items = _split_plan(tri, sfx, blks)
        assert (items % 4 == bst_trio.FIRST).any(), sfx
    rng = np.random.RandomState(bs)
    A, B = (rng.uniform(-1, 1, (2, blks * bs, heads * hs)).astype(np.float32)
            for _ in range(2))
    W = rng.uniform(-1, 1, (2, heads, op.blocks, bs, bs)).astype(np.float32)
    tab = op._tables(torch.device("cpu"))
    a, b, w = (torch.from_numpy(t) for t in (A, B, W))

    nt = _emulate_nt(A, B, tri, heads, bs, blks)
    _close(nt, bst_trio.bst_nt_plain(a, b, tab["q_blk"], tab["k_blk"],
                                      heads, bs), "nt plain")
    _close(nt, jop.nt_test(A, B), "nt golden")
    nn = _emulate_xn(W, B, tri, heads, bs, blks, False)
    _close(nn, bst_trio.bst_xn_plain(w, b, tab["q_blk"], tab["k_blk"], blks,
                                     heads, bs, False), "nn plain")
    _close(nn, jop.nn_test(W, B), "nn golden")
    assert (nn[:, bs:2 * bs] == 0).all()                  # query row 1
    tn = _emulate_xn(W, A, tri, heads, bs, blks, True)
    _close(tn, bst_trio.bst_xn_plain(w, a, tab["k_blk"], tab["q_blk"], blks,
                                     heads, bs, True), "tn plain")
    _close(tn, jop.tn_test(W, A), "tn golden")
    assert (tn[:, 2 * bs:3 * bs] == 0).all()              # key row 2


def test_op_tables_carry_the_plans():
    """The op's device tables hold the plans beside the CSRs (one upload),
    and the kernels' route passes them as the wrappers' row_ptr."""
    op, tri = _tables("random")
    tab = op._tables(torch.device("cpu"))
    for name in ("plan", "plan_t", "order", "order_t", "row_ptr",
                 "row_ptr_t"):
        t = tab["tri_" + name]
        assert t.dtype == torch.int32
        np.testing.assert_array_equal(t.numpy(), tri[name])


@pytest.mark.parametrize("per_head", [False, True])
def test_blocked_softmax_row_sums_are_fixed_order_adjoints(per_head):
    """The blocked softmax's row sums (``_RowSum``, ``_RowBroadcast``):
    ``row_blocks`` holds each query row's blocks in order, padded; the sum
    equals ``scatter_add``'s; each is the other's adjoint (gradcheck in
    f64), so the softmax's forward and backward add in fixed orders."""
    from blocksparse_tpu_torch.ops import transformer as port_tr
    layout = _layout("random", 12, 2, seed=0)
    op = BlocksparseTransformer(layout if per_head else layout[0],
                                block_size=8, heads=2)
    tab = op._tables(torch.device("cpu"))
    rb, q_blk = tab["row_blocks"], tab["q_blk"]
    for h in range(q_blk.shape[0]):
        for r in range(12):
            got = [b for b in rb[h, r].tolist() if b < op.blocks]
            assert got == np.flatnonzero(q_blk[h].numpy() == r).tolist()
    v = torch.randn((2, 2, op.blocks, 8), dtype=torch.float64)
    idx = q_blk.expand(2, -1)[None, :, :, None].expand(2, 2, op.blocks, 8)
    want = torch.zeros((2, 2, 12, 8), dtype=torch.float64).scatter_add(
        2, idx, v)
    torch.testing.assert_close(port_tr._RowSum.apply(v, rb, q_blk), want)
    s = torch.randn((2, 2, 12, 8), dtype=torch.float64, requires_grad=True)
    vg = v.clone().requires_grad_()
    assert torch.autograd.gradcheck(
        lambda t: port_tr._RowSum.apply(t, rb, q_blk), (vg,))
    assert torch.autograd.gradcheck(
        lambda t: port_tr._RowBroadcast.apply(t, rb, q_blk), (s,))
