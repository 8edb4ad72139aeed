"""``csrc/bsmm_updat_sparse.cu``'s host side, on the CPU: its plan
(``updat_sparse_plan``: the wider operand shared, bundles of its
block-rows that name the same blocks of the other, each bundle's union cut
into near-equal groups of slots), the kernels' route rule
(``updat_kernel``) and split at the conv's and the LM's N, and the
kernel's work decomposition replayed in f32.

The kernel runs only on the card (``test_torch_cuda.py`` holds it against
the plain version there).  Here the plan's invariants are checked on the
conv's tap-tiled layouts, random, banded, dense and empty-row layouts at
b32 and b64, both ways round; the shared axis is pinned by value at the
conv's three widths and the LM's two products; and the kernel's work —
thread block b taking items b, b + grid, ..., an item a group over one
run of N, stage by stage of UPDAT_WG_TN token rows, D = P_slotsᵀ · [Q_1 ..
Q_R] stored block by block, then the runs' partials in order — is
replayed and held against ``updat_plain`` and, at b32, the JAX package's
``updat_xla`` (imported inside that test).  Tolerance 1e-5 of the largest
|output|: the same f32 products of f32 inputs, summed in other orders.
"""
import numpy as np
import pytest
import torch

from blocksparse_tpu_torch import BlocksparseMatMul
from blocksparse_tpu_torch.kernels import bsmm as bk

torch.set_num_threads(2)
F32_TOL = 1e-5
KINDS = ("conv", "random", "banded", "dense", "empty_row")


def _conv_layout(CB, KB, density, rng, taps=9):
    """The conv's tap-tiled layout (``BlocksparseConv._build_bsmm``): the
    bench's channel connectivity (``benchmarks/conv_bench.py:51-59``: a
    block where cb == kb % CB or at ``density``), each block's row
    repeated for the taps."""
    lay = np.zeros((CB * taps, KB), np.int32)
    for kb in range(KB):
        for cb in range(CB):
            if cb == kb % CB or rng.rand() < density:
                lay[cb * taps:(cb + 1) * taps, kb] = 1
    return lay


def _layout(kind, CB, KB, seed):
    rng = np.random.RandomState(seed)
    if kind == "conv":
        return _conv_layout(CB, KB, 0.3, rng)
    if kind == "dense":
        return np.ones((CB, KB), np.int32)
    if kind == "banded":
        lay = np.zeros((CB, KB), np.int32)
        for c in range(CB):
            k = c * KB // CB
            lay[c, max(0, k - 1):k + 2] = 1
        return lay
    lay = (rng.rand(CB, KB) < 0.4).astype(np.int32)
    lay[np.arange(CB), np.arange(CB) % KB] = 1
    lay[np.arange(KB) % CB, np.arange(KB)] = 1
    if kind == "empty_row":
        lay[1::3, :] = 0
        lay[:, 1::4] = 0
        lay[0, 0] = 1
    return lay


def _op(kind, shape, bsize, transpose, seed=0):
    lay = _layout(kind, *shape, seed)
    return BlocksparseMatMul(lay.T.copy() if transpose else lay,
                             block_size=bsize, feature_axis=1)


def _plan(op):
    return bk.updat_sparse_plan(op.updat_lut[:, 0], op.updat_lut[:, 1],
                                op.bsize, (op.C, op.K))


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("bsize,shape", [(32, (4, 6)), (32, (9, 20)),
                                         (64, (3, 5)), (64, (7, 2))])
def test_updat_sparse_plan_invariants(bsize, shape, kind, transpose):
    op = _op(kind, shape, bsize, transpose)
    plan = _plan(op)
    grp_q, slot_p, slot_e, R = (plan["grp_q"], plan["slot_p"],
                                plan["slot_e"], plan["R"])
    G, groups = bk.UPDAT_ROWS // bsize, len(grp_q)
    assert R in bk.UPDAT_SP_BUNDLES[bsize]
    assert grp_q.shape == (groups, R) and slot_p.shape == (groups, G)
    assert slot_e.shape == (groups, G, R)
    assert all(a.dtype == np.int32 for a in (grp_q, slot_p, slot_e))
    # the wider operand shared
    assert plan["by_c"] == (op.C >= op.K)
    q_of, p_of = (op.updat_lut[:, 0], op.updat_lut[:, 1]) if plan["by_c"] \
        else (op.updat_lut[:, 1], op.updat_lut[:, 0])
    # each layout block exactly once, at its (slot, Q block)
    ids = slot_e[slot_e >= 0]
    assert sorted(ids.tolist()) == list(range(op.blocks))
    g, t, j = np.nonzero(slot_e >= 0)
    e = slot_e[g, t, j]
    np.testing.assert_array_equal(q_of[e], grp_q[g, j])
    np.testing.assert_array_equal(p_of[e], slot_p[g, t])
    # slots and Q blocks fill from 0; an empty slot or Q block holds none
    for a in (grp_q, slot_p):
        live = a >= 0
        assert (live.sum(1) >= 1).all()
        np.testing.assert_array_equal(
            live, np.arange(a.shape[1])[None, :] < live.sum(1)[:, None])
    assert (slot_e[slot_p < 0] < 0).all()
    assert (slot_e.transpose(0, 2, 1)[grp_q < 0] < 0).all()
    # a bundle's groups consecutive, its slots its union in ascending
    # order, near-equal groups, the larger first; bundles by first Q block
    keys = [tuple(r) for r in grp_q]
    firsts = []
    tiles = 0
    for i, key in enumerate(keys):
        if i and keys[i - 1] == key:
            continue
        firsts.append(key[0])
        n = 1
        while i + n < groups and keys[i + n] == key:
            n += 1
        rows = [q for q in key if q >= 0]
        sizes = (slot_p[i:i + n] >= 0).sum(1)
        assert sizes.max() - sizes.min() <= 1 and \
            (np.diff(sizes) <= 0).all()
        union = slot_p[i:i + n][slot_p[i:i + n] >= 0]
        want = np.unique(p_of[np.isin(q_of, rows)])
        np.testing.assert_array_equal(union, want)
        tiles += len(union) + n * len(rows)
    assert len(firsts) == len(set(keys)) and firsts == sorted(firsts)
    assert plan["tiles"] == tiles
    # every Q block in exactly one bundle
    live_q = [q for key in set(keys) for q in key if q >= 0]
    assert sorted(live_q) == sorted(set(q_of.tolist()))


@pytest.mark.parametrize("shape,seed,R", [((5, 6), 3, 4), ((8, 12), 1, 3)])
def test_updat_sparse_plan_bundles_the_taps_of_an_input_block(shape, seed,
                                                              R):
    """At the conv's layout the nine taps of an input block name the same
    dy blocks: 9 // R bundles of R taps of one input block each, every
    (slot, tap) of theirs a block; the leftover taps bundled R to a group
    of their union.  R as the cost picks it (4 at 30 input blocks and 6
    output blocks, where unions are cheap; 3 at 8 x 12)."""
    op = _op("conv", shape, 32, False, seed=seed)
    plan = _plan(op)
    assert plan["by_c"] and plan["R"] == R
    live = (plan["slot_p"] >= 0)[:, :, None] & (plan["grp_q"] >= 0)[:, None]
    pure = set()
    for g, key in enumerate(plan["grp_q"]):
        if min(key) >= 0 and len({q // 9 for q in key}) == 1:
            pure.add(tuple(key))
            np.testing.assert_array_equal(plan["slot_e"][g] >= 0, live[g])
    assert len(pure) == shape[0] * (9 // R)


def test_updat_sparse_plan_refuses_other_block_sizes():
    for b in (8, 16, 128):
        with pytest.raises(ValueError, match="block sizes"):
            bk.updat_sparse_plan([0], [0], b, (b, b))


# the conv bench's configurations as chip_smoke.py draws them (one
# RandomState(0) over C = K in 512, 1024, 2048, each at d 0.25 then
# 0.0625): their tap-tiled layouts at d 0.25, and the updat plans' counts
CONV_PLANS = {512: (684, 3, 48, 372, 92, 776), 1024: (2439, 3, 135, 1218,
                                                      320, 2759),
              2048: (9783, 3, 486, 4719, 1251, 11034)}


def _conv_layouts():
    rng = np.random.RandomState(0)
    out = {}
    for ck in (512, 1024, 2048):
        for d in (0.25, 0.0625):
            lay = _conv_layout(ck // 32, ck // 32, d, rng)
            if d == 0.25:
                out[ck] = lay
    return out


def test_updat_sparse_plan_at_the_conv_and_lm_shapes():
    """The shared axis by the bytes a group draws: at the conv (im2col's X,
    9 C wide, against dy's K = C) X's block-rows, three taps a bundle,
    4,719 tiles a token row at C=2048 against updat_plan's 11,034
    (blocks + groups); at the LM's bsmm1 (512 -> 2048) dy's columns, at
    bsmm2 x's rows (the wider operand either way)."""
    for ck, lay in _conv_layouts().items():
        blocks, R, groups, tiles, old_groups, old_tiles = CONV_PLANS[ck]
        ent_c, ent_k = np.nonzero(lay)
        assert len(ent_c) == blocks
        plan = bk.updat_sparse_plan(ent_c, ent_k, 32,
                                    (lay.shape[0] * 32, lay.shape[1] * 32))
        assert plan["by_c"] and (plan["R"], len(plan["grp_q"]),
                                 plan["tiles"]) == (R, groups, tiles), ck
        old = bk.updat_plan(ent_c, ent_k, 32)
        assert not old["by_c"] and len(old["grp_q"]) == old_groups
        assert blocks + old_groups == old_tiles
    bsmm1, bsmm2 = _flagship()
    for op, by_c in ((bsmm1, False), (bsmm2, True)):
        plan = op._plan("updat_sparse", "u")
        assert plan["by_c"] == by_c and plan["R"] == 4
        assert len(plan["grp_q"]) == 32 and plan["tiles"] == 375


def _replay(x, dy, plan, bsize, splits, sm_count=132):
    """What bsmm_updat_sparse.cu and the reduce compute, in f32 on the CPU:
    thread block b of min(items, sm_count) takes items b, b + grid, ...;
    item i is group i % groups over run i // groups of the split's runs
    (UPDAT_WG_TN-row stages, zero past N); per stage D += P_slotsᵀ ·
    [Q_1 .. Q_R] (G·b x R·b) over the group's live slots and Q blocks;
    each (slot, Q block) with a block stores its piece of D (transposed
    when Q is x); then the runs are summed in order."""
    N, TN, b = x.shape[0], bk.UPDAT_WG_TN, bsize
    rows = bk.updat_run_rows(N, splits, "sparse")
    runs = -(-N // rows) if splits > 1 else 1
    p, q = (dy, x) if plan["by_c"] else (x, dy)
    grp_q, slot_p, slot_e = plan["grp_q"], plan["slot_p"], plan["slot_e"]
    groups, G, R = len(grp_q), slot_p.shape[1], plan["R"]
    blocks = int((slot_e >= 0).sum())
    out = torch.full((runs, blocks, b, b), float("nan"))
    items = groups * runs
    grid = min(items, sm_count)
    done = set()
    for blk in range(grid):
        for item in range(blk, items, grid):
            grp, run = item % groups, item // groups
            lo, hi = run * rows, min(N, (run + 1) * rows)
            pcols = [pb for pb in slot_p[grp] if pb >= 0]
            qcols = [qb for qb in grp_q[grp] if qb >= 0]
            D = torch.zeros((G * b, R * b))
            for n0 in range(lo, hi, TN):
                n1 = min(hi, n0 + TN)
                P = torch.zeros((n1 - n0, G * b))
                Q = torch.zeros((n1 - n0, R * b))
                for t, pb in enumerate(pcols):
                    P[:, t * b:(t + 1) * b] = p[n0:n1, pb * b:(pb + 1) * b]
                for j, qb in enumerate(qcols):
                    Q[:, j * b:(j + 1) * b] = q[n0:n1, qb * b:(qb + 1) * b]
                D += P.t() @ Q
            for t in range(G):
                for j in range(R):
                    e = slot_e[grp, t, j]
                    if e >= 0:
                        d = D[t * b:(t + 1) * b, j * b:(j + 1) * b]
                        out[run, e] = d.t() if plan["by_c"] else d
            done.add(item)
    assert done == set(range(items))
    return bk.updat_reduce_plain(out), runs


@pytest.mark.parametrize("kind,bsize,shape,transpose,N,splits", [
    ("conv", 32, (3, 4), False, 300, 1),
    ("conv", 32, (4, 3), True, 1100, 2),
    ("random", 32, (6, 9), False, 200, 1),
    ("empty_row", 32, (7, 5), True, 1300, 2),
    ("conv", 64, (2, 3), False, 130, 1),
    ("random", 64, (5, 3), False, 1100, 2)])
def test_updat_sparse_decomposition_matches_plain(kind, bsize, shape,
                                                  transpose, N, splits):
    op = _op(kind, shape, bsize, transpose, seed=N)
    rng = np.random.RandomState(N + bsize)
    x = torch.from_numpy(rng.uniform(-1, 1, (N, op.C)).astype(np.float32))
    dy = torch.from_numpy(rng.uniform(-1, 1, (N, op.K)).astype(np.float32))
    dw, runs = _replay(x, dy, _plan(op), bsize, splits)
    assert runs == splits
    lut = op._lut(torch.device("cpu"))
    ref = bk.updat_plain(x, dy, lut["u_c"], lut["u_k"], bsize, 1)
    scale = ref.abs().max().item()
    torch.testing.assert_close(dw, ref, rtol=0, atol=F32_TOL * scale)
    if bsize == 32:
        import jax.numpy as jnp
        from blocksparse_tpu.kernels import bsmm as jax_bsmm
        jref = jax_bsmm.updat_xla(jnp.asarray(x.numpy()),
                                  jnp.asarray(dy.numpy()), op.updat_lut,
                                  bsize, 1)
        np.testing.assert_allclose(dw.numpy(), np.asarray(jref), rtol=0,
                                   atol=F32_TOL * scale)


@pytest.mark.parametrize("shape,seed", [((8, 12), 1), ((3, 5), 7)])
def test_updat_sparse_replay_with_fewer_thread_blocks_than_items(shape, seed):
    """The persistent walk: 5 thread blocks over more items than that (R =
    3 and 4 here), the same result as one thread block an item."""
    op = _op("conv", shape, 32, False, seed=seed)
    rng = np.random.RandomState(1)
    x = torch.from_numpy(rng.uniform(-1, 1, (700, op.C)).astype(np.float32))
    dy = torch.from_numpy(rng.uniform(-1, 1, (700, op.K)).astype(np.float32))
    plan = _plan(op)
    assert len(plan["grp_q"]) * 2 > 5
    few, _ = _replay(x, dy, plan, 32, 2, sm_count=5)
    many, _ = _replay(x, dy, plan, 32, 2)
    assert torch.equal(few, many)


def _flagship(bsize=32, density=0.5, n_embd=512, hidden=2048):
    """The LM's MLP layouts as ``SparseTransformerLM`` draws them (bsmm1
    512 -> 2048, bsmm2 its transpose)."""
    CB, KB = n_embd // bsize, hidden // bsize
    rng = np.random.RandomState(0)
    lay = (rng.rand(CB, KB) < density).astype(np.int32)
    lay[np.arange(CB), np.arange(CB) % KB] = 1
    lay[np.arange(KB) % CB, np.arange(KB)] = 1
    return (BlocksparseMatMul(lay, block_size=bsize, feature_axis=1),
            BlocksparseMatMul(lay.T.copy(), block_size=bsize, feature_axis=1))


def test_updat_kernel_at_the_conv_and_lm_shapes():
    """The route rule by value, 132 SMs: the conv's updat at N 32,768
    (its plans' tiles: C=512 372 of 776, C=1024 1,218 of 2,759, C=2048
    4,719 of 11,034) and the LM's at N 1,024-16,384 (375 of 633) on
    bsmm_updat_sparse.cu, with their splits (C=512: 48 groups, 11 runs
    fill 528 of 528; C=1024: 135 groups, 4 runs 540 of 660; C=2048: 486
    groups fill two waves alone); bench.py's random op (its plan no
    smaller) and b128 keep the earlier rule; UPDAT_SP_MAX_TILES of the
    tiles or fewer take the sparse kernel."""
    for ck, lay in _conv_layouts().items():
        blocks, _, groups, tiles, old_groups, old_tiles = CONV_PLANS[ck]
        assert bk.updat_kernel(32768, 32, old_groups, 132,
                               (tiles, old_tiles)) == "sparse"
        op = BlocksparseMatMul(lay, block_size=32, feature_axis=0)
        want = {512: 11, 1024: 4, 2048: 1}[ck]
        assert op._updat_route(32768, torch.bfloat16, 132) == ("sparse",
                                                                want)
        assert bk.updat_splits(32768, groups, 32, 132, "sparse") == want
        assert op.kernel_of(32768, "u", sm_count=132) == "bsmm_updat_sparse"
    bsmm1, _ = _flagship()
    for N in (1024, 2048, 4096, 8192, 16384):
        assert bsmm1.kernel_of(N, "u", sm_count=132) == "bsmm_updat_sparse"
        assert bk.updat_kernel(N, 32, 75, 132, (375, 633)) == "sparse"
    assert bk.updat_kernel(2048, 32, 2206, 132, (18994, 18990)) == "wgmma"
    assert bk.updat_kernel(32768, 32, 1251, 132, (11034, 11034)) == "mma"
    assert bk.updat_kernel(2048, 32, 300, 132, (80, 100)) == "sparse"
    assert bk.updat_kernel(2048, 32, 300, 132, (81, 100)) == "wgmma"
    assert bk.updat_kernel(2048, 128, 300, 132, (10, 100)) == "wgmma"
    assert bk.updat_kernel(2048, 16, 300, 132, (10, 100)) == "mma"
    # ceil(32768 / 11) = 2,979 rows, rounded up to 64-row stages
    assert bk.updat_run_rows(32768, 11, "sparse") == 3008
