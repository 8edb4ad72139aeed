"""The wgmma kernels' host side, on the CPU: ``csrc/bsmm_xprop_wgmma.cu``'s
column-group plan (``xprop_wgmma_plan``), ``csrc/bsmm_xprop_sparse.cu``'s
(``xprop_sparse_plan``: items of two input blocks, the packed weights'
order) and its weight packing (``xprop_sparse_pack``), the route rules
between the wgmma, sparse and mma.sync kernels (``xprop_kernel``,
``updat_kernel``) and the updat's N split for
``csrc/bsmm_updat_wgmma.cu`` (``updat_splits`` and ``updat_run_rows``
with ``kernel="wgmma"``).

The kernels run only on the card (``test_torch_cuda.py`` holds them
against the plain versions there).  Here the plan's invariants are
checked on random, banded, dense and empty-column layouts at every block
size, in both directions; the rules are pinned by value at the main
path's shapes; and the kernels' work decomposition is replayed in f32 —
the xprop group by group, N-tile by N-tile, staged item by staged item
into each column's accumulator (the sparse kernel's from its packed
weights); the updat group by group, run by run, TN
token rows a stage, then the runs' partials in order — and held against
``xprop_plain``/``updat_plain`` and, at b32, the JAX package's
``xprop_xla``/``updat_xla`` (imported inside those tests, on the CPU).
Tolerance 1e-5 of the largest |output|: the same f32 products of f32
inputs, summed in other orders.
"""
import numpy as np
import pytest
import torch

from blocksparse_tpu_torch import BlocksparseMatMul
from blocksparse_tpu_torch.kernels import bsmm as bk

torch.set_num_threads(2)
F32_TOL = 1e-5
KINDS = ("random", "banded", "dense", "empty_column")


def _layout(kind, CB, KB, seed):
    """A (CB, KB) layout: random at 0.4 (every row and column set once),
    a band, all ones, or random with empty output columns (fprop) and
    empty input rows (bprop)."""
    rng = np.random.RandomState(seed)
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
    if kind == "empty_column":
        lay[:, 1::3] = 0
        lay[1::4, :] = 0
        lay[0, 0] = 1
    return lay


def _csr(op, d):
    row_ptr, (ib, wb, _), n_out, n_in = op._csr(d)
    return row_ptr, ib, wb, n_out


@pytest.mark.parametrize("d", ["f", "b"])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("bsize,shape", [(8, (9, 40)), (16, (20, 3)),
                                         (32, (6, 19)), (64, (7, 5)),
                                         (128, (3, 5))])
def test_xprop_wgmma_plan_invariants(bsize, shape, kind, d):
    """Every (column, entry) in exactly one item of its group, a column's
    entries in LUT order, each group's items ascending, the columns cut
    into consecutive groups of 256 / b."""
    op = BlocksparseMatMul(_layout(kind, *shape, seed=bsize), block_size=bsize,
                           feature_axis=1)
    row_ptr, ib, wb, n_out = _csr(op, d)
    plan = bk.xprop_wgmma_plan(row_ptr, ib, wb, bsize)
    G = bk.XPROP_WG_FEATURES // bsize
    u_ptr, u_in, u_mask, u_w, grp = (plan[k] for k in (
        "u_ptr", "u_in", "u_mask", "u_w", "grp_col"))
    assert plan["G"] == G
    assert all(a.dtype == np.int32 for a in (u_ptr, u_in, u_mask, u_w, grp))
    assert grp.shape == (-(-n_out // G), G)
    assert grp.ravel().tolist() == list(range(n_out)) + \
        [-1] * (grp.size - n_out)
    assert u_ptr[0] == 0 and u_ptr[-1] == len(u_in) and \
        (np.diff(u_ptr) >= 0).all()
    assert u_w.shape == (len(u_in), G) and u_mask.shape == (len(u_in),)
    mask = u_mask.view(np.uint32).astype(np.int64)     # G bits (32 at b8)
    bits = (mask[:, None] >> np.arange(G)) & 1
    assert ((u_w >= 0) == (bits == 1)).all()
    assert (mask > 0).all()                   # no item without an entry
    walked = {o: [] for o in range(n_out)}
    for g in range(len(grp)):
        items = range(u_ptr[g], u_ptr[g + 1])
        assert (np.diff(u_in[items.start:items.stop]) > 0).all()  # ascending
        for t in items:
            for j in np.flatnonzero(bits[t]):
                assert grp[g, j] >= 0
                walked[grp[g, j]].append((u_in[t], u_w[t, j]))
    for o in range(n_out):                    # each entry once, in LUT order
        lo, hi = row_ptr[o], row_ptr[o + 1]
        assert walked[o] == list(zip(ib[lo:hi], wb[lo:hi]))
    assert op._plan("wgmma", d)["u_in"].tolist() == u_in.tolist()


def test_xprop_wgmma_plan_refuses_an_unordered_csr():
    with pytest.raises(ValueError, match="ascending"):
        bk.xprop_wgmma_plan([0, 2], [3, 1], [0, 1], 32)


def _replay_xprop(x, w, plan, bsize, n_out, trans):
    """What bsmm_xprop_wgmma.cu computes, in f32 on the CPU: thread block
    (group, N-tile of 128 rows, zero past N) walks its items and adds each
    present pair's product to its column's accumulator, then writes the
    tile's columns."""
    N, TM, G = x.shape[0], bk.XPROP_WG_TM, plan["G"]
    y = torch.full((N, n_out * bsize), float("nan"))
    for g, cols in enumerate(plan["grp_col"]):
        for n0 in range(0, N, TM):
            xt = torch.zeros((TM, x.shape[1]))
            xt[:min(TM, N - n0)] = x[n0:n0 + TM]
            acc = torch.zeros((G, TM, bsize))
            for t in range(plan["u_ptr"][g], plan["u_ptr"][g + 1]):
                i = plan["u_in"][t]
                xi = xt[:, i * bsize:(i + 1) * bsize]
                for j in range(G):
                    if plan["u_mask"][t] >> j & 1:
                        wb = w[plan["u_w"][t, j]]
                        acc[j] += xi @ (wb.t() if trans else wb)
            for j, o in enumerate(cols):
                if o >= 0:
                    y[n0:n0 + TM, o * bsize:(o + 1) * bsize] = \
                        acc[j, :min(TM, N - n0)]
    return y


@pytest.mark.parametrize("d", ["f", "b"])
@pytest.mark.parametrize("bsize,shape,kind,N", [
    (32, (6, 19), "random", 300), (32, (9, 4), "empty_column", 129),
    (64, (5, 7), "banded", 200), (128, (2, 3), "dense", 5)])
def test_xprop_wgmma_decomposition_matches_plain(bsize, shape, kind, N, d):
    op = BlocksparseMatMul(_layout(kind, *shape, seed=7), block_size=bsize,
                           feature_axis=1)
    row_ptr, ib, wb, n_out = _csr(op, d)
    rng = np.random.RandomState(bsize + N)
    x = torch.from_numpy(rng.uniform(-1, 1, (N, (op.C if d == "f" else op.K))
                                     ).astype(np.float32))
    w = torch.from_numpy(rng.uniform(-1, 1, op.w_shape).astype(np.float32))
    y = _replay_xprop(x, w, bk.xprop_wgmma_plan(row_ptr, ib, wb, bsize),
                      bsize, n_out, d == "b")
    lut = op._lut(torch.device("cpu"))
    ref = bk.xprop_plain(x, w, lut[f"{d}_in"], lut[f"{d}_w"], lut[f"{d}_out"],
                         n_out, bsize, 1, trans_w=d == "b")
    scale = ref.abs().max().item()
    torch.testing.assert_close(y, ref, rtol=0, atol=F32_TOL * scale)
    if bsize == 32:
        import jax.numpy as jnp
        from blocksparse_tpu.kernels import bsmm as jax_bsmm
        jref = jax_bsmm.xprop_xla(
            jnp.asarray(x.numpy()), jnp.asarray(w.numpy()),
            jnp.asarray(lut[f"{d}_in"].numpy()),
            jnp.asarray(lut[f"{d}_w"].numpy()),
            jnp.asarray(lut[f"{d}_out"].numpy()), n_out, bsize, 1,
            d == "b")
        np.testing.assert_allclose(y.numpy(), np.asarray(jref), rtol=0,
                                   atol=F32_TOL * scale)


def _replay_updat(x, dy, plan, bsize, splits):
    """What bsmm_updat_wgmma.cu and the reduce compute, in f32 on the CPU:
    thread block (group, run) adds P_stageᵀ · Q_stage over its run's
    stages of UPDAT_WG_TN token rows (zero past N) into each slot's D
    (dw transposed when Q is x), then the runs are summed in order."""
    N, TN = x.shape[0], bk.UPDAT_WG_TN
    rows = bk.updat_run_rows(N, splits, "wgmma")
    runs = -(-N // rows) if splits > 1 else 1
    p, q = (dy, x) if plan["by_c"] else (x, dy)
    blocks = int((plan["slot_e"] >= 0).sum())
    out = torch.full((runs, blocks, bsize, bsize), float("nan"))
    for grp, qb in enumerate(plan["grp_q"]):
        for r in range(runs):
            lo, hi = r * rows, min(N, (r + 1) * rows)
            acc = {t: torch.zeros((bsize, bsize))
                   for t, e in enumerate(plan["slot_e"][grp]) if e >= 0}
            for n0 in range(lo, hi, TN):
                qt = q[n0:min(hi, n0 + TN), qb * bsize:(qb + 1) * bsize]
                for t in acc:
                    pb = plan["slot_p"][grp, t]
                    pt = p[n0:min(hi, n0 + TN), pb * bsize:(pb + 1) * bsize]
                    acc[t] += pt.t() @ qt
            for t, d in acc.items():
                out[r, plan["slot_e"][grp, t]] = d.t() if plan["by_c"] else d
    return bk.updat_reduce_plain(out), runs


@pytest.mark.parametrize("bsize,shape,N,splits", [
    (32, (6, 4), 1100, 2), (32, (3, 9), 200, 1), (64, (3, 2), 130, 1),
    (128, (2, 3), 1200, 2)])
@pytest.mark.parametrize("transpose", [False, True])
def test_updat_wgmma_decomposition_matches_plain(bsize, shape, N, splits,
                                                  transpose):
    lay = _layout("random", *shape, seed=bsize)
    op = BlocksparseMatMul(lay.T.copy() if transpose else lay,
                           block_size=bsize, feature_axis=1)
    rng = np.random.RandomState(N)
    x = torch.from_numpy(rng.uniform(-1, 1, (N, op.C)).astype(np.float32))
    dy = torch.from_numpy(rng.uniform(-1, 1, (N, op.K)).astype(np.float32))
    dw, runs = _replay_updat(x, dy, op._plan("updat", "u"), bsize, splits)
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


# N: the train step (8 x 2048), prefill (bsmm's largest serving N), the
# decode (4 prompts), the conv (32 x 32 x 32), the MoE's capacity (2,560),
# the pipeline's microbatch (2 x 2048)
PATH_NS = (16384, 8192, 4, 32768, 2560, 4096)


def test_xprop_route_rule_at_the_path_shapes():
    """The kernel of each unsplit bf16 product, 132 SMs: where its tiles
    (ceil(N / 128) x groups of 256 features) number at least 0.30 x 132
    (40), bsmm_xprop_sparse.cu at b32 whatever a staged x tile's share of
    the columns (the LM's layouts: 4.36); where they number at least 0.48
    x 132 (64), bsmm_xprop_wgmma.cu at b64, and at b128 where the share
    is at least 3; else bsmm_xprop_mma.cu."""
    bsmm1, bsmm2 = _flagship()
    share = bsmm1._plan("wgmma", "f")["share"]
    assert abs(share - 4.359) < 1e-3
    assert [bsmm2._plan("wgmma", d)["share"] for d in "fb"] == \
        [bsmm1._plan("wgmma", d)["share"] for d in "bf"]
    want = {  # N: (bsmm1 fprop, bsmm1 bprop = bsmm2 fprop)
        16384: ("sparse", "sparse"), 8192: ("sparse", "sparse"),
        4: ("mma", "mma"), 32768: ("sparse", "sparse"),
        2560: ("sparse", "sparse"), 4096: ("sparse", "sparse")}
    for N in PATH_NS:
        got = (bk.xprop_kernel(N, 32, bsmm1.KB, 132, share),
               bk.xprop_kernel(N, 32, bsmm1.CB, 132, share))
        assert got == want[N], N
        assert (bsmm1._xkernel(N, "f", 132), bsmm2._xkernel(N, "f", 132)) \
            == got
    # decode takes the split route, on bsmm_xprop_mma.cu's clusters
    assert bsmm1.kernel_of(4, "f", sm_count=132) == "bsmm_xprop_mma"
    assert bsmm1.kernel_of(16384, "f", sm_count=132) == "bsmm_xprop_sparse"
    assert bsmm1.kernel_of(16384, "b", torch.float32, 132) == "bsmm_fprop"
    for b in (8, 16):       # on the mma.sync kernel at any N
        assert bk.xprop_kernel(1 << 20, b, 64, 132, 8.0) == "mma"
    assert bk.xprop_kernel(128 * 64, 64, 4, 132, 4.0) == "wgmma"  # 64 tiles
    assert bk.xprop_kernel(128 * 63, 64, 4, 132, 4.0) == "mma"
    assert bk.xprop_kernel(640, 32, 64, 132, 4.4) == "sparse"   # 5 x 8
    assert bk.xprop_kernel(512, 32, 64, 132, 4.4) == "mma"      # 4 x 8
    assert bk.xprop_kernel(16384, 32, 64, 132, 3.0) == "sparse"
    assert bk.xprop_kernel(16384, 32, 64, 132, 2.99) == "sparse"
    assert bk.xprop_kernel(2048, 64, 128, 132, 1.49) == "wgmma"
    assert bk.xprop_kernel(16384, 128, 64, 132, 3.0) == "wgmma"
    assert bk.xprop_kernel(16384, 128, 64, 132, 2.99) == "mma"


def test_xprop_route_rule_at_the_conv_and_packed_shapes():
    """The conv's tap-tiled fprop (C=512, d 0.25: 2.45 columns an x tile),
    its bprop (each input block's 9 taps in one group: 5.2), both at
    C=2048, and bench.py's random 8192² b32 op at d 0.25 (2.26) go to
    bsmm_xprop_sparse.cu."""
    rng = np.random.RandomState(0)
    cb = 16
    lay = (rng.rand(cb, cb) < 0.25).astype(np.int32)
    lay[np.arange(cb), np.arange(cb)] = 1
    conv = BlocksparseMatMul(np.repeat(lay, 9, axis=0), block_size=32,
                             feature_axis=0)     # rows (cb, tap), as the conv
    shares = [conv._plan("wgmma", d)["share"] for d in "fb"]
    assert shares[0] < bk.XPROP_WG_MIN_SHARE < shares[1]
    assert [conv._xkernel(32768, d, 132) for d in "fb"] == ["sparse"] * 2
    assert conv.kernel_of(32768, "f", sm_count=132) == "bsmm_xprop_sparse"
    wide = (rng.rand(64, 64) < 0.25).astype(np.int32)     # C=2048
    wide[np.arange(64), np.arange(64)] = 1
    conv = BlocksparseMatMul(np.repeat(wide, 9, axis=0), block_size=32,
                             feature_axis=0)
    assert [conv._xkernel(32768, d, 132) for d in "fb"] == ["sparse"] * 2
    rand = (rng.rand(256, 256) < 0.25).astype(np.int32)
    op = BlocksparseMatMul(rand, block_size=32, feature_axis=0)
    assert [op._xkernel(2048, d, 132) for d in "fb"] == ["sparse"] * 2


def test_updat_route_and_split_at_the_path_shapes():
    """The updat's kernel and its N split, 132 SMs: without the sparse
    plan's tiles the wgmma kernel's one resident thread block an SM sets a
    target of 264 thread blocks, 4 runs of the LM's 75 groups; of 4-8
    runs 7 fill their last wave best (525 of 528 thread blocks), of 4-5 at
    the MoE's N 5 (375 of 396).  The LM's route is bsmm_updat_sparse.cu
    (its plan's 375 tiles a token row against 633): 264 / 32 groups is 9
    runs, of 9-16 12 fill their last wave best (384 of 396).  Groups that
    fill the target alone over N >= 8192 stay on the mma.sync kernel."""
    bsmm1, bsmm2 = _flagship()
    groups = len(bsmm1._plan("updat", "u")["grp_q"])
    assert groups == 75 == len(bsmm2._plan("updat", "u")["grp_q"])
    want = {16384: 7, 8192: 7, 4: 1, 32768: 7, 2560: 5, 4096: 7}
    want_sp = {16384: 12, 8192: 12, 4: 1, 32768: 12, 2560: 5, 4096: 8}
    for N in PATH_NS:
        assert bk.updat_kernel(N, 32, groups, 132) == "wgmma"
        assert bk.updat_kernel(N, 32, groups, 132, (375, 633)) == "sparse"
        assert bk.updat_splits(N, groups, 32, 132, "wgmma") == want[N], N
        assert bk.updat_splits(N, 32, 32, 132, "sparse") == want_sp[N], N
        assert bsmm1._updat_route(N, torch.bfloat16, 132) == ("sparse",
                                                               want_sp[N])
    assert bsmm1._updat_route(16384, torch.float32, 132) == ("mma", 1)
    assert bk.updat_kernel(16384, 16, 75, 132) == "mma"
    assert bk.updat_kernel(16384, 8, 75, 132) == "mma"
    assert bk.updat_kernel(32768, 32, 1251, 132) == "mma"   # the conv C=2048
    assert bk.updat_kernel(2048, 32, 2206, 132) == "wgmma"  # bench.py's op
    assert bk.updat_kernel(8192, 64, 264, 132) == "mma"
    assert bk.updat_kernel(8191, 64, 264, 132) == "wgmma"
    assert bk.updat_kernel(32768, 64, 263, 132) == "wgmma"
    assert bk.updat_splits(16384, 16, 128, 132, "wgmma") == 16   # 264 / 16
    assert bk.updat_splits(16384, 264, 64, 132, "wgmma") == 1
    assert bk.updat_splits(16384, 263, 64, 132, "wgmma") == 2  # 526 of 528
    assert bk.updat_splits(1500, 4, 32, 132, "wgmma") == 2      # 1500 // 512
    assert bk.updat_run_rows(16384, 4, "wgmma") == 4096
    assert bk.updat_run_rows(16384, 7, "wgmma") == 2368      # 64-row stages
    assert bk.updat_run_rows(1100, 2, "wgmma") == 576
    assert bk.updat_run_rows(77, 1, "wgmma") == 77


def test_xprop_route_builds_the_wgmma_plan_only_where_it_reads_the_share():
    """The route reads the wgmma plan's share at b128 alone: deciding at
    b32 (sparse) and b64 (wgmma) builds no wgmma plan, at b128 it does
    (a group of 256 features holds two b128 columns, so a staged x tile
    serves at most 2 of them, under XPROP_WG_MIN_SHARE: mma.sync)."""
    for b, want in ((32, "sparse"), (64, "wgmma"), (128, "mma")):
        op = BlocksparseMatMul(np.ones((4, 6), np.int32), block_size=b,
                               feature_axis=1)
        assert op._xkernel(1 << 16, "f", 132) == want
        assert (("wgmma", "f", 0) in op._plans) == (b == 128), b


def test_kernel_of_names_every_route():
    bsmm1, _ = _flagship()
    assert bsmm1.kernel_of(16384, "u", sm_count=132) == "bsmm_updat_sparse"
    assert bsmm1.kernel_of(16384, "u", torch.float32, 132) == "bsmm_updat"
    fine = BlocksparseMatMul(_layout("random", 6, 4, 0), block_size=16,
                             feature_axis=1, mode="fine")
    assert fine.kernel_of(64, "f", sm_count=132) == "bsmm_fine_wgmma"
    assert fine.kernel_of(64, "u", sm_count=132) == "bsmm_updat_mma"
    win = BlocksparseMatMul(_layout("random", 6, 4, 0), block_size=32,
                            feature_axis=1, mode="window")
    assert win.kernel_of(64, "b", torch.float32, 132) == "bsmm_window"



# -------- bsmm_xprop_sparse.cu: pairs of input blocks, packed W --------

@pytest.mark.parametrize("d", ["f", "b"])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("shape", [(6, 19), (9, 40), (7, 8), (1, 9)])
def test_xprop_sparse_plan_invariants(shape, kind, d):
    """xprop_sparse_plan at b32: the wgmma plan's column groups, an item a
    pair of input blocks (the union of the group's pairs, ascending),
    every (column, entry) in exactly one (item, half, slot) with a
    column's entries in LUT order; u_pairs the (half, column pair) slots
    holding an entry; w_order the present pairs' two weight blocks each
    (-1 for an absent one) item by item, pair by pair (each layout block
    once), u_woff each item's first; with halves 1 the plan is the wgmma
    kernel's."""
    op = BlocksparseMatMul(_layout(kind, *shape, seed=sum(shape)),
                           block_size=32, feature_axis=1)
    row_ptr, ib, wb, n_out = _csr(op, d)
    G, H = bk.XPROP_WG_FEATURES // 32, bk.XPROP_SP_DEPTH // 32
    plan = bk.xprop_sparse_plan(row_ptr, ib, wb, 32)
    one = bk.xprop_wgmma_plan(row_ptr, ib, wb, 32)
    assert bk.xprop_wgmma_plan(row_ptr, ib, wb, 32, halves=1)["u_in"] \
        .tolist() == one["u_in"].tolist()
    assert (plan["G"], plan["halves"], plan["sparse"]) == (G, H, True)
    assert bk.plan_kernel(plan) == "sparse" and bk.plan_kernel(one) == "wgmma"
    u_ptr, u_in, u_mask, u_w, grp, woff, order, pairs = (plan[k] for k in (
        "u_ptr", "u_in", "u_mask", "u_w", "grp_col", "u_woff", "w_order",
        "u_pairs"))
    assert grp.tolist() == one["grp_col"].tolist()
    assert u_w.shape == (len(u_in), H * G) and woff.shape == u_in.shape
    assert all(a.dtype == np.int32
               for a in (u_ptr, u_in, u_mask, u_w, woff, pairs))
    assert order.dtype == np.int64
    mask = u_mask.view(np.uint32).astype(np.int64)
    bits = (mask[:, None] >> np.arange(H * G)) & 1
    assert ((u_w >= 0) == (bits == 1)).all() and (mask > 0).all()
    pbits = (pairs[:, None] >> np.arange(H * G // 2)) & 1
    assert (pbits == (bits[:, 0::2] | bits[:, 1::2])).all()
    assert sorted(order[order >= 0].tolist()) == sorted(wb.tolist())
    walked = {o: [] for o in range(n_out)}
    for g in range(len(grp)):
        lo, hi = u_ptr[g], u_ptr[g + 1]
        assert (np.diff(u_in[lo:hi]) > 0).all()
        pair_set = set(one["u_in"][one["u_ptr"][g]:one["u_ptr"][g + 1]] // H)
        assert set(u_in[lo:hi]) == pair_set
        for t in range(lo, hi):
            k = woff[t]
            for p in np.flatnonzero(pbits[t]):   # p = h · G / 2 + m
                h, m = divmod(p, G // 2)
                for j in (2 * m, 2 * m + 1):
                    assert order[k] == u_w[t, h * G + j]
                    if order[k] >= 0:
                        walked[grp[g, j]].append((u_in[t] * H + h, order[k]))
                    k += 1
            assert k == (woff[t + 1] if t + 1 < len(u_in) else len(order))
    for o in range(n_out):
        lo, hi = row_ptr[o], row_ptr[o + 1]
        assert walked[o] == list(zip(ib[lo:hi], wb[lo:hi]))


def test_xprop_sparse_plan_takes_b32_only():
    with pytest.raises(ValueError, match="block sizes"):
        bk.xprop_sparse_plan([0, 1], [0], [0], 64)
    with pytest.raises(ValueError, match="32-bit"):
        bk.xprop_wgmma_plan([0, 1], [0], [0], 8, halves=2)


def test_xprop_sparse_pack_lays_blocks_out_as_the_swizzle():
    """xprop_sparse_pack (its plain version on the CPU): block k of the
    pack is W[w_order[k]] (zeros for -1) with chunk c of row r at
    position c ^ (r // 2 % 4), the 64-byte swizzle's."""
    rng = np.random.RandomState(3)
    w = torch.from_numpy(rng.randn(7, 32, 32).astype(np.float32)) \
        .to(torch.bfloat16)
    order = torch.tensor([3, 0, 6, -1, 3], dtype=torch.int64)
    wp = bk.xprop_sparse_pack(w, order, 32)
    assert wp.shape == (5, 32, 32) and wp.dtype == torch.bfloat16
    for k, blk in enumerate(order.tolist()):
        src = w[blk] if blk >= 0 else torch.zeros_like(w[0])
        for r in range(32):
            for c in range(4):
                p = c ^ (r // 2 % 4)
                assert torch.equal(wp[k, r, p * 8:p * 8 + 8],
                                   src[r, c * 8:c * 8 + 8])


def _replay_sparse(x, w, plan, n_out, trans):
    """What bsmm_xprop_sparse.cu computes, in f32 on the CPU: thread block
    (group, N-tile of 128 rows, zero past N) walks its items, a stage an
    item: the x tile of the pair's 64 input features, and the item's
    present (half, column pair) slots' weight blocks read back to back
    from the packed weights (xprop_sparse_pack, undone here; a pair's
    absent block zeros) at u_woff, two a pair; k16 steps 0-1 the first
    half's pairs, 2-3 the second's, each pair's product (features x rows,
    the transpose) into its two columns' accumulators; then the tile's
    columns."""
    N, TM, G, H, b = x.shape[0], bk.XPROP_WG_TM, plan["G"], 2, 32
    wp = bk.xprop_sparse_pack(w, torch.from_numpy(plan["w_order"]), b)
    undo = torch.empty_like(wp).reshape(-1, b, b // 8, 8)
    rows = torch.arange(b)[:, None]
    undo[:, rows, torch.from_numpy(bk._swizzled_chunks(b))] = \
        wp.reshape(-1, b, b // 8, 8)
    blocks = undo.reshape(-1, b, b)
    y = torch.full((N, n_out * b), float("nan"))
    for g, cols in enumerate(plan["grp_col"]):
        for n0 in range(0, N, TM):
            xt = torch.zeros((TM, x.shape[1] + b))       # the pair past C: 0
            xt[:min(TM, N - n0), :x.shape[1]] = x[n0:n0 + TM]
            acc = torch.zeros((G, TM, b))
            for t in range(plan["u_ptr"][g], plan["u_ptr"][g + 1]):
                pairs = int(plan["u_pairs"][t])
                xs = xt[:, plan["u_in"][t] * 64:plan["u_in"][t] * 64 + 64]
                k = plan["u_woff"][t]
                for p in range(H * G // 2):
                    if pairs >> p & 1:
                        h, m = divmod(p, G // 2)
                        a = torch.cat([blocks[k].t() if not trans
                                       else blocks[k],
                                       blocks[k + 1].t() if not trans
                                       else blocks[k + 1]])     # (64, 32)
                        k += 2
                        d = a @ xs[:, h * b:(h + 1) * b].t()      # (64, TM)
                        acc[2 * m] += d[:b].t()
                        acc[2 * m + 1] += d[b:].t()
            for j, o in enumerate(cols):
                if o >= 0:
                    y[n0:n0 + TM, o * b:(o + 1) * b] = acc[j, :min(TM, N - n0)]
    return y


@pytest.mark.parametrize("d", ["f", "b"])
@pytest.mark.parametrize("shape,kind,N", [
    ((6, 19), "random", 300), ((9, 40), "empty_column", 129),
    ((7, 13), "banded", 200), ((3, 9), "dense", 5)])
def test_xprop_sparse_decomposition_matches_plain(shape, kind, N, d):
    op = BlocksparseMatMul(_layout(kind, *shape, seed=11), block_size=32,
                           feature_axis=1)
    row_ptr, ib, wb, n_out = _csr(op, d)
    rng = np.random.RandomState(N + sum(shape))
    x = torch.from_numpy(rng.uniform(-1, 1, (N, (op.C if d == "f" else op.K))
                                     ).astype(np.float32))
    w = torch.from_numpy(rng.uniform(-1, 1, op.w_shape).astype(np.float32))
    y = _replay_sparse(x, w, bk.xprop_sparse_plan(row_ptr, ib, wb, 32),
                       n_out, d == "b")
    lut = op._lut(torch.device("cpu"))
    ref = bk.xprop_plain(x, w, lut[f"{d}_in"], lut[f"{d}_w"], lut[f"{d}_out"],
                         n_out, 32, 1, trans_w=d == "b")
    scale = ref.abs().max().item()
    torch.testing.assert_close(y, ref, rtol=0, atol=F32_TOL * scale)
    import jax.numpy as jnp
    from blocksparse_tpu.kernels import bsmm as jax_bsmm
    jref = jax_bsmm.xprop_xla(
        jnp.asarray(x.numpy()), jnp.asarray(w.numpy()),
        jnp.asarray(lut[f"{d}_in"].numpy()),
        jnp.asarray(lut[f"{d}_w"].numpy()),
        jnp.asarray(lut[f"{d}_out"].numpy()), n_out, 32, 1, d == "b")
    np.testing.assert_allclose(y.numpy(), np.asarray(jref), rtol=0,
                               atol=F32_TOL * scale)


def non_finite_block(op, d):
    """(i, reads, partners) for an infinity in x's input block i of
    direction d: the output block-columns with an LUT entry at i (which
    every kernel and the plain version make non-finite in its row), and
    those paired with one of them in ``xprop_sparse_plan``'s groups
    (slots 2m, 2m + 1) that have none there (``bsmm_xprop_sparse.cu``
    meets the infinity through the pair's zero block: NaN); the first i
    with such a partner."""
    row_ptr, ib, wb, n_out = _csr(op, d)
    pairs = bk.xprop_sparse_plan(row_ptr, ib, wb, 32)["grp_col"].reshape(
        -1, 2)
    for i in range(op.CB if d == "f" else op.KB):
        reads = {c for c in range(n_out)
                 if i in ib[row_ptr[c]:row_ptr[c + 1]]}
        partners = {int(p[1 - j]) for p in pairs for j in (0, 1)
                    if p[j] in reads and p[1 - j] >= 0
                    and p[1 - j] not in reads}
        if partners:
            return i, reads, partners
    raise AssertionError("no input block with an absent partner")


def non_finite_columns(y, row, bsize=32):
    """The output block-columns of ``row`` whose every element is not
    finite; asserts that no column is partly so."""
    bad = ~torch.isfinite(y[row].float().reshape(-1, bsize))
    assert torch.equal(bad.any(1), bad.all(1))
    return set(torch.nonzero(bad.all(1)).flatten().tolist())


@pytest.mark.parametrize("d", ["f", "b"])
def test_xprop_sparse_decomposition_spreads_a_non_finite_input(d):
    """An infinity in x at one input block: the plain version makes its
    row non-finite in the output columns with an entry at that block;
    the sparse kernel's decomposition also, as NaN, in the columns paired
    with one of those that have none (the pair's zero block times the
    infinity), and nowhere else."""
    op = BlocksparseMatMul(_layout("random", 9, 40, seed=12), block_size=32,
                           feature_axis=1)
    row_ptr, ib, wb, n_out = _csr(op, d)
    i, reads, partners = non_finite_block(op, d)
    rng = np.random.RandomState(12)
    x = torch.from_numpy(rng.uniform(-1, 1, (40, (op.C if d == "f" else op.K))
                                     ).astype(np.float32))
    w = torch.from_numpy(rng.uniform(-1, 1, op.w_shape).astype(np.float32))
    x[3, i * 32 + 5] = float("inf")
    y = _replay_sparse(x, w, bk.xprop_sparse_plan(row_ptr, ib, wb, 32),
                       n_out, d == "b")
    lut = op._lut(torch.device("cpu"))
    ref = bk.xprop_plain(x, w, lut[f"{d}_in"], lut[f"{d}_w"], lut[f"{d}_out"],
                         n_out, 32, 1, trans_w=d == "b")
    assert non_finite_columns(ref, 3) == reads
    assert non_finite_columns(y, 3) == reads | partners
    assert torch.isnan(y[3].reshape(-1, 32)[sorted(partners)]).all()
    assert torch.isfinite(torch.cat([y[:3], y[4:]])).all()
