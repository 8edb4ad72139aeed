"""The port's schedule modes of BlocksparseMatMul against the JAX package.

On the CPU the port runs the plain versions whatever the mode; the card
runs ``bsmm_fine`` (``mode="fine"``), ``bsmm_window`` (``mode="window"``)
or the split route (in bf16/f16 one ``bsmm_split`` launch whose
thread-block clusters sum a column's runs; in f32 partial tiles, then
``bsmm_merge``) from host-side plans built here.  These tests hold on
the CPU what does not need the card:

- ``make_mask`` (the canonical bench's small-world layouts) equals the
  JAX package's networkx-built one;
- the fine, window and split plans cover every LUT entry once, in LUT
  order within each output column, and the merge index runs in phase
  order, then the sentinel; the tensor-core window kernel's N-tile rule
  (``window_tn``) by value;
- the fused split's cluster mapping at the LM's decode and the canonical
  bench's shapes, at every block size: rank r of column o's cluster
  names the column's r-th run, in phase order, or the sentinel's empty
  run, and a cluster holds at most ``SPLIT_MAX_PHASES`` blocks; its
  wrapper refuses CPU tensors and f32;
- ``merge_plain`` equals JAX ``merge_phased_tiles`` (Pallas interpret)
  on a phased cover from ``build_dense_tile_schedule_phased``: exactly in
  f32 (both add the same f32 tiles in the same order);
- the plain split route equals ``xprop_plain`` within 1e-5 in f32 (the
  same products, summed as runs and then across runs);
- ``mode="fine"`` and ``mode="window"`` ops equal JAX's same-mode ops
  with ``impl="pallas"`` (its fine and window-slab kernels in interpret
  mode), outputs and autograd gradients, within 1e-4 in f32 relative to
  each tensor's scale (the TPU kernels sum 128-deep chunks in other
  orders).
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from blocksparse_tpu import BlocksparseMatMul as JaxBSMM
from blocksparse_tpu.kernels import bsmm as jax_kernels
from blocksparse_tpu.models.sparse_lstm import make_mask as jax_make_mask
from blocksparse_tpu_torch import BlocksparseMatMul
from blocksparse_tpu_torch.kernels import bsmm as bsmm_kernels
from blocksparse_tpu_torch.models.sparse_lstm import make_mask

torch.set_num_threads(2)
F32_TOL = 1e-5
MODE_TOL = 1e-4


def random_layout(CB, KB, density, seed):
    rng = np.random.RandomState(seed)
    layout = (rng.rand(CB, KB) < density).astype(np.int32)
    layout[np.arange(CB), np.arange(CB) % KB] = 1
    layout[np.arange(KB) % CB, np.arange(KB)] = 1
    return layout


@pytest.mark.parametrize("n,kind,seed", [
    (16, "dense", 0), (24, "ba_3", 0), (60, "ba_7", 1), (97, "ba_1", 2),
    (40, "ws_2_20", 0), (64, "ws_5_50", 3), (33, "ws_1_100", 4),
    (12, "ws_6_20", 5)])
def test_make_mask_equals_jax(n, kind, seed):
    got, want = make_mask(n, kind, seed), jax_make_mask(n, kind, seed)
    assert got.dtype == np.int32 and got.shape == (n, n)
    np.testing.assert_array_equal(got, want)


def _csr_op(seed=0, CB=37, KB=11, bsize=8, axis=1):
    """An op whose layout has an empty output column, an empty input row
    and long columns."""
    layout = random_layout(CB, KB, 0.45, seed)
    layout[:, 4] = 0
    layout[CB // 2, :] = 0
    return BlocksparseMatMul(layout, block_size=bsize, feature_axis=axis)


def _lut_rows(op, d):
    row_ptr, (ib, wb, _), n_out, n_in = op._csr(d)
    return [list(zip(ib[row_ptr[o]:row_ptr[o + 1]].tolist(),
                     wb[row_ptr[o]:row_ptr[o + 1]].tolist()))
            for o in range(n_out)], n_in


@pytest.mark.parametrize("d", ["f", "b"])
@pytest.mark.parametrize("bsize", [8, 16, 32])
def test_fine_plan_covers_the_lut_in_order(bsize, d):
    op = _csr_op(bsize=bsize)
    rows, _ = _lut_rows(op, d)
    plan = op._plan("fine", d)
    gf = 128 // bsize
    assert plan["slot_in"].shape[1] == gf
    for o, lut in enumerate(rows):
        c0, c1 = plan["chunk_ptr"][o:o + 2]
        assert c1 - c0 == -(-len(lut) // gf)           # 0 for an empty one
        got = [(int(i), int(w)) for i, w in zip(
            plan["slot_in"][c0:c1].ravel(), plan["slot_w"][c0:c1].ravel())
            if i >= 0]
        assert got == lut
        pad = plan["slot_in"][c0:c1].ravel()[len(lut):]
        assert (pad == -1).all() and len(pad) < gf
        assert (plan["slot_w"][c0:c1].ravel()[len(lut):] == -1).all()


@pytest.mark.parametrize("d", ["f", "b"])
@pytest.mark.parametrize("bsize,CB", [(8, 70), (16, 37), (32, 20),
                                      (64, 9), (128, 5)])
def test_window_plan_covers_the_lut_in_order(bsize, CB, d):
    """Window counts that do not divide the input blocks (70 blocks of b8
    in windows of 32, 37 of b16 in 16, ...), an empty column."""
    op = _csr_op(CB=CB, KB=19, bsize=bsize)
    rows, n_in = _lut_rows(op, d)
    plan = op._plan("window", d)
    wb, sg, nwin = plan["WB"], plan["SG"], plan["nwin"]
    assert wb * bsize == bsmm_kernels.WINDOW_SLAB
    assert sg == bsmm_kernels.WINDOW_SG[bsize] and nwin == -(-n_in // wb)
    ptr = plan["ptr"]
    assert len(ptr) == -(-len(rows) // sg) * nwin * sg + 1
    assert ptr[-1] == sum(map(len, rows)) and (np.diff(ptr) >= 0).all()
    for o, lut in enumerate(rows):
        got = []
        for win in range(nwin):
            k = ((o // sg) * nwin + win) * sg + o % sg
            for e in range(ptr[k], ptr[k + 1]):
                assert plan["ent_lo"][e] == o % sg
                got.append((win * wb + int(plan["ent_slot"][e]),
                            int(plan["ent_w"][e])))
        assert got == lut
    # a super-group's entries run window by window, in each window column
    # by column: the tensor-core kernel walks them as one run in stages
    lo = plan["ent_lo"]
    for k in range(0, len(ptr) - 1, sg):
        assert (np.diff(lo[ptr[k]:ptr[k + sg]]) >= 0).all()


@pytest.mark.parametrize("N,n_sg,sms,tn", [
    (2048, 32, 132, 128),    # window regime N 2048: 16 x 32 blocks
    (256, 32, 132, 32),      # N 256: 4 x 32 = 128 < 132 at TN 64
    (64, 60, 132, 16),       # canonical hidden 7680 b8: 4 x 60 blocks
    (64, 30, 132, 16),       # canonical b32: no tile fills, the smallest
    (4224, 1, 132, 32),      # ceil(4224 / 32) = 132
    (300, 132, 132, 128),
    (1, 200, 132, 128),
    (256, 32, 30, 128)])     # fewer SMs: a larger tile fills them
def test_window_tn_rule(N, n_sg, sms, tn):
    """The tensor-core window kernel's N-tile: the largest of 128, 64, 32
    and 16 whose grid ceil(N / TN) x n_sg fills the SMs, else 16."""
    assert bsmm_kernels.WINDOW_TNS == (128, 64, 32, 16)
    assert bsmm_kernels.window_tn(N, n_sg, sms) == tn


@pytest.mark.parametrize("d", ["f", "b"])
@pytest.mark.parametrize("phases", [2, 3, 8])
def test_split_plan_runs_and_merge_index(phases, d):
    op = _csr_op(seed=3, CB=40, KB=13)
    rows, _ = _lut_rows(op, d)
    plan = op._plan("split", d, phases)
    tp, idx, T = plan["tile_ptr"], plan["merge_idx"], plan["tiles"] - 1
    assert len(tp) == T + 2 and tp[T] == tp[T + 1] == sum(map(len, rows))
    ent = np.arange(tp[-1])
    seen = []
    for o, lut in enumerate(rows):
        ids = [t for t in idx[o] if t != T]
        # tile ids of a column in phase order, then only the sentinel
        assert ids == sorted(ids) and list(idx[o][len(ids):]) == \
            [T] * (idx.shape[1] - len(ids))
        expect = 0 if not lut else max(
            1, min(phases, len(lut) // bsmm_kernels.SPLIT_MIN_PHASE))
        assert len(ids) == expect
        run = np.concatenate([ent[tp[t]:tp[t + 1]] for t in ids]) \
            if ids else np.zeros(0, int)
        # consecutive runs covering the column's entries in LUT order
        start = tp[ids[0]] if ids else 0
        np.testing.assert_array_equal(run, np.arange(start, start + len(lut)))
        assert all(tp[t + 1] - tp[t] >= min(len(lut),
                                           bsmm_kernels.SPLIT_MIN_PHASE)
                   for t in ids)
        seen.extend(ids)
    assert sorted(seen) == list(range(T))
    assert idx.shape[1] == max(1, max(
        (len(ids) for ids in ([t for t in r if t != T] for r in idx))))


def test_split_rule():
    """Split only below the SM count and for columns of >= 8 entries; P =
    min(8, ceil(SMs / grid), longest // 4)."""
    layout = np.ones((32, 10), np.int32)             # columns of 32 entries
    op = BlocksparseMatMul(layout, block_size=32, feature_axis=1)
    tm = bsmm_kernels.XPROP_TM[32]
    assert op._phases(tm, "f", 132) == 8             # grid 10: ceil(132/10)
    assert op._phases(tm, "f", 30) == 3              # ceil(30 / 10)
    assert op._phases(13 * tm, "f", 132) == 2        # grid 130
    assert op._phases(14 * tm, "f", 132) == 0        # grid 140 >= 132
    assert op._phases(tm, "b", 132) == 2             # 10 entries: 10 // 4
    short = BlocksparseMatMul(np.eye(8, dtype=np.int32) + np.roll(
        np.eye(8, dtype=np.int32), 1, axis=1), block_size=16, feature_axis=1)
    assert short._phases(4, "f", 132) == 0           # 2 entries a column


def test_dispatch_mode_names_the_route():
    layout = np.ones((32, 10), np.int32)
    kw = dict(block_size=32, feature_axis=1)
    assert BlocksparseMatMul(layout, **kw).dispatch_mode(
        4, sm_count=132) == "phased"
    assert BlocksparseMatMul(layout, **kw).dispatch_mode(
        4096, sm_count=132) == "grouped"
    assert BlocksparseMatMul(layout, mode="grouped", **kw).dispatch_mode(
        4, sm_count=132) == "grouped"
    assert BlocksparseMatMul(layout, mode="dense_tile", **kw).dispatch_mode(
        4, sm_count=132) == "phased"
    assert BlocksparseMatMul(layout, mode="fine", **kw).dispatch_mode(
        4096, sm_count=132) == "fine"
    assert BlocksparseMatMul(layout, mode="window", **kw).dispatch_mode(
        4, sm_count=132) == "window"
    # fine takes b8-b32; a larger block acts as auto
    big = BlocksparseMatMul(np.ones((16, 2), np.int32), block_size=64,
                            mode="fine", feature_axis=1)
    assert big.dispatch_mode(8, sm_count=132) == "phased"


def test_merge_plain_equals_jax_merge_phased_tiles():
    """A phased cover as tests/test_matmul.py builds it; random f32 group
    tiles merged by the JAX Pallas kernel (interpret) and by merge_plain
    on the same tiles in the NC orientation, the zero tile appended."""
    rng = np.random.RandomState(0)
    n, b, N = 24, 32, 128
    lay = (rng.rand(n, n) < 0.3).astype(np.int32)
    lay[np.arange(n), np.arange(n)] = 1
    rows = [[] for _ in range(n)]
    wid = 0
    for cb in range(n):
        for kb in range(n):
            if lay[cb, kb]:
                rows[kb].append((cb, wid))
                wid += 1
    sch = jax_kernels.build_dense_tile_schedule_phased(rows, n, b, wid,
                                                       thresholds=(2,))
    idx = jax_kernels.phased_merge_idx(sch)
    assert idx.shape[1] > 1
    groups, R = sch.rows_at.shape
    tiles = rng.uniform(-1, 1, (groups * R * b, N)).astype(np.float32)
    want = np.asarray(jax_kernels.merge_phased_tiles(
        jnp.asarray(tiles), sch, b, N, jnp.float32))
    nc = np.concatenate([tiles, np.zeros((b, N), np.float32)]).T
    got = bsmm_kernels.merge_plain(torch.from_numpy(np.ascontiguousarray(nc)),
                                   torch.from_numpy(idx.astype(np.int64)), b)
    np.testing.assert_array_equal(got.numpy(), want.T)
    half = bsmm_kernels.merge_plain(torch.from_numpy(np.ascontiguousarray(nc)),
                                    torch.from_numpy(idx.astype(np.int64)), b,
                                    out_dtype=torch.bfloat16)
    assert half.dtype == torch.bfloat16
    torch.testing.assert_close(half, got.bfloat16(), rtol=0, atol=0)


@pytest.mark.parametrize("axis", [1, 0])
@pytest.mark.parametrize("d", ["f", "b"])
def test_split_route_plain_matches_xprop_plain(d, axis):
    op = _csr_op(seed=5, CB=40, KB=13, bsize=16, axis=axis)
    rng = np.random.RandomState(6)
    N = 20
    shape = (N, op.C if d == "f" else op.K)
    x = torch.from_numpy(rng.uniform(-1, 1, shape).astype(np.float32))
    x = x if axis else x.t().contiguous()
    w = torch.from_numpy(rng.uniform(-1, 1, op.w_shape).astype(np.float32))
    assert op._phases(N, d, 132) > 1
    got = op.xprop_split_plain(x, w, d, sm_count=132)
    want = op._xprop(x, w, d)
    assert got.shape == want.shape and got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=0, atol=F32_TOL * max(
        1.0, want.abs().max().item()))
    with pytest.raises(ValueError):
        op.xprop_split_plain(x, w, d, sm_count=1)


def _lm_mlp_layout(bsize, n_embd=512, ratio=4, density=0.5):
    """The LM's MLP layout (``SparseTransformerLM``: RandomState(0), no
    empty row or column) for its 512 -> 2048 product at ``bsize``."""
    CB, KB = n_embd // bsize, ratio * n_embd // bsize
    lay = (np.random.RandomState(0).rand(CB, KB) < density).astype(np.int32)
    lay[np.arange(CB), np.arange(CB) % KB] = 1
    lay[np.arange(KB) % CB, np.arange(KB)] = 1
    return lay


# (name, layout at a block size, N): the LM's MLP products at decode
# (batch 4) and the canonical bench's hidden-2560 dense row (N 64)
_SPLIT_SHAPES = {
    "bsmm1": (lambda b: _lm_mlp_layout(b), 4),
    "bsmm2": (lambda b: _lm_mlp_layout(b).T.copy(), 4),
    "canonical2560": (lambda b: np.ones((2560 // b, 2560 // b), np.int32), 64)}


@pytest.mark.parametrize("bsize", bsmm_kernels.BLOCK_SIZES)
@pytest.mark.parametrize("shape", list(_SPLIT_SHAPES))
def test_split_cluster_mapping(shape, bsize):
    """bsmm_split launches a cluster of P thread blocks a (N-tile, output
    column o), rank r running run merge_idx[o, r]: for r below the
    column's run count the column's r-th run (consecutive runs covering
    its LUT entries in order), past it the sentinel's empty run; P <= 8
    (a portable cluster) on an H100's 132 SMs, fprop and bprop."""
    make, N = _SPLIT_SHAPES[shape]
    op = BlocksparseMatMul(make(bsize), block_size=bsize, feature_axis=1)
    for d in "fb":
        phases = op._phases(N, d, 132)
        if not phases:
            continue
        plan = op._plan("split", d, phases)
        row_ptr = op._csr(d)[0]
        tp, idx, T = plan["tile_ptr"], plan["merge_idx"], plan["tiles"] - 1
        P = idx.shape[1]
        assert 1 <= P <= phases <= bsmm_kernels.SPLIT_MAX_PHASES == 8
        assert tp[T] == tp[T + 1]                  # the sentinel: no entries
        for o in range(len(row_ptr) - 1):
            n_runs = int((idx[o] != T).sum())
            assert (idx[o, n_runs:] == T).all()
            runs = [np.arange(tp[t], tp[t + 1]) for t in idx[o, :n_runs]]
            got = np.concatenate(runs) if runs else np.zeros(0, np.int64)
            np.testing.assert_array_equal(
                got, np.arange(row_ptr[o], row_ptr[o + 1]))
            assert all(len(r) > 0 for r in runs)
    if shape == "bsmm2" and bsize == 32:
        # the LM's decode: bsmm2 (64 entries a column, 16 columns) in 8 runs
        assert op._phases(N, "f", 132) == 8
        assert op._plan("split", "f", 8)["merge_idx"].shape[1] == 8


def test_split_wrapper_refuses_cpu_and_f32():
    """bsmm_split launches a CUDA kernel or raises: a CPU tensor, f32 (the
    f32 split route is bsmm_partials + bsmm_merge) and a cluster of more
    than 8 blocks are refused before any launch."""
    op = BlocksparseMatMul(np.ones((16, 2), np.int32), block_size=16,
                           feature_axis=1)
    plan = {k: torch.as_tensor(v) for k, v in
            op._plan("split", "f", 4).items() if isinstance(v, np.ndarray)}
    lut = op._lut(torch.device("cpu"))
    w = torch.zeros(op.w_shape, dtype=torch.bfloat16)
    x = torch.zeros((4, op.C), dtype=torch.bfloat16)
    args = (plan["tile_ptr"], lut["f_ent_in"], lut["f_ent_w"])
    before = bsmm_kernels.bsmm_split.launches
    with pytest.raises(ValueError, match="CUDA"):
        bsmm_kernels.bsmm_split(x, w, *args, plan["merge_idx"], 16, 2)
    with pytest.raises(TypeError, match="f32"):
        bsmm_kernels.bsmm_split(x.float(), w.float(), *args,
                                plan["merge_idx"], 16, 2)
    with pytest.raises(ValueError, match="P <= 8"):
        bsmm_kernels.bsmm_split(x, w, *args, plan["merge_idx"].repeat(1, 5),
                                16, 2)
    assert bsmm_kernels.bsmm_split.launches == before


def _mode_pair(layout, bsize, mode, seed, N):
    ref = JaxBSMM(layout, block_size=bsize, feature_axis=1, impl="pallas",
                  mode=mode)
    port = BlocksparseMatMul(layout, block_size=bsize, feature_axis=1,
                             mode=mode)
    rng = np.random.RandomState(seed)
    X = rng.uniform(-1, 1, (N, port.C)).astype(np.float32)
    W = rng.uniform(-1, 1, port.w_shape).astype(np.float32)
    G = rng.uniform(-1, 1, (N, port.K)).astype(np.float32)
    y_ref, vjp = jax.vjp(ref, jnp.asarray(X), jnp.asarray(W))
    dx_ref, dw_ref = vjp(jnp.asarray(G))
    x = torch.from_numpy(X).requires_grad_()
    w = torch.from_numpy(W).requires_grad_()
    y = port(x, w)
    y.backward(torch.from_numpy(G))
    for got, want in ((y.detach(), y_ref), (x.grad, dx_ref), (w.grad, dw_ref)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=MODE_TOL * max(1.0, np.abs(want).max()))
    return ref


@pytest.mark.parametrize("bsize", [8, 16])
def test_fine_mode_matches_jax_fine_kernel(bsize):
    layout = random_layout(10, 7, 0.5, seed=bsize)
    layout[:, 3] = 0                                  # an empty column
    layout[0, 3] = 1
    ref = _mode_pair(layout, bsize, "fine", seed=bsize, N=48)
    assert ref.dispatch_mode(48, 4) == "fine"


def test_window_mode_matches_jax_window_kernel():
    """b16 with 136 input blocks: JAX's fprop windows of 128 blocks (and
    the port's of 16) do not divide them."""
    layout = random_layout(136, 4, 0.2, seed=7)
    ref = _mode_pair(layout, 16, "window", seed=8, N=24)
    assert ref.dispatch_mode(24, 4) == "window"
    assert ref.fprop_dt.num_windows == 2 and 136 % ref.fprop_dt.WB
    port = BlocksparseMatMul(layout, block_size=16, feature_axis=1,
                             mode="window")
    assert port._plan("window", "f")["nwin"] == 9     # 136 / 16
