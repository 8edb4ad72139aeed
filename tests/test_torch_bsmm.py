"""The port's BlocksparseMatMul, forward and backward, against the JAX
package's.

On the CPU the port runs the plain versions (the torch ports of
``xprop_xla`` and ``updat_xla``); they are held against JAX
``impl="xla"``, JAX ``impl="pallas"`` (interpret mode) and the NumPy
goldens ``fprop_test``/``bprop_test``/``updat_test``, and the autograd
gradients against ``jax.vjp`` of the JAX op.  f32 tolerance 1e-5 (both
sides sum the same f32 products, in other orders); bf16 tolerance 1e-2
relative to the output's scale (one bf16 rounding of the output, 2^-8,
plus order; dw is f32 on both sides, from the same bf16 inputs).  The
CUDA kernels are held against the plain versions in test_torch_cuda.py.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from blocksparse_tpu import BlocksparseMatMul as JaxBSMM
from blocksparse_tpu_torch import BlocksparseMatMul
from blocksparse_tpu_torch.kernels import bsmm as bsmm_kernels

torch.set_num_threads(2)
F32_TOL = 1e-5
BF16_TOL = 1e-2


def random_layout(CB, KB, density, seed):
    rng = np.random.RandomState(seed)
    layout = (rng.rand(CB, KB) < density).astype(np.int32)
    layout[np.arange(CB), np.arange(CB) % KB] = 1
    layout[np.arange(KB) % CB, np.arange(KB)] = 1
    return layout


@pytest.mark.parametrize("axis", [1, 0])
@pytest.mark.parametrize("bsize", [8, 16, 32, 64])
def test_fprop_matches_jax(bsize, axis):
    layout = random_layout(4, 6, 0.4, seed=bsize + axis)
    N = 48
    port = BlocksparseMatMul(layout, block_size=bsize, feature_axis=axis)
    rng = np.random.RandomState(bsize)
    X = rng.uniform(-1, 1, port.i_shape(N)).astype(np.float32)
    W = rng.uniform(-1, 1, port.w_shape).astype(np.float32)
    y = port(torch.from_numpy(X), torch.from_numpy(W)).numpy()
    np.testing.assert_allclose(y, port.fprop_test(X, W), rtol=F32_TOL,
                               atol=F32_TOL)
    for impl in ("xla", "pallas"):
        ref = JaxBSMM(layout, block_size=bsize, feature_axis=axis, impl=impl)
        y_ref = np.asarray(ref(jnp.asarray(X), jnp.asarray(W)))
        np.testing.assert_allclose(y, y_ref, rtol=F32_TOL, atol=F32_TOL,
                                   err_msg=impl)


def test_fprop_3d_input_matches_jax():
    """(B, L, C) input is flattened around the feature axis as
    ``_flatten_io`` does, and the output restored to (B, L, K)."""
    layout = random_layout(4, 8, 0.5, seed=3)
    port = BlocksparseMatMul(layout, block_size=16, feature_axis=1)
    ref = JaxBSMM(layout, block_size=16, feature_axis=1, impl="xla")
    rng = np.random.RandomState(1)
    X = rng.uniform(-1, 1, (3, 10, port.C)).astype(np.float32)
    W = rng.uniform(-1, 1, port.w_shape).astype(np.float32)
    y = port(torch.from_numpy(X), torch.from_numpy(W)).numpy()
    y_ref = np.asarray(ref(jnp.asarray(X), jnp.asarray(W)))
    assert y.shape == (3, 10, port.K) == y_ref.shape
    np.testing.assert_allclose(y, y_ref, rtol=F32_TOL, atol=F32_TOL)


def test_fprop_bf16_matches_jax():
    layout = random_layout(4, 8, 0.5, seed=5)
    port = BlocksparseMatMul(layout, block_size=32, feature_axis=1)
    ref = JaxBSMM(layout, block_size=32, feature_axis=1, impl="xla")
    rng = np.random.RandomState(2)
    X = rng.uniform(-1, 1, (40, port.C)).astype(np.float32)
    W = rng.uniform(-1, 1, port.w_shape).astype(np.float32)
    y = port(torch.from_numpy(X).bfloat16(), torch.from_numpy(W).bfloat16())
    assert y.dtype == torch.bfloat16
    y_ref = np.asarray(ref(jnp.asarray(X, jnp.bfloat16),
                           jnp.asarray(W, jnp.bfloat16)).astype(jnp.float32))
    scale = np.abs(y_ref).max()
    np.testing.assert_allclose(y.float().numpy(), y_ref, rtol=0,
                               atol=BF16_TOL * scale)


def test_empty_output_block_column_is_zero():
    layout = np.zeros((3, 4), np.int32)
    layout[0, 0] = layout[2, 1] = layout[1, 3] = 1      # column 2 empty
    port = BlocksparseMatMul(layout, block_size=8, feature_axis=1)
    X = torch.ones((5, port.C))
    W = torch.ones(port.w_shape)
    y = port(X, W)
    assert (y[:, 16:24] == 0).all() and (y[:, :8] == 8).all()


def test_rejects_what_it_does_not_take():
    layout = random_layout(2, 2, 1.0, seed=0)
    packed = BlocksparseMatMul(layout, block_size=8, w_layout="fprop_packed")
    assert packed.w_shape == tuple(JaxBSMM(layout, block_size=8,
                                           w_layout="fprop_packed").w_shape)
    with pytest.raises(ValueError):
        BlocksparseMatMul(layout, block_size=8, w_layout="panels")
    port = BlocksparseMatMul(layout, block_size=8, feature_axis=1)
    ones = (torch.ones(4, port.C), torch.ones(port.w_shape))
    assert torch.equal(port(*ones, gate=np.ones(port.blocks)),  # gates run
                       port(*ones))
    with pytest.raises(ValueError):           # a CPU tensor launches nothing
        bsmm_kernels.bsmm_bprop(torch.ones(4, 16), torch.ones(port.w_shape),
                                None, None, None, 8, 2)
    with pytest.raises(ValueError):
        bsmm_kernels.bsmm_updat(torch.ones(4, 16), torch.ones(4, 16), None,
                                None, 8)
    with pytest.raises(ValueError):
        port(torch.ones(4, port.C + 8), torch.ones(port.w_shape))
    with pytest.raises(ValueError):
        bsmm_kernels.bsmm_fprop(torch.ones(4, 16), torch.ones(port.w_shape),
                                None, None, None, 8, 2)
    # TPU schedule knobs change nothing
    x, w = torch.randn(6, port.C), torch.randn(port.w_shape)
    y = port(x, w)
    for kw in (dict(mode="dense_tile"), dict(tile_n=128),
               dict(dense_tile_R=2)):
        other = BlocksparseMatMul(layout, block_size=8, feature_axis=1, **kw)
        torch.testing.assert_close(other(x, w), y, rtol=0, atol=0)


def _pair(layout, bsize, axis, impl):
    return (JaxBSMM(layout, block_size=bsize, feature_axis=axis, impl=impl),
            BlocksparseMatMul(layout, block_size=bsize, feature_axis=axis))


@pytest.mark.parametrize("axis", [1, 0])
@pytest.mark.parametrize("bsize", [8, 16, 32, 64])
def test_bprop_and_updat_match_jax(bsize, axis):
    layout = random_layout(5, 4, 0.4, seed=bsize + 7 * axis)
    N = 40
    port = BlocksparseMatMul(layout, block_size=bsize, feature_axis=axis)
    rng = np.random.RandomState(bsize + axis)
    X = rng.uniform(-1, 1, port.i_shape(N)).astype(np.float32)
    E = rng.uniform(-1, 1, port.o_shape(N)).astype(np.float32)
    W = rng.uniform(-1, 1, port.w_shape).astype(np.float32)
    Xt, Et, Wt = (torch.from_numpy(a) for a in (X, E, W))
    dx = port._xprop(Et, Wt, "b").numpy()
    dw = port._updat(Xt, Et).numpy()
    assert dw.dtype == np.float32 and dw.shape == port.w_shape
    np.testing.assert_allclose(dx, port.bprop_test(E, W), rtol=F32_TOL,
                               atol=F32_TOL)
    np.testing.assert_allclose(dw, port.updat_test(X, E), rtol=F32_TOL,
                               atol=F32_TOL)
    for impl in ("xla", "pallas"):
        ref = JaxBSMM(layout, block_size=bsize, feature_axis=axis, impl=impl)
        np.testing.assert_allclose(port.bprop_test(E, W),
                                   ref.bprop_test(E, W), rtol=0, atol=0)
        np.testing.assert_allclose(
            dx, np.asarray(ref._bprop_impl(jnp.asarray(E), jnp.asarray(W))),
            rtol=F32_TOL, atol=F32_TOL, err_msg=impl)
        np.testing.assert_allclose(
            dw, np.asarray(ref._updat_impl(jnp.asarray(X), jnp.asarray(E))),
            rtol=F32_TOL, atol=F32_TOL, err_msg=impl)


@pytest.mark.parametrize("axis", [1, 0])
def test_bprop_and_updat_bf16_match_jax(axis):
    layout = random_layout(4, 6, 0.5, seed=9)
    port = BlocksparseMatMul(layout, block_size=32, feature_axis=axis)
    ref = JaxBSMM(layout, block_size=32, feature_axis=axis, impl="xla")
    rng = np.random.RandomState(3)
    X = rng.uniform(-1, 1, port.i_shape(24)).astype(np.float32)
    E = rng.uniform(-1, 1, port.o_shape(24)).astype(np.float32)
    W = rng.uniform(-1, 1, port.w_shape).astype(np.float32)
    bf = torch.bfloat16
    dx = port._xprop(torch.from_numpy(E).to(bf), torch.from_numpy(W).to(bf),
                     "b")
    dw = port._updat(torch.from_numpy(X).to(bf), torch.from_numpy(E).to(bf))
    assert dx.dtype == bf and dw.dtype == torch.float32
    jb = jnp.bfloat16
    dx_ref = np.asarray(ref._bprop_impl(jnp.asarray(E, jb),
                                        jnp.asarray(W, jb)).astype(jnp.float32))
    dw_ref = np.asarray(ref._updat_impl(jnp.asarray(X, jb), jnp.asarray(E, jb)))
    np.testing.assert_allclose(dx.float().numpy(), dx_ref, rtol=0,
                               atol=BF16_TOL * np.abs(dx_ref).max())
    np.testing.assert_allclose(dw.numpy(), dw_ref, rtol=0,
                               atol=BF16_TOL * np.abs(dw_ref).max())


@pytest.mark.parametrize("axis,dtype", [(1, "float32"), (0, "float32"),
                                        (1, "bfloat16")])
def test_autograd_matches_jax_vjp(axis, dtype):
    """dI and dW of ``BlocksparseMatMul.__call__`` through autograd against
    jax.vjp of the JAX op, on a 3-D input (axis 1) or (C, B, L) (axis 0);
    dW comes back in W's dtype as in the JAX ``_bsmm``."""
    layout = random_layout(4, 5, 0.5, seed=2 + axis)
    ref, port = _pair(layout, 16, axis, "xla")
    rng = np.random.RandomState(4)
    shape = (3, 7, port.C) if axis else (port.C, 3, 7)
    oshape = (3, 7, port.K) if axis else (port.K, 3, 7)
    X = rng.uniform(-1, 1, shape).astype(np.float32)
    W = rng.uniform(-1, 1, port.w_shape).astype(np.float32)
    G = rng.uniform(-1, 1, oshape).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    y_ref, vjp = jax.vjp(ref, jnp.asarray(X, jd), jnp.asarray(W, jd))
    dx_ref, dw_ref = (np.asarray(a.astype(jnp.float32))
                      for a in vjp(jnp.asarray(G, jd)))
    x = torch.from_numpy(X).to(td).requires_grad_()
    w = torch.from_numpy(W).to(td).requires_grad_()
    y = port(x, w)
    y.backward(torch.from_numpy(G).to(td))
    assert x.grad.dtype == td and w.grad.dtype == td
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    for got, want in ((y.detach(), np.asarray(y_ref.astype(jnp.float32))),
                      (x.grad, dx_ref), (w.grad, dw_ref)):
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                                   atol=tol * max(1.0, np.abs(want).max()))


def test_empty_input_block_row_gets_zero_gradient():
    """An input block-row with no layout block has no bprop entries: its
    dx is zero, and every dw block still equals x_cᵀ·dy_k."""
    layout = np.zeros((3, 2), np.int32)
    layout[0, 0] = layout[2, 1] = layout[0, 1] = 1          # row 1 empty
    port = BlocksparseMatMul(layout, block_size=8, feature_axis=1)
    x = torch.randn(5, port.C, requires_grad=True)
    w = torch.randn(port.w_shape, requires_grad=True)
    port(x, w).square().sum().backward()
    assert (x.grad[:, 8:16] == 0).all() and (x.grad[:, :8] != 0).any()
    X, W = x.detach().numpy(), w.detach().numpy()
    E = 2 * port.fprop_test(X, W)
    np.testing.assert_allclose(w.grad.numpy(), port.updat_test(X, E),
                               rtol=1e-5, atol=1e-5)


def _grouped_layout(n, empty=2):
    layout = np.ones((n, n), np.int32)
    layout[empty, :] = 0
    layout[:, empty] = 0
    return layout


def _xprop_group_cases(bsize):
    """(name, row_ptr, ent_in) CSRs: both directions of a full layout with
    an empty row and column (its columns group), of a random one, of a
    layout tiled four times along K (the LSTM's gates) and one block wide,
    and the split plan's tile CSR of the full and the tiled layouts."""
    gmax = max(1, bsmm_kernels.XPROP_F32_COLS // bsize)
    layouts = {"full": _grouped_layout(3 * gmax + 1),
               "random": random_layout(7, 9, 0.4, seed=bsize),
               "tiled": np.tile(random_layout(5, 5, 0.5, seed=bsize + 1),
                                (1, 4)),
               "one block wide": np.ones((6, 1), np.int32)}
    for name, layout in layouts.items():
        op = BlocksparseMatMul(layout, block_size=bsize, feature_axis=1)
        for d in "fb":
            row_ptr, (ib, _, _), _, _ = op._csr(d)
            yield f"{name} {d}", row_ptr, ib
            if name in ("full", "tiled"):
                tiles = bsmm_kernels.split_plan(row_ptr, 4)["tile_ptr"]
                yield f"{name} {d} tiles", tiles, ib


@pytest.mark.parametrize("bsize", [8, 16, 32, 64, 128])
def test_xprop_groups_cover_every_entry_once_in_order(bsize):
    """xprop_groups (bsmm_fprop.cu's column groups): every column in one
    slot; a group's slots filled from 0 with ascending columns whose entry
    lists name the same input blocks in the same order; the entries the
    kernel walks for a slot (its column's base + t, t = 0 .. L-1, x staged
    from slot 0's) are each LUT entry once, in order; groups longest
    first; gn = 128 / b unless more than a quarter of the slots would be
    empty, where it is 1; order, the columns one a thread block, each
    once, longest first."""
    gmax = max(1, bsmm_kernels.XPROP_F32_COLS // bsize)
    for name, row_ptr, ib in _xprop_group_cases(bsize):
        row_ptr = np.asarray(row_ptr, np.int64)
        lens = np.diff(row_ptr)
        plan = bsmm_kernels.xprop_groups(row_ptr, ib, bsize)
        grp, gn = plan["grp_col"], plan["gn"]
        assert grp.dtype == np.int32 and grp.shape[1] == gn, name
        live = grp >= 0
        assert (live[:, 0]).all() and not (np.diff(live.astype(int), axis=1)
                                           > 0).any(), name
        cols = grp[live]
        assert sorted(cols.tolist()) == list(range(len(lens))), name
        walked = []
        for row in grp:
            row = row[row >= 0]
            assert (np.diff(row) > 0).all(), name
            L = lens[row[0]]
            for o in row:
                assert lens[o] == L, name
                for t in range(L):
                    assert ib[row_ptr[row[0]] + t] == ib[row_ptr[o] + t]
                walked.append(row_ptr[o] + np.arange(L))
        walked = np.concatenate(walked) if walked else np.zeros(0, int)
        assert np.array_equal(np.sort(walked), np.arange(row_ptr[-1])), name
        firsts = lens[grp[:, 0]]
        assert (np.diff(firsts) <= 0).all(), name
        assert plan["order"].shape == (len(lens), 1), name
        order = plan["order"][:, 0]
        assert order.dtype == np.int32, name
        assert sorted(order.tolist()) == list(range(len(lens))), name
        assert (np.diff(lens[order]) <= 0).all(), name
        lists = {}
        for o in range(len(lens)):
            lists.setdefault(np.asarray(ib[row_ptr[o]:row_ptr[o + 1]])
                             .tobytes(), []).append(o)
        whole = sum(-(-len(v) // gmax) for v in lists.values())
        want = gmax if gmax > 1 and len(lens) >= 0.75 * whole * gmax else 1
        assert gn == want, (name, gn, want)
        if name.startswith("full") and gmax > 1:
            assert gn == gmax, name


@pytest.mark.parametrize("bsize", [8, 16, 32, 64])
def test_xprop_groups_replayed_match_jax(bsize):
    """bsmm_fprop.cu's decomposition replayed on the CPU in f32: each group
    stages x's input block from slot 0's entry list, each slot multiplies
    it by its own entry's W (Wᵀ in bprop) and writes its column; at gn > 1
    (the full layout with an empty column) and gn 1 (a random one) against
    JAX's impl="xla" within 1e-5 of the largest output."""
    rng = np.random.RandomState(bsize)
    gmax = max(1, bsmm_kernels.XPROP_F32_COLS // bsize)
    for layout in (_grouped_layout(3 * gmax + 1),
                   random_layout(5, 7, 0.4, seed=bsize)):
        op = BlocksparseMatMul(layout, block_size=bsize, feature_axis=1)
        jop = JaxBSMM(layout, block_size=bsize, feature_axis=1, impl="xla")
        w = rng.randn(*op.w_shape).astype(np.float32)
        for d in "fb":
            row_ptr, (ib, wb, _), n_out, n_in = op._csr(d)
            plan = op._plan("xgroup", d)
            x = rng.randn(13, n_in * bsize).astype(np.float32)
            xt, wt = torch.from_numpy(x), torch.from_numpy(w)
            y = torch.full((13, n_out * bsize), float("nan"))
            for row in plan["grp_col"]:
                row = row[row >= 0]
                for o in row:
                    acc = torch.zeros((13, bsize))
                    for t in range(row_ptr[row[0] + 1] - row_ptr[row[0]]):
                        xin = ib[row_ptr[row[0]] + t]
                        wblk = wt[wb[row_ptr[o] + t]]
                        acc += xt[:, xin * bsize:(xin + 1) * bsize] @ (
                            wblk.t() if d == "b" else wblk)
                    y[:, o * bsize:(o + 1) * bsize] = acc
            if d == "f":
                ref = np.asarray(jop(jnp.asarray(x), jnp.asarray(w)))
            else:
                _, vjp = jax.vjp(lambda a: jop(a, jnp.asarray(w)),
                                 jnp.zeros((13, op.C), jnp.float32))
                ref = np.asarray(vjp(jnp.asarray(x))[0])
            scale = max(1.0, np.abs(ref).max())
            np.testing.assert_allclose(y.numpy(), ref, rtol=0,
                                       atol=F32_TOL * scale)
        if layout.shape[0] > 5:
            assert op._plan("xgroup", "f")["gn"] == gmax


def test_xprop_groups_take_the_lstm_gates_four_to_a_group():
    """The sparse LSTM's gate layout (its hidden layout tiled over the four
    gates) at b32: the four gates of a hidden block share their fprop
    entry lists, so each group holds four columns; the bprop's rows all
    differ, one to a group; the split plan's tiles of the bprop group
    again by run where their lists agree."""
    base = random_layout(6, 6, 0.5, seed=3)
    op = BlocksparseMatMul(np.tile(base, (1, 4)), block_size=32,
                           feature_axis=0)
    plan = op._plan("xgroup", "f")
    assert plan["gn"] == 4 and plan["grp_col"].shape == (6, 4)
    for row in plan["grp_col"]:
        assert sorted(row % 6) == [row[0] % 6] * 4
    assert op._plan("xgroup", "b")["gn"] == 1


def _groups(gn, groups):
    """An xprop_groups plan's shape: ``groups`` groups of ``gn`` columns."""
    return {"gn": gn, "grp_col": np.zeros((groups, gn), np.int32),
            "order": np.zeros((groups * gn, 1), np.int32)}


def test_xprop_tile_by_n_and_plan():
    """bsmm_fprop.cu's configuration rule, pinned by value on a 132-SM card:
    full column groups at TM 64 where the plan groups 128 / b columns to a
    group and their grid puts two thread blocks on each SM (the MoE LM's
    512 -> 2048 fprop and 2048 -> 512 bprop at N 2,560: 16 groups of 4),
    else one column a thread block at TM 32 (the MoE's 16-column
    products, the LSTM's N 128, decode, a plan that does not group); at
    b128 every column is a full group."""
    tile = bsmm_kernels.xprop_tile
    assert tile(2560, 32, _groups(4, 16), 132) == (4, 64)
    assert tile(2560, 32, _groups(4, 4), 132) == (1, 32)
    assert tile(2560, 32, _groups(1, 64), 132) == (1, 32)
    assert tile(128, 32, _groups(4, 35), 132) == (1, 32)
    assert tile(128, 32, _groups(1, 141), 132) == (1, 32)
    assert tile(2112, 32, _groups(4, 8), 132) == (4, 64)     # 33 x 8 = 264
    assert tile(2048, 32, _groups(4, 8), 132) == (1, 32)     # 32 x 8 < 264
    assert tile(16384, 32, _groups(1, 33), 132) == (1, 32)
    assert tile(1, 8, _groups(16, 10), 132) == (1, 32)
    assert tile(16384, 128, _groups(1, 16), 132) == (1, 64)  # 256 x 16
    assert tile(1024, 128, _groups(1, 16), 132) == (1, 32)   # 16 x 16 < 264
    for b in (8, 16, 32, 64, 128):
        tiles = bsmm_kernels.xprop_f32_tiles(b)
        assert len(tiles) == 2
        gmax = max(1, 128 // b)
        assert tile(16384, b, _groups(gmax, 100), 132) == tiles[0]
        assert tile(3, b, _groups(1, 2), 132) == tiles[1] == (1, 32)


@pytest.mark.parametrize("bsize", [8, 32, 128])
def test_xprop_launch_takes_groups_or_columns(bsize):
    """xprop_launch: the plan's groups where the configuration's group width
    is theirs, its one-column order otherwise; on the LSTM-like tiled
    layout's fprop (groups of four at b32) and a random layout's."""
    gmax = max(1, bsmm_kernels.XPROP_F32_COLS // bsize)
    for layout in (np.tile(random_layout(5, 5, 0.5, seed=bsize), (1, 4)),
                   random_layout(7, 9, 0.4, seed=bsize)):
        op = BlocksparseMatMul(layout, block_size=bsize, feature_axis=1)
        plan = op._plan("xgroup", "f")
        for gn, tm in bsmm_kernels.xprop_f32_tiles(bsize):
            got = bsmm_kernels.xprop_launch(plan, (gn, tm))
            assert (got["gn"], got["tm"]) == (gn, tm)
            want = plan["grp_col"] if gn == plan["gn"] else plan["order"]
            assert got["grp_col"] is want
            if gn == gmax and plan["gn"] == gmax:
                assert got["grp_col"].shape[1] == gmax
            if gn == 1:
                assert got["grp_col"].shape == (op.KB, 1)
