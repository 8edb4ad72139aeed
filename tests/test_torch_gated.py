"""The gated block-sparse matmul and the rest of the matmul surface, against
the JAX package.

The gate (``gate``, ``gate_grad``, ``dw_gated``) in both feature axes, the
static NumPy gate against the dynamic one and the all-zero gate; the
initializers, ``prune``, ``block_coord``, ``l2_normalize`` and its
gradient, ``coarsen_layout``, ``block_reduced_full_dw``,
``dw_matmul_large_n``, ``largest_block``, ``SparseProj`` and pickling.
JAX runs ``impl="xla"`` (the CPU's path, as its own ``test_gated`` runs).

Tolerances (f32, the same products summed in other orders): outputs and
gradients 1e-5 of the tensor's largest magnitude (at least 1); integer
tables, layouts, initializers, projections and pickled state: exact.
"""
import pickle

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from blocksparse_tpu.ops import matmul as jm

import blocksparse_tpu_torch as bt
from blocksparse_tpu_torch.ops import matmul as tm

TOL = 1e-5
PAIRS = [(False, False), (False, True), (True, False), (True, True)]


def random_layout(CB, KB, density=0.5, seed=0):
    """The JAX matmul tests' random layout: no empty row or column."""
    rng = np.random.RandomState(seed)
    layout = (rng.rand(CB, KB) < density).astype(np.int32)
    for c in range(CB):
        if layout[c].sum() == 0:
            layout[c, rng.randint(KB)] = 1
    for k in range(KB):
        if layout[:, k].sum() == 0:
            layout[rng.randint(CB), k] = 1
    return layout


def _np(a):
    return a.detach().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def close(got, want, tol=TOL):
    got, want = _np(got), _np(want)
    scale = max(1.0, float(np.abs(want).max()))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def _ops(axis, bsize=16, layout=None):
    layout = random_layout(4, 4, 0.5, seed=3) if layout is None else layout
    return (jm.BlocksparseMatMul(layout, block_size=bsize, feature_axis=axis,
                                 impl="xla"),
            bt.BlocksparseMatMul(layout, block_size=bsize, feature_axis=axis))


def _inputs(op, N=32, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.uniform(-1, 1, op.i_shape(N)).astype(np.float32)
    E = rng.uniform(-1, 1, op.o_shape(N)).astype(np.float32)
    W = rng.uniform(-1, 1, op.w_shape).astype(np.float32)
    gate = (rng.rand(op.blocks) > 0.5).astype(np.float32)
    return X, E, W, gate


def _jax_grads(op, X, E, W, gate, **kw):
    def loss(x, w, g):
        y = op(x, w, gate=g, **kw)
        return jnp.sum(y * E), y
    (_, y), grads = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                       has_aux=True)(
        jnp.asarray(X), jnp.asarray(W), jnp.asarray(gate))
    return (np.asarray(y),) + tuple(np.asarray(g) for g in grads)


def _port_grads(op, X, E, W, gate, gate_requires_grad=True, **kw):
    x, w = (torch.from_numpy(a).requires_grad_() for a in (X, W))
    g = torch.from_numpy(gate).requires_grad_(gate_requires_grad)
    y = op(x, w, gate=g, **kw)
    args = (x, w, g) if gate_requires_grad else (x, w)
    grads = torch.autograd.grad((y * torch.from_numpy(E)).sum(), args)
    return (y,) + grads


@pytest.mark.parametrize("dw_gated,gate_grad", PAIRS)
@pytest.mark.parametrize("axis", [0, 1])
def test_gated_matches_jax(axis, dw_gated, gate_grad):
    """y, dx, dw and dg of the dynamic gate against JAX's (JAX
    ``test_gated``'s layout and sizes), and y, dx, dw against the NumPy
    goldens with the gate."""
    jop, top = _ops(axis)
    X, E, W, gate = _inputs(jop)
    want = _jax_grads(jop, X, E, W, gate, gate_grad=gate_grad,
                      dw_gated=dw_gated)
    got = _port_grads(top, X, E, W, gate, gate_grad=gate_grad,
                      dw_gated=dw_gated)
    for g, w in zip(got, want):
        close(g, w)
    close(got[0], top.fprop_test(X, W, gate=gate))
    close(got[1], top.bprop_test(E, W, gate=gate))
    close(got[2], top.updat_test(X, E, gate=gate, dw_gated=dw_gated))
    if not gate_grad:
        assert not got[3].any()


@pytest.mark.parametrize("axis", [0, 1])
def test_static_gate_matches_the_dynamic_gate_and_jax(axis):
    """A NumPy gate with dw_gated and no gate_grad runs the op of the
    surviving blocks: the dynamic gate's y, dx and dw, and JAX's static
    path's.  The sub-op keeps only those blocks."""
    jop, top = _ops(axis, bsize=8, layout=random_layout(6, 5, 0.6, seed=4))
    X, E, W, gate = _inputs(jop, N=24, seed=1)
    gate = gate * np.random.RandomState(2).uniform(0.5, 2.0, gate.shape) \
        .astype(np.float32)
    dyn = _port_grads(top, X, E, W, gate, dw_gated=True)[:3]
    x, w = (torch.from_numpy(a).requires_grad_() for a in (X, W))
    y = top(x, w, gate=gate, dw_gated=True)
    static = (y,) + torch.autograd.grad((y * torch.from_numpy(E)).sum(),
                                        (x, w))
    st = top._static_gates[gate.tobytes()]
    assert st.sub.blocks == int((gate != 0).sum())

    def jloss(x, w):
        y = jop(x, w, gate=gate, dw_gated=True)
        return jnp.sum(y * E), y
    (_, jy), jg = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(X), jnp.asarray(W))
    for s, d, j in zip(static, dyn, (jy,) + jg):
        close(s, d)
        close(s, j)
    # the same gate again: the cached sub-op, no rebuild
    top(x, w, gate=gate.copy(), dw_gated=True)
    assert top._static_gates[gate.tobytes()] is st


@pytest.mark.parametrize("axis", [0, 1])
def test_all_zero_static_gate_gives_zeros(axis):
    _, top = _ops(axis)
    X, E, W, _ = _inputs(top)
    zero = np.zeros(top.blocks, np.float32)
    x, w = (torch.from_numpy(a).requires_grad_() for a in (X, W))
    y = top(x, w, gate=zero, dw_gated=True)
    assert tuple(y.shape) == top.o_shape(32) and not y.any()
    dx, dw = torch.autograd.grad((y * torch.from_numpy(E)).sum(), (x, w))
    assert not dx.any() and not dw.any()
    with torch.no_grad():
        assert not top(x, w, gate=zero, dw_gated=True).any()


def test_gate_without_gradients_runs_the_forward():
    """No gradient to take: the gated forward alone, JAX's y; a NumPy gate
    with gate_grad stays dynamic."""
    jop, top = _ops(1)
    X, _, W, gate = _inputs(jop)
    want = np.asarray(jop(jnp.asarray(X), jnp.asarray(W),
                          gate=jnp.asarray(gate)))
    with torch.no_grad():
        close(top(torch.from_numpy(X), torch.from_numpy(W),
                  gate=torch.from_numpy(gate)), want)
    close(top(torch.from_numpy(X), torch.from_numpy(W), gate=gate,
              gate_grad=True, dw_gated=True), want)
    assert not top._static_gates


@pytest.mark.parametrize("layout", ["sparse", "dense"])
def test_ortho_init_is_bit_equal_after_the_same_seed(layout):
    lay = random_layout(5, 7, 0.4, seed=1) if layout == "sparse" \
        else np.ones((3, 4), np.int32)
    jop, top = (m.BlocksparseMatMul(lay, block_size=16)
                for m in (jm, bt))
    np.random.seed(11)
    want = jop.ortho_init()(None)
    np.random.seed(11)
    got = top.ortho_init()(None)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_checker_init_prune_and_block_coord_match_jax():
    lay = random_layout(6, 6, 0.5, seed=2)
    jop, top = (m.BlocksparseMatMul(lay, block_size=8) for m in (jm, bt))
    assert [top.block_coord(i) for i in range(top.blocks)] == \
        [jop.block_coord(i) for i in range(jop.blocks)]
    gate = top.checker_init()(None)
    assert np.array_equal(gate, jop.checker_init()(None))
    param = np.random.RandomState(3).randn(*top.w_shape).astype(np.float32)
    got_p, got_g = top.prune(param, gate)
    want_p, want_g = jop.prune(param, gate)
    assert np.array_equal(got_p, want_p) and np.array_equal(got_g, want_g)
    # the layout loses the pruned blocks in place, as JAX's
    assert np.array_equal(top.layout, jop.layout)
    assert int(top.layout.sum()) == int((gate != 0).sum())
    # nothing to prune: the param as it was
    same, ones = top.prune(param, np.ones(top.blocks, np.float32))
    assert same is param and ones.all()


@pytest.mark.parametrize("gain", [False, True])
def test_l2_normalize_and_its_gradient(gain):
    lay = random_layout(4, 5, 0.5, seed=9)
    jop, top = (m.BlocksparseMatMul(lay, block_size=8) for m in (jm, bt))
    rng = np.random.RandomState(4)
    W = rng.uniform(-1, 1, top.w_shape).astype(np.float32)
    U = rng.uniform(-1, 1, top.w_shape).astype(np.float32)
    G = rng.uniform(0.5, 1.5, top.K).astype(np.float32) if gain else None
    w = torch.from_numpy(W).requires_grad_()
    g = None if G is None else torch.from_numpy(G)
    out = top.l2_normalize(w, gain=g)
    close(out, np.asarray(jop.l2_normalize(
        jnp.asarray(W), gain=None if G is None else jnp.asarray(G))))
    if G is None:
        close(out, top.l2_normalize_test(W))
        (dw,) = torch.autograd.grad(out, w, torch.from_numpy(U))
        close(dw, top.l2_normalize_grad_test(W, U))
        assert np.array_equal(top.l2_normalize_grad_test(W, U),
                              jop.l2_normalize_grad_test(W, U))
    assert top.l2_normalize(w, dtype=torch.bfloat16).dtype == torch.bfloat16


@pytest.mark.parametrize("bsize,target", [(8, 32), (16, 128), (32, 64)])
def test_coarsen_layout_matches_jax(bsize, target):
    lay = random_layout(9, 7, 0.3, seed=bsize)
    got = bt.coarsen_layout(lay, bsize, target)
    want = jm.coarsen_layout(lay, bsize, target)
    assert np.array_equal(got[0], want[0]) and got[3] == want[3]
    fine = np.random.RandomState(0).randn(
        int(lay.sum()), bsize, bsize).astype(np.float32)
    packed = got[1](fine)
    assert np.array_equal(packed, want[1](fine))
    assert np.array_equal(got[2](packed), fine)


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("norm", ["max", "l2"])
def test_block_reduced_full_dw_matches_jax(axis, norm):
    rng = np.random.RandomState(5)
    shapes = ((64, 24), (48, 24)) if axis == 0 else ((24, 64), (24, 48))
    xs = [rng.randn(*shapes[0]).astype(np.float32) for _ in range(3)]
    gs = [rng.randn(*shapes[1]).astype(np.float32) for _ in range(3)]
    got = bt.block_reduced_full_dw([torch.from_numpy(a) for a in xs],
                                   [torch.from_numpy(a) for a in gs],
                                   bsize=16, axis=axis, norm=norm, scale=0.5)
    want = jm.block_reduced_full_dw([jnp.asarray(a) for a in xs],
                                    [jnp.asarray(a) for a in gs], bsize=16,
                                    axis=axis, norm=norm, scale=0.5)
    assert tuple(got.shape) == (4, 3)
    close(got, np.asarray(want))


def test_dw_matmul_large_n_and_largest_block():
    rng = np.random.RandomState(6)
    x = rng.randn(300, 24).astype(np.float32)
    dy = rng.randn(300, 40).astype(np.float32)
    got = bt.dw_matmul_large_n(torch.from_numpy(x).bfloat16(),
                               torch.from_numpy(dy).bfloat16())
    want = jm.dw_matmul_large_n(jnp.asarray(x, jnp.bfloat16),
                                jnp.asarray(dy, jnp.bfloat16))
    assert got.dtype == torch.float32
    close(got, np.asarray(want))
    for dim in (64, 48, 40, 24, 8):
        assert bt.largest_block(dim) == jm.largest_block(dim)
    with pytest.raises(ValueError):
        bt.largest_block(12)


def test_group_shims_and_dx_ops():
    g = torch.ones(3)
    assert bt.group_param_grads(g) is g and bt.group_dg_grads(g) is g
    with pytest.raises(NotImplementedError):
        bt.get_bsmm_dx_ops(g)


@pytest.mark.parametrize("form", ["stride", "nproj", "lut"])
def test_sparse_proj_matches_jax(form):
    nhidden = 96
    kw = {"stride": dict(proj_stride=3, block_size=8),
          "nproj": dict(nproj=40),
          "lut": dict(gather_lut=np.array([1, 5, 6, 50, 95]))}[form]
    np.random.seed(21)
    jp = jm.SparseProj(nhidden, **kw)
    np.random.seed(21)
    tp = bt.SparseProj(nhidden, **kw)
    assert np.array_equal(tp.gather_lut, jp.gather_lut)
    assert np.array_equal(tp.scatter_lut, jp.scatter_lut)
    rng = np.random.RandomState(7)
    x = rng.randn(nhidden, 3).astype(np.float32)
    y = rng.randn(tp.nproj, 3).astype(np.float32)
    X, Y = torch.from_numpy(x), torch.from_numpy(y)
    for got, want in (
            (tp.gather(X), jp.gather(jnp.asarray(x))),
            (tp.scatter(Y), jp.scatter(jnp.asarray(y))),
            (tp.scatter_add(X, Y), jp.scatter_add(jnp.asarray(x),
                                                  jnp.asarray(y))),
            (tp.scatter_mul(X, Y), jp.scatter_mul(jnp.asarray(x),
                                                  jnp.asarray(y)))):
        assert np.array_equal(got.numpy(), np.asarray(want))
    # pickled by its gather_lut, as JAX's
    back = pickle.loads(pickle.dumps(tp))
    assert tp.__getstate__()[0] == jp.__getstate__()[0]
    assert np.array_equal(tp.__getstate__()[2], jp.__getstate__()[2])
    assert np.array_equal(back.gather_lut, tp.gather_lut)
    assert back.nproj == tp.nproj and back.name == tp.name


def test_sparse_proj_gradients_match_jax():
    """gather, scatter and scatter_add against jax.grad; scatter_mul (whose
    JAX gradient JAX does not implement) against its closed form."""
    tp, jp = bt.SparseProj(64, proj_stride=2, block_size=8), \
        jm.SparseProj(64, proj_stride=2, block_size=8)
    rng = np.random.RandomState(8)
    x = rng.randn(64, 2).astype(np.float32)
    y = rng.randn(tp.nproj, 2).astype(np.float32)
    X, Y = (torch.from_numpy(a).requires_grad_() for a in (x, y))
    out = tp.scatter_add(X, Y) + tp.scatter(tp.gather(X) * Y)
    got = torch.autograd.grad(out.square().sum(), (X, Y))

    def f(x, y):
        return jnp.sum((jp.scatter_add(x, y)
                        + jp.scatter(jp.gather(x) * y)) ** 2)
    want = jax.grad(f, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(y))
    for g, w in zip(got, want):
        close(g, w)
    dx, dy = torch.autograd.grad(tp.scatter_mul(X, Y).sum(), (X, Y))
    lut = tp.gather_lut
    want_dx = np.ones_like(x)
    want_dx[lut] = y
    assert np.array_equal(dx.numpy(), want_dx)
    assert np.array_equal(dy.numpy(), x[lut])


def test_matmul_pickles_its_constructor_arguments_as_jax():
    lay = random_layout(5, 6, 0.4, seed=5)
    kw = dict(block_size=16, feature_axis=1, z_order=False, name="m",
              mode="grouped")
    top, jop = bt.BlocksparseMatMul(lay, **kw), \
        jm.BlocksparseMatMul(lay, impl="xla", **kw)
    top._lut(torch.device("cpu"))               # a cached LUT, not pickled
    state = top.__getstate__()
    want = jop.__getstate__()
    assert set(state) == set(want)
    for k, v in want.items():
        if k == "impl":
            continue
        assert np.array_equal(state[k], v) if k == "layout" else state[k] == v
    back = pickle.loads(pickle.dumps(top))
    assert not back._luts and back.updat_list == top.updat_list
    assert back.fprop_list == top.fprop_list and back.mode == "grouped"
    X = np.random.RandomState(1).randn(*top.i_shape(8)).astype(np.float32)
    W = np.random.RandomState(2).randn(*top.w_shape).astype(np.float32)
    assert torch.equal(back(torch.from_numpy(X), torch.from_numpy(W)),
                       top(torch.from_numpy(X), torch.from_numpy(W)))
    # a pruned layout pickles pruned
    top.prune(W, np.r_[0.0, np.ones(top.blocks - 1)])
    assert pickle.loads(pickle.dumps(top)).blocks == top.blocks - 1


def test_the_surface_is_exported_under_the_jax_names():
    import blocksparse_tpu as jbs
    for name in ("SparseProj", "block_reduced_full_dw", "group_param_grads",
                 "group_dg_grads", "get_bsmm_dx_ops", "largest_block",
                 "coarsen_layout", "dw_matmul_large_n"):
        assert hasattr(jbs, name)
        assert getattr(bt, name) is getattr(tm, name)
        assert getattr(bt.ops, name) is getattr(tm, name)
    from blocksparse_tpu_torch import sparsity
    assert sparsity.coarsen_layout is tm.coarsen_layout
