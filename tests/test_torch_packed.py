"""``BlocksparseMatMul(w_layout="fprop_packed")``: the port's packed
store against the JAX op's.

The store's shape and block order are the JAX op's TPU fprop schedule
(``kernels/packed_order.py`` rebuilds it in NumPy): for each layout and
knob below the port's store has JAX's shape, form (panels or slots) and
each block's position exactly, and each case asserts which of the JAX
op's branches decided it.  A store packed by either package unpacks to
the same canonical blocks in the other.  The call (which gathers the
canonical blocks and runs the usual kernels, their plain versions here)
gives JAX ``impl="xla"``'s y, dx, packed dW and dg: f32 within 1e-5 of
each output's max|.| (the same f32 products, summed in other orders),
bf16 within 1e-2 of it (one bf16 rounding of the output, 2^-8, plus
order); the padding of dW exactly zero.  The canonical b16 row (26,494
entries) takes the host library's builders in both packages.
"""
import pickle

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from blocksparse_tpu import BlocksparseMatMul as JaxBSMM
from blocksparse_tpu_torch import BlocksparseMatMul
from blocksparse_tpu_torch import native
from blocksparse_tpu_torch.kernels import packed_order
from blocksparse_tpu_torch.models.sparse_lstm import make_mask

torch.set_num_threads(2)
F32_TOL, BF16_TOL = 1e-5, 1e-2
MODES = ("auto", "grouped", "dense_tile", "window", "resident", "fine")


def random_layout(CB, KB, density, seed, empty=False):
    rng = np.random.RandomState(seed)
    layout = (rng.rand(CB, KB) < density).astype(np.int32)
    layout[0, 0] = 1
    if empty:                       # an empty input row and output column
        layout[CB // 2, :] = 0
        layout[:, KB // 2] = 0
    return layout


def banded(n, half):
    layout = np.zeros((n, n), np.int32)
    for i in range(n):
        layout[i, max(0, i - half):i + half + 1] = 1
    return layout


def jax_branch(op):
    """Which schedule decided the JAX op's store."""
    if op._panels_f:
        if op.mode_f == "window":
            return "window"
        if op.fprop_dt.rows_at is not None:
            return "phased"
        return op.mode_f                      # dense_tile or resident
    return "supertile" if getattr(op.fprop_grouped, "contiguous", False) \
        else "gathered"


# (layout, block size, constructor knobs, the JAX op's branch)
GRID_BRANCH = {  # random 12 x 10 at d 0.35: each block size in each mode
    8: ("dense_tile", "gathered", "dense_tile", "window", "resident",
        "dense_tile"),
    16: ("dense_tile", "gathered", "dense_tile", "window", "resident",
         "dense_tile"),
    32: ("dense_tile", "gathered", "dense_tile", "window", "resident",
         "dense_tile"),
    64: ("dense_tile", "supertile", "dense_tile", "window", "resident",
         "dense_tile"),
    128: ("supertile", "supertile", "supertile", "window", "supertile",
          "supertile"),
}
CASES = [(f"b{b}-{mode}", lambda b=b: random_layout(12, 10, 0.35, seed=b),
          b, dict(mode=mode), branch)
         for b, branches in GRID_BRANCH.items()
         for mode, branch in zip(MODES, branches)]
CASES += [
    ("b16-R4", lambda: random_layout(12, 10, 0.35, 16), 16,
     dict(dense_tile_R=4), "dense_tile"),
    ("b64-R4", lambda: random_layout(12, 10, 0.35, 64), 64,
     dict(dense_tile_R=4), "dense_tile"),
    ("b128-R4-dense_tile", lambda: random_layout(12, 10, 0.35, 128), 128,
     dict(dense_tile_R=4, mode="dense_tile"), "dense_tile"),
    ("b32-G2", lambda: random_layout(16, 16, 0.4, 1), 32,
     dict(dense_tile_G=2), "dense_tile"),
    ("b32-rowmajor", lambda: random_layout(12, 10, 0.35, 5), 32,
     dict(z_order=False), "dense_tile"),
    ("b16-rowmajor-grouped", lambda: random_layout(12, 10, 0.35, 6), 16,
     dict(z_order=False, mode="grouped"), "gathered"),
    ("b32-nc", lambda: random_layout(12, 10, 0.35, 7), 32,
     dict(feature_axis=1), "dense_tile"),
    ("b8-nc-window", lambda: random_layout(12, 10, 0.35, 8), 8,
     dict(feature_axis=1, mode="window"), "window"),
    ("b16-empty", lambda: random_layout(12, 10, 0.4, 9, empty=True), 16,
     {}, "dense_tile"),
    ("b32-empty-grouped", lambda: random_layout(12, 10, 0.4, 10, empty=True),
     32, dict(mode="grouped"), "gathered"),
    ("b32-empty-window", lambda: random_layout(12, 10, 0.4, 11, empty=True),
     32, dict(mode="window"), "window"),
    ("b64-empty", lambda: random_layout(12, 10, 0.4, 12, empty=True), 64,
     {}, "dense_tile"),
    ("b32-phased", lambda: random_layout(16, 16, 0.05, 3), 32, {},
     "phased"),
    ("b64-phased", lambda: random_layout(16, 16, 0.05, 3), 64, {},
     "phased"),
    ("b32-banded-grouped", lambda: banded(16, 3), 32, dict(mode="grouped"),
     "supertile"),
    ("b128-banded", lambda: banded(8, 1), 128, {}, "supertile"),
]
IDS = [c[0] for c in CASES]


def _pair(layout, bsize, kw):
    kw = dict(kw)
    kw.setdefault("feature_axis", 0)
    jop = JaxBSMM(layout, block_size=bsize, impl="xla",
                  w_layout="fprop_packed", **kw)
    top = BlocksparseMatMul(layout, block_size=bsize,
                            w_layout="fprop_packed", **kw)
    return jop, top


def _jax_pos(jop):
    return jop._dt_flat_pos if jop._panels_f else jop._packed_pos


@pytest.mark.parametrize("name,layout,bsize,kw,branch", CASES, ids=IDS)
def test_packed_order_matches_jax(name, layout, bsize, kw, branch):
    jop, top = _pair(layout(), bsize, kw)
    assert jax_branch(jop) == branch
    order = top.packed
    assert top.w_shape == tuple(jop.w_shape)
    assert top.packed_blocks == jop.packed_blocks
    assert order.panels == jop._panels_f
    assert order.mode_f == jop.mode_f
    assert order.phased == (branch == "phased")
    assert order.supertile == bool(getattr(jop.fprop_grouped, "contiguous",
                                           False))
    assert np.array_equal(order.pos, _jax_pos(jop))
    # a store packed by either package unpacks to the same blocks in the
    # other, and packs to the same bits
    W = np.random.RandomState(1).uniform(-1, 1, (top.blocks, bsize, bsize)) \
        .astype(np.float32)
    Wp = top.pack_weights(W)
    assert Wp.shape == top.w_shape
    assert np.array_equal(Wp, jop.pack_weights(W))
    assert np.array_equal(np.asarray(jop.unpack_weights(Wp)), W)
    assert np.array_equal(top.unpack_weights(jop.pack_weights(W)), W)


def test_packed_order_native_at_the_canonical_b16_row():
    """The canonical bench's hidden-7680 layout at 11.25%, b16 (26,494
    entries): both packages build it on the host library's builders, to
    the same store."""
    assert native.available()
    n = 7680 // 16
    layout = make_mask(n, "ba_28", seed=0)
    assert layout.sum() == 26494 >= packed_order.NATIVE_MIN_NNZ
    jop = JaxBSMM(layout, block_size=16, feature_axis=0, impl="xla",
                  w_layout="fprop_packed")
    top = BlocksparseMatMul(layout, block_size=16, feature_axis=0,
                            w_layout="fprop_packed")
    assert top.w_shape == tuple(jop.w_shape)
    assert top.packed.panels and jax_branch(jop) == "dense_tile"
    assert np.array_equal(top.packed.pos, _jax_pos(jop))


# one case of each store (dense-tile, phased and window panels; gathered
# and supertile slots) and of each feature axis, gated on three of them
CALL_CASES = [(c, gated) for c in CASES for gated in (False, True)
              if (c[0], gated) in {
                  ("b16-auto", False), ("b16-auto", True),
                  ("b8-grouped", False), ("b8-grouped", True),
                  ("b32-phased", True), ("b32-window", False),
                  ("b32-banded-grouped", False), ("b8-nc-window", False)}]


def _inputs(op, N, seed):
    rng = np.random.RandomState(seed)
    X = rng.uniform(-1, 1, op.i_shape(N)).astype(np.float32)
    E = rng.uniform(-1, 1, op.o_shape(N)).astype(np.float32)
    W = rng.uniform(-1, 1, (op.blocks, op.bsize, op.bsize)) \
        .astype(np.float32)
    gate = (rng.rand(op.blocks) > 0.3).astype(np.float32) \
        * rng.uniform(0.5, 2.0, op.blocks).astype(np.float32)
    return X, E, W, gate


def _close(got, want, tol):
    got = got.float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def _padding(op, dw):
    """dW's store less the store of its own blocks: the padding cells."""
    dw = dw.float().numpy()
    return dw - op.pack_weights(op.unpack_weights(dw))


@pytest.mark.parametrize("case,gated", CALL_CASES,
                         ids=[f"{c[0]}-{'gated' if g else 'plain'}"
                              for c, g in CALL_CASES])
def test_packed_call_matches_jax(case, gated):
    """y, dx, the packed dW (and, gated with gate_grad and dw_gated, dg)
    against JAX's packed op in f32; dW's padding exactly zero."""
    _, layout, bsize, kw, _ = case
    jop, top = _pair(layout(), bsize, kw)
    X, E, W, gate = _inputs(top, 24, seed=bsize)
    Wp = top.pack_weights(W)
    kwg = dict(gate_grad=True, dw_gated=True) if gated else {}

    def jloss(x, w, g):
        y = jop(x, w, gate=g if gated else None, **kwg)
        return jnp.sum(y * E), y
    (_, y_j), grads_j = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                           has_aux=True)(
        jnp.asarray(X), jnp.asarray(Wp), jnp.asarray(gate))
    x, w, g = (torch.from_numpy(a).requires_grad_() for a in (X, Wp, gate))
    y = top(x, w, gate=g if gated else None, **kwg)
    (y * torch.from_numpy(E)).sum().backward()
    _close(y.detach(), y_j, F32_TOL)
    _close(x.grad, grads_j[0], F32_TOL)
    _close(w.grad, grads_j[1], F32_TOL)
    if gated:
        _close(g.grad, grads_j[2], F32_TOL)
    assert not _padding(top, w.grad).any()
    # against the canonical op's golden
    _close(y.detach(), top.fprop_test(X, W, gate=gate if gated else None),
           F32_TOL)


def test_packed_call_bf16_matches_jax():
    _, layout, bsize, kw, _ = next(c for c in CASES if c[0] == "b16-auto")
    jop, top = _pair(layout(), bsize, kw)
    X, E, W, _ = _inputs(top, 32, seed=3)
    Wp = top.pack_weights(W)
    bf = jnp.bfloat16

    def jloss(x, w):
        y = jop(x, w)
        return jnp.sum(y.astype(jnp.float32) * E), y
    (_, y_j), (dx_j, dw_j) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jnp.asarray(X, bf),
                                             jnp.asarray(Wp, bf))
    x = torch.from_numpy(X).bfloat16().requires_grad_()
    w = torch.from_numpy(Wp).bfloat16().requires_grad_()
    y = top(x, w)
    assert y.dtype == torch.bfloat16
    (y.float() * torch.from_numpy(E)).sum().backward()
    for got, want in ((y.detach(), y_j), (x.grad, dx_j), (w.grad, dw_j)):
        _close(got, np.asarray(want.astype(jnp.float32)), BF16_TOL)
    assert not _padding(top, w.grad).any()


def test_packed_static_gate_matches_jax():
    """A NumPy gate with dw_gated and no gate_grad (the op over the
    surviving blocks) on a packed store: y, dx and the packed dW."""
    _, layout, bsize, kw, _ = next(c for c in CASES if c[0] == "b16-auto")
    jop, top = _pair(layout(), bsize, kw)
    X, E, W, gate = _inputs(top, 16, seed=5)
    Wp = top.pack_weights(W)

    def jloss(x, w):
        y = jop(x, w, gate=gate, dw_gated=True)
        return jnp.sum(y * E), y
    (_, y_j), (dx_j, dw_j) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jnp.asarray(X), jnp.asarray(Wp))
    x, w = (torch.from_numpy(a).requires_grad_() for a in (X, Wp))
    y = top(x, w, gate=gate, dw_gated=True)
    (y * torch.from_numpy(E)).sum().backward()
    for got, want in ((y.detach(), y_j), (x.grad, dx_j), (w.grad, dw_j)):
        _close(got, want, F32_TOL)
    assert not _padding(top, w.grad).any()


@pytest.mark.parametrize("name", ["b16-auto", "b8-grouped"])
def test_pack_and_unpack_tensors_match_jax(name):
    """The tensor forms: pack and unpack bit for bit against JAX's jnp
    forms, and the unpack's gradient is the repacked gradient."""
    _, layout, bsize, kw, _ = next(c for c in CASES if c[0] == name)
    jop, top = _pair(layout(), bsize, kw)
    _, _, W, _ = _inputs(top, 8, seed=7)
    Wp = np.array(jop.pack_weights(jnp.asarray(W)))
    assert torch.equal(top.pack_weights(torch.from_numpy(W)),
                       torch.from_numpy(Wp.copy()))
    wp = torch.from_numpy(Wp).requires_grad_()
    wc = top.unpack_weights(wp)
    assert torch.equal(wc, torch.from_numpy(W))
    (wc * torch.from_numpy(W)).sum().backward()
    assert torch.equal(wp.grad, torch.from_numpy(Wp))


def test_packed_op_pickles_with_its_layout():
    """Pickling keeps w_layout (the store's shape and order come back);
    like JAX's, it drops dense_tile_G (ROADMAP F10): an op built with it
    unpickles to the store the JAX op unpickles to."""
    for name in ("b16-auto", "b8-grouped", "b64-R4", "b32-G2"):
        _, layout, bsize, kw, _ = next(c for c in CASES if c[0] == name)
        jop, top = _pair(layout(), bsize, kw)
        t2, j2 = pickle.loads(pickle.dumps(top)), pickle.loads(
            pickle.dumps(jop))
        assert t2.w_layout == "fprop_packed"
        assert t2.w_shape == tuple(j2.w_shape)
        assert np.array_equal(t2.packed.pos, _jax_pos(j2))
        if "dense_tile_G" not in kw:
            assert t2.w_shape == top.w_shape
    assert t2.w_shape != top.w_shape          # b32-G2: the F10 case


def test_packed_inits_behave_as_jax_f9():
    """F9: the initialisers index the packed store by block id.  In the
    panel store both raise as JAX's do; in the slot store identity_init
    gives JAX's array bit for bit, and ortho_init JAX's written slots
    after the same np.random.seed (the others are np.empty's)."""
    _, layout, bsize, kw, _ = next(c for c in CASES if c[0] == "b16-auto")
    jop, top = _pair(layout(), bsize, kw)
    assert top.packed.panels
    for init in ("identity_init", "ortho_init"):
        with pytest.raises(ValueError):
            getattr(jop, init)()(None)
        with pytest.raises(ValueError):
            getattr(top, init)()(None)
    _, layout, bsize, kw, _ = next(c for c in CASES if c[0] == "b8-grouped")
    jop, top = _pair(layout(), bsize, kw)
    assert not top.packed.panels
    assert np.array_equal(top.identity_init(2.0)(None),
                          jop.identity_init(2.0)(None))
    assert not np.array_equal(top.unpack_weights(top.identity_init()(None)),
                              BlocksparseMatMul(layout(), bsize)
                              .identity_init()(None))
    np.random.seed(3)
    want = jop.ortho_init()(None)
    np.random.seed(3)
    got = top.ortho_init()(None)
    assert got.shape == want.shape == top.w_shape
    assert np.array_equal(got[:top.blocks], want[:top.blocks])
