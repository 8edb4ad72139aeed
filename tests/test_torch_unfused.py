"""The port's unfused block-sparse attention ops against the JAX package's.

On the CPU the port's ``nt_op``, ``nn_op`` and ``tn_op`` run their plain
versions (``kernels/bst_trio.py``), held against the JAX trio on
``impl="xla"`` and, at block size 16, on ``impl="pallas"`` (the Pallas
kernels in interpret mode); the blocked ``masked_softmax``/``softmax``,
the dense softmax family, ``attention(use_fused=False)``,
``flash_bwd=False`` and the LM past a head size of 128 against the same
JAX functions, from the same NumPy inputs.

Tolerances: f32 1e-5 of max(1, max|JAX|) (the same f32 sums in other
orders); bf16 and f16 2e-2 of it (both sides round the f32 result once
to the input type; JAX's Pallas trio runs f16 as bf16).  The NumPy
goldens are the JAX package's code on the same layout: equal bit for bit.
The LM: forward logits and one train step's loss and grad norm at 1e-5,
its gradients (through Adam's first mean slot) at 1e-4 of each tensor's
largest.
"""
import pickle

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from blocksparse_tpu import BlocksparseTransformer as JaxBST
from blocksparse_tpu.models import SparseTransformerLM as JaxLM
from blocksparse_tpu.models import TransformerConfig as JaxConfig
from blocksparse_tpu.models.sparse_transformer import (
    causal_subblock_mask, fixed_layout)
from blocksparse_tpu.ops import optimize as jax_opt
from blocksparse_tpu.ops import transformer as jax_tr

import blocksparse_tpu_torch as bt
from blocksparse_tpu_torch import BlocksparseTransformer
from blocksparse_tpu_torch.kernels import bst_attn, bst_trio
from blocksparse_tpu_torch.ops import transformer as port_tr

torch.set_num_threads(2)
F32_TOL, HALF_TOL, GRAD_TOL = 1e-5, 2e-2, 1e-4
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16),
          "float16": (torch.float16, jnp.float16)}


def _layouts(ctx_blks, heads, per_head, seed, empty=True):
    """A random layout (or one per head) with the same block count in
    every head; with ``empty`` query row 1 and key row 2 hold no block,
    else every query row holds its diagonal block."""
    rng = np.random.RandomState(seed)
    lays = []
    for _ in range(heads if per_head else 1):
        lay = (rng.rand(ctx_blks, ctx_blks) < 0.5).astype(np.int32)
        lay[0, 0] = 1
        if empty:
            lay[1, :] = 0
            lay[:, 2] = 0
        else:
            lay[np.arange(ctx_blks), np.arange(ctx_blks)] = 1
        lays.append(lay)
    want = min(int(lay.sum()) for lay in lays)
    for lay in lays:
        extra = int(lay.sum()) - want
        on = np.argwhere(lay * (1 - np.eye(ctx_blks, dtype=np.int32)))
        on = on[on[:, 0] >= 2][:extra]
        lay[on[:, 0], on[:, 1]] = 0
    return np.array(lays) if per_head else lays[0]


def _pair(layout, bs, heads, mask_callback=None, impl="xla"):
    return (JaxBST(layout, block_size=bs, heads=heads,
                   mask_callback=mask_callback, impl=impl),
            BlocksparseTransformer(layout, block_size=bs, heads=heads,
                                   mask_callback=mask_callback))


def _close(got, ref, tol, what=""):
    ref = np.asarray(jnp.asarray(ref).astype(jnp.float32))
    got = got.detach().float().numpy()
    assert got.shape == ref.shape, what
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=tol * max(1.0, np.abs(ref).max()),
                               err_msg=what)


def _rand(rng, *shape):
    return rng.uniform(-1, 1, shape).astype(np.float32)


# ---------------- goldens and pickling ----------------

@pytest.mark.parametrize("bs", [8, 16])
@pytest.mark.parametrize("per_head", [False, True])
def test_goldens_equal_jax(bs, per_head):
    """The trio's goldens on a layout with an empty query row and key row;
    the softmax goldens (which take every query row to hold a block) on
    one whose rows all hold their diagonal."""
    heads, blks, hs = 2, 5, 8
    rng = np.random.RandomState(1)
    A, B = _rand(rng, 2, blks * bs, heads * hs), _rand(rng, 2, blks * bs,
                                                        heads * hs)
    for empty, names in ((True, ("nt_test", "nn_test", "tn_test")),
                         (False, ("masked_softmax_test",
                                  "masked_softmax_grad_test"))):
        layout = _layouts(blks, heads, per_head, seed=bs, empty=empty)
        jop, op = _pair(layout, bs, heads, causal_subblock_mask)
        W, DY = (_rand(rng, 2, heads, op.blocks, bs, bs) for _ in range(2))
        args = {"nt_test": (A, B), "nn_test": (W, B), "tn_test": (W, A),
                "masked_softmax_test": (W, 0.5),
                "masked_softmax_grad_test": (DY, W, 0.5)}
        for name in names:
            np.testing.assert_array_equal(getattr(op, name)(*args[name]),
                                          getattr(jop, name)(*args[name]),
                                          err_msg=name)
    np.testing.assert_array_equal(
        op.masked_softmax_test(W, 0.5, autoregress_at_key=3 * bs // 2),
        jop.masked_softmax_test(W, 0.5, autoregress_at_key=3 * bs // 2))
    assert [op.block_coord(b, h) for h in range(op.lut_heads)
            for b in range(op.blocks)] == \
        [jop.block_coord(b, h) for h in range(jop.lut_heads)
         for b in range(jop.blocks)]
    assert port_tr.sparse_coo_to_dense(op.nt_list[0], blks, blks).tolist() \
        == jax_tr.sparse_coo_to_dense(jop.nt_list[0], blks, blks).tolist()


def test_dense_goldens_equal_jax():
    rng = np.random.RandomState(2)
    x, dy = _rand(rng, 6, 32), _rand(rng, 6, 32)
    mask = (rng.rand(1, 32) < 0.7).astype(np.float32)
    y = jax_tr.masked_softmax_test(x, mask, 0.5)
    for name, args in (("masked_softmax_test", (x, mask, 0.5)),
                       ("masked_top_k_softmax_test", (x, 5, mask, 0.5)),
                       ("masked_softmax_grad_test", (dy, y, mask, 0.5)),
                       ("rectified_top_k_test", (x, 4))):
        np.testing.assert_array_equal(getattr(port_tr, name)(*args),
                                      getattr(jax_tr, name)(*args),
                                      err_msg=name)


@pytest.mark.parametrize("impl", [None, "xla"])
def test_pickling_round_trips(impl):
    layout = _layouts(4, 2, True, seed=3)
    op = BlocksparseTransformer(layout, block_size=16, heads=2,
                                mask_callback=causal_subblock_mask,
                                impl=impl, q_mult=1)
    op._tables(torch.device("cpu"))
    back = pickle.loads(pickle.dumps(op))
    assert (back.impl, back.q_mult, back.heads, back.blocks) == \
        (impl, 1, 2, op.blocks)
    assert back.nt_list == op.nt_list and back.nn_list == op.nn_list
    np.testing.assert_array_equal(back._mask_blocks, op._mask_blocks)
    np.testing.assert_array_equal(back.softmax_mask, op.softmax_mask)
    state = op.__getstate__()
    ref = JaxBST(layout, block_size=16, heads=2,
                 mask_callback=causal_subblock_mask, impl=impl, q_mult=1)
    jstate = ref.__getstate__()
    assert state.keys() == jstate.keys()
    np.testing.assert_array_equal(state["layout"], jstate["layout"])
    with pytest.raises(ValueError):
        BlocksparseTransformer(layout, block_size=16, heads=2, impl="cuda")


# ---------------- nt / nn / tn ----------------

def _trio_case(bs, per_head, dtype, seed, hs=8):
    heads, blks = 2, 5
    layout = _layouts(blks, heads, per_head, seed=seed)
    rng = np.random.RandomState(seed)
    ctx = blks * bs
    A, B, DY = (_rand(rng, 2, ctx, heads * hs) for _ in range(3))
    W = _rand(rng, 2, heads, int(layout[0].sum() if per_head
                                 else layout.sum()), bs, bs)
    return layout, heads, A, B, W, DY


def _trio_vs_jax(jop, op, dtype, A, B, W, DY, tol):
    """Forward and gradients of nt, nn and tn against JAX's."""
    td, jd = DTYPES[dtype]
    DW = np.random.RandomState(9).uniform(-1, 1, W.shape).astype(np.float32)
    for name, fn, args, cot in (
            ("nt", lambda o, a, b: o.nt_op(a, b), (A, B), DW),
            ("nn", lambda o, a, b: o.nn_op(a, b), (W, B), DY),
            ("tn", lambda o, a, b: o.tn_op(a, b), (W, A), DY)):
        ref, vjp = jax.vjp(lambda a, b: fn(jop, a, b),
                           *(jnp.asarray(x, jd) for x in args))
        grads = vjp(jnp.asarray(cot, jd))
        ts = [torch.from_numpy(x).to(td).requires_grad_() for x in args]
        got = fn(op, *ts)
        assert got.dtype == td, name
        got.backward(torch.from_numpy(cot).to(td))
        _close(got, ref, tol, name)
        for t, g, which in zip(ts, grads, "ab"):
            assert t.grad.dtype == td
            _close(t.grad, g, tol, f"{name} d{which}")


@pytest.mark.parametrize("per_head", [False, True])
@pytest.mark.parametrize("bs", [8, 16, 32, 64])
def test_trio_matches_jax_f32(bs, per_head):
    layout, heads, A, B, W, DY = _trio_case(bs, per_head, "float32", bs + 1)
    jop, op = _pair(layout, bs, heads)
    _trio_vs_jax(jop, op, "float32", A, B, W, DY, F32_TOL)
    # the goldens agree too
    _close(op.nt_op(torch.from_numpy(A), torch.from_numpy(B)),
           op.nt_test(A, B), F32_TOL)


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("bs", [8, 32])
def test_trio_matches_jax_half(bs, dtype):
    layout, heads, A, B, W, DY = _trio_case(bs, True, dtype, bs + 2, hs=16)
    jop, op = _pair(layout, bs, heads)
    _trio_vs_jax(jop, op, dtype, A, B, W, DY, HALF_TOL)


@pytest.mark.parametrize("per_head", [False, True])
def test_trio_matches_jax_pallas(per_head):
    """At block size 16, against the JAX trio's Pallas kernels
    (updat_pallas_dense_tile and xprop_pallas_dense_tile, interpret
    mode)."""
    layout, heads, A, B, W, DY = _trio_case(16, per_head, "float32", 4)
    jop, op = _pair(layout, 16, heads, impl="pallas")
    _trio_vs_jax(jop, op, "float32", A, B, W, DY, F32_TOL)


def test_trio_pads_head_sizes():
    """A head size that is not a multiple of 8 (12): the plain versions
    take it as it is; the kernels' route pads it (``_head8``) and the
    result is cropped back."""
    layout, heads, A, B, W, DY = _trio_case(16, False, "float32", 5, hs=12)
    jop, op = _pair(layout, 16, heads)
    _trio_vs_jax(jop, op, "float32", A, B, W, DY, F32_TOL)
    a = torch.from_numpy(A)
    padded = port_tr._head8(a, heads)
    assert padded.shape[-1] == heads * 16
    assert torch.equal(port_tr._crop(padded, a.shape[1], heads, 12), a)


def test_trio_plain_versions_on_the_tables():
    """The plain versions against the NumPy goldens, fed the kernels'
    CSRs (``trio_tables``): row i's entries, in order."""
    layout, heads, A, B, W, DY = _trio_case(16, True, "float32", 6)
    op = BlocksparseTransformer(layout, block_size=16, heads=heads)
    tri = bst_trio.trio_tables(op.nt_list, op.ctx_blks_q, op.ctx_blks_k)
    for h in range(heads):
        for r, lut in enumerate(op.nn_list[h]):
            lo, hi = tri["row_ptr"][h, r:r + 2]
            assert [(b, k) for b, k in lut] == list(zip(
                tri["ent_e"][h, lo:hi], tri["ent_k"][h, lo:hi]))
        for c, lut in enumerate(op.tn_list[h]):
            lo, hi = tri["row_ptr_t"][h, c:c + 2]
            assert [(b, q) for b, q in lut] == list(zip(
                tri["ent_b"][h, lo:hi], tri["ent_q"][h, lo:hi]))
    tab = op._tables(torch.device("cpu"))
    w = bst_trio.bst_xn_plain(torch.from_numpy(W), torch.from_numpy(B),
                              tab["q_blk"], tab["k_blk"], op.ctx_blks_q,
                              heads, 16, False)
    _close(w, op.nn_test(W, B), F32_TOL)
    with pytest.raises(ValueError, match="CUDA"):
        bst_trio.bst_nt(torch.from_numpy(A), torch.from_numpy(B),
                        tab["tri_row_ptr"], tab["tri_ent_k"], heads, 16)


# ---------------- blocked softmax ----------------

@pytest.mark.parametrize("key", [None, 40, "tensor"])
@pytest.mark.parametrize("per_head", [False, True])
def test_blocked_masked_softmax_matches_jax(per_head, key):
    bs, heads, blks = 16, 2, 5
    layout = np.tril(np.ones((blks, blks), np.int32))
    if per_head:
        layout = np.stack([layout, layout.copy()])
        layout[1, 3, 0], layout[1, 0, 3] = 0, 1   # same count, other blocks
    jop, op = _pair(layout, bs, heads, causal_subblock_mask)
    rng = np.random.RandomState(7)
    X, DY = (_rand(rng, 2, heads, op.blocks, bs, bs) * 3 for _ in range(2))
    arg = (None if key is None else
           torch.tensor(40) if key == "tensor" else key)
    ref, vjp = jax.vjp(lambda x: jop.masked_softmax(
        x, scale=0.7, autoregress_at_key=None if key is None else 40),
        jnp.asarray(X))
    dref, = vjp(jnp.asarray(DY))
    x = torch.from_numpy(X).requires_grad_()
    got = op.masked_softmax(x, scale=0.7, autoregress_at_key=arg)
    got.backward(torch.from_numpy(DY))
    _close(got, ref, F32_TOL)
    _close(x.grad, dref, F32_TOL, "dx")
    want = op.masked_softmax_test(X, 0.7, None if key is None else 40)
    _close(got, want, F32_TOL, "golden")
    if key is None:
        _close(x.grad, op.masked_softmax_grad_test(
            DY, got.detach().numpy(), 0.7), F32_TOL, "golden grad")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_blocked_softmax_matches_jax(dtype):
    bs, heads = 8, 2
    layout = _layouts(6, heads, False, seed=8)
    jop, op = _pair(layout, bs, heads)
    td, jd = DTYPES[dtype]
    rng = np.random.RandomState(8)
    X, DY = (_rand(rng, 2, heads, op.blocks, bs, bs) for _ in range(2))
    ref, vjp = jax.vjp(lambda x: jop.softmax(x, scale=2.0),
                       jnp.asarray(X, jd))
    dref, = vjp(jnp.asarray(DY, jd))
    x = torch.from_numpy(X).to(td).requires_grad_()
    got = op.masked_softmax(x, scale=2.0)       # no masks: softmax
    got.backward(torch.from_numpy(DY).to(td))
    tol = F32_TOL if dtype == "float32" else HALF_TOL
    _close(got, ref, tol)
    _close(x.grad, dref, tol, "dx")
    assert op.softmax(x, 2.0, dtype=torch.float32).dtype == torch.float32
    with pytest.raises(ValueError, match="autoregress_at_key"):
        op.masked_softmax(x, autoregress_at_key=3)


# ---------------- the dense family ----------------

@pytest.mark.parametrize("masked", [False, True])
def test_dense_softmax_family_matches_jax(masked):
    rng = np.random.RandomState(10)
    x, dy = _rand(rng, 3, 4, 48) * 4, _rand(rng, 3, 4, 48)
    mask = (rng.rand(1, 4, 48) < 0.6).astype(np.float32) * 1.5 \
        if masked else None
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else torch.from_numpy(mask)
    ref, vjp = jax.vjp(lambda a: jax_tr.masked_softmax(a, jm, 0.5),
                       jnp.asarray(x))
    dref, = vjp(jnp.asarray(dy))
    xt = torch.from_numpy(x).requires_grad_()
    got = bt.masked_softmax(xt, tm, 0.5)
    got.backward(torch.from_numpy(dy))
    _close(got, ref, F32_TOL)
    _close(xt.grad, dref, F32_TOL, "dx")
    _close(bt.softmax(torch.from_numpy(x), 0.5),
           jax_tr.softmax(jnp.asarray(x), 0.5), F32_TOL, "softmax")
    _close(bt.masked_top_k_softmax(torch.from_numpy(x), 6, tm, 0.5),
           jax_tr.masked_top_k_softmax(jnp.asarray(x), 6, jm, 0.5), F32_TOL,
           "top-k softmax")
    for rebase in (True, False):
        _close(bt.rectified_top_k(torch.from_numpy(x), 5, rebase),
               jax_tr.rectified_top_k(jnp.asarray(x), 5, rebase), F32_TOL,
               "rectified_top_k")
    vals, idx = bt.top_k(torch.from_numpy(x), 7)
    jvals, jidx = jax_tr.top_k(jnp.asarray(x), 7)
    _close(vals, jvals, 0.0, "top_k values")
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    x4 = torch.from_numpy(_rand(rng, 2, 3, 4, 5))
    np.testing.assert_array_equal(
        bt.transpose_0213(x4).numpy(),
        np.asarray(jax_tr.transpose_0213(jnp.asarray(x4.numpy()))))
    np.testing.assert_array_equal(bt.transpose_2d(x4[0, 0]).numpy(),
                                  x4[0, 0].numpy().T)
    assert bt.clear_bst_constants() is None
    with pytest.raises(ValueError):
        bt.top_k(torch.ones(2, 1025), 3)


# ---------------- attention on the unfused route ----------------

def _attn_inputs(seed, batch, ctx, state):
    rng = np.random.RandomState(seed)
    return [rng.standard_normal((batch, ctx, state)).astype(np.float32)
            for _ in range(4)]


@pytest.mark.parametrize("bs,hs,flash_bwd", [
    (16, 16, True), (8, 24, True), (16, 16, False)])
def test_unfused_attention_matches_jax(bs, hs, flash_bwd):
    """attention(use_fused=False) (the trio) and, with flash_bwd=False, the
    fused forward with the trio's backward, against JAX: forward and
    gradients."""
    heads, blks = 2, 4
    layout = fixed_layout(blks, local_blocks=2)
    jop, op = _pair(layout, bs, heads, causal_subblock_mask, impl=None)
    use_fused = None if not flash_bwd else False
    q, k, v, do = _attn_inputs(bs + hs, 2, blks * bs, heads * hs)
    scale = hs ** -0.5
    ref, vjp = jax.vjp(lambda a, b, c: jop.attention(
        a, b, c, scale=scale, use_fused=use_fused, flash_bwd=flash_bwd),
        *(jnp.asarray(t) for t in (q, k, v)))
    grads = vjp(jnp.asarray(do))
    ts = [torch.from_numpy(t).requires_grad_() for t in (q, k, v)]
    before = bst_trio.bst_nt.launches
    got = op.attention(*ts, scale=scale, use_fused=use_fused,
                       flash_bwd=flash_bwd)
    got.backward(torch.from_numpy(do))
    assert bst_trio.bst_nt.launches == before        # plain versions
    _close(got, ref, F32_TOL)
    for t, g, name in zip(ts, grads, ("dq", "dk", "dv")):
        _close(t.grad, g, F32_TOL, name)


def _f1_mask(blk_shape, head, qry, key, blk):
    """Causal diagonal, except that query row 3 of block-row 1 sees no key
    at all."""
    mask = causal_subblock_mask(blk_shape, head, qry, key, blk)
    if qry == 1:
        mask[3, :] = False
    return mask


def test_fully_masked_row_on_the_unfused_route_matches_jax():
    """F1: a query row that sees no key is the mean of v over its blocks'
    keys on the unfused route (the -finfo(f32).max fill), as in JAX's
    unfused ops, and zeros on the fused route: use_fused changes it."""
    heads, bs, blks = 2, 16, 4
    layout = np.tril(np.ones((blks, blks), np.int32))
    jop, op = _pair(layout, bs, heads, _f1_mask, impl=None)
    q, k, v, _ = _attn_inputs(11, 2, blks * bs, heads * 16)
    ref = jop.attention(*(jnp.asarray(t) for t in (q, k, v)), scale=0.25,
                        use_fused=False)
    qt, kt, vt = (torch.from_numpy(t) for t in (q, k, v))
    got = op.attention(qt, kt, vt, scale=0.25, use_fused=False)
    _close(got, ref, F32_TOL)
    dead = bs + 3
    mean = vt[:, :2 * bs].mean(1)          # block-row 1 sees key blocks 0-1
    torch.testing.assert_close(got[:, dead], mean, rtol=0, atol=F32_TOL)
    fused = op.attention(qt, kt, vt, scale=0.25)
    assert (fused[:, dead] == 0).all()
    live = torch.ones(blks * bs, dtype=torch.bool)
    live[dead] = False
    torch.testing.assert_close(fused[:, live], got[:, live], rtol=0,
                               atol=F32_TOL)


def test_flash_bwd_false_runs_the_fused_forward():
    """flash_bwd=False: the forward is the fused serving forward (one
    bst_attn plain forward, no lse), the backward the trio's.  The two
    backward routes sum in other orders: their gradients agree at the
    file's gradient tolerance of max|g|, and each agrees with the
    gradient of JAX's attention (its unfused XLA route, the same
    function)."""
    heads, bs, blks = 1, 16, 2
    layout = np.ones((blks, blks), np.int32)
    jop, op = _pair(layout, bs, heads)
    qn = np.random.RandomState(7).standard_normal(
        (1, blks * bs, 16)).astype(np.float32)
    q = torch.from_numpy(qn).requires_grad_()
    y = op.attention(q, q, q, flash_bwd=False)
    y2 = op.attention(q, q, q)
    torch.testing.assert_close(y, y2, rtol=0, atol=0)
    (g1,) = torch.autograd.grad(y.sum(), q)
    (g2,) = torch.autograd.grad(y2.sum(), q)
    scale = g2.abs().max().item()
    torch.testing.assert_close(g1, g2, rtol=0, atol=GRAD_TOL * scale)
    ref = jax.grad(lambda x: jop.attention(x, x, x, use_fused=False).sum())(
        jnp.asarray(qn))
    for g in (g1, g2):
        np.testing.assert_allclose(g.numpy(), np.asarray(ref), rtol=0,
                                   atol=GRAD_TOL * scale)


# ---------------- the LM past a head size of 128 ----------------

WIDE = dict(n_vocab=32, n_embd=288, n_layer=2, n_head=2, ctx=64, blk_size=16,
            attn_layout="fixed", local_blocks=2, mlp_ratio=2,
            mlp_block_size=0, dtype="float32", recompute=True)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def test_lm_past_head_size_128_matches_jax():
    """2 heads of 144: the JAX LM takes the unfused ops (hs > 128) and so
    does the port's, on their plain versions here.  Forward logits and
    one make_train_step (loss, grad norm, gradients) against JAX's."""
    jax_model = JaxLM(JaxConfig(**WIDE))
    params = _np(jax_model.init(jax.random.PRNGKey(1)))
    port = bt.SparseTransformerLM(bt.TransformerConfig(**WIDE), device="cpu")
    port.load_state_dict(bt.params_from_jax(params, port))
    assert port.hs == 144 and not port_tr._can_fuse(port.hs)
    rng = np.random.RandomState(3)
    tokens, targets = (rng.randint(0, 32, (2, 64)).astype(np.int32)
                       for _ in range(2))
    ref = jax_model.forward(params, jnp.asarray(tokens))
    trio = bst_trio.bst_nt.launches
    got = port(torch.from_numpy(tokens).long())
    assert bst_trio.bst_nt.launches == trio          # plain versions
    _close(got, ref, F32_TOL, "logits")

    make_opt = dict(learning_rate=1e-3, zero_nans=True, zero_infs=True)
    ref_opt = jax_opt.AdamOptimizer(**make_opt)
    state0 = ref_opt.init(params)
    _, rs, rm, _ = jax_model.make_train_step(ref_opt)(
        params, state0, jnp.asarray(tokens), jnp.asarray(targets),
        jnp.asarray(1024.0))
    step = port.make_train_step(bt.AdamOptimizer(**make_opt))
    ps, pm, _ = step(bt.opt_state_from_jax(_np(state0), port),
                     torch.from_numpy(tokens).long(),
                     torch.from_numpy(targets).long(), 1024.0)
    for key in ("loss", "grad_norm", "norm_scale"):
        np.testing.assert_allclose(float(pm[key]), float(rm[key]),
                                   rtol=F32_TOL, err_msg=key)
    for name, want in bt.params_from_jax(_np(rs["mean"]), port).items():
        np.testing.assert_allclose(ps["mean"][name].numpy(), want.numpy(),
                                   rtol=0,
                                   atol=GRAD_TOL * want.abs().max().item(),
                                   err_msg=name)


def test_params_from_jax_carries_a_head_size_256_lm():
    """params_from_jax maps a JAX LM with 2 heads of 256 (the chip check's
    head count) as it maps any other: the same shapes and values, and
    the same logits on a short context."""
    cfg = dict(WIDE, n_embd=512, n_layer=1, ctx=32)
    jax_model = JaxLM(JaxConfig(**cfg))
    params = _np(jax_model.init(jax.random.PRNGKey(2)))
    port = bt.SparseTransformerLM(bt.TransformerConfig(**cfg), device="cpu")
    sd = bt.params_from_jax(params, port)
    assert sd.keys() == port.state_dict().keys()
    port.load_state_dict(sd)
    assert port.hs == 256
    np.testing.assert_array_equal(port.h[0].w_qkv.detach().numpy(),
                                  np.asarray(params["h0"]["w_qkv"]))
    tokens = np.random.RandomState(4).randint(0, 32, (1, 32)).astype(
        np.int32)
    _close(port(torch.from_numpy(tokens).long()),
           jax_model.forward(params, jnp.asarray(tokens)), F32_TOL)
