"""The port's block-sparse attention against the JAX package's.

On the CPU the port's ``attention`` runs its plain versions (masked
per-block references), held against the JAX fused kernels in interpret
mode: the forward, the training forward's lse
(``fused_attention_fwd_lse``) and the gradients (``jax.vjp`` of the JAX
fused attention, ``flash_bwd=True``); ``decode_step`` is held against
JAX ``decode_step``.  f32 tolerance 1e-5 (the same f32 softmax, summed
in other orders; gradients are O(1) here).

Fully masked query rows (a row whose mask hides every key): the port
defines their output as zeros, their lse as -inf and their gradients as
zeros, in the plain versions and the kernels alike.  The JAX fused
kernels give them a schedule-dependent value, so parity excludes such
rows.  The CUDA kernels are held against the plain versions, F1
included, in test_torch_cuda.py.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from blocksparse_tpu import BlocksparseTransformer as JaxBST
from blocksparse_tpu.kernels import bst_attn as jax_bst_attn
from blocksparse_tpu.models.sparse_transformer import (
    causal_subblock_mask, fixed_layout, strided_layout)

from blocksparse_tpu_torch import BlocksparseTransformer
from blocksparse_tpu_torch.kernels import bst_attn

torch.set_num_threads(2)
F32_TOL = 1e-5


def _pair(layout, bs, heads, mask_callback=causal_subblock_mask):
    return (JaxBST(layout, block_size=bs, heads=heads,
                   mask_callback=mask_callback),
            BlocksparseTransformer(layout, block_size=bs, heads=heads,
                                   mask_callback=mask_callback))


def _qkv(batch, ctx, state, seed):
    rng = np.random.RandomState(seed)
    return [rng.standard_normal((batch, ctx, state)).astype(np.float32)
            for _ in range(3)]


CASES = [  # (ctx, bs, heads, hs, layout)
    (64, 16, 2, 16, "fixed"),
    (128, 16, 4, 32, "strided"),
    (128, 32, 2, 32, "fixed"),
    (96, 32, 3, 16, "fixed"),
]


@pytest.mark.parametrize("ctx,bs,heads,hs,kind", CASES)
def test_attention_matches_jax_fused(ctx, bs, heads, hs, kind):
    blks = ctx // bs
    layout = (fixed_layout(blks, local_blocks=2) if kind == "fixed"
              else strided_layout(blks, local_blocks=2))
    ref, port = _pair(layout, bs, heads)
    Q, K, V = _qkv(2, ctx, heads * hs, seed=ctx + bs)
    scale = 1.0 / np.sqrt(hs)
    y_ref = np.asarray(ref.attention(jnp.asarray(Q), jnp.asarray(K),
                                     jnp.asarray(V), scale=scale,
                                     use_fused=True))
    y = port.attention(torch.from_numpy(Q), torch.from_numpy(K),
                       torch.from_numpy(V), scale=scale)
    assert y.shape == (2, ctx, heads * hs)
    np.testing.assert_allclose(y.numpy(), y_ref, rtol=F32_TOL, atol=F32_TOL)


def test_attention_per_head_layouts_match_jax():
    lay = fixed_layout(4, local_blocks=2)
    layout = np.stack([lay, lay[:, ::-1], lay, np.flipud(lay)])
    ref, port = _pair(layout, 16, 4)
    Q, K, V = _qkv(1, 64, 4 * 16, seed=7)
    y_ref = np.asarray(ref.attention(jnp.asarray(Q), jnp.asarray(K),
                                     jnp.asarray(V), scale=0.3,
                                     use_fused=True))
    y = port.attention(torch.from_numpy(Q), torch.from_numpy(K),
                       torch.from_numpy(V), scale=0.3)
    np.testing.assert_allclose(y.numpy(), y_ref, rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("bs,kind", [(16, "fixed"), (32, "strided")])
def test_decode_step_matches_jax(bs, kind):
    ctx, heads, hs = 128, 2, 16
    blks = ctx // bs
    layout = (fixed_layout(blks, local_blocks=2) if kind == "fixed"
              else strided_layout(blks, local_blocks=2))
    ref, port = _pair(layout, bs, heads)
    _, Kc, Vc = _qkv(2, ctx, heads * hs, seed=bs)
    rng = np.random.RandomState(bs + 1)
    for pos in (0, bs - 1, bs, 77, ctx - 1):
        q = rng.standard_normal((2, 1, heads * hs)).astype(np.float32)
        y_ref = np.asarray(ref.decode_step(jnp.asarray(q), jnp.asarray(Kc),
                                           jnp.asarray(Vc), pos, scale=0.25))
        y = port.decode_step(torch.from_numpy(q), torch.from_numpy(Kc),
                             torch.from_numpy(Vc), pos, scale=0.25)
        np.testing.assert_allclose(y.numpy(), y_ref, rtol=F32_TOL,
                                   atol=F32_TOL, err_msg=f"pos {pos}")


def _f1_mask(blk_shape, head, qry, key, blk):
    """Causal diagonal, except that query row 3 of block-row 1 sees no
    key at all."""
    mask = causal_subblock_mask(blk_shape, head, qry, key, blk)
    if qry == 1:
        mask[3, :] = False
    return mask


def _f1_inputs():
    bs, heads, hs = 8, 2, 16
    layout = np.tril(np.ones((4, 4), np.int32))
    Q, K, V = _qkv(2, 4 * bs, heads * hs, seed=11)
    return layout, bs, heads, Q, K, V


def test_fully_masked_row_is_zero_and_other_rows_match_jax():
    layout, bs, heads, Q, K, V = _f1_inputs()
    ref, port = _pair(layout, bs, heads, mask_callback=_f1_mask)
    y = port.attention(torch.from_numpy(Q), torch.from_numpy(K),
                       torch.from_numpy(V), scale=0.25).numpy()
    dead = 1 * bs + 3
    assert (y[:, dead] == 0).all()
    y_ref = np.asarray(ref.attention(jnp.asarray(Q), jnp.asarray(K),
                                     jnp.asarray(V), scale=0.25,
                                     use_fused=True))
    live = np.arange(y.shape[1]) != dead
    np.testing.assert_allclose(y[:, live], y_ref[:, live], rtol=F32_TOL,
                               atol=F32_TOL)


def _layout(kind, blks):
    lay = fixed_layout(blks, local_blocks=2)
    if kind == "strided":
        return strided_layout(blks, local_blocks=2)
    if kind == "per_head":
        return np.stack([lay, np.flipud(lay)])     # same block count per head
    return lay


def _to_flat(a, heads, bs):
    batch, ctx, state = a.shape
    hs = state // heads
    return a.reshape(batch, ctx // bs, bs, heads, hs).transpose(
        0, 3, 1, 2, 4).reshape(batch * heads, ctx, hs)


@pytest.mark.parametrize("ctx,bs,heads,hs,kind", [
    (64, 16, 2, 16, "fixed"), (128, 32, 2, 32, "strided"),
    (64, 16, 2, 16, "per_head")])
def test_fwd_lse_matches_jax(ctx, bs, heads, hs, kind):
    layout = _layout(kind, ctx // bs)
    ref, port = _pair(layout, bs, heads)
    Q, K, V = _qkv(2, ctx, heads * hs, seed=ctx + bs + 5)
    scale = 1.0 / np.sqrt(hs)
    yf, lse_ref = jax_bst_attn.fused_attention_fwd_lse(
        *(jnp.asarray(_to_flat(a, heads, bs)) for a in (Q, K, V)),
        ref.attn_schedule, heads, scale)
    tab = port._tables(torch.device("cpu"))
    y, lse = bst_attn.attention_fwd_lse_plain(
        *(torch.from_numpy(a) for a in (Q, K, V)), tab["q_blk"], tab["k_blk"],
        tab["mask"], heads, bs, scale)
    assert lse.dtype == torch.float32 and lse.shape == (2, heads, ctx)
    np.testing.assert_allclose(_to_flat(y.numpy(), heads, bs), np.asarray(yf),
                               rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(lse.numpy().reshape(-1),
                               np.asarray(lse_ref).reshape(-1), rtol=F32_TOL,
                               atol=F32_TOL)


def _grads(port, Q, K, V, dO, scale, ref=None):
    """(out, dq, dk, dv) of the port through autograd, and of the JAX fused
    attention through jax.vjp when ``ref`` is given."""
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in (Q, K, V))
    out = port.attention(q, k, v, scale=scale)
    out.backward(torch.from_numpy(dO))
    got = [out.detach().numpy()] + [t.grad.numpy() for t in (q, k, v)]
    if ref is None:
        return got
    y, vjp = jax.vjp(lambda a, b, c: ref.attention(a, b, c, scale=scale,
                                                   use_fused=True),
                     *(jnp.asarray(a) for a in (Q, K, V)))
    return got, [np.asarray(y)] + [np.asarray(g)
                                   for g in vjp(jnp.asarray(dO))]


@pytest.mark.parametrize("ctx,bs,heads,hs,kind", [
    (64, 16, 2, 16, "fixed"), (128, 32, 2, 32, "strided"),
    (128, 64, 2, 16, "fixed"), (128, 32, 2, 16, "per_head")])
def test_attention_grads_match_jax_vjp(ctx, bs, heads, hs, kind):
    layout = _layout(kind, ctx // bs)
    ref, port = _pair(layout, bs, heads)
    Q, K, V, dO = _qkv(2, ctx, heads * hs, seed=bs + 3) + _qkv(
        2, ctx, heads * hs, seed=bs + 4)[:1]
    got, want = _grads(port, Q, K, V, dO, 1.0 / np.sqrt(hs), ref)
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, w, rtol=F32_TOL, atol=F32_TOL,
                                   err_msg=name)


def test_bwd_plain_matches_autograd_of_fwd_plain():
    """The plain backward (P from the lse, the kernels' order of
    operations) against autograd through the plain forward itself."""
    layout = fixed_layout(4, local_blocks=2)
    port = BlocksparseTransformer(layout, block_size=16, heads=2,
                                  mask_callback=causal_subblock_mask)
    tab = port._tables(torch.device("cpu"))
    Q, K, V, dO = _qkv(2, 64, 32, seed=21) + _qkv(2, 64, 32, seed=22)[:1]
    args = (tab["q_blk"], tab["k_blk"], tab["mask"], 2, 16, 0.25)
    q, k, v = (torch.from_numpy(a).double().requires_grad_()
               for a in (Q, K, V))
    bst_attn.attention_fwd_plain(q, k, v, *args).backward(
        torch.from_numpy(dO).double())
    got = _grads(port, Q, K, V, dO, 0.25)
    for g, t in zip(got[1:], (q, k, v)):
        np.testing.assert_allclose(g, t.grad.numpy(), rtol=F32_TOL,
                                   atol=F32_TOL)


def test_fully_masked_row_has_zero_grads_and_other_grads_match_jax():
    """F1: the dead row's dq is zero and it adds nothing to dk/dv (its
    probabilities are defined as zero).  With its dO zeroed, neither
    package's dk/dv sees it, and every gradient matches JAX."""
    bs, heads = 32, 2
    layout = np.tril(np.ones((4, 4), np.int32))
    Q, K, V = _qkv(2, 4 * bs, heads * 16, seed=13)
    ref, port = _pair(layout, bs, heads, mask_callback=_f1_mask)
    dead = 1 * bs + 3
    dO = np.random.RandomState(12).standard_normal(Q.shape).astype(np.float32)
    out, dq, dk, dv = _grads(port, Q, K, V, dO, 0.25)
    assert (out[:, dead] == 0).all() and (dq[:, dead] == 0).all()
    dO0 = dO.copy()
    dO0[:, dead] = 0
    got, want = _grads(port, Q, K, V, dO0, 0.25, ref)
    np.testing.assert_array_equal(got[2], dk)      # the dead row adds nothing
    np.testing.assert_array_equal(got[3], dv)
    live = np.arange(Q.shape[1]) != dead
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        if name in ("out", "dq"):
            g, w = g[:, live], w[:, live]
        np.testing.assert_allclose(g, w, rtol=F32_TOL, atol=F32_TOL,
                                   err_msg=name)
