"""The port's public surface against the JAX package's, and the embedding
gradient.

Each callable below takes the JAX one's parameters, by name, in order,
with the same defaults, so a call written for the JAX package binds the
same way.  Knobs that do nothing on the card are accepted and ignored;
values the port has not ported (a matmul gate, a mesh) raise
``NotImplementedError``; ``flash_bwd=False`` runs and
matches the JAX package's.

The embedding gradient sums each id's rows in a fixed order (stable sort,
then a segment sum in f32, rounded once), against ``jax.grad`` of the JAX
``embedding_lookup`` with repeated ids: f32 within 1e-5 of the largest
|grad| (the same f32 adds, in other orders); bf16 within 2⁻⁸·(repeats + 1)
of it (JAX adds the repeated bf16 rows in bf16, rounding each add; the
port adds in f32 and rounds once).
"""
import inspect

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import blocksparse_tpu as jax_bs
from blocksparse_tpu.models import sparse_transformer as jax_st
from blocksparse_tpu.ops import embed as jax_embed
from blocksparse_tpu.ops import ewops as jax_ewops
from blocksparse_tpu.ops import norms as jax_norms
from blocksparse_tpu.ops import optimize as jax_opt

import blocksparse_tpu_torch as bt
from blocksparse_tpu_torch.models import sparse_transformer as port_st
from blocksparse_tpu_torch.ops import optimize as port_opt

torch.set_num_threads(2)

PAIRS = {
    "layer_norm": (bt.layer_norm, jax_norms.layer_norm),
    "embedding_lookup": (bt.embedding_lookup, jax_embed.embedding_lookup),
    "swish": (bt.swish, jax_ewops.swish),
    "fast_gelu": (bt.fast_gelu, jax_ewops.fast_gelu),
    "float_cast": (bt.float_cast, jax_ewops.float_cast),
    "BlocksparseMatMul.__call__": (bt.BlocksparseMatMul.__call__,
                                   jax_bs.BlocksparseMatMul.__call__),
    "BlocksparseTransformer.attention": (
        bt.BlocksparseTransformer.attention,
        jax_bs.BlocksparseTransformer.attention),
    "BlocksparseTransformer.__init__": (
        bt.BlocksparseTransformer.__init__,
        jax_bs.BlocksparseTransformer.__init__),
    "BlocksparseTransformer.nt_op": (bt.BlocksparseTransformer.nt_op,
                                     jax_bs.BlocksparseTransformer.nt_op),
    "BlocksparseTransformer.nn_op": (bt.BlocksparseTransformer.nn_op,
                                     jax_bs.BlocksparseTransformer.nn_op),
    "BlocksparseTransformer.tn_op": (bt.BlocksparseTransformer.tn_op,
                                     jax_bs.BlocksparseTransformer.tn_op),
    "BlocksparseTransformer.masked_softmax": (
        bt.BlocksparseTransformer.masked_softmax,
        jax_bs.BlocksparseTransformer.masked_softmax),
    "BlocksparseTransformer.softmax": (
        bt.BlocksparseTransformer.softmax,
        jax_bs.BlocksparseTransformer.softmax),
    "softmax": (bt.softmax, jax_bs.softmax),
    "masked_softmax": (bt.masked_softmax, jax_bs.masked_softmax),
    "masked_top_k_softmax": (bt.masked_top_k_softmax,
                             jax_bs.masked_top_k_softmax),
    "top_k": (bt.top_k, jax_bs.top_k),
    "rectified_top_k": (bt.rectified_top_k, jax_bs.rectified_top_k),
    "transpose_0213": (bt.transpose_0213, jax_bs.transpose_0213),
    "adam_apply": (port_opt.adam_apply, jax_opt.adam_apply),
    "make_train_step": (port_st.SparseTransformerLM.make_train_step,
                        jax_st.SparseTransformerLM.make_train_step),
}


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_signature_matches_jax(name):
    port, ref = (inspect.signature(f).parameters for f in PAIRS[name])
    assert list(port) == list(ref)
    for p, r in zip(port.values(), ref.values()):
        assert p.kind == r.kind, p.name
        if r.default is not inspect.Parameter.empty:
            assert p.default == r.default, p.name


def test_unported_values_raise():
    layout = np.eye(2, dtype=np.int32)
    packed = bt.BlocksparseMatMul(layout, block_size=8,  # the TPU order
                                  w_layout="fprop_packed")
    assert packed.w_shape == tuple(jax_bs.BlocksparseMatMul(
        layout, block_size=8, w_layout="fprop_packed").w_shape)
    op = bt.BlocksparseMatMul(layout, block_size=8, feature_axis=1)
    x, w = torch.ones(4, op.C), torch.ones(op.w_shape)
    for kw in (dict(gate=np.ones(op.blocks)), dict(gate_grad=True),
               dict(dw_gated=True)):                  # the gates: ported
        assert torch.equal(op(x, w, **kw), op(x, w))
    assert op(x, w, name="fc", bench=1).shape == (4, op.K)   # ignored
    bst = bt.BlocksparseTransformer(np.ones((1, 2, 2), np.int32),
                                    block_size=16, heads=1)
    ref = jax_bs.BlocksparseTransformer(np.ones((1, 2, 2), np.int32),
                                        block_size=16, heads=1)
    qn = np.random.RandomState(1).standard_normal((1, 32, 16)).astype(
        np.float32)
    y, vjp = jax.vjp(lambda a: ref.attention(a, a, a, flash_bwd=False),
                     jnp.asarray(qn))
    q = torch.from_numpy(qn).requires_grad_()
    got = bst.attention(q, q, q, flash_bwd=False)      # runs: no raise
    got.backward(torch.ones_like(got))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(y),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(q.grad.numpy(),
                               np.asarray(vjp(jnp.ones_like(y))[0]),
                               rtol=0, atol=1e-5)
    p = torch.ones(3)
    # gated Adam is ported: a zero gate leaves its block untouched
    p2, _, _ = port_opt.adam_apply(p, p, p, p, 1e-3,
                                   gate=torch.tensor([1.0, 0.0, 1.0]))
    assert p2[1] == 1.0 and p2[0] != 1.0
    cfg = bt.TransformerConfig(n_vocab=16, n_embd=32, n_layer=1, n_head=2,
                               ctx=32, blk_size=16, mlp_block_size=16)
    model = bt.SparseTransformerLM(cfg, device="cpu")
    # the sharded step is ported (test_torch_sharded_train); a mesh must be
    # a DeviceMesh; pipeline parallelism is ported (test_torch_pp_train):
    # pp 2 builds, and n_layer must divide by pp, as JAX asserts
    with pytest.raises(TypeError, match="DeviceMesh"):
        model.make_train_step(bt.AdamOptimizer(), mesh=object())
    pp_cfg = dict(n_vocab=16, n_embd=32, n_head=2, ctx=32, blk_size=16,
                  pp=2)
    assert len(bt.SparseTransformerLM(bt.TransformerConfig(
        n_layer=2, **pp_cfg), device="cpu").h) == 1
    with pytest.raises(ValueError, match="divide by pp"):
        bt.SparseTransformerLM(bt.TransformerConfig(n_layer=3, **pp_cfg),
                               device="cpu")
    model.make_train_step(bt.AdamOptimizer(), None, 0.5)      # positional
    x = torch.ones(2, 32)
    assert bt.layer_norm(x, torch.ones(32), torch.zeros(32), atomics=False,
                         bench=1, use_tf=True).shape == x.shape
    for fn in (bt.swish, bt.fast_gelu):
        assert torch.equal(fn(x, name="f"), fn(x))
    assert bt.float_cast(x, torch.bfloat16, name="c").dtype == torch.bfloat16


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_embedding_grad_with_repeated_ids_matches_jax(dtype):
    rng = np.random.RandomState(5)
    vocab, d, repeats = 12, 16, 7
    emb = rng.standard_normal((vocab, d)).astype(np.float32)
    ids = np.concatenate([np.repeat(np.arange(0, vocab, 2), repeats),
                          [1, 3, 3]])                 # ids 5, 7, ... unused
    ids = rng.permutation(ids).reshape(3, -1).astype(np.int32)
    dy = rng.standard_normal(ids.shape + (d,)).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    ref = jax.grad(lambda e: jnp.sum(
        jax_embed.embedding_lookup(e, jnp.asarray(ids)).astype(jnp.float32)
        * jnp.asarray(dy, jd).astype(jnp.float32)))(jnp.asarray(emb, jd))
    ref = np.asarray(ref.astype(jnp.float32))
    et = torch.from_numpy(emb).to(td).requires_grad_()
    out = bt.embedding_lookup(et, torch.from_numpy(ids), sort_grad=False)
    out.backward(torch.from_numpy(dy).to(td))
    assert et.grad.dtype == td
    tol = 1e-5 if dtype == "float32" else 2.0 ** -8 * (repeats + 1)
    got = et.grad.float().numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * np.abs(ref).max())
    assert (got[5::2] == 0).all() and (ref[5::2] == 0).all()


def test_embedding_grad_is_the_sorted_segment_sum():
    """The backward adds each id's rows in their order in idx, in f32, and
    rounds once: bit for bit the sequential sum, on every run."""
    rng = np.random.RandomState(6)
    ids = torch.from_numpy(rng.randint(0, 5, (4, 9)))
    dy = torch.from_numpy(rng.standard_normal((4, 9, 8)).astype(np.float32))
    want = torch.zeros(5, 8)
    for i, row in zip(ids.reshape(-1).tolist(), dy.reshape(-1, 8)):
        want[i] = want[i] + row
    grads = []
    for _ in range(2):
        et = torch.zeros(5, 8, requires_grad=True)
        bt.embedding_lookup(et, ids).backward(dy)
        grads.append(et.grad)
    assert torch.equal(grads[0], want) and torch.equal(grads[1], want)
