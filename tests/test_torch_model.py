"""The port's SparseTransformerLM against the JAX package's, from the same
weights.

A tiny config in the style of tests/test_model.py with the flagship's
block-sparse MLP, f32.  JAX params from ``model.init`` (gains and biases
perturbed with seeded NumPy noise so that none is trivial) go through
``params_from_jax``.  Tolerance 1e-4 on logits: both sides compute in f32
through six ops a layer, summing in other orders.  JAX's PRNG cannot be
reproduced, so sampled tokens are not compared across packages.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from blocksparse_tpu.models import SparseTransformerLM as JaxLM
from blocksparse_tpu.models import TransformerConfig as JaxConfig

from blocksparse_tpu_torch import (SparseTransformerLM, TransformerConfig,
                                   generate_cached, params_from_jax,
                                   random_jax_params)
from blocksparse_tpu_torch.kernels import bsmm as bsmm_kernels
from blocksparse_tpu_torch.kernels import bst_attn

torch.set_num_threads(2)
TOL = 1e-4
TINY = dict(n_vocab=64, n_embd=64, n_layer=2, n_head=4, ctx=64, blk_size=16,
            attn_layout="fixed", local_blocks=2, mlp_ratio=4,
            mlp_block_size=16, mlp_density=0.5, dtype="float32")


def _models(**kw):
    cfg = dict(TINY, **kw)
    jax_model = JaxLM(JaxConfig(**cfg))
    params = jax.tree_util.tree_map(np.asarray,
                                    jax_model.init(jax.random.PRNGKey(0)))
    rng = np.random.RandomState(0)

    def perturb(path, a):
        name = str(path[-1])
        if "_g" in name or "_b" in name:
            return (a + 0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a
    params = jax.tree_util.tree_map_with_path(perturb, params)
    port = SparseTransformerLM(TransformerConfig(**cfg), device="cpu")
    port.load_state_dict(params_from_jax(params, port))
    return jax_model, params, port


def _tokens(batch, n, seed=0):
    return np.random.RandomState(seed).randint(0, 64, (batch, n)) \
        .astype(np.int32)


@pytest.mark.parametrize("mlp_block_size", [16, 0])
def test_forward_logits_match_jax(mlp_block_size):
    jax_model, params, port = _models(mlp_block_size=mlp_block_size)
    tokens = _tokens(2, 64)
    ref = np.asarray(jax_model.forward(params, jnp.asarray(tokens)))
    got = port(torch.from_numpy(tokens).long())
    assert got.dtype == torch.float32 and got.shape == (2, 64, 64)
    np.testing.assert_allclose(got.numpy(), ref, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("mlp_block_size", [16, 0])
def test_f16_forward_matches_jax(mlp_block_size):
    """dtype="float16": the port runs f16 natively; the JAX fused attention
    (and its Pallas bsmm) runs f16 inputs as bf16 and emits f16.  So the
    tolerance is bf16 level: 1e-2 of max(1, max|logits|), a few bf16 ulps
    (2^-8) through two layers."""
    jax_model, params, port = _models(dtype="float16",
                                      mlp_block_size=mlp_block_size)
    tokens = _tokens(2, 64, seed=6)
    ref = np.asarray(jax_model.forward(params, jnp.asarray(tokens)))
    got = port(torch.from_numpy(tokens).long())
    assert got.dtype == torch.float32 and bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=1e-2 * max(1.0, np.abs(ref).max()))


def test_prefill_and_teacher_forced_decode_match_jax():
    jax_model, params, port = _models()
    n, steps = 24, 6
    seq = _tokens(2, n + steps, seed=1)
    full = np.zeros((2, 64), np.int32)
    full[:, :n] = seq[:, :n]
    ref_logits, ref_caches = jax_model.prefill(params, jnp.asarray(full))
    logits, caches = port.prefill(torch.from_numpy(full).long())
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits),
                               rtol=TOL, atol=TOL)
    for c, rc in zip(caches, ref_caches):
        np.testing.assert_allclose(c["k"].numpy(), np.asarray(rc["k"]),
                                   rtol=TOL, atol=TOL)
    dec = jax.jit(jax_model.decode_forward)
    for i in range(steps):
        pos = n + i
        tok = seq[:, pos]
        ref_l, ref_caches = dec(params, jnp.asarray(tok), ref_caches,
                                jnp.asarray(pos, jnp.int32))
        got_l, caches = port.decode_forward(torch.from_numpy(tok).long(),
                                            caches, pos)
        np.testing.assert_allclose(got_l.numpy(), np.asarray(ref_l),
                                   rtol=TOL, atol=TOL, err_msg=f"pos {pos}")


def test_decode_from_empty_cache_matches_jax():
    jax_model, params, port = _models()
    seq = _tokens(2, 4, seed=4)
    ref_caches = jax_model.init_kv_cache(2)
    caches = port.init_kv_cache(2)
    assert caches[0]["k"].shape == (2, 64, 64)
    assert caches[0]["k"].dtype == torch.float32 and len(caches) == 2
    dec = jax.jit(jax_model.decode_forward)
    for pos in range(4):
        ref_l, ref_caches = dec(params, jnp.asarray(seq[:, pos]), ref_caches,
                                jnp.asarray(pos, jnp.int32))
        got_l, caches = port.decode_forward(
            torch.from_numpy(seq[:, pos]).long(), caches, pos)
        np.testing.assert_allclose(got_l.numpy(), np.asarray(ref_l),
                                   rtol=TOL, atol=TOL, err_msg=f"pos {pos}")


def test_stacked_jax_params_convert():
    """A stack_layers=True param dict (one ``hs`` dict with a leading
    layer dim) loads into the same module and gives the JAX logits."""
    cfg = dict(TINY, stack_layers=True)
    jax_model = JaxLM(JaxConfig(**cfg))
    params = jax.tree_util.tree_map(np.asarray,
                                    jax_model.init(jax.random.PRNGKey(1)))
    port = SparseTransformerLM(TransformerConfig(**cfg), device="cpu")
    port.load_state_dict(params_from_jax(params, port))
    tokens = _tokens(1, 64, seed=5)
    ref = np.asarray(jax_model.forward(params, jnp.asarray(tokens)))
    got = port(torch.from_numpy(tokens).long())
    np.testing.assert_allclose(got.numpy(), ref, rtol=TOL, atol=TOL)


def test_generate_cached_is_seeded_and_in_range():
    port = SparseTransformerLM(TransformerConfig(**TINY), device="cpu")
    port.load_state_dict(params_from_jax(random_jax_params(port, seed=3),
                                         port))
    prompt = torch.from_numpy(_tokens(3, 10, seed=2)).long()
    outs = [generate_cached(port, prompt, 8, temperature=0.9,
                            generator=torch.Generator().manual_seed(5))
            for _ in range(2)]
    assert outs[0].shape == (3, 18)
    assert torch.equal(outs[0], outs[1])
    assert torch.equal(outs[0][:, :10], prompt)
    assert ((outs[0] >= 0) & (outs[0] < 64)).all()


def test_model_runs_on_the_card_unless_asked_for_the_cpu(monkeypatch):
    """With no device the model goes to the CUDA card; a host without one
    raises and names device="cpu" instead of carrying on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        SparseTransformerLM(TransformerConfig(**TINY))
    port = SparseTransformerLM(TransformerConfig(**TINY), device="cpu")
    assert all(p.device.type == "cpu" for p in port.parameters())
    logits = port(torch.zeros((1, 64), dtype=torch.long))
    assert logits.shape == (1, 64, 64) and bool(torch.isfinite(logits).all())


def test_cpu_path_launches_no_kernel_and_rejects_unported_options():
    before = (bsmm_kernels.bsmm_fprop.launches,
              bst_attn.attention_fwd.launches)
    _, _, port = _models()
    port(torch.zeros((1, 64), dtype=torch.long))
    assert (bsmm_kernels.bsmm_fprop.launches,
            bst_attn.attention_fwd.launches) == before
    # pp builds one stage (n_layer/pp blocks) and MoE ep one rank's E/ep
    # experts; each runs only bound to a mesh; pp x sp is refused, as JAX
    pp2 = SparseTransformerLM(TransformerConfig(**dict(TINY, pp=2)),
                              device="cpu")
    assert len(pp2.h) == TINY["n_layer"] // 2 == pp2.n_local
    ep2 = SparseTransformerLM(TransformerConfig(**dict(
        TINY, moe_experts=2, ep=2)), device="cpu")
    assert tuple(ep2.h[0].moe.w1.shape)[0] == 1 and \
        tuple(ep2.h[0].moe.wg.shape) == (TINY["n_embd"], 2)
    for m in (pp2, ep2):
        with pytest.raises(ValueError, match="mesh"):
            m.loss(torch.zeros((1, 64), dtype=torch.long),
                   torch.zeros((1, 64), dtype=torch.long))
    with pytest.raises(ValueError, match="pp x sp"):
        SparseTransformerLM(TransformerConfig(**dict(TINY, pp=2, sp=2)),
                            device="cpu")
    # tp builds one rank's shard (n_head/tp heads, the MLP at hidden/tp);
    # it runs only bound to a mesh
    tp2 = SparseTransformerLM(TransformerConfig(**dict(TINY, tp=2)),
                              device="cpu")
    assert tuple(tp2.h[0].w_qkv.shape) == (64, 96)
    assert tp2.bst.heads == 2 and tp2.hidden_local == 128
    with pytest.raises(ValueError, match="mesh"):
        tp2(torch.zeros((1, 64), dtype=torch.long))
    with pytest.raises(ValueError, match="ep needs moe_experts"):
        SparseTransformerLM(TransformerConfig(**dict(TINY, ep=2)),
                            device="cpu")
    # MoE builds; its KV-cached decode raises, as the JAX asserts
    moe = SparseTransformerLM(TransformerConfig(**dict(TINY, moe_experts=2)),
                              device="cpu")
    with pytest.raises(NotImplementedError, match="KV-cached decode"):
        moe.prefill(torch.zeros((1, 64), dtype=torch.long))
    # residual dropout is ported: it builds, and drops nothing unasked
    drop = SparseTransformerLM(TransformerConfig(**dict(TINY,
                                                        resid_pdrop=0.1)),
                               device="cpu")
    drop.load_state_dict(port.state_dict())
    tokens = torch.zeros((1, 64), dtype=torch.long)
    assert torch.equal(drop(tokens), port(tokens))
