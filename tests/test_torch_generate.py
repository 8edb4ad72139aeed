"""The port's token loops against each other and against the JAX package's.

The TINY config of tests/test_torch_model.py (block-sparse MLP, f32) on the
CPU, where ``generate_cached_scan`` runs its graph's step function eagerly
in a loop.  JAX params from ``model.init`` (gains and biases perturbed with
seeded NumPy noise) go through ``params_from_jax``.

- ``decode_forward`` at a position given as a device tensor computes what
  it computes at an int position, bit for bit (one code path), and matches
  the JAX ``decode_forward`` at a traced position to 1e-4 (f32, other
  summation orders; tests/test_torch_model.py's tolerance).
- ``generate_cached_scan`` and ``generate`` emit ``generate_cached``'s
  tokens for one seed: one sampler, noise drawn up front from the seed.
- JAX's PRNG cannot be reproduced, so sampled tokens are compared across
  packages only where sampling is the argmax: at temperature 1e-6, with
  the JAX logits' top-two gap above twice the logits' tolerance at every
  step, each side's winner is the argmax of logits that agree to within
  the tolerance, so the two argmaxes agree.  The gap over T is then at
  least 2e-4 / 1e-6 = 200: JAX's Gumbel noise spans less than 22, and
  the port's softmax gives the runner-up exp(-200), 0 in f32.
- The optimizer's scalars now come from fills on the device instead of
  copies from the host: the same f32 values, so the same bits.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from blocksparse_tpu.models import SparseTransformerLM as JaxLM
from blocksparse_tpu.models import TransformerConfig as JaxConfig
from blocksparse_tpu.models.sparse_transformer import (
    generate_cached_scan as jax_generate_cached_scan)

from blocksparse_tpu_torch import (AdamOptimizer, SparseTransformerLM,
                                   TransformerConfig, clip_by_global_norm,
                                   generate, generate_cached,
                                   generate_cached_scan, params_from_jax)
from blocksparse_tpu_torch.models.sparse_transformer import (sample_noise,
                                                             sample_tokens)
from blocksparse_tpu_torch.ops import optimize
from blocksparse_tpu_torch.ops.transformer import position_tensor

torch.set_num_threads(2)
TOL = 1e-4
GREEDY_T = 1e-6
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


def _seed(s):
    return torch.Generator().manual_seed(s)


@pytest.mark.parametrize("as_tensor", [lambda p: torch.tensor(p),
                                       lambda p: torch.tensor([p])],
                         ids=["0-d", "1-element"])
def test_tensor_pos_equals_int_pos_and_matches_jax(as_tensor):
    jax_model, params, port = _models()
    n, steps = 24, 6
    seq = _tokens(2, n + steps, seed=1)
    full = np.zeros((2, 64), np.int32)
    full[:, :n] = seq[:, :n]
    ref_logits, ref_caches = jax_model.prefill(params, jnp.asarray(full))
    _, by_int = port.prefill(torch.from_numpy(full).long())
    _, by_tensor = port.prefill(torch.from_numpy(full).long())
    dec = jax.jit(jax_model.decode_forward)
    for pos in range(n, n + steps):
        tok = torch.from_numpy(seq[:, pos]).long()
        want, _ = port.decode_forward(tok, by_int, pos)
        got, _ = port.decode_forward(tok, by_tensor, as_tensor(pos))
        assert torch.equal(got, want), pos
        for a, b in zip(by_tensor, by_int):
            assert torch.equal(a["k"], b["k"]) and torch.equal(a["v"], b["v"])
        ref, ref_caches = dec(params, jnp.asarray(seq[:, pos]), ref_caches,
                              jnp.asarray(pos, jnp.int32))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=TOL,
                                   atol=TOL, err_msg=f"pos {pos}")


def test_position_tensor_takes_ints_and_one_element_tensors():
    for pos in (7, torch.tensor(7), torch.tensor([7], dtype=torch.int32)):
        t = position_tensor(pos, torch.device("cpu"))
        assert t.dtype == torch.int64 and tuple(t.shape) == (1,)
        assert int(t) == 7


@pytest.mark.parametrize("temperature", [1.0, 0.7])
def test_scan_tokens_equal_loop_tokens(temperature):
    """tests/test_model.py's scan-against-loop check for the port."""
    _, _, port = _models()
    prompt = torch.from_numpy(_tokens(2, 10, seed=3)).long()
    loop = generate_cached(port, prompt, 8, temperature, _seed(11))
    scan = generate_cached_scan(port, prompt, 8, temperature, _seed(11))
    assert scan.shape == (2, 18) and scan.dtype == torch.int64
    assert torch.equal(scan, loop)
    assert torch.equal(scan[:, :10], prompt)
    other = generate_cached_scan(port, prompt, 8, temperature, _seed(12))
    assert not torch.equal(other, loop)


def test_generate_equals_generate_cached():
    """tests/test_transformer.py's full-context-against-cached check for
    the port (f32)."""
    _, _, port = _models()
    prompt = torch.from_numpy(_tokens(2, 10, seed=0)).long()
    full = generate(port, prompt, 8, generator=_seed(7))
    cached = generate_cached(port, prompt, 8, generator=_seed(7))
    assert full.shape == (2, 18)
    assert torch.equal(full, cached)


def test_greedy_scan_matches_jax():
    jax_model, params, port = _models()
    n, steps = 12, 10
    prompt = _tokens(2, n, seed=5)
    ref = np.asarray(jax_generate_cached_scan(
        jax_model, params, jnp.asarray(prompt), steps, temperature=GREEDY_T,
        key=jax.random.PRNGKey(3)))
    got = generate_cached_scan(port, torch.from_numpy(prompt).long(), steps,
                               GREEDY_T, _seed(3))
    # the JAX logits each token was drawn from, teacher forced
    full = np.zeros((2, 64), np.int32)
    full[:, :n] = prompt
    logits, caches = jax_model.prefill(params, jnp.asarray(full))
    last = np.asarray(logits[:, n - 1])
    dec = jax.jit(jax_model.decode_forward)
    for i in range(steps):
        top2 = np.sort(last, axis=-1)[:, -2:]
        gap = (top2[:, 1] - top2[:, 0]).min()
        assert gap > 2 * TOL * (1 + np.abs(last).max()), (i, gap)
        assert (ref[:, n + i] == last.argmax(-1)).all(), i
        step_logits, caches = dec(params, jnp.asarray(ref[:, n + i]), caches,
                                  jnp.asarray(n + i, jnp.int32))
        last = np.asarray(step_logits)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_sampler_is_seeded_in_range_and_is_the_race():
    rng = np.random.RandomState(0)
    logits = torch.from_numpy(rng.standard_normal((3, 64)) * 2).float()
    noise = sample_noise((3, 64), _seed(4))
    assert noise.dtype == torch.float32 and bool((noise >= 0).all())
    assert torch.equal(noise, sample_noise((3, 64), _seed(4)))
    tok = sample_tokens(logits, 0.8, noise)
    assert tok.shape == (3,) and bool(((tok >= 0) & (tok < 64)).all())
    scaled = logits.numpy() / 0.8
    probs = np.exp(scaled - scaled.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    np.testing.assert_array_equal(tok.numpy(),
                                  (probs / noise.numpy()).argmax(-1))


def test_sampler_draws_from_the_softmax():
    """20,000 draws from five logits: each token's share within 0.015 of
    its probability (three standard errors at p = 0.5 are 0.011)."""
    logits = torch.tensor([[1.0, 0.0, -1.0, 2.0, 0.5]]).expand(20000, 5)
    tok = sample_tokens(logits, 1.0, sample_noise((20000, 5), _seed(9)))
    share = np.bincount(tok.numpy(), minlength=5) / 20000
    np.testing.assert_allclose(share, torch.softmax(logits[0], 0).numpy(),
                               atol=0.015)


def _host_scalar(x, like):
    """The optimizer's scalars as they were made before: copied from the
    host."""
    return torch.as_tensor(x, dtype=torch.float32, device=like.device)


def _grads(seed, poison=False):
    rng = np.random.RandomState(seed)
    g = {"a": torch.from_numpy(rng.standard_normal((4, 6)) * 3).float(),
         "b": torch.from_numpy(rng.standard_normal(5) * 0.01).float()}
    if poison:
        g["a"][1, 2] = np.inf
    return g


@pytest.mark.parametrize("poison", [False, True])
def test_clip_bits_unchanged_by_device_scalars(poison, monkeypatch):
    g = _grads(1, poison)
    for kw in (dict(clip_norm=1.0, grad_scale=0.5),
               dict(clip_norm=100.0, saturate=2.0),
               dict(clip_norm=1.0, grad_scale=torch.tensor(0.25),
                    zero_infs=True)):
        new = clip_by_global_norm(g, **kw)
        with monkeypatch.context() as m:
            m.setattr(optimize, "_scalar", _host_scalar)
            old = clip_by_global_norm(g, **kw)
        for a, b in zip(new, old):
            assert torch.equal(a, b) or (a.isnan() and b.isnan()), kw


@pytest.mark.parametrize("kw,norm_scale", [
    (dict(), 1.0), (dict(clip_sigmas=1.5, zero_infs=True), 0.5),
    (dict(beta1=0.8, saturate=2.0), 0.0)])
def test_adam_bits_unchanged_by_device_scalars(kw, norm_scale, monkeypatch):
    """Two AdamOptimizer.apply steps, scalars by fills against scalars
    copied from the host: params, mean, var and t equal bit for bit."""
    rng = np.random.RandomState(2)
    params = {"a": torch.from_numpy(rng.standard_normal((4, 6))).float(),
              "b": torch.from_numpy(rng.standard_normal(5)).float()}
    adam = AdamOptimizer(learning_rate=0.01, **kw)
    runs = []
    for scalar in (optimize._scalar, _host_scalar):
        with monkeypatch.context() as m:
            m.setattr(optimize, "_scalar", scalar)
            p, s = dict(params), adam.init(params)
            for step in range(2):
                p, s = adam.apply(_grads(10 + step, kw.get("zero_infs", False)),
                                  p, s, norm_scale=torch.tensor(norm_scale),
                                  grad_scale=0.5)
            runs.append((p, s))
    (p0, s0), (p1, s1) = runs
    for k in params:
        for a, b in ((p0[k], p1[k]), (s0["mean"][k], s1["mean"][k]),
                     (s0["var"][k], s1["var"][k])):
            assert torch.equal(a, b), k
    assert torch.equal(s0["t"], s1["t"])


def test_train_step_takes_a_float_loss_scale():
    """The README's quick start passes the loss scale as a float: the same
    bits as a tensor of it."""
    runs = []
    for scale in (1024.0, torch.tensor(1024.0)):
        _, _, port = _models(recompute=False)
        adam = AdamOptimizer(learning_rate=1e-3)
        step = port.make_train_step(adam)
        tokens, targets = (torch.from_numpy(_tokens(2, 64, seed=s)).long()
                           for s in (6, 7))
        state, metrics, new_scale = step(
            adam.init(dict(port.named_parameters())), tokens, targets, scale)
        runs.append((metrics, new_scale, port.state_dict()))
    (m0, sc0, p0), (m1, sc1, p1) = runs
    assert all(torch.equal(m0[k], m1[k]) for k in m0)
    assert torch.equal(sc0, sc1) and sc0.dtype == torch.float32
    assert all(torch.equal(p0[k], p1[k]) for k in p0)
