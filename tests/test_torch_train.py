"""The port's training step against the JAX package's, from the same weights
and optimizer state.

On the CPU every op of the step runs its plain version: the block-sparse
matmul's fprop/bprop/updat (held against JAX ``impl="xla"``), the fused
attention's training forward, dq and dk/dv (held against the JAX fused
kernels in interpret mode, ``flash_bwd=True``), layer norm, embedding and
the softmax cross entropy through autograd, then the global-norm clip,
Adam and the dynamic loss scale.

Tolerances (f32 throughout, sums in other orders):
- loss, grad_norm, norm_scale: 1e-5 relative;
- every gradient: 1e-4 of the largest entry of its tensor.  The step does
  not return gradients; after one step from zero Adam state each mean
  slot is (1 - beta1)·norm_scale·g/loss_scale, so the mean slots are the
  gradients up to that shared, separately checked scalar;
- parameters after the step: 1e-5 absolute where |g| exceeds 1e-3 of the
  tensor's largest |g|.  Below that a gradient is rounding noise and may
  flip sign between packages; at t = 1 Adam moves every element by at
  most lr, so there the two may differ by up to 2·lr, and no more.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from blocksparse_tpu.models import SparseTransformerLM as JaxLM
from blocksparse_tpu.models import TransformerConfig as JaxConfig
from blocksparse_tpu.ops import optimize as jax_opt
from blocksparse_tpu.ops.transformer import (
    softmax_cross_entropy as jax_softmax_cross_entropy)

from blocksparse_tpu_torch import (AdamOptimizer, SparseTransformerLM,
                                   TransformerConfig, clip_by_global_norm,
                                   global_norm, opt_state_from_jax,
                                   params_from_jax, params_to_jax,
                                   softmax_cross_entropy)
from blocksparse_tpu_torch.kernels import bsmm as bsmm_kernels
from blocksparse_tpu_torch.kernels import bst_attn

torch.set_num_threads(2)
TOL = 1e-5
GRAD_TOL = 1e-4
LR = 1e-3
TINY = dict(n_vocab=64, n_embd=64, n_layer=2, n_head=4, ctx=64, blk_size=16,
            attn_layout="fixed", local_blocks=2, mlp_ratio=4,
            mlp_block_size=16, mlp_density=0.5, dtype="float32")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_softmax_cross_entropy_matches_jax(dtype):
    rng = np.random.RandomState(0)
    logits = (rng.standard_normal((3, 5, 64)) * 3).astype(np.float32)
    labels = rng.randint(0, 64, (3, 5)).astype(np.int32)
    dy = rng.standard_normal((3, 5)).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    ref, vjp = jax.vjp(lambda x: jax_softmax_cross_entropy(x, jnp.asarray(
        labels)), jnp.asarray(logits, jd))
    dref, = vjp(jnp.asarray(dy))
    x = torch.from_numpy(logits).to(td).requires_grad_()
    got = softmax_cross_entropy(x, torch.from_numpy(labels))
    got.backward(torch.from_numpy(dy))
    assert got.dtype == torch.float32 and x.grad.dtype == td
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               rtol=TOL, atol=TOL)
    tol = TOL if dtype == "float32" else 2 ** -8    # one bf16 rounding
    np.testing.assert_allclose(x.grad.float().numpy(),
                               np.asarray(dref.astype(jnp.float32)),
                               rtol=tol, atol=tol)


def _grad_tree(seed, poison=False):
    rng = np.random.RandomState(seed)
    g = {"a": rng.standard_normal((4, 6)).astype(np.float32) * 3,
         "b": rng.standard_normal((5,)).astype(np.float32) * 0.01}
    if poison:
        g["a"][1, 2] = np.inf
        g["b"][0] = np.nan
    return g


@pytest.mark.parametrize("poison", [False, True])
def test_clip_by_global_norm_matches_jax(poison):
    g = _grad_tree(1, poison)
    tg = {k: torch.from_numpy(a) for k, a in g.items()}
    for kw in (dict(clip_norm=1.0, grad_scale=0.5),
               dict(clip_norm=100.0, saturate=2.0),
               dict(clip_norm=1.0, zero_infs=True, zero_nans=True)):
        gn, ns = clip_by_global_norm(tg, **kw)
        rgn, rns = jax_opt.clip_by_global_norm(
            {k: jnp.asarray(a) for k, a in g.items()}, **kw)
        np.testing.assert_allclose([float(gn), float(ns)],
                                   [float(rgn), float(rns)], rtol=TOL)
        if poison and not kw.get("zero_infs") and not kw.get("saturate"):
            assert float(ns) == 0.0
    np.testing.assert_allclose(
        float(global_norm(tg, zero_infs=True, zero_nans=True)),
        float(jax_opt.global_norm({k: jnp.asarray(a) for k, a in g.items()},
                                  zero_infs=True, zero_nans=True)), rtol=TOL)


@pytest.mark.parametrize("kw,norm_scale", [
    (dict(), 1.0), (dict(clip_sigmas=1.5, zero_infs=True, zero_nans=True),
                    0.5), (dict(beta1=0.8, saturate=2.0), 0.0)])
def test_adam_matches_jax(kw, norm_scale):
    """Two AdamOptimizer.apply steps fed identical NumPy gradients; a
    norm_scale of 0 leaves params, mean and var untouched."""
    rng = np.random.RandomState(2)
    params = {"a": rng.standard_normal((4, 6)).astype(np.float32),
              "b": rng.standard_normal((5,)).astype(np.float32)}
    ref_opt = jax_opt.AdamOptimizer(learning_rate=0.01, **kw)
    port_opt = AdamOptimizer(learning_rate=0.01, **kw)
    rp = {k: jnp.asarray(a) for k, a in params.items()}
    rs = ref_opt.init(rp)
    pp = {k: torch.from_numpy(a) for k, a in params.items()}
    ps = port_opt.init(pp)
    for step in range(2):
        g = _grad_tree(10 + step, poison=kw.get("zero_nans", False))
        rp, rs = ref_opt.apply({k: jnp.asarray(a) for k, a in g.items()}, rp,
                               rs, norm_scale=norm_scale, grad_scale=0.5)
        pp, ps = port_opt.apply({k: torch.from_numpy(a) for k, a in g.items()},
                                pp, ps, norm_scale=torch.tensor(norm_scale),
                                grad_scale=0.5)
        assert int(ps["t"]) == int(rs["t"]) == step + 1
        for k in params:
            for got, want in ((pp[k], rp[k]), (ps["mean"][k], rs["mean"][k]),
                              (ps["var"][k], rs["var"][k])):
                np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                           rtol=TOL, atol=1e-7)
    if norm_scale == 0.0:
        for k in params:
            np.testing.assert_array_equal(pp[k].numpy(), params[k])
            assert not ps["mean"][k].any() and not ps["var"][k].any()


def test_unported_optimizer_options_raise():
    """Every AdamOptimizer option is ported now: 16-bit and gated
    optimizers build, and only an unknown state format raises."""
    for kw, fmt in ((dict(fp16=True), "bfloat16"),
                    (dict(state_format="packed16"), "packed16"),
                    (dict(gated=True), "float32")):
        assert AdamOptimizer(**kw).state_format == fmt
    with pytest.raises(ValueError):
        AdamOptimizer(state_format="float16")


def _jax_setup(recompute):
    cfg = dict(TINY, recompute=recompute)
    jax_model = JaxLM(JaxConfig(**cfg))
    params = _np(jax_model.init(jax.random.PRNGKey(0)))
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


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, 64, (2, 64)).astype(np.int32),
            rng.randint(0, 64, (2, 64)).astype(np.int32))


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(a)
            for p, a in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("recompute", [True, False])
def test_train_step_matches_jax(recompute):
    jax_model, params, port = _jax_setup(recompute)
    tokens, targets = _batch()
    make_opt = dict(learning_rate=LR, zero_nans=True, zero_infs=True)
    ref_opt = jax_opt.AdamOptimizer(**make_opt)
    state0 = ref_opt.init(params)
    scale = 1024.0
    rp, rs, rm, rsc = jax_model.make_train_step(ref_opt)(
        params, state0, jnp.asarray(tokens), jnp.asarray(targets),
        jnp.asarray(scale))

    step = port.make_train_step(AdamOptimizer(**make_opt))
    ps, pm, psc = step(opt_state_from_jax(_np(state0), port),
                       torch.from_numpy(tokens).long(),
                       torch.from_numpy(targets).long(), scale)
    for k in ("loss", "grad_norm", "norm_scale"):
        np.testing.assert_allclose(float(pm[k]), float(rm[k]), rtol=TOL,
                                   err_msg=k)
    assert 0 < float(pm["norm_scale"]) < 1       # clipping is active here
    assert float(psc) == float(rsc) == np.float32(scale * 2 ** (1 / 2000))
    assert int(ps["t"]) == int(rs["t"]) == 1

    # gradients, through the first mean slot (see the module docstring)
    want_mean = params_from_jax(_np(rs["mean"]), port)
    for k, want in want_mean.items():
        np.testing.assert_allclose(ps["mean"][k].numpy(), want.numpy(),
                                   rtol=0,
                                   atol=GRAD_TOL * want.abs().max().item(),
                                   err_msg=k)

    want_p = params_from_jax(_np(rp), port)
    for k, got in port.state_dict().items():
        m = want_mean[k].abs()
        live = m > 1e-3 * m.max()
        diff = (got - want_p[k]).abs()
        assert diff[live].max() <= TOL, k
        assert diff.max() <= 2 * LR + TOL, k
    assert not torch.equal(port.wte, torch.tensor(params["wte"]))
    # params_to_jax writes the JAX layout back
    back = _leaves(params_to_jax(port))
    want = _leaves(_np(rp))
    assert back.keys() == want.keys()
    for k, a in want.items():
        assert back[k].shape == a.shape, k


def test_poisoned_weight_skips_update():
    """An inf weight gives a non-finite loss and gradient norm: norm_scale
    is 0, the update is skipped (every parameter and slot unchanged) and
    the loss scale halves (tests/test_model.py:82-98 for the port)."""
    _, params, port = _jax_setup(recompute=True)
    with torch.no_grad():
        port.h[0].w_qkv[0, 0] = float("inf")
    before = {k: v.clone() for k, v in port.state_dict().items()}
    opt = AdamOptimizer(learning_rate=LR)
    state = opt.init(dict(port.named_parameters()))
    tokens, targets = _batch(1)
    state, metrics, scale = port.make_train_step(opt)(
        state, torch.from_numpy(tokens).long(),
        torch.from_numpy(targets).long(), torch.tensor(1024.0))
    assert float(metrics["norm_scale"]) == 0.0
    assert not np.isfinite(float(metrics["grad_norm"]))
    assert float(scale) == 512.0 and int(state["t"]) == 1
    for k, v in port.state_dict().items():
        torch.testing.assert_close(v, before[k], rtol=0, atol=0,
                                   equal_nan=True)
    for slot in ("mean", "var"):
        assert not any(t.any() for t in state[slot].values())


def test_cpu_train_step_launches_no_kernel():
    """Eight steps on a fixed batch on the CPU: plain versions only (no
    kernel counter moves), finite losses that fall, scale never halved."""
    counters = (bsmm_kernels.bsmm_fprop, bsmm_kernels.bsmm_bprop,
                bsmm_kernels.bsmm_updat, bst_attn.attention_fwd,
                bst_attn.attention_fwd_lse, bst_attn.attention_dq,
                bst_attn.attention_dkv)
    before = [c.launches for c in counters]
    _, _, port = _jax_setup(recompute=True)
    opt = AdamOptimizer(learning_rate=3e-3, zero_nans=True, zero_infs=True)
    step = port.make_train_step(opt)
    state = opt.init(dict(port.named_parameters()))
    tokens, targets = (torch.from_numpy(a).long() for a in _batch(2))
    scale, losses = torch.tensor(2.0 ** 15), []
    for _ in range(8):
        state, metrics, scale = step(state, tokens, targets, scale)
        assert float(metrics["norm_scale"]) > 0
        losses.append(float(metrics["loss"]))
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    assert [c.launches for c in counters] == before
