"""The port's Mixture-of-Experts against the JAX package's, on the CPU:
``route_topk``, ``BlocksparseMoE`` and the LM with MoE MLPs.

The same inputs, drawn with NumPy from a seed, go through the JAX
function (XLA on the CPU; the LM's fused attention in Pallas interpret
mode) and the port's (plain torch on the CPU).

Tolerances:
- ``route_topk``: dispatch and combine bit for bit (ties included); aux
  bit for bit on the uniform (all-tie) router, else within 2 units in the
  last place: the mean over the tokens is a column sum whose order XLA's
  CPU reduction picks by shape (no fixed order reproduces it for every
  token count);
- the layer, f32: y 1e-5 x max(1, max|ref|), aux 1e-6, each gradient
  1e-4 of its tensor's largest; the router ``wg``'s at k = 1 5e-4: its
  gate is topv / topv = 1, whose gradient cancels to a rounding residual
  that each package rounds its own way (about 5e-5 of the aux term that
  is the real gradient);
- the layer, bf16 (ROADMAP F6: f32 expert weights, bf16 tokens): 1e-2
  (one bf16 rounding of bsmm1's output and of dx, 2^-8, may land a place
  apart), and the dtypes exactly: y f32, dx bf16, the weights' f32;
- the LM (f32): logits 1e-5 x max, aux and loss 1e-5 relative; one train
  step: loss and grad_norm 1e-5 relative, each gradient (the first Adam
  mean slot) 1e-4 of its largest (``wg`` 5e-4, as above), parameters
  1e-5 where the gradient is above 1e-3 of its largest, else 2 lr (a
  noise-level gradient may flip Adam's first step).
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from blocksparse_tpu.models import SparseTransformerLM as JaxLM
from blocksparse_tpu.models import TransformerConfig as JaxConfig
from blocksparse_tpu.ops import moe as jmoe
from blocksparse_tpu.ops import optimize as jax_opt

import blocksparse_tpu_torch as bt
from blocksparse_tpu_torch.examples import enwik8 as port_enwik8
from blocksparse_tpu_torch.ops import moe as pmoe

torch.set_num_threads(2)
TOL, GRAD_TOL, WG_K1_TOL, BF16_TOL, LR = 1e-5, 1e-4, 5e-4, 1e-2, 1e-3


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, ref, tol, what=""):
    ref = np.asarray(ref, np.float64)
    got = got.detach().double().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float64)
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * max(
        1.0, np.abs(ref).max()), err_msg=what)


def _grad_close(got, ref, tol, what=""):
    ref = np.asarray(ref, np.float64)
    np.testing.assert_allclose(got.detach().double().numpy(), ref, rtol=0,
                               atol=tol * np.abs(ref).max(), err_msg=what)


# ---------------- route_topk ----------------

def _probs(kind, T, E, seed):
    rng = np.random.RandomState(seed)
    if kind == "uniform":                    # every row one tie
        return np.full((T, E), 1.0 / E, np.float32)
    if kind == "ties":                       # ties within rows
        p = rng.randint(1, 4, (T, E)).astype(np.float32)
    elif kind == "one-expert":               # every token picks expert 0
        p = np.tile(np.arange(E, 0, -1, dtype=np.float32), (T, 1))
    else:
        p = rng.rand(T, E).astype(np.float32)
    return (p / p.sum(1, keepdims=True)).astype(np.float32)


_ROUTES = [("random", 64, 8, 1, 16), ("random", 64, 8, 2, 24),
           ("random", 100, 4, 2, 48), ("random", 37, 3, 3, 8),
           ("uniform", 64, 8, 1, 8), ("uniform", 64, 8, 2, 16),
           ("ties", 48, 6, 2, 16), ("one-expert", 20, 4, 1, 8),
           ("one-expert", 20, 4, 2, 8)]


@pytest.mark.parametrize("kind,T,E,k,C", _ROUTES,
                         ids=[f"{a}-T{b}-E{c}-k{d}-C{e}"
                              for a, b, c, d, e in _ROUTES])
def test_route_topk_matches_jax_bit_for_bit(kind, T, E, k, C):
    """dispatch and combine equal JAX's bit for bit: ties go to the lower
    expert (``lax.top_k``'s rule), first choices win capacity, overflow
    drops; aux as the module docstring says."""
    p = _probs(kind, T, E, T + k)
    ref = [np.asarray(a) for a in jmoe.route_topk(jnp.asarray(p), k, C)]
    got = [a.numpy() for a in pmoe.route_topk(torch.from_numpy(p), k, C)]
    for name, a, b in zip(("dispatch", "combine", "aux"), got, ref):
        assert a.dtype == b.dtype, name
    for name, a, b in zip(("dispatch", "combine"), got, ref):
        np.testing.assert_array_equal(a, b, err_msg=name)
    if kind == "uniform":
        assert float(got[2]) == float(ref[2]) == 1.0
    assert abs(float(got[2]) - float(ref[2])) <= 2 ** -22 * float(ref[2])
    if kind == "one-expert":                 # expert 0 keeps C tokens
        assert got[0][:, 0].sum() == C and got[0][C:, 0].sum() == 0


# ---------------- the layer ----------------

def _layer_case(bs, k, dtype, E=4, T=64, d=32, h=64, cf=0.5):
    """The two layers, shared params (NumPy, f32), tokens x (T, d) in
    ``dtype`` and a cotangent for y.  cf 0.5 drops tokens."""
    kw = dict(block_size=bs, density=0.6, capacity_factor=cf, k=k)
    jm, pm = jmoe.BlocksparseMoE(E, d, h, **kw), pmoe.BlocksparseMoE(
        E, d, h, **kw)
    rng = np.random.RandomState(bs + 10 * k)
    params = {n: (rng.standard_normal(s) * (0.3 if n == "wg" else 0.1))
              .astype(np.float32) for n, s in pm.shapes().items()}
    x = jnp.asarray(rng.uniform(-1, 1, (T, d)), getattr(jnp, dtype))
    dy = rng.standard_normal((T, d)).astype(np.float32)
    return jm, pm, params, x, dy


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("bs", [0, 16])
def test_moe_layer_matches_jax(bs, k, dtype):
    """y, aux and every gradient (wg, w1, b1, w2, b2, x) against
    ``jax.vjp`` of the JAX layer, dense and b16 experts, with tokens
    dropped; in bf16 the dtypes of F6."""
    jm, pm, params, x, dy = _layer_case(bs, k, dtype)
    (yj, auxj), vjp = jax.vjp(lambda p, x: jm(p, x),
                              jax.tree_util.tree_map(jnp.asarray, params), x)
    gj, gxj = vjp((jnp.asarray(dy).astype(yj.dtype), jnp.float32(0.7)))
    pt = {n: torch.from_numpy(a).requires_grad_() for n, a in params.items()}
    xt = torch.from_numpy(np.asarray(x.astype(jnp.float32))).to(
        getattr(torch, dtype)).requires_grad_()
    y, aux = pm(pt, xt)
    assert y.dtype == torch.float32 and aux.dtype == torch.float32
    assert str(yj.dtype) == "float32"
    grads = torch.autograd.grad((y, aux), list(pt.values()) + [xt],
                                (torch.from_numpy(dy), torch.tensor(0.7)))
    assert grads[-1].dtype == xt.dtype
    assert all(g.dtype == torch.float32 for g in grads[:-1])
    tol = TOL if dtype == "float32" else BF16_TOL
    _close(y, np.asarray(yj), tol, "y")
    assert abs(float(aux) - float(auxj)) <= 1e-6
    if k == 1:                           # some tokens were dropped
        assert (y == 0).all(-1).any()
    for name, got in zip(list(params) + ["x"], grads):
        ref = np.asarray((gj[name] if name != "x" else gxj)
                         .astype(jnp.float32))
        g_tol = WG_K1_TOL if (name == "wg" and k == 1) else GRAD_TOL
        _grad_close(got.float(), ref, max(g_tol, 0 if dtype == "float32"
                                          else BF16_TOL), name)


def test_moe_layer_constructor_matches_jax():
    """The layout (seeded, no empty row or column), capacity, parameter
    shapes, specs and reduce axes as JAX's; init from a torch generator
    with JAX's shapes and scales; the refusals; ep 2 without an axis."""
    for bs, dens in ((16, 0.3), (32, 1.0), (0, 1.0)):
        jm = jmoe.BlocksparseMoE(8, 64, 256, block_size=bs, density=dens,
                                 capacity_factor=1.25, k=2, seed=3)
        pm = pmoe.BlocksparseMoE(8, 64, 256, block_size=bs, density=dens,
                                 capacity_factor=1.25, k=2, seed=3)
        if bs:
            for a, b in ((pm.bsmm1, jm.bsmm1), (pm.bsmm2, jm.bsmm2)):
                np.testing.assert_array_equal(a.layout, b.layout)
                assert a.updat_list == b.updat_list and a.axis == 1
        for n in (1, 7, 100, 16384):
            assert pm.capacity(n) == jm.capacity(n)
        ref = jm.init(jax.random.PRNGKey(0))
        got = pm.init(torch.Generator().manual_seed(0))
        assert {n: tuple(v.shape) for n, v in got.items()} == \
            {n: tuple(v.shape) for n, v in ref.items()} == pm.shapes()
        assert all(got[n].abs().max() == 0 for n in ("b1", "b2"))
        assert 0.015 < float(got["w1"].std()) < 0.025
        assert {n: tuple(s) for n, s in jm.param_specs().items()} == \
            pm.param_specs()
        assert jm.param_reduce_axes() == pm.param_reduce_axes()
    assert pm.capacity(16384) == 5120          # k 2, cf 1.25, 8 experts
    with pytest.raises(ValueError):
        pmoe.BlocksparseMoE(8, 64, 256, k=9)
    with pytest.raises(ValueError):
        pmoe.BlocksparseMoE(8, 64, 256, ep=3)
    # ep 2 without an axis runs as ep 1 on the params it is given, as the
    # JAX layer does: the same outputs as the ep 1 layer; one rank's E/ep
    # experts alone need the axis
    ep = pmoe.BlocksparseMoE(8, 64, 256, ep=2)
    one = pmoe.BlocksparseMoE(8, 64, 256)
    assert ep.shapes(local=True)["w1"] == (4, 64, 256) and \
        ep.shapes(local=True)["wg"] == (64, 8) and ep.shapes() == one.shapes()
    params = one.init(torch.Generator().manual_seed(1))
    x = torch.randn(16, 64, generator=torch.Generator().manual_seed(2))
    for a, b in zip(ep(params, x), one(params, x)):
        assert torch.equal(a, b)
    local = {n: (v[:4] if n != "wg" else v) for n, v in params.items()}
    with pytest.raises(ValueError, match="ep_axis"):
        ep(local, x)


def test_moe_layer_routes_and_sums_without_scatter_add():
    """The routing, dispatch and combine (dense experts: no bsmm plain
    version) run no float ``index_add``/``scatter_add`` forward or
    backward; two backward runs give the same bits."""
    from torch.profiler import ProfilerActivity, profile
    _, pm, params, x, dy = _layer_case(0, 2, "float32", cf=0.75)
    pt = {n: torch.from_numpy(a).requires_grad_() for n, a in params.items()}
    xt = torch.from_numpy(np.asarray(x)).requires_grad_()
    runs = []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            y, aux = pm(pt, xt)
            runs.append(torch.autograd.grad(
                (y, aux), list(pt.values()) + [xt],
                (torch.from_numpy(dy), torch.tensor(0.7))))
    names = {e.key for e in prof.key_averages()}
    assert not [n for n in names if "index_add" in n or "scatter_add" in n
                or "embedding_dense_backward" in n], sorted(names)
    assert all(torch.equal(a, b) for a, b in zip(*runs))


# ---------------- the LM ----------------

MOE_LM = dict(n_vocab=64, n_embd=64, n_layer=2, n_head=4, ctx=128,
              blk_size=32, attn_layout="fixed", local_blocks=2, mlp_ratio=2,
              mlp_block_size=16, mlp_density=0.6, dtype="float32",
              recompute=True, moe_experts=4, moe_k=1,
              moe_capacity_factor=1.25)


def _lm(**kw):
    cfg = dict(MOE_LM, **kw)
    jm = JaxLM(JaxConfig(**cfg))
    params = _np(jm.init(jax.random.PRNGKey(0)))
    port = bt.SparseTransformerLM(bt.TransformerConfig(**cfg), device="cpu")
    port.load_state_dict(bt.params_from_jax(params, port))
    rng = np.random.RandomState(1)
    tokens, targets = (rng.randint(0, 64, (2, 128)).astype(np.int32)
                       for _ in range(2))
    return jm, params, port, tokens, targets


def test_moe_lm_forward_loss_and_train_step_match_jax():
    """The JAX MoE test's LM (4 experts, top-1, b16 experts at density
    0.6; capacity factor 1.25, so tokens drop): logits and aux of
    ``forward(return_aux=True)``; one ``make_train_step`` (clip, Adam,
    loss scale) against JAX's: loss (cross entropy + 0.01 aux), grad norm,
    every gradient through the first mean slot (the router ``wg``'s
    included, which at k = 1 comes from the aux loss alone) and the
    parameters."""
    jm, params, port, tokens, targets = _lm()
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    logits_j, aux_j = jm.forward(jp, jnp.asarray(tokens), return_aux=True)
    tt, tg = (torch.from_numpy(a).long() for a in (tokens, targets))
    logits, aux = port(tt, return_aux=True)
    _close(logits, np.asarray(logits_j), TOL, "logits")
    assert abs(float(aux) / float(aux_j) - 1) <= TOL and float(aux) > 0
    ce = bt.softmax_cross_entropy(logits, tg).mean()
    loss = port.loss(tt, tg)
    assert torch.equal(loss.detach(), ce + 0.01 * aux)

    make_opt = dict(learning_rate=LR, zero_nans=True, zero_infs=True)
    ref_opt = jax_opt.AdamOptimizer(**make_opt)
    state0 = ref_opt.init(params)
    rp, rs, rm, _ = jm.make_train_step(ref_opt)(
        params, state0, jnp.asarray(tokens), jnp.asarray(targets),
        jnp.asarray(64.0))
    step = port.make_train_step(bt.AdamOptimizer(**make_opt))
    ps, pm, _ = step(bt.opt_state_from_jax(_np(state0), port), tt, tg, 64.0)
    for k in ("loss", "grad_norm", "norm_scale"):
        np.testing.assert_allclose(float(pm[k]), float(rm[k]), rtol=TOL,
                                   err_msg=k)
    assert abs(float(pm["loss"]) / float(loss) - 1) <= TOL
    want_mean = bt.params_from_jax(_np(rs["mean"]), port)
    for k, want in want_mean.items():
        tol = WG_K1_TOL if k.endswith("moe.wg") else GRAD_TOL
        _grad_close(ps["mean"][k], want.numpy(), tol, k)
    assert want_mean["h.0.moe.wg"].abs().max() > 0
    want_p = bt.params_from_jax(_np(rp), port)
    for k, got in port.state_dict().items():
        m = want_mean[k].abs()
        live = m > 1e-3 * m.max()
        diff = (got - want_p[k]).abs()
        assert diff[live].max() <= TOL, k
        assert diff.max() <= 2 * LR + TOL, k


def test_moe_lm_recompute_generate_and_refusals():
    """Gradients with recompute on and off equal bit for bit (the
    recompute routes as the forward did); ``generate`` (a full forward a
    token) runs; the KV-cached paths raise, as the JAX asserts."""
    _, params, port, tokens, targets = _lm(n_layer=1)
    tt, tg = (torch.from_numpy(a).long() for a in (tokens, targets))
    names, ps = zip(*port.named_parameters())
    grads = []
    for rc in (True, False):
        port.config.recompute = rc
        grads.append(torch.autograd.grad(port.loss(tt, tg), ps))
    assert all(torch.equal(a, b) for a, b in zip(*grads))
    assert any(n.endswith("moe.wg") for n in names)
    out = bt.generate(port, tt[:1, :5], 3,
                      generator=torch.Generator().manual_seed(0))
    assert out.shape == (1, 8) and torch.equal(out[:, :5], tt[:1, :5])
    for fn in (lambda: port.init_kv_cache(1),
               lambda: port.prefill(tt[:1]),
               lambda: port.decode_forward(tt[:1, 0], [], 0),
               lambda: bt.generate_cached(port, tt[:1, :5], 2),
               lambda: bt.generate_cached_scan(port, tt[:1, :5], 2)):
        with pytest.raises(NotImplementedError, match="KV-cached decode"):
            fn()


@pytest.mark.parametrize("stacked", [False, True])
def test_moe_convert_round_trips(stacked):
    """``params_from_jax`` of the JAX init (``h{l}`` or stacked ``hs``),
    ``params_to_jax`` back bit for bit, Adam states (f32 and bfloat16
    slots) to and from JAX's bit for bit, and ``random_jax_params``' tree
    with the JAX init's keys and shapes."""
    cfg = dict(MOE_LM, n_layer=2, stack_layers=stacked)
    jm = JaxLM(JaxConfig(**cfg))
    params = _np(jm.init(jax.random.PRNGKey(3)))
    port = bt.SparseTransformerLM(bt.TransformerConfig(**cfg), device="cpu")
    sd = bt.params_from_jax(params, port)
    port.load_state_dict(sd)
    assert "h.1.moe.w2" in sd and "h.0.w_fc" not in sd
    flat = _np(params["hs"]) if stacked else None
    back = bt.params_to_jax(port)
    for l in range(2):
        want = params[f"h{l}"] if not stacked else jax.tree_util.tree_map(
            lambda a: a[l], flat)
        assert set(back[f"h{l}"]) == set(want)
        for k, a in want["moe"].items():
            np.testing.assert_array_equal(back[f"h{l}"]["moe"][k], a)
    for fmt in ("float32", "bfloat16"):
        opt = jax_opt.AdamOptimizer(fp16=fmt == "bfloat16")
        state = _np(opt.init(jax.tree_util.tree_map(jnp.asarray, params)))
        pstate = bt.opt_state_from_jax(state, port)
        # 16-bit slots for tensors of 8K elements or more (w1, not wg)
        assert pstate["mean"]["h.0.moe.w1"].dtype == getattr(torch, fmt)
        again = bt.opt_state_to_jax(pstate, port)
        ref = state if not stacked else {
            "mean": {f"h{l}": jax.tree_util.tree_map(
                lambda a: a[l], state["mean"]["hs"]) for l in range(2)}}
        for l in range(2):
            for k in ("wg", "w1", "b2"):
                np.testing.assert_array_equal(
                    np.asarray(again["mean"][f"h{l}"]["moe"][k], np.float32),
                    np.asarray(ref["mean"][f"h{l}"]["moe"][k], np.float32))
    rnd = bt.random_jax_params(port, seed=0)
    unstacked = _np(JaxLM(JaxConfig(**dict(cfg, stack_layers=False))).init(
        jax.random.PRNGKey(0)))
    assert jax.tree_util.tree_structure(rnd) == \
        jax.tree_util.tree_structure(unstacked)
    for a, b in zip(jax.tree_util.tree_leaves(rnd),
                    jax.tree_util.tree_leaves(unstacked)):
        assert a.shape == b.shape
    loaded, tree = _tp2()
    np.testing.assert_array_equal(loaded["h.0.w_fc"].numpy(),
                                  tree["h0"]["w_fc"][1])
    np.testing.assert_array_equal(loaded["h.1.w_proj"].numpy(),
                                  tree["h1"]["w_proj"][1])


def _tp2():
    """A block-sparse MLP weight with a tp dim of 2: a tp-2 model's rank 1
    loads its slice [1]; a tp-1 model refuses it."""
    tp2 = bt.SparseTransformerLM(bt.TransformerConfig(**dict(
        MOE_LM, moe_experts=0, tp=2)), device="cpu")
    tree = bt.random_jax_params(tp2, seed=0)
    assert tree["h0"]["w_fc"].shape[0] == 2
    tp1 = bt.SparseTransformerLM(bt.TransformerConfig(**dict(
        MOE_LM, moe_experts=0)), device="cpu")
    one = bt.params_to_jax(tp1)
    one["h0"]["w_fc"] = np.concatenate([one["h0"]["w_fc"]] * 2)
    with pytest.raises(ValueError, match="tp dim 2"):
        bt.params_from_jax(one, tp1)
    return bt.params_from_jax(tree, tp2, tp_rank=1), tree


def test_moe_entry_point_trains_checkpoints_and_resumes(tmp_path):
    """``--moe_experts 2 --moe_k 2`` on the CPU: three steps with finite
    losses; the checkpoint after step 2 holds the MoE params and their
    Adam slots bit for bit, and a run resumes from it."""
    small = ["--device", "cpu", "--n_ctx", "64", "--n_embd", "64",
             "--n_layer", "1", "--n_head", "4", "--blk_size", "16",
             "--n_batch", "2", "--lr", "3e-3", "--moe_experts", "2",
             "--moe_k", "2"]
    ck = str(tmp_path / "ck")
    seen = {}

    def on_step(step, model, opt_state, loss_scale, metrics):
        if step == 1:
            seen["params"] = {k: v.clone()
                              for k, v in model.state_dict().items()}
            seen["mean"] = {k: v.clone()
                            for k, v in opt_state["mean"].items()}
    full = port_enwik8.train(port_enwik8.parse_args(small + [
        "--n_iter", "3", "--ckpt_dir", ck, "--ckpt_every", "2"]), on_step)
    assert np.isfinite(full["losses"]).all()
    tree, meta = bt.checkpoint.restore(ck)
    assert meta["step"] == 2
    assert tree["params"]["h.0.moe.w1"].shape == (2, 16, 32, 32)
    for k in ("h.0.moe.wg", "h.0.moe.w1", "h.0.moe.b2"):
        assert torch.equal(tree["params"][k], seen["params"][k])
        assert torch.equal(tree["opt_state"]["mean"][k], seen["mean"][k])
    assert tree["opt_state"]["mean"]["h.0.moe.wg"].abs().max() > 0
    resumed = port_enwik8.train(port_enwik8.parse_args(small + [
        "--n_iter", "3", "--ckpt_dir", ck, "--resume"]))
    assert resumed["start"] == 2 and len(resumed["losses"]) == 1
    assert np.isfinite(resumed["losses"]).all()
