"""The port's optimizers against the JAX package's, from the same NumPy
inputs.

Tolerances:
- packed16 (mhalf/vhalf) pack and unpack: bit for bit, on every one of
  the 65,536 codes, their neighbours and midpoints and a seeded spread;
- Adam (f32, bfloat16, packed16, gated, lazy, dual-lr) and EMA: the same
  f32 elementwise math in the same order, held at 1e-6 of max(1, |JAX|)
  (one f32 ulp at most where XLA fuses differently); slots in 16 bits at
  one unit of their own last place, where such a last-bit difference
  may round the other way;
- Adafactor: its means reduce in another order than XLA's: 1e-5 relative;
- quantized slots (``*_qspec``): one step of the format's grid, plus 1e-6
  of the value, as the JAX grid comes from XLA's inexact ``exp2`` and
  lies off the exact grid by up to ~1e-6 relative (ROADMAP F4);
- block norms, pruning gates: f32 reductions, 1e-6; gates exact;
- state conversion to and from JAX: bit for bit.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
import ml_dtypes

from blocksparse_tpu.ops import optimize as jax_opt
from blocksparse_tpu.ops.quantize import QuantizeSpec as JaxQSpec

import blocksparse_tpu_torch as bt

torch.set_num_threads(2)
TOL = 1e-6
ADAFACTOR_TOL = 1e-5
CODES = np.arange(65536, dtype=np.uint16)


def _np(x):
    """A JAX or torch array as NumPy f32 (bf16 widened exactly)."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, tol=TOL, what=""):
    want = _np(want)
    np.testing.assert_allclose(_np(got), want, rtol=0,
                               atol=tol * max(1.0, np.abs(want).max()),
                               err_msg=what)


def _ulp_close(got, want, what=""):
    """Equal, or one unit of the slot dtype's last place apart."""
    if isinstance(got, torch.Tensor) and got.dtype == torch.uint16:
        g = got.numpy().astype(np.int64)
        w = np.asarray(want).astype(np.int64)
        assert np.abs(g - w).max() <= 1, what
        return
    if isinstance(got, torch.Tensor) and got.dtype == torch.bfloat16:
        g = got.view(torch.int16).numpy().astype(np.int64)
        w = np.asarray(want).view(np.int16).astype(np.int64)
        assert np.abs(g - w).max() <= 1, what
        return
    _close(got, want, what=what)


def _probe_values(unpacked):
    """Every code's value, its f32 neighbours, the midpoints between
    codes, and a seeded spread over 27 decades with edge values."""
    vals = unpacked[np.isfinite(unpacked)]
    up = np.nextafter(vals, np.float32(np.inf))
    dn = np.nextafter(vals, np.float32(-np.inf))
    srt = np.unique(vals)
    mid = ((srt[1:].astype(np.float64) + srt[:-1]) / 2).astype(np.float32)
    rng = np.random.RandomState(0)
    spread = rng.standard_normal(20000) * 10.0 ** rng.uniform(-25, 2, 20000)
    edges = [0.0, -0.0, np.inf, -np.inf, 16.0, -16.0, 15.99, 1e-40,
             2.0 ** -60, 2.0 ** -61, 2.0 ** -62, 2.0 ** -63, 1e30]
    return np.concatenate([vals, up, dn, mid, spread, edges]).astype(
        np.float32)


@pytest.mark.parametrize("fmt", ["mhalf", "vhalf"])
def test_packed16_every_code_matches_jax(fmt):
    j_unpack, j_pack = (getattr(jax_opt, f"{fmt}_{d}")
                        for d in ("unpack", "pack"))
    p_unpack, p_pack = (getattr(bt, f"{fmt}_{d}") for d in ("unpack", "pack"))
    ref = np.asarray(j_unpack(jnp.asarray(CODES)))
    got = p_unpack(torch.from_numpy(CODES))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  ref.view(np.uint32))
    x = _probe_values(ref)
    packed = p_pack(torch.from_numpy(x))
    assert packed.dtype == torch.uint16
    np.testing.assert_array_equal(packed.numpy(),
                                  np.asarray(j_pack(jnp.asarray(x))))
    # every code's value packs back to that code, but for the codes of
    # mantissa 0 at exponent 0 (+-2^-60): pack flushes them to 0
    finite = np.isfinite(ref)
    again = p_pack(torch.from_numpy(ref[finite])).numpy()
    want = CODES[finite].copy()
    want[np.abs(ref[finite]) <= 2.0 ** -60] = 0
    np.testing.assert_array_equal(again, want)


def _tree(seed, shapes, scale=1.0):
    rng = np.random.RandomState(seed)
    return {k: (rng.standard_normal(s) * scale).astype(np.float32)
            for k, s in shapes.items()}


SHAPES = {"big": (128, 80), "small": (5, 6), "blocks": (4, 8, 8)}


def _run_adam(kw, steps=3, gates=None, norm_scales=(1.0, 0.5, 1.0)):
    params = _tree(0, SHAPES)
    ref_opt = jax_opt.AdamOptimizer(learning_rate=0.01, **kw)
    port_kw = dict(kw)
    for q in ("param_qspec", "mean_qspec", "var_qspec"):
        if q in port_kw:
            s = port_kw[q]
            port_kw[q] = bt.QuantizeSpec(ebits=s.ebits, fbits=s.fbits,
                                         emax=s.emax, denorm=s.denorm)
    port_opt_ = bt.AdamOptimizer(learning_rate=0.01, **port_kw)
    rp = {k: jnp.asarray(a) for k, a in params.items()}
    pp = {k: torch.from_numpy(a) for k, a in params.items()}
    rs, ps = ref_opt.init(rp), port_opt_.init(pp)
    for k in params:
        assert str(ps["mean"][k].dtype).split(".")[-1] == \
            str(rs["mean"][k].dtype)
    for step in range(steps):
        g = _tree(10 + step, SHAPES)
        rg = None if gates is None else {k: jnp.asarray(a)
                                         for k, a in gates.items()}
        pg = None if gates is None else {k: torch.from_numpy(a)
                                         for k, a in gates.items()}
        ns = norm_scales[step]
        rp, rs = ref_opt.apply({k: jnp.asarray(a) for k, a in g.items()},
                               rp, rs, norm_scale=ns, grad_scale=0.5,
                               gates=rg)
        pp, ps = port_opt_.apply({k: torch.from_numpy(a)
                                  for k, a in g.items()}, pp, ps,
                                 norm_scale=torch.tensor(ns), grad_scale=0.5,
                                 gates=pg)
        assert int(ps["t"]) == int(rs["t"]) == step + 1
    return params, (rp, rs), (pp, ps)


ADAM_CASES = {
    "bfloat16": dict(state_format="bfloat16"),
    "fp16": dict(fp16=True, clip_sigmas=2.0),
    "packed16": dict(state_format="packed16", zero_infs=True,
                     zero_nans=True),
    "gated": dict(gated=True),
    "qspec": dict(param_qspec=JaxQSpec(ebits=8, fbits=7, emax=127),
                  mean_qspec=JaxQSpec(ebits=5, fbits=7, emax=3)),
}


@pytest.mark.parametrize("case", sorted(ADAM_CASES))
def test_adam_three_steps_match_jax(case):
    """Three AdamOptimizer.apply steps: 16-bit slots only on the 8K+
    parameter, packed16 codes and bf16 slots equal or one unit of last
    place apart, params at f32 tolerance."""
    gates = None
    if case == "gated":
        gates = {k: np.ones(s[0], np.float32) for k, s in SHAPES.items()}
        gates["blocks"] = np.array([1, 0, 1, 0], np.float32)
    kw = ADAM_CASES[case]
    params, (rp, rs), (pp, ps) = _run_adam(kw, gates=gates)
    for k in params:
        _close(pp[k], rp[k], what=k)
        for slot in ("mean", "var"):
            spec = kw.get(f"{slot}_qspec")
            if spec is None:
                _ulp_close(ps[slot][k], rs[slot][k], what=f"{slot} {k}")
                continue
            want = np.asarray(rs[slot][k])
            step = np.exp2(np.floor(np.log2(np.abs(want) + 1e-30))
                           - spec.fbits)
            assert (np.abs(ps[slot][k].numpy() - want)
                    <= step + 1e-6 * np.abs(want)).all(), \
                f"{slot} {k}"
    if case in ("bfloat16", "fp16", "packed16"):
        want = torch.uint16 if case == "packed16" else torch.bfloat16
        assert ps["mean"]["big"].dtype == want
        assert ps["var"]["small"].dtype == torch.float32
    if case == "gated":
        off = torch.tensor([False, True, False, True])
        assert torch.equal(pp["blocks"][off],
                           torch.from_numpy(params["blocks"])[off])
        assert not ps["mean"]["blocks"][off].any()


def test_adam_apply_gate_and_lazy_embedding_match_jax():
    rng = np.random.RandomState(3)
    p, m, v = (rng.standard_normal((6, 4)).astype(np.float32)
               for _ in range(3))
    v = np.abs(v)
    g = rng.standard_normal((6, 4)).astype(np.float32)
    g[[1, 4]] = 0.0                                     # untouched rows
    args = [jnp.asarray(a) for a in (g, p, m, v)]
    targs = [torch.from_numpy(a) for a in (g, p, m, v)]
    gate = np.array([1, 0, 1, 1, 0, 1], np.float32)
    ref = jax_opt.adam_apply(*args, 0.01, gate=jnp.asarray(gate))
    got = bt.adam_apply(*targs, 0.01, gate=torch.from_numpy(gate))
    for a, b in zip(got, ref):
        _close(a, b)
    ref = jax_opt.lazy_emb_adam_apply(*args, 0.01, clip_sigma=1.0)
    got = bt.lazy_emb_adam_apply(*targs, 0.01, clip_sigma=1.0)
    for a, b in zip(got, ref):
        _close(a, b)
    for a, b in zip(got, targs[1:]):
        assert torch.equal(a[[1, 4]], b[[1, 4]])


@pytest.mark.parametrize("lr_select", [None, [1, 0, 0, 1]])
def test_blocksparse_adam_op_matches_jax(lr_select):
    rng = np.random.RandomState(4)
    g, p, m = (rng.standard_normal((4, 8, 8)).astype(np.float32)
               for _ in range(3))
    v = np.abs(rng.standard_normal((4, 8, 8))).astype(np.float32)
    sel = None if lr_select is None else np.array(lr_select, np.float32)
    ref = jax_opt.blocksparse_adam_op(
        *(jnp.asarray(a) for a in (g, p, m, v)), 0.01, 0.1,
        None if sel is None else jnp.asarray(sel), norm_scale=0.5)
    got = bt.blocksparse_adam_op(
        *(torch.from_numpy(a) for a in (g, p, m, v)), 0.01, 0.1,
        None if sel is None else torch.from_numpy(sel),
        norm_scale=torch.tensor(0.5))
    for a, b in zip(got, ref):
        _close(a, b)


def test_adafactor_three_steps_match_jax():
    """2-D (factored), 1-D and a one-row 2-D param; the third step with a
    norm_scale of 0 leaves everything as it was."""
    params = _tree(5, {"w": (12, 7), "b": (9,), "row": (1, 5)})
    ref_opt = jax_opt.AdafactorOptimizer(learning_rate=0.01, clip_thresh=0.5)
    port = bt.AdafactorOptimizer(learning_rate=0.01, clip_thresh=0.5)
    rp = {k: jnp.asarray(a) for k, a in params.items()}
    pp = {k: torch.from_numpy(a) for k, a in params.items()}
    rs, ps = ref_opt.init(rp), port.init(pp)
    assert set(ps["slots"]["w"]) == {"cv", "rv"}
    assert set(ps["slots"]["row"]) == {"cv"}
    for step, ns in enumerate((1.0, 0.7, 0.0)):
        g = _tree(20 + step, {"w": (12, 7), "b": (9,), "row": (1, 5)})
        rp, rs = ref_opt.apply({k: jnp.asarray(a) for k, a in g.items()},
                               rp, rs, norm_scale=ns)
        before = {k: v.clone() for k, v in pp.items()}
        pp, ps = port.apply({k: torch.from_numpy(a) for k, a in g.items()},
                            pp, ps, norm_scale=torch.tensor(ns))
        for k in params:
            _close(pp[k], rp[k], ADAFACTOR_TOL, k)
            for s, a in ps["slots"][k].items():
                np.testing.assert_allclose(
                    a.numpy(), np.asarray(rs["slots"][k][s]),
                    rtol=ADAFACTOR_TOL, err_msg=f"{k} {s}")
        if ns == 0.0:
            assert all(torch.equal(pp[k], before[k]) for k in pp)
    with pytest.raises(ValueError):
        port.init({"x": torch.zeros(2, 2, 2)})


def test_adafactor_ops_match_jax():
    rng = np.random.RandomState(6)
    p, g = (rng.standard_normal((6, 5)).astype(np.float32) for _ in range(2))
    cv = np.abs(rng.standard_normal((1, 5))).astype(np.float32)
    rv = np.abs(rng.standard_normal((6, 1))).astype(np.float32)
    ref = jax_opt.adafactor2d_apply(*(jnp.asarray(a) for a in (p, cv, rv, g)),
                                    0.9, 0.01, grad_scale=0.5)
    got = bt.adafactor2d_op(*(torch.from_numpy(a) for a in (p, cv, rv, g)),
                            torch.tensor(0.9), 0.01, grad_scale=0.5)
    for a, b in zip(got, ref):
        _close(a, b, ADAFACTOR_TOL)
    ref = jax_opt.adafactor1d_apply(*(jnp.asarray(a) for a in
                                      (p[:1], cv, g[:1])), 0.9, 0.01)
    got = bt.adafactor1d_op(*(torch.from_numpy(a) for a in
                              (p[:1], cv, g[:1])), torch.tensor(0.9), 0.01)
    for a, b in zip(got, ref):
        _close(a, b, ADAFACTOR_TOL)


@pytest.mark.parametrize("fp16,gated,qspec", [(False, False, False),
                                              (True, False, False),
                                              (False, True, True)])
def test_ema_matches_jax(fp16, gated, qspec):
    params = _tree(7, SHAPES)
    ref, port = jax_opt.Ema(decay=0.9, fp16=fp16), bt.Ema(decay=0.9,
                                                          fp16=fp16)
    rs = ref.init({k: jnp.asarray(a) for k, a in params.items()})
    ps = port.init({k: torch.from_numpy(a) for k, a in params.items()})
    gates = {k: np.array([1, 0, 1, 1][:a.shape[0]] + [1] * max(
        0, a.shape[0] - 4), np.float32) for k, a in params.items()}
    for step in range(3):
        new = _tree(30 + step, SHAPES)
        kw_r = dict(gates={k: jnp.asarray(a) for k, a in gates.items()}
                    if gated else None,
                    qspec=JaxQSpec(ebits=5, fbits=7, emax=3) if qspec
                    else None)
        kw_p = dict(gates={k: torch.from_numpy(a) for k, a in gates.items()}
                    if gated else None,
                    qspec=bt.QuantizeSpec(ebits=5, fbits=7, emax=3) if qspec
                    else None)
        rs = ref.apply({k: jnp.asarray(a) for k, a in new.items()}, rs,
                       **kw_r)
        ps = port.apply({k: torch.from_numpy(a) for k, a in new.items()},
                        ps, **kw_p)
    for k in params:
        assert ps[k].dtype == (torch.bfloat16 if fp16 else torch.float32)
        _ulp_close(ps[k], rs[k], k)
    assert port.average(ps, "big") is ps["big"] and port.params(ps) is ps
    got = bt.ema_op(torch.ones(3), torch.zeros(3), decay=0.75)
    _close(got, jax_opt.ema_op(jnp.ones(3), jnp.zeros(3), decay=0.75))


@pytest.mark.parametrize("norm", ["max", "l2"])
def test_block_norm_decay_and_prune_match_jax(norm):
    rng = np.random.RandomState(8)
    p = rng.standard_normal((10, 16, 16)).astype(np.float32)
    p *= np.linspace(0.1, 2.0, 10, dtype=np.float32)[:, None, None]
    gate = np.ones(10, np.float32)
    gate[3] = 0
    jp, tp = jnp.asarray(p), torch.from_numpy(p)
    _close(bt.blocksparse_norm(tp, norm), jax_opt.blocksparse_norm(jp, norm))
    _close(bt.blocksparse_l2_decay(tp, torch.from_numpy(gate), rate=2.0),
           jax_opt.blocksparse_l2_decay(jp, jnp.asarray(gate), rate=2.0))
    for kw in (dict(sparsity=0.35), dict(threshold=12.0 if norm == "l2"
                                         else 3.0)):
        for step in (4, 5):
            want = jax_opt.blocksparse_prune(jnp.asarray(gate), jp, step,
                                             norm=norm, frequency=2, **kw)
            got = bt.blocksparse_prune(torch.from_numpy(gate), tp,
                                       torch.tensor(step), norm=norm,
                                       frequency=2, **kw)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError):
        bt.blocksparse_norm(torch.zeros(2, 3, 4))


def test_torch_optim_adapters_match_optax():
    """FusedAdam and FusedAdafactor (torch.optim) take the same step as
    the JAX package's optax_adam and optax_adafactor."""
    params = _tree(9, {"w": (6, 5), "b": (5,)})
    for jax_fn, port_cls in ((jax_opt.optax_adam, bt.FusedAdam),
                             (jax_opt.optax_adafactor, bt.FusedAdafactor)):
        tx = jax_fn(learning_rate=0.01)
        jp = {k: jnp.asarray(a) for k, a in params.items()}
        state = tx.init(jp)
        tparams = {k: torch.nn.Parameter(torch.from_numpy(a.copy()))
                   for k, a in params.items()}
        opt = port_cls(list(tparams.values()), learning_rate=0.01)
        for step in range(2):
            g = _tree(40 + step, {"w": (6, 5), "b": (5,)})
            upd, state = tx.update({k: jnp.asarray(a) for k, a in g.items()},
                                   state, jp)
            jp = jax.tree_util.tree_map(lambda p, u: p + u, jp, upd)
            for k, p in tparams.items():
                p.grad = torch.from_numpy(g[k])
            opt.step()
        for k in params:
            _close(tparams[k], jp[k], ADAFACTOR_TOL, k)


def test_unknown_state_format_raises():
    with pytest.raises(ValueError):
        bt.AdamOptimizer(state_format="float8")


@pytest.mark.parametrize("fmt", ["float32", "bfloat16", "packed16"])
def test_adam_state_converts_to_and_from_jax_bit_for_bit(fmt):
    """A JAX LM's Adam state after one step, into the port and back."""
    from blocksparse_tpu.models import SparseTransformerLM as JaxLM
    from blocksparse_tpu.models import TransformerConfig as JaxConfig
    cfg = dict(n_vocab=32, n_embd=64, n_layer=1, n_head=2, ctx=32,
               blk_size=16, mlp_block_size=16, mlp_density=0.5,
               dtype="float32")
    jm = JaxLM(JaxConfig(**cfg))
    params = jm.init(jax.random.PRNGKey(0))
    ref = jax_opt.AdamOptimizer(state_format=fmt)
    g = jax.tree_util.tree_map(lambda p: jnp.full(p.shape, 0.01, p.dtype) *
                               (1 + jnp.arange(p.size).reshape(p.shape) % 7),
                               params)
    _, state = ref.apply(g, params, ref.init(params))
    np_state = jax.tree_util.tree_map(np.asarray, state)
    model = bt.SparseTransformerLM(bt.TransformerConfig(**cfg), device="cpu")
    ps = bt.opt_state_from_jax(np_state, model)
    assert int(ps["t"]) == 1
    back = bt.opt_state_to_jax(ps, model)
    flat_a = jax.tree_util.tree_leaves_with_path(np_state)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, a in flat_a:
        b = flat_b[path]
        assert np.asarray(b).dtype == np.asarray(a).dtype, path
        np.testing.assert_array_equal(np.atleast_1d(b).view(np.uint8),
                                      np.atleast_1d(a).view(np.uint8))
    big = ps["mean"]["h.0.w_fc"]
    assert big.dtype == {"float32": torch.float32,
                         "bfloat16": torch.bfloat16,
                         "packed16": torch.uint16}[fmt]


def test_adafactor_and_ema_state_convert_bit_for_bit():
    from blocksparse_tpu.models import SparseTransformerLM as JaxLM
    from blocksparse_tpu.models import TransformerConfig as JaxConfig
    cfg = dict(n_vocab=32, n_embd=64, n_layer=1, n_head=2, ctx=32,
               blk_size=16, dtype="float32")
    jm = JaxLM(JaxConfig(**cfg))
    params = jm.init(jax.random.PRNGKey(1))
    g = jax.tree_util.tree_map(lambda p: jnp.ones_like(p) * 0.1, params)
    ada = jax_opt.AdafactorOptimizer()
    _, astate = ada.apply(g, params, ada.init(params))
    ema = jax_opt.Ema(fp16=True)
    estate = ema.apply(params, ema.init(params))
    model = bt.SparseTransformerLM(bt.TransformerConfig(**cfg), device="cpu")
    for state in (astate, estate):
        np_state = jax.tree_util.tree_map(np.asarray, state)
        back = bt.opt_state_to_jax(bt.opt_state_from_jax(np_state, model),
                                   model)
        a = jax.tree_util.tree_leaves_with_path(np_state)
        b = dict(jax.tree_util.tree_leaves_with_path(back))
        assert len(a) == len(b)
        for path, x in a:
            assert np.asarray(b[path]).dtype == np.asarray(x).dtype
            np.testing.assert_array_equal(
                np.atleast_1d(b[path]).view(np.uint8),
                np.atleast_1d(x).view(np.uint8))
    ps = bt.opt_state_from_jax(jax.tree_util.tree_map(np.asarray, estate),
                               model)
    assert ps["wte"].dtype == torch.bfloat16
    assert ml_dtypes.bfloat16 == np.asarray(
        bt.opt_state_to_jax(ps, model)["wte"]).dtype
