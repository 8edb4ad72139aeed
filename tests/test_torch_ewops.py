"""The port's elementwise ops, norms and gradient utilities against the
JAX package's, from the same NumPy inputs.

Tolerances:
- add, multiply, subtract, maximum, minimum, negative, square, relu,
  filter_tensor, dropout with a given mask, bias_relu, fancy_gather,
  reduce_max, assign_add: the same f32 math in the same order: bit for
  bit (forward and gradient);
- divide, reciprocal, sqrt (whose gradients each library writes its own
  way) and the transcendental ops (exp, log, sigmoid, tanh, elu, gelu,
  swish, concrete gates): each library's own f32 functions, 2e-6 of
  max(1, |JAX|);
- batch_norm: its mean and variance reduce in another order than XLA's:
  1e-5 of max(1, |JAX|), forward and gradient;
- the NumPy goldens (``*_test``): the JAX package's code on the same
  inputs, bit for bit;
- ``gradients`` and ``recomputable`` (tanh of a matmul): 1e-5 of max(1,
  |JAX|);
- ``recomputable`` over dropout and stochastic quantize: the gradients
  with recompute on equal those with it off, and JAX's through its own
  ``recomputable`` given the port's mask and quantized values, bit for
  bit (the same elementwise math).
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from blocksparse_tpu.ops import ewops as jew
from blocksparse_tpu.ops import grads as jgrads
from blocksparse_tpu.ops import norms as jnorms
from blocksparse_tpu.ops import quantize as jq

import blocksparse_tpu_torch as bt
from blocksparse_tpu_torch.ops import ewops as pew
from blocksparse_tpu_torch.ops import norms as pnorms

torch.set_num_threads(2)
TRANS_TOL = 2e-6
BN_TOL = 1e-5


def _x(seed, shape=(4, 6), scale=2.0):
    return (np.random.RandomState(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _vjp(jfn, pfn, *arrays, dy_seed=99):
    """(JAX output, JAX grads, port output, port grads) for one cotangent
    drawn from ``dy_seed``."""
    jin = [jnp.asarray(a) for a in arrays]
    y, vjp = jax.vjp(jfn, *jin)
    dy = _x(dy_seed, y.shape)
    jg = vjp(jnp.asarray(dy))
    pin = [torch.from_numpy(a).requires_grad_() for a in arrays]
    py = pfn(*pin)
    pg = torch.autograd.grad(py, pin, torch.from_numpy(dy))
    return np.asarray(y), [np.asarray(g) for g in jg], \
        py.detach().numpy(), [g.numpy() for g in pg]


def _close(got, want, tol):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(1.0, np.abs(want).max()))


BINARY = ["add", "multiply", "subtract", "divide", "maximum", "minimum"]
UNARY = ["negative", "reciprocal", "square", "sqrt", "exp", "log", "sigmoid",
         "tanh", "relu", "elu", "gelu", "swish", "fast_gelu"]
EXACT = {"add", "multiply", "subtract", "maximum", "minimum", "negative",
         "square", "relu"}
GRAD_UTIL_TOL = 1e-5


@pytest.mark.parametrize("name", BINARY + UNARY)
def test_elementwise_op_and_grad_match_jax(name):
    x = _x(1)
    if name in ("sqrt", "log", "reciprocal"):
        x = np.abs(x) + 0.5
    args = (x, _x(2) + 3.0) if name in BINARY else (x,)
    jy, jg, py, pg = _vjp(getattr(jew, name), getattr(bt, name), *args)
    tol = 0.0 if name in EXACT else TRANS_TOL
    _close(py, jy, tol)
    for a, b in zip(pg, jg):
        _close(a, b, tol)


def test_add_n_and_add_n8_match_jax():
    xs = [_x(s) for s in range(9)]
    np.testing.assert_array_equal(
        bt.add_n([torch.from_numpy(a) for a in xs]).numpy(),
        np.asarray(jew.add_n([jnp.asarray(a) for a in xs])))
    np.testing.assert_array_equal(
        bt.add_n8([torch.from_numpy(a) for a in xs[:8]]).numpy(),
        np.asarray(jew.add_n8([jnp.asarray(a) for a in xs[:8]])))
    with pytest.raises(ValueError):
        bt.add_n8([torch.zeros(2)] * 9)


@pytest.mark.parametrize("kw", [dict(scale=0.5), dict(saturate=1.0),
                                dict(zero_infs=True, zero_nans=True,
                                     scale=2.0)])
def test_filter_tensor_and_its_grad_match_jax(kw):
    x = _x(3)
    x[0, 0], x[1, 1] = np.inf, np.nan
    jy, jg, py, pg = _vjp(lambda a: jew.filter_tensor(a, **kw),
                          lambda a: bt.filter_tensor(a, **kw), x)
    np.testing.assert_array_equal(py, jy)
    np.testing.assert_array_equal(pg[0], jg[0])
    np.testing.assert_array_equal(
        bt.scale_tensor(torch.from_numpy(x[2:]), 3.0).numpy(),
        np.asarray(jew.scale_tensor(jnp.asarray(x[2:]), 3.0)))


def test_float_cast_grad_dtype_matches_jax():
    x = _x(4)
    y = jew.float_cast(jnp.asarray(x), jnp.bfloat16, dx_dtype=jnp.float32)
    t = torch.from_numpy(x).requires_grad_()
    py = bt.float_cast(t, torch.bfloat16, dx_dtype=torch.float32)
    assert py.dtype == torch.bfloat16
    np.testing.assert_array_equal(py.detach().float().numpy(),
                                  np.asarray(y.astype(jnp.float32)))
    py.backward(torch.ones_like(py))
    assert t.grad.dtype == torch.float32


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dropout_with_jax_mask_matches_jax(dtype):
    """The JAX op's mask (bernoulli on a key) given to the port: the same
    output and gradient bit for bit, the scale rounded to x's dtype."""
    x = _x(5, (3, 5, 8))
    key = jax.random.PRNGKey(3)
    jd = getattr(jnp, dtype)
    ref, vjp = jax.vjp(lambda a: jew.dropout(a, 0.8, key=key)[0],
                       jnp.asarray(x, jd))
    _, mask = jew.dropout(jnp.asarray(x, jd), 0.8, key=key)
    dy = _x(6, x.shape)
    (dref,) = vjp(jnp.asarray(dy, jd))
    t = torch.from_numpy(x).to(getattr(torch, dtype)).requires_grad_()
    y, m = bt.dropout(t, 0.8, mask=torch.from_numpy(np.asarray(mask)))
    y.backward(torch.from_numpy(dy).to(t.dtype))
    np.testing.assert_array_equal(y.detach().float().numpy(),
                                  np.asarray(ref.astype(jnp.float32)))
    np.testing.assert_array_equal(t.grad.float().numpy(),
                                  np.asarray(dref.astype(jnp.float32)))
    assert m.dtype == torch.bool


def test_dropout_draws_reusable_broadcast_masks():
    x = torch.from_numpy(_x(7, (4, 64, 32)))
    g = torch.Generator().manual_seed(0)
    y, m = bt.dropout(x, 0.75, generator=g)
    keep = m.float().mean().item()
    n = m.numel()
    assert abs(keep - 0.75) < 5 * np.sqrt(0.75 * 0.25 / n)
    y2, m2 = bt.dropout(x, 0.75, mask=m)                  # reuse
    assert torch.equal(y, y2) and m2 is m
    y3, m3 = bt.dropout(x, 0.75, mask_shape=(4, 1, 32),
                        generator=torch.Generator().manual_seed(1))
    assert m3.shape == (4, 1, 32)
    assert torch.equal(y3 == 0, (~m3).expand_as(x) | (x == 0))
    with pytest.raises(ValueError):
        bt.dropout(x, 0.75, mask_shape=(4, 2, 32))
    bt.set_entropy(5)
    a = bt.dropout(x, 0.5)[1]
    bt.set_entropy(5)
    assert torch.equal(a, bt.dropout(x, 0.5)[1])


def test_concrete_gates_match_jax():
    """The JAX gate given its own uniform draw, and the inference gate."""
    loga = _x(8)
    key = jax.random.PRNGKey(4)
    ref = jew.concrete_gate(jnp.asarray(loga), key=key)
    u = jax.random.uniform(key, loga.shape, jnp.float32, minval=1e-6,
                           maxval=1.0 - 1e-6)
    got = pew._concrete_gate(torch.from_numpy(loga),
                             torch.from_numpy(np.asarray(u)), 2.0 / 3.0,
                             -0.1, 1.1)
    _close(got.numpy(), np.asarray(ref), TRANS_TOL)
    _close(bt.concrete_gate_infer(torch.from_numpy(loga)).numpy(),
           np.asarray(jew.concrete_gate_infer(jnp.asarray(loga))), TRANS_TOL)
    s = bt.concrete_gate(torch.from_numpy(loga),
                         generator=torch.Generator().manual_seed(0))
    assert s.shape == loga.shape and (s >= 0).all() and (s <= 1).all()


@pytest.mark.parametrize("kw", [dict(), dict(relu=True),
                                dict(fast_gelu=True, axis=1)])
def test_bias_relu_matches_jax(kw):
    x = _x(9, (3, 5))
    b = _x(10, (5,) if kw.get("axis", -1) == -1 else (5,))
    jy, jg, py, pg = _vjp(lambda a, c: jew.bias_relu(a, c, **kw),
                          lambda a, c: bt.bias_relu(a, c, **kw), x, b)
    tol = TRANS_TOL if kw.get("fast_gelu") else 0.0
    _close(py, jy, tol)
    for a, c in zip(pg, jg):
        _close(a, c, tol)
    with pytest.raises(ValueError):
        bt.bias_relu(torch.zeros(2, 2), torch.zeros(2), relu=True,
                     fast_gelu=True)


def test_fancy_gather_matches_jax_and_golden():
    x = _x(11, (3, 4, 6, 2))
    idx = np.random.RandomState(12).randint(-1, 6, (3, 4)).astype(np.int32)
    jy, jg, py, pg = _vjp(lambda a: jew.fancy_gather(a, jnp.asarray(idx)),
                          lambda a: bt.fancy_gather(a, torch.from_numpy(idx)),
                          x)
    np.testing.assert_array_equal(py, jy)
    np.testing.assert_array_equal(pg[0], jg[0])
    np.testing.assert_array_equal(pew.fancy_gather_test(x, idx),
                                  jew.fancy_gather_test(x, idx))


def test_reduce_max_and_assign_add_match_jax():
    x = _x(13, (3, 4, 5))
    x[1, :, 2] = 9.0                                 # ties share the grad
    jy, jg, py, pg = _vjp(lambda a: jew.reduce_max(a, 1),
                          lambda a: bt.reduce_max(a, 1), x)
    np.testing.assert_array_equal(py, jy)
    np.testing.assert_array_equal(pg[0], jg[0])
    y = torch.from_numpy(_x(14))
    out = bt.assign_add(y, torch.from_numpy(_x(15)))
    assert out is y
    np.testing.assert_array_equal(
        y.numpy(), np.asarray(jew.assign_add(jnp.asarray(_x(14)),
                                             jnp.asarray(_x(15)))))
    assert bt.replace_add_n() is None and bt.restore_add_n() is None


@pytest.mark.parametrize("shape", [(4, 3, 5, 5), (6, 8)])
def test_batch_norm_and_inference_match_jax(shape):
    x = _x(16, shape) + 1.0
    C = shape[1]
    g, b = _x(17, (C,)), _x(18, (C,))
    jy, jg, py, pg = _vjp(lambda a, gg, bb: jnorms.batch_norm(a, gg, bb)[0],
                          lambda a, gg, bb: bt.batch_norm(a, gg, bb)[0],
                          x, g, b)
    _close(py, jy, BN_TOL)
    for a, c in zip(pg, jg):
        _close(a, c, BN_TOL)
    _, jm, jv = jnorms.batch_norm(jnp.asarray(x), jnp.asarray(g),
                                  jnp.asarray(b))
    _, pm, pv = bt.batch_norm(*(torch.from_numpy(a) for a in (x, g, b)))
    _close(pm.numpy(), np.asarray(jm), BN_TOL)
    _close(pv.numpy(), np.asarray(jv), BN_TOL)
    m, v = _x(19, (C,)), np.abs(_x(20, (C,))) + 0.1
    _close(bt.batch_norm_inference(*(torch.from_numpy(a) for a in
                                     (x, g, b, m, v))).numpy(),
           np.asarray(jnorms.batch_norm_inference(*(jnp.asarray(a) for a in
                                                   (x, g, b, m, v)))), BN_TOL)


def test_norm_goldens_equal_jax_goldens():
    x = _x(21, (6, 12)).astype(np.float64)
    g, b = _x(22, (12,)).astype(np.float64), _x(23, (12,)).astype(np.float64)
    dy = _x(24, (6, 12)).astype(np.float64)
    for axis, seg in ((1, 1), (1, 3), (0, 2)):
        xs = x if axis == 1 else x.T.copy()
        dys = dy if axis == 1 else dy.T.copy()
        for fn, args in (("layer_norm_test", (xs, g, b)),
                         ("layer_norm_grad_test", (dys, xs, g, b))):
            want = getattr(jnorms, fn)(*args, axis=axis, segments=seg,
                                       relu=True)
            got = getattr(pnorms, fn)(*args, axis=axis, segments=seg,
                                      relu=True)
            for a, c in zip(np.atleast_1d(got) if fn == "layer_norm_test"
                            else got, np.atleast_1d(want)
                            if fn == "layer_norm_test" else want):
                np.testing.assert_array_equal(a, c)
    x4 = _x(25, (3, 4, 2, 2)).astype(np.float64)
    c4 = [_x(26 + i, (4,)).astype(np.float64) for i in range(4)]
    c4[3] = np.abs(c4[3])
    np.testing.assert_array_equal(pnorms.batch_norm_inf_test(x4, *c4),
                                  jnorms.batch_norm_inf_test(x4, *c4))
    for a, c in zip(pnorms.batch_norm_test(x4, c4[0], c4[1]),
                    jnorms.batch_norm_test(x4, c4[0], c4[1])):
        np.testing.assert_array_equal(a, c)
    dy4 = _x(30, x4.shape).astype(np.float64)
    for a, c in zip(pnorms.batch_norm_grad_test(dy4, x4, c4[0], c4[2], c4[3]),
                    jnorms.batch_norm_grad_test(dy4, x4, c4[0], c4[2],
                                                c4[3])):
        np.testing.assert_array_equal(a, c)


def _loss_fns():
    def jfun(p):
        return jnp.sum(jnp.tanh(p["w"] @ p["v"]) ** 2) + jnp.sum(p["b"] ** 3)

    def pfun(p):
        return (torch.tanh(p["w"] @ p["v"]) ** 2).sum() + (p["b"] ** 3).sum()
    return jfun, pfun


def test_gradients_match_jax():
    jfun, pfun = _loss_fns()
    xs = {"w": _x(31, (3, 4)), "v": _x(32, (4, 2)), "b": _x(33, (5,))}
    jxs = {k: jnp.asarray(a) for k, a in xs.items()}
    pxs = {k: torch.from_numpy(a) for k, a in xs.items()}
    for kw in (dict(), dict(stop_grads={"w": True, "v": False, "b": None})):
        want = jgrads.gradients(jfun, jxs, **kw)
        got = bt.gradients(pfun, pxs, **kw)
        for k in xs:
            _close(got[k].numpy(), np.asarray(want[k]), GRAD_UTIL_TOL)
    assert not got["w"].any()
    # grad_ys over a non-scalar output, with aux
    dy = _x(34, (3, 2))
    want, jaux = jgrads.gradients(lambda p: (jnp.tanh(p["w"] @ p["v"]), 7),
                                  jxs, grad_ys=jnp.asarray(dy), has_aux=True)
    got, paux = bt.gradients(lambda p: (torch.tanh(p["w"] @ p["v"]), 7), pxs,
                             grad_ys=torch.from_numpy(dy), has_aux=True)
    assert paux == jaux == 7
    for k in ("w", "v"):
        _close(got[k].numpy(), np.asarray(want[k]), GRAD_UTIL_TOL)
    assert not got["b"].any()


@pytest.mark.parametrize("recompute", [False, True])
def test_recomputable_matches_jax(recompute):
    @jgrads.recomputable
    def jblock(x, w, scale=1.0):
        return jnp.tanh(x @ w) * scale

    @bt.recomputable
    def pblock(x, w, scale=1.0):
        return torch.tanh(x @ w) * scale
    x, w = _x(35, (5, 4)), _x(36, (4, 4))
    jy, jg, py, pg = _vjp(lambda a, b: jblock(a, b, scale=2.0,
                                              recompute=recompute),
                          lambda a, b: pblock(a, b, scale=2.0,
                                              recompute=recompute), x, w)
    _close(py, jy, GRAD_UTIL_TOL)
    for a, c in zip(pg, jg):
        _close(a, c, GRAD_UTIL_TOL)


@pytest.mark.parametrize("source", ["entropy", "generator"])
def test_recomputable_replays_dropout_and_stochastic_quantize(source):
    """Random ops inside ``recomputable(recompute=True)``: the recompute
    draws the forward's mask and rounding noise again (from the global
    entropy or from a generator argument), so the gradients equal those
    without recompute and JAX's for the same mask and values."""
    qspec = bt.QuantizeSpec(ebits=4, fbits=3, emax=7, stochastic=1)
    bspec = bt.QuantizeSpec(ebits=8, fbits=23, emax=127)   # range only
    x, w = _x(37, (6, 16)), _x(38, (6, 16))

    def run(recompute):
        drawn = []

        @bt.recomputable
        def block(a, b, g=None):
            y, mask = bt.dropout(a * b, 0.7, generator=g)
            q = bt.quantize(y, qspec, bspec, generator=g)
            drawn.append((mask, q.detach()))
            return (q * q).sum()
        bt.set_entropy(11)
        g = torch.Generator().manual_seed(12) if source == "generator" \
            else None
        pin = [torch.from_numpy(a).requires_grad_() for a in (x, w)]
        loss = block(*pin, g=g, recompute=recompute)
        return torch.autograd.grad(loss, pin), drawn
    (g_off, drawn_off), (g_on, drawn_on) = run(False), run(True)
    assert len(drawn_on) == 2            # the forward and its recompute
    mask, q = drawn_on[0]
    for m_, q_ in drawn_on[1:] + drawn_off:
        assert torch.equal(m_, mask) and torch.equal(q_, q)
    assert 0 < mask.float().mean() < 1
    for a, b in zip(g_on, g_off):
        np.testing.assert_array_equal(a.numpy(), b.numpy())

    @jgrads.recomputable
    def jblock(a, b):
        return jew.dropout(a * b, 0.7, mask=jnp.asarray(mask.numpy()))[0]
    _, vjp = jax.vjp(lambda a, b: jblock(a, b, recompute=True),
                     jnp.asarray(x), jnp.asarray(w))
    # d sum(q^2) / dq = 2q, through quantize's backward (range only here:
    # the identity on these values)
    dq = jq.quantize_float_sim(jnp.asarray(2 * q.numpy()), 8, 23, 127)
    for a, b in zip(g_on, vjp(dq)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
