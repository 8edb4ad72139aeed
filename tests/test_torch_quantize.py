"""The port's quantize ops against the JAX package's, from the same NumPy
inputs.

Tolerances:
- ``quantize_float_sim`` (nearest) and the gradient through ``quantize``
  (which uses ``b_qspec``): bit for bit against an exact NumPy model of
  the format (powers of two by ``np.ldexp``), and within one step of the
  format's grid (plus 2e-6 of the value) of JAX's: the JAX package builds
  its grid with XLA's ``exp2``, inexact on the CPU for most exponents, so
  its values lie ~1e-6 relative off the grid and round-half cases may go
  either way (ROADMAP F4);
- stochastic rounding draws other random numbers than JAX: each value
  lands on one of its two grid neighbours, and the mean of many draws is
  within 5 sigma of x;
- emax estimates and tensor stats: f32 reductions in other orders, 1e-6
  relative (estimates are whole numbers: equal);
- ``log_stats``: the same rows (printed to 6 significant digits) at the
  same steps as JAX's.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from blocksparse_tpu.ops import quantize as jq

import blocksparse_tpu_torch as bt
import blocksparse_tpu_torch.ops.quantize as pq

torch.set_num_threads(2)
FORMATS = [dict(ebits=4, fbits=3, emax=7), dict(ebits=5, fbits=10, emax=15),
           dict(ebits=8, fbits=7, emax=127), dict(ebits=6, fbits=2, emax=3,
                                                  denorm=False)]


def _exact_sim(x, ebits, fbits, emax, denorm=True):
    """The format's nearest rounding in NumPy with exact powers of two."""
    max_float, min_float, bexp_min = pq._format_params(ebits, fbits, emax,
                                                       denorm)
    x = x.astype(np.float32)
    ax = np.abs(x)
    _, ex = np.frexp(np.where(ax > 0, ax, 1.0).astype(np.float32))
    ulp = np.ldexp(np.float32(1), ex - 1 - fbits).astype(np.float32)
    q = (np.floor((ax + np.float32(0.5) * ulp) / ulp) * ulp).astype(
        np.float32)
    q = np.minimum(q, np.float32(max_float))
    q = np.where(q < np.float32(min_float), np.float32(0), q)
    if denorm:
        qd = np.float32(np.ldexp(1.0, bexp_min - 127))
        q = np.where(q < qd * np.float32(2.0 ** fbits) * 2,
                     np.round(q / qd) * qd, q).astype(np.float32)
    return (np.sign(x) * q).astype(np.float32)


def _jax_close(got, ref, x, ebits, fbits, emax, denorm=True):
    """|got - ref| <= one step of the format's grid at x (the denorm
    quantum where that is larger) + 2e-6 |ref|."""
    _, _, bexp_min = pq._format_params(ebits, fbits, emax, denorm)
    ex = np.frexp(np.where(x != 0, np.abs(x), 1.0))[1]
    step = np.maximum(np.ldexp(1.0, ex - fbits),
                      np.ldexp(1.0, bexp_min - 127) if denorm else 0.0)
    assert (np.abs(got - ref) <= step + 2e-6 * np.abs(ref)).all()


def _values(seed, lo, hi, n=4000):
    rng = np.random.RandomState(seed)
    x = rng.standard_normal(n) * 2.0 ** rng.uniform(lo, hi, n)
    return np.concatenate([x, [0.0, -0.0, 1.0, -1.5, 1e6, -1e6]]).astype(
        np.float32)


@pytest.mark.parametrize("fmt", range(len(FORMATS)))
def test_quantize_float_sim_matches_jax_and_the_exact_grid(fmt):
    f = FORMATS[fmt]
    for x in (_values(fmt, -3, 3), _values(10 + fmt, -40, 30)):
        got = pq.quantize_float_sim(
            torch.from_numpy(x), f["ebits"], f["fbits"], f["emax"],
            denorm=f.get("denorm", True)).numpy()
        np.testing.assert_array_equal(got, _exact_sim(x, **f))
    x = _values(fmt, -3, 3)
    ref = np.asarray(jq.quantize_float_sim(
        jnp.asarray(x), f["ebits"], f["fbits"], f["emax"],
        denorm=f.get("denorm", True)))
    _jax_close(_exact_sim(x, **f), ref, x, **f)


def test_quantize_grad_uses_its_backward_spec():
    fspec, bspec = dict(ebits=8, fbits=7, emax=127), dict(ebits=5, fbits=2,
                                                          emax=15)
    x = _values(3, -2, 2, 500)
    dy = _values(4, -2, 2, 500)
    jf, jb = jq.QuantizeSpec(**fspec), jq.QuantizeSpec(**bspec)
    y, vjp = jax.vjp(lambda a: jq.quantize(a, jf, jb), jnp.asarray(x))
    (dx,) = vjp(jnp.asarray(dy))
    t = torch.from_numpy(x).requires_grad_()
    got = bt.quantize(t, bt.QuantizeSpec(**fspec), bt.QuantizeSpec(**bspec))
    got.backward(torch.from_numpy(dy))
    np.testing.assert_array_equal(got.detach().numpy(),
                                  _exact_sim(x, **fspec))
    np.testing.assert_array_equal(t.grad.numpy(), _exact_sim(dy, **bspec))
    _jax_close(got.detach().numpy(), np.asarray(y), x, **fspec)
    _jax_close(t.grad.numpy(), np.asarray(dx), dy, **bspec)
    with pytest.raises(ValueError):
        bt.quantize(torch.ones(2, dtype=torch.bfloat16),
                    bt.QuantizeSpec(ebits=5, fbits=10))


def test_stochastic_rounding_is_unbiased_on_the_grid():
    spec = bt.QuantizeSpec(ebits=8, fbits=3, emax=127, stochastic=1)
    x = torch.full((20000,), 1.0 + 3 / 64)          # between 1 and 1.125
    g = torch.Generator().manual_seed(0)
    q = bt.quantize(x, spec, generator=g)
    assert set(torch.unique(q).tolist()) <= {1.0, 1.125}
    p = 3 / 8                                       # P(round up)
    sigma = np.sqrt(p * (1 - p) / x.numel()) * 0.125
    assert abs(q.mean().item() - x[0].item()) < 5 * sigma
    again = bt.quantize(x, spec, generator=torch.Generator().manual_seed(0))
    assert torch.equal(q, again)


@pytest.mark.parametrize("mode", [1, 2])
def test_emax_estimate_and_tensor_stats_match_jax(mode):
    x = _values(5, -6, 6, 3000)
    js = jq.QuantizeSpec(mode=mode, bias_pad=1)
    ps = bt.QuantizeSpec(mode=mode, bias_pad=1)
    assert float(bt.quantize_emax_estimate(torch.from_numpy(x), ps)) == \
        float(jq.quantize_emax_estimate(jnp.asarray(x), js))
    for a, b in zip(pq.tensor_stats(torch.from_numpy(x), sat_val=4.0,
                                    ftz_val=1e-3),
                    jq.tensor_stats(jnp.asarray(x), sat_val=4.0,
                                    ftz_val=1e-3)):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-6)


def test_tracked_emax_follows_jax_tracker():
    """Mode-1 specs tracked by name, forward and gradient streams, for
    five steps at frequency 2: the same emax after each step."""
    fs = dict(ebits=5, fbits=4, emax=2, mode=1, frequency=2, bias_pad=1)
    xs = [_values(20 + i, -4 + i, i, 256) for i in range(5)]

    def jstep(x):
        return jax.grad(lambda a: jnp.sum(jq.quantize(
            a, jq.QuantizeSpec(**fs), jq.QuantizeSpec(**fs),
            name="q") * 3.0))(x)

    def pstep(x):
        x = x.clone().requires_grad_()
        y = bt.quantize(x, bt.QuantizeSpec(**fs), bt.QuantizeSpec(**fs),
                        name="q")
        (y * 3.0).sum().backward()
        return x.grad
    jt, pt = jq.QuantizeTracker(), bt.QuantizeTracker()
    jw, pw = jt.wrap_jit(jstep), pt.wrap_jit(pstep)
    for x in xs:
        dj = jw(jnp.asarray(x))
        dp = pw(torch.from_numpy(x))
        for name in ("q", "q_grad"):
            assert pt.emax_of(name) == jt.emax_of(name), name
            assert isinstance(pt.emax[name], torch.Tensor)
        _jax_close(dp.numpy(), np.asarray(dj), x, **{
            k: fs[k] for k in ("ebits", "fbits", "emax")})
    assert pt.counts == jt.counts


def test_log_stats_rows_match_jax(tmp_path, capsys):
    x = _values(6, -3, 3, 100)[:100].reshape(10, 10)
    for step in (3, 4):
        jf, pf = tmp_path / f"j{step}.tsv", tmp_path / f"p{step}.tsv"
        jax.grad(lambda a: jnp.sum(jq.log_stats(
            a, step, logfile=str(jf), name="t") ** 2))(jnp.asarray(x))
        jax.effects_barrier()
        t = torch.from_numpy(x).requires_grad_()
        (bt.log_stats(t, torch.tensor(step), logfile=str(pf),
                      name="t") ** 2).sum().backward()
        assert torch.equal(t.grad, 2 * torch.from_numpy(x))
        assert pf.read_text() == jf.read_text()
    rows = (tmp_path / "p4.tsv").read_text().splitlines()
    assert rows[0].split("\t") == pq.stat_headers
    assert [r.split("\t")[-1] for r in rows[1:]] == ["t", "t_grad"]
    bt.log_stats(torch.ones(3), 8, name="s")
    assert capsys.readouterr().out.split("\t")[-1].strip() == "s"
