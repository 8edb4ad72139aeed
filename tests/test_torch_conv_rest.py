"""The rest of the port's conv against the JAX package's, on the CPU: ragged
blocks, ``impl="matmul"``, ``BlocksparseDeconv``, both ``l2_normalize``s,
``ConvEdgeBias`` and ``cwise_linear``.

The same inputs, drawn with NumPy from a seed, go through the JAX op
(XLA on the CPU: none of these reaches a Pallas kernel) and the port's
(plain torch on the CPU), and through the NumPy goldens.

Tolerances:
- conv and deconv outputs and gradients: f32 1e-5 x max(1, max|ref|)
  against JAX (full f32 on both sides, sums in other orders), 1e-4 against
  the goldens (f64 NumPy); bf16 1e-2 x max(1, max|ref|) against JAX (one
  rounding of each bf16 output, 2^-8, and bf16 operands);
- l2 norms, edge bias and cwise_linear and their gradients: 1e-5 x
  max(1, max|ref|) (f32, a few sums in other orders).
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from blocksparse_tpu.ops import conv as jconv

import blocksparse_tpu_torch as bt
from blocksparse_tpu_torch.ops import conv as pconv

torch.set_num_threads(2)
F32_TOL, BF16_TOL, GOLD_TOL = 1e-5, 1e-2, 1e-4


def _close(got, ref, tol):
    ref = np.asarray(ref, np.float64)
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64).reshape(
        ref.shape), ref, rtol=0, atol=tol * max(1.0, np.abs(ref).max()))


def _ragged_bck(blocks, C, K, seed):
    """The JAX tests' ragged BCK: blocks of 2-5 channels each side, drawn
    without replacement, so C and K sets overlap; from the first seed at or
    after ``seed`` whose blocks use every channel (a conv's C and K count
    the channels used)."""
    while True:
        rng = np.random.RandomState(seed)
        BCK = []
        for _ in range(blocks):
            bC, bK = int(rng.randint(2, 6)), int(rng.randint(2, 6))
            BCK.append((
                tuple(sorted(rng.choice(C, bC, replace=False).tolist())),
                tuple(sorted(rng.choice(K, bK, replace=False).tolist()))))
        if {c for cs, _ in BCK for c in cs} == set(range(C)) and \
                {k for _, ks in BCK for k in ks} == set(range(K)):
            return BCK
        seed += 1000


def _fixed_bck(blocks, b, C, K, seed):
    """Blocks of b x b channels: the first ones tile C and K (every channel
    used), the rest drawn at random, overlapping them."""
    rng = np.random.RandomState(seed)

    def pick(i, n):
        if (i + 1) * b <= n:
            return tuple(range(i * b, (i + 1) * b))
        return tuple(sorted(rng.choice(n, b, replace=False).tolist()))
    return [(pick(i, C), pick(i, K)) for i in range(blocks)]


def _filter(op, rng):
    """(F of f_shape(), its blocks) from rng, uniform in [-1, 1)."""
    blocks = [rng.uniform(-1, 1, op.f_shape(b)[:2] + op.TRS)
              .astype(np.float32) for b in range(op.blocks)]
    if op.fixed_block_size:
        return np.stack(blocks).reshape(op.f_shape()), blocks
    return op.collapse_filter(blocks, dtype=np.float32), blocks


def _run_both(jop, pop, F, I, E, dtype):
    """y, dF, dI of sum(op(F, I) * E) on both packages (JAX's under one
    ``jit``), I and F in ``dtype`` (f32 or bf16)."""
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)

    @jax.jit
    def run(f, x):
        y, vjp = jax.vjp(jop, f, x)
        return (y,) + vjp(jnp.asarray(E).astype(y.dtype))
    Fj, Ij = jnp.asarray(F).astype(jd), jnp.asarray(I).astype(jd)
    yj, dFj, dIj = run(Fj, Ij)
    Ft = torch.from_numpy(np.asarray(Fj.astype(jnp.float32))).to(td) \
        .requires_grad_()
    It = torch.from_numpy(np.asarray(Ij.astype(jnp.float32))).to(td) \
        .requires_grad_()
    yt = pop(Ft, It)
    (yt.float() * torch.from_numpy(E)).sum().backward()
    assert yt.dtype == td and Ft.grad.dtype == td and It.grad.dtype == td
    f32 = jnp.float32
    return ((yt, np.asarray(yj.astype(f32))),
            (Ft.grad, np.asarray(dFj.astype(f32))),
            (It.grad, np.asarray(dIj.astype(f32))))


def _check(pairs, tol):
    for got, ref in pairs:
        _close(got, ref, tol)


# ---------------- ragged blocks ----------------

_RAGGED = {"2d": ((3, 3), (8, 8), (1, 1), (1, 1)),
           "2d-stride2": ((3, 3), (9, 9), (2, 2), (1, 1)),
           "1d-dilated": ((3,), (12,), (1,), (2,))}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("geom", sorted(_RAGGED))
def test_ragged_conv_matches_jax_and_goldens(geom, dtype):
    """Ragged blocks (sizes 2-5, overlapping C and K sets): forward, dI and
    dF against JAX's padded scan and, in f32, the NumPy goldens."""
    TRS, DHW, st, dil = _RAGGED[geom]
    BCK = _ragged_bck(5, 8, 8, seed=3)
    kw = dict(strides=st, dilates=dil, padding="SAME")
    jop, pop = jconv.BlocksparseConv(BCK, TRS, DHW, **kw), \
        bt.BlocksparseConv(BCK, TRS, DHW, **kw)
    assert not pop.fixed_block_size and pop.f_shape() == [pop.sizeF]
    rng = np.random.RandomState(len(geom))
    F, blocks = _filter(pop, rng)
    I = rng.uniform(-1, 1, pop.i_shape(2)).astype(np.float32)
    E = rng.uniform(-1, 1, pop.o_shape(2)).astype(np.float32)
    pairs = _run_both(jop, pop, F, I, E, dtype)
    _check(pairs, F32_TOL if dtype == "float32" else BF16_TOL)
    if dtype == "float32":
        (y, _), (dF, _), (dI, _) = pairs
        _close(y, pop.fprop_test(blocks, I), GOLD_TOL)
        _close(dI, pop.bprop_test(blocks, E), GOLD_TOL)
        _close(dF, pop.updat_test(E, I), GOLD_TOL)


def test_ragged_conv_takes_the_ragged_path_whatever_impl():
    """A ragged conv with impl="matmul" runs the ragged path (as JAX's
    does), equal to impl="conv" bit for bit; impl="bsmm" raises JAX's
    ValueError; a filter given as a list of blocks equals the flat one."""
    BCK = _ragged_bck(4, 8, 8, seed=5)
    ops = [bt.BlocksparseConv(BCK, (3, 3), (8, 8), impl=impl)
           for impl in ("conv", "matmul")]
    rng = np.random.RandomState(0)
    F, blocks = _filter(ops[0], rng)
    I = torch.from_numpy(rng.uniform(-1, 1, ops[0].i_shape(2))
                         .astype(np.float32))
    ys = [op(torch.from_numpy(F), I) for op in ops]
    assert torch.equal(ys[0], ys[1])
    assert torch.equal(ops[0]([torch.from_numpy(b) for b in blocks], I),
                       ys[0])
    with pytest.raises(ValueError) as ref:
        jconv.BlocksparseConv(BCK, (3, 3), (8, 8), impl="bsmm")
    with pytest.raises(ValueError) as got:
        bt.BlocksparseConv(BCK, (3, 3), (8, 8), impl="bsmm")
    assert str(got.value) == str(ref.value)


def test_ragged_filter_helpers_and_convert():
    """f_shape, collapse/expand, the padded tables and the convert helpers
    on a ragged conv, against JAX's."""
    BCK = _ragged_bck(6, 12, 10, seed=9)
    jop = jconv.BlocksparseConv(BCK, (3, 3), (8, 8))
    pop = bt.BlocksparseConv(BCK, (3, 3), (8, 8))
    assert pop.f_shape() == jop.f_shape() == [jop.sizeF]
    for b in range(pop.blocks):
        assert pop.f_shape(b) == jop.f_shape(b)
    for name in ("_lutC_pad", "_lutK_pad", "_fmap_pad"):
        np.testing.assert_array_equal(getattr(pop, name),
                                      getattr(jop, name))
    F = bt.random_jax_conv_filter(pop, seed=4)
    assert F.shape == (pop.sizeF,)
    blocks = pop.expand_filter(F)
    np.testing.assert_array_equal(pop.collapse_filter(blocks, np.float32), F)
    for a, b in zip(blocks, jop.expand_filter(F)):
        np.testing.assert_array_equal(a, b)
    t = bt.conv_filter_from_jax(F, pop, "cpu")
    assert t.shape == (pop.sizeF,) and np.array_equal(t.numpy(), F)
    with pytest.raises(ValueError, match="f_shape"):
        bt.conv_filter_from_jax(F[:-1], pop, "cpu")


# ---------------- impl="matmul" ----------------

_MATMUL = {"s1": ((3, 3), (12, 12), (1, 1), (1, 1), 4),
           "s2": ((3, 3), (12, 12), (2, 2), (1, 1), 4),
           "d2": ((3, 3), (12, 12), (1, 1), (2, 2), 4),
           "3d": ((3, 3, 3), (6, 6, 6), (1, 1, 1), (1, 1, 1), 4),
           "b40-chunks": ((3, 3), (8, 8), (1, 1), (1, 1), 40)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("geom", sorted(_MATMUL))
def test_matmul_impl_matches_jax_and_goldens(geom, dtype):
    """The tap-chunked gathered product (overlapping channel sets; bC 40
    cuts the 9 taps into chunks of 4): forward, dI and dF against JAX's and
    the goldens."""
    TRS, DHW, st, dil, b = _MATMUL[geom]
    C = K = 2 * b
    BCK = _fixed_bck(3, b, C, K, seed=b)
    kw = dict(strides=st, dilates=dil, padding="SAME", impl="matmul")
    jop, pop = jconv.BlocksparseConv(BCK, TRS, DHW, **kw), \
        bt.BlocksparseConv(BCK, TRS, DHW, **kw)
    rng = np.random.RandomState(b + len(DHW))
    F, blocks = _filter(pop, rng)
    I = rng.uniform(-1, 1, pop.i_shape(2)).astype(np.float32)
    E = rng.uniform(-1, 1, pop.o_shape(2)).astype(np.float32)
    pairs = _run_both(jop, pop, F, I, E, dtype)
    _check(pairs, F32_TOL if dtype == "float32" else BF16_TOL)
    if dtype == "float32":
        (y, _), (dF, _), (dI, _) = pairs
        _close(y, pop.fprop_test(blocks, I), GOLD_TOL)
        _close(dI, pop.bprop_test(blocks, E), GOLD_TOL)
        _close(dF, pop.updat_test(E, I), GOLD_TOL)
        conv = bt.BlocksparseConv(BCK, TRS, DHW, strides=st, dilates=dil)
        _close(conv(torch.from_numpy(F), torch.from_numpy(I)),
               y.detach().numpy(), F32_TOL)


# ---------------- BlocksparseDeconv ----------------

_DECONV = ("1d-fixed", "2d-fixed", "2d-stride2")


def _deconv_case(name):
    if name == "1d-fixed":
        return [((0, 1), (0, 1)), ((2, 3), (2, 3))], (3,), (12,), (1,)
    if name == "1d-ragged":
        return _ragged_bck(4, 8, 8, seed=7), (3,), (10,), (1,)
    if name == "2d-fixed":
        return _fixed_bck(3, 4, 8, 8, seed=2), (3, 3), (6, 6), (1, 1)
    return _fixed_bck(3, 4, 8, 8, seed=6), (3, 3), (5, 5), (2, 2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", _DECONV)
def test_deconv_matches_jax_and_goldens(name, dtype):
    """BlocksparseDeconv: shapes swapped as JAX's; forward (the conv's
    transpose), dI (the conv's forward of dy) and dF (the conv's filter
    gradient with image dy and output gradient I) against JAX's
    ``linear_transpose`` and the swapped goldens."""
    BCK, TRS, DHW, st = _deconv_case(name)
    jop, pop = jconv.BlocksparseDeconv(BCK, TRS, DHW, strides=st), \
        bt.BlocksparseDeconv(BCK, TRS, DHW, strides=st)
    assert pop.MPQ == jop.MPQ and pop.i_shape(2) == jop.i_shape(2) \
        and pop.o_shape(2) == jop.o_shape(2) and pop.f_shape() == \
        jop.f_shape()
    rng = np.random.RandomState(len(name))
    F, blocks = _filter(pop, rng)
    I = rng.uniform(-1, 1, pop.i_shape(2)).astype(np.float32)
    E = rng.uniform(-1, 1, pop.o_shape(2)).astype(np.float32)
    pairs = _run_both(jop, pop, F, I, E, dtype)
    _check(pairs, F32_TOL if dtype == "float32" else BF16_TOL)
    if dtype == "float32":
        (y, _), (dF, _), (dI, _) = pairs
        _close(y, pop.fprop_test(blocks, I), GOLD_TOL)
        _close(dI, pop.bprop_test(blocks, E), GOLD_TOL)
        _close(dF, pop.updat_test(E, I), GOLD_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ragged_deconv_matches_goldens(dtype):
    """A ragged deconv: JAX's raises (its ``linear_transpose`` cannot
    transpose the ragged conv's scan: ROADMAP F7), so the port's forward,
    dI and dF are held to the goldens in f32, and in bf16 to its own f32
    results."""
    BCK, TRS, DHW = _ragged_bck(4, 8, 8, seed=7), (3,), (10,)
    jop, pop = jconv.BlocksparseDeconv(BCK, TRS, DHW), \
        bt.BlocksparseDeconv(BCK, TRS, DHW)
    rng = np.random.RandomState(4)
    F, blocks = _filter(pop, rng)
    I = rng.uniform(-1, 1, pop.i_shape(2)).astype(np.float32)
    E = rng.uniform(-1, 1, pop.o_shape(2)).astype(np.float32)
    with pytest.raises(TypeError):
        jop(jnp.asarray(F), jnp.asarray(I))
    td = getattr(torch, dtype)
    Ft, It = (torch.from_numpy(a).to(td).requires_grad_() for a in (F, I))
    y = pop(Ft, It)
    (y.float() * torch.from_numpy(E)).sum().backward()
    if dtype == "float32":
        refs = (pop.fprop_test(blocks, I), pop.updat_test(E, I),
                pop.bprop_test(blocks, E))
        tol = GOLD_TOL
    else:
        F32, I32 = (torch.from_numpy(a).requires_grad_() for a in (F, I))
        y32 = pop(F32, I32)
        (y32 * torch.from_numpy(E)).sum().backward()
        refs = (y32.detach().numpy(), F32.grad.numpy(), I32.grad.numpy())
        tol = BF16_TOL
    for got, ref in zip((y, Ft.grad, It.grad), refs):
        _close(got, ref, tol)


def test_deconv_is_the_conv_transpose():
    """<deconv(F, I), x> = <I, conv(F, x)> for the conv the deconv
    transposes (f32 sums: 1e-5 relative)."""
    BCK, TRS, DHW, st = _deconv_case("2d-stride2")
    dec = bt.BlocksparseDeconv(BCK, TRS, DHW, strides=st)
    conv = bt.BlocksparseConv(dec.BCK, TRS, dec.DHW[-2:], dec.MPQ[-2:],
                              strides=st)
    rng = np.random.RandomState(1)
    F = torch.from_numpy(_filter(dec, rng)[0])
    I = torch.from_numpy(rng.uniform(-1, 1, dec.i_shape(2)))
    x = torch.from_numpy(rng.uniform(-1, 1, conv.i_shape(2)))
    lhs = (dec(F, I.float()).double() * x).sum().item()
    rhs = (I * conv(F, x.float()).double()).sum().item()
    assert abs(lhs - rhs) <= F32_TOL * max(1.0, abs(rhs))


# ---------------- l2 norms ----------------

@pytest.mark.parametrize("gain", [False, True])
@pytest.mark.parametrize("kind", ["conv-fixed", "conv-ragged",
                                  "deconv-fixed", "deconv-ragged"])
def test_l2_normalize_matches_jax_and_goldens(kind, gain):
    """KCTRS rows of the conv, CKTRS columns of the deconv, fixed and
    ragged, with and without gain: values and the gradient of a weighted
    sum against JAX's, values against ``l2_normalize_test``."""
    ragged = kind.endswith("ragged")
    BCK = _ragged_bck(4, 8, 8, seed=5) if ragged \
        else _fixed_bck(3, 4, 8, 8, seed=2)
    cls = "BlocksparseDeconv" if kind.startswith("deconv") \
        else "BlocksparseConv"
    jop = getattr(jconv, cls)(BCK, (3, 3), (8, 8))
    pop = getattr(bt, cls)(BCK, (3, 3), (8, 8))
    rng = np.random.RandomState(len(kind) + gain)
    F, blocks = _filter(pop, rng)
    n = pop._n_ccols if cls == "BlocksparseDeconv" else pop._n_krows
    g = rng.uniform(0.5, 1.5, n).astype(np.float32) if gain else None
    w = rng.uniform(-1, 1, pop.sizeF).astype(np.float32)

    def jloss(f):
        out = jop.l2_normalize(f, gain=None if g is None else jnp.asarray(g))
        return jnp.sum(out.reshape(-1) * jnp.asarray(w)), out
    (_, ref), dref = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(F))
    Ft = torch.from_numpy(F).requires_grad_()
    got = pop.l2_normalize(Ft, gain=None if g is None else torch.from_numpy(g))
    assert tuple(got.shape) == tuple(ref.shape)
    (got.reshape(-1) * torch.from_numpy(w)).sum().backward()
    _close(got, np.asarray(ref), F32_TOL)
    _close(Ft.grad, np.asarray(dref), F32_TOL)
    _close(got, pop.l2_normalize_test(blocks, gain=g), F32_TOL)


# ---------------- ConvEdgeBias ----------------

_EDGE = {"conv-NHWC": ("conv", "NHWC", 1), "conv-NCHW": ("conv", "NCHW", 1),
         "conv-NCHW-stride2": ("conv", "NCHW", 2),
         "deconv-NHWC": ("deconv", "NHWC", 2)}


@pytest.mark.parametrize("case", sorted(_EDGE))
def test_edge_bias_matches_jax_and_goldens(case):
    """The pattern map (ordered by first pixel) equals JAX's; y and the
    gradients in x, g and b against JAX's and the goldens
    (``edge_bias_test``, ``edge_bias_grad_test``), NCHW ((K, E) gains) and
    NHWC ((E, K))."""
    kind, fmt, stride = _EDGE[case]
    N, C, K, big = 2, 4, 6, 8
    # x: the op's input, y: its output (the deconv's the larger image)
    xs, ys = (big, big // stride) if kind == "conv" else (big // stride,
                                                         big)
    if fmt == "NHWC":
        x_shape, y_shape = [N, xs, xs, C], [N, ys, ys, K]
        strides = [1, stride, stride, 1]
    else:
        x_shape, y_shape = [N, C, xs, xs], [N, K, ys, ys]
        strides = [1, 1, stride, stride]
    init = "conv_edge_bias_init" if kind == "conv" \
        else "deconv_edge_bias_init"
    w_shape = [3, 3, C, K]
    jeb = getattr(jconv, init)(y_shape, x_shape, w_shape, strides=strides,
                               data_format=fmt)
    peb = getattr(bt, init)(y_shape, x_shape, w_shape, strides=strides,
                            data_format=fmt)
    assert peb.edgeBiasDim == jeb.edgeBiasDim > 0 and peb.shape == jeb.shape
    assert peb.edgeBiasMap == jeb.edgeBiasMap
    np.testing.assert_array_equal(peb.pattern_map, jeb.pattern_map)
    out_shape = y_shape
    rng = np.random.RandomState(len(case))
    x = rng.uniform(-1, 1, out_shape).astype(np.float32)
    g = rng.uniform(0.5, 1.5, peb.shape).astype(np.float32)
    b = rng.uniform(-0.5, 0.5, peb.shape).astype(np.float32)
    dy = rng.uniform(-1, 1, out_shape).astype(np.float32)

    def jloss(x, g, b):
        return jnp.sum(jeb(x, g, b) * jnp.asarray(dy))
    yj = jeb(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b))
    grads_j = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(g), jnp.asarray(b))
    xt, gt, bt_ = (torch.from_numpy(a).requires_grad_() for a in (x, g, b))
    y = peb(xt, gt, bt_)
    (y * torch.from_numpy(dy)).sum().backward()
    _close(y, np.asarray(yj), F32_TOL)
    _close(y, peb.edge_bias_test(x, g, b), F32_TOL)
    golden = peb.edge_bias_grad_test(dy, x, g)
    for got, ref, gold in zip((xt.grad, gt.grad, bt_.grad), grads_j, golden):
        _close(got, np.asarray(ref), F32_TOL)
        _close(got, gold, F32_TOL)


def test_edge_bias_cache_and_interior_only_geometry():
    """One geometry's pattern map is built once (the class cache); a
    geometry with no edge pattern (VALID) returns x itself."""
    pconv.ConvEdgeBias.Cache.clear()
    a = bt.conv_edge_bias_init([2, 8, 8, 6], [2, 8, 8, 4], [3, 3, 4, 6])
    b = bt.conv_edge_bias_init([2, 8, 8, 6], [2, 8, 8, 4], [3, 3, 4, 6])
    assert len(pconv.ConvEdgeBias.Cache) == 1
    assert a.pattern_map is b.pattern_map
    valid = bt.conv_edge_bias_init([2, 6, 6, 6], [2, 8, 8, 4], [3, 3, 4, 6],
                                   padding="VALID")
    x = torch.ones(2, 6, 6, 6)
    assert valid.edgeBiasDim == 0 and valid(x, None, None) is x


# ---------------- cwise_linear ----------------

_CWISE = {"gain+bias relu": dict(gain=True, bias=True, relu=True),
          "bias_first": dict(gain=True, bias=True, bias_first=True),
          "gain only": dict(gain=True), "bias only relu":
          dict(bias=True, relu=True)}


@pytest.mark.parametrize("case", sorted(_CWISE))
def test_cwise_linear_matches_jax_and_goldens(case):
    """y and the gradients in x, gain and bias against JAX's, and (without
    bias_first) against ``cwise_linear_test``/``cwise_linear_grad_test``."""
    kw = dict(_CWISE[case])
    rng = np.random.RandomState(len(case))
    x = rng.uniform(-1, 1, (2, 8, 4, 4)).astype(np.float32)
    a = rng.uniform(0.5, 1.5, 8).astype(np.float32)
    b = rng.uniform(-0.5, 0.5, 8).astype(np.float32)
    dy = rng.uniform(-1, 1, x.shape).astype(np.float32)
    use_g, use_b = kw.pop("gain", False), kw.pop("bias", False)

    def jloss(x, a, b):
        return jnp.sum(jconv.cwise_linear(x, gain=a if use_g else None,
                                          bias=b if use_b else None, **kw)
                       * jnp.asarray(dy))
    yj = jconv.cwise_linear(jnp.asarray(x), gain=jnp.asarray(a) if use_g
                            else None, bias=jnp.asarray(b) if use_b
                            else None, **kw)
    grads_j = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(a), jnp.asarray(b))
    xt, at, bt_ = (torch.from_numpy(v).requires_grad_() for v in (x, a, b))
    y = bt.cwise_linear(xt, gain=at if use_g else None,
                        bias=bt_ if use_b else None, **kw)
    (y * torch.from_numpy(dy)).sum().backward()
    _close(y, np.asarray(yj), F32_TOL)
    for got, ref, used in ((xt.grad, grads_j[0], True),
                           (at.grad, grads_j[1], use_g),
                           (bt_.grad, grads_j[2], use_b)):
        if used:
            _close(got, np.asarray(ref), F32_TOL)
        else:
            assert got is None and not np.asarray(ref).any()
    if not kw.get("bias_first"):
        ga, gb = (a if use_g else 1), (b if use_b else 0)
        relu = kw.get("relu", False)
        _close(y, pconv.cwise_linear_test(x, ga, gb, relu=relu), F32_TOL)
        dx, da, db = pconv.cwise_linear_grad_test(dy, x, ga, gb, relu=relu)
        _close(xt.grad, dx, F32_TOL)
        if use_g:
            _close(at.grad, da, F32_TOL)
        if use_b:
            _close(bt_.grad, db, F32_TOL)
    with pytest.raises(ValueError):
        bt.cwise_linear(xt)
