"""The port's block-sparse conv against the JAX package's, on the CPU.

The same inputs, drawn with NumPy from a seed, go through JAX's
``BlocksparseConv`` (its im2col/col2im Pallas kernels in interpret mode
where it takes them) and the port's (the plain versions, as on any CPU
tensor), and through the NumPy goldens.

Tolerances: im2col and col2im in f32 are exact (a copy; the same f32 sums
in the same tap order).  Conv outputs and gradients: f32 1e-5 x max(1,
max|ref|) (full f32 on both sides, sums in other orders); bf16 1e-2 x
max(1, max|ref|) (one rounding of each bf16 output, 2^-8, plus the
rounding of bf16 operands that differ in the last place).
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from blocksparse_tpu.kernels import im2col as jax_im2col
from blocksparse_tpu.ops import conv as jax_conv
from blocksparse_tpu.ops.conv import BlocksparseConv as JaxConv

from blocksparse_tpu_torch import (BlocksparseConv, conv_filter_from_jax,
                                   random_jax_conv_filter)
from blocksparse_tpu_torch.kernels import im2col as port_im2col
from blocksparse_tpu_torch.ops import conv as port_conv

torch.set_num_threads(2)
F32_TOL, BF16_TOL = 1e-5, 1e-2


def _close(got, ref, tol):
    ref = np.asarray(ref, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), ref, rtol=0,
                               atol=tol * max(1.0, np.abs(ref).max()))


def _blocks(pairs, b):
    return [(tuple(range(cb * b, (cb + 1) * b)),
             tuple(range(kb * b, (kb + 1) * b))) for cb, kb in pairs]


# (R, S, pt, pl): every pad 0..R-1 of each filter, asymmetric R != S
_TAPS = ([(3, 3, p, p) for p in range(3)] + [(3, 3, 0, 2)]
         + [(1, 3, 0, p) for p in range(3)]
         + [(5, 5, p, 4 - p) for p in range(5)]
         + [(3, 1, p, 0) for p in range(3)])


@pytest.mark.parametrize("R,S,pt,pl", _TAPS,
                         ids=[f"{r}x{s}-p{a}{b}" for r, s, a, b in _TAPS])
def test_im2col_col2im_plain_match_jax_kernels(R, S, pt, pl):
    """The plain versions equal JAX's Pallas im2col/col2im exactly in f32;
    row order (cb, tap, ci) with tap = r*S + s."""
    bC = 8 if (R + S + pt) % 2 else 16
    C, N, H, W = 2 * bC, 2, 8, 16
    rng = np.random.RandomState(R * 100 + S * 10 + pt)
    xc = rng.standard_normal((C, N * H * W)).astype(np.float32)
    dX = rng.standard_normal((C * R * S, N * H * W)).astype(np.float32)
    args = (H, W, R, S, pt, pl, bC)
    X = port_im2col.im2col(torch.from_numpy(xc), *args)
    np.testing.assert_array_equal(
        X.numpy(), np.asarray(jax_im2col.im2col(jnp.asarray(xc), *args)))
    dx = port_im2col.col2im(torch.from_numpy(dX), *args)
    np.testing.assert_array_equal(
        dx.numpy(), np.asarray(jax_im2col.col2im(jnp.asarray(dX), *args)))
    # the tap order, spelled out for one element of a middle pixel
    t = (R - 1) * S + (S - 1)
    h, w = 3, 5
    assert X[(1 * R * S + t) * bC + 2, N * H * W - H * W + h * W + w] == \
        xc[bC + 2, N * H * W - H * W + (h + R - 1 - pt) * W + (w + S - 1 - pl)]


@pytest.mark.parametrize("R,S,pt,pl,H,W", [(3, 3, 1, 1, 12, 12),
                                           (3, 5, 2, 0, 1, 20)])
def test_col2im_is_the_adjoint_of_im2col(R, S, pt, pl, H, W):
    """<im2col(x), y> = <x, col2im(y)>, and autograd's backward of im2col
    is col2im."""
    bC, C, N = 8, 24, 3
    rng = np.random.RandomState(7)
    x = torch.from_numpy(rng.standard_normal((C, N * H * W)))
    y = torch.from_numpy(rng.standard_normal((C * R * S, N * H * W)))
    args = (H, W, R, S, pt, pl, bC)
    lhs = (port_im2col.im2col(x, *args) * y).sum()
    rhs = (x * port_im2col.col2im(y, *args)).sum()
    assert abs(lhs - rhs) <= 1e-5 * abs(rhs)
    xg = x.clone().requires_grad_()
    (g,) = torch.autograd.grad(port_im2col.im2col(xg, *args), xg, y)
    assert torch.equal(g, port_im2col.col2im(y, *args))


_BSMM_BCKS = {
    "2d-b8": (_blocks([(0, 0), (0, 1), (1, 1), (2, 2), (3, 0), (3, 3)], 8),
              (3, 3), (12, 12)),
    "1d-b16": (_blocks([(0, 0), (1, 0), (1, 1)], 16), (3,), (10,)),
    "asym-b8": (_blocks([(0, 1), (1, 0), (2, 2), (2, 0)], 8), (3, 1),
                (8, 6)),
}


@pytest.mark.parametrize("name", sorted(_BSMM_BCKS))
def test_build_bsmm_matches_jax(name):
    BCK, TRS, DHW = _BSMM_BCKS[name]
    ref = JaxConv(BCK, TRS, DHW, impl="bsmm")
    port = BlocksparseConv(BCK, TRS, DHW, impl="bsmm")
    for k in ("C", "K", "blocks", "TRS", "DHW", "MPQ", "padding", "trs",
              "flops", "sizeF", "spatial_rank", "fixed_block_size"):
        assert getattr(port, k) == getattr(ref, k), k
    assert port.f_shape() == ref.f_shape() and port.i_shape(3) == \
        ref.i_shape(3) and port.o_shape(3) == ref.o_shape(3)
    for k in ("_lutC", "_lutK", "_flatK", "_krow_of_elem", "_ccol_of_elem",
              "_bsmm_wb", "_bsmm_wt"):
        np.testing.assert_array_equal(getattr(port, k), getattr(ref, k))
    op, rop = port._bsmm_op, ref._bsmm_op
    np.testing.assert_array_equal(op.layout, rop.layout)
    assert op.updat_list == rop.updat_list and op.axis == rop.axis == 0
    assert (op.bsize, op.C, op.K) == (rop.bsize, rop.C, rop.K)


def _jax_fwd_grads(bsc, F, I, E):
    y = bsc(jnp.asarray(F), jnp.asarray(I))

    def loss(f, x):
        return jnp.sum(bsc(f, x).astype(jnp.float32) * jnp.asarray(E))
    dF, dI = jax.grad(loss, argnums=(0, 1))(jnp.asarray(F), jnp.asarray(I))
    return [np.asarray(a.astype(jnp.float32)) for a in (y, dI, dF)]


def _port_fwd_grads(conv, F, I, E):
    Ft = F.detach().clone().requires_grad_()
    It = I.detach().clone().requires_grad_()
    y = conv(Ft, It)
    dF, dI = torch.autograd.grad((y.float() * torch.from_numpy(E)).sum(),
                                 (Ft, It))
    assert dI.dtype == It.dtype and dF.dtype == Ft.dtype
    assert dF.shape == Ft.shape and dI.shape == It.shape
    return [a.detach().float().numpy() for a in (y, dI, dF)]


# (BCK pairs, bsize, TRS, DHW, strides, dilates): the JAX package's
# test_conv_bsmm_* cases, plus a port-only 12x12 im2col case
_CONV_CASES = {
    "s1-d1-12x12": ([(0, 0), (0, 1), (1, 1), (2, 2), (3, 0), (3, 3)], 8,
                    (3, 3), (12, 12), (1, 1), (1, 1)),
    "s2-d1": ([(0, 0), (0, 1), (1, 1), (2, 2), (3, 0), (3, 3)], 8, (3, 3),
              (12, 12), (2, 2), (1, 1)),
    "s1-d2": ([(0, 0), (0, 1), (1, 1), (2, 2), (3, 0), (3, 3)], 8, (3, 3),
              (12, 12), (1, 1), (2, 2)),
    "1d": ([(0, 0), (1, 1)], 8, (3,), (10,), (1,), (1,)),
    "im2col-16x16": ([(0, 0), (0, 1), (1, 1), (2, 2), (3, 0), (3, 3),
                      (2, 1)], 8, (3, 3), (16, 16), (1, 1), (1, 1)),
    "asym-3x1-8x16": ([(0, 1), (1, 0), (1, 1)], 16, (3, 1), (8, 16),
                      (1, 1), (1, 1)),
}


@pytest.mark.parametrize("name", list(_CONV_CASES))
def test_conv_bsmm_matches_jax_and_goldens(name):
    """impl="bsmm": forward, dI and dF of sum(y * E) against jax.grad of the
    JAX conv and against the NumPy goldens; the CPU path launches no
    kernel."""
    pairs, b, TRS, DHW, st, dil = _CONV_CASES[name]
    BCK = _blocks(pairs, b)
    kw = dict(strides=st, dilates=dil, padding="SAME", impl="bsmm")
    ref, port = JaxConv(BCK, TRS, DHW, **kw), BlocksparseConv(BCK, TRS, DHW,
                                                              **kw)
    uses_kernel = port_im2col.im2col_supported(
        port.TRS, port.DHW, port.MPQ, port.strides, port.dilates,
        port.padding, port.C, b)
    assert uses_kernel == (set(st) == set(dil) == {1})
    rng = np.random.RandomState(len(name))
    F = random_jax_conv_filter(ref, seed=len(name)) * 10
    I = rng.uniform(-1, 1, ref.i_shape(2)).astype(np.float32)
    E = rng.uniform(-1, 1, ref.o_shape(2)).astype(np.float32)
    before = (port_im2col.im2col.launches, port_im2col.col2im.launches)
    got = _port_fwd_grads(port, conv_filter_from_jax(F, port, "cpu"),
                          torch.from_numpy(I), E)
    assert (port_im2col.im2col.launches,
            port_im2col.col2im.launches) == before
    for g, r in zip(got, _jax_fwd_grads(ref, F, I, E)):
        _close(g, r, F32_TOL)
    Fl = list(F.reshape([port.blocks, b, b] + port.TRS))
    y, dI, dF = got
    _close(y, ref.fprop_test(Fl, I), F32_TOL)
    _close(dI, ref.bprop_test(Fl, E), F32_TOL)
    _close(dF.reshape(-1), ref.updat_test(E, I), F32_TOL)


def test_conv_bsmm_bf16_matches_jax():
    """bf16 image and filter through the im2col route (16x16)."""
    pairs, b, TRS, DHW, _, _ = _CONV_CASES["im2col-16x16"]
    BCK = _blocks(pairs, b)
    ref = JaxConv(BCK, TRS, DHW, impl="bsmm")
    port = BlocksparseConv(BCK, TRS, DHW, impl="bsmm")
    rng = np.random.RandomState(3)
    F = (random_jax_conv_filter(ref, seed=3) * 10).astype(jnp.bfloat16)
    I = rng.uniform(-1, 1, ref.i_shape(2)).astype(jnp.bfloat16)
    E = rng.uniform(-1, 1, ref.o_shape(2)).astype(np.float32)
    Ft = conv_filter_from_jax(F, port, "cpu")
    assert Ft.dtype == torch.bfloat16
    It = torch.from_numpy(I.astype(np.float32)).bfloat16()
    got = _port_fwd_grads(port, Ft, It, E)
    for g, r in zip(got, _jax_fwd_grads(ref, F, I, E)):
        _close(g, r, BF16_TOL)


@pytest.mark.parametrize("case", ["2d-s1", "1d-s2", "2d-scattered"])
def test_conv_impl_conv_matches_jax(case):
    """impl="conv", the JAX default: grouped convolution and an f32
    index_add_ over output channels (overlapping K sets add up; the last
    case's channel lists are not contiguous)."""
    if case == "2d-s1":
        BCK, TRS, DHW, st = _blocks([(0, 0), (1, 0), (1, 1)], 4), (3, 3), \
            (6, 7), (1, 1)
    elif case == "1d-s2":
        BCK, TRS, DHW, st = _blocks([(0, 1), (1, 1), (2, 0)], 4), (3,), \
            (11,), (2,)
    else:
        BCK = [((0, 1, 2, 3), (0, 1, 2)), ((4, 5, 6, 7), (2, 3, 4)),
               ((0, 2, 4, 6), (3, 4, 5))]
        TRS, DHW, st = (3, 3), (5, 6), (1, 1)
    ref = JaxConv(BCK, TRS, DHW, strides=st)
    port = BlocksparseConv(BCK, TRS, DHW, strides=st)
    assert port.overlapK
    rng = np.random.RandomState(11)
    F = rng.uniform(-1, 1, ref.f_shape()).astype(np.float32)
    I = rng.uniform(-1, 1, ref.i_shape(2)).astype(np.float32)
    E = rng.uniform(-1, 1, ref.o_shape(2)).astype(np.float32)
    got = _port_fwd_grads(port, torch.from_numpy(F), torch.from_numpy(I), E)
    for g, r in zip(got, _jax_fwd_grads(ref, F, I, E)):
        _close(g, r, F32_TOL)


_BAD_BSMM = {
    "not-square": ([((0, 1, 2, 3, 4, 5, 6, 7), tuple(range(16)))], (3,),
                   (10,)),
    "bad-size": (_blocks([(0, 0)], 4), (3,), (10,)),
    "unaligned": ([((0, 2, 4, 6, 8, 10, 12, 14), tuple(range(8)))], (3,),
                  (10,)),
    "duplicate": (_blocks([(0, 0), (0, 0)], 8), (3,), (10,)),
}


@pytest.mark.parametrize("name", sorted(_BAD_BSMM))
def test_build_bsmm_errors_match_jax(name):
    BCK, TRS, DHW = _BAD_BSMM[name]
    with pytest.raises(ValueError) as ref:
        JaxConv(BCK, TRS, DHW, impl="bsmm")
    with pytest.raises(ValueError) as got:
        BlocksparseConv(BCK, TRS, DHW, impl="bsmm")
    assert str(got.value) == str(ref.value)


def test_conv_rejects_unported_options():
    """What the conv still refuses: an unknown impl or bsmm_impl,
    impl="bsmm" on ragged blocks (JAX's ValueError) and a filter of another
    shape.  impl="matmul" and ragged blocks build (their parity:
    tests/test_torch_conv_rest.py)."""
    BCK = _blocks([(0, 0), (1, 1)], 8)
    assert BlocksparseConv(BCK, (3, 3), (8, 8), impl="matmul").impl == \
        "matmul"
    with pytest.raises(ValueError, match="unknown impl"):
        BlocksparseConv(BCK, (3, 3), (8, 8), impl="xla")
    ragged = [((0, 1, 2, 3), (0, 1)), ((4, 5), (2, 3, 4))]
    assert not BlocksparseConv(ragged, (3,), (8,)).fixed_block_size
    with pytest.raises(ValueError, match="fixed square channel blocks"):
        BlocksparseConv(ragged, (3,), (8,), impl="bsmm")
    with pytest.raises(ValueError, match="bsmm_impl"):
        BlocksparseConv(BCK, (3, 3), (8, 8), bsmm_impl="pallas")
    conv = BlocksparseConv(BCK, (3, 3), (8, 8))
    with pytest.raises(ValueError, match="f_shape"):
        conv_filter_from_jax(np.zeros((2, 8, 8, 9), np.float32), conv, "cpu")


def test_shape_and_golden_helpers_match_jax():
    for S in (1, 2, 3, 5):
        for dil in (1, 2):
            assert port_conv.dilation_size(S, dil) == \
                jax_conv.dilation_size(S, dil)
            for pad in range(port_conv.dilation_size(S, dil) // 2 + 1):
                for st in (1, 2, 3):
                    args = (S, 11, pad, st, dil)
                    for fn in ("out_dim", "in_dim"):
                        assert getattr(port_conv, fn)(*args) == \
                            getattr(jax_conv, fn)(*args), (fn, args)
                    # as the goldens call them: output q over an image of
                    # 6, input x over the Q outputs
                    Q = jax_conv.out_dim(S, 6, pad, st, dil)
                    for fn, n, size in (("fprop_lut", Q, 6),
                                        ("fprop_slice", Q, 6),
                                        ("bprop_lut", 6, Q),
                                        ("bprop_slice", 6, Q)):
                        for i in range(n):
                            assert getattr(port_conv, fn)(
                                i, size, S, pad, st, dil) == getattr(
                                    jax_conv, fn)(i, size, S, pad, st,
                                                  dil), (fn, i, args)
    for padding in ("SAME", "VALID", [1], (0, 2), [1, 0, 2]):
        for TRS, dil in (([1, 3, 3], [1, 1, 1]), ([3, 5, 1], [2, 1, 3])):
            assert port_conv.get_padding(padding, TRS, dil) == \
                jax_conv.get_padding(padding, TRS, dil)
    assert port_conv.expand_dims([4, 5]) == jax_conv.expand_dims([4, 5])
