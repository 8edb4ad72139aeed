"""The port's BlocksparseMatMul, forward and backward, against the JAX
package's.

On the CPU the port runs the plain versions (the torch ports of
``xprop_xla`` and ``updat_xla``); they are held against JAX
``impl="xla"``, JAX ``impl="pallas"`` (interpret mode) and the NumPy
goldens ``fprop_test``/``bprop_test``/``updat_test``, and the autograd
gradients against ``jax.vjp`` of the JAX op.  f32 tolerance 1e-5 (both
sides sum the same f32 products, in other orders); bf16 tolerance 1e-2
relative to the output's scale (one bf16 rounding of the output, 2^-8,
plus order; dw is f32 on both sides, from the same bf16 inputs).  The
CUDA kernels are held against the plain versions in test_torch_cuda.py.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from blocksparse_tpu import BlocksparseMatMul as JaxBSMM
from blocksparse_tpu_torch import BlocksparseMatMul
from blocksparse_tpu_torch.kernels import bsmm as bsmm_kernels

torch.set_num_threads(2)
F32_TOL = 1e-5
BF16_TOL = 1e-2


def random_layout(CB, KB, density, seed):
    rng = np.random.RandomState(seed)
    layout = (rng.rand(CB, KB) < density).astype(np.int32)
    layout[np.arange(CB), np.arange(CB) % KB] = 1
    layout[np.arange(KB) % CB, np.arange(KB)] = 1
    return layout


@pytest.mark.parametrize("axis", [1, 0])
@pytest.mark.parametrize("bsize", [8, 16, 32, 64])
def test_fprop_matches_jax(bsize, axis):
    layout = random_layout(4, 6, 0.4, seed=bsize + axis)
    N = 48
    port = BlocksparseMatMul(layout, block_size=bsize, feature_axis=axis)
    rng = np.random.RandomState(bsize)
    X = rng.uniform(-1, 1, port.i_shape(N)).astype(np.float32)
    W = rng.uniform(-1, 1, port.w_shape).astype(np.float32)
    y = port(torch.from_numpy(X), torch.from_numpy(W)).numpy()
    np.testing.assert_allclose(y, port.fprop_test(X, W), rtol=F32_TOL,
                               atol=F32_TOL)
    for impl in ("xla", "pallas"):
        ref = JaxBSMM(layout, block_size=bsize, feature_axis=axis, impl=impl)
        y_ref = np.asarray(ref(jnp.asarray(X), jnp.asarray(W)))
        np.testing.assert_allclose(y, y_ref, rtol=F32_TOL, atol=F32_TOL,
                                   err_msg=impl)


def test_fprop_3d_input_matches_jax():
    """(B, L, C) input is flattened around the feature axis as
    ``_flatten_io`` does, and the output restored to (B, L, K)."""
    layout = random_layout(4, 8, 0.5, seed=3)
    port = BlocksparseMatMul(layout, block_size=16, feature_axis=1)
    ref = JaxBSMM(layout, block_size=16, feature_axis=1, impl="xla")
    rng = np.random.RandomState(1)
    X = rng.uniform(-1, 1, (3, 10, port.C)).astype(np.float32)
    W = rng.uniform(-1, 1, port.w_shape).astype(np.float32)
    y = port(torch.from_numpy(X), torch.from_numpy(W)).numpy()
    y_ref = np.asarray(ref(jnp.asarray(X), jnp.asarray(W)))
    assert y.shape == (3, 10, port.K) == y_ref.shape
    np.testing.assert_allclose(y, y_ref, rtol=F32_TOL, atol=F32_TOL)


def test_fprop_bf16_matches_jax():
    layout = random_layout(4, 8, 0.5, seed=5)
    port = BlocksparseMatMul(layout, block_size=32, feature_axis=1)
    ref = JaxBSMM(layout, block_size=32, feature_axis=1, impl="xla")
    rng = np.random.RandomState(2)
    X = rng.uniform(-1, 1, (40, port.C)).astype(np.float32)
    W = rng.uniform(-1, 1, port.w_shape).astype(np.float32)
    y = port(torch.from_numpy(X).bfloat16(), torch.from_numpy(W).bfloat16())
    assert y.dtype == torch.bfloat16
    y_ref = np.asarray(ref(jnp.asarray(X, jnp.bfloat16),
                           jnp.asarray(W, jnp.bfloat16)).astype(jnp.float32))
    scale = np.abs(y_ref).max()
    np.testing.assert_allclose(y.float().numpy(), y_ref, rtol=0,
                               atol=BF16_TOL * scale)


def test_empty_output_block_column_is_zero():
    layout = np.zeros((3, 4), np.int32)
    layout[0, 0] = layout[2, 1] = layout[1, 3] = 1      # column 2 empty
    port = BlocksparseMatMul(layout, block_size=8, feature_axis=1)
    X = torch.ones((5, port.C))
    W = torch.ones(port.w_shape)
    y = port(X, W)
    assert (y[:, 16:24] == 0).all() and (y[:, :8] == 8).all()


def test_rejects_what_it_does_not_take():
    layout = random_layout(2, 2, 1.0, seed=0)
    packed = BlocksparseMatMul(layout, block_size=8, w_layout="fprop_packed")
    assert packed.w_shape == tuple(JaxBSMM(layout, block_size=8,
                                           w_layout="fprop_packed").w_shape)
    with pytest.raises(ValueError):
        BlocksparseMatMul(layout, block_size=8, w_layout="panels")
    port = BlocksparseMatMul(layout, block_size=8, feature_axis=1)
    ones = (torch.ones(4, port.C), torch.ones(port.w_shape))
    assert torch.equal(port(*ones, gate=np.ones(port.blocks)),  # gates run
                       port(*ones))
    with pytest.raises(ValueError):           # a CPU tensor launches nothing
        bsmm_kernels.bsmm_bprop(torch.ones(4, 16), torch.ones(port.w_shape),
                                None, None, None, 8, 2)
    with pytest.raises(ValueError):
        bsmm_kernels.bsmm_updat(torch.ones(4, 16), torch.ones(4, 16), None,
                                None, 8)
    with pytest.raises(ValueError):
        port(torch.ones(4, port.C + 8), torch.ones(port.w_shape))
    with pytest.raises(ValueError):
        bsmm_kernels.bsmm_fprop(torch.ones(4, 16), torch.ones(port.w_shape),
                                None, None, None, 8, 2)
    # TPU schedule knobs change nothing
    x, w = torch.randn(6, port.C), torch.randn(port.w_shape)
    y = port(x, w)
    for kw in (dict(mode="dense_tile"), dict(tile_n=128),
               dict(dense_tile_R=2)):
        other = BlocksparseMatMul(layout, block_size=8, feature_axis=1, **kw)
        torch.testing.assert_close(other(x, w), y, rtol=0, atol=0)


def _pair(layout, bsize, axis, impl):
    return (JaxBSMM(layout, block_size=bsize, feature_axis=axis, impl=impl),
            BlocksparseMatMul(layout, block_size=bsize, feature_axis=axis))


@pytest.mark.parametrize("axis", [1, 0])
@pytest.mark.parametrize("bsize", [8, 16, 32, 64])
def test_bprop_and_updat_match_jax(bsize, axis):
    layout = random_layout(5, 4, 0.4, seed=bsize + 7 * axis)
    N = 40
    port = BlocksparseMatMul(layout, block_size=bsize, feature_axis=axis)
    rng = np.random.RandomState(bsize + axis)
    X = rng.uniform(-1, 1, port.i_shape(N)).astype(np.float32)
    E = rng.uniform(-1, 1, port.o_shape(N)).astype(np.float32)
    W = rng.uniform(-1, 1, port.w_shape).astype(np.float32)
    Xt, Et, Wt = (torch.from_numpy(a) for a in (X, E, W))
    dx = port._xprop(Et, Wt, "b").numpy()
    dw = port._updat(Xt, Et).numpy()
    assert dw.dtype == np.float32 and dw.shape == port.w_shape
    np.testing.assert_allclose(dx, port.bprop_test(E, W), rtol=F32_TOL,
                               atol=F32_TOL)
    np.testing.assert_allclose(dw, port.updat_test(X, E), rtol=F32_TOL,
                               atol=F32_TOL)
    for impl in ("xla", "pallas"):
        ref = JaxBSMM(layout, block_size=bsize, feature_axis=axis, impl=impl)
        np.testing.assert_allclose(port.bprop_test(E, W),
                                   ref.bprop_test(E, W), rtol=0, atol=0)
        np.testing.assert_allclose(
            dx, np.asarray(ref._bprop_impl(jnp.asarray(E), jnp.asarray(W))),
            rtol=F32_TOL, atol=F32_TOL, err_msg=impl)
        np.testing.assert_allclose(
            dw, np.asarray(ref._updat_impl(jnp.asarray(X), jnp.asarray(E))),
            rtol=F32_TOL, atol=F32_TOL, err_msg=impl)


@pytest.mark.parametrize("axis", [1, 0])
def test_bprop_and_updat_bf16_match_jax(axis):
    layout = random_layout(4, 6, 0.5, seed=9)
    port = BlocksparseMatMul(layout, block_size=32, feature_axis=axis)
    ref = JaxBSMM(layout, block_size=32, feature_axis=axis, impl="xla")
    rng = np.random.RandomState(3)
    X = rng.uniform(-1, 1, port.i_shape(24)).astype(np.float32)
    E = rng.uniform(-1, 1, port.o_shape(24)).astype(np.float32)
    W = rng.uniform(-1, 1, port.w_shape).astype(np.float32)
    bf = torch.bfloat16
    dx = port._xprop(torch.from_numpy(E).to(bf), torch.from_numpy(W).to(bf),
                     "b")
    dw = port._updat(torch.from_numpy(X).to(bf), torch.from_numpy(E).to(bf))
    assert dx.dtype == bf and dw.dtype == torch.float32
    jb = jnp.bfloat16
    dx_ref = np.asarray(ref._bprop_impl(jnp.asarray(E, jb),
                                        jnp.asarray(W, jb)).astype(jnp.float32))
    dw_ref = np.asarray(ref._updat_impl(jnp.asarray(X, jb), jnp.asarray(E, jb)))
    np.testing.assert_allclose(dx.float().numpy(), dx_ref, rtol=0,
                               atol=BF16_TOL * np.abs(dx_ref).max())
    np.testing.assert_allclose(dw.numpy(), dw_ref, rtol=0,
                               atol=BF16_TOL * np.abs(dw_ref).max())


@pytest.mark.parametrize("axis,dtype", [(1, "float32"), (0, "float32"),
                                        (1, "bfloat16")])
def test_autograd_matches_jax_vjp(axis, dtype):
    """dI and dW of ``BlocksparseMatMul.__call__`` through autograd against
    jax.vjp of the JAX op, on a 3-D input (axis 1) or (C, B, L) (axis 0);
    dW comes back in W's dtype as in the JAX ``_bsmm``."""
    layout = random_layout(4, 5, 0.5, seed=2 + axis)
    ref, port = _pair(layout, 16, axis, "xla")
    rng = np.random.RandomState(4)
    shape = (3, 7, port.C) if axis else (port.C, 3, 7)
    oshape = (3, 7, port.K) if axis else (port.K, 3, 7)
    X = rng.uniform(-1, 1, shape).astype(np.float32)
    W = rng.uniform(-1, 1, port.w_shape).astype(np.float32)
    G = rng.uniform(-1, 1, oshape).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    y_ref, vjp = jax.vjp(ref, jnp.asarray(X, jd), jnp.asarray(W, jd))
    dx_ref, dw_ref = (np.asarray(a.astype(jnp.float32))
                      for a in vjp(jnp.asarray(G, jd)))
    x = torch.from_numpy(X).to(td).requires_grad_()
    w = torch.from_numpy(W).to(td).requires_grad_()
    y = port(x, w)
    y.backward(torch.from_numpy(G).to(td))
    assert x.grad.dtype == td and w.grad.dtype == td
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    for got, want in ((y.detach(), np.asarray(y_ref.astype(jnp.float32))),
                      (x.grad, dx_ref), (w.grad, dw_ref)):
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                                   atol=tol * max(1.0, np.abs(want).max()))


def test_empty_input_block_row_gets_zero_gradient():
    """An input block-row with no layout block has no bprop entries: its
    dx is zero, and every dw block still equals x_cᵀ·dy_k."""
    layout = np.zeros((3, 2), np.int32)
    layout[0, 0] = layout[2, 1] = layout[0, 1] = 1          # row 1 empty
    port = BlocksparseMatMul(layout, block_size=8, feature_axis=1)
    x = torch.randn(5, port.C, requires_grad=True)
    w = torch.randn(port.w_shape, requires_grad=True)
    port(x, w).square().sum().backward()
    assert (x.grad[:, 8:16] == 0).all() and (x.grad[:, :8] != 0).any()
    X, W = x.detach().numpy(), w.detach().numpy()
    E = 2 * port.fprop_test(X, W)
    np.testing.assert_allclose(w.grad.numpy(), port.updat_test(X, E),
                               rtol=1e-5, atol=1e-5)
