"""The port's plain ops against the JAX package's: layer norm (both
feature axes, segments, relu), swish / fast-gelu, the cast and the
embedding lookup, and their gradients (autograd against ``jax.vjp``, and
layer norm's against the NumPy golden ``layer_norm_grad_test``).  f32
tolerance 1e-5 (the same f32 arithmetic in other orders); the bf16 cast
is exact.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from blocksparse_tpu.ops import ewops as jax_ewops
from blocksparse_tpu.ops.embed import embedding_lookup as jax_embedding_lookup
from blocksparse_tpu.ops.norms import layer_norm as jax_layer_norm
from blocksparse_tpu.ops.norms import layer_norm_grad_test

from blocksparse_tpu_torch import (embedding_lookup, fast_gelu, float_cast,
                                   layer_norm, swish)

torch.set_num_threads(2)
TOL = 1e-5


@pytest.mark.parametrize("axis,segments,relu", [
    (-1, 1, False), (1, 4, False), (0, 1, False), (0, 2, True)])
def test_layer_norm_matches_jax(axis, segments, relu):
    rng = np.random.RandomState(segments)
    shape = (32, 6) if axis == 0 else (3, 5, 32)
    x = (rng.standard_normal(shape) * 3 + 1).astype(np.float32)
    g = rng.standard_normal(32).astype(np.float32)
    b = rng.standard_normal(32).astype(np.float32)
    ref = np.asarray(jax_layer_norm(jnp.asarray(x), jnp.asarray(g),
                                    jnp.asarray(b), axis=axis,
                                    segments=segments, relu=relu))
    got = layer_norm(torch.from_numpy(x), torch.from_numpy(g),
                     torch.from_numpy(b), axis=axis, segments=segments,
                     relu=relu)
    np.testing.assert_allclose(got.numpy(), ref, rtol=TOL, atol=TOL)


def test_elementwise_and_cast_match_jax():
    x = np.random.RandomState(0).standard_normal((7, 33)).astype(np.float32)
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    np.testing.assert_allclose(fast_gelu(xt).numpy(),
                               np.asarray(jax_ewops.fast_gelu(xj)),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(swish(xt, alpha=0.5).numpy(),
                               np.asarray(jax_ewops.swish(xj, alpha=0.5)),
                               rtol=TOL, atol=TOL)
    cast = float_cast(xt, torch.bfloat16)
    ref = np.asarray(jax_ewops.float_cast(xj, jnp.bfloat16)
                     .astype(jnp.float32))
    np.testing.assert_array_equal(cast.float().numpy(), ref)
    assert float_cast(xt, torch.float32) is xt
    with pytest.raises(ValueError):
        float_cast(xt, torch.int32)


def test_embedding_lookup_matches_jax():
    rng = np.random.RandomState(1)
    emb = rng.standard_normal((50, 12)).astype(np.float32)
    idx = rng.randint(0, 50, (4, 9)).astype(np.int32)
    ref = np.asarray(jax_embedding_lookup(jnp.asarray(emb), jnp.asarray(idx)))
    got = embedding_lookup(torch.from_numpy(emb), torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("axis,segments,relu", [
    (-1, 1, False), (1, 4, True), (0, 2, False)])
def test_layer_norm_grads_match_jax(axis, segments, relu):
    rng = np.random.RandomState(7 + segments)
    shape = (32, 6) if axis == 0 else (3, 5, 32)
    x = (rng.standard_normal(shape) * 3 + 1).astype(np.float32)
    g = rng.standard_normal(32).astype(np.float32)
    b = rng.standard_normal(32).astype(np.float32)
    dy = rng.standard_normal(shape).astype(np.float32)
    _, vjp = jax.vjp(lambda x, g, b: jax_layer_norm(
        x, g, b, axis=axis, segments=segments, relu=relu),
        jnp.asarray(x), jnp.asarray(g), jnp.asarray(b))
    ref = [np.asarray(a) for a in vjp(jnp.asarray(dy))]
    xt, gt, bt = (torch.from_numpy(a).requires_grad_() for a in (x, g, b))
    layer_norm(xt, gt, bt, axis=axis, segments=segments,
               relu=relu).backward(torch.from_numpy(dy))
    for got, want in zip((xt.grad, gt.grad, bt.grad), ref):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    gold = layer_norm_grad_test(dy, x, g, b, axis=-1 if axis else 0,
                                segments=segments, relu=relu)
    for got, want in zip((xt.grad, gt.grad, bt.grad), gold):
        np.testing.assert_allclose(got.numpy(), np.reshape(want, got.shape),
                                   rtol=1e-4, atol=1e-4)


def test_cast_and_embedding_grads_match_jax():
    rng = np.random.RandomState(3)
    x = rng.standard_normal((6, 10)).astype(np.float32)
    dy = rng.standard_normal((6, 10)).astype(np.float32)
    for dx_dtype in (None, torch.bfloat16):
        xt = torch.from_numpy(x).requires_grad_()
        float_cast(xt, torch.bfloat16, dx_dtype=dx_dtype).backward(
            torch.from_numpy(dy).bfloat16())
        assert xt.grad.dtype == torch.float32     # leaf grads take x's dtype
        _, vjp = jax.vjp(lambda a: jax_ewops.float_cast(
            a, jnp.bfloat16,
            dx_dtype=None if dx_dtype is None else jnp.bfloat16),
            jnp.asarray(x))
        ref, = vjp(jnp.asarray(dy, jnp.bfloat16))
        np.testing.assert_array_equal(xt.grad.numpy(),
                                      np.asarray(ref.astype(jnp.float32)))
    emb = rng.standard_normal((50, 12)).astype(np.float32)
    idx = rng.randint(0, 50, (4, 9)).astype(np.int32)
    dy = rng.standard_normal((4, 9, 12)).astype(np.float32)
    _, vjp = jax.vjp(lambda e: jax_embedding_lookup(e, jnp.asarray(idx)),
                     jnp.asarray(emb))
    ref, = vjp(jnp.asarray(dy))
    et = torch.from_numpy(emb).requires_grad_()
    embedding_lookup(et, torch.from_numpy(idx)).backward(torch.from_numpy(dy))
    np.testing.assert_allclose(et.grad.numpy(), np.asarray(ref), rtol=TOL,
                               atol=TOL)
