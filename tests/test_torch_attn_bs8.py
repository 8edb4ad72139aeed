"""The attention kernels' route at block size 8, on the CPU, against JAX.

``BlocksparseTransformer.attention`` runs block size 8 through the
kernels' view of the layout at block size 16 (``bst_attn.kernel_view``;
see test_torch_attn_view.py).  Here that route, on its way to the
kernels' plain versions as on the card to the kernels, is held against
the JAX package's fused attention at bs 8 (Pallas in interpret mode):
the forward, the training forward's lse and the gradients, on the fixed
and strided layouts with the causal sub-block mask, at ctx 40 (an odd
number of 8-blocks, so the view pads one hidden 8-row) and 64, at head
sizes 16 and 48 (padded to 64); and a fully masked query row (F1), whose
output and dq are zero, its lse -inf.  f32 tolerance 1e-5: the same f32
softmax, summed in other orders.
"""
import numpy as np
import pytest

from blocksparse_tpu.models.sparse_transformer import causal_subblock_mask
from test_torch_attn_view import (F32_TOL, NAMES, _arrays, _pair,
                                  check_route, jax_all, port_all)


@pytest.mark.parametrize("ctx,heads,hs,kind", [
    (40, 2, 16, "fixed"), (64, 2, 16, "strided"), (40, 2, 48, "strided")])
def test_block_size_8_matches_jax_fused(ctx, heads, hs, kind):
    check_route(ctx, 8, heads, hs, kind)


def _f1_mask(blk_shape, head, qry, key, blk):
    """Causal diagonal, except that query row 3 of block-row 1 sees no
    key at all."""
    mask = causal_subblock_mask(blk_shape, head, qry, key, blk)
    if qry == 1:
        mask[3, :] = False
    return mask


def test_fully_masked_row_at_block_size_8():
    """F1 at bs 8 through the view: the dead row's out and dq are zero,
    its lse -inf, and it adds nothing to dk/dv; with its dO zeroed every
    other value matches JAX."""
    bs, heads, blks, hs = 8, 2, 5, 48
    layout = np.tril(np.ones((blks, blks), np.int32))
    ref, port = _pair(layout, bs, heads, mask_callback=_f1_mask)
    Q, K, V, dO = _arrays(4, (1, blks * bs, heads * hs), seed=31)
    dead = 1 * bs + 3
    got = port_all(port, Q, K, V, dO, 0.25)
    out, lse, dq = got[:3]
    assert (out[:, dead] == 0).all() and (dq[:, dead] == 0).all()
    assert np.isneginf(lse[:, :, dead]).all()
    assert all(np.isfinite(a).all() for a in (out, dq, got[3], got[4]))
    dO[:, dead] = 0
    got0 = port_all(port, Q, K, V, dO, 0.25)
    np.testing.assert_array_equal(got0[3], got[3])   # dk: the row adds nothing
    np.testing.assert_array_equal(got0[4], got[4])
    want = jax_all(ref, Q, K, V, dO, heads, bs, 0.25)
    live = np.arange(Q.shape[1]) != dead
    for name, g, w in zip(NAMES, got0, want):
        if name in ("out", "dq"):
            g, w = g[:, live], w[:, live]
        elif name == "lse":
            g, w = g[:, :, live], w[:, :, live]
        np.testing.assert_allclose(g, w, rtol=F32_TOL, atol=F32_TOL,
                                   err_msg=name)
