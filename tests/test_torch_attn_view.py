"""The attention kernels' view of every size the reference fuses, on the CPU.

The kernels are built for block sizes 16-64 and head sizes 16, 32, 64 and
128.  ``BlocksparseTransformer.attention`` runs block size 8 through a
view of the layout at block size 16 (``bst_attn.kernel_view``: a block
present where any of its four 8 x 8 sub-blocks is, its mask their union,
an odd context padded by one hidden 8-row) and any head size up to 128
zero-padded to the next size the kernels take
(``bst_attn.kernel_head_size``).  Both are pure functions of the layout
and the inputs, and the CPU runs them on the way to the kernels' plain
versions, as the card runs them on the way to the kernels.

These tests hold the view's tables to the layout (the same visible
elements, from bs 16 up the op's own tables), pin ``kernel_head_size``,
and hold the route at head sizes 8, 48 and 96 against the JAX package's
fused attention (Pallas in interpret mode): the forward, the training
forward's lse (``fused_attention_fwd_lse``) and the gradients
(``jax.vjp``).  test_torch_attn_bs8.py does the same at bs 8.  f32
tolerance 1e-5, as in test_torch_attention.py: the same f32 softmax,
summed in other orders.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from blocksparse_tpu import BlocksparseTransformer as JaxBST
from blocksparse_tpu.kernels import bst_attn as jax_bst_attn
from blocksparse_tpu.models.sparse_transformer import (
    causal_subblock_mask, fixed_layout, strided_layout)

from blocksparse_tpu_torch import BlocksparseTransformer
from blocksparse_tpu_torch.kernels import bst_attn, bst_trio

torch.set_num_threads(2)
F32_TOL = 1e-5


def _pair(layout, bs, heads, mask_callback=causal_subblock_mask):
    return (JaxBST(layout, block_size=bs, heads=heads,
                   mask_callback=mask_callback),
            BlocksparseTransformer(layout, block_size=bs, heads=heads,
                                   mask_callback=mask_callback))


def _arrays(n, shape, seed):
    rng = np.random.RandomState(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]


def _layout(kind, blks):
    if kind == "strided":
        return strided_layout(blks, local_blocks=2)
    return fixed_layout(blks, local_blocks=2)


def _dense_mask(nt_lists, masks, bs, rows, cols):
    """(lut_heads, rows·bs, cols·bs) bool: the elements each head's
    layout and masks let a query see."""
    out = np.zeros((len(nt_lists), rows * bs, cols * bs), bool)
    for h, nt in enumerate(nt_lists):
        for b, (q, k) in enumerate(nt):
            out[h, q * bs:(q + 1) * bs, k * bs:(k + 1) * bs] = (
                True if masks is None else masks[h][b])
    return out


@pytest.mark.parametrize("blks", [5, 8])
@pytest.mark.parametrize("masked", [True, False])
def test_kernel_view_sees_the_same_elements(blks, masked):
    """At bs 8 the view is at bs 16, holds exactly the elements the layout
    and its masks let a query see, hides the padded row and column of an
    odd ctx_blks, and takes a 16-block only where a sub-block is
    present; per-head layouts may give the heads different counts."""
    lay = fixed_layout(blks, local_blocks=2)
    layout = np.stack([lay, lay.T])
    cb = causal_subblock_mask if masked else None
    port = BlocksparseTransformer(layout, block_size=8, mask_callback=cb)
    masks = None if not masked else list(port._mask_blocks)
    nt, vmasks, kbs, cq, ck = bst_attn.kernel_view(
        port.nt_list, port._mask_blocks, 8, blks, blks)
    assert kbs == 16 and cq == ck == -(-blks // 2)
    want = _dense_mask(port.nt_list, masks, 8, blks, blks)
    got = _dense_mask(nt, vmasks, 16, cq, ck)
    np.testing.assert_array_equal(got[:, :8 * blks, :8 * blks], want)
    assert not got[:, 8 * blks:].any() and not got[:, :, 8 * blks:].any()
    for h in range(2):
        present = {(q // 2, k // 2) for q, k in port.nt_list[h]}
        assert nt[h] == sorted(present)
    # two heads whose views differ in block count: one 16-block against two
    ragged = np.zeros((2, 3, 3), np.int32)
    ragged[0, 0, :2] = ragged[1, [0, 2], 0] = 1
    port = BlocksparseTransformer(ragged, block_size=8, mask_callback=cb)
    nt, vmasks, _, cq, ck = bst_attn.kernel_view(
        port.nt_list, port._mask_blocks, 8, 3, 3)
    assert nt == [[(0, 0)], [(0, 0), (1, 0)]]
    tab = port._tables(torch.device("cpu"))
    assert tab["kq_blk"].tolist() == [[0, 0], [0, 1]]
    assert not tab["kmask"][0, 1].any()         # the filler adds nothing
    # larger block sizes pass through unchanged
    port16 = BlocksparseTransformer(lay, block_size=16, heads=2,
                                    mask_callback=cb)
    nt16, m16, kbs16, cq16, _ = bst_attn.kernel_view(
        port16.nt_list, port16._mask_blocks, 16, blks, blks)
    assert (kbs16, cq16, nt16) == (16, blks, port16.nt_list)
    assert (m16 is None) == (not masked)


def test_kernel_tables_equal_the_layouts_own_from_block_size_16():
    """From bs 16 up the view is the layout: its CSRs and codes are the
    op's own nn/tn lists and ``mask_codes``."""
    port = BlocksparseTransformer(fixed_layout(6, local_blocks=2),
                                  block_size=32, heads=2,
                                  mask_callback=causal_subblock_mask)
    tab = port._tables(torch.device("cpu"))
    codes, uniq = port.mask_codes()
    codes_t, uniq_t = port.mask_codes(transposed=True)
    for name, want in zip(
            ("row_ptr", "ent_k", "ent_code"),
            bst_attn.build_attn_csr(port.nn_list, codes)):
        np.testing.assert_array_equal(tab[name].numpy(), want)
    for name, want in zip(
            ("row_ptr_t", "ent_q", "ent_code_t"),
            bst_attn.build_attn_csr(port.tn_list, codes_t)):
        np.testing.assert_array_equal(tab[name].numpy(), want)
    np.testing.assert_array_equal(tab["uniq"].numpy(), uniq)
    np.testing.assert_array_equal(tab["uniq_t"].numpy(), uniq_t)
    assert tab["kbs"] == 32 and tab["kctx_q"] == tab["kctx_k"] == 192
    for a, b in (("kq_blk", "q_blk"), ("kk_blk", "k_blk"), ("kmask", "mask")):
        assert torch.equal(tab[a], tab[b])


def test_kernel_head_size():
    got = [bst_attn.kernel_head_size(hs)
           for hs in (1, 8, 16, 17, 24, 32, 48, 64, 80, 96, 128)]
    assert got == [16, 16, 16, 32, 32, 32, 64, 64, 128, 128, 128]
    with pytest.raises(NotImplementedError, match="unfused"):
        bst_attn.kernel_head_size(129)


def test_head_size_past_128_takes_the_plain_versions_on_the_cpu():
    """Past hs 128 the op takes the unfused ops, as the reference does:
    on the CPU their plain versions (nt, the blocked masked softmax, nn);
    the fused route, pinned with use_fused=True, takes its plain version
    at the op's own block size."""
    port = BlocksparseTransformer(fixed_layout(2, local_blocks=2),
                                  block_size=16, heads=1,
                                  mask_callback=causal_subblock_mask)
    q, k, v = (torch.from_numpy(a) for a in _arrays(3, (1, 32, 136), 5))
    tab = port._tables(torch.device("cpu"))
    w = bst_trio.bst_nt_plain(q, k, tab["q_blk"], tab["k_blk"], 1, 16)
    want = bst_trio.bst_xn_plain(port.masked_softmax(w, scale=0.1), v,
                                 tab["q_blk"], tab["k_blk"], 2, 1, 16, False)
    assert torch.equal(port.attention(q, k, v, scale=0.1), want)
    fused = bst_attn.attention_fwd_plain(q, k, v, tab["q_blk"], tab["k_blk"],
                                         tab["mask"], 1, 16, 0.1)
    assert torch.equal(port.attention(q, k, v, scale=0.1, use_fused=True),
                       fused)


def _to_flat(a, heads, bs):
    batch, ctx, state = a.shape
    hs = state // heads
    return a.reshape(batch, ctx // bs, bs, heads, hs).transpose(
        0, 3, 1, 2, 4).reshape(batch * heads, ctx, hs)


def port_all(port, Q, K, V, dO, scale):
    """out, lse (the training forward's), dq, dk, dv through the kernels'
    route on the CPU."""
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in (Q, K, V))
    _, lse = port._kernel_fwd(q.detach(), k.detach(), v.detach(), scale,
                              with_lse=True)
    out = port.attention(q, k, v, scale=scale)
    out.backward(torch.from_numpy(dO))
    return ([out.detach().numpy(), lse.numpy()]
            + [t.grad.numpy() for t in (q, k, v)])


def jax_all(ref, Q, K, V, dO, heads, bs, scale):
    """out, lse, dq, dk, dv of the JAX fused attention (interpret mode)."""
    _, lse = jax_bst_attn.fused_attention_fwd_lse(
        *(jnp.asarray(_to_flat(a, heads, bs)) for a in (Q, K, V)),
        ref.attn_schedule, heads, scale)
    y, vjp = jax.vjp(lambda a, b, c: ref.attention(a, b, c, scale=scale,
                                                   use_fused=True),
                     *(jnp.asarray(a) for a in (Q, K, V)))
    return ([np.asarray(y), np.asarray(lse).reshape(Q.shape[0], heads, -1)]
            + [np.asarray(g) for g in vjp(jnp.asarray(dO))])


NAMES = ("out", "lse", "dq", "dk", "dv")


@pytest.mark.parametrize("ctx,bs,heads,hs,kind", [
    (64, 16, 2, 8, "fixed"), (64, 16, 2, 48, "strided"),
    (64, 32, 1, 96, "fixed")])
def test_padded_head_sizes_match_jax_fused(ctx, bs, heads, hs, kind):
    """Forward, lse and gradients at hs 8, 48 and 96, zero-padded to 16,
    64 and 128, against JAX's fused attention (bs 8 in
    test_torch_attn_bs8.py)."""
    check_route(ctx, bs, heads, hs, kind)


def check_route(ctx, bs, heads, hs, kind):
    """The kernels' route (view and padding) against JAX's fused attention:
    out, lse, dq, dk, dv within F32_TOL."""
    layout = _layout(kind, ctx // bs)
    ref, port = _pair(layout, bs, heads)
    Q, K, V, dO = _arrays(4, (1, ctx, heads * hs), seed=ctx + bs + hs)
    scale = 1.0 / np.sqrt(hs)
    tab = port._tables(torch.device("cpu"))
    assert tab["kbs"] == max(bs, 16) and tab["kctx_q"] % tab["kbs"] == 0
    got = port_all(port, Q, K, V, dO, scale)
    want = jax_all(ref, Q, K, V, dO, heads, bs, scale)
    for name, g, w in zip(NAMES, got, want):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, rtol=F32_TOL, atol=F32_TOL,
                                   err_msg=name)
