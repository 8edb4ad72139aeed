"""The tensor-core attention forward's recurrence, on the CPU.

``csrc/bst_attn_fwd_mma.cu`` walks each query block-row's CSR entry by
entry: the running max moves once an entry, alpha = exp(m - m') rescales
l and the accumulator, l sums the unrounded p, P is rounded to the input
type before P·v, and lse = m + log l (the max kept in base-2 units, as
the kernel keeps it).  ``_replay`` is that recurrence in torch, block by
block, over the port's own tables (the CSR, mask codes and unique blocks
of ``BlocksparseTransformer._tables``).  It is held against the JAX
package's ``fused_attention_fwd_lse``, run as the JAX package's own tests
run it on the CPU (Pallas interpret), and against the port's plain
version, ``attention_fwd_lse_plain``.

The layouts carry a fully masked query row (F1): the replay gives it
zeros and lse -inf, as the kernel does; the JAX kernel gives such a row a
schedule-dependent value, so the comparison with JAX leaves that row out.

Tolerances: f32 1e-5 (the same f32 softmax, summed in other orders);
bf16 out 2e-2 of max(1, max|ref|), as on the card (P is rounded to bf16
against another running max on each side: the JAX kernel moves its max
once a step of several entries, the plain version once a row), lse 1e-4
absolute (f32, from the unrounded p on every side).
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from blocksparse_tpu import BlocksparseTransformer as JaxBST
from blocksparse_tpu.kernels import bst_attn as jax_bst_attn

from blocksparse_tpu_torch import BlocksparseTransformer
from blocksparse_tpu_torch.kernels import bst_attn
from blocksparse_tpu_torch.models.sparse_transformer import (
    causal_subblock_mask, fixed_layout)

torch.set_num_threads(2)
LOG2E, LN2 = 1.4426950408889634, 0.6931471805599453
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
LSE_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-4}
JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _f1_mask(blk_shape, head, qry, key, blk):
    """Causal diagonal, except that query row 3 of block-row 1 sees no
    key at all."""
    mask = causal_subblock_mask(blk_shape, head, qry, key, blk)
    if qry == 1:
        mask[3, :] = False
    return mask


def _visible(code, uniq, bs):
    """The (bs, bs) bool mask of an entry's code (``visible`` in
    ``csrc/bst_attn.cuh``)."""
    tril = torch.ones((bs, bs), dtype=torch.bool).tril()
    if code == bst_attn.MASK_FULL:
        return torch.ones((bs, bs), dtype=torch.bool)
    if code == bst_attn.MASK_TRIL:
        return tril
    if code == bst_attn.MASK_TRIU:
        return tril.T
    u = code - bst_attn.MASK_UNIQ0
    return uniq[u * bs:(u + 1) * bs] != 0


def _replay(q, k, v, tab, heads, bs, scale):
    """The kernel's recurrence, entry by entry of each query block-row:
    (out in q's dtype, lse f32 (batch, heads, ctx_q))."""
    batch, ctx_q, state = q.shape
    hs, rows = state // heads, ctx_q // bs
    row_ptr, ent_k, ent_code = (tab[n].tolist()
                                for n in ("row_ptr", "ent_k", "ent_code"))
    lut_heads = len(row_ptr) // (rows + 1)
    c = abs(scale) * LOG2E
    out = torch.zeros_like(q)
    lse = torch.empty((batch, heads, ctx_q))

    def block(a, r, h):
        return a[:, r * bs:(r + 1) * bs, h * hs:(h + 1) * hs].float()
    for h in range(heads):
        rp = row_ptr[(0 if lut_heads == 1 else h) * (rows + 1):]
        for r in range(rows):
            qb = block(q, r, h)
            m = torch.full((batch, bs), float("-inf"))
            l = torch.zeros((batch, bs))
            acc = torch.zeros((batch, bs, hs))
            for e in range(rp[r], rp[r + 1]):
                s = qb @ block(k, ent_k[e], h).transpose(1, 2)
                s = s.masked_fill(~_visible(ent_code[e], tab["uniq"], bs),
                                  float("-inf"))
                m_new = torch.maximum(m, s.amax(-1) * c)
                z = torch.where(m_new == float("-inf"), 0.0, m_new)
                alpha = torch.exp2(m - z)
                p = torch.exp2(s * c - z[..., None])       # unrounded
                l = l * alpha + p.sum(-1)
                acc = acc * alpha[..., None] + \
                    p.to(q.dtype).float() @ block(v, ent_k[e], h)
                m = m_new
            live = l > 0
            inv = torch.where(live, 1.0 / l.clamp_min(1e-30), 0.0)
            out[:, r * bs:(r + 1) * bs, h * hs:(h + 1) * hs] = \
                (acc * inv[..., None]).to(q.dtype)
            lse[:, h, r * bs:(r + 1) * bs] = torch.where(
                live, m * LN2 + torch.log(l.clamp_min(1e-30)), float("-inf"))
    return out, lse


def _to_flat(a, heads, bs):
    batch, ctx, state = a.shape
    hs = state // heads
    return a.reshape(batch, ctx // bs, bs, heads, hs).transpose(
        0, 3, 1, 2, 4).reshape(batch * heads, ctx, hs)


def _close(got, want, tol, what):
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale,
                               err_msg=what)


@pytest.mark.parametrize("bs", [64, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_replay_matches_jax_fwd_lse(dtype, bs):
    """ctx 256, a fixed layout with the causal sub-block mask and an F1
    row: the replay's out and lse against JAX ``fused_attention_fwd_lse``
    (the F1 row left out) and against the port's plain version (all
    rows); the F1 row is zero with lse -inf."""
    ctx, heads, hs, batch = 256, 2, 32, 2
    layout = fixed_layout(ctx // bs, local_blocks=2)
    ref = JaxBST(layout, block_size=bs, heads=heads, mask_callback=_f1_mask)
    port = BlocksparseTransformer(layout, block_size=bs, heads=heads,
                                  mask_callback=_f1_mask)
    rng = np.random.RandomState(bs)
    Q, K, V = (rng.standard_normal((batch, ctx, heads * hs)).astype(
        np.float32) for _ in range(3))
    scale = 1.0 / np.sqrt(hs)
    q, k, v = (torch.from_numpy(a).to(dtype) for a in (Q, K, V))
    tab = port._tables(torch.device("cpu"))
    out, lse = _replay(q, k, v, tab, heads, bs, scale)

    dead = bs + 3
    assert (out[:, dead] == 0).all()
    assert torch.isneginf(lse[:, :, dead]).all()
    live = torch.ones(ctx, dtype=torch.bool)
    live[dead] = False
    assert torch.isfinite(lse[:, :, live]).all()

    yf, lse_f = jax_bst_attn.fused_attention_fwd_lse(
        *(jnp.asarray(_to_flat(a, heads, bs)).astype(JNP[dtype])
          for a in (Q, K, V)), ref.attn_schedule, heads, scale)
    want = np.asarray(yf.astype(jnp.float32)).reshape(batch, heads, ctx, hs)
    got = _to_flat(out.float().numpy(), heads, bs).reshape(want.shape)
    _close(got[:, :, live], want[:, :, live], TOL[dtype], "out vs JAX")
    lse_want = np.asarray(lse_f).reshape(batch, heads, ctx)
    np.testing.assert_allclose(lse[:, :, live].numpy(),
                               lse_want[:, :, live.numpy()], rtol=0,
                               atol=LSE_TOL[dtype], err_msg="lse vs JAX")

    out_p, lse_p = bst_attn.attention_fwd_lse_plain(
        q, k, v, tab["q_blk"], tab["k_blk"], tab["mask"], heads, bs, scale)
    _close(out.float().numpy(), out_p.float().numpy(), TOL[dtype],
           "out vs plain")
    assert torch.equal(torch.isneginf(lse), torch.isneginf(lse_p))
    np.testing.assert_allclose(lse[:, :, live].numpy(),
                               lse_p[:, :, live].numpy(), rtol=0,
                               atol=LSE_TOL[dtype], err_msg="lse vs plain")


def test_forward_launch_order_on_the_lm_layout():
    """The LM's layout (fixed, 32 block-rows, 8 local blocks, bs 64): the
    query rows hold 1-8 entries (rows 0-7), then 9-14 in fours, the
    heaviest last in CSR order; the forward launches them by entry count,
    most first, ties in row order."""
    bst = BlocksparseTransformer(fixed_layout(32, local_blocks=8),
                                 block_size=64, heads=8,
                                 mask_callback=causal_subblock_mask)
    tab = bst._tables("cpu")
    order = tab["order"]
    assert order.dtype == torch.int32 and tuple(order.shape) == (1, 32)
    want = [r for top in range(28, 4, -4) for r in range(top, top + 4)] \
        + list(range(7, -1, -1))
    assert order[0].tolist() == want
    counts = np.diff(tab["row_ptr"].numpy())
    assert counts.tolist() == list(range(1, 9)) + [
        n for n in range(9, 15) for _ in range(4)]
    assert counts[want].tolist() == [n for n in range(14, 8, -1)
                                     for _ in range(4)] + list(range(8, 0, -1))
