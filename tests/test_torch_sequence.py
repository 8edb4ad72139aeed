"""Sequence-parallel attention: the port's shard tables, gather and ring
modes against the JAX package's and against the port's unsharded
attention.

Four gloo ranks (``torch_dist_workers.sequence_cases``, spawned once for
the file) run ``sequence_parallel_attention`` and ``ring_attention`` at
sp 2 (a dp 2 x sp 2 mesh) and sp 4, forward and backward, on two configs
(``torch_dist_workers.SEQ``): two layout heads at block size 16, the fixed
pattern with the causal sub-block mask and a layout whose key block-row 2
no query sees (an empty key row on every shard); and the shared fixed
layout at block size 8 (the kernels' bs-16 view), 12 block-rows, so a
shard holds 3 at sp 4.  On the CPU the shard kernels' plain versions run
on the kernels' view of each shard's tables.

Tolerances, f32: the gather mode's y, lse and dq against the unsharded
attention 1e-6 (each row sums its entries in the unsharded order); its
dk/dv and everything of the ring (partial sums added across shards, the
ring's (out, lse) merge) 1e-5 absolute on values of order 1; against the
JAX package's ``shard_map`` (other kernels, other summation orders) 2e-5.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from blocksparse_tpu.kernels import bst_attn as jax_bst_attn
from blocksparse_tpu.ops.transformer import (
    BlocksparseTransformer as JaxBST)
from blocksparse_tpu.parallel import sequence as jax_seq

from blocksparse_tpu_torch.kernels import bst_attn
from blocksparse_tpu_torch.ops.transformer import _rowsum
from blocksparse_tpu_torch.parallel import sequence as seq
import torch_dist_workers as workers

WORLD = 4
CASES = [(name, mode, n) for name in workers.SEQ
         for mode in ("gather", "ring") for n in (2, 4)]
# the cases also held against JAX (each a Pallas compile in interpret mode,
# ~5-20 s): both modes at sp 2 and 4 on the two-head b16 layout, and the
# b8 ring at sp 4 (odd shards)
JAX_CASES = [("perhead16", "gather", 2), ("perhead16", "ring", 2),
             ("perhead16", "gather", 4), ("perhead16", "ring", 4),
             ("shared8", "ring", 4)]


@pytest.fixture(scope="module")
def ranks():
    return workers.spawn("sequence_cases", WORLD)


def _assembled(ranks, key):
    """The sp ranks' shards of ``key``'s results, joined along the
    context (the first n ranks hold sp ranks 0..n-1 of dp rank 0)."""
    n = key[2]
    outs = sorted((r[key] for r in ranks[:n]), key=lambda o: o["sp_rank"])
    return {k: np.concatenate([o[k] for o in outs], axis=1)
            for k in ("y", "dq", "dk", "dv")}


def _unsharded(name):
    """The port's unsharded attention: y, dq, dk, dv and lse."""
    bst = workers.seq_op(name)
    q, k, v, dy = (torch.from_numpy(a) for a in workers.seq_inputs(name))
    qkv = [t.clone().requires_grad_() for t in (q, k, v)]
    y = bst.attention(*qkv, scale=workers.seq_scale(name))
    y.backward(dy)
    _, lse = bst._kernel_fwd(q, k, v, workers.seq_scale(name), True)
    return {"y": y.detach().numpy(), "dq": qkv[0].grad.numpy(),
            "dk": qkv[1].grad.numpy(), "dv": qkv[2].grad.numpy(),
            "lse": lse.numpy()}


def _shard_lse(name, mode, n):
    """Each shard's lse, in one process, by the functions the ranks run:
    the gather mode's on its tables against the whole K/V, the ring's
    merged over its pairs."""
    bst = workers.seq_op(name)
    q, k, v, _ = (torch.from_numpy(a) for a in workers.seq_inputs(name))
    scale = workers.seq_scale(name)
    L = q.shape[1] // n
    lses = []
    for r in range(n):
        qr = q[:, r * L:(r + 1) * L]
        if mode == "gather":
            lses.append(seq.shard_forward(bst, qr, k, v, scale,
                                          seq.shard_tables(bst, n, r))[1])
            continue
        out = torch.zeros(qr.shape)
        lse = torch.full((q.shape[0], bst.heads, L), -1e30)
        for j in range(n):
            o_t, l_t = seq.shard_forward(
                bst, qr, k[:, j * L:(j + 1) * L], v[:, j * L:(j + 1) * L],
                scale, seq.shard_tables(bst, n, r, j))
            out, lse = seq.merge(out, lse, o_t, l_t, bst.heads)
        lses.append(lse)
    return torch.cat(lses, dim=2).numpy()


@pytest.mark.parametrize("name,mode,n", CASES)
def test_sharded_attention_matches_the_unsharded_attention(ranks, name,
                                                           mode, n):
    got = _assembled(ranks, (name, mode, n))
    want = _unsharded(name)
    exact = 1e-6 if mode == "gather" else 1e-5
    for key in ("y", "dq"):
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=exact,
                                   err_msg=key)
    for key in ("dk", "dv"):
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-5,
                                   err_msg=key)
    np.testing.assert_allclose(_shard_lse(name, mode, n), want["lse"],
                               rtol=0, atol=exact)
    if name == "perhead16":
        # key block-row 2 of layout head 1 is seen by no query: zero dk/dv
        bs, hs = workers.SEQ[name]["bs"], workers.SEQ[name]["hs"]
        for key in ("dk", "dv"):
            assert not got[key][:, 2 * bs:3 * bs, hs:2 * hs].any()


_JAX = {}


def _jax(name, mode, n):
    """JAX's sequence_parallel_attention / ring_attention in shard_map on
    n simulated devices (Pallas in interpret mode): y, dq, dk, dv."""
    key = (name, mode, n)
    if key not in _JAX:
        c = workers.SEQ[name]
        bst = JaxBST(workers.seq_layout(name), block_size=c["bs"],
                     heads=c["heads"],
                     mask_callback=workers.causal_subblock_mask)
        fn = (jax_seq.sequence_parallel_attention if mode == "gather"
              else jax_seq.ring_attention)
        mesh = Mesh(np.array(jax.devices()[:n]), ("sp",))
        att = shard_map(
            lambda q, k, v: fn(bst, q, k, v, axis="sp", n_shards=n,
                               scale=workers.seq_scale(name)),
            mesh=mesh, in_specs=(P(None, "sp"),) * 3,
            out_specs=P(None, "sp"), check_vma=False)

        @jax.jit
        def run(q, k, v, dy):
            y, vjp = jax.vjp(att, q, k, v)
            return (y,) + vjp(dy)
        q, k, v, dy = (jnp.asarray(a) for a in workers.seq_inputs(name))
        _JAX[key] = dict(zip(("y", "dq", "dk", "dv"),
                             (np.asarray(a) for a in run(q, k, v, dy))))
    return _JAX[key]


@pytest.mark.parametrize("name,mode,n", JAX_CASES)
def test_sharded_attention_matches_jax(ranks, name, mode, n):
    got = _assembled(ranks, (name, mode, n))
    want = _jax(name, mode, n)
    for key in ("y", "dq", "dk", "dv"):
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=2e-5,
                                   err_msg=key)


def _jax_entries(stack, i, lut_heads):
    """{(head, row): [block index]} of shard (or pair) i of a JAX stacked
    schedule, MASK_ABSENT slots dropped."""
    out = {}
    for s_, row in enumerate(stack["row"][i]):
        for h in range(lut_heads):
            for e, code in enumerate(stack["mcode"][i][h, s_]):
                if code != jax_bst_attn.MASK_ABSENT:
                    out.setdefault((h, int(row)), []).append(
                        int(stack["k_idx"][i][h, s_, e]))
    return out


def _port_entries(tab, transposed):
    """{(head, row): [block index]} of a port shard's own-block-size
    layout (``nt``): query rows to key blocks, or (transposed) key rows
    to query blocks."""
    out = {}
    for h, blocks in enumerate(tab["nt"]):
        for qb, kb in blocks:
            row, col = (kb, qb) if transposed else (qb, kb)
            out.setdefault((h, row), []).append(col)
    return out


@pytest.mark.parametrize("name", list(workers.SEQ))
@pytest.mark.parametrize("n", [2, 4])
def test_shard_tables_hold_the_jax_schedules_blocks(name, n):
    """Each shard (gather) and each (query shard, key chunk) pair (ring)
    holds the (q, k) blocks of JAX's ``build_sp_schedules`` /
    ``build_ring_schedules``, in each query row's order; at block size 16
    up the kernels' CSR is that table itself."""
    c = workers.SEQ[name]
    jbst = JaxBST(workers.seq_layout(name), block_size=c["bs"],
                  heads=c["heads"],
                  mask_callback=workers.causal_subblock_mask)
    bst = workers.seq_op(name)
    lh = bst.lut_heads
    sp = jax_seq.build_sp_schedules(jbst, n)
    ring = jax_seq.build_ring_schedules(jbst, n)
    for i in range(n):
        tab = seq.shard_tables(bst, n, i)
        assert _port_entries(tab, False) == _jax_entries(sp.nn, i, lh)
        # JAX's tn schedule gives a key row with no local query one
        # all-masked chunk; the port's CSR row is empty
        assert _port_entries(tab, True) == _jax_entries(sp.tn, i, lh)
        if c["bs"] >= 16:
            rp = tab["row_ptr"].numpy().reshape(lh, -1)
            ent = tab["ent_k"].numpy()
            for (h, row), ks in _port_entries(tab, False).items():
                assert ent[rp[h, row]:rp[h, row + 1]].tolist() == ks
        for j in range(n):
            pair = seq.shard_tables(bst, n, i, j)
            assert _port_entries(pair, False) == \
                _jax_entries(ring.nn, i * n + j, lh)
            assert _port_entries(pair, True) == \
                _jax_entries(ring.tn, i * n + j, lh)
    assert seq.build_sp_schedules(bst, n)[0] is seq.shard_tables(bst, n, 0)
    assert seq.build_ring_schedules(bst, n)[1][0] is \
        seq.shard_tables(bst, n, 1, 0)


def test_bs8_shards_with_an_odd_row_count_borrow_no_row():
    """At block size 8 with 3 block-rows a shard, each shard's view pads its
    own q with one hidden 8-row (2 view rows of 16), never a neighbour's."""
    bst = workers.seq_op("shared8")
    for r in range(4):
        tab = seq.shard_tables(bst, 4, r)
        assert (tab["kbs"], tab["kctx_q"], tab["kctx_k"]) == (16, 32, 96)
        # every view block's mask hides the pad row's 8 queries
        assert not tab["kmask"][:, :, 8:, :][
            tab["kq_blk"] == 1].any()


def test_dq_f32_plain_option_keeps_the_sum_unrounded():
    """``attention_bwd_plain(dq_dtype=f32)``, the plain version of the dq
    kernel's f32 output: the same sum, unrounded (bf16 inputs)."""
    bst = workers.seq_op("perhead16")
    q, k, v, dy = (torch.from_numpy(a).bfloat16()
                   for a in workers.seq_inputs("perhead16"))
    tab = bst._tables(q.device)
    out, lse = bst_attn.attention_fwd_lse_plain(
        q, k, v, tab["q_blk"], tab["k_blk"], tab["mask"], bst.heads, 16,
        0.25)
    args = (q, k, v, dy, lse, _rowsum(dy, out, bst.heads), tab["q_blk"],
            tab["k_blk"], tab["mask"], bst.heads, 16, 0.25)
    dq, dk, dv = bst_attn.attention_bwd_plain(*args)
    dq32, dk32, dv32 = bst_attn.attention_bwd_plain(
        *args, dq_dtype=torch.float32)
    assert dq.dtype == torch.bfloat16 and dq32.dtype == torch.float32
    assert torch.equal(dq32.bfloat16(), dq)
    assert torch.equal(dk32, dk) and torch.equal(dv32, dv)
