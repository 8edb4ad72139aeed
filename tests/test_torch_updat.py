"""The tensor-core updat's host side: its plan (``updat_plan``), its N
split (``updat_splits``, ``updat_run_rows``) and the split's second pass
(``updat_reduce_plain``), on the CPU.

``csrc/bsmm_updat_mma.cu`` runs only on the card (``test_torch_cuda.py``
holds it against ``updat_plain`` there).  Here the plan's invariants are
checked, the split rule is pinned by value, and the kernel's
decomposition (each group's slots against its shared tile, run by run,
D stored transposed for x block-row groups, partials summed in run order)
is replayed in f32 on the plan and held against the JAX package's updat
(``impl="xla"`` and ``impl="pallas"`` in interpret mode) at 1e-5 of the
largest |dw| (the same f32 products summed in other orders).
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from blocksparse_tpu import BlocksparseMatMul as JaxBSMM
from blocksparse_tpu_torch import BlocksparseMatMul
from blocksparse_tpu_torch.kernels import bsmm as bsmm_kernels

torch.set_num_threads(2)
F32_TOL = 1e-5


def _layout(CB, KB, density, seed):
    rng = np.random.RandomState(seed)
    layout = (rng.rand(CB, KB) < density).astype(np.int32)
    layout[0, :] = 1                       # a row longer than one group
    return layout


def _replay(x, dy, plan, bsize, splits):
    """What bsmm_updat_mma.cu and its second pass compute, in f32 on the
    CPU: thread block (group, run) writes D = P_slotᵀ · Q over its run's
    rows into out[run][slot_e] (transposed when Q is x), then the runs'
    partials are summed in order."""
    N = x.shape[0]
    rows = bsmm_kernels.updat_run_rows(N, splits)
    runs = -(-N // rows) if splits > 1 else 1
    p, q = (dy, x) if plan["by_c"] else (x, dy)
    blocks = int((plan["slot_e"] >= 0).sum())
    out = torch.full((runs, blocks, bsize, bsize), float("nan"))
    for grp, qb in enumerate(plan["grp_q"]):
        qt = q[:, qb * bsize:(qb + 1) * bsize]
        for pb, e in zip(plan["slot_p"][grp], plan["slot_e"][grp]):
            if e < 0:
                continue
            pt = p[:, pb * bsize:(pb + 1) * bsize]
            for r in range(runs):
                d = pt[r * rows:(r + 1) * rows].t() @ qt[r * rows:(r + 1) * rows]
                out[r, e] = d.t() if plan["by_c"] else d
    return bsmm_kernels.updat_reduce_plain(out), runs


@pytest.mark.parametrize("bsize,shape", [(8, (40, 5)), (16, (3, 20)),
                                         (32, (6, 4)), (128, (2, 3))])
def test_updat_plan_covers_every_block_once(bsize, shape):
    """Every layout block in exactly one slot; a group's blocks share its
    staged tile (x block-row or dy block-column) and fill its slots from
    0; the axis is the one with fewer groups."""
    layout = _layout(*shape, 0.6, seed=bsize)
    op = BlocksparseMatMul(layout, block_size=bsize, feature_axis=1)
    c, k = op.updat_lut[:, 0], op.updat_lut[:, 1]
    plan = bsmm_kernels.updat_plan(c, k, bsize)
    G = bsmm_kernels.UPDAT_ROWS // bsize
    grp_q, slot_p, slot_e = plan["grp_q"], plan["slot_p"], plan["slot_e"]
    assert slot_p.shape == slot_e.shape == (len(grp_q), G)
    used = slot_e >= 0
    assert sorted(slot_e[used].tolist()) == list(range(op.blocks))
    assert ((slot_p >= 0) == used).all()
    assert (np.diff(used.astype(int), axis=1) <= 0).all()   # filled from 0
    shared, other = (c, k) if plan["by_c"] else (k, c)
    rows = np.broadcast_to(grp_q[:, None], slot_e.shape)
    assert (shared[slot_e[used]] == rows[used]).all()
    assert (other[slot_e[used]] == slot_p[used]).all()
    counts = {a: -(-np.bincount(s).astype(int) // G).sum()
              for a, s in (("c", c), ("k", k))}
    assert len(grp_q) == min(counts.values())
    assert plan["by_c"] == (counts["c"] <= counts["k"])


def test_updat_split_rule():
    """Split below UPDAT_WAVES waves of resident thread blocks (2 a SM,
    1 at b128) and from two runs of 512 rows; S = min(16, ceil(target /
    groups), N // 512)."""
    assert bsmm_kernels.updat_splits(16384, 75, 32, 132) == 8   # 528 / 75
    assert bsmm_kernels.updat_splits(32768, 92, 32, 132) == 6
    assert bsmm_kernels.updat_splits(32768, 1251, 32, 132) == 1
    assert bsmm_kernels.updat_splits(16384, 528, 32, 132) == 1
    assert bsmm_kernels.updat_splits(16384, 527, 32, 132) == 2
    assert bsmm_kernels.updat_splits(16384, 16, 128, 132) == 16  # 264 / 16
    assert bsmm_kernels.updat_splits(16384, 300, 128, 132) == 1
    assert bsmm_kernels.updat_splits(1500, 4, 32, 132) == 2      # 1500 // 512
    assert bsmm_kernels.updat_splits(1023, 4, 32, 132) == 1
    assert bsmm_kernels.updat_run_rows(16384, 8) == 2048
    assert bsmm_kernels.updat_run_rows(16384, 7) == 2368         # 32-row stages
    assert bsmm_kernels.updat_run_rows(77, 1) == 77
    layout = _layout(4, 6, 0.5, seed=1)
    op = BlocksparseMatMul(layout, block_size=32, feature_axis=1)
    assert op.updat_splits(1500, torch.bfloat16, sm_count=132) == 2
    assert op.updat_splits(77, torch.float16, sm_count=132) == 1
    assert op.updat_splits(1500, torch.float32, sm_count=132) == 1


@pytest.mark.parametrize("axis", [1, 0])
@pytest.mark.parametrize("bsize,shape,N,splits", [
    (8, (40, 5), 96, 1), (16, (3, 20), 200, 3), (32, (6, 4), 1100, 2),
    (64, (3, 2), 40, 1)])
def test_updat_decomposition_matches_jax(bsize, shape, N, splits, axis):
    layout = _layout(*shape, 0.6, seed=bsize + axis)
    op = BlocksparseMatMul(layout, block_size=bsize, feature_axis=axis)
    rng = np.random.RandomState(bsize)
    X = rng.uniform(-1, 1, op.i_shape(N)).astype(np.float32)
    E = rng.uniform(-1, 1, op.o_shape(N)).astype(np.float32)
    x, dy = (torch.from_numpy(a if axis else a.T.copy()) for a in (X, E))
    dw, runs = _replay(x, dy, op._plan("updat", "u"), bsize, splits)
    assert runs == splits
    for impl in ("xla", "pallas"):
        ref = np.asarray(JaxBSMM(layout, block_size=bsize, feature_axis=axis,
                                 impl=impl)._updat_impl(jnp.asarray(X),
                                                        jnp.asarray(E)))
        np.testing.assert_allclose(dw.numpy(), ref, rtol=0,
                                   atol=F32_TOL * np.abs(ref).max(),
                                   err_msg=impl)


def test_updat_reduce_plain_sums_in_run_order():
    parts = torch.tensor([[1e8], [1.0], [-1e8]], dtype=torch.float32)
    assert bsmm_kernels.updat_reduce_plain(parts).item() == 0.0  # (1e8+1)-1e8
    parts = torch.randn((5, 3, 8, 8), generator=torch.Generator().manual_seed(0))
    acc = parts[0]
    for s in range(1, 5):
        acc = acc + parts[s]
    assert torch.equal(bsmm_kernels.updat_reduce_plain(parts), acc)
