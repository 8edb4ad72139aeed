"""The port's host-side LUTs equal the JAX package's exactly.

Block-sparse matmul: block ids (z-order), updat/fprop/bprop lists, the
flat fprop/bprop entry arrays and shapes.  Attention: nt/nn/tn lists and
LUTs, masks, mask codes, and the fused kernels' query-row and key-row
CSRs against the JAX fused kernels' schedules.  Also: the port imports
no JAX module.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from blocksparse_tpu import BlocksparseMatMul as JaxBSMM
from blocksparse_tpu import BlocksparseTransformer as JaxBST
from blocksparse_tpu.kernels import bst_attn as jax_bst_attn
from blocksparse_tpu.models.sparse_transformer import (
    causal_subblock_mask, fixed_layout, strided_layout, dense_causal_layout)
from blocksparse_tpu.utils import z_order_2d as jax_z_order_2d

from blocksparse_tpu_torch import BlocksparseMatMul, BlocksparseTransformer
from blocksparse_tpu_torch.kernels import bst_attn
from blocksparse_tpu_torch.models import sparse_transformer as port_model
from blocksparse_tpu_torch.utils import z_order_2d

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parent.parent


def test_z_order_2d():
    for x in range(40):
        for y in range(40):
            assert z_order_2d(x, y) == jax_z_order_2d(x, y)


@pytest.mark.parametrize("z_order", [True, False])
@pytest.mark.parametrize("bsize", [8, 16, 32, 64])
def test_bsmm_luts(bsize, z_order):
    rng = np.random.RandomState(bsize)
    layout = (rng.rand(7, 11) < 0.4).astype(np.int32)
    layout[0, 0] = 1
    kw = dict(block_size=bsize, feature_axis=1, z_order=z_order)
    ref, port = JaxBSMM(layout, **kw), BlocksparseMatMul(layout, **kw)
    assert port.updat_list == ref.updat_list
    np.testing.assert_array_equal(port.updat_lut, ref.updat_lut)
    assert port.fprop_list == ref.fprop_list
    assert port.bprop_list == ref.bprop_list
    assert port.w_shape == ref.w_shape
    assert port.i_shape(5) == ref.i_shape(5)
    assert port.o_shape(5) == ref.o_shape(5)
    assert (port.blocks, port.C, port.K, port.sparsity) == \
        (ref.blocks, ref.C, ref.K, ref.sparsity)
    for a, b in zip(port._fprop_flat + port._bprop_flat,
                    ref._fprop_flat + ref._bprop_flat):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        port.identity_init()(), ref.identity_init()())


def _layouts():
    cases = []
    for bs in (8, 16, 32, 64):
        cases.append(("fixed", bs, fixed_layout(8, local_blocks=3)))
    cases.append(("strided", 16, strided_layout(9, local_blocks=2)))
    cases.append(("dense", 32, dense_causal_layout(6)))
    lay = fixed_layout(8, local_blocks=2)
    per_head = np.stack([lay, lay[:, ::-1]])   # same block count per head
    cases.append(("per_head", 16, per_head))
    return cases


@pytest.mark.parametrize("name,bs,layout", _layouts(),
                         ids=[f"{c[0]}-b{c[1]}" for c in _layouts()])
def test_attention_luts(name, bs, layout):
    heads = 2
    ref = JaxBST(layout, block_size=bs, heads=heads,
                 mask_callback=causal_subblock_mask)
    port = BlocksparseTransformer(layout, block_size=bs, heads=heads,
                                  mask_callback=causal_subblock_mask)
    assert port.nt_list == ref.nt_list
    assert port.nn_list == ref.nn_list
    assert port.tn_list == ref.tn_list
    assert (port.nn_max, port.tn_max, port.blocks) == \
        (ref.nn_max, ref.tn_max, ref.blocks)
    np.testing.assert_array_equal(port.nt_lut, ref.nt_lut)
    for a, b in zip(port.nn_lut + port.tn_lut, ref.nn_lut + ref.tn_lut):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(port.softmax_mask_np, ref.softmax_mask_np)
    np.testing.assert_array_equal(port.softmax_mask, ref.softmax_mask)
    np.testing.assert_array_equal(port._mask_blocks, ref._mask_blocks)
    for a, b in zip(port.decode_tables, ref.decode_tables):
        np.testing.assert_array_equal(a, b)

    codes, uniq = port.mask_codes()
    ref_codes, ref_uniq = jax_bst_attn.classify_mask_blocks(
        ref._mask_blocks, bs)
    np.testing.assert_array_equal(codes, ref_codes)
    np.testing.assert_array_equal(uniq, ref_uniq)

    # the kernel's CSR walks each query row's key blocks in the JAX fused
    # kernel's schedule order, with the same mask codes
    row_ptr, ent_k, ent_code = bst_attn.build_attn_csr(port.nn_list, codes)
    sched = ref.attn_schedule
    rows = ref.ctx_blks_q
    for h in range(ref.lut_heads):
        for q in range(rows):
            steps = np.nonzero(sched.row == q)[0]
            kk = sched.k_idx[h, steps].reshape(-1)
            mc = sched.mcode[h, steps].reshape(-1)
            n = len(ref.nn_list[h][q])
            lo, hi = row_ptr[h * (rows + 1) + q], row_ptr[h * (rows + 1) + q + 1]
            assert hi - lo == n
            np.testing.assert_array_equal(ent_k[lo:hi], kk[:n])
            np.testing.assert_array_equal(ent_code[lo:hi], mc[:n])
            assert (mc[n:] == jax_bst_attn.MASK_ABSENT).all()


@pytest.mark.parametrize("name,bs,layout", _layouts(),
                         ids=[f"{c[0]}-b{c[1]}" for c in _layouts()])
def test_attention_tn_csr(name, bs, layout):
    """The dk/dv kernel's key-row CSR walks each key row's query blocks in
    the JAX tn schedule's order, with the mask codes and unique table of
    the transposed mask blocks (``build_attn_schedule_tn``)."""
    heads = 2
    ref = JaxBST(layout, block_size=bs, heads=heads,
                 mask_callback=causal_subblock_mask)
    port = BlocksparseTransformer(layout, block_size=bs, heads=heads,
                                  mask_callback=causal_subblock_mask)
    codes_t, uniq_t = port.mask_codes(transposed=True)
    row_ptr, ent_q, ent_code = bst_attn.build_attn_csr(port.tn_list, codes_t)
    sched = ref.attn_schedule_tn
    np.testing.assert_array_equal(uniq_t, sched.muniq)
    rows = ref.ctx_blks_k
    for h in range(ref.lut_heads):
        for r in range(rows):
            steps = np.nonzero(sched.row == r)[0]
            kk = sched.k_idx[h, steps].reshape(-1)
            mc = sched.mcode[h, steps].reshape(-1)
            n = len(ref.tn_list[h][r])
            lo, hi = row_ptr[h * (rows + 1) + r], row_ptr[h * (rows + 1) + r + 1]
            assert hi - lo == n
            np.testing.assert_array_equal(ent_q[lo:hi], kk[:n])
            np.testing.assert_array_equal(ent_code[lo:hi], mc[:n])
            assert (mc[n:] == jax_bst_attn.MASK_ABSENT).all()
    # the causal diagonal is TRIL on the query rows, TRIU on the key rows
    diag = [b for b, (q, k) in enumerate(port.nt_list[0]) if q == k]
    codes, _ = port.mask_codes()
    assert (codes[0, diag] == bst_attn.MASK_TRIL).all()
    assert (codes_t[0, diag] == bst_attn.MASK_TRIU).all()


def test_model_layouts_equal():
    for ctx_blks in (4, 16, 33):
        np.testing.assert_array_equal(port_model.fixed_layout(ctx_blks, 8),
                                      fixed_layout(ctx_blks, 8))
        np.testing.assert_array_equal(port_model.strided_layout(ctx_blks, 3),
                                      strided_layout(ctx_blks, 3))
        np.testing.assert_array_equal(port_model.dense_causal_layout(ctx_blks),
                                      dense_causal_layout(ctx_blks))
    for q, k in ((0, 0), (2, 1), (3, 3)):
        np.testing.assert_array_equal(
            port_model.causal_subblock_mask((16, 16), 0, q, k, 0),
            causal_subblock_mask((16, 16), 0, q, k, 0))


def test_import_pulls_no_jax():
    """Importing the port with jax and networkx blocked works and loads no
    jax module; no file of the port, nor chip_smoke.py, imports jax,
    networkx or the JAX package."""
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['networkx'] = None; "
            "import blocksparse_tpu_torch, blocksparse_tpu_torch.convert, "
            "blocksparse_tpu_torch.ops.conv, "
            "blocksparse_tpu_torch.kernels.im2col, "
            "blocksparse_tpu_torch.models.sparse_lstm, "
            "blocksparse_tpu_torch.parallel, blocksparse_tpu_torch.nccl, "
            "blocksparse_tpu_torch.parallel.pipeline; "
            "blocksparse_tpu_torch.models.sparse_lstm.make_mask(40, 'ba_3'); "
            "bad = [m for m, mod in sys.modules.items() if mod is not None "
            "and (m.startswith(('jax', 'blocksparse_tpu.')) "
            "or m == 'blocksparse_tpu')]; "
            "assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   cwd=str(REPO), timeout=120)
    for path in [*(REPO / "blocksparse_tpu_torch").rglob("*.py"),
                 REPO / "chip_smoke.py"]:
        for line in path.read_text().splitlines():
            words = line.split()
            assert not (words[:1] in (["import"], ["from"])
                        and len(words) > 1
                        and words[1].split(".")[0] in (
                            "jax", "jaxlib", "networkx", "blocksparse_tpu")), \
                (path, line)
