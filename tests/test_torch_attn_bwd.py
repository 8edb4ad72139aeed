"""What the tensor-core attention backward adds on the host, on the CPU:
the 16-byte alignment rule for the views it is handed, and the launch
order of the dk/dv kernel's key block-rows on the LM's layout."""
import numpy as np
import pytest
import torch

from blocksparse_tpu_torch import BlocksparseTransformer
from blocksparse_tpu_torch.kernels import bst_attn
from blocksparse_tpu_torch.models.sparse_transformer import (
    causal_subblock_mask, fixed_layout)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_packed_qkv_slices_pass_uncopied(dtype):
    """The LM's q, k and v: column slices of one packed (batch, ctx, 3·512)
    qkv, row stride 3·512 elements, offsets of 512; and contiguous lse."""
    qkv = torch.zeros((2, 128, 3 * 512), dtype=dtype)
    for t in qkv.split(512, dim=-1):
        assert bst_attn._aligned16(t) is t
    lse = torch.zeros((2, 8, 128))
    assert bst_attn._aligned16(lse) is lse


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_views_off_16_bytes_are_copied(dtype):
    """A view that starts 2 bytes past a 16-byte boundary, or whose row
    stride is 4 bytes off one, goes in as an aligned contiguous copy of the
    same values."""
    src = torch.randn((2, 64, 32)).to(dtype)
    shifted = torch.empty(src.numel() + 1, dtype=dtype)[1:].view_as(src)
    padded = torch.zeros((2, 64, 34), dtype=dtype)[..., :32]
    for view in (shifted, padded):
        view.copy_(src)
        got = bst_attn._aligned16(view)
        assert got is not view and got.is_contiguous()
        assert got.data_ptr() % 16 == 0 and torch.equal(got, src)


def test_launch_order_on_the_lm_layout():
    """The LM's layout (fixed, 32 block-rows, 8 local blocks, bs 64): key
    rows by entry count, most first, ties in row order; the summary columns
    0, 4, ..., 20 hold 32, 28, ..., 12 entries, rows 25-31 fewer than 8."""
    bst = BlocksparseTransformer(fixed_layout(32, local_blocks=8),
                                 block_size=64, heads=8,
                                 mask_callback=causal_subblock_mask)
    tab = bst._tables("cpu")
    order = tab["order_t"]
    assert order.dtype == torch.int32 and tuple(order.shape) == (1, 32)
    want = ([0, 4, 8, 12, 16, 20]
            + [r for r in range(25) if r % 4 or r > 20] + list(range(25, 32)))
    assert order[0].tolist() == want
    counts = np.diff(tab["row_ptr_t"].numpy())
    assert counts[want].tolist() == ([32, 28, 24, 20, 16, 12] + [8] * 19
                                     + [7, 6, 5, 4, 3, 2, 1])


def test_launch_order_per_layout_head():
    """One order per layout head, each a permutation of the key rows,
    stable among equal counts."""
    row_ptr = np.array([0, 1, 3, 4, 6, 0, 2, 2, 5, 6], np.int32)  # 2 heads
    order = bst_attn.launch_order(row_ptr, 4)
    assert order.dtype == np.int32
    assert order.tolist() == [[1, 3, 0, 2], [2, 0, 3, 1]]
