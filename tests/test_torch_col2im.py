"""col2im's tile rule for the TMA kernel (``csrc/col2im_tma.cu``), on the CPU.

``col2im_tile`` picks, from shapes alone, the TH x TW output pixels a
thread block owns and its ring depth; the kernel reads one TMA box {bC,
TW, TH, 1} of dX a tap.  These tests hold the rule to the limits the
hardware and the kernel set, for every channel block and dtype, at the
conv bench's shape (32 x 32 images) and at odd ones (7 x 9, one row of
37, W past TMA's 256, a large image):

- TMA: each box dimension at most 256, the box's inner extent (bC
  elements) a multiple of 16 bytes, the global strides of the (N, H, W,
  C·R·S) view of dX multiples of 16 bytes;
- the kernel: TW a multiple of the pixels of one 16-byte store, at most
  four (channel, run) items for each of the 256 threads, the box within
  ``COL2IM_BOX``; shared memory within what a block may take, and two
  blocks resident on an SM;
- coverage: the tiles cover the image, TW spans W where the box allows.

And on the CPU ``col2im`` runs its plain version, whatever the tile.
"""
import numpy as np
import pytest
import torch

from blocksparse_tpu_torch.kernels import im2col as ic
from blocksparse_tpu_torch.kernels.bsmm import BLOCK_SIZES

# an H100 SM's 228 KB of shared memory, 1 KB of it reserved a block, and
# the 227 KB one block may take
SM_TOTAL, RESERVED, BLOCK_MAX = 233472, 1024, 232448
DTYPES = (torch.float32, torch.bfloat16, torch.float16)
SHAPES = ((32, 32), (7, 9), (1, 37), (3, 300), (64, 64))


@pytest.mark.parametrize("H,W", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_col2im_tile_within_tma_and_smem_limits(dtype, H, W):
    elem = torch.empty((), dtype=dtype).element_size()
    vec = 16 // elem
    for bC in BLOCK_SIZES:
        TH, TW, stages = ic.col2im_tile(bC, dtype, H, W)
        what = f"bC {bC} {dtype} {H}x{W}: TH {TH} TW {TW}"
        # TMA's limits on the box and the tensor
        assert 1 <= TH <= ic.TMA_BOX_DIM and 1 <= TW <= ic.TMA_BOX_DIM, what
        assert bC <= ic.TMA_BOX_DIM and bC * elem % 16 == 0, what
        for C, trs in ((bC, 9), (bC, 3), (4 * bC, 1)):
            assert C * trs * elem % 16 == 0, what   # the pixel stride
        # the kernel's: whole 16-byte runs, four items a thread of 256
        box = bC * TH * TW * elem
        assert TW % vec == 0 and box <= ic.COL2IM_BOX, what
        assert bC * TH * TW // vec <= 4 * 256, what
        assert 2 <= stages <= 8, what
        # col2im_tma.cu's smem_bytes: 128 bytes of alignment slack, the
        # ring of boxes, an 8-byte mbarrier a slot
        smem = 128 + stages * (box + 8)
        assert smem <= BLOCK_MAX, what
        assert 2 * (smem + RESERVED) <= SM_TOTAL, what   # two blocks an SM
        # the tiles cover the image; TW spans W unless the box is full
        assert TH <= H, what
        wide = -(-W // vec) * vec
        assert TW == min(wide, ic.TMA_BOX_DIM, ic.COL2IM_BOX // (bC * elem))
        if TW == wide and TH < H:
            assert (TH + 1) * TW * bC * elem > ic.COL2IM_BOX, what


def test_col2im_tile_at_the_conv_bench_shape():
    """The conv bench (3x3, b32, 32 x 32 images): a bf16 tile is 8 rows of
    32 pixels, a 16 KB box, six boxes in flight a thread block."""
    assert ic.col2im_tile(32, torch.bfloat16, 32, 32) == (8, 32, 6)
    assert ic.col2im_tile(32, torch.float32, 32, 32) == (4, 32, 6)
    assert ic.col2im_tile(8, torch.bfloat16, 3, 300) == (3, 256, 6)
    assert ic.col2im_tile(128, torch.float32, 7, 9) == (2, 12, 6)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_col2im_on_the_cpu_is_the_plain_version(dtype):
    rng = np.random.RandomState(3)
    dX = torch.from_numpy(rng.uniform(-1, 1, (16 * 9, 2 * 7 * 9))).to(dtype)
    args = (7, 9, 3, 3, 1, 1, 8)
    before = ic.col2im.launches
    assert torch.equal(ic.col2im(dX, *args), ic.col2im_plain(dX, *args))
    assert ic.col2im.launches == before
