"""im2col from the image in place, and the im2col kernel's tile rule, on the CPU.

``im2col_image`` takes the image (N, C, H, W) itself, as the conv passes
it, where ``im2col`` takes a channel-major (C, N·H·W) copy; on the card
``csrc/im2col.cu`` reads the image through its strides, so the conv
makes no such copy, and its backward ``col2im_image`` writes the
image's gradient in NCHW.  On the CPU both run the plain versions.
These tests hold them to JAX's Pallas ``im2col``/``col2im`` (interpret
mode) bit for bit, in f32, by reshaping on the JAX side only.

``im2col_tile`` picks, from shapes alone, the channels (CB) and the TH x
TW output pixels a thread block of ``csrc/im2col.cu`` owns.  The tests
hold it to the kernel's limits for every channel block and dtype, at the
conv bench's shape and at odd ones: TW a multiple of a 16-byte run, at
most four 16-byte chunks of X a thread a tap, the halo tile within a
block's shared memory (and within the 64 KB it aims at wherever that is
possible), CB a divisor of bC holding whole 16-byte runs, and tiles that
cover the image.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from blocksparse_tpu.kernels import im2col as jax_im2col

from blocksparse_tpu_torch.kernels import im2col as ic
from blocksparse_tpu_torch.kernels.bsmm import BLOCK_SIZES

DTYPES = (torch.float32, torch.bfloat16, torch.float16)
# (N, C, bC, H, W, R, S, pt, pl): pads 0..R-1, odd H and W, 1-row images
_CASES = [(2, 16, 8, 8, 16, 3, 3, 1, 1), (2, 32, 16, 7, 9, 3, 3, 0, 0),
          (1, 16, 8, 5, 11, 3, 3, 2, 2), (3, 24, 8, 6, 6, 5, 5, 2, 4),
          (2, 32, 32, 1, 20, 1, 3, 0, 2)]


@pytest.mark.parametrize("case", _CASES,
                         ids=[f"C{c[1]}-b{c[2]}-{c[3]}x{c[4]}-{c[5]}x{c[6]}-"
                              f"p{c[7]}{c[8]}" for c in _CASES])
def test_im2col_image_matches_jax_kernels(case):
    """X from the image equals JAX im2col of its channel-major copy, and
    the gradient (autograd's backward, ``col2im_image``) equals JAX
    col2im reshaped to NCHW, bit for bit in f32."""
    N, C, bC, H, W, R, S, pt, pl = case
    rng = np.random.RandomState(C + H * W + R)
    x = rng.standard_normal((N, C, H, W)).astype(np.float32)
    dX = rng.standard_normal((C * R * S, N * H * W)).astype(np.float32)
    xc = x.transpose(1, 0, 2, 3).reshape(C, N * H * W)
    args = (H, W, R, S, pt, pl, bC)
    xt = torch.from_numpy(x).requires_grad_()
    X = ic.im2col_image(xt, R, S, pt, pl, bC)
    np.testing.assert_array_equal(
        X.detach().numpy(), np.asarray(jax_im2col.im2col(jnp.asarray(xc),
                                                         *args)))
    (g,) = torch.autograd.grad(X, xt, torch.from_numpy(dX))
    want = np.asarray(jax_im2col.col2im(jnp.asarray(dX), *args)).reshape(
        C, N, H, W).transpose(1, 0, 2, 3)
    assert g.shape == (N, C, H, W) and g.is_contiguous()
    np.testing.assert_array_equal(g.numpy(), want)
    np.testing.assert_array_equal(
        ic.col2im_image(torch.from_numpy(dX), N, *args).numpy(), want)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_im2col_image_of_a_strided_view_on_the_cpu(dtype):
    """A view whose channel stride is not H·W (an NHWC tensor seen as
    NCHW) gives the X of its values, and the plain version counts no
    launch."""
    rng = np.random.RandomState(2)
    nhwc = torch.from_numpy(rng.uniform(-1, 1, (2, 5, 7, 16))).to(dtype)
    x = nhwc.permute(0, 3, 1, 2)
    before = ic.im2col.launches
    X = ic.im2col_image(x, 3, 3, 1, 1, 8)
    assert ic.im2col.launches == before
    xc = x.transpose(0, 1).reshape(16, -1)
    assert torch.equal(X, ic.im2col_plain(xc, 5, 7, 3, 3, 1, 1, 8))


SHAPES = ((32, 32), (7, 9), (1, 37), (3, 300), (64, 64), (14, 14))
FILTERS = ((3, 3, 1, 1), (3, 3, 0, 0), (3, 3, 2, 2), (1, 3, 0, 2),
           (5, 5, 2, 2), (1, 1, 0, 0))


@pytest.mark.parametrize("H,W", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_im2col_tile_within_the_kernels_limits(dtype, H, W):
    elem = torch.empty((), dtype=dtype).element_size()
    vec = 16 // elem
    for bC in BLOCK_SIZES:
        for R, S, pt, pl in FILTERS:
            CB, TH, TW = ic.im2col_tile(bC, dtype, H, W, R, S, pl)
            what = f"bC {bC} {dtype} {H}x{W} {R}x{S}: CB {CB} TH {TH} TW {TW}"
            # CB channels: a divisor of bC, whole 16-byte runs a pixel
            assert bC % CB == 0 and CB * elem % 16 == 0, what
            # whole 16-byte runs along W; four chunks a thread of 256
            assert TW % vec == 0 and TW >= vec, what
            assert TH * TW * (CB // vec) <= 4 * 256, what
            # the halo tile and the taps' offsets, as im2col.cu lays them
            lp, rp = -(-pl // vec) * vec, -(-(S - 1 - pl) // vec) * vec
            smem = (TH + R - 1) * (lp + TW + rp) * CB * elem + 4 * R * S
            assert smem == ic.im2col_smem(CB, TH, TW, dtype, R, S, pl), what
            assert smem <= ic.IM2COL_SMEM, what      # three blocks an SM
            assert CB == bC, what                   # small filters: whole blocks
            # the tiles cover the image; TW spans W where the chunks allow
            assert 1 <= TH <= H, what
            wide = -(-W // vec) * vec
            assert TW == min(wide, 4 * 256 * vec // CB // vec * vec) or \
                ic.im2col_smem(CB, TH, TW + vec, dtype, R, S, pl) > \
                ic.IM2COL_SMEM, what


def test_im2col_tile_at_the_conv_bench_shape():
    """The conv bench (3x3 SAME, b32, 32 x 32 images): a bf16 tile is 8
    rows of 32 pixels of the whole channel block, an f32 one 4 rows."""
    assert ic.im2col_tile(32, torch.bfloat16, 32, 32, 3, 3, 1) == (32, 8, 32)
    assert ic.im2col_tile(32, torch.float32, 32, 32, 3, 3, 1) == (32, 4, 32)
    assert ic.im2col_tile(8, torch.bfloat16, 32, 32, 3, 3, 1) == (8, 32, 32)
    assert ic.im2col_tile(128, torch.float32, 32, 32, 3, 3, 1) == (128, 1, 32)


def test_im2col_tile_of_a_large_filter():
    """A filter whose halo rows outgrow 64 KB keeps the smallest tile; one
    past a block's shared memory splits the channel block; one past even
    8 channels raises."""
    CB, TH, TW = ic.im2col_tile(128, torch.float32, 64, 64, 15, 15, 7)
    assert (CB, TH, TW) == (128, 1, 4)
    assert ic.IM2COL_SMEM < ic.im2col_smem(CB, TH, TW, torch.float32, 15, 15,
                                           7) <= ic.SMEM_BLOCK_MAX
    CB, TH, TW = ic.im2col_tile(128, torch.float32, 64, 64, 25, 25, 12)
    assert CB < 128 and 128 % CB == 0 and TH == 1 and TW == 4
    assert ic.im2col_smem(CB, TH, TW, torch.float32, 25, 25, 12) <= \
        ic.SMEM_BLOCK_MAX
    with pytest.raises(ValueError, match="shared memory"):
        ic.im2col_tile(8, torch.float32, 512, 512, 201, 201, 100)
