"""im2col / col2im for the block-sparse conv: the CUDA kernels and their
plain versions.

``im2col`` replaces the TPU kernel ``im2col`` / ``_im2col_fwd_impl`` and
runs ``csrc/im2col.cu`` (in tiles of ``im2col_tile``'s shape); ``col2im``
replaces the TPU kernel ``col2im`` (``blocksparse_tpu/kernels/im2col.py``)
and runs ``csrc/col2im_tma.cu``, which reads dX by TMA tile loads in
tiles of ``col2im_tile``'s shape.  im2col maps xc (C, N·H·W),
channel-major, to X (C·R·S, N·H·W) with row (cb·trs + tap)·bC + ci,
where tap t = r·S + s reads pixel (h + r − pt, w + s − pl), zero outside
the image.  ``im2col_image`` gives the same X from the image (N, C, H, W)
itself, which the kernel reads in place through its strides, and its
backward ``col2im_image`` writes the image's gradient in NCHW: the conv
makes no channel-major copy either way.  col2im is im2col's adjoint:
each output element sums the trs taps that land on it, in f32, in tap
order, cast to dX's dtype once.

``im2col`` is differentiable (a ``torch.autograd.Function`` whose backward
is ``col2im``), as the JAX custom_vjp is.  On a CUDA tensor each launches
its kernel or raises; on a CPU tensor, or with ``plain=True``, each runs
its plain version: ``im2col_plain`` (pad, tap slices, stack) and
``col2im_plain`` (the adjoint sum in f32 in tap order).  The kernels equal
them bit for bit: im2col is a copy, and col2im sums the same f32 values in
the same order.  On the card X and dX are kept in the NC orientation
that the block-sparse matmul kernels read and write (a contiguous
(N·H·W, C·R·S) array, seen as its transposed view), so the conv's matmuls
copy neither.

Scope (``im2col_supported``): 2-D, stride 1, dilation 1, output dims equal
to input dims, 0 <= pad < R, S, C % bC == 0; the kernels take bC of 8-128,
the conv's block sizes.  The TPU kernel also needs N·H·W on its 128 lanes
(``npix_align``); the card does not, so the port's default is 1.  Convs outside the scope take the plain tap build in
``ops/conv.py``, chosen by shape.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from blocksparse_tpu_torch.kernels import _build
from blocksparse_tpu_torch.kernels.bsmm import _DTYPE_CODE, BLOCK_SIZES


def im2col_supported(TRS, DHW, MPQ, strides, dilates, padding, C, bC,
                     npix_align=1):
    T, R, S = TRS
    return (T == 1 and list(strides) == [1, 1, 1]
            and list(dilates) == [1, 1, 1]
            and list(MPQ)[1:] == list(DHW)[1:] and MPQ[0] == 1
            and padding[0] == 0 and 0 <= padding[1] < R
            and 0 <= padding[2] < S and C % bC == 0
            and (DHW[1] * DHW[2]) % npix_align == 0)


def im2col_plain(xc, H, W, R, S, pt, pl_, bC):
    """xc (C, N·H·W) -> (C·R·S, N·H·W), rows (cb, tap, ci): the padded
    image's tap windows, stacked tap-minor within each channel block."""
    C, NP = xc.shape
    x = xc.reshape(C, NP // (H * W), H, W)
    xp = F.pad(x, (pl_, S - 1 - pl_, pt, R - 1 - pt))
    taps = [xp[:, :, r:r + H, s:s + W].reshape(C // bC, bC, NP)
            for r in range(R) for s in range(S)]
    return torch.stack(taps, 1).reshape(C * R * S, NP)


def col2im_plain(dX, H, W, R, S, pt, pl_, bC):
    """The adjoint of ``im2col_plain``: dX (C·R·S, N·H·W) -> (C, N·H·W),
    each tap window added back onto the padded image in f32, taps in
    order, then cropped and cast to dX's dtype."""
    Ctrs, NP = dX.shape
    C = Ctrs // (R * S)
    N = NP // (H * W)
    g = dX.reshape(C // bC, R * S, bC, N, H, W)
    acc = torch.zeros((C // bC, bC, N, H + R - 1, W + S - 1),
                      dtype=torch.float32, device=dX.device)
    for t in range(R * S):
        r, s = divmod(t, S)
        acc[:, :, :, r:r + H, s:s + W] += g[:, t].float()
    return acc[:, :, :, pt:pt + H, pl_:pl_ + W].reshape(C, NP).to(dX.dtype)


# col2im_tma.cu: a tap's TMA box holds at most COL2IM_BOX bytes (four
# 16-byte runs for each of its 256 threads) and at most TMA_BOX_DIM
# elements along each dimension; COL2IM_STAGES ring slots (two thread
# blocks resident an SM)
COL2IM_BOX = 16384
COL2IM_STAGES = 6
TMA_BOX_DIM = 256


def col2im_tile(bC, dtype, H, W):
    """col2im_tma.cu's tile for channel blocks of bC in ``dtype`` on H x W
    images: (TH, TW, stages).  A tile is TH x TW output pixels of one
    image and one channel block; each tap's box {bC, TW, TH} of dX holds
    at most COL2IM_BOX bytes.  TW covers W rounded up to the pixels of one
    16-byte store (VEC = 16 / itemsize), within TMA's 256 and the box;
    TH takes the rows the box has left, at most H.  Shapes only."""
    elem = torch.empty((), dtype=dtype).element_size()
    vec = 16 // elem
    pixels = COL2IM_BOX // (bC * elem)
    TW = min(-(-W // vec) * vec, TMA_BOX_DIM, pixels)
    TH = max(1, min(pixels // TW, H, TMA_BOX_DIM))
    return TH, TW, COL2IM_STAGES


# im2col.cu: a thread of 256 copies at most IM2COL_ITEMS 16-byte chunks of X
# a tap; the halo tile aims at IM2COL_SMEM bytes (three blocks an SM) and
# must fit SMEM_BLOCK_MAX, the shared memory one block may take
IM2COL_ITEMS = 4
IM2COL_THREADS = 256
IM2COL_SMEM = 65536
SMEM_BLOCK_MAX = 232448


def im2col_smem(CB, TH, TW, dtype, R, S, pl_):
    """im2col.cu's shared memory for a tile of CB channels and TH x TW
    output pixels: the halo tile, (TH + R - 1) rows of LP + TW + RP
    columns (the halo's pl and S - 1 - pl columns rounded up to 16-byte
    runs) of CB channels, and the taps' int offsets."""
    elem = torch.empty((), dtype=dtype).element_size()
    vec = 16 // elem
    lp, rp = -(-pl_ // vec) * vec, -(-(S - 1 - pl_) // vec) * vec
    return (TH + R - 1) * (lp + TW + rp) * CB * elem + 4 * R * S


def im2col_tile(bC, dtype, H, W, R, S, pl_):
    """im2col.cu's tile for channel blocks of bC in ``dtype`` on H x W
    images with R x S filters: (CB, TH, TW), CB channels and TH x TW
    output pixels a thread block.  TW covers W in 16-byte runs (VEC =
    16 / itemsize pixels), within the pixels that IM2COL_ITEMS chunks for
    each of the 256 threads hold; TH takes the rows left, at most H.  TH,
    then TW, shrink until the halo tile fits IM2COL_SMEM; CB (bC at first)
    halves only while it does not fit SMEM_BLOCK_MAX.  Shapes only;
    raises where even CB 8 does not fit."""
    elem = torch.empty((), dtype=dtype).element_size()
    vec = 16 // elem
    CB = bC
    pixels = IM2COL_ITEMS * IM2COL_THREADS * vec // CB
    TW = min(-(-W // vec) * vec, pixels // vec * vec)
    TH = min(H, pixels // TW)

    def smem():
        return im2col_smem(CB, TH, TW, dtype, R, S, pl_)
    while TH > 1 and smem() > IM2COL_SMEM:
        TH -= 1
    while TW > vec and smem() > IM2COL_SMEM:
        TW -= vec
    while CB > 8 and smem() > SMEM_BLOCK_MAX:
        CB //= 2
    if smem() > SMEM_BLOCK_MAX:
        raise ValueError(f"im2col: a {R}x{S} filter's halo tile does not fit "
                         f"a thread block's shared memory")
    return CB, TH, TW


_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def _check(fn, t, C, R, S, pt, pl_, bC):
    if not t.is_cuda:
        raise ValueError(f"{fn} launches a CUDA kernel: its input must be on "
                         f"a CUDA device")
    if t.dtype not in _DTYPE_CODE:
        raise TypeError(f"{fn} takes f32, bf16 or f16, got {t.dtype}")
    if bC not in BLOCK_SIZES or C % bC or not (0 <= pt < R and 0 <= pl_ < S):
        raise ValueError(f"{fn}: bC={bC} must be one of {BLOCK_SIZES} and "
                         f"divide C={C}, and 0 <= pt < R, 0 <= pl < S (pt={pt}, "
                         f"pl={pl_}, R={R}, S={S})")


def _planes(x):
    """x (N, C, H, W), or a contiguous copy of it where its H·W planes are
    not contiguous; and its (channel, image) strides."""
    N, C, H, W = x.shape
    if x.stride(3) != 1 or (H > 1 and x.stride(2) != W):
        x = x.contiguous()
    return x, x.stride(1), x.stride(0)


def _im2col_cuda(x, C, N, H, W, sc, sn, R, S, pt, pl_, bC):
    """Launch im2col.cu on the image x, element (n, c, h, w) at n·sn +
    c·sc + h·W + w; returns X (C·R·S, N·H·W) as the transposed view of a
    contiguous (N·H·W, C·R·S) array, the orientation the bsmm kernels
    read."""
    _check("im2col", x, C, R, S, pt, pl_, bC)
    out = torch.empty((N * H * W, C * R * S), dtype=x.dtype, device=x.device)
    CB, TH, TW = im2col_tile(bC, x.dtype, H, W, R, S, pl_)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _build.function(
            "im2col", "im2col_fwd",
            [_I, _P, _P] + [_I] * 9 + [_L, _L] + [_I] * 3 + [_P])(
            _DTYPE_CODE[x.dtype], x.data_ptr(), out.data_ptr(), C, N, H, W, R,
            S, pt, pl_, bC, sc, sn, CB, TH, TW, stream)
    if err != 0:
        raise RuntimeError(f"im2col launch failed: cudaError {err}")
    im2col.launches += 1
    return out.t()


def _col2im_cuda(dX, out, C, N, H, W, sc, sn, R, S, pt, pl_, bC):
    """Launch col2im_tma.cu: dX (C·R·S, N·H·W), read by TMA from its NC
    array, into out, element (n, c, h, w) at n·sn + c·sc + h·W + w."""
    _check("col2im", dX, C, R, S, pt, pl_, bC)
    src = dX.t().contiguous()
    if src.data_ptr() % 16:
        raise ValueError("col2im reads dX by TMA: its NC array must start "
                         "on a 16-byte boundary")
    with torch.cuda.device(dX.device):
        stream = torch.cuda.current_stream(dX.device).cuda_stream
        err = _build.function(
            "col2im_tma", "col2im_fwd", [_I, _P, _P] + [_I] * 12 + [_L, _L, _P])(
            _DTYPE_CODE[dX.dtype], src.data_ptr(), out.data_ptr(), C, N, H, W,
            R, S, pt, pl_, bC, *col2im_tile(bC, dX.dtype, H, W), sc, sn,
            stream)
    if err != 0:
        raise RuntimeError(f"col2im launch failed: cudaError {err}")
    col2im.launches += 1
    return out


def _dX_rows(dX, R, S):
    Ctrs, NP = dX.shape
    if Ctrs % (R * S):
        raise ValueError(f"col2im: dX has {Ctrs} rows, not a multiple of "
                         f"R·S={R * S}")
    return Ctrs // (R * S), NP


def col2im(dX, H, W, R, S, pt, pl_, bC, plain=False):
    """dX (C·R·S, N·H·W) -> (C, N·H·W): the adjoint of ``im2col``, on the
    card for a CUDA tensor (``plain=False``), else the plain version.  The
    kernel reads dX in the NC orientation by TMA: a dX that is the
    transposed view of a contiguous (N·H·W, C·R·S) array, as bsmm bprop
    gives it, is read in place; that array must start on a 16-byte
    boundary (raises otherwise)."""
    if plain or not dX.is_cuda:
        return col2im_plain(dX, H, W, R, S, pt, pl_, bC)
    C, NP = _dX_rows(dX, R, S)
    out = torch.empty((C, NP), dtype=dX.dtype, device=dX.device)
    return _col2im_cuda(dX, out, C, NP // (H * W), H, W, NP, H * W, R, S, pt,
                        pl_, bC)


def col2im_image(dX, N, H, W, R, S, pt, pl_, bC, plain=False):
    """The adjoint of ``im2col_image``: dX (C·R·S, N·H·W) -> the image's
    gradient, a contiguous (N, C, H, W), which the kernel writes in place
    (no transposing copy); else the plain version, as ``col2im``."""
    if plain or not dX.is_cuda:
        C = dX.shape[0] // (R * S)
        return col2im_plain(dX, H, W, R, S, pt, pl_, bC).reshape(
            C, N, H, W).transpose(0, 1).contiguous()
    C, _ = _dX_rows(dX, R, S)
    out = torch.empty((N, C, H, W), dtype=dX.dtype, device=dX.device)
    return _col2im_cuda(dX, out, C, N, H, W, H * W, C * H * W, R, S, pt, pl_,
                        bC)


def _im2col(x, H, W, R, S, pt, pl_, bC, plain, image):
    """im2col of the channel-major xc (C, N·H·W), or with ``image`` of the
    image x (N, C, H, W)."""
    if image:
        N, C = x.shape[:2]
        if plain or not x.is_cuda:
            return im2col_plain(x.transpose(0, 1).reshape(C, N * H * W), H, W,
                                R, S, pt, pl_, bC)
        x, sc, sn = _planes(x)
        return _im2col_cuda(x, C, N, H, W, sc, sn, R, S, pt, pl_, bC)
    if plain or not x.is_cuda:
        return im2col_plain(x, H, W, R, S, pt, pl_, bC)
    x = x.contiguous()
    C, NP = x.shape
    return _im2col_cuda(x, C, NP // (H * W), H, W, NP, H * W, R, S, pt, pl_,
                        bC)


class _Im2colFunction(torch.autograd.Function):
    """The JAX ``im2col`` custom_vjp: forward im2col, backward col2im (into
    the image's NCHW layout for ``im2col_image``)."""

    @staticmethod
    def forward(ctx, x, H, W, R, S, pt, pl_, bC, plain, image):
        ctx.args = (H, W, R, S, pt, pl_, bC, plain)
        ctx.N = x.shape[0] if image else None
        return _im2col(x, H, W, R, S, pt, pl_, bC, plain, image)

    @staticmethod
    def backward(ctx, dX):
        if ctx.N is None:
            dx = col2im(dX, *ctx.args)
        else:
            dx = col2im_image(dX, ctx.N, *ctx.args)
        return (dx,) + (None,) * 9


def im2col(xc, H, W, R, S, pt, pl_, bC, plain=False):
    """xc (C, N·H·W) channel-major -> (C·R·S, N·H·W) with row order
    (cb, tap, ci); differentiable in xc (its backward is ``col2im``).  On
    the card for a CUDA tensor (``plain=False``), else the plain version."""
    args = (xc, H, W, R, S, pt, pl_, bC, plain, False)
    if torch.is_grad_enabled() and xc.requires_grad:
        return _Im2colFunction.apply(*args)
    return _im2col(*args)


def im2col_image(x, R, S, pt, pl_, bC, plain=False):
    """x (N, C, H, W) -> (C·R·S, N·H·W), the same X as ``im2col`` of its
    channel-major copy, read from the image in place: any view whose H·W
    planes are contiguous (else it is copied to one).  Differentiable in x
    (its backward is ``col2im_image``, which writes an NCHW gradient).  On
    the card for a CUDA tensor (``plain=False``), else the plain version
    through the channel-major copy."""
    H, W = x.shape[2:]
    args = (x, H, W, R, S, pt, pl_, bC, plain, True)
    if torch.is_grad_enabled() and x.requires_grad:
        return _Im2colFunction.apply(*args)
    return _im2col(*args)


im2col.launches = 0
col2im.launches = 0
