"""im2col / col2im for the block-sparse conv: the CUDA kernels and their
plain versions.

``im2col`` replaces the TPU kernel ``im2col`` / ``_im2col_fwd_impl`` and
runs ``csrc/im2col.cu``; ``col2im`` replaces the TPU kernel ``col2im``
(``blocksparse_tpu/kernels/im2col.py``) and runs ``csrc/col2im_tma.cu``,
which reads dX by TMA tile loads in tiles of ``col2im_tile``'s shape.
im2col maps xc (C, N·H·W), channel-major, to
X (C·R·S, N·H·W) with row (cb·trs + tap)·bC + ci, where tap t = r·S + s
reads pixel (h + r − pt, w + s − pl), zero outside the image.  col2im is
its adjoint: each output element sums the trs taps that land on it, in
f32, in tap order, cast to dX's dtype once.

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


_P, _I = ctypes.c_void_p, ctypes.c_int


def _launch(fn, src, out, C, NP, H, W, R, S, pt, pl_, bC, source="im2col",
            extra=()):
    """Check the arguments and launch ``fn`` of ``csrc/<source>.cu`` from
    the contiguous ``src`` into ``out``; NP = N·H·W; the ints ``extra``
    after bC."""
    if not src.is_cuda:
        raise ValueError(f"{fn} launches a CUDA kernel: its input must be on "
                         f"a CUDA device")
    if src.dtype not in _DTYPE_CODE:
        raise TypeError(f"{fn} takes f32, bf16 or f16, got {src.dtype}")
    if bC not in BLOCK_SIZES or C % bC or NP % (H * W) \
            or not (0 <= pt < R and 0 <= pl_ < S):
        raise ValueError(f"{fn}: bC={bC} must be one of {BLOCK_SIZES} and "
                         f"divide C={C}, H·W={H * W} must divide N·H·W={NP}, "
                         f"and 0 <= pt < R, 0 <= pl < S (pt={pt}, pl={pl_}, "
                         f"R={R}, S={S})")
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream(src.device).cuda_stream
        err = _build.function(source, fn,
                              [_I, _P, _P] + [_I] * (9 + len(extra)) + [_P])(
            _DTYPE_CODE[src.dtype], src.data_ptr(), out.data_ptr(), C,
            NP // (H * W), H, W, R, S, pt, pl_, bC, *extra, stream)
    if err != 0:
        raise RuntimeError(f"{fn} launch failed: cudaError {err}")
    return out


def _im2col(xc, H, W, R, S, pt, pl_, bC, plain):
    if plain or not xc.is_cuda:
        return im2col_plain(xc, H, W, R, S, pt, pl_, bC)
    C, NP = xc.shape
    # the kernel writes X in the NC orientation the bsmm kernels read:
    # a contiguous (N·H·W, C·R·S) array, returned as its transposed view
    out = torch.empty((NP, C * R * S), dtype=xc.dtype, device=xc.device)
    _launch("im2col_fwd", xc.contiguous(), out, C, NP, H, W, R, S, pt, pl_,
            bC)
    im2col.launches += 1
    return out.t()


def col2im(dX, H, W, R, S, pt, pl_, bC, plain=False):
    """dX (C·R·S, N·H·W) -> (C, N·H·W): the adjoint of ``im2col``, on the
    card for a CUDA tensor (``plain=False``), else the plain version.  The
    kernel reads dX in the NC orientation by TMA: a dX that is the
    transposed view of a contiguous (N·H·W, C·R·S) array, as bsmm bprop
    gives it, is read in place; that array must start on a 16-byte
    boundary (raises otherwise)."""
    if plain or not dX.is_cuda:
        return col2im_plain(dX, H, W, R, S, pt, pl_, bC)
    Ctrs, NP = dX.shape
    if Ctrs % (R * S):
        raise ValueError(f"col2im: dX has {Ctrs} rows, not a multiple of "
                         f"R·S={R * S}")
    C = Ctrs // (R * S)
    src = dX.t().contiguous()
    if src.data_ptr() % 16:
        raise ValueError("col2im reads dX by TMA: its NC array must start "
                         "on a 16-byte boundary")
    out = torch.empty((C, NP), dtype=dX.dtype, device=dX.device)
    _launch("col2im_fwd", src, out, C, NP, H, W, R, S, pt, pl_, bC,
            source="col2im_tma", extra=col2im_tile(bC, dX.dtype, H, W))
    col2im.launches += 1
    return out


class _Im2colFunction(torch.autograd.Function):
    """The JAX ``im2col`` custom_vjp: forward im2col, backward col2im."""

    @staticmethod
    def forward(ctx, xc, H, W, R, S, pt, pl_, bC, plain):
        ctx.args = (H, W, R, S, pt, pl_, bC, plain)
        return _im2col(xc, H, W, R, S, pt, pl_, bC, plain)

    @staticmethod
    def backward(ctx, dX):
        return (col2im(dX, *ctx.args),) + (None,) * 8


def im2col(xc, H, W, R, S, pt, pl_, bC, plain=False):
    """xc (C, N·H·W) channel-major -> (C·R·S, N·H·W) with row order
    (cb, tap, ci); differentiable in xc (its backward is ``col2im``).  On
    the card for a CUDA tensor (``plain=False``), else the plain version."""
    if torch.is_grad_enabled() and xc.requires_grad:
        return _Im2colFunction.apply(xc, H, W, R, S, pt, pl_, bC, plain)
    return _im2col(xc, H, W, R, S, pt, pl_, bC, plain)


im2col.launches = 0
col2im.launches = 0
