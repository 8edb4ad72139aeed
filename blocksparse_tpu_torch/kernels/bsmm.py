"""Block-sparse matmul: the CUDA kernels and their plain versions.

``bsmm_fprop`` (y = x·W) and ``bsmm_bprop`` (dx = dy·Wᵀ) replace both
directions of the TPU kernels ``xprop_pallas_dense_tile``,
``xprop_pallas_grouped`` / ``xprop_pallas_grouped_panels`` and
``xprop_pallas`` (``blocksparse_tpu/kernels/bsmm.py``), which all compute
the product over the layout's LUT and differ only in how they tile the
TPU's MXU.  Both run ``csrc/bsmm_fprop.cu``, written natively for the NC
orientation (``feature_axis=1``, x of shape (N, C)): one thread block per
(N-tile, output block-column), a fixed-order f32 sum over the
block-column's LUT entries, no atomics; bprop reads each W block
transposed and walks the CSR of input block-columns.  ``bsmm_updat``
(dw[e] = x_cᵀ·dy_k summed over N, in f32) replaces
``updat_pallas_dense_tile`` and, for canonical weights,
``updat_pallas_grouped`` and ``updat_pallas``; it runs
``csrc/bsmm_updat.cu``.  On the H100 all three are bound by operations at
training shapes; see the sources for what the designs do about it.

``xprop_plain`` and ``updat_plain`` are the plain PyTorch versions, the
ports of ``xprop_xla`` and ``updat_xla`` (gather, einsum, ``index_add_``).
They are what runs for tensors on the CPU and what the kernels are held
against on the card.
"""
from __future__ import annotations

import ctypes

import torch

from blocksparse_tpu_torch.kernels import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
BLOCK_SIZES = (8, 16, 32, 64, 128)


def xprop_plain(x, w, in_blk, w_blk, out_blk, n_out_blocks, bsize, axis,
                trans_w=False, out_dtype=None):
    """Port of ``xprop_xla``: y[out] += x[in] · w (fprop) or x[in] · wᵀ
    (``trans_w``, bprop) for every LUT entry, in f32, cast to
    ``out_dtype`` (default x's).  in_blk/w_blk/out_blk: (nnz,) int64
    tensors on x's device."""
    out_dtype = out_dtype or x.dtype
    f32 = torch.float32
    wg = w[w_blk].to(f32)                             # (nnz, b, b)
    if axis == 0:
        C, N = x.shape
        xg = x.reshape(C // bsize, bsize, N)[in_blk].to(f32)
        eq = "ekn,eck->ecn" if trans_w else "ecn,eck->ekn"
        prod = torch.einsum(eq, xg, wg)
        out = torch.zeros((n_out_blocks, bsize, N), dtype=f32, device=x.device)
        out.index_add_(0, out_blk, prod)
        return out.reshape(n_out_blocks * bsize, N).to(out_dtype)
    N, C = x.shape
    xg = x.reshape(N, C // bsize, bsize)[:, in_blk].to(f32)
    eq = "nek,eck->nec" if trans_w else "nec,eck->nek"
    prod = torch.einsum(eq, xg, wg)
    out = torch.zeros((N, n_out_blocks, bsize), dtype=f32, device=x.device)
    out.index_add_(1, out_blk, prod)
    return out.reshape(N, n_out_blocks * bsize).to(out_dtype)


def updat_plain(x, dy, ent_c, ent_k, bsize, axis):
    """Port of ``updat_xla``: dw[e] = x_blk(c_e)ᵀ · dy_blk(k_e) summed over
    N, in f32, for every layout block.  ent_c/ent_k: (blocks,) int64
    tensors on x's device (the layout's updat_list)."""
    f32 = torch.float32
    if axis == 0:
        C, N = x.shape
        xb = x.reshape(C // bsize, bsize, N)[ent_c].to(f32)
        yb = dy.reshape(-1, bsize, N)[ent_k].to(f32)
        return torch.einsum("ecn,ekn->eck", xb, yb)
    N, C = x.shape
    xb = x.reshape(N, C // bsize, bsize)[:, ent_c].to(f32)
    yb = dy.reshape(N, -1, bsize)[:, ent_k].to(f32)
    return torch.einsum("nec,nek->eck", xb, yb)


_P, _I = ctypes.c_void_p, ctypes.c_int
_XPROP_ARGS = [_I, _I, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P]
_UPDAT_ARGS = [_I, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P]


def _check_common(fn, x, others, bsize):
    """Device, dtype and block-size checks shared by the three wrappers."""
    if not x.is_cuda:
        raise ValueError(f"{fn} launches a CUDA kernel: its input must be on "
                         f"a CUDA device")
    for name, t in others:
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, input on {x.device}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"{fn} takes f32, bf16 or f16, got {x.dtype}")
    if bsize not in BLOCK_SIZES:
        raise ValueError(f"unsupported block size {bsize}")
    for name, t in others:
        if name.startswith(("row_ptr", "ent_")) and (
                t.dtype != torch.int32 or not t.is_contiguous()):
            raise TypeError(f"{name} must be a contiguous int32 tensor")


def _xprop(fn, x, w, row_ptr, ent_in, ent_w, bsize, n_out_blocks, trans_w):
    _check_common(fn, x, (("w", w), ("row_ptr", row_ptr), ("ent_in", ent_in),
                          ("ent_w", ent_w)), bsize)
    if w.dtype != x.dtype:
        raise TypeError(f"{fn} takes x and w of one dtype, got {x.dtype} and "
                        f"{w.dtype}")
    if x.dim() != 2 or x.shape[1] % bsize:
        raise ValueError(f"x must be (N, C) with C a multiple of {bsize}, "
                         f"got {tuple(x.shape)}")
    if w.dim() != 3 or tuple(w.shape[1:]) != (bsize, bsize):
        raise ValueError(f"w must be (blocks, {bsize}, {bsize}), "
                         f"got {tuple(w.shape)}")
    if row_ptr.numel() != n_out_blocks + 1:
        raise ValueError("row_ptr must have n_out_blocks + 1 entries")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("x and w must be contiguous")
    N, C = x.shape
    K = n_out_blocks * bsize
    y = torch.empty((N, K), dtype=x.dtype, device=x.device)
    if N == 0:
        return y
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _build.function("bsmm_fprop", "bsmm_xprop_nc", _XPROP_ARGS)(
            _DTYPE_CODE[x.dtype], bsize, int(trans_w), x.data_ptr(),
            w.data_ptr(), row_ptr.data_ptr(), ent_in.data_ptr(),
            ent_w.data_ptr(), y.data_ptr(), N, C, K, stream)
    if err != 0:
        raise RuntimeError(f"{fn} launch failed: cudaError {err}")
    return y


def bsmm_fprop(x, w, row_ptr, ent_c, ent_w, bsize, n_out_blocks):
    """y (N, n_out_blocks*bsize) = x (N, C) · W over a CSR LUT, on the card.

    row_ptr (n_out_blocks+1,), ent_c, ent_w (nnz,): int32 CUDA tensors, the
    LUT entries of each output block-column in accumulation order.
    w: (blocks, bsize, bsize).  x and w: f32, bf16 or f16, same dtype,
    contiguous, on one CUDA device.  Raises on anything else."""
    y = _xprop("bsmm_fprop", x, w, row_ptr, ent_c, ent_w, bsize,
               n_out_blocks, trans_w=False)
    bsmm_fprop.launches += 1
    return y


def bsmm_bprop(dy, w, row_ptr, ent_k, ent_w, bsize, n_out_blocks):
    """dx (N, n_out_blocks*bsize) = dy (N, K) · Wᵀ over the bprop CSR (one
    row per input block-column c, entries (k, w) in accumulation order),
    on the card.  Same types and checks as ``bsmm_fprop``."""
    dx = _xprop("bsmm_bprop", dy, w, row_ptr, ent_k, ent_w, bsize,
                n_out_blocks, trans_w=True)
    bsmm_bprop.launches += 1
    return dx


def bsmm_updat(x, dy, ent_c, ent_k, bsize):
    """dw (blocks, bsize, bsize) f32 = x_cᵀ · dy_k per layout block, summed
    over N, on the card.  x (N, C), dy (N, K): contiguous, one dtype (f32,
    bf16 or f16); ent_c, ent_k: (blocks,) int32, the updat list.  One
    thread block per layout block sums all of N in a fixed order."""
    _check_common("bsmm_updat", x, (("dy", dy), ("ent_c", ent_c),
                                    ("ent_k", ent_k)), bsize)
    if dy.dtype != x.dtype:
        raise TypeError(f"bsmm_updat takes x and dy of one dtype, got "
                        f"{x.dtype} and {dy.dtype}")
    if x.dim() != 2 or dy.dim() != 2 or x.shape[0] != dy.shape[0] \
            or x.shape[1] % bsize or dy.shape[1] % bsize:
        raise ValueError(f"x (N, C) and dy (N, K) must share N with C, K "
                         f"multiples of {bsize}, got {tuple(x.shape)}, "
                         f"{tuple(dy.shape)}")
    if not (x.is_contiguous() and dy.is_contiguous()):
        raise ValueError("x and dy must be contiguous")
    if ent_c.numel() != ent_k.numel():
        raise ValueError("ent_c and ent_k must have one entry per block")
    (N, C), K, blocks = x.shape, dy.shape[1], ent_c.numel()
    dw = torch.empty((blocks, bsize, bsize), dtype=torch.float32,
                     device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _build.function("bsmm_updat", "bsmm_updat_nc", _UPDAT_ARGS)(
            _DTYPE_CODE[x.dtype], bsize, x.data_ptr(), dy.data_ptr(),
            ent_c.data_ptr(), ent_k.data_ptr(), dw.data_ptr(), N, C, K, blocks,
            stream)
    if err != 0:
        raise RuntimeError(f"bsmm_updat launch failed: cudaError {err}")
    bsmm_updat.launches += 1
    return dw


bsmm_fprop.launches = 0
bsmm_bprop.launches = 0
bsmm_updat.launches = 0
