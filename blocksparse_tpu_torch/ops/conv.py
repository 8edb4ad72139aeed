"""Block-sparse convolution with fixed block sizes, forward and backward.

Counterpart of ``BlocksparseConv`` in ``blocksparse_tpu/ops/conv.py``: the
same BCK spec (a list of blocks, each a tuple of input channels and a
tuple of output channels), the same shapes, filter layout
(blocks, bK, bC, *TRS), tap-tiled bsmm layout and NumPy goldens, so a conv
and its filter move between the two packages unchanged.  Data is
NC[DHW].

Two lowerings, chosen by ``impl`` as in the JAX package:

- ``impl="bsmm"``: ``im2col`` lifts the image to X (C·trs, N·MPQ),
  reading the NCHW image in place (``im2col_image``), and
  ONE tap-tiled ``BlocksparseMatMul`` (feature_axis 0) does every FLOP.
  Its backward is bprop -> ``col2im`` for dI and updat for dF.  On CUDA
  tensors these are the hand-written kernels (``kernels/im2col.py``,
  ``kernels/bsmm.py``); on CPU tensors, or with ``bsmm_impl="xla"``,
  their plain versions.  Strided, dilated and 3-D convs, which the im2col
  kernel does not cover, build X from plain tap slices instead, chosen by
  shape.
- ``impl="conv"`` (the default): a grouped torch convolution over the
  gathered channel blocks and an f32 ``index_add_`` over the output
  channels (overlapping K sets add up).  The JAX package leaves this
  lowering to XLA's convolutions; here it is torch's.

Not ported yet (ROADMAP §1, "The rest of the conv"): ragged blocks,
``impl="matmul"``, ``BlocksparseDeconv``, ``l2_normalize``,
``ConvEdgeBias``, ``cwise_linear`` and the batch norms.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as nnf

from blocksparse_tpu_torch.kernels.im2col import (im2col_image,
                                                  im2col_supported)
from blocksparse_tpu_torch.ops.matmul import BlocksparseMatMul
from blocksparse_tpu_torch.utils import ceil_div, reduce_mul

_NOT_PORTED = "is not ported yet (ROADMAP §1, \"The rest of the conv\")"


# ---------------- helpers (parity: reference conv.py:1001-1094) --------

def dilation_size(S, dilate):
    return S * dilate - dilate + 1


def out_dim(S, W, padding, stride, dilate):
    return ceil_div(W - dilation_size(S, dilate) + 1 + 2 * padding, stride)


def in_dim(S, W, padding, stride, dilate):
    return W * stride + S - 2 * padding - (S & 1)


def expand_dims(dim, pad_val=1):
    return [pad_val] * (3 - len(dim)) + list(dim)


def get_padding(padding, TRS, dilates):
    if isinstance(padding, str):
        if padding.upper() == "SAME":
            padding = [dilation_size(*dims) // 2 for dims in zip(TRS, dilates)]
        else:
            padding = [0, 0, 0]
    else:
        padding = expand_dims(padding, 0)
    return padding


def fprop_lut(q, X, S, padding, stride, dilate):
    qs = q * stride - padding
    image = []
    for s in range(S):
        x = qs + s * dilate
        image.append(x if 0 <= x < X else -1)
    return image


def bprop_lut(x, Q, S, padding, stride, dilate):
    pad_eff = dilation_size(S, dilate) - padding - 1
    xs = x - pad_eff
    image = []
    for s in range(S - 1, -1, -1):
        q = xs + s * dilate
        if q % stride == 0:
            q //= stride
            image.append(q if 0 <= q < Q else -1)
        else:
            image.append(-2)
    return image


def fprop_slice(q, X, S, padding, stride, dilate):
    qs = q * stride - padding
    x1 = None
    for s in range(S):
        x = qs + s * dilate
        if x1 is None and x >= 0:
            x1 = x
            f1 = s
        if x < X:
            x2 = x
            f2 = s
    return (slice(f1, f2 + 1), slice(x1, x2 + 1, dilate), f2 - f1 + 1)


def bprop_slice(x, Q, S, padding, stride, dilate):
    pad_eff = dilation_size(S, dilate) - padding - 1
    xs = x - pad_eff
    f, e = [], []
    for s in range(S):
        q = xs + s * dilate
        if q % stride == 0:
            q //= stride
            if 0 <= q < Q:
                f.append(s)
                e.append(q)
    if len(f) == 0:
        return (slice(0, 0, 1), slice(0, 0, 1))
    if len(f) == 1:
        fstride = estride = 1
    else:
        fstride = f[1] - f[0]
        estride = e[1] - e[0]
    return (slice(f[0], f[-1] + 1, fstride), slice(e[0], e[-1] + 1, estride))


class BlocksparseConv:
    """Reference conv.py:228.  BCK: per-block channel lists
    ((c...), (k...)); TRS/DHW/MPQ spatial dims (1-3d); NC[DHW] data.

    impl: "conv" (grouped torch convolution) or "bsmm" (im2col + one
        tap-tiled block-sparse matmul: aligned square channel blocks of
        8-128).  "matmul" raises ``NotImplementedError``.
    bsmm_impl: None runs the im2col, col2im and bsmm kernels on CUDA
        tensors; "xla" runs their plain versions on any device (the
        reference they are held against on the card).  CPU tensors always
        take the plain versions.
    """

    def __init__(self, BCK, TRS, DHW, MPQ=None, strides=(1, 1, 1),
                 dilates=(1, 1, 1), padding="SAME", debug=False,
                 deconv=False, impl="conv", bsmm_impl=None):
        if impl == "matmul":
            raise NotImplementedError(f"impl='matmul' {_NOT_PORTED}")
        if impl not in ("conv", "bsmm"):
            raise ValueError(f"unknown impl {impl!r}")
        if bsmm_impl not in (None, "xla"):
            raise ValueError(f"unknown bsmm_impl {bsmm_impl!r}")
        if deconv:
            raise NotImplementedError(f"BlocksparseDeconv {_NOT_PORTED}")
        self.impl = impl
        self.bsmm_impl = bsmm_impl
        self.userTRS = list(TRS)
        for a in (TRS, DHW, MPQ, strides, dilates, padding):
            if type(a) in (tuple, list):
                assert 1 <= len(a) <= 3
        assert len(TRS) == len(DHW)

        self.spatial_rank = len(TRS)
        TRS = expand_dims(TRS)
        DHW = expand_dims(DHW)
        strides = expand_dims(strides)
        dilates = expand_dims(dilates)
        padding = get_padding(padding, TRS, dilates)
        if MPQ is None:
            MPQ = [out_dim(*dims)
                   for dims in zip(TRS, DHW, padding, strides, dilates)]
        else:
            MPQ = expand_dims(MPQ)

        cSet, kSet = set(), set()
        overlapC = overlapK = False
        blkSizes = set()
        sizeF = 0
        for listC, listK in BCK:
            for c in listC:
                if c in cSet:
                    overlapC = True
                cSet.add(c)
            for k in listK:
                if k in kSet:
                    overlapK = True
                kSet.add(k)
            blkSizes.add((len(listK), len(listC)))
            sizeF += len(listK) * len(listC) * reduce_mul(TRS)

        self.C = len(cSet)
        self.K = len(kSet)
        self.fixed_block_size = len(blkSizes) == 1
        self.overlapC = overlapC
        self.overlapK = overlapK
        self.BCK = BCK
        self.blocks = len(BCK)
        self.TRS = TRS
        self.DHW = DHW
        self.MPQ = MPQ
        self.sizeF = sizeF
        self.strides = strides
        self.dilates = dilates
        self.padding = padding
        self.trs = reduce_mul(TRS)
        self.flops = sizeF * reduce_mul(MPQ) * 2
        self.debug = bool(debug)
        self.mpqSlice = None
        self.deconv = deconv
        self._bsmm_op = None
        self._dev = {}

        if not self.fixed_block_size:
            raise NotImplementedError(
                f"ragged blocks (channel blocks of several sizes) "
                f"{_NOT_PORTED}")
        self._lutC = np.array([list(c) for c, _ in BCK], np.int32)
        self._lutK = np.array([list(k) for _, k in BCK], np.int32)
        self._flatK = self._lutK.reshape(-1)
        self._flatC = self._lutC.reshape(-1)

        # per-element row ids for the l2 norms: KCTRS rows are
        # (block, k-row) over (bC, trs); CKTRS cols are (block, c-col)
        # over (bK, trs)
        krow, ccol = [], []
        self._n_krows = sum(len(k) for _, k in BCK)
        self._n_ccols = sum(len(c) for c, _ in BCK)
        koff = coff = 0
        for listC, listK in BCK:
            bC, bK = len(listC), len(listK)
            kr = (koff + np.arange(bK, dtype=np.int64))[:, None, None]
            krow.append(np.broadcast_to(
                kr, (bK, bC, self.trs)).reshape(-1))
            cc = (coff + np.arange(bC, dtype=np.int64))[None, :, None]
            ccol.append(np.broadcast_to(
                cc, (bK, bC, self.trs)).reshape(-1))
            koff += bK
            coff += bC
        self._krow_of_elem = np.concatenate(krow)
        self._ccol_of_elem = np.concatenate(ccol)

        if impl == "bsmm":
            self._build_bsmm()

    # ---------------- shapes ----------------

    def i_shape(self, N):
        return [N, self.C] + self.DHW

    def o_shape(self, N):
        return [N, self.K] + self.MPQ

    def f_shape(self, block=None):
        if block is None:
            lutC, lutK = self.BCK[0]
            return [self.blocks, len(lutK), len(lutC)] + self.userTRS
        lutC, lutK = self.BCK[block]
        return [len(lutK), len(lutC)] + self.userTRS

    def collapse_filter(self, F, dtype=None):
        flatF = np.empty(self.sizeF, dtype=dtype)
        offset = 0
        for f in F:
            flatF[offset:offset + f.size] = f.reshape(-1).astype(dtype)
            offset += f.size
        return flatF

    def expand_filter(self, flatF):
        """Inverse of collapse_filter -> list of (bK, bC, T, R, S) blocks."""
        blocks = []
        offset = 0
        for b in range(self.blocks):
            lutC, lutK = self.BCK[b]
            shape = (len(lutK), len(lutC)) + tuple(self.TRS)
            size = int(np.prod(shape))
            blocks.append(flatF[offset:offset + size].reshape(shape))
            offset += size
        return blocks

    def _f_blocks(self, F):
        """Normalize filter input to a list of 5-D (bK,bC,T,R,S) blocks."""
        if isinstance(F, (list, tuple)):
            return [torch.as_tensor(f).reshape(self.f_shape(i)[:2]
                                               + list(self.TRS))
                    for i, f in enumerate(F)]
        F = torch.as_tensor(F)
        if F.ndim >= 3:
            bK, bC = len(self.BCK[0][1]), len(self.BCK[0][0])
            return list(F.reshape((self.blocks, bK, bC) + tuple(self.TRS)))
        return self.expand_filter(F.reshape(-1))

    def _index(self, name, device):
        """A host index array as an int64 tensor on ``device``, uploaded
        once."""
        t = self._dev.get((name, device))
        if t is None:
            t = torch.as_tensor(getattr(self, name).astype(np.int64),
                                device=device)
            self._dev[(name, device)] = t
        return t

    # ---------------- forward ----------------

    def _build_bsmm(self):
        """Build the tap-tiled BlocksparseMatMul behind impl='bsmm'.

        The conv's channel connectivity (bC x bK blocks over C x K) is
        lifted to a (CB*trs, KB) block layout: each filter tap tiles the
        layout along the contraction axis, so block row cb*trs + tap
        covers input features [cb*trs*b + tap*b, +b).  The whole conv
        then runs as ONE block-sparse matmul with contraction depth
        C*trs and N = batch * MPQ pixels."""
        bK, bC = len(self.BCK[0][1]), len(self.BCK[0][0])
        if not self.fixed_block_size or bC != bK or \
                bC not in (8, 16, 32, 64, 128) or \
                self.C % bC or self.K % bC:
            raise ValueError(
                "impl='bsmm' requires fixed square channel blocks of "
                "size 8/16/32/64/128 dividing C and K (got bC=%d bK=%d "
                "C=%d K=%d)" % (bC, bK, self.C, self.K))
        CB, KB = self.C // bC, self.K // bC
        layout = np.zeros((CB * self.trs, KB), np.int32)
        block_of = {}
        for b, (listC, listK) in enumerate(self.BCK):
            c0, k0 = listC[0], listK[0]
            if (c0 % bC or k0 % bC
                    or list(listC) != list(range(c0, c0 + bC))
                    or list(listK) != list(range(k0, k0 + bC))):
                raise ValueError(
                    "impl='bsmm' requires aligned contiguous channel "
                    "blocks (block %d spans C%s K%s)"
                    % (b, listC[:2], listK[:2]))
            cb, kb = c0 // bC, k0 // bC
            if (cb, kb) in block_of:
                raise ValueError(
                    "impl='bsmm' requires unique (cb, kb) blocks")
            block_of[(cb, kb)] = b
            layout[cb * self.trs:(cb + 1) * self.trs, kb] = 1
        op = BlocksparseMatMul(layout, block_size=bC, feature_axis=0,
                               impl=self.bsmm_impl)
        wb = np.empty(op.blocks, np.int32)
        wt = np.empty(op.blocks, np.int32)
        for w, (c, k) in enumerate(op.updat_list):
            wb[w] = block_of[(c // self.trs, k)]
            wt[w] = c % self.trs
        self._bsmm_op = op
        self._bsmm_wb = wb
        self._bsmm_wt = wt

    def _conv_fwd_bsmm(self, F, I):
        """im2col + tap-tiled block-sparse matmul.

        X's rows are (cb, tap, ci), matching the tiled layout of
        :meth:`_build_bsmm`.  2-D SAME-family convs build X with the
        im2col kernel from the image in place (its backward, col2im,
        writes dI in NCHW); the rest stack strided, dilated tap slices of
        the padded input in plain torch."""
        N = I.shape[0]
        bC = self._bsmm_op.bsize
        T, R, S = self.TRS
        M, P, Q = self.MPQ
        st, dil, pd = self.strides, self.dilates, self.padding
        npix = M * P * Q
        if im2col_supported(self.TRS, self.DHW, self.MPQ, list(st),
                            list(dil), list(pd), self.C, bC):
            # the image itself, read in place (its backward writes dI in
            # NCHW): no channel-major copy either way; squeeze, a view
            # both ways (a select's backward would copy dI into zeros)
            X = im2col_image(I.squeeze(2), R, S, int(pd[1]), int(pd[2]), bC,
                             plain=self.bsmm_impl == "xla")
        else:
            Ic = I.transpose(0, 1)               # (C, N, D, H, W)
            # pad so every tap's strided window stays in bounds
            pads = []
            for i in (2, 1, 0):
                need = (self.MPQ[i] - 1) * st[i] \
                    + (self.TRS[i] - 1) * dil[i] + 1
                pads += [pd[i], max(need - self.DHW[i] - pd[i], pd[i])]
            Ipad = nnf.pad(Ic, pads)
            xs = []
            for t in range(T):
                for r in range(R):
                    for s in range(S):
                        sl = Ipad[:, :,
                                  t * dil[0]:t * dil[0] + (M - 1) * st[0] + 1:st[0],
                                  r * dil[1]:r * dil[1] + (P - 1) * st[1] + 1:st[1],
                                  s * dil[2]:s * dil[2] + (Q - 1) * st[2] + 1:st[2]]
                        xs.append(sl.reshape(self.C // bC, bC, N * npix))
            X = torch.stack(xs, 1)               # (CB, trs, bC, N*npix)
        X = X.reshape(self.C * self.trs, N * npix)
        Fb = F.reshape(self.blocks, bC, bC, self.trs)
        W = Fb[self._index("_bsmm_wb", F.device), :, :,
               self._index("_bsmm_wt", F.device)].transpose(1, 2)  # (w, c, k)
        y = self._bsmm_op(X, W.to(X.dtype))      # (K, N*npix)
        y = y.reshape(self.K, N, M, P, Q).transpose(0, 1)
        return y.to(I.dtype)

    def _conv_fwd(self, F, I):
        """I: (N, C, D, H, W); returns (N, K, M, P, Q)."""
        if self.impl == "bsmm":
            return self._conv_fwd_bsmm(F, I)
        N = I.shape[0]
        bK, bC = len(self.BCK[0][1]), len(self.BCK[0][0])
        rank = self.spatial_rank
        lead = 3 - rank                          # leading unit spatial dims
        Fb = F.to(I.dtype).reshape(
            [self.blocks * bK, bC] + self.TRS[lead:])
        Ig = I.index_select(1, self._index("_flatC", I.device)).reshape(
            [N, self.blocks * bC] + self.DHW[lead:])
        conv = (nnf.conv1d, nnf.conv2d, nnf.conv3d)[rank - 1]
        out = conv(Ig, Fb, stride=self.strides[lead:],
                   padding=self.padding[lead:],
                   dilation=self.dilates[lead:], groups=self.blocks)
        y = torch.zeros([N, self.K] + self.MPQ[lead:], dtype=torch.float32,
                        device=I.device)
        y.index_add_(1, self._index("_flatK", I.device), out.float())
        return y.reshape(self.o_shape(N)).to(I.dtype)

    def __call__(self, F, I):
        """y (N, K, M, P, Q) = the conv of I (N, C, ...) with the filter F
        (any shape holding ``f_shape()``'s elements); differentiable in
        both."""
        if I.shape[1] != self.C:
            raise ValueError(f"I must be (N, {self.C}, ...), got "
                             f"{tuple(I.shape)}")
        I3 = I.reshape((I.shape[0], self.C) + tuple(self.DHW))
        return self._conv_fwd(F, I3)

    # ---------------- NumPy goldens (reference conv.py:540-661) --------

    def init_slices(self):
        if self.mpqSlice is None:
            self.mpqSlice = []
            self.dhwSlice = []
            fdata = list(zip(self.TRS, self.padding, self.strides,
                             self.dilates))
            for i in range(3):
                self.mpqSlice.append(
                    [fprop_slice(x, self.DHW[i], *fdata[i])
                     for x in range(self.MPQ[i])])
                self.dhwSlice.append(
                    [bprop_slice(x, self.MPQ[i], *fdata[i])
                     for x in range(self.DHW[i])])

    def fprop_test(self, F, I, alpha=1.0):
        self.init_slices()
        N = I.shape[0]
        O = np.zeros([N, self.K] + self.MPQ)
        mSlice, pSlice, qSlice = self.mpqSlice
        for block in range(self.blocks):
            blockF = F[block]
            blockK = blockF.shape[0]
            lutC, lutK = self.BCK[block]
            for m, p, q in np.ndindex(*self.MPQ):
                sliceT, sliceD, _ = mSlice[m]
                sliceR, sliceH, _ = pSlice[p]
                sliceS, sliceW, _ = qSlice[q]
                slicedF = blockF[:, :, sliceT, sliceR, sliceS] \
                    .reshape((blockK, -1))
                slicedI = I[:, lutC][:, :, sliceD, sliceH, sliceW] \
                    .reshape((N, -1))
                O[:, lutK, m, p, q] += np.dot(slicedI, slicedF.T) * alpha
        return O

    def bprop_test(self, F, I, alpha=1.0):
        self.init_slices()
        N = I.shape[0]
        O = np.zeros([N, self.C] + self.DHW)
        dSlice, hSlice, wSlice = self.dhwSlice
        for block in range(self.blocks):
            blockF = np.transpose(F[block][:, :, ::-1, ::-1, ::-1],
                                  (1, 0, 2, 3, 4)).copy()
            blockC = blockF.shape[0]
            lutC, lutK = self.BCK[block]
            for d, h, w in np.ndindex(*self.DHW):
                sliceT, sliceM = dSlice[d]
                sliceR, sliceP = hSlice[h]
                sliceS, sliceQ = wSlice[w]
                slicedF = blockF[:, :, sliceT, sliceR, sliceS] \
                    .reshape((blockC, -1))
                slicedI = I[:, lutK][:, :, sliceM, sliceP, sliceQ] \
                    .reshape((N, -1))
                O[:, lutC, d, h, w] += np.dot(slicedI, slicedF.T) * alpha
        return O

    def updat_test(self, E, I, alpha=1.0, transpose=False):
        self.init_slices()
        U = []
        N = I.shape[0]
        mSlice, pSlice, qSlice = self.mpqSlice
        for block in range(self.blocks):
            lutC, lutK = self.BCK[block]
            dimF = self.f_shape(block)
            dimF = [dimF[0], dimF[1]] + self.TRS
            blockU = np.zeros(dimF)
            U.append(blockU)
            for m, p, q in np.ndindex(*self.MPQ):
                sliceT, sliceD, tlen = mSlice[m]
                sliceR, sliceH, rlen = pSlice[p]
                sliceS, sliceW, slen = qSlice[q]
                slicedI = I[:, lutC][:, :, sliceD, sliceH, sliceW] \
                    .reshape(N, -1)
                slicedE = E[:, lutK, m, p, q]
                blockU[:, :, sliceT, sliceR, sliceS] += np.dot(
                    slicedE.T, slicedI).reshape(
                        (dimF[0], dimF[1], tlen, rlen, slen)) * alpha
        return self.collapse_filter(U, dtype=np.float32)
