"""Block-sparse convolution and deconvolution, edge bias, channel-wise
linear.

Counterpart of ``blocksparse_tpu/ops/conv.py``: the same BCK spec (a list
of blocks, each a tuple of input channels and a tuple of output
channels), the same shapes, filter layouts ((blocks, bK, bC, *TRS) when
every block has one shape, else the flat collapsed filter of ``sizeF``
elements), tap-tiled bsmm layout and NumPy goldens, so a conv and its
filter move between the two packages unchanged.  Data is NC[DHW].

Three lowerings for blocks of one shape, chosen by ``impl`` as in the JAX
package:

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
- ``impl="matmul"``: the tap-chunked gathered product (taps in chunks of
  ceil(128/bC), one batched f32 product a chunk), then the same sum over
  the output channels; XLA work in JAX, batched torch products here.

Ragged blocks (channel blocks of several shapes) take the grouped
lowering whatever ``impl`` says (``"bsmm"`` raises, as in JAX), every
block padded to (bKmax, bCmax): padded input entries read an appended
zero input channel, padded output entries sum into an appended junk
output channel, padded filter cells gather an appended zero weight.

``BlocksparseDeconv`` is the exact linear transpose of its conv's forward
(the conv's input gradient), differentiable in the filter and the input.
``l2_normalize`` (KCTRS rows of the conv, CKTRS columns of the deconv)
reduces ragged filters over the same zero-padded (blocks, bKmax, bCmax,
trs) view, a fixed-order sum with no scatter.  ``ConvEdgeBias`` (a gain
and bias a channel for each pattern of filter taps falling off the image
edge) and ``cwise_linear`` are plain torch.  The convolution's batch norms
are ``ops/norms.py``'s.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as nnf

from blocksparse_tpu_torch.kernels.im2col import (im2col_image,
                                                  im2col_supported)
from blocksparse_tpu_torch.ops.embed import embedding_lookup
from blocksparse_tpu_torch.ops.matmul import BlocksparseMatMul
from blocksparse_tpu_torch.utils import ceil_div, reduce_mul


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

    impl: "conv" (grouped torch convolution), "matmul" (tap-chunked
        gathered products) or "bsmm" (im2col + one tap-tiled block-sparse
        matmul: aligned square channel blocks of 8-128).  Ragged blocks
        take the grouped lowering.
    bsmm_impl: None runs the im2col, col2im and bsmm kernels on CUDA
        tensors; "xla" runs their plain versions on any device (the
        reference they are held against on the card).  CPU tensors always
        take the plain versions.
    """

    def __init__(self, BCK, TRS, DHW, MPQ=None, strides=(1, 1, 1),
                 dilates=(1, 1, 1), padding="SAME", debug=False,
                 deconv=False, impl="conv", bsmm_impl=None):
        if impl not in ("conv", "matmul", "bsmm"):
            raise ValueError(f"unknown impl {impl!r}")
        if bsmm_impl not in (None, "xla"):
            raise ValueError(f"unknown bsmm_impl {bsmm_impl!r}")
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

        if self.fixed_block_size:
            self._lutC = np.array([list(c) for c, _ in BCK], np.int32)
            self._lutK = np.array([list(k) for _, k in BCK], np.int32)
            self._flatK = self._lutK.reshape(-1)
            self._flatC = self._lutC.reshape(-1)

        # every block padded to (bKmax, bCmax) (fixed blocks: as they
        # are): padded C entries read an appended zero input channel,
        # padded K entries sum into an appended junk output channel, and
        # padded filter cells hold zeros (``_fmap_pad``: each padded
        # cell's element of the flat filter, sizeF where padded, the JAX
        # table; ``_elem_pos``: each element's cell, where ``_padded``
        # copies it).  ``_krows`` / ``_ccols``: the padded KCTRS rows
        # (block, k) / CKTRS columns (block, c) that hold a real one, in
        # the order of the l2 norms' gains.
        bKmax = max(len(k) for _, k in BCK)
        bCmax = max(len(c) for c, _ in BCK)
        self._bKmax, self._bCmax = bKmax, bCmax
        lutC = np.full((self.blocks, bCmax), self.C, np.int64)
        lutK = np.full((self.blocks, bKmax), self.K, np.int64)
        fmap = np.full((self.blocks, bKmax, bCmax, self.trs), self.sizeF,
                       np.int64)
        krow_ids, ccol_ids, krow, ccol = [], [], [], []
        offset = koff = coff = 0
        for b, (listC, listK) in enumerate(BCK):
            bC, bK = len(listC), len(listK)
            lutC[b, :bC] = listC
            lutK[b, :bK] = listK
            fmap[b, :bK, :bC, :] = np.arange(
                bK * bC * self.trs, dtype=np.int64).reshape(
                    bK, bC, self.trs) + offset
            offset += bK * bC * self.trs
            krow_ids.append(b * bKmax + np.arange(bK))
            ccol_ids.append(b * bCmax + np.arange(bC))
            # the JAX op's tables: each filter element's KCTRS row and
            # CKTRS column over the real lines
            krow.append(np.broadcast_to((koff + np.arange(bK))[
                :, None, None], (bK, bC, self.trs)).reshape(-1))
            ccol.append(np.broadcast_to((coff + np.arange(bC))[
                None, :, None], (bK, bC, self.trs)).reshape(-1))
            koff += bK
            coff += bC
        self._lutC_pad, self._lutK_pad, self._fmap_pad = lutC, lutK, fmap
        self._lutC_flat, self._lutK_flat = lutC.reshape(-1), lutK.reshape(-1)
        self._krow_of_elem = np.concatenate(krow).astype(np.int64)
        self._ccol_of_elem = np.concatenate(ccol).astype(np.int64)
        cells = fmap.reshape(-1)
        self._elem_pos = np.flatnonzero(cells < self.sizeF)[
            np.argsort(cells[cells < self.sizeF], kind="stable")]
        self._krows = np.concatenate(krow_ids)
        self._ccols = np.concatenate(ccol_ids)
        self._n_krows = len(self._krows)
        self._n_ccols = len(self._ccols)

        if impl == "bsmm":
            self._build_bsmm()

    # ---------------- shapes ----------------

    def i_shape(self, N):
        return [N, self.C] + self.DHW

    def o_shape(self, N):
        return [N, self.K] + self.MPQ

    def f_shape(self, block=None):
        if block is None:
            if not self.fixed_block_size:
                return [self.sizeF]
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
        if self.fixed_block_size and F.ndim >= 3:
            bK, bC = len(self.BCK[0][1]), len(self.BCK[0][0])
            return list(F.reshape((self.blocks, bK, bC) + tuple(self.TRS)))
        return self.expand_filter(F.reshape(-1))

    def _index(self, name, device):
        """A host index array as an int64 tensor on ``device``, uploaded
        once."""
        t = self._dev.get((name, device))
        if t is None:
            t = torch.as_tensor(np.asarray(getattr(self, name), np.int64),
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
            # (C, N, D, H, W), padded
            Ipad = nnf.pad(I.transpose(0, 1), self._tap_pads())
            X = torch.stack([
                self._tap(Ipad, t, r, s).reshape(self.C // bC, bC, N * npix)
                for t in range(T) for r in range(R) for s in range(S)],
                1)                               # (CB, trs, bC, N*npix)
        X = X.reshape(self.C * self.trs, N * npix)
        Fb = F.reshape(self.blocks, bC, bC, self.trs)
        W = Fb[self._index("_bsmm_wb", F.device), :, :,
               self._index("_bsmm_wt", F.device)].transpose(1, 2)  # (w, c, k)
        y = self._bsmm_op(X, W.to(X.dtype))      # (K, N*npix)
        y = y.reshape(self.K, N, M, P, Q).transpose(0, 1)
        return y.to(I.dtype)

    def _conv_fwd_matmul(self, F, I):
        """The tap-chunked gathered product (blocks of one shape): the
        channels gathered into block order once, each tap a strided slice
        of the padded input, the taps in chunks of ceil(128/bC) (a
        contraction of at least 128), one batched f32 product a chunk,
        then the f32 sum over the output channels (overlapping K sets add
        up)."""
        N = I.shape[0]
        bK, bC = len(self.BCK[0][1]), len(self.BCK[0][0])
        B = self.blocks
        T, R, S = self.TRS
        M, P, Q = self.MPQ
        Fb = F.reshape(B, bK, bC, T, R, S).float()
        Ig = I.index_select(1, self._index("_flatC", I.device)).reshape(
            [N, B * bC] + self.DHW)
        Ipad = nnf.pad(Ig, self._tap_pads())
        taps = [(t, r, s) for t in range(T) for r in range(R)
                for s in range(S)]
        chunk = max(1, -(-128 // bC))
        npix = M * P * Q
        y = torch.zeros((N, B, bK, npix), dtype=torch.float32,
                        device=I.device)
        for i in range(0, len(taps), chunk):
            grp = taps[i:i + chunk]
            xc = torch.cat([self._tap(Ipad, t, r, s).reshape(N, B, bC, npix)
                            for t, r, s in grp], 2).float()
            fc = torch.cat([Fb[:, :, :, t, r, s] for t, r, s in grp], 2)
            y = y + torch.einsum("bkc,nbcp->nbkp", fc, xc)
        out = torch.zeros((N, self.K, npix), dtype=torch.float32,
                          device=I.device)
        out.index_add_(1, self._index("_flatK", I.device),
                       y.reshape(N, B * bK, npix))
        return out.reshape([N, self.K] + self.MPQ).to(I.dtype)

    def _tap_pads(self):
        """``nnf.pad``'s pads (last dim first) that keep every tap's strided
        window in bounds."""
        pads = []
        for i in (2, 1, 0):
            need = (self.MPQ[i] - 1) * self.strides[i] \
                + (self.TRS[i] - 1) * self.dilates[i] + 1
            pads += [self.padding[i],
                     max(need - self.DHW[i] - self.padding[i],
                         self.padding[i])]
        return pads

    def _tap(self, Ipad, t, r, s):
        """Tap (t, r, s)'s strided window of the padded input: (..., M, P,
        Q)."""
        (M, P, Q), st, dil = self.MPQ, self.strides, self.dilates
        return Ipad[..., t * dil[0]:t * dil[0] + (M - 1) * st[0] + 1:st[0],
                    r * dil[1]:r * dil[1] + (P - 1) * st[1] + 1:st[1],
                    s * dil[2]:s * dil[2] + (Q - 1) * st[2] + 1:st[2]]

    def _conv_fwd(self, F, I):
        """I: (N, C, D, H, W); returns (N, K, M, P, Q)."""
        if self.fixed_block_size and self.impl == "matmul":
            return self._conv_fwd_matmul(F, I)
        if self.fixed_block_size and self.impl == "bsmm":
            return self._conv_fwd_bsmm(F, I)
        N = I.shape[0]
        rank = self.spatial_rank
        lead = 3 - rank                          # leading unit spatial dims
        if self.fixed_block_size:
            bK, bC = len(self.BCK[0][1]), len(self.BCK[0][0])
            Fb = F.to(I.dtype).reshape(
                [self.blocks * bK, bC] + self.TRS[lead:])
            Ig = I.index_select(1, self._index("_flatC", I.device))
            k_idx, K_out = self._index("_flatK", I.device), self.K
        else:
            # the padded uniform blocks, whole
            bK, bC = self._bKmax, self._bCmax
            Fb = self._padded(F).to(I.dtype).reshape(
                [self.blocks * bK, bC] + self.TRS[lead:])
            Ie = torch.cat([I, I.new_zeros((N, 1) + tuple(I.shape[2:]))], 1)
            Ig = Ie.index_select(1, self._index("_lutC_flat", I.device))
            k_idx, K_out = self._index("_lutK_flat", I.device), self.K + 1
        Ig = Ig.reshape([N, self.blocks * bC] + self.DHW[lead:])
        conv = (nnf.conv1d, nnf.conv2d, nnf.conv3d)[rank - 1]
        out = conv(Ig, Fb, stride=self.strides[lead:],
                   padding=self.padding[lead:],
                   dilation=self.dilates[lead:], groups=self.blocks)
        y = torch.zeros([N, K_out] + self.MPQ[lead:], dtype=torch.float32,
                        device=I.device)
        y.index_add_(1, k_idx, out.float())
        return y[:, :self.K].reshape([N, self.K] + self.MPQ).to(I.dtype)

    def _padded(self, F):
        """The flat filter as the zero-padded (blocks, bKmax, bCmax, trs)
        view: each element copied into its cell (a copy, whose gradient
        is a gather: no sum)."""
        Ff = F.reshape(-1)
        pos = self._index("_elem_pos", F.device)
        return Ff.new_zeros(self._fmap_pad.size).index_copy(0, pos, Ff) \
            .reshape(self._fmap_pad.shape)

    def _flat(self, F):
        """A filter given as a list of blocks, as one flat tensor."""
        if isinstance(F, (list, tuple)):
            return torch.cat([torch.as_tensor(f).reshape(-1) for f in F])
        return F

    def __call__(self, F, I):
        """y (N, K, M, P, Q) = the conv of I (N, C, ...) with the filter F
        (any shape holding ``f_shape()``'s elements, or a list of blocks);
        differentiable in both."""
        if I.shape[1] != self.C:
            raise ValueError(f"I must be (N, {self.C}, ...), got "
                             f"{tuple(I.shape)}")
        I3 = I.reshape((I.shape[0], self.C) + tuple(self.DHW))
        return self._conv_fwd(self._flat(F), I3)

    # ---------------- l2 norm (per output-channel row over C,T,R,S) ----

    def l2_normalize(self, F, gain=None, epsilon=1e-12, dtype=None):
        """Per output-channel-row L2 norm over (bC, T, R, S), KCTRS.  Blocks
        of one shape reduce with one reshape; ragged blocks (or a filter
        given as a list) over the zero-padded (blocks, bKmax, bCmax, trs)
        view in a fixed order, the flat filter returned."""
        if self.fixed_block_size and not isinstance(F, (list, tuple)):
            bK = len(self.BCK[0][1])
            Fb = F.reshape(self.blocks, bK, -1).float()
            norm = torch.sqrt(torch.clamp(
                Fb.square().sum(2, keepdim=True), min=epsilon))
            out = Fb / norm
            if gain is not None:
                out = out * gain.reshape(self.blocks, bK, 1).float()
            return out.reshape(F.shape).to(dtype or F.dtype)
        return self._l2_normalize_padded(F, (2, 3), "_krows", gain, epsilon,
                                         dtype)

    def _l2_normalize_padded(self, F, dims, lines, gain, epsilon, dtype):
        """The ragged l2 norm: each line's sum of squares over ``dims`` of
        the zero-padded (blocks, bKmax, bCmax, trs) view, then each cell
        times its line's 1/norm (and gain), the real cells read back in
        the flat filter's order.  ``lines``: the padded lines that hold a
        real one, in the gains' order.  Sums in a fixed order, no
        scatter-add either way."""
        Ff = self._flat(F).reshape(-1)
        out_dtype = dtype or Ff.dtype
        pad = self._padded(Ff.float())
        scale = 1.0 / torch.sqrt(torch.clamp(
            pad.square().sum(dims, keepdim=True), min=epsilon))
        if gain is not None:
            g = torch.ones(scale.numel(), device=Ff.device).index_copy(
                0, self._index(lines, Ff.device), gain.reshape(-1).float())
            scale = scale * g.reshape(scale.shape)
        return (pad * scale).reshape(-1)[
            self._index("_elem_pos", Ff.device)].to(out_dtype)

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

    def l2_normalize_test(self, F, gain=None, epsilon=1e-12):
        normF = []
        if gain is None:
            for blockF in F:
                norm = np.sqrt(np.maximum(np.sum(
                    np.square(blockF), axis=(1, 2, 3, 4), keepdims=True),
                    epsilon))
                normF.append(blockF / norm)
        else:
            offsetK = 0
            for blockF in F:
                blockK = blockF.shape[0]
                g = gain[offsetK:offsetK + blockK].reshape(
                    (blockK, 1, 1, 1, 1))
                norm = np.sqrt(np.maximum(np.sum(
                    np.square(blockF), axis=(1, 2, 3, 4), keepdims=True),
                    epsilon))
                normF.append(g * blockF / norm)
                offsetK += blockK
        return self.collapse_filter(normF, dtype=np.float32)


class _Transpose(torch.autograd.Function):
    """y = A(F)ᵀ·I, the transpose of the conv's forward x -> A(F)·x: the
    conv's input gradient with output gradient I.  Backward: dI = A(F)·dy
    (the conv's forward of dy), dF = the conv's filter gradient with image
    dy and output gradient I.  Each is the VJP of the conv's forward, which
    is linear in either argument, taken at zeros."""

    @staticmethod
    def forward(ctx, F, I, conv):
        ctx.save_for_backward(F, I)
        ctx.conv = conv
        return conv._input_grad(F, I)

    @staticmethod
    def backward(ctx, dy):
        F, I = ctx.saved_tensors
        conv = ctx.conv
        dF = dI = None
        if ctx.needs_input_grad[1]:
            dI = conv._conv_fwd(F, dy)
        if ctx.needs_input_grad[0]:
            F0 = torch.zeros_like(F, requires_grad=True)
            with torch.enable_grad():
                dF, = torch.autograd.grad(conv._conv_fwd(F0, dy), F0, I)
        return dF, dI, None


class BlocksparseDeconv(BlocksparseConv):
    """Reference conv.py:728: the exact linear transpose of the conv."""

    def __init__(self, BCK, TRS, DHW, MPQ=None, strides=(1, 1, 1),
                 dilates=(1, 1, 1), padding="SAME", debug=False):
        BKC = [[listK, listC] for listC, listK in BCK]
        if MPQ is None:
            d = len(TRS)
            std = list(strides)[-d:]
            dil = list(dilates)[-d:]
            pad = get_padding(padding, list(TRS), dil)
            pad = pad[-d:]
            MPQ = [in_dim(*dims)
                   for dims in zip(TRS, DHW, pad, std, dil)]
        super().__init__(BKC, TRS, MPQ, DHW, strides, dilates, padding,
                         debug, True)

    def i_shape(self, N):
        return [N, self.K] + self.MPQ

    def o_shape(self, N):
        return [N, self.C] + self.DHW

    def fprop_test(self, F, I, alpha=1.0):
        return super().bprop_test(F, I, alpha)

    def bprop_test(self, F, I, alpha=1.0):
        return super().fprop_test(F, I, alpha)

    def updat_test(self, E, I, alpha=1.0):
        return super().updat_test(I, E, alpha, transpose=True)

    def _input_grad(self, F, I):
        """The underlying conv's input gradient for output gradient I."""
        x0 = torch.zeros([I.shape[0], self.C] + self.DHW, dtype=I.dtype,
                         device=I.device, requires_grad=True)
        with torch.enable_grad():
            out, = torch.autograd.grad(self._conv_fwd(F.detach(), x0), x0,
                                       I)
        return out

    def __call__(self, F, I):
        """y (N, C, D, H, W) from I (N, K, M, P, Q): the transpose of the
        underlying conv's forward, linear in I; differentiable in F and
        I."""
        if I.shape[1] != self.K:
            raise ValueError(f"I must be (N, {self.K}, ...), got "
                             f"{tuple(I.shape)}")
        I3 = I.reshape((I.shape[0], self.K) + tuple(self.MPQ))
        return _Transpose.apply(self._flat(F), I3, self)

    def l2_normalize_test(self, F, gain=None, epsilon=1e-12):
        normF = []
        if gain is None:
            for blockF in F:
                norm = np.sqrt(np.maximum(np.sum(
                    np.square(blockF), axis=(0, 2, 3, 4), keepdims=True),
                    epsilon))
                normF.append(blockF / norm)
        else:
            offsetK = 0
            for blockF in F:
                blockK = blockF.shape[1]
                g = gain[offsetK:offsetK + blockK].reshape(
                    (1, blockK, 1, 1, 1))
                norm = np.sqrt(np.maximum(np.sum(
                    np.square(blockF), axis=(0, 2, 3, 4), keepdims=True),
                    epsilon))
                normF.append(g * blockF / norm)
                offsetK += blockK
        return self.collapse_filter(normF, dtype=np.float32)

    def l2_normalize(self, F, gain=None, epsilon=1e-12, dtype=None):
        """Per input-channel-column L2 norm over (bK, T, R, S), CKTRS.
        Ragged blocks (or a list) over the zero-padded view, as the
        conv's."""
        if self.fixed_block_size and not isinstance(F, (list, tuple)):
            bK, bC = len(self.BCK[0][1]), len(self.BCK[0][0])
            Fb = F.reshape(self.blocks, bK, bC, -1).float()
            norm = torch.sqrt(torch.clamp(
                Fb.square().sum((1, 3), keepdim=True), min=epsilon))
            out = Fb / norm
            if gain is not None:
                out = out * gain.reshape(self.blocks, 1, bC, 1).float()
            return out.reshape(F.shape).to(dtype or F.dtype)
        return self._l2_normalize_padded(F, (1, 3), "_ccols", gain, epsilon,
                                         dtype)


# ------------------------------------------------------------------
# ConvEdgeBias (reference conv.py:55-225)
# ------------------------------------------------------------------

def conv_edge_bias_init(y_shape, x_shape, w_shape, strides=None,
                        padding="SAME", data_format="NHWC", dilations=None):
    y_shape = list(getattr(y_shape, "shape", y_shape))
    x_shape = list(getattr(x_shape, "shape", x_shape))
    w_shape = list(getattr(w_shape, "shape", w_shape))
    return ConvEdgeBias(y_shape, x_shape, w_shape, strides, padding,
                        data_format, dilations)


def deconv_edge_bias_init(y_shape, x_shape, w_shape, strides=None,
                          padding="SAME", data_format="NHWC", dilations=None):
    y_shape = list(getattr(y_shape, "shape", y_shape))
    x_shape = list(getattr(x_shape, "shape", x_shape))
    w_shape = list(getattr(w_shape, "shape", w_shape))
    return ConvEdgeBias(x_shape, y_shape, w_shape, strides, padding,
                        data_format, dilations, deconv=True)


class ConvEdgeBias:
    """Learned gain+bias per unique filter/image-edge overlap pattern.

    Output pixels are hashed by which filter taps fall off the image
    edge; each unique pattern gets one (gain, bias) pair per channel:
    (E, K) in NHWC, (K, E) in NCHW.  The pattern maps are built once per
    geometry and kept in the class-level ``Cache``.  The gains and biases
    are gathered by pixel through ``embedding_lookup``, whose backward
    sums a pattern's pixels in a fixed order."""

    Cache = dict()

    def __init__(self, y_shape, x_shape, w_shape, strides=None,
                 padding="SAME", data_format="NHWC", dilations=None,
                 deconv=False):
        if data_format in ("NCW", "NCHW", "NCDHW"):
            self.layout = 0
            sdim = slice(2, None)
            fdim = slice(0, -2)   # RSCK (tf filter layout)
            cdim = 1
        else:
            self.layout = 1
            sdim = slice(1, -1)
            fdim = slice(0, -2)
            cdim = -1

        C = x_shape[cdim]
        K = y_shape[cdim]
        MPQ = expand_dims(y_shape[sdim])
        DHW = expand_dims(x_shape[sdim])
        TRS = expand_dims(w_shape[fdim])

        strides = (1, 1, 1) if strides is None else expand_dims(strides[sdim])
        dilates = (1, 1, 1) if dilations is None \
            else expand_dims(dilations[sdim])

        if isinstance(padding, str) and padding.upper() == "VALID":
            padding = (0, 0, 0)
        else:
            padding = []
            for S, Q, W, stride, dilate in zip(TRS, MPQ, DHW, strides,
                                               dilates):
                padding.append(max((Q - 1) * stride + S - W, 0) // 2)

        if deconv:
            lut_func = bprop_lut
            MPQ, DHW = DHW, MPQ
            C, K = K, C
        else:
            lut_func = fprop_lut

        key = tuple(tuple(a) for a in (MPQ, DHW, TRS, padding, strides,
                                       dilates))
        entry = ConvEdgeBias.Cache.get(key)
        if entry is None:
            mpqLut = []
            fdata = list(zip(TRS, padding, strides, dilates))
            for i in range(3):
                mpqLut.append([lut_func(d, DHW[i], *fdata[i])
                               for d in range(MPQ[i])])
            self._build_edge_lut(MPQ, mpqLut)
            ConvEdgeBias.Cache[key] = (self.edgeBiasMap, self.pattern_map,
                                       self.edgeBiasDim)
        else:
            self.edgeBiasMap, self.pattern_map, self.edgeBiasDim = entry

        self.K = K
        self.shape = (self.edgeBiasDim, K) if self.layout \
            else (K, self.edgeBiasDim)
        self._pm = {}

    def _build_edge_lut(self, MPQ, mpqLut):
        PQ = MPQ[1] * MPQ[2]
        Q = MPQ[2]
        edge_map = {}
        mLut, pLut, qLut = mpqLut
        for m, p, q in np.ndindex(*MPQ):
            pat = []
            for di, d in enumerate(mLut[m]):
                for hi, h in enumerate(pLut[p]):
                    for wi, w in enumerate(qLut[q]):
                        if any(v == -1 for v in (d, h, w)):
                            pat.append((di, hi, wi))
            if pat:
                edge_map.setdefault(tuple(pat), []).append(
                    m * PQ + p * Q + q)

        self.edgeBiasDim = len(edge_map)
        # stable ordering by first pixel (reference conv.py:149)
        self.edgeBiasMap = sorted(edge_map.values(), key=lambda v: v[0])
        # pixel -> pattern-id map; non-edge pixels get id edgeBiasDim
        mpq_total = int(np.prod(MPQ))
        pattern_map = np.full(mpq_total, self.edgeBiasDim, np.int32)
        for i, pix in enumerate(self.edgeBiasMap):
            pattern_map[pix] = i
        self.pattern_map = pattern_map

    def __call__(self, x, g, b, inference=False, bench=0, name=None):
        """y = x · gain + bias of each pixel's pattern (non-edge pixels as
        they are), in x's dtype."""
        if not self.edgeBiasDim:
            return x
        pm = self._pm.get(x.device)
        if pm is None:
            pm = self._pm[x.device] = torch.as_tensor(
                self.pattern_map.astype(np.int64), device=x.device)
        K = self.K
        shape = x.shape
        if self.layout:  # NHWC: g/b shaped (E, K)
            g_ext = torch.cat([g, g.new_ones((1, K))], 0)
            b_ext = torch.cat([b, b.new_zeros((1, K))], 0)
            xr = x.reshape(shape[0], -1, K)
            y = xr * embedding_lookup(g_ext, pm)[None] \
                + embedding_lookup(b_ext, pm)[None]
        else:            # NCHW: g/b shaped (K, E)
            g_ext = torch.cat([g, g.new_ones((K, 1))], 1)
            b_ext = torch.cat([b, b.new_zeros((K, 1))], 1)
            xr = x.reshape(shape[0], K, -1)
            y = xr * embedding_lookup(g_ext.t(), pm).t()[None] \
                + embedding_lookup(b_ext.t(), pm).t()[None]
        return y.reshape(shape).to(x.dtype)

    # ---------------- goldens (reference conv.py:163-214) ----------

    def edge_bias_test(self, x, g, b):
        if not self.edgeBiasDim:
            return x
        if self.layout:
            N = x.shape[0]
            K = x.shape[-1]
            y = np.array(x.reshape(N, -1, K))
            for i in range(self.edgeBiasDim):
                y[:, self.edgeBiasMap[i], :] = \
                    y[:, self.edgeBiasMap[i], :] * g[i].reshape(1, 1, K) \
                    + b[i].reshape(1, 1, K)
            return y.reshape(x.shape)
        else:
            N, K = x.shape[0:2]
            y = np.array(x.reshape(N, K, -1))
            for i in range(self.edgeBiasDim):
                y[:, :, self.edgeBiasMap[i]] = \
                    y[:, :, self.edgeBiasMap[i]] * g[:, i].reshape(1, K, 1) \
                    + b[:, i].reshape(1, K, 1)
            return y.reshape(x.shape)

    def edge_bias_grad_test(self, dy, x, g):
        if not self.edgeBiasDim:
            return dy, None, None
        lut = self.edgeBiasMap
        dy_shape = dy.shape
        if self.layout:
            N = dy_shape[0]
            K = dy_shape[-1]
            x = x.reshape(N, -1, K)
            dy = dy.reshape(N, -1, K)
            dx = np.array(dy)
            dg = np.empty(self.shape, dtype=np.float32)
            db = np.empty(self.shape, dtype=np.float32)
            for i in range(self.edgeBiasDim):
                dx[:, lut[i], :] *= g[i].reshape(1, 1, K)
                dg[i] = (dy[:, lut[i], :] * x[:, lut[i], :]).sum(axis=(0, 1))
                db[i] = dy[:, lut[i], :].sum(axis=(0, 1))
        else:
            N, K = dy_shape[0:2]
            x = x.reshape(N, K, -1)
            dy = dy.reshape(N, K, -1)
            dx = np.array(dy)
            dg = np.empty(self.shape, dtype=np.float32)
            db = np.empty(self.shape, dtype=np.float32)
            for i in range(self.edgeBiasDim):
                dx[:, :, lut[i]] *= g[:, i].reshape(1, K, 1)
                dg[:, i] = (dy[:, :, lut[i]] * x[:, :, lut[i]]) \
                    .sum(axis=(0, 2))
                db[:, i] = dy[:, :, lut[i]].sum(axis=(0, 2))
        return dx.reshape(dy_shape), dg, db


# ------------------------------------------------------------------
# Channel-wise linear (reference conv.py:906-998)
# ------------------------------------------------------------------

def cwise_linear(x, gain=None, bias=None, relu=False, bias_first=False,
                 use_tf=False):
    """y = relu(a*x + b) (or (x+b)*a with bias_first) with per-channel
    a, b broadcast over NC[DHW]'s channel dim."""
    if gain is None and bias is None:
        raise ValueError("cwise_linear needs a gain or a bias")
    bcast = [1] * x.ndim
    bcast[1] = x.shape[1]
    y = x
    if bias_first:
        if bias is not None:
            y = y + bias.reshape(bcast)
        if gain is not None:
            y = y * gain.reshape(bcast)
    else:
        if gain is not None:
            y = y * gain.reshape(bcast)
        if bias is not None:
            y = y + bias.reshape(bcast)
    return torch.relu(y) if relu else y


def cwise_linear_test(x, a=1, b=0, relu=False):
    bcast = list(x.shape)
    for i in range(len(bcast)):
        if i != 1:
            bcast[i] = 1
    if not np.isscalar(a):
        a = a.reshape(bcast)
    if not np.isscalar(b):
        b = b.reshape(bcast)
    y = a * x + b
    if relu:
        y = np.maximum(y, 0.0)
    return y


def cwise_linear_grad_test(dy, x, a=1, b=0, relu=False):
    bcast = list(dy.shape)
    axis = []
    for i in range(len(bcast)):
        if i != 1:
            bcast[i] = 1
            axis.append(i)
    axis = tuple(axis)
    if not np.isscalar(a):
        a = a.reshape(bcast)
    if not np.isscalar(b):
        b = b.reshape(bcast)
    if relu:
        dy = dy * (a * x + b > 0.0)
    dx = a * dy
    da = np.sum(dy * x, axis=axis)
    db = np.sum(dy, axis=axis)
    return dx, da, db
