"""Block-sparse transformer attention (training, serving and KV-cached
decode), the unfused block-sparse ops, the dense softmax family and the
softmax cross-entropy loss.

Counterpart of ``blocksparse_tpu/ops/transformer.py``: the same layout
LUTs (``nt_list``/``nn_list``/``tn_list``), bit-packed and dense masks,
NumPy goldens and pickling, and the public (batch, ctx, heads·hs) layout
at ``attention`` and ``decode_step``.

``attention`` takes the fused route where the head size is at most 128
(``use_fused=None``, as the JAX package's ``_can_fuse``) or where
``use_fused=True``: the fused CUDA kernels (``kernels/bst_attn.py``) on
CUDA tensors and their plain masked per-block versions on CPU tensors,
both on the kernels' view of the layout (block size 8 seen at 16, head
sizes zero-padded up to 128).  With a gradient to take it is a
``torch.autograd.Function``, the counterpart of ``_attention_fused``:
with ``flash_bwd=True`` the training forward saves the log-sum-exp and
the backward runs dq over the query-row CSR and dk/dv over the key-row
CSR; with ``flash_bwd=False`` the backward is that of the unfused ops.
Without a gradient it runs the serving forward.  Past a head size of 128
(or with ``use_fused=False``) it runs the unfused ops, as the JAX package
does: ``nt_op`` (the scores), the blocked ``masked_softmax`` and
``nn_op``.  ``nt_op``, ``nn_op`` and ``tn_op`` are autograd functions
wired as the reference's (each one's backward is the other two) over the
CUDA kernels of ``kernels/bst_trio.py`` on CUDA tensors and their plain
versions on CPU tensors.  ``impl="xla"`` makes an op plain on every
device: the trio's plain versions and, on the fused route, the plain
version at the op's own block size.  The blocked softmaxes,
``decode_step``, the dense softmax family and ``softmax_cross_entropy``
are plain PyTorch, as the JAX package leaves them to XLA.
"""
from __future__ import annotations

import numpy as np
import torch

from blocksparse_tpu_torch.kernels import bst_attn, bst_trio

_NEG_MAX = -np.finfo(np.float32).max
_IMPLS = (None, "xla", "pallas")


def sparse_coo_to_dense(coords, nq, nk):
    a = np.zeros((nq, nk), np.int32)
    for (q, k) in coords:
        a[q, k] = 1
    return a


def _can_fuse(hs):
    """The fused kernels take head sizes up to 128 (the JAX package's
    ``_can_fuse``); past it ``attention`` runs the unfused ops."""
    return hs <= bst_attn.HEAD_SIZES[-1]


class BlocksparseTransformer:

    def __getstate__(self):
        # the layouts and masks determine the state; device tables are
        # rebuilt at first use
        return {"layout": np.stack([sparse_coo_to_dense(
                    self.nt_list[h], self.ctx_blks_q, self.ctx_blks_k)
                    for h in range(self.lut_heads)]),
                "block_size": self.blk_size,
                "heads": self.heads,
                "mask_blocks": self._mask_blocks,
                "name": self.name,
                "impl": self.impl,
                "q_mult": self.q_mult}

    def __setstate__(self, state):
        mask_blocks = state["mask_blocks"]
        cb = None
        if mask_blocks is not None:
            def cb(blk_shape, head, qry, key, blk):
                return np.asarray(mask_blocks[head][blk])
        self.__init__(state["layout"], state["block_size"], state["heads"],
                      cb, state["name"], state.get("impl"),
                      state.get("q_mult"))

    def __init__(self, layout, block_size=64, heads=None, mask_callback=None,
                 name=None, impl=None, q_mult=None):
        """layout: (ctx_blks_q, ctx_blks_k) shared by all heads (then
        ``heads`` is required) or (lut_heads, ctx_blks_q, ctx_blks_k).
        mask_callback(blk_shape, head, qry, key, blk) -> bool block.
        impl: None (or "pallas") runs the CUDA kernels on CUDA tensors and
        their plain versions on CPU tensors; "xla" runs the plain versions
        on every device, the reference the kernels are held against.
        q_mult is the TPU kernel's row pairing, accepted for the same
        call signature; it changes no result."""
        if impl not in _IMPLS:
            raise ValueError(f"impl must be one of {_IMPLS}, got {impl!r}")
        self.impl = impl
        self.q_mult = q_mult
        layout = np.asarray(layout)
        if layout.ndim == 2:
            if heads is None:
                raise ValueError("heads must be explicitly specified when "
                                 "using shared layouts per head")
            layout = np.expand_dims(layout, 0)
        if heads is None:
            heads = layout.shape[0]
        if block_size not in (8, 16, 32, 64):
            raise ValueError("Block sizes of 8, 16, 32 and 64 currently "
                             "supported")
        if layout.ndim != 3:
            raise ValueError("bad layout shape: " + str(layout.shape))

        self.blk_size = block_size
        self.name = name
        self.heads = heads
        self.lut_heads = layout.shape[0]
        self.ctx_blks_q = layout.shape[1]
        self.ctx_blks_k = layout.shape[2]
        self.blk_shape = (block_size, block_size)
        self.nn_max = 0
        self.tn_max = 0
        layout = layout.astype(np.int32)

        self.nt_lut = []
        self.nn_lut = []
        self.tn_lut = []
        self.nt_list = []
        self.nn_list = []
        self.tn_list = []
        blocks = None
        for head in range(layout.shape[0]):
            ys, xs = np.nonzero(layout[head])
            if blocks is None:
                blocks = len(ys)
            elif len(ys) != blocks:
                raise ValueError("number of layout blocks must be equal "
                                 "across heads")
            # blocks contiguous along the rows
            nt_list = sorted(zip(ys.tolist(), xs.tolist()))
            ys = [b[0] for b in nt_list]
            xs = [b[1] for b in nt_list]
            nn_lut, nn_list, nn_max = self.xn_lut(ys, xs, blocks,
                                                  self.ctx_blks_q)
            tn_lut, tn_list, tn_max = self.xn_lut(xs, ys, blocks,
                                                  self.ctx_blks_k)
            self.nt_lut.append(np.array(nt_list, dtype=np.int32))
            self.nn_lut.append(nn_lut)
            self.tn_lut.append(tn_lut)
            self.nt_list.append(nt_list)
            self.nn_list.append(nn_list)
            self.tn_list.append(tn_list)
            self.nn_max = max(self.nn_max, nn_max)
            self.tn_max = max(self.tn_max, tn_max)

        self.blocks = blocks
        self.nt_lut = np.array(self.nt_lut, dtype=np.int32)
        self._q_blk = self.nt_lut[:, :, 0]          # (lut_heads, blocks)
        self._k_blk = self.nt_lut[:, :, 1]

        if mask_callback is not None:
            self.init_softmax_mask(mask_callback)
        else:
            self.softmax_mask = None
            self.softmax_mask_np = None
            self._mask_blocks = None
        self._decode_tables = None
        self._dev_tables = {}

    # ------------- LUT building ----------------

    def xn_lut(self, ys, xs, blocks, ctx_blks):
        py_lut = [list() for _ in range(ctx_blks)]
        for b in range(blocks):
            py_lut[ys[b]].append((b, xs[b]))
        max_lut = 0
        offset = ctx_blks
        np_lut = np.empty((offset + blocks, 2), dtype=np.int32)
        for i, lut in enumerate(py_lut):
            np_lut[i] = offset, len(lut)
            max_lut = max(max_lut, len(lut))
            for entry in lut:
                np_lut[offset] = entry
                offset += 1
        return np_lut, py_lut, max_lut

    def init_softmax_mask(self, mask_callback):
        dtype = {64: np.uint64, 32: np.uint32, 16: np.uint16}.get(
            self.blk_size, np.uint8)
        masks = []
        dense = []
        for h in range(self.lut_heads):
            head_mask = []
            head_dense = []
            for b, (q, k) in enumerate(self.nt_list[h]):
                mask = mask_callback(self.blk_shape, h, q, k, b)
                bits = np.packbits(mask.reshape(-1, 8)[:, ::-1]).view(dtype)
                head_mask.append(bits)
                head_dense.append(mask.astype(bool))
            masks.append(head_mask)
            dense.append(head_dense)
        # (heads, blocks, blk_size) bit-packed rows, and kernel order
        self.softmax_mask_np = np.array(masks, dtype=dtype)
        self.softmax_mask = np.transpose(
            self.softmax_mask_np, [0, 2, 1]).copy()
        self._mask_blocks = np.array(dense, dtype=bool)

    def block_coord(self, block, head=0):
        return self.nt_list[head][block]

    def mask_codes(self, transposed=False):
        """(codes (lut_heads, blocks), uniq table) of the fused kernels'
        per-entry masks; codes are None when there is no mask.  With
        ``transposed`` the codes and table of the transposed mask blocks,
        which the key-row (dk/dv) kernel reads: TRIL and TRIU swap and
        each unique block is transposed (``build_attn_schedule_tn``)."""
        if self._mask_blocks is None:
            return None, np.zeros(self.blk_shape, np.int8)
        mb = self._mask_blocks
        if transposed:
            mb = np.ascontiguousarray(np.transpose(mb, (0, 1, 3, 2)))
        return bst_attn.classify_mask_blocks(mb, self.blk_size)

    # ------------- shape plumbing ----------------

    def _split_heads(self, a, ctx_blks):
        """(batch, ctx, state) -> (batch, heads, ctx_blks, bs, hs)"""
        batch, ctx, state = a.shape
        bs = self.blk_size
        if ctx != ctx_blks * bs:
            raise ValueError((tuple(a.shape), ctx_blks, bs))
        hs = state // self.heads
        return a.reshape(batch, ctx_blks, bs, self.heads, hs) \
            .permute(0, 3, 1, 2, 4)

    def _tables(self, device):
        """The layout's tables on ``device``, uploaded once: those of the
        kernels' view of the layout (``bst_attn.kernel_view``: block size
        8 seen at 16, other sizes as they are) from
        ``bst_attn.kernel_tables``, its block size and padded contexts
        (``kbs``, ``kctx_q``, ``kctx_k``; the view's plain-version block
        indices and masks as ``kq_blk``, ``kk_blk``, ``kmask``); the plain
        versions' block indices and dense masks at this op's own block
        size; the unfused ops' CSRs (``bst_trio.trio_tables``, as
        ``tri_<name>``) and each query row's blocks padded to one length
        (``row_blocks``, for the blocked softmax's row sums); and the
        decode tables (so a decode step copies
        nothing from the host, which would stall the stream, and a CUDA
        graph can capture the ops)."""
        tab = self._dev_tables.get(device)
        if tab is None:
            tab = fused_tables(self.nt_list, self._mask_blocks,
                               self.blk_size, self.ctx_blks_q,
                               self.ctx_blks_k, device)
            kblk, bid, cnt = self.decode_tables
            in_row = np.arange(kblk.shape[2])[None, None] < cnt[:, :, None]

            def t(a, dt):
                return torch.as_tensor(a, dtype=dt, device=device)
            i32, i64 = torch.int32, torch.int64
            tab.update({
                "dec_kblk": t(kblk, i64),
                "dec_bid": t(bid, i64),
                "dec_in_row": t(in_row, torch.bool),
                "arange_bs": t(np.arange(self.blk_size), i64),
                "heads_lut": t(np.arange(self.lut_heads)[:, None], i64)})
            tri = bst_trio.trio_tables(self.nt_list, self.ctx_blks_q,
                                       self.ctx_blks_k)
            tab.update({f"tri_{name}": t(a, i32) for name, a in tri.items()})
            tab["row_blocks"] = t(_row_blocks(self._q_blk, self.ctx_blks_q),
                                  i64)
            self._dev_tables[device] = tab
        return tab

    # ------------- the unfused ops ----------------

    def nt_op(self, a, b, name=None, bench=0):
        """scores[n, h, blk] = a_blk · b_blkᵀ (dense x dense -> sparse):
        (batch, heads, blocks, bs, bs) in a's dtype, from a (batch, ctx_q,
        heads·hs) and b (batch, ctx_k, heads·hs).  Differentiable: db =
        tn(dw, a), da = nn(dw, b)."""
        return _NT.apply(a, b, self)

    query_key_op = nt_op

    def nn_op(self, a, b, name=None, bench=0):
        """y = Σ over each query row's blocks of w_blk · v_blk (sparse x
        dense -> dense): a (batch, heads, blocks, bs, bs), b (batch, ctx_k,
        heads·hs) -> (batch, ctx_q, heads·hs) in b's dtype.
        Differentiable: db = tn(a, dy), da = nt(dy, b)."""
        return _NN.apply(a, b, self)

    weight_value_op = nn_op

    def tn_op(self, a, b, name=None, bench=0):
        """y = Σ over each key row's blocks of w_blkᵀ · x_blk (the
        gradient op): a (batch, heads, blocks, bs, bs), b (batch, ctx_q,
        heads·hs) -> (batch, ctx_k, heads·hs) in b's dtype.
        Differentiable: db = nn(a, dy), da = nt(b, dy)."""
        return _TN.apply(a, b, self)

    # ------------- blocked softmax ----------------

    def _softmax_imp(self, x, scale, mask):
        """x: (batch, heads, blocks, bs, bs) -> the softmax over each query
        row's visible keys (all blocks of its block-row, in-block columns),
        in f32, cast to x's dtype.  Hidden scores take -finfo(f32).max, so
        a row that sees no key spreads evenly over its blocks.  Plain
        torch, differentiable through autograd; the row max is a constant
        of the gradient, as the shift cancels.  The row sums, forward and
        backward, add each row's blocks in block order (``_RowSum``): no
        atomics, so a step gives the same bits eager and captured."""
        tab = self._tables(x.device)
        batch, heads, blocks, bs, _ = x.shape
        xs = x.float() * scale
        if mask is not None:
            xs = torch.where(mask, xs, _NEG_MAX)
        idx = tab["q_blk"].expand(heads, -1)[None, :, :, None].expand(
            batch, heads, blocks, bs)
        rows = (batch, heads, self.ctx_blks_q, bs)
        m = torch.full(rows, float("-inf"), device=x.device).scatter_reduce(
            2, idx, xs.detach().amax(-1), "amax")
        e = torch.exp(xs - m.gather(2, idx)[..., None])
        s = _RowSum.apply(e.sum(-1), tab["row_blocks"], tab["q_blk"])
        s = _RowBroadcast.apply(s, tab["row_blocks"], tab["q_blk"])
        return (e / s[..., None]).to(x.dtype)

    def masked_softmax(self, x, scale=1.0, autoregress_at_key=None,
                       dtype=None):
        """The blocked softmax of the scores x (batch, heads, blocks, bs,
        bs) under the op's masks, scaled by ``scale``.  With
        ``autoregress_at_key`` (an int or a device tensor of one element)
        a key k of query q stays visible only if k < max(key, q + 1)
        (the reference's bst_partial_autoregressive_mask).  Without masks
        it is ``softmax``."""
        if self.softmax_mask_np is None:
            if autoregress_at_key is not None:
                raise ValueError("autoregress_at_key only applies to ops "
                                 "with mask_callback defined.")
            return self.softmax(x, scale, dtype)
        tab = self._tables(x.device)
        mask = tab["mask"][None]            # (1, lut_heads, blocks, bs, bs)
        if autoregress_at_key is not None:
            bs, ar = self.blk_size, tab["arange_bs"]
            q_glob = tab["q_blk"][:, :, None, None] * bs + ar[:, None]
            k_glob = tab["k_blk"][:, :, None, None] * bs + ar
            if isinstance(autoregress_at_key, torch.Tensor):
                front = torch.maximum(q_glob + 1, autoregress_at_key.to(
                    device=x.device, dtype=torch.int64).reshape(()))
            else:
                front = torch.clamp(q_glob + 1, min=int(autoregress_at_key))
            mask = mask & (k_glob < front)[None]
        out = self._softmax_imp(x, scale, mask)
        return out if dtype is None else out.to(dtype)

    def softmax(self, x, scale=1.0, dtype=None):
        out = self._softmax_imp(x, scale, None)
        return out if dtype is None else out.to(dtype)

    # ------------- NumPy goldens ----------------

    def nt_test(self, A, B):
        shapeA = list(A.shape)
        shapeB = list(B.shape)
        shapeA[1:] = [self.ctx_blks_q, self.blk_size, self.heads,
                      shapeA[2] // self.heads]
        shapeB[1:] = [self.ctx_blks_k, self.blk_size, self.heads,
                      shapeB[2] // self.heads]
        batch_size = shapeA[0]
        A = A.reshape(shapeA)
        B = B.reshape(shapeB)
        C = np.empty([batch_size, self.heads, self.blocks, self.blk_size,
                      self.blk_size], dtype=np.float32)
        for n in range(batch_size):
            for h in range(self.heads):
                lut_head = h if self.lut_heads > 1 else 0
                for b, (y, x) in enumerate(self.nt_list[lut_head]):
                    C[n, h, b] = np.dot(A[n, y, :, h, :], B[n, x, :, h, :].T)
        return C

    def nn_test(self, A, B):
        shapeB = list(B.shape)
        state_size = shapeB[2]
        shapeB[1:] = [self.ctx_blks_k, self.blk_size, self.heads,
                      state_size // self.heads]
        shapeC = list(shapeB)
        shapeC[1:] = [self.ctx_blks_q, self.blk_size, self.heads,
                      state_size // self.heads]
        batch_size = shapeC[0]
        B = B.reshape(shapeB)
        C = np.zeros(shapeC, dtype=np.float32)
        for n in range(batch_size):
            for h in range(self.heads):
                lut_head = h if self.lut_heads > 1 else 0
                for x, lut in enumerate(self.nn_list[lut_head]):
                    for b, y in lut:
                        C[n, x, :, h, :] += np.dot(A[n, h, b],
                                                   B[n, y, :, h, :])
        return C.reshape([batch_size, self.ctx_blks_q * self.blk_size,
                          state_size])

    def tn_test(self, A, B):
        shapeB = list(B.shape)
        state_size = shapeB[2]
        shapeB[1:] = [self.ctx_blks_q, self.blk_size, self.heads,
                      state_size // self.heads]
        shapeC = list(shapeB)
        shapeC[1:] = [self.ctx_blks_k, self.blk_size, self.heads,
                      state_size // self.heads]
        batch_size = shapeC[0]
        B = B.reshape(shapeB)
        C = np.zeros(shapeC, dtype=np.float32)
        for n in range(batch_size):
            for h in range(self.heads):
                lut_head = h if self.lut_heads > 1 else 0
                for x, lut in enumerate(self.tn_list[lut_head]):
                    for b, y in lut:
                        C[n, x, :, h, :] += np.dot(A[n, h, b].T,
                                                   B[n, y, :, h, :])
        return C.reshape([batch_size, self.ctx_blks_k * self.blk_size,
                          state_size])

    def masked_softmax_test(self, x, scale=1.0, autoregress_at_key=None):
        y = np.empty_like(x)
        m = self.softmax_mask_np
        bsize = self.blk_size
        ones = (1 << bsize) - 1
        for n in range(x.shape[0]):
            for h in range(x.shape[1]):
                hl = h if self.lut_heads > 1 else 0
                for lut in self.nn_list[hl]:
                    xm = np.full((len(lut), bsize * bsize), _NEG_MAX,
                                 dtype=np.float32)
                    for i, (b, k) in enumerate(lut):
                        xb = x[n, h, b].reshape(-1)
                        if m is None:
                            xm[i, :] = xb * scale
                        else:
                            mask = m[hl, b, :]
                            if autoregress_at_key is not None:
                                Q = self.nt_list[hl][b][0] * bsize
                                K = k * bsize
                                new_mask = np.empty(bsize, dtype=mask.dtype)
                                for q in range(bsize):
                                    shift_a = bsize - min(max(
                                        autoregress_at_key - K, 0), bsize)
                                    shift_b = min(max(
                                        bsize - 1 + K - (Q + q), 0), bsize)
                                    shift_c = int(min(shift_a, shift_b))
                                    new_mask[q] = int(mask[q]) \
                                        & (ones >> shift_c)
                                mask = new_mask
                            mask = np.unpackbits(
                                mask.view(np.uint8)).reshape(-1, 8)[:, ::-1] \
                                .reshape(-1)
                            nzIdx = np.nonzero(mask)
                            xm[i, nzIdx] = xb[nzIdx] * scale
                    xm = xm.reshape((len(lut), bsize, bsize))
                    xm = np.exp(xm - np.max(xm, axis=(0, 2), keepdims=True))
                    ym = xm / np.sum(xm, axis=(0, 2), keepdims=True)
                    for i, (b, k) in enumerate(lut):
                        y[n, h, b] = ym[i]
        return y

    def masked_softmax_grad_test(self, dy, y, scale=1.0):
        dx = np.empty_like(dy)
        for n in range(dy.shape[0]):
            for h in range(dy.shape[1]):
                hl = h if self.lut_heads > 1 else 0
                for lut in self.nn_list[hl]:
                    bs = [b for b, k in lut]
                    dyb = dy[n, h, bs]
                    yb = y[n, h, bs]
                    dxb = (dyb - np.sum(dyb * yb, axis=(0, 2),
                                        keepdims=True)) * yb * scale
                    for i, (b, k) in enumerate(lut):
                        dx[n, h, b] = dxb[i]
        return dx

    # ------------- attention ----------------

    def attention(self, q, k, v, scale=1.0, use_fused=None, flash_bwd=True):
        """softmax(scale·QKᵀ + mask)·V over this object's layout.

        q: (batch, ctx_q, heads·hs); k, v: (batch, ctx_k, heads·hs).
        use_fused=None takes the fused route where hs <= 128 and the
        unfused ops past it, as the JAX package does; True and False pin
        a route.  The fused route runs the fused kernels on CUDA tensors
        and their plain versions on CPU tensors, both on the kernels' view
        of the layout (block size 8 seen at 16) with hs zero-padded to a
        size the kernels take (``_kernel_fwd``); past hs 128 it raises on
        the card and runs the plain version at the op's own block size on
        the CPU.  With ``impl="xla"`` the fused route runs that plain
        version on every device.  On the fused route a query row that
        sees no key gives zeros; on the unfused route it gives the mean of
        v over its blocks' keys (the reference's -finfo(f32).max fill).
        Differentiable in q, k and v: with a gradient to take, the
        training forward (which keeps the lse) runs, else the serving
        forward; ``flash_bwd=False`` takes the backward of the unfused
        ops, nn(masked_softmax(nt(q, k)), v), instead of the fused one."""
        hs = q.shape[-1] // self.heads
        if use_fused is None:
            use_fused = _can_fuse(hs)
        if not use_fused:
            return self._unfused(q, k, v, scale)
        kernels = self.impl != "xla" and (q.is_cuda or _can_fuse(hs))
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in (q, k, v)):
            return _AttentionFunction.apply(q, k, v, self, scale, kernels,
                                            flash_bwd)
        return self._fused_fwd(q, k, v, scale, kernels, with_lse=False)[0]

    def _unfused(self, q, k, v, scale):
        """nn(masked_softmax(nt(q, k), scale), v): the JAX package's
        unfused attention."""
        w = self.nt_op(q, k)
        p = self.masked_softmax(w, scale=scale)
        return self.nn_op(p, v)

    def _fused_fwd(self, q, k, v, scale, kernels, with_lse, tab=None):
        """The fused forward, (out, lse or None): on the kernels' route
        (``_kernel_fwd``) or, without ``kernels``, the plain version at
        this op's own block size.  ``tab``: the tables to run on, by
        default the layout's (``_tables``); the sequence-parallel
        attention passes a shard's (``parallel.sequence.shard_tables``)."""
        if kernels:
            return self._kernel_fwd(q, k, v, scale, with_lse, tab)
        tab = tab or self._tables(q.device)
        out, lse = bst_attn.attention_fwd_lse_plain(
            q, k, v, tab["q_blk"], tab["k_blk"], tab["mask"], self.heads,
            self.blk_size, scale)
        return out, lse if with_lse else None

    def _kernel_fwd(self, q, k, v, scale, with_lse, tab=None):
        """The fused forward on the kernels' view: (out, lse or None).
        q, k and v are zero-padded to the view's contexts and to
        ``kernel_head_size`` (no copy where nothing is padded), run
        through the kernels on a CUDA tensor or their plain versions on a
        CPU one, and out and lse are cropped back.  ``tab`` as in
        ``_fused_fwd``."""
        tab = tab or self._tables(q.device)
        heads, kbs = self.heads, tab["kbs"]
        _, ctx_q, state = q.shape
        hs = state // heads
        khs = bst_attn.kernel_head_size(hs)
        qp = _pad(q, tab["kctx_q"], heads, khs)
        kp = _pad(k, tab["kctx_k"], heads, khs)
        vp = _pad(v, tab["kctx_k"], heads, khs)
        lse = None
        if not q.is_cuda:
            out, lse = bst_attn.attention_fwd_lse_plain(
                qp, kp, vp, tab["kq_blk"], tab["kk_blk"], tab["kmask"], heads,
                kbs, scale)
        elif with_lse:
            out, lse = bst_attn.attention_fwd_lse(qp, kp, vp, tab, heads,
                                                  scale)
        else:
            out = bst_attn.attention_fwd(qp, kp, vp, tab, heads, scale)
        if with_lse and lse.shape[-1] != ctx_q:
            lse = lse[..., :ctx_q].contiguous()
        return _crop(out, ctx_q, heads, hs), lse if with_lse else None

    def _kernel_bwd(self, q, k, v, do, out, lse, scale, tab=None,
                    dvec=None, dq_dtype=None):
        """dq, dk, dv of the fused attention on the kernels' view: D =
        rowsum(dO·out) from the unpadded dO and out (or ``dvec`` as
        given, out unused); q, k, v and dO padded as in ``_kernel_fwd``,
        lse padded with -inf and D with 0 (the padded query rows see no
        key); dq and dk/dv by the kernels on a CUDA tensor or the plain
        backward on a CPU one, cropped back.  dq in q's dtype (or
        ``dq_dtype``, f32 for a caller that sums it), dk and dv in f32.
        ``tab`` as in ``_fused_fwd``."""
        tab = tab or self._tables(q.device)
        heads, kbs = self.heads, tab["kbs"]
        _, ctx_q, state = q.shape
        hs = state // heads
        khs = bst_attn.kernel_head_size(hs)
        if dvec is None:
            dvec = _rowsum(do, out, heads)
        pad_q = tab["kctx_q"] - ctx_q
        if pad_q:
            lse = torch.nn.functional.pad(lse, (0, pad_q),
                                          value=float("-inf"))
            dvec = torch.nn.functional.pad(dvec, (0, pad_q))
        qp = _pad(q, tab["kctx_q"], heads, khs)
        dop = _pad(do, tab["kctx_q"], heads, khs)
        kp = _pad(k, tab["kctx_k"], heads, khs)
        vp = _pad(v, tab["kctx_k"], heads, khs)
        if q.is_cuda:
            dq = bst_attn.attention_dq(qp, kp, vp, dop, lse, dvec, tab,
                                       heads, scale, out_dtype=dq_dtype)
            dk, dv = bst_attn.attention_dkv(qp, kp, vp, dop, lse, dvec, tab,
                                            heads, scale)
        else:
            dq, dk, dv = bst_attn.attention_bwd_plain(
                qp, kp, vp, dop, lse, dvec, tab["kq_blk"], tab["kk_blk"],
                tab["kmask"], heads, kbs, scale, dq_dtype=dq_dtype)
        ctx_k = k.shape[1]
        return (_crop(dq, ctx_q, heads, hs), _crop(dk, ctx_k, heads, hs),
                _crop(dv, ctx_k, heads, hs))

    def _fused_bwd(self, q, k, v, do, out, lse, scale, kernels, tab=None,
                   dvec=None, dq_dtype=None):
        """dq, dk, dv of the fused attention: on the kernels' route
        (``_kernel_bwd``, whose arguments these are) or, without
        ``kernels``, the plain backward at this op's own block size."""
        if kernels:
            return self._kernel_bwd(q, k, v, do, out, lse, scale, tab, dvec,
                                    dq_dtype)
        tab = tab or self._tables(q.device)
        if dvec is None:
            dvec = _rowsum(do, out, self.heads)
        return bst_attn.attention_bwd_plain(
            q, k, v, do, lse, dvec, tab["q_blk"], tab["k_blk"], tab["mask"],
            self.heads, self.blk_size, scale, dq_dtype=dq_dtype)

    # ------------- KV-cached decode ----------------

    @property
    def decode_tables(self):
        """Padded per-query-row key-block tables for incremental decode:
        (row_kblk, row_bid, row_cnt) with shapes (lut_heads, ctx_blks_q,
        nn_max), same, and (lut_heads, ctx_blks_q)."""
        if self._decode_tables is None:
            E = max(self.nn_max, 1)
            lh = self.lut_heads
            kblk = np.zeros((lh, self.ctx_blks_q, E), np.int32)
            bid = np.zeros((lh, self.ctx_blks_q, E), np.int32)
            cnt = np.zeros((lh, self.ctx_blks_q), np.int32)
            for h in range(lh):
                for qr in range(self.ctx_blks_q):
                    ents = self.nn_list[h][qr]
                    cnt[h, qr] = len(ents)
                    for i, (b, kb) in enumerate(ents):
                        kblk[h, qr, i] = kb
                        bid[h, qr, i] = b
            self._decode_tables = (kblk, bid, cnt)
        return self._decode_tables

    def decode_step(self, q, k_cache, v_cache, pos, scale=1.0):
        """KV-cached single-position sparse attention.

        q: (batch, 1, state); k_cache / v_cache: (batch, ctx_k, state)
        with positions > pos allowed to hold anything; pos: an int or an
        int64 device tensor of one element (``position_tensor``), read on
        the device: no value goes to the host, so a CUDA graph can
        capture the step and replay it at any position.  Returns (batch,
        1, state).  Only the layout row of ``pos`` is gathered, so a token
        costs O(visible blocks).  Semantics match the masked softmax at
        query row ``pos`` with keys past ``pos`` hidden."""
        bs = self.blk_size
        batch, one, state = q.shape
        if one != 1:
            raise ValueError("decode_step takes one position")
        hs = state // self.heads
        dev = q.device
        pos = position_tensor(pos, dev)                      # (1,)
        r = torch.div(pos, bs, rounding_mode="floor")
        tab = self._tables(dev)
        idx = tab["dec_kblk"].index_select(1, r)[:, 0]       # (lh, E)
        E = idx.shape[1]
        kpos = idx[:, :, None] * bs + tab["arange_bs"]       # (lh, E, bs)
        vis = (kpos <= pos) & \
            tab["dec_in_row"].index_select(1, r)[:, 0, :, None]
        if tab["mask"] is not None:
            bid = tab["dec_bid"].index_select(1, r)[:, 0]    # (lh, E)
            rows = tab["mask"].index_select(2, torch.remainder(pos, bs))
            vis &= rows[tab["heads_lut"], bid, 0]

        ctx_blks = k_cache.shape[1] // bs
        hidx = torch.arange(self.heads, device=dev)[:, None]
        kix = idx.expand(self.heads, -1)                     # (h, E)
        kg = self._split_heads(k_cache, ctx_blks)[:, hidx, kix].float()
        vg = self._split_heads(v_cache, ctx_blks)[:, hidx, kix].float()
        q3 = q.reshape(batch, self.heads, hs).float()
        s = torch.einsum("nhc,nhebc->nheb", q3, kg) * scale
        s = torch.where(vis[None], s, torch.full_like(s, _NEG_MAX))
        p = torch.softmax(s.reshape(batch, self.heads, E * bs), dim=-1)
        out = torch.einsum("nhk,nhkc->nhc", p,
                           vg.reshape(batch, self.heads, E * bs, hs))
        return out.reshape(batch, 1, state).to(q.dtype)


def fused_tables(nt_lists, mask_blocks, bs, ctx_blks_q, ctx_blks_k, device):
    """The fused attention's tables of a layout on ``device``: those of
    the kernels' view (``bst_attn.kernel_view``, ``kernel_tables``: the
    CSRs, their mask codes, launch orders and pair plans, which the
    kernels' wrappers read from this dict), its block size and padded
    contexts (``kbs``, ``kctx_q``, ``kctx_k``), the view's plain-version
    block indices and masks (``kq_blk``, ``kk_blk``, ``kmask``), and the
    plain versions' at the layout's own block size (``q_blk``, ``k_blk``,
    ``mask``).  nt_lists: per layout head, the (q_blk, k_blk) blocks in
    row order (the heads' counts may differ); mask_blocks: per head, the
    blocks' (bs, bs) bool masks in that order, or None."""
    nt, masks, kbs, kcq, kck = bst_attn.kernel_view(
        nt_lists, mask_blocks, bs, ctx_blks_q, ctx_blks_k)
    kt = bst_attn.kernel_tables(nt, masks, kbs, kcq, kck)
    own = kt if kbs == bs else bst_attn.kernel_tables(
        nt_lists, None if mask_blocks is None else list(mask_blocks), bs,
        ctx_blks_q, ctx_blks_k)

    def t(a, dt):
        return None if a is None else torch.as_tensor(a, dtype=dt,
                                                      device=device)
    i32, i8, i64 = torch.int32, torch.int8, torch.int64
    tab = {name: t(kt[name], i8 if name.startswith("uniq") else i32)
           for name in bst_attn._TABLES + bst_attn._TABLES_T}
    tab.update({
        "kbs": kbs, "kctx_q": kcq * kbs, "kctx_k": kck * kbs,
        "kq_blk": t(kt["q_blk"], i64), "kk_blk": t(kt["k_blk"], i64),
        "kmask": t(kt["mask"], torch.bool),
        "q_blk": t(own["q_blk"], i64), "k_blk": t(own["k_blk"], i64),
        "mask": t(own["mask"], torch.bool)})
    return tab


def position_tensor(pos, device):
    """A decode position as a (1,) int64 tensor on ``device``: a tensor of
    one element as it is (cast to int64), an int by a fill on the device,
    which copies nothing from the host (such a copy waits for the
    stream)."""
    if isinstance(pos, torch.Tensor):
        return pos.reshape(1).to(device=device, dtype=torch.int64)
    return torch.full((1,), int(pos), dtype=torch.int64, device=device)


def _rowsum(do, out, heads):
    """D = rowsum(dO·out) a head, in f32: (batch, heads, ctx_q)."""
    batch, ctx_q, state = do.shape
    d = (do.float() * out.float()).reshape(batch, ctx_q, heads,
                                           state // heads).sum(-1)
    return d.transpose(1, 2).contiguous()


def _pad(a, ctx, heads, hs):
    """(batch, c, heads·h) -> (batch, ctx, heads·hs), zero-filled past c
    positions and h columns a head; ``a`` itself where nothing is
    padded."""
    batch, c, state = a.shape
    h = state // heads
    if c == ctx and h == hs:
        return a
    out = a.new_zeros((batch, ctx, heads, hs))
    out[:, :c, :, :h] = a.reshape(batch, c, heads, h)
    return out.reshape(batch, ctx, heads * hs)


def _crop(a, ctx, heads, hs):
    """The inverse of ``_pad``: the first ctx positions and hs columns of
    each head of a (batch, c, heads·h) tensor, contiguous."""
    batch, c, state = a.shape
    h = state // heads
    if c == ctx and h == hs:
        return a
    return a.reshape(batch, c, heads, h)[:, :ctx, :, :hs].reshape(
        batch, ctx, heads * hs)


def _row_blocks(q_blk, rows):
    """Each query block-row's blocks (a (lut_heads, blocks) q_blk in row
    order), padded with ``blocks`` to the longest row: (lut_heads, rows,
    most), int64."""
    lh, blocks = q_blk.shape
    counts = np.stack([np.bincount(q, minlength=rows) for q in q_blk])
    out = np.full((lh, rows, max(int(counts.max()), 1)), blocks, np.int64)
    for h in range(lh):
        for r in range(rows):
            out[h, r, :counts[h, r]] = np.flatnonzero(q_blk[h] == r)
    return out


class _RowSum(torch.autograd.Function):
    """v (batch, heads, blocks, bs) summed over each query block-row's
    blocks in block order: (batch, heads, rows, bs), from ``row_blocks``
    (``_row_blocks``).  A padded gather and a sum, not ``scatter_add``,
    whose atomics add in no fixed order on the card; its adjoint is
    ``_RowBroadcast`` (each block its row's value, a gather), and the
    other way round."""

    @staticmethod
    def forward(ctx, v, row_blocks, q_blk):
        ctx.save_for_backward(row_blocks, q_blk)
        return _row_sum(v, row_blocks)

    @staticmethod
    def backward(ctx, g):
        row_blocks, q_blk = ctx.saved_tensors
        return _RowBroadcast.apply(g, row_blocks, q_blk), None, None


class _RowBroadcast(torch.autograd.Function):
    """s (batch, heads, rows, bs) at each block's row: (batch, heads,
    blocks, bs); the adjoint of ``_RowSum``."""

    @staticmethod
    def forward(ctx, s, row_blocks, q_blk):
        ctx.save_for_backward(row_blocks, q_blk)
        idx = q_blk.expand(s.shape[1], -1)[None, :, :, None].expand(
            s.shape[0], s.shape[1], q_blk.shape[1], s.shape[3])
        return s.gather(2, idx)

    @staticmethod
    def backward(ctx, g):
        row_blocks, q_blk = ctx.saved_tensors
        return _RowSum.apply(g, row_blocks, q_blk), None, None


def _row_sum(v, row_blocks):
    pad = torch.cat([v, v.new_zeros(v.shape[:2] + (1,) + v.shape[3:])], 2)
    hidx = torch.arange(v.shape[1], device=v.device)[:, None, None]
    return pad[:, hidx, row_blocks.expand(v.shape[1], -1, -1)].sum(3)


def _on_kernels(bst, t):
    """The trio's route for a tensor: the CUDA kernels on a CUDA tensor
    unless the op is ``impl="xla"``."""
    return t.is_cuda and bst.impl != "xla"


def _rows_contiguous(t):
    """t, or a copy where its last dim is not contiguous (a gradient may be
    an expanded view)."""
    return t if t.stride(-1) == 1 else t.contiguous()


def _head8(a, heads):
    """a with each head zero-padded to a multiple of 8 columns, the head
    size the trio's kernels take (zero columns add nothing to a score and
    give output columns that are cropped); a itself where hs is one."""
    hs = a.shape[-1] // heads
    return _pad(a, a.shape[1], heads, -(-hs // 8) * 8)


def _nt(bst, a, b):
    """scores (batch, heads, blocks, bs, bs) = a_blk · b_blkᵀ in a's
    dtype: ``bst_trio.bst_nt`` or its plain version."""
    tab = bst._tables(a.device)
    if not _on_kernels(bst, a):
        return bst_trio.bst_nt_plain(a, b, tab["q_blk"], tab["k_blk"],
                                     bst.heads, bst.blk_size)
    return bst_trio.bst_nt(
        _head8(_rows_contiguous(a), bst.heads),
        _head8(_rows_contiguous(b.to(a.dtype)), bst.heads),
        tab["tri_plan"], tab["tri_ent_k"], bst.heads, bst.blk_size)


def _xn(bst, w, x, trans):
    """NN (y over the query rows, x at the key blocks) or TN (``trans``: y
    over the key rows, x at the query blocks) of the scores w and x, in
    x's dtype: ``bst_trio.bst_xn`` or its plain version."""
    tab = bst._tables(x.device)
    rows = bst.ctx_blks_k if trans else bst.ctx_blks_q
    if not _on_kernels(bst, x):
        seg, gather = ((tab["k_blk"], tab["q_blk"]) if trans
                       else (tab["q_blk"], tab["k_blk"]))
        return bst_trio.bst_xn_plain(w, x, seg, gather, rows, bst.heads,
                                     bst.blk_size, trans)
    csr = (("tri_plan_t", "tri_ent_b", "tri_ent_q") if trans
           else ("tri_plan", "tri_ent_e", "tri_ent_k"))
    batch, _, state = x.shape
    y = bst_trio.bst_xn(
        w.to(x.dtype).contiguous(), _head8(_rows_contiguous(x), bst.heads),
        *(tab[name] for name in csr), bst.heads, bst.blk_size, rows, trans)
    return _crop(y, rows * bst.blk_size, bst.heads, state // bst.heads)


class _NT(torch.autograd.Function):
    """``nt_op``: dk = tn(dw, q), dq = nn(dw, k) (the JAX ``_bst_nt``)."""

    @staticmethod
    def forward(ctx, a, b, bst):
        ctx.save_for_backward(a, b)
        ctx.bst = bst
        return _nt(bst, a, b)

    @staticmethod
    def backward(ctx, dw):
        a, b = ctx.saved_tensors
        dw = dw.to(a.dtype)
        da = _xn(ctx.bst, dw, b, False) if ctx.needs_input_grad[0] else None
        db = _xn(ctx.bst, dw, a, True) if ctx.needs_input_grad[1] else None
        return (None if da is None else da.to(a.dtype),
                None if db is None else db.to(b.dtype), None)


class _NN(torch.autograd.Function):
    """``nn_op``: dv = tn(w, dy), dw = nt(dy, v) (the JAX ``_bst_nn``)."""

    @staticmethod
    def forward(ctx, w, v, bst):
        ctx.save_for_backward(w, v)
        ctx.bst = bst
        return _xn(bst, w, v, False)

    @staticmethod
    def backward(ctx, dy):
        w, v = ctx.saved_tensors
        dy = dy.to(v.dtype)
        dw = _nt(ctx.bst, dy, v) if ctx.needs_input_grad[0] else None
        dv = _xn(ctx.bst, w, dy, True) if ctx.needs_input_grad[1] else None
        return (None if dw is None else dw.to(w.dtype),
                None if dv is None else dv.to(v.dtype), None)


class _TN(torch.autograd.Function):
    """``tn_op``: dq = nn(w, dy), dw = nt(q, dy) (the JAX ``_bst_tn``)."""

    @staticmethod
    def forward(ctx, w, q, bst):
        ctx.save_for_backward(w, q)
        ctx.bst = bst
        return _xn(bst, w, q, True)

    @staticmethod
    def backward(ctx, dy):
        w, q = ctx.saved_tensors
        dy = dy.to(q.dtype)
        dw = _nt(ctx.bst, q, dy) if ctx.needs_input_grad[0] else None
        dq = _xn(ctx.bst, w, dy, False) if ctx.needs_input_grad[1] else None
        return (None if dw is None else dw.to(w.dtype),
                None if dq is None else dq.to(q.dtype), None)


class _AttentionFunction(torch.autograd.Function):
    """The JAX ``_attention_fused`` custom_vjp.  ``kernels``: the fused
    kernels' route (``_kernel_fwd``/``_kernel_bwd``), else the plain
    versions at the op's own block size.  With ``flash_bwd`` the forward
    keeps (q, k, v, out, lse) and the backward forms D = rowsum(dO·out) in
    plain torch and runs dq and dk/dv, casting each to its input's dtype
    (dk and dv come out of their kernel in f32).  Without it the forward
    is the serving one and the backward that of the unfused ops,
    recomputed from q, k and v."""

    @staticmethod
    def forward(ctx, q, k, v, bst, scale, kernels, flash_bwd):
        out, lse = bst._fused_fwd(q, k, v, scale, kernels,
                                  with_lse=flash_bwd)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.bst, ctx.scale, ctx.kernels = bst, scale, kernels
        ctx.flash_bwd = flash_bwd
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        bst, scale = ctx.bst, ctx.scale
        if not ctx.flash_bwd:
            with torch.enable_grad():
                qkv = [t.detach().requires_grad_() for t in (q, k, v)]
                y = bst._unfused(*qkv, scale)
            dq, dk, dv = torch.autograd.grad(y, qkv, do.to(y.dtype))
            return dq, dk, dv, None, None, None, None
        do = _rows_contiguous(do.to(q.dtype))
        dq, dk, dv = bst._fused_bwd(q, k, v, do, out, lse, scale,
                                    ctx.kernels)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None, None)


def clear_bst_constants():
    """Parity shim: an op's tables go to each device once, at first use."""


# ------------------------------------------------------------------
# Dense softmax / top-k family (reference transformer.py:484-701), plain
# torch as the JAX package leaves it to XLA.
# ------------------------------------------------------------------

def _check_k(x, k):
    if not k <= x.shape[-1] <= 1024:
        raise ValueError(f"k <= last dim <= 1024, got k {k} of "
                         f"{x.shape[-1]}")


def top_k(x, k):
    """(values, indices) of the k largest entries of the last dim, in
    descending order."""
    _check_k(x, k)
    return torch.topk(x, k, dim=-1)


def rectified_top_k(x, k, rebase=True):
    """x where it is among the k largest of its row, less the k-th value
    when that is positive (``rebase``), else 0."""
    _check_k(x, k)
    kth = torch.topk(x, k, dim=-1).values[..., k - 1:k]
    base = kth.clamp_min(0.0) if rebase else torch.zeros_like(kth)
    return torch.where(x >= kth, torch.maximum(x, base) - base,
                       torch.zeros_like(x))


def rectified_top_k_test(x, k, rebase=True):
    a = np.argsort(x)[:, ::-1]
    y = np.zeros(x.shape, dtype=np.float32)
    for i in range(x.shape[0]):
        base = max(x[i, a[i, k - 1]], 0.0) if rebase else 0.0
        y[i, a[i, :k]] = np.maximum(x[i, a[i, :k]], base) - base
    return y


def _apply_mask_scale(x, mask, scale):
    xs = x.float()
    if mask is None:
        return xs * scale
    m = mask.float()
    return torch.where(m != 0, xs * m * scale, _NEG_MAX)


def softmax(x, scale=1.0, bench=0):
    return masked_softmax(x, mask=None, scale=scale)


def masked_softmax(x, mask=None, scale=1.0, bench=0):
    """Dense softmax over the last dim with a broadcastable
    multiplicative/visibility mask (mask == 0 -> hidden; else the logit
    is scaled by mask·scale), in f32, cast to x's dtype.  Its gradient is
    the reference's masked_softmax_grad, (dy - Σ dy·y)·y·mask·scale."""
    if mask is not None:
        if mask.dim() != x.dim() or any(
                m not in (1, n) for m, n in zip(mask.shape, x.shape)):
            raise ValueError(f"mask {tuple(mask.shape)} does not broadcast "
                             f"to x {tuple(x.shape)} dim for dim")
    return _DenseSoftmax.apply(x, mask, scale)


class _DenseSoftmax(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, mask, scale):
        xs = _apply_mask_scale(x, mask, scale)
        e = torch.exp(xs - xs.amax(-1, keepdim=True))
        y = (e / e.sum(-1, keepdim=True)).to(x.dtype)
        ctx.save_for_backward(y, mask)
        ctx.scale = scale
        return y

    @staticmethod
    def backward(ctx, dy):
        y, mask = ctx.saved_tensors
        yf, dyf = y.float(), dy.float()
        dx = (dyf - (dyf * yf).sum(-1, keepdim=True)) * yf * ctx.scale
        if mask is not None:
            dx = dx * mask.float()
        return dx.to(y.dtype), None, None


def masked_top_k_softmax(x, k, mask=None, scale=1.0):
    """The softmax over each row's k largest masked, scaled logits, zeros
    elsewhere, in x's dtype."""
    _check_k(x, k)
    xs = _apply_mask_scale(x, mask, scale)
    vals, idx = torch.topk(xs, k, dim=-1)
    e = torch.exp(vals - vals[..., :1])
    sm = e / e.sum(-1, keepdim=True)
    return torch.zeros_like(xs).scatter(-1, idx, sm).to(x.dtype)


def masked_softmax_test(x, mask=None, scale=1.0):
    x_shape = x.shape
    if mask is not None:
        x = x.reshape(-1, mask.size)
        y = np.empty(x.shape, dtype=np.float32)
        y.fill(_NEG_MAX)
        nz = np.nonzero(mask.reshape(-1))
        y[:, nz] = x[:, nz] * mask.reshape(1, -1)[:, nz] * scale
    else:
        y = x * scale
    y = y.reshape(-1, x_shape[-1])
    m = np.max(y, axis=1, keepdims=True)
    z = np.exp(y - m) / np.sum(np.exp(y - m), axis=1, keepdims=True)
    return z.reshape(x_shape)


def masked_top_k_softmax_test(x, k, mask=None, scale=1.0):
    x_shape = x.shape
    if mask is not None:
        x = x.reshape(-1, mask.size)
        y = np.empty(x.shape, dtype=np.float32)
        y.fill(_NEG_MAX)
        nz = np.nonzero(mask.reshape(-1))
        y[:, nz] = x[:, nz] * mask.reshape(1, -1)[:, nz] * scale
    else:
        y = x * scale
    y = y.reshape(-1, x_shape[-1])
    a = np.argsort(y)[:, ::-1]
    z = np.zeros(y.shape, dtype=np.float32)
    for i in range(y.shape[0]):
        max_val = y[i, a[i, 0]]
        z[i, a[i, :k]] = np.exp(y[i, a[i, :k]] - max_val) \
            / np.sum(np.exp(y[i, a[i, :k]] - max_val))
    return z.reshape(x_shape)


def masked_softmax_grad_test(dy, y, mask=None, scale=1.0):
    if mask is None:
        mask = 1.0
    return (dy - np.sum(dy * y, axis=-1, keepdims=True)) * y * mask * scale


def transpose_2d(x):
    return x.t()


def transpose_0213(x):
    """(batch, a, b, c) -> (batch, b, a, c), the head transpose."""
    return x.permute(0, 2, 1, 3)


def softmax_cross_entropy(logits, labels):
    """Per-row cross entropy of ``logits`` (..., vocab) against integer
    ``labels`` (...), in f32, with the fused gradient
    (softmax - onehot)·dy cast to the logits' dtype (JAX
    ``ops/transformer.py:863``)."""
    if logits.shape[-1] > 65536:
        raise ValueError("use a sharded cross entropy if feature dim is "
                         "greater than 64k")
    return _SoftmaxCrossEntropy.apply(logits, labels)


class _SoftmaxCrossEntropy(torch.autograd.Function):

    @staticmethod
    def forward(ctx, logits, labels):
        labels = labels.long()
        ctx.save_for_backward(logits, labels)
        ls = logits.float()
        m = ls.amax(-1, keepdim=True)
        lse = torch.log(torch.exp(ls - m).sum(-1)) + m[..., 0]
        return lse - ls.gather(-1, labels[..., None])[..., 0]

    @staticmethod
    def backward(ctx, dy):
        logits, labels = ctx.saved_tensors
        dx = torch.softmax(logits.float(), dim=-1)
        dx.scatter_add_(-1, labels[..., None],
                        torch.full_like(dx[..., :1], -1.0))
        return (dx * dy[..., None].float()).to(logits.dtype), None
