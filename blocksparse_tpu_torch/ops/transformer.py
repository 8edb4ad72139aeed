"""Block-sparse transformer attention (training, serving and KV-cached
decode) and the softmax cross-entropy loss.

Counterpart of ``blocksparse_tpu/ops/transformer.py``: the same layout
LUTs (``nt_list``/``nn_list``/``tn_list``), bit-packed and dense masks,
and the public (batch, ctx, heads·hs) layout at ``attention`` and
``decode_step``.

``attention`` runs the fused CUDA kernels (``kernels/bst_attn.py``) on
CUDA tensors and their plain masked per-block versions on CPU tensors,
both on the kernels' view of the layout (block size 8 seen at 16, head
sizes zero-padded up to 128); ``use_fused=False`` selects the plain
versions at the op's own block size.  With a gradient to take it is a
``torch.autograd.Function``, the counterpart of ``_attention_fused`` with
``flash_bwd=True``: the training forward saves the log-sum-exp, and the
backward runs dq over the query-row CSR and dk/dv over the key-row CSR.
Without one it runs the serving forward.  ``decode_step`` and
``softmax_cross_entropy`` are plain PyTorch, as the JAX package leaves
them to XLA.  The unfused nt/nn/tn ops belong to a later slice.
"""
from __future__ import annotations

import numpy as np
import torch

from blocksparse_tpu_torch.kernels import bst_attn

_NEG_MAX = -np.finfo(np.float32).max


class BlocksparseTransformer:

    def __init__(self, layout, block_size=64, heads=None, mask_callback=None,
                 name=None, impl=None, q_mult=None):
        """layout: (ctx_blks_q, ctx_blks_k) shared by all heads (then
        ``heads`` is required) or (lut_heads, ctx_blks_q, ctx_blks_k).
        mask_callback(blk_shape, head, qry, key, blk) -> bool block.
        impl selects the JAX package's unfused nt/nn/tn ops, which the
        port has not got yet; q_mult is the TPU kernel's row pairing.
        Both are accepted for the same call signature and change no
        result."""
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
        size; and the decode tables (so a decode step copies nothing from
        the host, which would stall the stream)."""
        tab = self._dev_tables.get(device)
        if tab is None:
            nt, masks, kbs, kcq, kck = bst_attn.kernel_view(
                self.nt_list, self._mask_blocks, self.blk_size,
                self.ctx_blks_q, self.ctx_blks_k)
            kt = bst_attn.kernel_tables(nt, masks, kbs, kcq, kck)
            kblk, bid, cnt = self.decode_tables
            in_row = np.arange(kblk.shape[2])[None, None] < cnt[:, :, None]

            def t(a, dt):
                return None if a is None else torch.as_tensor(
                    a, dtype=dt, device=device)
            i32, i8, i64 = torch.int32, torch.int8, torch.int64
            tab = {name: t(kt[name], dt) for name, dt in (
                ("row_ptr", i32), ("ent_k", i32), ("ent_code", i32),
                ("uniq", i8), ("order", i32), ("row_ptr_t", i32),
                ("ent_q", i32), ("ent_code_t", i32), ("uniq_t", i8),
                ("order_t", i32))}
            tab.update({
                "kbs": kbs, "kctx_q": kcq * kbs, "kctx_k": kck * kbs,
                "kq_blk": t(kt["q_blk"], i64), "kk_blk": t(kt["k_blk"], i64),
                "kmask": t(kt["mask"], torch.bool),
                "q_blk": t(self._q_blk, i64), "k_blk": t(self._k_blk, i64),
                "mask": t(self._mask_blocks, torch.bool),
                "dec_kblk": t(kblk, i64),
                "dec_bid": t(bid, i64),
                "dec_in_row": t(in_row, torch.bool),
                "arange_bs": t(np.arange(self.blk_size), i64),
                "heads_lut": t(np.arange(self.lut_heads)[:, None], i64)})
            self._dev_tables[device] = tab
        return tab

    # ------------- attention ----------------

    def attention(self, q, k, v, scale=1.0, use_fused=None, flash_bwd=True):
        """softmax(scale·QKᵀ + mask)·V over this object's layout.

        q: (batch, ctx_q, heads·hs); k, v: (batch, ctx_k, heads·hs).
        Unless use_fused=False, the fused kernels' route runs: on CUDA
        tensors the kernels, on CPU tensors their plain versions, both on
        the kernels' view of the layout (block size 8 seen at 16) with hs
        zero-padded to a size the kernels take (``_kernel_fwd``).  A head
        size past 128 raises there on the card (the reference's unfused
        ops are not ported) and takes the plain versions on the CPU.
        use_fused=False selects the plain versions at this op's own block
        size, on any device.  Differentiable in q, k and v: with a
        gradient to take, the training forward (which keeps the lse) runs,
        else the serving forward.  A query row that sees no key gives
        zeros, and zero gradients.  The backward is always the flash one:
        ``flash_bwd=False`` (the reference's unfused backward) is not
        ported and raises."""
        if not flash_bwd:
            raise NotImplementedError("flash_bwd=False (the unfused "
                                      "attention backward) is not ported "
                                      "yet")
        fused = use_fused is not False and (
            q.is_cuda or q.shape[-1] // self.heads <= bst_attn.HEAD_SIZES[-1])
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in (q, k, v)):
            return _AttentionFunction.apply(q, k, v, self, scale, fused)
        if fused:
            return self._kernel_fwd(q, k, v, scale, with_lse=False)[0]
        tab = self._tables(q.device)
        return bst_attn.attention_fwd_plain(
            q, k, v, tab["q_blk"], tab["k_blk"], tab["mask"], self.heads,
            self.blk_size, scale)

    def _kernel_fwd(self, q, k, v, scale, with_lse):
        """The fused forward on the kernels' view: (out, lse or None).
        q, k and v are zero-padded to the view's contexts and to
        ``kernel_head_size`` (no copy where nothing is padded), run
        through the kernels on a CUDA tensor or their plain versions on a
        CPU one, and out and lse are cropped back."""
        tab = self._tables(q.device)
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
            out, lse = bst_attn.attention_fwd_lse(
                qp, kp, vp, tab["row_ptr"], tab["ent_k"], tab["ent_code"],
                tab["uniq"], heads, kbs, scale, order=tab["order"])
        else:
            out = bst_attn.attention_fwd(
                qp, kp, vp, tab["row_ptr"], tab["ent_k"], tab["ent_code"],
                tab["uniq"], heads, kbs, scale, order=tab["order"])
        if with_lse and lse.shape[-1] != ctx_q:
            lse = lse[..., :ctx_q].contiguous()
        return _crop(out, ctx_q, heads, hs), lse if with_lse else None

    def _kernel_bwd(self, q, k, v, do, out, lse, scale):
        """dq, dk, dv of the fused attention on the kernels' view: D =
        rowsum(dO·out) from the unpadded dO and out; q, k, v and dO padded
        as in ``_kernel_fwd``, lse padded with -inf and D with 0 (the
        padded query rows see no key); dq and dk/dv by the kernels on a
        CUDA tensor or the plain backward on a CPU one, cropped back.  dq
        in q's dtype, dk and dv in f32."""
        tab = self._tables(q.device)
        heads, kbs = self.heads, tab["kbs"]
        _, ctx_q, state = q.shape
        hs = state // heads
        khs = bst_attn.kernel_head_size(hs)
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
            dq = bst_attn.attention_dq(
                qp, kp, vp, dop, lse, dvec, tab["row_ptr"], tab["ent_k"],
                tab["ent_code"], tab["uniq"], heads, kbs, scale)
            dk, dv = bst_attn.attention_dkv(
                qp, kp, vp, dop, lse, dvec, tab["row_ptr_t"], tab["ent_q"],
                tab["ent_code_t"], tab["uniq_t"], heads, kbs, scale,
                order=tab["order_t"])
        else:
            dq, dk, dv = bst_attn.attention_bwd_plain(
                qp, kp, vp, dop, lse, dvec, tab["kq_blk"], tab["kk_blk"],
                tab["kmask"], heads, kbs, scale)
        ctx_k = k.shape[1]
        return (_crop(dq, ctx_q, heads, hs), _crop(dk, ctx_k, heads, hs),
                _crop(dv, ctx_k, heads, hs))

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


class _AttentionFunction(torch.autograd.Function):
    """The JAX ``_attention_fused`` custom_vjp with ``flash_bwd=True``:
    the forward keeps (q, k, v, out, lse); the backward forms
    D = rowsum(dO·out) in plain torch and runs dq and dk/dv, casting each
    to its input's dtype (dk and dv come out of their kernel in f32).
    ``fused``: the kernels' route (``_kernel_fwd``/``_kernel_bwd``), else
    the plain versions at the op's own block size."""

    @staticmethod
    def forward(ctx, q, k, v, bst, scale, fused):
        if fused:
            out, lse = bst._kernel_fwd(q, k, v, scale, with_lse=True)
        else:
            tab = bst._tables(q.device)
            out, lse = bst_attn.attention_fwd_lse_plain(
                q, k, v, tab["q_blk"], tab["k_blk"], tab["mask"], bst.heads,
                bst.blk_size, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.bst, ctx.scale, ctx.fused = bst, scale, fused
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        bst, scale = ctx.bst, ctx.scale
        do = do.to(q.dtype)
        if do.stride(-1) != 1:
            do = do.contiguous()
        if ctx.fused:
            dq, dk, dv = bst._kernel_bwd(q, k, v, do, out, lse, scale)
        else:
            tab = bst._tables(q.device)
            dq, dk, dv = bst_attn.attention_bwd_plain(
                q, k, v, do, lse, _rowsum(do, out, bst.heads), tab["q_blk"],
                tab["k_blk"], tab["mask"], bst.heads, bst.blk_size, scale)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None)


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
