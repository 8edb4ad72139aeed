"""Layout-driven block-sparse matrix multiply, forward and backward.

Counterpart of ``blocksparse_tpu/ops/matmul.py``: the same constructor
arguments, block-id order (z-order), LUTs, weight shape and NumPy goldens,
so a layout and its weights move between the two packages unchanged.

The op is a ``torch.autograd.Function`` (the JAX ``_bsmm`` custom_vjp):
forward = fprop, backward = (bprop, updat), with dw cast to W's dtype.
On a CUDA tensor each direction runs a hand-written kernel
(``kernels/bsmm.py``), chosen by ``mode`` as the JAX op chooses among its
TPU schedules; on a CPU tensor, or with ``impl="xla"``, it runs the plain
PyTorch version.

With ``w_layout="fprop_packed"`` the weights are kept in the JAX op's TPU
fprop schedule order (``kernels/packed_order.py`` rebuilds it): the op
gathers the store's canonical blocks (``_Unpack``) before the same kernels,
and dW comes back in the store, its padding zero.

The gates (``gate``, ``gate_grad``, ``dw_gated``) scale W by a per-block
gate before the same kernels (a NumPy gate with ``dw_gated`` and no
``gate_grad`` instead builds an op over the surviving blocks, so the
kernels launch only those); the gate's scaling and its gradient's
per-block sums are plain PyTorch, as the JAX package leaves them to XLA.
Beside the op: its initializers (``ortho_init``, ``identity_init``,
``checker_init``), ``prune``, ``l2_normalize`` (plain PyTorch, autograd's
gradient) with its NumPy goldens, ``SparseProj`` (the dense <-> sparse
feature projections of the sparse LSTM) and the free functions
``largest_block``, ``coarsen_layout``, ``block_reduced_full_dw``,
``dw_matmul_large_n`` and the group no-ops.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from blocksparse_tpu_torch.kernels import bsmm as bsmm_kernels
from blocksparse_tpu_torch.kernels import packed_order
from blocksparse_tpu_torch.kernels.bsmm import device_sm_count
from blocksparse_tpu_torch.utils import ceil_div, z_order_2d

_MODES = ("auto", "grouped", "dense_tile", "window", "resident", "fine")


def largest_block(dim):
    """(block, dim // block) for the largest of 32, 16, 8 dividing dim."""
    for blk in (32, 16, 8):
        if dim % blk == 0:
            return (blk, dim // blk)
    raise ValueError("dimension not multiple of 8, 16, or 32")


class BlocksparseMatMul:
    """Block-sparse matmul op object.

    layout: 2-D 0/1 array (CB, KB) of nonzero blocks.
    block_size: 8, 16, 32, 64 or 128.
    feature_axis: 0 => activations are (C, N); 1 => (N, C), the
        orientation the kernel runs natively.
    impl: None or "pallas" run the CUDA kernels on CUDA tensors; "xla"
        runs the plain PyTorch version on any device.  Tensors on the CPU
        always take the plain version.
    mode: which kernel fprop and bprop run on a CUDA tensor (the
        function is the same; updat always runs ``bsmm_updat`` over
        ``updat_plan``'s groups, in bf16 and f16 on the kernel
        ``kernels.bsmm.updat_kernel`` picks (over
        ``updat_sparse_plan``'s bundles for "sparse"), N split by
        ``updat_splits``):
        - "fine" with block_size <= 32: ``bsmm_fine`` (the JAX fine
          schedule), 128-deep chunks of each output column's entries;
          with a larger block it acts as "auto"; in bf16/f16 on the
          kernel ``kernels.bsmm.fine_kernel`` picks
          (``bsmm_fine_wgmma.cu`` or ``bsmm_fine_mma.cu``);
        - "window": ``bsmm_window`` (the JAX window-slab schedule), x
          staged once per window for a super-group of columns; in
          bf16/f16 on the kernel ``kernels.bsmm.window_kernel`` picks
          (``bsmm_window_wgmma.cu`` over ``window_wgmma_plan``'s groups
          of 256 features, or ``bsmm_window_mma.cu``);
        - "grouped": ``bsmm_fprop``/``bsmm_bprop`` unsplit, always (the
          pin for A/B runs: JAX "grouped" never takes a phased cover);
        - "auto", "dense_tile", "resident": the split route (runs of
          each column's entries, whose partial tiles are summed in phase
          order: in bf16/f16 one ``bsmm_split`` launch, the runs of a
          column a thread-block cluster; in f32 ``bsmm_partials`` then
          ``bsmm_merge``) when the unsplit grid, ceil(N / TM) * n_out
          thread blocks, is smaller than the card's SM count and the
          longest column holds at least 8 entries; P = min(8, ceil(SMs /
          grid), longest // 4) runs at most, each of at least 4 entries
          (``kernels.bsmm.split_phases``).  Otherwise unsplit, in
          bf16/f16 on the kernel ``kernels.bsmm.xprop_kernel`` picks
          (``bsmm_xprop_wgmma.cu`` over ``xprop_wgmma_plan``'s column
          groups, ``bsmm_xprop_sparse.cu`` over ``xprop_sparse_plan``'s
          for sparse groups, x staged 64 input features a stage, or
          ``bsmm_xprop_mma.cu``).
        ``dispatch_mode(N)`` names the route, ``kernel_of(N, d)`` the
        kernel's source.
    tile_n, dense_tile_G, dense_tile_R: TPU schedule knobs; the dense-tile
        pair decides an ``fprop_packed`` store's shape and order, and
        nothing else.
    w_layout: "blocks", canonical (blocks, b, b) weights, or
        "fprop_packed", the JAX op's TPU fprop schedule order
        (``self.packed``, a ``kernels.packed_order.PackedOrder``): a panel
        store (chunks, R·b, G·b) of transposed blocks, or a slot store
        (packed_blocks, b, b), zero where no block lies.
        ``pack_weights``/``unpack_weights`` convert; the call gathers the
        canonical blocks, and dW comes back in the store.  As in the JAX
        op, ``identity_init``/``ortho_init`` index the packed store by
        block id (ROADMAP F9).

    Pickling keeps the constructor's arguments only, as the JAX op's:
    the LUTs, plans and device tensors are built again on unpickling.
    """

    def __getstate__(self):
        return {"layout": self.layout, "block_size": self.bsize,
                "feature_axis": self.axis, "z_order": self.z_order,
                "name": self.name, "impl": self.impl,
                "w_layout": self.w_layout, "mode": self.mode,
                "dense_tile_R": self.dense_tile_R}

    def __setstate__(self, state):
        self.__init__(**state)

    def __init__(self, layout, block_size=32, feature_axis=0, z_order=True,
                 name=None, impl=None, tile_n=None, w_layout="blocks",
                 mode="auto", dense_tile_G=None, dense_tile_R=None):
        if block_size not in bsmm_kernels.BLOCK_SIZES:
            raise ValueError("Unsupported block size: %d" % block_size)
        if w_layout not in ("blocks", "fprop_packed"):
            raise ValueError(f"unknown w_layout {w_layout!r}")
        if mode not in _MODES:
            raise ValueError(f"unknown mode {mode!r}")
        if impl not in (None, "pallas", "xla"):
            raise ValueError(f"unknown impl {impl!r}")
        self.axis = feature_axis
        self.bsize = block_size
        self.z_order = z_order
        self.impl = impl
        self.mode = mode
        self.tile_n = tile_n
        self.w_layout = w_layout
        self.dense_tile_R = dense_tile_R

        layout = np.asarray(layout)
        if layout.ndim != 2:
            raise ValueError("layout must be 2-D")
        CB, KB = layout.shape
        cs, ks = np.nonzero(layout)
        blocks = len(cs)
        if blocks == 0:
            raise ValueError("empty layout")

        # block ids: z-order for weight-storage locality, else row-major
        coords = list(zip(cs.tolist(), ks.tolist()))
        if z_order:
            order = sorted(range(blocks),
                           key=lambda i: z_order_2d(*coords[i]))
        else:
            order = sorted(range(blocks), key=lambda i: coords[i])
        updat_list = [coords[i] for i in order]
        self.updat_list = updat_list
        self.updat_lut = np.array(updat_list, dtype=np.int32)

        # entries grouped by output block, sorted: the accumulation order
        fprop_rows = [[] for _ in range(KB)]
        bprop_rows = [[] for _ in range(CB)]
        for w, (c, k) in enumerate(updat_list):
            fprop_rows[k].append((c, w))
            bprop_rows[c].append((k, w))
        for r in fprop_rows:
            r.sort()
        for r in bprop_rows:
            r.sort()
        self.fprop_list = [(k, lut) for k, lut in enumerate(fprop_rows)]
        self.bprop_list = [(c, lut) for c, lut in enumerate(bprop_rows)]

        def flat(rows):
            """(in, w, out) entry arrays sorted by output row, and the
            CSR row pointer over output rows."""
            ents = [(i, w, r) for r, lut in enumerate(rows) for (i, w) in lut]
            arrays = tuple(np.array(a, np.int32) for a in zip(*ents))
            row_ptr = np.concatenate(
                [[0], np.cumsum([len(r) for r in rows])]).astype(np.int32)
            return arrays, row_ptr

        self._fprop_flat, self._fprop_row_ptr = flat(fprop_rows)
        self._bprop_flat, self._bprop_row_ptr = flat(bprop_rows)
        self._luts = {}
        self._plans = {}          # (kind, d, phases) -> NumPy plan
        self._plan_luts = {}      # (device, kind, d, phases) -> tensors
        self._split_runs = {}     # (N, d, SMs) -> phases of the split rule
        self._xlaunches = {}      # (device, d, N, phases) -> f32 xprop launch
        self._updat_runs = {}     # (N, SMs) -> the updat's kernel and runs
        self._static_gates = {}   # a NumPy gate's bytes -> _StaticGate

        self._block_kb = self.updat_lut[:, 1].copy()   # for l2_normalize

        self.name = name or "BlocksparseMatMul"
        self.blocks = blocks
        self.flops = blocks * block_size * block_size * 2
        self.packed = None
        self._pack_luts = {}      # device -> the store's index tensors
        if w_layout == "fprop_packed":
            self.packed = packed_order.fprop_order(
                fprop_rows, CB, blocks, block_size, mode, dense_tile_G,
                dense_tile_R)
            self.packed_blocks = self.packed.packed_blocks
            self.w_shape = self.packed.w_shape
        else:
            self.w_shape = (blocks, block_size, block_size)
        self.g_shape = (blocks,)
        self.CB, self.KB = CB, KB
        self.C = CB * block_size
        self.K = KB * block_size
        self.sparsity = round(float(blocks) / float(CB * KB), 3)
        self.layout = layout > 0

    # ---------------- shapes / coords ----------------

    def i_shape(self, N):
        return (N, self.C) if self.axis else (self.C, N)

    def o_shape(self, N):
        return (N, self.K) if self.axis else (self.K, N)

    def block_coord(self, block):
        return self.updat_list[block]

    # ---------------- initializers ----------------

    def _ortho_blocks(self, normal, dtype=np.float32):
        """Orthogonal blocks: each output block-column's stacked blocks
        (its LUT's, top to bottom) are the left singular vectors of a
        matrix drawn by ``normal(mean, std, shape)``; with every block
        present, the whole (C, K) matrix's."""
        W = np.empty(self.w_shape, dtype=dtype)
        bsize = self.bsize
        if self.sparsity < 1.0:
            for k, lut in self.fprop_list:
                if not lut:
                    continue
                shp = (len(lut) * bsize, bsize)
                a = normal(0.0, 1.0, shp).astype(dtype)
                u, _, v = np.linalg.svd(a, full_matrices=False)
                if u.shape != shp:
                    u = v
                for i, (c, w) in enumerate(lut):
                    W[w, :, :] = u[i * bsize:(i + 1) * bsize, :]
        else:
            shp = (self.C, self.K)
            a = normal(0.0, 1.0, shp).astype(dtype)
            u, _, v = np.linalg.svd(a, full_matrices=False)
            if u.shape != shp:
                u = v
            for w, (c, k) in enumerate(self.updat_list):
                W[w, :, :] = u[c * bsize:(c + 1) * bsize,
                               k * bsize:(k + 1) * bsize]
        return W

    def ortho_init(self):
        """Initializer of orthogonal blocks drawn from the global
        ``np.random``, as the JAX op's: after the same ``np.random.seed``
        both give the same W bit for bit."""
        def _initializer(shape=None, dtype=np.float32, key=None):
            return self._ortho_blocks(np.random.normal, dtype)
        return _initializer

    def identity_init(self, scale=1.0):
        def _initializer(shape=None, dtype=np.float32, key=None):
            W = np.zeros(self.w_shape, dtype=dtype)
            for w in range(self.blocks):
                cb, kb = self.updat_list[w]
                if (cb % self.KB) == (kb % self.CB):
                    W[w] = np.eye(self.bsize, dtype=dtype) * scale
            return W
        return _initializer

    def checker_init(self):
        """Initializer of a checkerboard gate: 1 where block row and
        column have the same parity."""
        def _initializer(shape=None, dtype=np.float32, key=None):
            gate = np.empty(self.blocks, dtype=dtype)
            for w, (c, k) in enumerate(self.updat_list):
                gate[w] = (c & 1) ^ (k & 1) ^ 1
            return gate
        return _initializer

    def prune(self, param, gate):
        """Drop the blocks whose gate is zero; returns (new_param,
        new_gate of ones).  Clears those blocks in ``self.layout`` in
        place, as the JAX op does; the caller builds a new op from it."""
        param = np.asarray(param)
        gate = np.asarray(gate)
        new_blocks = int(np.sum(gate != 0.0))
        if new_blocks != self.blocks:
            new_param = np.empty((new_blocks, self.bsize, self.bsize),
                                 dtype=param.dtype)
            new_w = 0
            layout = self.layout
            for w, (c, k) in enumerate(self.updat_list):
                if gate[w] == 0.0:
                    layout[c, k] = False
                else:
                    new_param[new_w] = param[w]
                    new_w += 1
        else:
            new_param = param
        return new_param, np.ones((new_blocks,), dtype=gate.dtype)

    # ---------------- NumPy goldens (the JAX package's) ----------------

    def fprop_test(self, I, W, gate=None):
        bsize = self.bsize
        if self.axis:
            O = np.zeros((I.shape[0], self.KB, bsize))
            I = I.reshape((-1, self.CB, bsize))
            for k, lut in self.fprop_list:
                for c, w in lut:
                    g = 1.0 if gate is None else gate[w]
                    if g != 0.0:
                        O[:, k, :] += np.dot(I[:, c, :], W[w]) * g
            return O.reshape(I.shape[0], -1)
        N = I[0].size
        O = np.zeros((self.KB, bsize, N))
        I = I.reshape((self.CB, bsize, N))
        for k, lut in self.fprop_list:
            for c, w in lut:
                g = 1.0 if gate is None else gate[w]
                if g != 0.0:
                    O[k, :, :] += np.dot(W[w].T, I[c, :, :]) * g
        return O.reshape(-1, N)

    def bprop_test(self, E, W, gate=None):
        bsize = self.bsize
        if self.axis:
            B = np.zeros((E.shape[0], self.CB, bsize))
            E = E.reshape((-1, self.KB, bsize))
            for c, lut in self.bprop_list:
                for k, w in lut:
                    g = 1.0 if gate is None else gate[w]
                    if g != 0.0:
                        B[:, c, :] += np.dot(E[:, k, :], W[w].T) * g
            return B.reshape(E.shape[0], -1)
        N = E[0].size
        B = np.zeros((self.CB, bsize, N))
        E = E.reshape((self.KB, bsize, N))
        for c, lut in self.bprop_list:
            for k, w in lut:
                g = 1.0 if gate is None else gate[w]
                if g != 0.0:
                    B[c, :, :] += np.dot(W[w], E[k, :, :]) * g
        return B.reshape(-1, N)

    def updat_test(self, I, E, gate=None, dw_gated=False):
        """dw, canonical (blocks, b, b); times the gate with
        ``dw_gated``."""
        U = np.zeros((self.blocks, self.bsize, self.bsize))
        bsize = self.bsize
        if self.axis:
            I = I.reshape((-1, self.CB, bsize))
            E = E.reshape((-1, self.KB, bsize))
            for w, (c, k) in enumerate(self.updat_list):
                g = gate[w] if (dw_gated and gate is not None) else 1.0
                if g != 0.0:
                    U[w] = np.dot(I[:, c, :].T, E[:, k, :]) * g
        else:
            I = I.reshape((self.CB, bsize, -1))
            E = E.reshape((self.KB, bsize, -1))
            for w, (c, k) in enumerate(self.updat_list):
                g = gate[w] if (dw_gated and gate is not None) else 1.0
                if g != 0.0:
                    U[w] = np.dot(I[c], E[k].T) * g
        return U

    def l2_normalize_test(self, W, epsilon=1e-12):
        W = np.array(W, copy=True)
        for k, lut in self.fprop_list:
            ws = [w for c, w in lut]
            if not ws:
                continue
            W2 = W[ws].reshape(-1, self.bsize)
            norm = np.sqrt(np.maximum(
                np.sum(np.square(W2), axis=0, keepdims=True), epsilon))
            for w in ws:
                W[w] /= norm
        return W

    def l2_normalize_grad_test(self, W, U, epsilon=1e-12):
        U = np.array(U, copy=True)
        for k, lut in self.fprop_list:
            ws = [w for c, w in lut]
            if not ws:
                continue
            W2 = W[ws].reshape(-1, self.bsize)
            U2 = U[ws].reshape(-1, self.bsize)
            sum_sqr_w = np.sum(np.square(W2), axis=0, keepdims=True)
            max_w = np.maximum(sum_sqr_w, epsilon)
            norm_grad = (U2 + W2 * (sum_sqr_w >= epsilon)
                         * np.sum(-U2 * W2 / max_w, axis=0, keepdims=True)
                         ) / np.sqrt(max_w)
            norm_grad = norm_grad.reshape(-1, self.bsize, self.bsize)
            for i, w in enumerate(ws):
                U[w] = norm_grad[i]
        return U

    def l2_normalize(self, W, gain=None, epsilon=1e-12, dtype=None):
        """Joint L2 normalization of each layout block-column: every
        output column of W divided by its norm over the column's blocks
        (at least sqrt(epsilon)), times ``gain`` (K,) where given; in f32,
        cast to ``dtype`` (default W's).  Plain PyTorch; autograd's
        gradient is ``l2_normalize_grad_test``'s."""
        kb = torch.as_tensor(self._block_kb, dtype=torch.int64,
                             device=W.device)
        w32 = W.to(torch.float32)
        sq = w32.square().sum(dim=1)                       # (blocks, b)
        ssq = torch.zeros((self.KB, self.bsize), dtype=torch.float32,
                          device=W.device).index_add(0, kb, sq)
        norm = torch.sqrt(torch.clamp(ssq, min=epsilon))
        wn = w32 / norm[kb][:, None, :]
        if gain is not None:
            g = gain.reshape(self.KB, self.bsize).to(torch.float32)
            wn = wn * g[kb][:, None, :]
        return wn.to(dtype or W.dtype)

    # ---------------- packed weight conversions ----------------

    def _order(self):
        if self.packed is None:
            raise ValueError("the op keeps canonical 'blocks' weights")
        return self.packed

    def pack_weights(self, w):
        """Canonical (blocks, b, b) weights -> the packed store, zero
        where no block lies (a NumPy array or a tensor, as given)."""
        order = self._order()
        if isinstance(w, torch.Tensor):
            return self._pack_tensor(w)
        if order.panels:
            b = self.bsize
            w_ext = np.concatenate([w, np.zeros((1, b, b), w.dtype)], axis=0)
            cells = w_ext[order.wpos].swapaxes(-1, -2)     # (S, R, G, b, b)
            return cells.transpose(0, 1, 3, 2, 4).reshape(self.w_shape)
        out = np.zeros(self.w_shape, w.dtype)
        out[order.pos] = w
        return out

    def unpack_weights(self, w_packed):
        """The packed store -> canonical (blocks, b, b) weights (a NumPy
        array, or a tensor through ``_Unpack``, whose gradient is the
        repacked dW)."""
        order = self._order()
        if isinstance(w_packed, torch.Tensor):
            return _Unpack.apply(w_packed, self)
        if order.panels:
            S, R, G = order.wpos.shape
            b = self.bsize
            pv = w_packed.reshape(S, R, b, G, b).transpose(0, 1, 3, 2, 4) \
                .reshape(-1, b, b)
            return pv[order.pos].swapaxes(-1, -2)
        return w_packed[order.pos]

    def _pack_index(self, device):
        """The store's index tensors on ``device`` (int64), uploaded once:
        each block's chunk, lane band and slot (panel store), or its slot
        (slot store)."""
        idx = self._pack_luts.get(device)
        if idx is None:
            order = self._order()
            pos = torch.as_tensor(order.pos, dtype=torch.int64,
                                  device=device)
            if order.panels:
                _, R, G = order.wpos.shape
                idx = (pos // (R * G), pos // G % R, pos % G)
            else:
                idx = (pos,)
            self._pack_luts[device] = idx
        return idx

    def _cells(self, store):
        """The panel store as (S, R, G, b, b), cell (s, r, i) holding its
        block untransposed: a view, no copy."""
        S, R, G = self.packed.wpos.shape
        b = self.bsize
        return store.reshape(S, R, b, G, b).permute(0, 1, 3, 4, 2)

    def _unpack_tensor(self, store):
        idx = self._pack_index(store.device)
        if self.packed.panels:
            return self._cells(store)[idx]
        return store.index_select(0, idx[0])

    def _pack_tensor(self, w):
        """Canonical blocks written into a zero store; each block has its
        own cell, so no two writes meet (no atomics, one result)."""
        idx = self._pack_index(w.device)
        store = w.new_zeros(self.w_shape)
        if self.packed.panels:
            self._cells(store).index_put_(idx, w)
            return store
        return store.index_copy_(0, idx[0], w)

    # ---------------- device op ----------------

    def _lut(self, device):
        """The LUTs on ``device``, uploaded once: the kernels' CSRs (row_ptr,
        entries as int32) and the plain versions' flat index arrays
        (int64), for fprop, bprop and updat."""
        lut = self._luts.get(device)
        if lut is None:
            def t(a, dt):
                return torch.as_tensor(a, dtype=dt, device=device)
            lut = {}
            for d, (ib, wb, ob), row_ptr in (
                    ("f", self._fprop_flat, self._fprop_row_ptr),
                    ("b", self._bprop_flat, self._bprop_row_ptr)):
                lut.update({f"{d}_row_ptr": t(row_ptr, torch.int32),
                            f"{d}_ent_in": t(ib, torch.int32),
                            f"{d}_ent_w": t(wb, torch.int32),
                            f"{d}_in": t(ib, torch.int64),
                            f"{d}_w": t(wb, torch.int64),
                            f"{d}_out": t(ob, torch.int64)})
            for i, name in enumerate(("u_c", "u_k")):
                lut[name + "32"] = t(self.updat_lut[:, i], torch.int32)
                lut[name] = t(self.updat_lut[:, i], torch.int64)
            self._luts[device] = lut
        return lut

    def _plain(self, x):
        return self.impl == "xla" or not x.is_cuda

    # ---------------- kernel routes ----------------

    def _csr(self, d):
        """(row_ptr, (in, w, out) entries, n_out, n_in) of direction d."""
        if d == "f":
            return self._fprop_row_ptr, self._fprop_flat, self.KB, self.CB
        return self._bprop_row_ptr, self._bprop_flat, self.CB, self.KB

    def _phases(self, N, d, sms):
        """Runs of the split rule for N rows on a card of ``sms`` SMs (0 =
        unsplit)."""
        key = (N, d, sms)
        if key not in self._split_runs:
            self._split_runs[key] = bsmm_kernels.split_phases(
                N, self.bsize, self._csr(d)[0], sms)
        return self._split_runs[key]

    def _route(self, N, d, sms):
        """The kernel direction d takes for N rows on a card of ``sms``
        SMs: "fine", "window", "phased" (split) or "grouped" (unsplit)."""
        if self.mode == "fine" and \
                self.bsize in bsmm_kernels.FINE_BLOCK_SIZES:
            return "fine"
        if self.mode == "window":
            return "window"
        if self.mode != "grouped" and self._phases(N, d, sms):
            return "phased"
        return "grouped"

    def dispatch_mode(self, N, itemsize=2, sm_count=None):
        """The kernel the fprop of a CUDA tensor of N rows runs, as the JAX
        op's ``dispatch_mode`` names it: "fine", "window", "phased" (the
        split route, its runs' partial tiles summed in phase order) or
        "grouped" (the unsplit ``bsmm_fprop``).  sm_count: the card's
        SMs, by default the current CUDA device's.  itemsize is accepted
        for the JAX signature; the routes do not depend on it."""
        return self._route(N, "f", sm_count if sm_count is not None
                           else device_sm_count())

    def updat_splits(self, N, dtype=torch.bfloat16, sm_count=None):
        """Runs of N the updat of N rows takes on a card of ``sm_count`` SMs
        (default the current CUDA device's): 1 (unsplit) in f32, whose
        kernel walks all of N; in bf16 and f16 the split rule
        (``kernels.bsmm.updat_splits``) over this layout's groups for the
        kernel ``updat_kernel`` picks."""
        return self._updat_route(N, dtype, sm_count)[1]

    def _updat_route(self, N, dtype, sm_count=None):
        """(kernel, runs of N) of the updat of N rows: ("mma", 1) in f32
        (``bsmm_updat.cu``, which reads no kernel name); in bf16 and f16
        ``kernels.bsmm.updat_kernel``'s kernel and its split."""
        if dtype == torch.float32:
            return "mma", 1
        sms = sm_count if sm_count is not None else device_sm_count()
        key = (N, sms)
        if key not in self._updat_runs:
            groups = len(self._plan("updat", "u")["grp_q"])
            tiles = None
            if self.bsize in bsmm_kernels.UPDAT_SP_BUNDLES:
                tiles = (self._plan("updat_sparse", "u")["tiles"],
                         self.blocks + groups)
            kernel = bsmm_kernels.updat_kernel(N, self.bsize, groups, sms,
                                               tiles)
            if kernel == "sparse":
                groups = len(self._plan("updat_sparse", "u")["grp_q"])
            self._updat_runs[key] = kernel, bsmm_kernels.updat_splits(
                N, groups, self.bsize, sms, kernel)
        return self._updat_runs[key]

    def kernel_of(self, N, d, dtype=torch.bfloat16, sm_count=None):
        """The source (``csrc/<name>.cu``) the kernel of direction d ("f"
        fprop, "b" bprop, "u" updat) of a CUDA tensor of N rows in
        ``dtype`` launches on a card of ``sm_count`` SMs (default the
        current device's).  The split route's is "bsmm_xprop_mma" in
        bf16/f16 (the fused split) and "bsmm_fprop" in f32 (its partial
        tiles, which ``bsmm_merge.cu`` then sums)."""
        sms = sm_count if sm_count is not None else device_sm_count()
        f32 = dtype == torch.float32
        if d == "u":
            if f32:
                return "bsmm_updat"
            return "bsmm_updat_" + self._updat_route(N, dtype, sms)[0]
        route = self._route(N, d, sms)
        if route in ("fine", "window"):
            return f"bsmm_{route}" + ("" if f32 else
                                      "_" + self._mkernel(route, N, d, sms))
        if f32:
            return "bsmm_fprop"
        if route == "phased":
            return "bsmm_xprop_mma"
        return "bsmm_xprop_" + self._xkernel(N, d, sms)

    def _xkernel(self, N, d, sms):
        """The unsplit bf16/f16 xprop's kernel of direction d at N rows
        (``kernels.bsmm.xprop_kernel`` over its wgmma plan's share):
        "wgmma", "sparse" or "mma"."""
        share = self._plan("wgmma", d)["share"] \
            if self.bsize in bsmm_kernels.XPROP_WG_SHARE_BLOCK_SIZES else 0.0
        return bsmm_kernels.xprop_kernel(N, self.bsize, self._csr(d)[2], sms,
                                         share)

    def _mkernel(self, route, N, d, sms):
        """The bf16/f16 kernel of mode route "fine" or "window" in direction
        d at N rows (``kernels.bsmm.fine_kernel`` / ``window_kernel``):
        "wgmma" or "mma"."""
        rule = bsmm_kernels.fine_kernel if route == "fine" \
            else bsmm_kernels.window_kernel
        return rule(N, self.bsize, self._csr(d)[2], sms)

    def _plan(self, kind, d, phases=0):
        """The host-side plan (NumPy) of a route, built once (kind "updat":
        the updat's groups, d "u"; kind "updat_sparse": those of
        ``bsmm_updat_sparse.cu``, d "u"; kind "xgroup": ``bsmm_fprop.cu``'s
        column groups over direction d's CSR, or with ``phases`` over the
        split plan's tiles; kind "wgmma": ``bsmm_xprop_wgmma.cu``'s column
        groups and their items over direction d's CSR; kind "sparse":
        ``bsmm_xprop_sparse.cu``'s over direction d's CSR; kind
        "window_wgmma": ``bsmm_window_wgmma.cu``'s)."""
        key = (kind, d, phases)
        plan = self._plans.get(key)
        if plan is None:
            row_ptr, (ib, wb, _), _, n_in = self._csr(d)
            if kind == "updat":
                plan = bsmm_kernels.updat_plan(
                    self.updat_lut[:, 0], self.updat_lut[:, 1], self.bsize)
            elif kind == "updat_sparse":
                plan = bsmm_kernels.updat_sparse_plan(
                    self.updat_lut[:, 0], self.updat_lut[:, 1], self.bsize,
                    (self.C, self.K))
            elif kind == "wgmma":
                plan = bsmm_kernels.xprop_wgmma_plan(row_ptr, ib, wb,
                                                     self.bsize)
            elif kind == "sparse":
                plan = bsmm_kernels.xprop_sparse_plan(row_ptr, ib, wb,
                                                      self.bsize)
            elif kind == "xgroup":
                if phases:
                    row_ptr = self._plan("split", d, phases)["tile_ptr"]
                plan = bsmm_kernels.xprop_groups(row_ptr, ib, self.bsize)
            elif kind == "fine":
                plan = bsmm_kernels.fine_plan(row_ptr, ib, wb, self.bsize)
            elif kind == "window":
                plan = bsmm_kernels.window_plan(row_ptr, ib, wb, n_in,
                                                self.bsize)
            elif kind == "window_wgmma":
                plan = bsmm_kernels.window_wgmma_plan(row_ptr, ib, wb,
                                                      self.bsize)
            else:
                plan = bsmm_kernels.split_plan(row_ptr, phases)
            self._plans[key] = plan
        return plan

    def _plan_tensors(self, device, kind, d, phases=0):
        """A plan with its index arrays on ``device``, uploaded once (int32);
        its other entries as they are."""
        key = (device, kind, d, phases)
        out = self._plan_luts.get(key)
        if out is None:
            out = {k: torch.as_tensor(v, device=device)
                   if isinstance(v, np.ndarray) else v
                   for k, v in self._plan(kind, d, phases).items()}
            self._plan_luts[key] = out
        return out

    def _xlaunch(self, device, d, N, phases=0):
        """``bsmm_fprop.cu``'s launch (``xprop_launch``) for direction d at
        N rows on ``device``, over the columns or, with ``phases``, the
        split plan's tiles, in the configuration ``xprop_tile`` picks:
        resolved once, so a call reads it from one dict."""
        key = (device, d, N, phases)
        out = self._xlaunches.get(key)
        if out is None:
            plan = self._plan_tensors(device, "xgroup", d, phases)
            out = bsmm_kernels.xprop_launch(plan, bsmm_kernels.xprop_tile(
                N, self.bsize, plan, device_sm_count(device)))
            self._xlaunches[key] = out
        return out

    def xprop_split_plain(self, x, w, d, sm_count):
        """The split route on the plain versions: the partial tiles of the
        split rule's runs for a card of ``sm_count`` SMs through
        ``xprop_plain`` in f32, then ``merge_plain``.  2-D x; d "f"
        (fprop) or "b" (bprop).  Raises where the rule does not split."""
        xn = x if self.axis else x.t()
        phases = self._phases(xn.shape[0], d, sm_count)
        if not phases:
            raise ValueError(f"the split rule does not split {xn.shape[0]} "
                             f"rows on {sm_count} SMs")
        plan = self._plan("split", d, phases)
        _, (ib, wb, _), _, _ = self._csr(d)
        tile_of = np.repeat(np.arange(plan["tiles"]),
                            np.diff(plan["tile_ptr"]))
        t = functools.partial(torch.as_tensor, dtype=torch.int64,
                              device=x.device)
        parts = bsmm_kernels.xprop_plain(
            xn, w, t(ib), t(wb), t(tile_of), plan["tiles"], self.bsize, 1,
            trans_w=d == "b", out_dtype=torch.float32)
        y = bsmm_kernels.merge_plain(parts, t(plan["merge_idx"]),
                                     self.bsize, out_dtype=x.dtype)
        return y if self.axis else y.t()

    def _nc(self, a):
        """A 2-D activation in the kernels' (N, features) orientation (no
        copy when ``a`` is the transposed view of such an array)."""
        return (a if self.axis else a.t()).contiguous()

    def _xprop(self, x, w, d):
        """fprop (d="f") or bprop (d="b") of a 2-D activation, of x's
        dtype; x and w of two dtypes multiply in their promoted one."""
        lut = self._lut(x.device)
        n_out = self.KB if d == "f" else self.CB
        if self._plain(x):
            return bsmm_kernels.xprop_plain(
                x, w, lut[f"{d}_in"], lut[f"{d}_w"], lut[f"{d}_out"], n_out,
                self.bsize, self.axis, trans_w=d == "b", out_dtype=x.dtype)
        out_dtype = x.dtype
        if w.dtype != x.dtype:
            # the JAX product of mixed operands: both in the promoted
            # dtype (f32 for bf16 x and f32 w), rounded to x's on output
            dt = torch.promote_types(x.dtype, w.dtype)
            x, w = x.to(dt), w.to(dt)
        xn, wc, b, trans = self._nc(x), w.contiguous(), self.bsize, d == "b"
        sms = device_sm_count(x.device)
        route = self._route(xn.shape[0], d, sms)
        if route == "fine":
            p = self._plan_tensors(x.device, "fine", d)
            kernel = "mma" if x.dtype == torch.float32 else \
                self._mkernel(route, xn.shape[0], d, sms)
            y = bsmm_kernels.bsmm_fine(xn, wc, p["chunk_ptr"], p["slot_in"],
                                       p["slot_w"], b, n_out, trans, kernel)
        elif route == "window":
            p = self._plan_tensors(x.device, "window", d)
            plan = None
            if x.dtype != torch.float32 and \
                    self._mkernel(route, xn.shape[0], d, sms) == "wgmma":
                plan = self._plan_tensors(x.device, "window_wgmma", d)
            y = bsmm_kernels.bsmm_window(xn, wc, p["ptr"], p["ent_slot"],
                                         p["ent_w"], b, n_out, trans, plan)
        elif route == "phased":
            phases = self._phases(xn.shape[0], d, sms)
            p = self._plan_tensors(x.device, "split", d, phases)
            ents = (lut[f"{d}_ent_in"], lut[f"{d}_ent_w"])
            if x.dtype == torch.float32:
                parts = bsmm_kernels.bsmm_partials(
                    xn, wc, p["tile_ptr"], *ents, b,
                    p["tile_ptr"].numel() - 1, trans,
                    plan=self._xlaunch(x.device, d, xn.shape[0], phases))
                y = bsmm_kernels.bsmm_merge(parts, p["merge_idx"], b, x.dtype)
            else:
                y = bsmm_kernels.bsmm_split(xn, wc, p["tile_ptr"], *ents,
                                            p["merge_idx"], b, n_out, trans)
        else:
            kernel = bsmm_kernels.bsmm_bprop if trans \
                else bsmm_kernels.bsmm_fprop
            if x.dtype == torch.float32:
                plan = self._xlaunch(x.device, d, xn.shape[0])
            else:
                # the plan of the kernel's own name ("wgmma", "sparse")
                xkernel = self._xkernel(xn.shape[0], d, sms)
                plan = None if xkernel == "mma" else \
                    self._plan_tensors(x.device, xkernel, d)
            y = kernel(xn, wc, lut[f"{d}_row_ptr"], lut[f"{d}_ent_in"],
                       lut[f"{d}_ent_w"], b, n_out, plan=plan)
        y = y.to(out_dtype)
        # feature_axis 0: the (features, N) view of the kernel's (N,
        # features) output; a consumer in that orientation copies nothing
        return y if self.axis else y.t()

    def _updat(self, x, dy):
        """dw (blocks, b, b) in f32 from 2-D x and dy."""
        lut = self._lut(x.device)
        if self._plain(x):
            return bsmm_kernels.updat_plain(x, dy, lut["u_c"], lut["u_k"],
                                            self.bsize, self.axis)
        if dy.dtype != x.dtype:
            dt = torch.promote_types(x.dtype, dy.dtype)
            x, dy = x.to(dt), dy.to(dt)
        xn, dyn = self._nc(x), self._nc(dy)
        kernel, splits = self._updat_route(xn.shape[0], x.dtype,
                                           device_sm_count(x.device))
        plan = self._plan_tensors(
            x.device, "updat_sparse" if kernel == "sparse" else "updat", "u")
        return bsmm_kernels.bsmm_updat(xn, dyn, lut["u_c32"], lut["u_k32"],
                                       self.bsize, plan, splits, kernel)

    def matmul(self, I, W, **kwargs):
        return self.__call__(I, W, **kwargs)

    def __call__(self, I, W, gate=None, gate_grad=False, dw_gated=False,
                 name=None, bench=0):
        """y = I · W over the layout; I is (..., C) for feature_axis=1,
        (C, ...) for feature_axis=0.  Differentiable in I and W (and in a
        tensor ``gate``).  ``name`` and ``bench`` are accepted and change
        nothing.

        gate: None, or a per-block gate (blocks,) that scales each block
        of W (in f32, cast back to W's dtype) before the usual kernels.
        ``dw_gated``: dw is the raw updat times the gate (else the raw
        updat); ``gate_grad``: the gate's gradient is each block's sum of
        dw_raw · W (else zero).  A NumPy gate with ``dw_gated`` and no
        ``gate_grad`` is static: the product runs on an op over the
        blocks whose gate is nonzero, built once for the gate's bytes, so
        the kernels launch only those (all zero: y and the gradients are
        zeros)."""
        if tuple(W.shape) != self.w_shape:
            raise ValueError(f"W must be {self.w_shape}, got "
                             f"{tuple(W.shape)}")
        if self.packed is not None:
            W = self.unpack_weights(W)
        shape = I.shape
        if self.axis == 0:
            if shape[0] != self.C:
                raise ValueError(f"I must be ({self.C}, ...), got {shape}")
            x, out_shape = I.reshape(self.C, -1), (self.K,) + tuple(shape[1:])
        else:
            if shape[-1] != self.C:
                raise ValueError(f"I must be (..., {self.C}), got {shape}")
            x, out_shape = I.reshape(-1, self.C), tuple(shape[:-1]) + (self.K,)
        grad = torch.is_grad_enabled() and (I.requires_grad
                                            or W.requires_grad)
        if gate is None:
            y = _BsmmFunction.apply(x, W, self) if grad \
                else self._xprop(x, W, "f")
        elif isinstance(gate, np.ndarray) and dw_gated and not gate_grad:
            static = self._static_gate(gate)
            y = _StaticGatedFunction.apply(x, W, static) if grad \
                else static.fprop(x, W)
        else:
            if not isinstance(gate, torch.Tensor):
                gate = torch.as_tensor(np.asarray(gate), device=x.device)
            if grad or (torch.is_grad_enabled() and gate.requires_grad):
                y = _GatedFunction.apply(x, W, gate, self, bool(dw_gated),
                                         bool(gate_grad))
            else:
                y = self._xprop(x, _gated(W, gate), "f")
        return y.reshape(out_shape)

    def _static_gate(self, gate):
        """The ``_StaticGate`` of a NumPy gate, built once for its bytes."""
        key = np.asarray(gate).tobytes()
        if key not in self._static_gates:
            self._static_gates[key] = _StaticGate(self, gate)
        return self._static_gates[key]


def _gated(w, gate):
    """W with each block times its gate, in f32, cast back to W's dtype."""
    return (w.to(torch.float32)
            * gate.to(torch.float32)[:, None, None]).to(w.dtype)


class _BsmmFunction(torch.autograd.Function):
    """The JAX ``_bsmm`` custom_vjp: forward = fprop; backward = bprop for
    dx (cast to x's dtype) and updat for dw (f32, cast to W's dtype, as
    ``ops/matmul.py:1156`` of the JAX package does)."""

    @staticmethod
    def forward(ctx, x, w, op):
        ctx.save_for_backward(x, w)
        ctx.op = op
        return op._xprop(x, w, "f")

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        op = ctx.op
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = op._xprop(dy, w, "b").to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = op._updat(x, dy).to(w.dtype)
        return dx, dw, None


class _Unpack(torch.autograd.Function):
    """A packed store's canonical blocks (a gather); the backward writes
    dW's blocks into their cells of a zero store, as the JAX op's
    ``_repack_dw``, so the store's padding gets exactly zero."""

    @staticmethod
    def forward(ctx, store, op):
        ctx.op = op
        return op._unpack_tensor(store)

    @staticmethod
    def backward(ctx, dw):
        return ctx.op._pack_tensor(dw), None


class _GatedFunction(torch.autograd.Function):
    """The JAX ``_bsmm_gated(dw_gated, gate_grad)`` custom_vjp (the pair
    passed in, where JAX caches one function a pair): fprop and bprop on
    the gated W, updat on x and dy; dw = dw_raw · gate with ``dw_gated``,
    dg = Σ_block dw_raw · W with ``gate_grad`` (else zeros)."""

    @staticmethod
    def forward(ctx, x, w, gate, op, dw_gated, gate_grad):
        ctx.save_for_backward(x, w, gate)
        ctx.op, ctx.flags = op, (dw_gated, gate_grad)
        return op._xprop(x, _gated(w, gate), "f")

    @staticmethod
    def backward(ctx, dy):
        x, w, gate = ctx.saved_tensors
        op, (dw_gated, gate_grad) = ctx.op, ctx.flags
        need_x, need_w, need_g = ctx.needs_input_grad[:3]
        dx = dw = dg = None
        if need_x:
            dx = op._xprop(dy, _gated(w, gate), "b").to(x.dtype)
        if need_w or (need_g and gate_grad):
            dw_raw = op._updat(x, dy)
            if need_w:
                dw = (dw_raw * gate.to(torch.float32)[:, None, None]
                      if dw_gated else dw_raw).to(w.dtype)
        if need_g:
            dg = (dw_raw * w.to(torch.float32)).sum(dim=(1, 2)) \
                .to(gate.dtype) if gate_grad else torch.zeros_like(gate)
        return dx, dw, dg, None, None, None


class _StaticGate:
    """A static gate's product: ``sub``, the op over the blocks whose gate
    is nonzero (None when none is), their ids in the gated op (``ids``)
    and their gate values (``gv``, f32), the last two uploaded once a
    device.  The kernels launch only the surviving blocks."""

    def __init__(self, op, gate):
        gate = np.asarray(gate)
        keep = np.flatnonzero(gate != 0)
        self.op, self.sub, self._tensors = op, None, {}
        if keep.size == 0:
            return
        layout = np.zeros(op.layout.shape, np.int32)
        for i in keep:
            layout[op.updat_list[i]] = 1
        self.sub = BlocksparseMatMul(layout, op.bsize, op.axis,
                                     z_order=op.z_order, impl=op.impl,
                                     mode=op.mode)
        orig = {coord: w for w, coord in enumerate(op.updat_list)}
        self.ids = np.array([orig[c] for c in self.sub.updat_list], np.int64)
        self.gv = np.asarray(gate, np.float32)[self.ids]

    def _on(self, device):
        if device not in self._tensors:
            self._tensors[device] = (
                torch.as_tensor(self.ids, device=device),
                torch.as_tensor(self.gv, device=device))
        return self._tensors[device]

    def weights(self, w):
        """The surviving blocks of W, each times its gate."""
        ids, gv = self._on(w.device)
        return _gated(w.index_select(0, ids), gv)

    def fprop(self, x, w):
        if self.sub is None:
            op = self.op
            shape = (x.shape[0], op.K) if op.axis else (op.K, x.shape[1])
            return x.new_zeros(shape)
        return self.sub._xprop(x, self.weights(w), "f")


class _StaticGatedFunction(torch.autograd.Function):
    """The JAX ``_static_gated`` custom_vjp: fprop, bprop and updat on the
    op of the surviving blocks; dw = updat · gate scattered back into the
    gated op's blocks, zeros elsewhere."""

    @staticmethod
    def forward(ctx, x, w, static):
        ctx.save_for_backward(x, w)
        ctx.static = static
        return static.fprop(x, w)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        static = ctx.static
        sub = static.sub
        if sub is None:
            return torch.zeros_like(x), torch.zeros_like(w), None
        dx = sub._xprop(dy, static.weights(w), "b").to(x.dtype)
        ids, gv = static._on(w.device)
        dws = sub._updat(x, dy) * gv[:, None, None]
        dw = torch.zeros(w.shape, dtype=dws.dtype, device=w.device) \
            .index_copy(0, ids, dws)
        return dx, dw.to(w.dtype), None


# ------------------------------------------------------------------
# The JAX package's graph-rewrite shims: autograd sums the gradients of a
# weight (or gate) shared across applications, as JAX's AD does.
# ------------------------------------------------------------------

def group_param_grads(param_grad, group_size=8):
    """Returns its input: autograd already sums a shared weight's
    gradients over its applications (the reference rewrote the graph to
    chain its dw ops)."""
    return param_grad


def group_dg_grads(gate_grad, group_size=8):
    """Returns its input (``group_param_grads`` for a shared gate)."""
    return gate_grad


def get_bsmm_dx_ops(param_grad):
    raise NotImplementedError(
        "graph introspection has no PyTorch equivalent; use "
        "torch.autograd.grad directly")


def block_reduced_full_dw(xs, gs, bsize=32, axis=0, norm="max", scale=1.0):
    """Block-norm-reduced *full* dw, for growing a layout: the dense
    dw = Σ_t x_t · g_tᵀ in f32 (axis 0: x (C, N), g (K, N); else (N, C),
    (N, K)), each (bsize, bsize) block reduced to its max-abs ("max") or
    L2 norm, times ``scale``: a (CB, KB) array."""
    if len(xs) != len(gs):
        raise ValueError("xs and gs must pair up")
    f32 = torch.float32
    acc = None
    for x, g in zip(xs, gs):
        eq = "cn,kn->ck" if axis == 0 else "nc,nk->ck"
        d = torch.einsum(eq, x.to(f32), g.to(f32))
        acc = d if acc is None else acc + d
    C, K = acc.shape
    blk = acc.reshape(C // bsize, bsize, K // bsize, bsize)
    if norm.lower() == "max":
        out = blk.abs().amax(dim=(1, 3))
    else:
        out = blk.square().sum(dim=(1, 3)).sqrt()
    return out * scale


def dw_matmul_large_n(x, dy, precision=None):
    """Dense dw = xᵀ · dy contracting the leading (N) axis of both, in f32
    whatever the inputs' dtype (torch's default keeps TF32 off for f32
    products).  ``precision`` is the JAX signature's, accepted."""
    return torch.tensordot(x.to(torch.float32), dy.to(torch.float32),
                           dims=([0], [0]))


def coarsen_layout(layout, bsize, target=128):
    """Lift a fine block layout to ``target``-sized blocks.

    Returns (coarse_layout, pack_w, unpack_w, fill): the (CB', KB') 0/1
    layout at the coarse block size, converters between the fine
    (blocks, b, b) weights (ordered as ``BlocksparseMatMul(layout,
    bsize)``) and the coarse (blocks', target, target) ones (ordered as
    ``BlocksparseMatMul(coarse_layout, target)``; absent fine blocks
    zero), both NumPy, and the fill nnz_fine / (nnz_coarse ·
    (target / bsize)²)."""
    V = target // bsize
    if target % bsize or V < 1:
        raise ValueError("target must be a multiple of bsize")
    layout = (np.asarray(layout) != 0).astype(np.int32)
    CB, KB = layout.shape
    CBp, KBp = ceil_div(CB, V), ceil_div(KB, V)
    pad = np.zeros((CBp * V, KBp * V), np.int32)
    pad[:CB, :KB] = layout
    coarse = pad.reshape(CBp, V, KBp, V).max(axis=(1, 3))

    fine = BlocksparseMatMul(layout, block_size=bsize, feature_axis=0)
    co = BlocksparseMatMul(coarse, block_size=target, feature_axis=0)

    # each fine block id -> (coarse block id, row offset, column offset)
    coarse_id = {cc: i for i, cc in enumerate(co.updat_list)}
    fmap = []
    for w, (c, k) in enumerate(fine.updat_list):
        cid = coarse_id[(c // V, k // V)]
        fmap.append((cid, (c % V) * bsize, (k % V) * bsize))

    def pack_w(w_fine):
        w_fine = np.asarray(w_fine)
        out = np.zeros((co.blocks, target, target), w_fine.dtype)
        for w, (cid, ro, cv) in enumerate(fmap):
            out[cid, ro:ro + bsize, cv:cv + bsize] = w_fine[w]
        return out

    def unpack_w(w_coarse):
        w_coarse = np.asarray(w_coarse)
        out = np.zeros((fine.blocks, bsize, bsize), w_coarse.dtype)
        for w, (cid, ro, cv) in enumerate(fmap):
            out[w] = w_coarse[cid, ro:ro + bsize, cv:cv + bsize]
        return out

    fill = fine.blocks / (co.blocks * V * V)
    return coarse, pack_w, unpack_w, fill


# ------------------------------------------------------------------
# SparseProj: one-to-one dense <-> sparse feature projections, feature-
# major (x is (nhidden, ...)).
# ------------------------------------------------------------------

class SparseProj:
    """The features ``gather_lut`` of nhidden: ``gather`` takes them,
    ``scatter`` places nproj features there (zeros elsewhere),
    ``scatter_add`` and ``scatter_mul`` add into or multiply them.  The
    LUT is strided (``proj_stride``: every stride-th feature, a multiple
    of ``block_size`` of them), drawn (``nproj``: a sorted sample, shuffled
    with the global ``np.random`` as the JAX class does) or given.
    Pickled as the JAX class pickles: by its ``gather_lut``."""

    def __getstate__(self):
        return (self.nhidden, self.nproj, self.gather_lut, self.name)

    def __setstate__(self, state):
        self.__init__(state[0], nproj=None, gather_lut=state[2],
                      name=state[3])

    def __init__(self, nhidden, nproj=None, proj_stride=None, block_size=32,
                 gather_lut=None, name=None):
        if gather_lut is None:
            gather_lut = np.arange(nhidden, dtype=np.int32)
            if nproj is not None:
                if nproj > nhidden:
                    raise ValueError("nproj must not exceed nhidden")
                np.random.shuffle(gather_lut)
                gather_lut = np.sort(gather_lut[0:nproj])
            elif proj_stride is not None:
                if not 1 <= proj_stride <= nhidden:
                    raise ValueError("proj_stride must lie in [1, nhidden]")
                gather_max = ((nhidden // proj_stride) // block_size) \
                    * block_size * proj_stride
                gather_lut = gather_lut[:gather_max:proj_stride].copy()
            else:
                raise ValueError("missing nproj, proj_stride or gather_lut")
        gather_lut = np.asarray(gather_lut, dtype=np.int32)
        nproj = gather_lut.size

        scatter_lut = np.full(nhidden, -1, dtype=np.int32)
        scatter_lut[gather_lut] = np.arange(nproj, dtype=np.int32)

        self.name = name or "SparseProj"
        self.gather_lut = gather_lut
        self.scatter_lut = scatter_lut
        self.nhidden = nhidden
        self.nproj = nproj
        self._luts = {}

    def _lut(self, device):
        if device not in self._luts:
            self._luts[device] = torch.as_tensor(
                self.gather_lut, dtype=torch.int64, device=device)
        return self._luts[device]

    def gather(self, x):
        if x.shape[0] != self.nhidden:
            raise ValueError(f"x must be ({self.nhidden}, ...)")
        return x.index_select(0, self._lut(x.device))

    def scatter(self, x):
        if x.shape[0] != self.nproj:
            raise ValueError(f"x must be ({self.nproj}, ...)")
        out = x.new_zeros((self.nhidden,) + tuple(x.shape[1:]))
        return out.index_copy(0, self._lut(x.device), x)

    def scatter_add(self, x, y):
        if x.shape[0] != self.nhidden or y.shape[0] != self.nproj:
            raise ValueError(f"x must be ({self.nhidden}, ...), y "
                             f"({self.nproj}, ...)")
        return x.index_add(0, self._lut(x.device), y)

    def scatter_mul(self, x, y):
        if x.shape[0] != self.nhidden or y.shape[0] != self.nproj:
            raise ValueError(f"x must be ({self.nhidden}, ...), y "
                             f"({self.nproj}, ...)")
        lut = self._lut(x.device)
        return x.index_copy(0, lut, x.index_select(0, lut) * y)
