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
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from blocksparse_tpu_torch.kernels import bsmm as bsmm_kernels
from blocksparse_tpu_torch.kernels.bsmm import device_sm_count
from blocksparse_tpu_torch.utils import z_order_2d

_MODES = ("auto", "grouped", "dense_tile", "window", "resident", "fine")


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
        function is the same; updat always runs ``bsmm_updat``, in bf16
        and f16 over ``updat_plan``'s groups, N split by
        ``updat_splits``):
        - "fine" with block_size <= 32: ``bsmm_fine`` (the JAX fine
          schedule), 128-deep chunks of each output column's entries;
          with a larger block it acts as "auto";
        - "window": ``bsmm_window`` (the JAX window-slab schedule), x
          staged once per window for a super-group of columns;
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
          (``kernels.bsmm.split_phases``).  Otherwise unsplit.
        ``dispatch_mode(N)`` names the route.
    tile_n, dense_tile_G, dense_tile_R: TPU schedule knobs, accepted for
        the same call signature; they change nothing.
    w_layout: only "blocks" (canonical (blocks, b, b) weights).
    """

    def __init__(self, layout, block_size=32, feature_axis=0, z_order=True,
                 name=None, impl=None, tile_n=None, w_layout="blocks",
                 mode="auto", dense_tile_G=None, dense_tile_R=None):
        if block_size not in bsmm_kernels.BLOCK_SIZES:
            raise ValueError("Unsupported block size: %d" % block_size)
        if w_layout == "fprop_packed":
            raise NotImplementedError(
                "w_layout='fprop_packed' follows the TPU schedule order; "
                "the port takes canonical 'blocks' weights")
        if w_layout != "blocks":
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
        self._updat_runs = {}     # (N, SMs) -> runs of the updat's N split

        self.name = name or "BlocksparseMatMul"
        self.blocks = blocks
        self.w_shape = (blocks, block_size, block_size)
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

    # ---------------- initializers / golden ----------------

    def identity_init(self, scale=1.0):
        def _initializer(shape=None, dtype=np.float32, key=None):
            W = np.zeros(self.w_shape, dtype=dtype)
            for w in range(self.blocks):
                cb, kb = self.updat_list[w]
                if (cb % self.KB) == (kb % self.CB):
                    W[w] = np.eye(self.bsize, dtype=dtype) * scale
            return W
        return _initializer

    def fprop_test(self, I, W):
        """NumPy golden of the forward (the JAX package's, ungated)."""
        bsize = self.bsize
        if self.axis:
            O = np.zeros((I.shape[0], self.KB, bsize))
            I = I.reshape((-1, self.CB, bsize))
            for k, lut in self.fprop_list:
                for c, w in lut:
                    O[:, k, :] += np.dot(I[:, c, :], W[w])
            return O.reshape(I.shape[0], -1)
        N = I[0].size
        O = np.zeros((self.KB, bsize, N))
        I = I.reshape((self.CB, bsize, N))
        for k, lut in self.fprop_list:
            for c, w in lut:
                O[k, :, :] += np.dot(W[w].T, I[c, :, :])
        return O.reshape(-1, N)

    def bprop_test(self, E, W):
        """NumPy golden of dx = E · Wᵀ (the JAX package's, ungated)."""
        bsize = self.bsize
        if self.axis:
            B = np.zeros((E.shape[0], self.CB, bsize))
            E = E.reshape((-1, self.KB, bsize))
            for c, lut in self.bprop_list:
                for k, w in lut:
                    B[:, c, :] += np.dot(E[:, k, :], W[w].T)
            return B.reshape(E.shape[0], -1)
        N = E[0].size
        B = np.zeros((self.CB, bsize, N))
        E = E.reshape((self.KB, bsize, N))
        for c, lut in self.bprop_list:
            for k, w in lut:
                B[c, :, :] += np.dot(W[w], E[k, :, :])
        return B.reshape(-1, N)

    def updat_test(self, I, E):
        """NumPy golden of dw, canonical (blocks, b, b) (ungated)."""
        U = np.zeros((self.blocks, self.bsize, self.bsize))
        bsize = self.bsize
        if self.axis:
            I = I.reshape((-1, self.CB, bsize))
            E = E.reshape((-1, self.KB, bsize))
            for w, (c, k) in enumerate(self.updat_list):
                U[w] = np.dot(I[:, c, :].T, E[:, k, :])
        else:
            I = I.reshape((self.CB, bsize, -1))
            E = E.reshape((self.KB, bsize, -1))
            for w, (c, k) in enumerate(self.updat_list):
                U[w] = np.dot(I[c], E[k].T)
        return U

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
        (``kernels.bsmm.updat_splits``) over this layout's groups."""
        if dtype == torch.float32:
            return 1
        sms = sm_count if sm_count is not None else device_sm_count()
        key = (N, sms)
        if key not in self._updat_runs:
            self._updat_runs[key] = bsmm_kernels.updat_splits(
                N, len(self._plan("updat", "u")["grp_q"]), self.bsize, sms)
        return self._updat_runs[key]

    def _plan(self, kind, d, phases=0):
        """The host-side plan (NumPy) of a route, built once (kind "updat":
        the tensor-core updat's groups, d "u")."""
        key = (kind, d, phases)
        plan = self._plans.get(key)
        if plan is None:
            row_ptr, (ib, wb, _), _, n_in = self._csr(d)
            if kind == "updat":
                plan = bsmm_kernels.updat_plan(
                    self.updat_lut[:, 0], self.updat_lut[:, 1], self.bsize)
            elif kind == "fine":
                plan = bsmm_kernels.fine_plan(row_ptr, ib, wb, self.bsize)
            elif kind == "window":
                plan = bsmm_kernels.window_plan(row_ptr, ib, wb, n_in,
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
        """fprop (d="f") or bprop (d="b") of a 2-D activation."""
        lut = self._lut(x.device)
        n_out = self.KB if d == "f" else self.CB
        if self._plain(x):
            return bsmm_kernels.xprop_plain(
                x, w, lut[f"{d}_in"], lut[f"{d}_w"], lut[f"{d}_out"], n_out,
                self.bsize, self.axis, trans_w=d == "b", out_dtype=x.dtype)
        xn, wc, b, trans = self._nc(x), w.contiguous(), self.bsize, d == "b"
        sms = device_sm_count(x.device)
        route = self._route(xn.shape[0], d, sms)
        if route == "fine":
            p = self._plan_tensors(x.device, "fine", d)
            y = bsmm_kernels.bsmm_fine(xn, wc, p["chunk_ptr"], p["slot_in"],
                                       p["slot_w"], b, n_out, trans)
        elif route == "window":
            p = self._plan_tensors(x.device, "window", d)
            y = bsmm_kernels.bsmm_window(xn, wc, p["ptr"], p["ent_slot"],
                                         p["ent_w"], b, n_out, trans)
        elif route == "phased":
            phases = self._phases(xn.shape[0], d, sms)
            p = self._plan_tensors(x.device, "split", d, phases)
            ents = (lut[f"{d}_ent_in"], lut[f"{d}_ent_w"])
            if x.dtype == torch.float32:
                parts = bsmm_kernels.bsmm_partials(
                    xn, wc, p["tile_ptr"], *ents, b,
                    p["tile_ptr"].numel() - 1, trans)
                y = bsmm_kernels.bsmm_merge(parts, p["merge_idx"], b, x.dtype)
            else:
                y = bsmm_kernels.bsmm_split(xn, wc, p["tile_ptr"], *ents,
                                            p["merge_idx"], b, n_out, trans)
        else:
            kernel = bsmm_kernels.bsmm_bprop if trans \
                else bsmm_kernels.bsmm_fprop
            y = kernel(xn, wc, lut[f"{d}_row_ptr"], lut[f"{d}_ent_in"],
                       lut[f"{d}_ent_w"], b, n_out)
        # feature_axis 0: the (features, N) view of the kernel's (N,
        # features) output; a consumer in that orientation copies nothing
        return y if self.axis else y.t()

    def _updat(self, x, dy):
        """dw (blocks, b, b) in f32 from 2-D x and dy."""
        lut = self._lut(x.device)
        if self._plain(x):
            return bsmm_kernels.updat_plain(x, dy, lut["u_c"], lut["u_k"],
                                            self.bsize, self.axis)
        xn, dyn = self._nc(x), self._nc(dy)
        splits = self.updat_splits(xn.shape[0], x.dtype,
                                   device_sm_count(x.device))
        return bsmm_kernels.bsmm_updat(
            xn, dyn, lut["u_c32"], lut["u_k32"], self.bsize,
            self._plan_tensors(x.device, "updat", "u"), splits)

    def __call__(self, I, W, gate=None, gate_grad=False, dw_gated=False,
                 name=None, bench=0):
        """y = I · W over the layout; I is (..., C) for feature_axis=1,
        (C, ...) for feature_axis=0.  Differentiable in I and W.  The JAX
        op's gates (``gate``, ``gate_grad``, ``dw_gated``) are not ported
        and raise; ``name`` and ``bench`` are accepted and change
        nothing."""
        if gate is not None or gate_grad or dw_gated:
            raise NotImplementedError("gated block-sparse matmul (gate, "
                                      "gate_grad, dw_gated) is not ported "
                                      "yet")
        if tuple(W.shape) != self.w_shape:
            raise ValueError(f"W must be {self.w_shape}, got "
                             f"{tuple(W.shape)}")
        shape = I.shape
        if self.axis == 0:
            if shape[0] != self.C:
                raise ValueError(f"I must be ({self.C}, ...), got {shape}")
            x, out_shape = I.reshape(self.C, -1), (self.K,) + tuple(shape[1:])
        else:
            if shape[-1] != self.C:
                raise ValueError(f"I must be (..., {self.C}), got {shape}")
            x, out_shape = I.reshape(-1, self.C), tuple(shape[:-1]) + (self.K,)
        if torch.is_grad_enabled() and (I.requires_grad or W.requires_grad):
            y = _BsmmFunction.apply(x, W, self)
        else:
            y = self._xprop(x, W, "f")
        return y.reshape(out_shape)


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
