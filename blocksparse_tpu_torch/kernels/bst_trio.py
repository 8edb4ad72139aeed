"""The unfused block-sparse attention products: the CUDA kernels and their
plain versions.

``BlocksparseTransformer``'s unfused ops (``nt_op``, ``nn_op``, ``tn_op``)
are three products over the layout's blocks with per-instance weights:

- NT: w[n, h, e] = a_blk(q_e) · b_blk(k_e)ᵀ over the head size, for
  every layout block e of the instance's layout head (the scores);
- NN: y[q-row] = Σ w[e] · x_blk(k_e) over the query row's blocks;
- TN: y[k-row] = Σ w[e]ᵀ · x_blk(q_e) over the key row's blocks.

``bst_nt`` replaces the TPU kernel ``updat_pallas_dense_tile``
(``blocksparse_tpu/kernels/bsmm.py``) in its ``_nt_impl_pallas`` use, and
``bst_xn`` replaces ``xprop_pallas_dense_tile`` in its ``_xn_impl_pallas``
use (NN, and TN with transposed cells), both vmapped over batch·heads on
the TPU.  Here one launch covers every instance.  bf16 and f16 run
``csrc/bst_nt_mma.cu`` and ``csrc/bst_xn_mma.cu`` on the tensor cores,
outputs staged in shared memory and written in 16-byte runs.  NT is a
thread block per (plan item, batch·head): its query block resident, the
key blocks streamed by TMA in 64-column chunks of the head through a
four-stage ring, each 64-key tile one ``wgmma`` product (keys . qᵀ, both
K-major).  NN/TN are a cluster of two thread blocks per (plan pair,
batch·head, column group: the whole head up to 64 columns, else groups of
128), each owning its row's whole column group, so a score block is read
once a group (twice at hs 256): at
block size 64 ``wgmma`` on TMA-fed tiles (TN's weights read MN-major,
transposed by the tensor cores), at 8-32 ``mma.sync`` m16n8k16 on a
``cp.async`` ring.  f32 runs ``csrc/bst_nt.cu`` and ``csrc/bst_xn.cu``
in full fp32 on the CUDA cores (no TF32: the reference's f32 dots are
exact).  Every sum runs in a fixed order in f32, with no atomics, and is
rounded once to the input dtype; an NN/TN row with no entries writes
zeros.

The launch plan (``launch_plan``) walks each layout head's rows longest
first; a row holding more than ``SPLIT_FACTOR`` times the mean entry
count is cut into two halves.  NT writes each half's score blocks on its
own; NN/TN run the halves on the two thread blocks of one cluster, and
the first adds the second's f32 sums through distributed shared memory
(first half + second half, rounded once).  The plan travels after the
CSR's row pointers in one table (``trio_tables``' ``plan`` and
``plan_t``), which the wrappers take as their ``row_ptr``: a caller
cannot launch without it.

The activations are read in place from the public (batch, ctx, heads·hs)
layout through their batch and row strides, so the column slices of a
packed qkv tensor go in without a copy; the head size must be a multiple
of 8 (``BlocksparseTransformer`` zero-pads other sizes).  The tables
(``trio_tables``) are CSRs of the layout per layout head: a model whose
heads share one layout passes one.

``bst_nt_plain`` and ``bst_xn_plain`` are the plain PyTorch versions, the
ports of ``_nt_impl_xla`` and ``_xn_impl_xla`` (a gather, an f32 einsum
and, for NN/TN, ``index_add_`` over the output rows, cast once).  They run
for tensors on the CPU and are what the kernels are held against on the
card.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from blocksparse_tpu_torch.kernels import _build
from blocksparse_tpu_torch.kernels.bst_attn import _aligned16, launch_order

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
BLOCK_SIZES = (8, 16, 32, 64)
# bst_nt_mma.cu keeps the query block's whole head in shared memory beside
# its ring: head sizes up to NT_MAX_HEAD_SIZE
NT_MAX_HEAD_SIZE = 512
# the launch plan cuts a row in two where it holds more than this many
# times the mean entry count of its layout head's rows (the rows that
# would set the tail of the grid)
SPLIT_FACTOR = 2
# a plan item is row * 4 + part: the whole row, or its first or second
# half (the first ceil(count / 2) entries, then the rest); -1 is no item
WHOLE, FIRST, SECOND = 0, 1, 2


def launch_plan(row_ptr, rows):
    """The kernels' launch plan of a CSR: a (lut_heads, items) int32 array
    of items ``row * 4 + part`` (``WHOLE``, ``FIRST``, ``SECOND``) in
    pairs, -1 where a pair has no second item.

    Each layout head's rows go longest first (``bst_attn.launch_order``);
    a row of at least two entries holding more than ``SPLIT_FACTOR``
    times the head's mean count becomes its two halves, the first
    ceil(count / 2) entries and the rest, side by side in one pair (the
    xn kernel's cluster: the FIRST half's block adds the SECOND's sums).
    The units (a split row's pair, a whole row) are sorted by their
    largest item, stably, and whole rows fill the pairs two by two.
    Heads are padded with -1 to one length."""
    row_ptr = np.asarray(row_ptr).reshape(-1, rows + 1)
    counts = np.diff(row_ptr, axis=1)
    plans = []
    for c, order in zip(counts, launch_order(row_ptr, rows)):
        units = []
        for r in order.tolist():
            if c[r] >= 2 and c[r] > SPLIT_FACTOR * c.mean():
                halves = [4 * r + FIRST, 4 * r + SECOND]
                units.append(((c[r] + 1) // 2, halves))
            else:
                units.append((c[r], [4 * r + WHOLE]))
        units.sort(key=lambda u: -u[0])
        items, pending = [], None
        for _, unit in units:
            if len(unit) == 2:
                items += unit
            elif pending is None:
                pending = unit[0]
            else:
                items += [pending, unit[0]]
                pending = None
        if pending is not None:
            items += [pending, -1]
        plans.append(items)
    n = max(len(p) for p in plans)
    return np.array([p + [-1] * (n - len(p)) for p in plans], np.int32)


def trio_tables(nt_lists, ctx_blks_q, ctx_blks_k):
    """The kernels' tables of a layout, as int32 NumPy arrays, one row per
    layout head (nt_lists: each head's (q_blk, k_blk) blocks in row order,
    the same count for every head).

    - ``row_ptr`` (lut_heads, ctx_blks_q + 1), ``ent_k`` (lut_heads,
      blocks): the query-row CSR; block e of a head is entry e (the nt
      list is row-sorted) and ``ent_k[e]`` its key block.  NT and NN walk
      it; NN's weight block of entry e is e itself (``ent_e``).
    - ``row_ptr_t`` (lut_heads, ctx_blks_k + 1), ``ent_b``, ``ent_q``
      (lut_heads, blocks): the key-row CSR TN walks, each key row's
      blocks in ascending block order, their query blocks.
    - ``order`` (lut_heads, ctx_blks_q), ``order_t`` (lut_heads,
      ctx_blks_k): each CSR's rows by entry count, most first, stable.
    - ``plan``, ``plan_t``: each CSR's row pointers, all heads, followed
      by its ``launch_plan``, all heads, flat: (lut_heads · (rows + 1 +
      items),).  The wrappers take these as ``row_ptr`` (the f32
      kernels read the leading row pointers alone)."""
    lh, blocks = len(nt_lists), len(nt_lists[0])
    out = {k: np.zeros((lh, n), np.int32) for k, n in (
        ("row_ptr", ctx_blks_q + 1), ("ent_k", blocks), ("ent_e", blocks),
        ("row_ptr_t", ctx_blks_k + 1), ("ent_b", blocks), ("ent_q", blocks))}
    for h, nt in enumerate(nt_lists):
        qb = np.array([q for q, _ in nt], np.int64).reshape(-1)
        kb = np.array([k for _, k in nt], np.int64).reshape(-1)
        out["row_ptr"][h, 1:] = np.cumsum(np.bincount(qb,
                                                      minlength=ctx_blks_q))
        out["ent_k"][h] = kb
        out["ent_e"][h] = np.arange(blocks)
        order = np.argsort(kb, kind="stable")
        out["row_ptr_t"][h, 1:] = np.cumsum(np.bincount(kb,
                                                        minlength=ctx_blks_k))
        out["ent_b"][h] = order
        out["ent_q"][h] = qb[order]
    for sfx, rows in (("", ctx_blks_q), ("_t", ctx_blks_k)):
        rp = out["row_ptr" + sfx]
        out["order" + sfx] = launch_order(rp, rows)
        out["plan" + sfx] = np.concatenate(
            [rp.ravel(), launch_plan(rp, rows).ravel()]).astype(np.int32)
    return out


def _split(a, heads, bs):
    """(batch, ctx, heads·hs) -> (batch, heads, ctx // bs, bs, hs), a
    view."""
    batch, ctx, state = a.shape
    return a.reshape(batch, ctx // bs, bs, heads, state // heads) \
        .permute(0, 3, 1, 2, 4)


def _gather(a, blk, heads, bs):
    """The blocks blk (lut_heads, blocks) of each head of a, in f32:
    (batch, heads, blocks, bs, hs)."""
    hidx = torch.arange(heads, device=a.device)[:, None]
    return _split(a, heads, bs)[:, hidx, blk.expand(heads, -1)].float()


def bst_nt_plain(a, b, q_blk, k_blk, heads, bs):
    """Port of ``_nt_impl_xla``: w[n, h, e] = a_blk(q_blk[e]) ·
    b_blk(k_blk[e])ᵀ in f32, rounded once to a's dtype.  a: (batch, ctx_q,
    heads·hs), b: (batch, ctx_k, heads·hs); q_blk, k_blk: (lut_heads,
    blocks) int64 on a's device.  Returns (batch, heads, blocks, bs,
    bs)."""
    w = torch.einsum("nhbqc,nhbkc->nhbqk", _gather(a, q_blk, heads, bs),
                     _gather(b, k_blk, heads, bs))
    return w.to(a.dtype)


def bst_xn_plain(w, x, seg, gather, n_rows, heads, bs, trans):
    """Port of ``_xn_impl_xla``: y[seg[e]] += w[e] · x_blk(gather[e])
    (NN), or w[e]ᵀ · x_blk(gather[e]) with ``trans`` (TN), summed in f32
    by ``index_add_`` and cast once to x's dtype.  w: (batch, heads,
    blocks, bs, bs); x: (batch, ctx_in, heads·hs); seg, gather:
    (lut_heads, blocks) int64 on x's device.  Returns (batch, n_rows·bs,
    heads·hs)."""
    batch, _, state = x.shape
    hs = state // heads
    eq = "nhbqk,nhbqc->nhbkc" if trans else "nhbqk,nhbkc->nhbqc"
    prod = torch.einsum(eq, w.float(), _gather(x, gather, heads, bs))
    blocks = prod.shape[2]
    hidx = torch.arange(heads, device=x.device)[:, None]
    idx = (hidx * n_rows + seg.expand(heads, -1)).reshape(-1)
    out = torch.zeros((batch, heads * n_rows, bs, hs), dtype=torch.float32,
                      device=x.device)
    out.index_add_(1, idx, prod.reshape(batch, heads * blocks, bs, hs))
    return out.reshape(batch, heads, n_rows, bs, hs).permute(0, 2, 3, 1, 4) \
        .reshape(batch, n_rows * bs, state).to(x.dtype)


# ---------------- the kernels' wrappers ----------------

_P, _I = ctypes.c_void_p, ctypes.c_int
_NT_ARGS = [_I, _I, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]
_XN_ARGS = [_I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
            _P]
# the tensor-core kernels also take the plan's item count and the rows of
# their streamed input (b's ctx for NT, x's for NN/TN), before the stream
_NT_MMA_ARGS = _NT_ARGS[:-1] + [_I, _I, _P]
_XN_MMA_ARGS = _XN_ARGS[:-1] + [_I, _I, _P]


def _check_acts(fn, acts, bs, heads):
    """Checks shared by the wrappers on the (batch, ctx, heads·hs)
    activations ``acts`` ((name, tensor) pairs).  Returns hs."""
    first = acts[0][1]
    if not first.is_cuda:
        raise ValueError(f"{fn} launches a CUDA kernel: its inputs must be "
                         f"on a CUDA device")
    if first.dtype not in _DTYPE_CODE:
        raise TypeError(f"{fn} takes f32, bf16 or f16, got {first.dtype}")
    if bs not in BLOCK_SIZES:
        raise ValueError(f"{fn} takes block sizes {BLOCK_SIZES}, got {bs}")
    for name, t in acts:
        if t.device != first.device or t.dtype != first.dtype:
            raise TypeError(f"{name} must be {first.dtype} on {first.device}"
                            f", got {t.dtype} on {t.device}")
        if t.dim() != 3 or t.shape[0] != first.shape[0] \
                or t.shape[2] != first.shape[2] or t.shape[1] % bs:
            raise ValueError(f"bad shapes {[tuple(a.shape) for _, a in acts]}"
                             f": (batch, ctx, heads·hs), ctx a multiple of "
                             f"{bs}")
        if t.stride(2) != 1:
            raise ValueError(f"{name}'s last dim must be contiguous")
    state = first.shape[2]
    if state % heads or (state // heads) % 8:
        raise ValueError(f"the head size must be a multiple of 8, got "
                         f"{state / heads}")
    return state // heads


def _check_tables(fn, device, rows, tables):
    """The int32 tables: contiguous, on ``device``; the entry tables
    (lut_heads, blocks); the first a CSR's row pointers followed by its
    launch plan (``trio_tables``' plan or plan_t).  Returns (lut_heads,
    blocks, items)."""
    for name, t in tables:
        if t.device != device or t.dtype != torch.int32 \
                or not t.is_contiguous():
            raise TypeError(f"{fn}: {name} must be a contiguous int32 tensor "
                            f"on {device}")
    ents = [t for _, t in tables[1:]]
    if any(t.dim() != 2 or t.shape != ents[0].shape for t in ents):
        raise ValueError(f"{fn}: entry tables must be (lut_heads, blocks)")
    lut_heads, blocks = ents[0].shape
    plan = tables[0][1].numel()
    items = plan // max(lut_heads, 1) - rows - 1
    if plan % max(lut_heads, 1) or items < 2 or items % 2:
        raise ValueError(f"{fn}: row_ptr must hold {rows} rows' pointers "
                         f"followed by their launch plan (trio_tables' "
                         f"plan or plan_t) for {lut_heads} layout heads")
    return lut_heads, blocks, items


def _source(name, dtype):
    return name if dtype == torch.float32 else f"{name}_mma"


def _launch(fn, dtype, extra, device, *args):
    """Calls the C function of ``fn`` for ``dtype`` (the tensor-core
    kernels also take ``extra``: the plan's item count and the rows of
    the streamed input) on ``device``'s current stream; raises on a
    failed launch."""
    source = _source(fn, dtype)
    mma = dtype != torch.float32
    argtypes = {("bst_nt", False): _NT_ARGS, ("bst_nt", True): _NT_MMA_ARGS,
                ("bst_xn", False): _XN_ARGS,
                ("bst_xn", True): _XN_MMA_ARGS}[fn, mma]
    with torch.cuda.device(device):
        err = _build.function(source, source, argtypes)(
            _DTYPE_CODE[dtype], *args, *(extra if mma else ()),
            torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn} launch failed: cudaError {err}")


def bst_nt(a, b, row_ptr, ent_k, heads, bs):
    """w (batch, heads, blocks, bs, bs) of a's dtype: w[n, h, e] = a_blk(q)
    · b_blk(ent_k[e])ᵀ over the head size, for each entry e of query row
    q of the query-row CSR, on the card.  ``row_ptr`` is the CSR's row
    pointers followed by its launch plan and ``ent_k`` its key blocks
    (``trio_tables``' plan and ent_k: int32, one layout head or
    ``heads``).

    a: (batch, ctx_q, heads·hs), b: (batch, ctx_k, heads·hs), one dtype
    (f32, bf16 or f16), last dim contiguous, other strides free; hs a
    multiple of 8 (up to ``NT_MAX_HEAD_SIZE`` in bf16/f16).  Raises on
    anything else and on a failed launch."""
    hs = _check_acts("bst_nt", (("a", a), ("b", b)), bs, heads)
    batch, ctx_q, _ = a.shape
    rows = ctx_q // bs
    lut_heads, blocks, items = _check_tables(
        "bst_nt", a.device, rows, (("row_ptr", row_ptr), ("ent_k", ent_k)))
    if lut_heads not in (1, heads):
        raise ValueError(f"{lut_heads} layout heads for {heads} heads")
    if a.dtype != torch.float32:
        if hs > NT_MAX_HEAD_SIZE:
            raise ValueError(f"bst_nt takes head sizes up to "
                             f"{NT_MAX_HEAD_SIZE} in bf16/f16, got {hs}")
        a, b = _aligned16(a), _aligned16(b)
    w = torch.empty((batch, heads, blocks, bs, bs), dtype=a.dtype,
                    device=a.device)
    if batch and blocks:
        strides = (ctypes.c_longlong * 4)(a.stride(0), a.stride(1),
                                          b.stride(0), b.stride(1))
        _launch("bst_nt", a.dtype, (items, b.shape[1]), a.device, bs, hs,
                a.data_ptr(), b.data_ptr(), w.data_ptr(),
                ctypes.addressof(strides), row_ptr.data_ptr(),
                ent_k.data_ptr(), batch, heads, lut_heads, rows, blocks)
        bst_nt.launches += 1
    return w


def bst_xn(w, x, row_ptr, ent_w, ent_x, heads, bs, n_rows, trans):
    """y (batch, n_rows·bs, heads·hs) of x's dtype, on the card: output
    block-row r of head h is Σ w[n, h, ent_w[e]] · x_blk(ent_x[e]) (NN),
    or w[...]ᵀ · x_blk(ent_x[e]) with ``trans`` (TN), over the entries e
    of row r of the CSR, summed in f32 in a fixed order and rounded once;
    a row with no entries is zeros.  ``row_ptr`` is the CSR's row
    pointers followed by its launch plan, ``ent_w``, ``ent_x`` its
    entries (``trio_tables``' plan, ent_e, ent_k for NN; plan_t, ent_b,
    ent_q for TN: int32, one layout head or ``heads``).

    w: (batch, heads, blocks, bs, bs) contiguous, x's dtype; x: (batch,
    ctx_in, heads·hs), f32, bf16 or f16, last dim contiguous, other
    strides free, hs a multiple of 8.  Raises on anything else and on a
    failed launch.  Launches count in ``bst_xn.launches``, TN's also in
    ``bst_xn.launches_tn``."""
    hs = _check_acts("bst_xn", (("x", x),), bs, heads)
    batch = x.shape[0]
    lut_heads, blocks, items = _check_tables(
        "bst_xn", x.device, n_rows,
        (("row_ptr", row_ptr), ("ent_w", ent_w), ("ent_x", ent_x)))
    if lut_heads not in (1, heads):
        raise ValueError(f"{lut_heads} layout heads for {heads} heads")
    if w.dtype != x.dtype or w.device != x.device or not w.is_contiguous() \
            or tuple(w.shape) != (batch, heads, blocks, bs, bs):
        raise ValueError(f"w must be a contiguous {x.dtype} ({batch}, "
                         f"{heads}, {blocks}, {bs}, {bs}) on {x.device}, got "
                         f"{w.dtype} {tuple(w.shape)}")
    if x.dtype != torch.float32:
        w, x = _aligned16(w), _aligned16(x)
    y = torch.empty((batch, n_rows * bs, heads * hs), dtype=x.dtype,
                    device=x.device)
    if batch and n_rows:
        strides = (ctypes.c_longlong * 2)(x.stride(0), x.stride(1))
        _launch("bst_xn", x.dtype, (items, x.shape[1]), x.device, bs, hs,
                int(trans),
                w.data_ptr(), x.data_ptr(), y.data_ptr(),
                ctypes.addressof(strides), row_ptr.data_ptr(),
                ent_w.data_ptr(), ent_x.data_ptr(), batch, heads, lut_heads,
                n_rows, blocks)
        bst_xn.launches += 1
        bst_xn.launches_tn += int(bool(trans))
    return y


bst_nt.launches = 0
bst_xn.launches = 0
bst_xn.launches_tn = 0
