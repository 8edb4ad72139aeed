"""Block-sparse matmul: the CUDA kernels and their plain versions.

``bsmm_fprop`` (y = x·W) and ``bsmm_bprop`` (dx = dy·Wᵀ) replace both
directions of the TPU kernels ``xprop_pallas_dense_tile``,
``xprop_pallas_grouped`` / ``xprop_pallas_grouped_panels`` and
``xprop_pallas`` (``blocksparse_tpu/kernels/bsmm.py``), which all compute
the product over the layout's LUT and differ only in how they tile the
TPU's MXU.  Both are written natively for the NC orientation
(``feature_axis=1``, x of shape (N, C)): thread blocks over (N-tile,
output block-columns), a fixed-order f32 sum over each block-column's
LUT entries, no atomics; bprop reads each W block transposed and walks
the CSR of input block-columns.  bf16 and f16 run on the tensor cores,
on the kernel ``xprop_kernel`` picks: ``csrc/bsmm_xprop_sparse.cu`` at
b32 (``wgmma`` fed by a TMA x box of two input blocks and one bulk copy
of the stage's weight blocks, which ``xprop_sparse_pack`` lays out in the
plan's order a call: ``xprop_sparse_plan``), ``csrc/bsmm_xprop_wgmma.cu``
at b64 and b128 (``wgmma`` fed by TMA from an ``mbarrier`` ring,
persistent thread blocks over (N-tile, group of 256 output features)
tiles, x staged once a group: ``xprop_wgmma_plan``), else
``csrc/bsmm_xprop_mma.cu`` (``mma.sync`` fed by ``ldmatrix`` from a
``cp.async`` ring, one output block-column a thread block); f32 runs
``csrc/bsmm_fprop.cu``
in full fp32 on the CUDA cores (no TF32: the reference's f32 dots are
exact), an SGEMM-style kernel whose thread blocks own the output columns
that share their entry lists (``xprop_groups``), or one column, at an
N-tile chosen by N (``xprop_tile``), through a ``cp.async`` ring, each
output one fmaf chain in LUT order.  ``bsmm_updat`` (dw[e] = x_cᵀ·dy_k summed over N, in f32)
replaces ``updat_pallas_dense_tile`` and, for canonical weights,
``updat_pallas_grouped`` and ``updat_pallas``.  Its kernels run over the
layout's blocks in groups that share one staged x (or dy) tile
(``updat_plan``).  bf16 and f16 run on the tensor cores,
``csrc/bsmm_updat_sparse.cu`` (``wgmma`` fed by TMA over
``updat_sparse_plan``'s groups: bundles of the wider operand's
block-rows that name the same blocks of the other, so a slot's tile
serves all of a bundle's; the conv's and the LM's products),
``csrc/bsmm_updat_wgmma.cu`` (``wgmma`` fed by TMA) or
``csrc/bsmm_updat_mma.cu`` (``mma.sync``) as ``updat_kernel`` says, N cut
into runs where the groups alone would leave SMs idle (``updat_splits``),
the runs' f32 partials summed in order by ``bsmm_updat_reduce``.  f32
runs ``csrc/bsmm_updat.cu`` on the CUDA cores, one fmaf chain over all of
N an output.  See the sources for what
bounds each on the H100 and what the designs do about it.

``xprop_plain`` and ``updat_plain`` are the plain PyTorch versions, the
ports of ``xprop_xla`` and ``updat_xla`` (gather, einsum, ``index_add_``).
They are what runs for tensors on the CPU and what the kernels are held
against on the card; ``updat_reduce_plain`` is the split's second pass.

Three more schedules of the same product, each with its host-side plan
built here in NumPy from the LUT's CSR:

- ``bsmm_fine`` (b 8-32; replaces ``xprop_pallas_fine``): an output
  column's entries in chunks of 128/b, one 128-deep contraction a chunk
  (``fine_plan``); bf16 and f16 on the tensor cores, on the kernel
  ``fine_kernel`` picks: ``csrc/bsmm_fine_wgmma.cu`` (``wgmma``, each
  slot's x slice a TMA box, the chunk's weights staged by producer
  warps, persistent) or ``csrc/bsmm_fine_mma.cu`` (a ``cp.async`` ring
  of chunks); f32 on the CUDA cores (``csrc/bsmm_fine.cu``).
- ``bsmm_window`` (b 8-128; replaces ``xprop_pallas_window``): x staged
  once per window slab for a super-group of output columns whose
  accumulators stay in registers; bf16 and f16 on the tensor cores, on
  the kernel ``window_kernel`` picks: ``csrc/bsmm_window_wgmma.cu``
  (``wgmma`` over ``window_wgmma_plan``'s groups of 256 features and
  windows of 64 inputs, x by TMA, each window's cells by one bulk copy
  from the copy ``window_wgmma_pack`` lays out a call) or
  ``csrc/bsmm_window_mma.cu`` (``window_plan``, N-tile ``window_tn``);
  f32 on the CUDA cores (``csrc/bsmm_window.cu``).
- the split route (``split_plan``, ``split_phases``): each column's
  entries cut into runs, whose f32 partial tiles are added in phase order
  and rounded once.  bf16 and f16 run it in one launch, ``bsmm_split``
  (the unsplit kernel's split flag: the runs of a column are the thread
  blocks of one cluster, which sum their tiles through distributed
  shared memory; replaces ``merge_phased_tiles``).  f32 runs
  ``bsmm_partials`` (the unsplit kernel with its f32 partials flag), then
  ``bsmm_merge`` (``csrc/bsmm_merge.cu``; replaces ``merge_phased_tiles``
  too), which bf16 and f16 also take as the fused route's reference on
  the card.  ``merge_plain`` is the merge's plain version; the fine and
  window kernels compute ``xprop_plain``'s function.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from blocksparse_tpu_torch.kernels import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
BLOCK_SIZES = (8, 16, 32, 64, 128)
# rows of N a thread block of the unsplit tensor-core kernel owns
# (Tile<B>::TM of bsmm_xprop_mma.cu), which the split rule reads for every
# dtype: bsmm_fprop.cu's one-column blocks (TM 32, 64 threads) hold a
# quarter of the work of a tensor-core block, so its own grid would
# undercount the split's gain (at the sparse LSTM's bprop, N 128 on 35
# columns, the split route took 0.038 ms and the unsplit TM-32 kernel
# 0.081 on the H100: tools/bsmm_f32_bench.py)
XPROP_TM = {8: 64, 16: 128, 32: 128, 64: 128, 128: 64}
# bsmm_fprop.cu (f32): the columns of a full column group (its thread
# blocks own XPROP_F32_COLS // b block-columns that share their entry
# lists, 8 x 8 outputs a thread, at an N-tile of XPROP_F32_GROUP_TM rows),
# the N-tile of its one-column thread blocks, and the share of empty slots
# above which a plan does not group
XPROP_F32_COLS = 128
XPROP_F32_GROUP_TM = 64
XPROP_F32_TM = 32
XPROP_F32_WASTE = 0.25
# bsmm_fine.cu: block sizes, and contraction rows a chunk stages
FINE_BLOCK_SIZES = (8, 16, 32)
FINE_DEPTH = 128
# bsmm_window.cu: x columns a window stages (WB = WINDOW_SLAB // b
# block-rows) and output block-columns a super-group keeps resident
WINDOW_SLAB = 256
WINDOW_SG = {8: 16, 16: 8, 32: 8, 64: 4, 128: 2}
# bsmm_window_mma.cu: the N-tiles (rows of N a thread block owns) it is
# built for, largest first
WINDOW_TNS = (128, 64, 32, 16)
# bsmm_window_wgmma.cu (wgmma fed by TMA, persistent): output features a
# group (four m64 slots: WINDOW_WG_FEATURES // b block-columns, at b128
# two), input features a window (one 128-byte swizzled x box), and rows of
# N a tile (two consumer warpgroups of 64)
WINDOW_WG_FEATURES = 256
WINDOW_WG_SLAB = 64
WINDOW_WG_TN = 128
# the window mode's route to it (window_kernel): its tiles, ceil(N / 128)
# x groups, number at least WINDOW_WG_MIN_FILL x the SMs.
# In the H100 runs of PERF.md (with its packing, against
# bsmm_window_mma.cu): bench.py's random 8192^2 b32 op at N 2048, 512
# tiles, 0.33 ms against 0.54-0.58; at N 256, 64 tiles, 0.105 against
# 0.103; the canonical b8 row at N 64, 30 tiles, 0.133 against 0.129
WINDOW_WG_MIN_FILL = 1.0
# bsmm_fine_wgmma.cu (wgmma fed by TMA boxes of a slot's x, persistent):
# rows of N an item (x rows on wgmma's M), and the block sizes the fine
# mode takes it at (fine_kernel; H100 runs of PERF.md at the canonical
# rows, N 64: b16 0.025 ms against bsmm_fine_mma.cu's 0.037, b32 0.016
# against 0.027; b8, whose x slices are 16-byte rows, 0.071 against 0.058)
FINE_WG_TM = 64
FINE_WG_BLOCK_SIZES = (16, 32)
# split route: at most SPLIT_MAX_PHASES runs a column, each of at least
# SPLIT_MIN_PHASE entries
SPLIT_MAX_PHASES = 8
SPLIT_MIN_PHASE = 4
# bsmm_updat_mma.cu: slots a thread block stages, UPDAT_ROWS // b layout
# blocks of b columns; token rows a ring stage; its thread blocks resident
# on one SM
UPDAT_ROWS = 256
UPDAT_TN = 32
UPDAT_RESIDENT = {8: 2, 16: 2, 32: 2, 64: 2, 128: 1}
# the updat's N split: aim for UPDAT_WAVES waves of resident thread blocks,
# in at most UPDAT_MAX_SPLIT runs of at least UPDAT_MIN_RUN rows
UPDAT_WAVES = 2
UPDAT_MAX_SPLIT = 16
UPDAT_MIN_RUN = 512
# bsmm_xprop_wgmma.cu and bsmm_updat_wgmma.cu (wgmma fed by TMA): the block
# sizes they take (b8 and b16 stay on the mma.sync kernels); the xprop's
# N-tile and output features a column group (XPROP_WG_FEATURES // b
# block-columns); the updat's token rows a ring stage and its thread blocks
# resident on one SM (one: 384 threads and a ~190 KB ring)
WGMMA_BLOCK_SIZES = (32, 64, 128)
XPROP_WG_TM = 128
XPROP_WG_FEATURES = 256
UPDAT_WG_TN = 64
UPDAT_WG_RESIDENT = 1
# the xprop's route to the wgmma kernels (xprop_kernel): their tiles
# number at least XPROP_WG_MIN_FILL of the SMs (one persistent thread
# block an SM; at 64 tiles on 132 SMs the wgmma and mma.sync kernels were
# within 4% in the H100 runs of PERF.md, and at 32 the wgmma one took
# twice as long); at b32 they go to bsmm_xprop_sparse.cu (from
# XPROP_SP_MIN_FILL), which with its packing took 0.43-0.79x
# bsmm_xprop_wgmma.cu's time and 0.34-0.66x bsmm_xprop_mma.cu's at every
# b32 shape measured (shares 2.3-8; PERF.md); at b64 to
# bsmm_xprop_wgmma.cu (bench.py's random b64 op, share 1.49: wgmma 0.255
# ms, the sparse kernel with its packing 0.262, mma.sync 0.339); at b128
# to bsmm_xprop_wgmma.cu where a staged x tile serves at least
# XPROP_WG_MIN_SHARE of the group's columns on average (entries / items
# of xprop_wgmma_plan; set from b32 runs before the sparse kernel: 2.3-2.5
# columns a tile lost 3-13% to bsmm_xprop_mma.cu, 4.4 and more gained
# 27-39%; b128 not measured since): the share is read, and the plan built
# for it, at XPROP_WG_SHARE_BLOCK_SIZES alone)
XPROP_WG_MIN_FILL = 0.48
XPROP_WG_MIN_SHARE = 3.0
XPROP_WG_SHARE_BLOCK_SIZES = (128,)
# the updat's unsplit runs from which the mma.sync kernel is kept
# (updat_kernel)
UPDAT_WG_LONG_RUN = 8192
# bsmm_updat_sparse.cu (wgmma fed by TMA over updat_sparse_plan's bundles):
# the block sizes it takes and, for each, the bundle sizes R it is built
# for (a bundle: R block-rows of the shared operand, D's n = R * b); the
# plan's cost of a bundle size weighs a byte read against
# UPDAT_SP_FLOPS_PER_BYTE operations (the H100's 989 TFLOP/s of bf16
# products over the ~6 TB/s the updat kernels drew from L2: PERF.md)
UPDAT_SP_BUNDLES = {32: (1, 2, 3, 4), 64: (1, 2)}
UPDAT_SP_FLOPS_PER_BYTE = 165
# the share of updat_plan's tiles (a token row) at most which the updat
# takes bsmm_updat_sparse.cu (updat_kernel): in the H100 runs of PERF.md
# the LM's products (0.59 of the tiles) took 0.62-0.84x
# bsmm_updat_wgmma.cu's time at N 1,024-16,384, the MoE's dense bsmm1
# (0.33) 0.89x, the conv's (0.43-0.48) 0.26-0.57x; bench.py's random
# 8192² op (1.0: no two x block-rows alike) 1.05x
UPDAT_SP_MAX_TILES = 0.8
# bsmm_xprop_sparse.cu (wgmma fed by a TMA x box of 64 input features, a
# pair of input blocks, and one bulk copy of the stage's packed weight
# blocks): the block sizes it takes and the input features a stage
XPROP_SP_BLOCK_SIZES = (32,)
XPROP_SP_DEPTH = 64
# its tiles (ceil(N / XPROP_WG_TM) x column groups) number at least
# XPROP_SP_MIN_FILL of the SMs: on 132, at 40 tiles (the MoE's bsmm1 bprop,
# N 2560) it took 0.031 ms against bsmm_xprop_mma.cu's 0.048, at 32 (the
# LM's bsmm1 bprop at N 2048, an earlier version of it) 0.034 against 0.025
XPROP_SP_MIN_FILL = 0.30


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


def updat_reduce_plain(parts):
    """Plain version of ``bsmm_updat_reduce``: parts[0] + parts[1] + ... in
    that order, in f32."""
    acc = parts[0].float()
    for s in range(1, parts.shape[0]):
        acc = acc + parts[s]
    return acc


def merge_plain(tiles, idx, bsize, out_dtype=None):
    """Plain version of ``bsmm_merge``: y[:, o] = Σ_p tiles[:, idx[o, p]]
    over the (N, T·bsize) f32 partial tiles, summed in f32 in phase order
    (p = 0, 1, ...) and cast once to ``out_dtype`` (default f32).  idx:
    (n_out, P) int64 on the tiles' device."""
    N = tiles.shape[0]
    t = tiles.float().reshape(N, -1, bsize)[:, idx]      # (N, n_out, P, b)
    acc = t[:, :, 0]
    for p in range(1, idx.shape[1]):
        acc = acc + t[:, :, p]
    return acc.reshape(N, -1).to(out_dtype or torch.float32)


# ---------------- host-side plans (NumPy, from the LUT's CSR) ----------------

def _entry_rows(row_ptr):
    """(entries of each row, row of each entry) of a CSR row pointer."""
    lens = np.diff(np.asarray(row_ptr, np.int64))
    return lens, np.repeat(np.arange(len(lens)), lens)


def fine_plan(row_ptr, ent_in, ent_w, bsize):
    """The fine kernel's plan: each output column's entries, in order, cut
    into chunks of Gf = 128 / bsize.  chunk_ptr (n_out + 1,): the chunks
    of column o are chunk_ptr[o]..chunk_ptr[o + 1]; slot_in, slot_w
    (chunks, Gf): each slot's input block and weight block, -1 after the
    column's last entry.  All int32."""
    gf = FINE_DEPTH // bsize
    row_ptr = np.asarray(row_ptr, np.int64)
    lens, row = _entry_rows(row_ptr)
    chunk_ptr = np.concatenate([[0], np.cumsum(-(-lens // gf))])
    pos = np.arange(len(row)) - row_ptr[row]
    chunk, slot = chunk_ptr[row] + pos // gf, pos % gf
    slot_in = np.full((int(chunk_ptr[-1]), gf), -1, np.int32)
    slot_w = slot_in.copy()
    slot_in[chunk, slot] = ent_in
    slot_w[chunk, slot] = ent_w
    return {"chunk_ptr": chunk_ptr.astype(np.int32), "slot_in": slot_in,
            "slot_w": slot_w}


def window_plan(row_ptr, ent_in, ent_w, n_in_blocks, bsize):
    """The window kernel's plan: a CSR over (super-group sg of SG output
    columns, window win of WB input blocks, local column lo).  Entries
    ptr[(sg·nwin + win)·SG + lo] .. of the next give (lo, slot within
    the window, weight block) of output column sg·SG + lo in window win,
    in LUT (ascending input) order.  SG = ``WINDOW_SG[bsize]``, WB =
    ``WINDOW_SLAB // bsize``, as ``csrc/bsmm_window.cu`` takes them."""
    wb, sg = WINDOW_SLAB // bsize, WINDOW_SG[bsize]
    lens, row = _entry_rows(row_ptr)
    nwin, n_sg = -(-n_in_blocks // wb), -(-len(lens) // sg)
    ent_in = np.asarray(ent_in, np.int64)
    key = ((row // sg) * nwin + ent_in // wb) * sg + row % sg
    order = np.argsort(key, kind="stable")       # keeps the LUT order
    ptr = np.concatenate(
        [[0], np.cumsum(np.bincount(key, minlength=n_sg * nwin * sg))])
    return {"ptr": ptr.astype(np.int32),
            "ent_lo": (row % sg)[order].astype(np.int32),
            "ent_slot": (ent_in % wb)[order].astype(np.int32),
            "ent_w": np.asarray(ent_w)[order].astype(np.int32),
            "WB": wb, "SG": sg, "nwin": nwin}


def window_tn(N, n_sg, sm_count):
    """The mma.sync window kernel's N-tile for a product of N rows over
    ``n_sg`` super-groups: the largest of ``WINDOW_TNS`` whose grid,
    ceil(N / TN) · n_sg thread blocks, is at least the card's
    ``sm_count`` (the smallest if none is).  A larger tile reads each W
    block fewer times; a full grid keeps every SM busy.  Shapes and the
    SM count only.  (The wgmma window kernel keeps WINDOW_WG_TN rows and
    takes only the shapes whose tiles fill the card: ``window_kernel``.)"""
    for tn in WINDOW_TNS:
        if -(-N // tn) * n_sg >= sm_count:
            return tn
    return WINDOW_TNS[-1]


def _window_wg_shape(bsize):
    """(KD, SUBM, SUBK) of ``csrc/bsmm_window_wgmma.cu`` at a block size: a
    cell's depth (input features; its rows KD · 2 bytes), and the
    block-columns and input blocks a cell's (64, KD) tile spans (1 and 1
    at b64 and b128, where a cell is a 64 x 64 part of one block)."""
    kd = min(max(bsize, 16), WINDOW_WG_SLAB)
    return kd, max(1, 64 // bsize), max(1, kd // bsize)


def window_wgmma_plan(row_ptr, ent_in, ent_w, bsize):
    """``csrc/bsmm_window_wgmma.cu``'s plan over a CSR of output
    block-columns whose entries name their input blocks in ascending order
    (the LUT's order; raises otherwise).  Groups of WINDOW_WG_FEATURES
    output features (G = 256 // bsize columns, four m64 slots of 64
    features); windows of WINDOW_WG_SLAB input features, each cut into
    64 // KD k-blocks (``_window_wg_shape``); a cell: the (64, KD) tile of
    one (k-block, m-slot) of a group's window, present where a block of
    the layout meets it.  An item: a window of a group with a present
    cell.  u_ptr (groups + 1,): the items of group g are u_ptr[g] ..
    u_ptr[g + 1], in window order; u_in (items,): the item's window;
    u_mask (items,): bit q · 4 + s set for its present cell of k-block q,
    m-slot s; u_woff (items,): its first cell in the packed order (item
    by item, bit by bit); cell_w (cells, SUBM · SUBK + 1): the weight
    block each (column jm, input block jk) of a cell's tile holds at jm ·
    SUBK + jk, -1 where none, and last mo << 16 | ko, the tile's offset in
    its block at b64 and b128 (0 below).  Arrays int32; G, KD, cells."""
    G = WINDOW_WG_FEATURES // bsize
    kd, subm, subk = _window_wg_shape(bsize)
    bits = (WINDOW_WG_SLAB // kd) * 4
    row_ptr = np.asarray(row_ptr, np.int64)
    ent_in = np.asarray(ent_in, np.int64)[:row_ptr[-1]]
    ent_w = np.asarray(ent_w, np.int64)[:row_ptr[-1]]
    lens, row = _entry_rows(row_ptr)
    groups = max(1, -(-len(lens) // G))
    same_row = row[1:] == row[:-1]
    if (np.diff(ent_in)[same_row] <= 0).any():
        raise ValueError("window_wgmma_plan: a column's entries must name "
                         "its input blocks in ascending order")
    # each entry's cells: one below b128; (m part, k part) pairs at b128
    rep = max(1, bsize // 64)
    e = np.repeat(np.arange(len(row)), rep * rep)
    dm = np.tile(np.repeat(np.arange(rep), rep), len(row))
    dk = np.tile(np.arange(rep), rep * len(row))
    j, i = row[e] % G, ent_in[e]
    feat, inp = j * bsize + dm * 64, i * bsize + dk * 64
    nwin = (int(ent_in.max()) * bsize // WINDOW_WG_SLAB + rep
            if len(ent_in) else 1)
    item = (row[e] // G) * nwin + inp // WINDOW_WG_SLAB
    bit = (inp % WINDOW_WG_SLAB) // kd * 4 + feat // 64 % 4
    keys, cell = np.unique(item * bits + bit, return_inverse=True)
    cell_w = np.full((len(keys), subm * subk + 1), -1, np.int32)
    cell_w[:, -1] = 0
    if bsize < 64:
        cell_w[cell, (j % subm) * subk + i % subk] = ent_w[e]
    else:
        cell_w[cell, 0] = ent_w[e]
        cell_w[cell, 1] = (dm * 64) << 16 | dk * 64
    items, first = np.unique(keys // bits, return_index=True)
    u_mask = np.bitwise_or.reduceat(1 << (keys % bits), first) \
        if len(keys) else np.zeros(0, np.int64)
    u_ptr = np.concatenate([[0], np.cumsum(np.bincount(
        items // nwin, minlength=groups))])
    return {"u_ptr": u_ptr.astype(np.int32),
            "u_in": (items % nwin).astype(np.int32),
            "u_mask": u_mask.astype(np.int32),
            "u_woff": first.astype(np.int32), "cell_w": cell_w,
            "G": G, "KD": kd, "cells": len(keys)}


def _swizzle_rows(rows, row_bytes):
    """(rows, row_bytes // 16): where wgmma's swizzle of ``row_bytes``-byte
    rows (16: none, 32, 64 or 128) puts 16-byte chunk c of row r:
    c ^ ((r · row_bytes >> 7) % (row_bytes // 16))."""
    r = np.arange(rows)[:, None]
    n = row_bytes // 16
    return np.arange(n)[None, :] ^ ((r * row_bytes >> 7) % n)


def window_wgmma_pack_plain(w, cell_w, bsize, trans_w):
    """Plain version of ``window_wgmma_pack`` (advanced indexing; block -1,
    a zero block appended after the last)."""
    kd, subm, subk = _window_wg_shape(bsize)
    b = bsize
    w = torch.cat([w.reshape(-1, b, b), w.new_zeros(1, b, b)])
    a = w if trans_w else w.transpose(1, 2)          # a[id][m][k]
    ids = cell_w[:, :-1].long()
    if b < 64:
        t = a[ids.reshape(-1, subm, subk)]           # (cells, jm, jk, b, b)
        t = t.permute(0, 1, 3, 2, 4).reshape(-1, 64, kd)
    else:
        p = b // 64
        a = a.reshape(-1, p, 64, p, 64).permute(0, 1, 3, 2, 4)
        off = cell_w[:, -1].long()
        t = a[ids[:, 0], (off >> 16) // 64, (off & 0xffff) // 64]
    sw = torch.as_tensor(_swizzle_rows(64, kd * 2), device=w.device)
    t = t.reshape(-1, 64, kd // 8, 8)
    out = torch.empty_like(t)
    out[:, torch.arange(64, device=w.device)[:, None], sw] = t
    return out.reshape(-1, 64, kd)


def window_wgmma_pack(w, cell_w, bsize, trans_w):
    """The packed cells of ``csrc/bsmm_window_wgmma.cu``: for each cell of
    ``window_wgmma_plan`` (cell_w an int32 tensor on w's device), A =
    (64 features) x (KD inputs) of the blocks it spans, Wᵀ's in fprop and
    W's as stored in bprop (``trans_w``), zeros where a block is absent,
    each row's 16-byte chunks where wgmma's swizzle of KD · 2-byte rows
    reads them (``_swizzle_rows``).  (cells, 64, KD) of w's dtype, a
    16-bit type.  On a CUDA tensor the pack kernel of
    ``csrc/bsmm_window_wgmma.cu`` (one thread a 16-byte chunk), counted in
    ``window_wgmma_pack.launches``; on the CPU
    ``window_wgmma_pack_plain``."""
    if not w.is_cuda:
        return window_wgmma_pack_plain(w, cell_w, bsize, trans_w)
    kd = _window_wg_shape(bsize)[0]
    if w.dtype not in (torch.bfloat16, torch.float16) or \
            bsize not in BLOCK_SIZES or cell_w.dtype != torch.int32 or \
            cell_w.device != w.device or cell_w.dim() != 2 or \
            not cell_w.is_contiguous():
        raise ValueError(f"window_wgmma_pack takes bf16/f16 weights of block "
                         f"size {BLOCK_SIZES} and a contiguous 2-d int32 "
                         f"cell_w on their device, got {w.dtype}, b{bsize}, "
                         f"{cell_w.dtype} {tuple(cell_w.shape)} on "
                         f"{cell_w.device}")
    w = _aligned(w.contiguous())
    wp = torch.empty((cell_w.shape[0], 64, kd), dtype=w.dtype,
                     device=w.device)
    with torch.cuda.device(w.get_device()):
        err = _build.function("bsmm_window_wgmma",
                              "bsmm_window_wgmma_pack_nc", _MODE_PACK_ARGS)(
            bsize, int(trans_w), w.data_ptr(), cell_w.data_ptr(),
            wp.data_ptr(), cell_w.shape[0], _stream(w))
    if err != 0:
        raise RuntimeError(f"window_wgmma_pack launch failed: cudaError "
                           f"{err}")
    window_wgmma_pack.launches += 1
    return wp


def fine_wgmma_stage_plain(w, slot_w, bsize, trans_w):
    """The weights of each chunk of ``fine_plan`` (slot_w (chunks,
    128/bsize)) as ``csrc/bsmm_fine_wgmma.cu``'s producer warps stage them
    for wgmma's B, (chunks, 128 · bsize) of w's dtype, zeros for a -1
    slot: in fprop the chunk's blocks' rows stacked (128 rows k of bsize
    elements, MN-major), each row's 16-byte pieces where wgmma's swizzle
    of 2 · bsize-byte rows reads them; in bprop two panels of 64 inputs,
    rows n of 128 bytes (K-major: row n of the blocks side by side),
    128-byte swizzled (``_swizzle_rows``).  The kernel reads the blocks
    where they lie; this is what it writes, for the tests' replays."""
    b, gf = bsize, FINE_DEPTH // bsize
    w = torch.cat([w.reshape(-1, b, b), w.new_zeros(1, b, b)])
    t = w[slot_w.long()]                              # (chunks, gf, b, b)
    if trans_w:
        t = t.permute(0, 2, 1, 3).reshape(-1, b, 2, 8, 8)  # ch n panel c
        t = t.permute(0, 2, 1, 3, 4)                  # (ch, panel, n, c, 8)
        rows, row_bytes = b, 128
    else:
        t = t.reshape(-1, 1, FINE_DEPTH, b // 8, 8)   # (ch, 1, k, c, 8)
        rows, row_bytes = FINE_DEPTH, 2 * b
    sw = torch.as_tensor(_swizzle_rows(rows, row_bytes), device=w.device)
    out = torch.empty_like(t)
    out[:, :, torch.arange(rows, device=w.device)[:, None], sw] = t
    return out.reshape(-1, FINE_DEPTH * b)


def split_phases(N, bsize, row_ptr, sm_count):
    """The split rule: the number P of runs to cut the longest output
    column into for a product of N rows, or 0 to run unsplit.  It splits
    when the unsplit grid, ceil(N / TM) · n_out thread blocks (TM =
    ``XPROP_TM[bsize]``), is smaller than the card's ``sm_count`` and the
    longest column holds at least 2 · SPLIT_MIN_PHASE entries; then P =
    min(SPLIT_MAX_PHASES, ceil(sm_count / grid), longest //
    SPLIT_MIN_PHASE).  Shapes and the SM count only."""
    lens = np.diff(np.asarray(row_ptr, np.int64))
    grid = -(-N // XPROP_TM[bsize]) * len(lens)
    longest = int(lens.max()) if len(lens) else 0
    if N <= 0 or grid >= sm_count or longest < 2 * SPLIT_MIN_PHASE:
        return 0
    return min(SPLIT_MAX_PHASES, -(-sm_count // grid),
               longest // SPLIT_MIN_PHASE)


def split_plan(row_ptr, phases):
    """The split route's plan: each output column of L entries cut into p =
    min(phases, L // SPLIT_MIN_PHASE) (at least 1; 0 for an empty column)
    runs of consecutive entries, near-equal.  tile_ptr (T + 2,): the CSR
    over the T runs, then one empty tile (the sentinel, written as zeros);
    the entries stay those of the LUT.  merge_idx (n_out, P): each
    column's tile ids in phase order, then the sentinel T.  int32."""
    row_ptr = np.asarray(row_ptr, np.int64)
    lens, _ = _entry_rows(row_ptr)
    p = np.where(lens > 0,
                 np.clip(lens // SPLIT_MIN_PHASE, 1, phases), 0)
    tile_row = np.repeat(np.arange(len(lens)), p)
    first = np.cumsum(p) - p
    q = np.arange(len(tile_row)) - first[tile_row]
    start = row_ptr[tile_row] + q * lens[tile_row] // p[tile_row]
    T = len(tile_row)
    tile_ptr = np.concatenate([start, [row_ptr[-1], row_ptr[-1]]])
    P = max(1, int(p.max()))
    cols = np.arange(P)[None, :]
    idx = np.where(cols < p[:, None], first[:, None] + cols, T)
    return {"tile_ptr": tile_ptr.astype(np.int32),
            "merge_idx": idx.astype(np.int32), "tiles": T + 1}


def xprop_groups(row_ptr, ent_in, bsize):
    """``csrc/bsmm_fprop.cu``'s column groups over a CSR (the LUT's, or the
    split plan's tile_ptr): output columns whose entry lists name the same
    input blocks in the same order, up to gn = XPROP_F32_COLS // bsize of
    them a group, so that a thread block stages x once for all of them.
    Columns group in ascending order; gn is 1 (no grouping) where more
    than XPROP_F32_WASTE of the slots would stay empty.  grp_col (groups,
    gn) int32: each group's columns, -1 after its last; groups by
    descending entry count (the longest launched first), then by first
    column.  order (columns, 1) int32: the columns one a thread block, in
    the same order.  Each column in exactly one group."""
    gmax = max(1, XPROP_F32_COLS // bsize)
    row_ptr = np.asarray(row_ptr, np.int64)
    ent_in = np.asarray(ent_in, np.int64)
    lens = np.diff(row_ptr)
    n = len(lens)
    lists = {}
    for o in range(n):
        lists.setdefault(ent_in[row_ptr[o]:row_ptr[o + 1]].tobytes(),
                         []).append(o)
    groups = [cols[i:i + gmax] for cols in lists.values()
              for i in range(0, len(cols), gmax)]
    gn = gmax
    if gmax == 1 or n < (1 - XPROP_F32_WASTE) * len(groups) * gmax:
        gn, groups = 1, [[o] for o in range(n)]
    groups.sort(key=lambda g: (-lens[g[0]], g[0]))
    grp_col = np.full((len(groups), gn), -1, np.int32)
    for i, cols in enumerate(groups):
        grp_col[i, :len(cols)] = cols
    order = np.lexsort((np.arange(n), -lens)).astype(np.int32)[:, None]
    return {"grp_col": grp_col, "gn": gn, "order": order}


def xprop_f32_tiles(bsize):
    """The (gn, tm) configurations ``csrc/bsmm_fprop.cu`` is built for at
    block size ``bsize``: full column groups at XPROP_F32_GROUP_TM rows,
    and one column a thread block at XPROP_F32_TM."""
    return ((max(1, XPROP_F32_COLS // bsize), XPROP_F32_GROUP_TM),
            (1, XPROP_F32_TM))


_F32_TILES = {b: xprop_f32_tiles(b) for b in BLOCK_SIZES}


def xprop_tile(N, bsize, plan, sm_count):
    """``csrc/bsmm_fprop.cu``'s configuration (gn, tm) for a product of N
    rows over ``plan`` (``xprop_groups``) on a card of ``sm_count`` SMs:
    full column groups (8 x 8 outputs a thread, x staged once a group)
    where the plan groups the columns gn = XPROP_F32_COLS // bsize to a
    group (at b128 one: every column) and their grid, ceil(N / 64) ·
    groups, puts two thread blocks on each SM; else one column a thread
    block at 32 rows (4 x 4 a thread), so a small N or few columns still
    fill the card.  Shapes, the plan's counts and the SM count only."""
    gmax = max(1, XPROP_F32_COLS // bsize)
    if plan["gn"] == gmax and -(-N // XPROP_F32_GROUP_TM) * \
            len(plan["grp_col"]) >= 2 * sm_count:
        return gmax, XPROP_F32_GROUP_TM
    return 1, XPROP_F32_TM


def xprop_launch(plan, tile):
    """``csrc/bsmm_fprop.cu``'s launch in configuration ``tile`` = (gn, tm)
    over ``plan`` (``xprop_groups``): {"grp_col": the plan's groups where
    gn is their width, else its columns one a thread block ("order"),
    "gn", "tm"}, the ``plan`` that ``bsmm_fprop``, ``bsmm_bprop`` and
    ``bsmm_partials`` take in f32."""
    gn, tm = tile
    return {"grp_col": plan["grp_col"] if gn == plan["gn"] else
            plan["order"], "gn": gn, "tm": tm}


def updat_plan(ent_c, ent_k, bsize):
    """The tensor-core updat's plan: the layout's blocks (the updat list
    ent_c, ent_k) cut into groups of at most G = UPDAT_ROWS // bsize that
    share one operand tile.  "by_c": the groups are x block-rows (a thread
    block stages x[:, c] once and the blocks' dy column tiles in its
    slots); else dy block-columns (dy[:, k] shared, x tiles in the slots):
    whichever axis gives fewer groups, x block-rows on a tie.  grp_q
    (groups,): the shared block; slot_p, slot_e (groups, G): each slot's
    block of the other operand and its block id, -1 after the group's last
    entry (slots fill from 0); a shared block's entries go in ascending
    order of the other block, G to a group.  Arrays int32."""
    ent_c, ent_k = (np.asarray(a, np.int64) for a in (ent_c, ent_k))
    G = UPDAT_ROWS // bsize

    def cut(shared, other):
        order = np.lexsort((other, shared))
        s = shared[order]
        starts = np.flatnonzero(np.r_[True, s[1:] != s[:-1]])
        lens = np.diff(np.r_[starts, len(s)])
        n_grp = -(-lens // G)
        row = np.repeat(np.arange(len(starts)), lens)
        pos = np.arange(len(s)) - starts[row]
        grp = (np.cumsum(n_grp) - n_grp)[row] + pos // G
        slot_p = np.full((int(n_grp.sum()), G), -1, np.int32)
        slot_e = slot_p.copy()
        slot_p[grp, pos % G] = other[order]
        slot_e[grp, pos % G] = order
        return {"grp_q": np.repeat(s[starts], n_grp).astype(np.int32),
                "slot_p": slot_p, "slot_e": slot_e}

    by_c, by_k = cut(ent_c, ent_k), cut(ent_k, ent_c)
    if len(by_c["grp_q"]) <= len(by_k["grp_q"]):
        return {**by_c, "by_c": True}
    return {**by_k, "by_c": False}


def _bundles(q_ent, p_ent, R, G):
    """``updat_sparse_plan``'s groups for bundles of R shared blocks (see
    there), and the tiles (shared and slot blocks) they read a token
    row."""
    order = np.lexsort((p_ent, q_ent))
    q_s, p_s = q_ent[order], p_ent[order]
    starts = np.flatnonzero(np.r_[True, q_s[1:] != q_s[:-1]])
    ends = np.r_[starts[1:], len(q_s)]
    sets = {}             # a shared block's other blocks -> shared blocks
    for a, b in zip(starts, ends):
        sets.setdefault(p_s[a:b].tobytes(), []).append(int(q_s[a]))
    bundles, left = [], []
    for rows in sets.values():
        full = len(rows) // R * R
        bundles += [rows[i:i + R] for i in range(0, full, R)]
        left += rows[full:]
    left.sort()
    bundles += [left[i:i + R] for i in range(0, len(left), R)]
    bundles.sort()
    block = {(int(q), int(p)): int(e)
             for q, p, e in zip(q_s, p_s, order)}
    grp_q, slot_p, slot_e = [], [], []
    tiles = 0
    for rows in bundles:
        cols = np.unique(np.concatenate(
            [p_s[starts[i]:ends[i]] for i in
             np.searchsorted(q_s[starts], rows)]))
        parts = np.array_split(cols, -(-len(cols) // G))
        tiles += len(cols) + len(parts) * len(rows)
        for part in parts:
            grp_q.append(rows + [-1] * (R - len(rows)))
            slot_p.append(list(part) + [-1] * (G - len(part)))
            slot_e.append([[block.get((q, int(p)), -1) for q in rows]
                           + [-1] * (R - len(rows)) for p in part]
                          + [[-1] * R] * (G - len(part)))
    n = len(grp_q)
    return {"grp_q": np.array(grp_q, np.int32).reshape(n, R),
            "slot_p": np.array(slot_p, np.int32).reshape(n, G),
            "slot_e": np.array(slot_e, np.int32).reshape(n, G, R),
            "R": R, "tiles": tiles}


def updat_sparse_plan(ent_c, ent_k, bsize, widths):
    """``csrc/bsmm_updat_sparse.cu``'s plan over the layout's blocks (the
    updat list ent_c, ent_k) for x of C and dy of K features, ``widths`` =
    (C, K).  The shared operand Q is the wider one (x on a tie: "by_c"),
    so the narrower, re-read a block, is the one whose token rows the L2
    holds; P is the other.  Q's block-rows (x block-rows by_c, else dy
    block-columns) are cut into bundles of R: those whose P blocks are the
    same set first (the conv's taps of one input block), R to a bundle in
    ascending order, then the rest in ascending order, R to a bundle; the
    union of a bundle's P blocks, ascending, is cut into near-equal groups
    of at most G = UPDAT_ROWS // bsize slots, the larger first, so that a
    thread block stages a slot's P tile once for all R of the bundle's Q
    tiles.  R is the one of UPDAT_SP_BUNDLES[bsize] whose groups cost
    least a token row: 2 · bsize bytes a tile read (a group's Q tiles and
    slots) plus 2 · bsize² operations a (slot, Q tile) product over
    UPDAT_SP_FLOPS_PER_BYTE; the smaller R on a tie.  Groups in bundle
    order (a bundle's consecutive), bundles by their first Q block.
    grp_q (groups, R): a group's Q blocks, -1 past the bundle's last;
    slot_p (groups, G): its slots' P blocks, -1 past the last (slots fill
    from 0); slot_e (groups, G, R): the block id of (slot, Q block), -1
    where the layout has none.  Arrays int32; R, by_c and tiles (the
    tiles a token row the groups read)."""
    if bsize not in UPDAT_SP_BUNDLES:
        raise ValueError(f"updat_sparse_plan takes block sizes "
                         f"{tuple(UPDAT_SP_BUNDLES)}, got {bsize}")
    ent_c, ent_k = (np.asarray(a, np.int64) for a in (ent_c, ent_k))
    by_c = widths[0] >= widths[1]
    q_ent, p_ent = (ent_c, ent_k) if by_c else (ent_k, ent_c)
    G = UPDAT_ROWS // bsize
    best, best_cost = None, None
    for R in UPDAT_SP_BUNDLES[bsize]:
        plan = _bundles(q_ent, p_ent, R, G)
        cost = 2 * bsize * plan["tiles"] + 2 * bsize ** 2 * G * R * len(
            plan["grp_q"]) / UPDAT_SP_FLOPS_PER_BYTE
        if best is None or cost < best_cost:
            best, best_cost = plan, cost
    return {**best, "by_c": by_c}


def updat_splits(N, groups, bsize, sm_count, kernel="mma"):
    """The updat's N split: the number S of runs to cut N rows into (1 =
    unsplit).  It splits when the plan's ``groups`` thread blocks are fewer
    than UPDAT_WAVES waves of the card's resident ones, target =
    UPDAT_WAVES · resident · sm_count (resident: UPDAT_RESIDENT[bsize]
    thread blocks an SM for ``kernel`` "mma", UPDAT_WG_RESIDENT for
    "wgmma" and "sparse"), and N holds two runs of UPDAT_MIN_RUN rows; then
    S = min(UPDAT_MAX_SPLIT, ceil(target / groups), N // UPDAT_MIN_RUN).
    For "wgmma" and "sparse" (one thread block an SM, so a last wave left
    part empty costs a whole wave) S is then the count of S .. min(2 S,
    UPDAT_MAX_SPLIT, N // UPDAT_MIN_RUN) runs whose groups · S thread
    blocks fill their last wave best, the smallest on a tie.  Shapes and
    the SM count only."""
    resident = UPDAT_RESIDENT[bsize] if kernel == "mma" else \
        UPDAT_WG_RESIDENT
    target = UPDAT_WAVES * resident * sm_count
    if groups >= target or N < 2 * UPDAT_MIN_RUN:
        return 1
    cap = min(UPDAT_MAX_SPLIT, N // UPDAT_MIN_RUN)
    splits = min(cap, -(-target // groups))
    if kernel == "mma":
        return splits
    wave = resident * sm_count
    return max(range(splits, min(cap, 2 * splits) + 1),
               key=lambda s: (groups * s / (-(-groups * s // wave) * wave),
                              -s))


def updat_run_rows(N, splits, kernel="mma"):
    """Token rows a run of the split holds: ceil(N / splits) rounded up to
    a ring stage of ``kernel`` (UPDAT_TN for "mma", UPDAT_WG_TN for
    "wgmma" and "sparse"); all of N unsplit."""
    if splits <= 1:
        return N
    tn = UPDAT_TN if kernel == "mma" else UPDAT_WG_TN
    per_run = -(-N // splits)
    return -(-per_run // tn) * tn


def xprop_wgmma_plan(row_ptr, ent_in, ent_w, bsize, halves=1):
    """``csrc/bsmm_xprop_wgmma.cu``'s plan over a CSR of output
    block-columns whose entries name their input blocks in ascending order
    (the LUT's order; raises otherwise): the columns cut into groups of G =
    XPROP_WG_FEATURES // bsize consecutive ones, and each group's items,
    the union of its columns' input blocks in ascending order.  With
    ``halves`` = H > 1 (``csrc/bsmm_xprop_sparse.cu``: ``xprop_sparse_plan``)
    an item is H neighbouring input blocks (i · H .. i · H + H - 1,
    whichever hold entries), its slots H · G, half h's before half h + 1's.
    u_ptr (groups + 1,): the items of group g are u_ptr[g]..u_ptr[g + 1];
    u_in (items,): an item's input block (with halves, its first block //
    H); u_mask (items,): bit h · G + j set where the group's column slot j
    holds an entry for the item's half h (bit 31 where an item has 32
    slots: a uint32 pattern); u_w (items, H · G): that entry's weight
    block, -1 where none; grp_col (groups, G): each slot's column, -1 past
    the last.  A column's entries are its items' in order, half by half,
    so the kernels sum each column in LUT order.  Arrays int32, G, halves,
    and share: the entries an item serves on average (entries / items)."""
    W = G = max(1, XPROP_WG_FEATURES // bsize)
    if G * halves > 32:
        raise ValueError(f"xprop_wgmma_plan: {halves} halves of {G} "
                         f"columns exceed a 32-bit mask")
    row_ptr = np.asarray(row_ptr, np.int64)
    ent_in = np.asarray(ent_in, np.int64)[:row_ptr[-1]]
    ent_w = np.asarray(ent_w, np.int64)[:row_ptr[-1]]
    lens, row = _entry_rows(row_ptr)
    n_out = len(lens)
    groups = max(1, -(-n_out // W))
    same_row = row[1:] == row[:-1]
    if (np.diff(ent_in)[same_row] <= 0).any():
        raise ValueError("xprop_wgmma_plan: a column's entries must name "
                         "its input blocks in ascending order")
    n_in = (int(ent_in.max()) // halves + 1) if len(ent_in) else 1
    slot = (ent_in % halves) * W + row % W
    keys, item = np.unique((row // W) * n_in + ent_in // halves,
                           return_inverse=True)
    u_w = np.full((len(keys), W * halves), -1, np.int32)
    u_w[item, slot] = ent_w
    u_mask = np.zeros(len(keys), np.int64)
    np.add.at(u_mask, item, 1 << slot)       # one entry a (column, input)
    u_ptr = np.concatenate([[0], np.cumsum(np.bincount(
        keys // n_in, minlength=groups))])
    grp_col = np.full(groups * W, -1, np.int32)
    grp_col[:n_out] = np.arange(n_out)
    return {"u_ptr": u_ptr.astype(np.int32),
            "u_in": (keys % n_in).astype(np.int32),
            "u_mask": u_mask.astype(np.uint32).view(np.int32), "u_w": u_w,
            "grp_col": grp_col.reshape(groups, W), "G": G, "halves": halves,
            "share": len(ent_in) / max(1, len(keys))}


def xprop_sparse_plan(row_ptr, ent_in, ent_w, bsize):
    """``csrc/bsmm_xprop_sparse.cu``'s plan: ``xprop_wgmma_plan``'s column
    groups, an item the H = XPROP_SP_DEPTH // bsize input blocks (a pair
    at b32) whose x tile a stage stages; its column slots taken in pairs
    (2m, 2m + 1), a warpgroup's product covering both: u_pairs (items,)
    int32, bit h · G / 2 + m set where half h holds an entry for slot 2m
    or 2m + 1; and the order of the packed weights the kernel reads:
    w_order (entries,) int64, the weight blocks of the items' present
    (half, pair) slots, item by item, pair by pair, two a pair (-1 for an
    absent one: a block of zeros), and u_woff (items,) int32, each item's
    first in it.  Marked "sparse" (``plan_kernel``)."""
    if bsize not in XPROP_SP_BLOCK_SIZES:
        raise ValueError(f"xprop_sparse_plan takes block sizes "
                         f"{XPROP_SP_BLOCK_SIZES}, got {bsize}")
    plan = xprop_wgmma_plan(row_ptr, ent_in, ent_w, bsize,
                            halves=XPROP_SP_DEPTH // bsize)
    u_w = plan["u_w"]                        # (items, H · G): h · G + j
    pairs = u_w.reshape(len(u_w), -1, 2)     # (items, H · G / 2, 2)
    present = (pairs >= 0).any(axis=2)
    bits = (present << np.arange(present.shape[1])).sum(axis=1)
    count = 2 * present.sum(axis=1)
    return {**plan, "u_pairs": bits.astype(np.int32),
            "w_order": pairs[present].reshape(-1).astype(np.int64),
            "u_woff": (np.cumsum(count) - count).astype(np.int32),
            "sparse": True}


def _swizzled_chunks(bsize):
    """(bsize, bsize // 8): for row r of a (32, 32) block of 16-bit
    elements (64-byte rows), the 16-byte chunk that TMA's 64-byte swizzle
    puts at chunk position c: c ^ (r // 2 % 4)."""
    r = np.arange(bsize)[:, None]
    return np.arange(bsize // 8)[None, :] ^ ((r // 2) % 4)


@functools.lru_cache(maxsize=None)
def _swizzle_index(bsize, device):
    """(rows, chunks) index tensors of ``_swizzled_chunks`` on ``device``,
    made once (no copy to the device inside a captured CUDA graph)."""
    return (torch.arange(bsize, device=device)[:, None],
            torch.as_tensor(_swizzled_chunks(bsize), device=device))


def xprop_sparse_pack_plain(w, w_order, bsize):
    """Plain version of ``xprop_sparse_pack`` (advanced indexing; block -1,
    a zero block appended after the last)."""
    rows, chunk = _swizzle_index(bsize, w.device)
    w = torch.cat([w.reshape(-1, bsize, bsize), w.new_zeros(1, bsize, bsize)])
    return w.reshape(-1, bsize, bsize // 8, 8)[
        w_order[:, None, None], rows, chunk].reshape(-1, bsize, bsize)


def xprop_sparse_pack(w, w_order, bsize):
    """The packed weights of ``csrc/bsmm_xprop_sparse.cu``: w[w_order]
    (``xprop_sparse_plan``'s order, an int64 tensor on w's device; zeros
    for -1), each block's 16-byte chunks laid out as TMA's swizzle would
    stage the block (``_swizzled_chunks``), so one bulk copy stages a
    stage's blocks back to back.  (entries, bsize, bsize) of w's dtype, a
    16-bit type.  On a CUDA tensor the pack kernel of
    ``csrc/bsmm_xprop_sparse.cu`` (one thread a 16-byte chunk), counted in
    ``xprop_sparse_pack.launches``; on the CPU
    ``xprop_sparse_pack_plain``."""
    if not w.is_cuda:
        return xprop_sparse_pack_plain(w, w_order, bsize)
    if w.dtype not in (torch.bfloat16, torch.float16) or \
            bsize not in XPROP_SP_BLOCK_SIZES or \
            w_order.dtype != torch.int64 or w_order.device != w.device:
        raise ValueError(f"xprop_sparse_pack takes bf16/f16 weights of block "
                         f"size {XPROP_SP_BLOCK_SIZES} and int64 block ids on "
                         f"their device, got {w.dtype}, b{bsize}, "
                         f"{w_order.dtype} on {w_order.device}")
    w = _aligned(w.contiguous())
    wp = torch.empty((w_order.numel(), bsize, bsize), dtype=w.dtype,
                     device=w.device)
    with torch.cuda.device(w.get_device()):
        err = _build.function("bsmm_xprop_sparse", "bsmm_xprop_sparse_pack_nc",
                              _PACK_ARGS)(
            bsize, w.data_ptr(), w_order.contiguous().data_ptr(),
            wp.data_ptr(), w_order.numel(), _stream(w))
    if err != 0:
        raise RuntimeError(f"xprop_sparse_pack launch failed: cudaError {err}")
    xprop_sparse_pack.launches += 1
    return wp


def xprop_kernel(N, bsize, n_out, sm_count, share):
    """The unsplit bf16/f16 xprop's kernel for a product of N rows into
    ``n_out`` output block-columns on a card of ``sm_count`` SMs, its
    wgmma plan's items serving ``share`` entries each on average
    (``xprop_wgmma_plan``), at the block sizes the wgmma kernels take and
    where their tiles, ceil(N / XPROP_WG_TM) · ceil(n_out / G) (G =
    XPROP_WG_FEATURES // bsize), number at least XPROP_WG_MIN_FILL ·
    sm_count (at b32 XPROP_SP_MIN_FILL): "sparse"
    (``csrc/bsmm_xprop_sparse.cu``) at b32; "wgmma"
    (``csrc/bsmm_xprop_wgmma.cu``) at b64, and at the block sizes of
    XPROP_WG_SHARE_BLOCK_SIZES (b128) where share >= XPROP_WG_MIN_SHARE
    (share is read there alone).  Else "mma" (``csrc/bsmm_xprop_mma.cu``).
    Shapes, the plan's counts and the SM count only."""
    if bsize not in WGMMA_BLOCK_SIZES or N < 1:
        return "mma"
    sparse = bsize in XPROP_SP_BLOCK_SIZES
    groups = -(-n_out // (XPROP_WG_FEATURES // bsize))
    fill = XPROP_SP_MIN_FILL if sparse else XPROP_WG_MIN_FILL
    if -(-N // XPROP_WG_TM) * groups < fill * sm_count:
        return "mma"
    if sparse:
        return "sparse"
    return "wgmma" if bsize not in XPROP_WG_SHARE_BLOCK_SIZES or \
        share >= XPROP_WG_MIN_SHARE else "mma"


def window_kernel(N, bsize, n_out, sm_count):
    """The bf16/f16 window mode's kernel for a product of N rows into
    ``n_out`` output block-columns on a card of ``sm_count`` SMs:
    "wgmma" (``csrc/bsmm_window_wgmma.cu``) where its tiles,
    ceil(N / WINDOW_WG_TN) · ceil(n_out / G) (G = WINDOW_WG_FEATURES //
    bsize), number at least WINDOW_WG_MIN_FILL · sm_count; else "mma"
    (``csrc/bsmm_window_mma.cu``, whose N-tile shrinks to fill the card).
    Shapes and the SM count only."""
    tiles = -(-N // WINDOW_WG_TN) * -(-n_out // (WINDOW_WG_FEATURES
                                                  // bsize))
    return "wgmma" if N >= 1 and tiles >= WINDOW_WG_MIN_FILL * sm_count \
        else "mma"


def fine_kernel(N, bsize, n_out, sm_count):
    """The bf16/f16 fine mode's kernel for a product of N rows into
    ``n_out`` output block-columns on a card of ``sm_count`` SMs:
    "wgmma" (``csrc/bsmm_fine_wgmma.cu``) at the block sizes of
    FINE_WG_BLOCK_SIZES, else "mma" (``csrc/bsmm_fine_mma.cu``).  The
    block size and N only (n_out and the SM count, which
    ``window_kernel`` reads, are taken for one signature)."""
    return "wgmma" if N >= 1 and bsize in FINE_WG_BLOCK_SIZES else "mma"


def updat_kernel(N, bsize, groups, sm_count, tiles=None):
    """The bf16/f16 updat's kernel for a product of N rows over
    ``updat_plan``'s ``groups`` on a card of ``sm_count`` SMs, ``tiles`` =
    (the tiles a token row ``updat_sparse_plan``'s groups read, those
    ``updat_plan``'s read: blocks + groups) where the layout's block size
    is one ``csrc/bsmm_updat_sparse.cu`` takes: "sparse" (that kernel)
    where its plan reads at most UPDAT_SP_MAX_TILES of the tiles; else
    "wgmma" (``csrc/bsmm_updat_wgmma.cu``, one resident thread block an
    SM) at the block sizes it takes, but where the groups alone fill
    UPDAT_WAVES waves of it (no N split) over runs of at least
    UPDAT_WG_LONG_RUN rows; else "mma" (``csrc/bsmm_updat_mma.cu``, two
    resident thread blocks an SM).  The H100 runs in PERF.md set both
    (UPDAT_SP_MAX_TILES; the conv's C=2048 updat, 1,251 groups over N
    32,768, took 3.6% longer on the wgmma kernel than on the mma.sync
    one, and bench.py's 8192² op, ~2,300 groups over N 2,048, 33% less).
    Shapes, the plans' counts and the SM count only."""
    if bsize not in WGMMA_BLOCK_SIZES or N < 1:
        return "mma"
    if tiles is not None and bsize in UPDAT_SP_BUNDLES and \
            tiles[0] <= UPDAT_SP_MAX_TILES * tiles[1]:
        return "sparse"
    unsplit = groups >= UPDAT_WAVES * UPDAT_WG_RESIDENT * sm_count
    return "mma" if unsplit and N >= UPDAT_WG_LONG_RUN else "wgmma"


# ---------------- the kernels' wrappers ----------------

_P, _I = ctypes.c_void_p, ctypes.c_int


def _xprop_args(n_ints, n_extra=0):
    """ctypes argument types of an xprop kernel's C function: (dtype,
    bsize, trans_w, x, w, n_ints index arrays, y, N, C, K, n_extra ints,
    stream)."""
    return [_I] * 3 + [_P] * (3 + n_ints) + [_I] * (3 + n_extra) + [_P]


_XPROP_ARGS = _xprop_args(3)
_UPDAT_ARGS = [_I, _I, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P]
_MERGE_ARGS = [_I, _I, _P, _P, _P, _I, _I, _I, _I, _P]
_UPDAT_MMA_ARGS = [_I, _I, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                   _I, _I, _P]
_UPDAT_SP_ARGS = [_I] * 4 + [_P] * 6 + [_I] * 7 + [_P]
_REDUCE_ARGS = [_P, _P, _I, _I, _P]
_PACK_ARGS = [_I, _P, _P, _P, ctypes.c_longlong, _P]
_MODE_PACK_ARGS = [_I, _I, _P, _P, _P, ctypes.c_longlong, _P]


def _check_common(fn, x, others, bsize, ints=()):
    """Device, dtype and block-size checks shared by the wrappers; ``ints``
    are the int32 index tensors."""
    if not x.is_cuda:
        raise ValueError(f"{fn} launches a CUDA kernel: its input must be on "
                         f"a CUDA device")
    dev = x.device
    for name, t in (*others, *ints):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, input on {dev}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"{fn} takes f32, bf16 or f16, got {x.dtype}")
    if bsize not in BLOCK_SIZES:
        raise ValueError(f"unsupported block size {bsize}")
    for name, t in ints:
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise TypeError(f"{name} must be a contiguous int32 tensor")


@functools.lru_cache(maxsize=None)
def _sm_count(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


def device_sm_count(device=None):
    """Streaming multiprocessors of a CUDA device (default the current
    one): the count the split rule and ``window_tn`` read."""
    index = None if device is None else torch.device(device).index
    return _sm_count(torch.cuda.current_device() if index is None else index)


def _stream(x):
    """The raw handle of the current stream of x's CUDA device (the
    handle alone: no Stream object a call)."""
    return torch._C._cuda_getCurrentRawStream(x.get_device())


def _aligned(t):
    """t, or a fresh (16-byte aligned) copy of a contiguous view that starts
    off a 16-byte boundary: the tensor-core kernels copy 16 bytes a
    thread."""
    return t.clone() if t.data_ptr() % 16 and t.is_contiguous() else t


def _xprop(fn, source, cfn, x, w, ints, n_ptr, bsize, n_out_blocks, trans_w,
           out_dtype=None, extra=()):
    """Checks and launches one of the xprop kernels, which share a C
    signature: (dtype, bsize, trans_w, x, w, the int32 index arrays, y,
    N, C, K, stream), with the ints ``extra`` before the stream where
    given.  ints: the (name, tensor) index arrays, the first a pointer
    array of ``n_ptr`` entries.  y: (N, n_out_blocks·bsize) of
    ``out_dtype`` (default x's)."""
    _check_common(fn, x, (("w", w),), bsize, ints)
    if w.dtype != x.dtype:
        raise TypeError(f"{fn} takes x and w of one dtype, got {x.dtype} and "
                        f"{w.dtype}")
    if x.dim() != 2 or x.shape[1] % bsize:
        raise ValueError(f"x must be (N, C) with C a multiple of {bsize}, "
                         f"got {tuple(x.shape)}")
    if w.dim() != 3 or tuple(w.shape[1:]) != (bsize, bsize):
        raise ValueError(f"w must be (blocks, {bsize}, {bsize}), "
                         f"got {tuple(w.shape)}")
    if ints[0][1].numel() != n_ptr:
        raise ValueError(f"{ints[0][0]} must have {n_ptr} entries, got "
                         f"{ints[0][1].numel()}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("x and w must be contiguous")
    N, C = x.shape
    K = n_out_blocks * bsize
    y = torch.empty((N, K), dtype=out_dtype or x.dtype, device=x.device)
    if N == 0:
        return y
    with torch.cuda.device(x.get_device()):
        err = _build.function(source, cfn,
                              _xprop_args(len(ints), len(extra)))(
            _DTYPE_CODE[x.dtype], bsize, int(trans_w), x.data_ptr(),
            w.data_ptr(), *(t.data_ptr() for _, t in ints),
            y.data_ptr(), N, C, K, *extra, _stream(x))
    if err != 0:
        raise RuntimeError(f"{fn} launch failed: cudaError {err}")
    return y


def plan_kernel(plan):
    """The bf16/f16 unsplit kernel a plan given to ``bsmm_fprop`` /
    ``bsmm_bprop`` runs: "sparse" for ``xprop_sparse_plan``'s (marked
    "sparse"), "wgmma" for ``xprop_wgmma_plan``'s, else "mma" (no plan,
    or f32's launch)."""
    if plan is None or "u_ptr" not in plan:
        return "mma"
    return "sparse" if plan.get("sparse") else "wgmma"


def _wgmma_xprop(fn, x, w, plan, bsize, n_out_blocks, trans_w):
    """``csrc/bsmm_xprop_wgmma.cu`` over ``plan`` (``xprop_wgmma_plan``'s
    arrays as int32 tensors on x's device, G and halves 1), or
    ``csrc/bsmm_xprop_sparse.cu`` over a plan marked "sparse"
    (``xprop_sparse_plan``'s, w_order int64), w packed by
    ``xprop_sparse_pack``; x and w 16-byte aligned; bf16 or f16, the
    block sizes of WGMMA_BLOCK_SIZES (XPROP_SP_BLOCK_SIZES), N >= 1."""
    sparse = plan_kernel(plan) == "sparse"
    halves = plan.get("halves", 1)
    source = "bsmm_xprop_sparse" if sparse else "bsmm_xprop_wgmma"
    sizes = XPROP_SP_BLOCK_SIZES if sparse else WGMMA_BLOCK_SIZES
    if bsize not in sizes:
        raise ValueError(f"{fn} on {source}.cu takes block sizes {sizes}, "
                         f"got {bsize}")
    if x.dtype == torch.float32:
        raise TypeError(f"{fn} on {source}.cu takes bf16 or f16; f32 "
                        f"runs bsmm_fprop.cu over xprop_launch's plan")
    G = XPROP_WG_FEATURES // bsize
    grp = plan["grp_col"]
    if plan["G"] != G or grp.dim() != 2 or grp.shape[1] != G or \
            grp.shape[0] != -(-n_out_blocks // G):
        raise ValueError(f"the plan's grp_col must be "
                         f"({-(-n_out_blocks // G)}, {G}), got "
                         f"{tuple(grp.shape)}")
    if x.dim() == 2 and x.shape[0] == 0:
        raise ValueError(f"{fn} on {source}.cu takes N >= 1")
    want = XPROP_SP_DEPTH // bsize if sparse else 1
    if halves != want:
        raise ValueError(f"{source}.cu takes {want} halves an item, got "
                         f"{halves}")
    if plan["u_w"].shape != (plan["u_in"].numel(), G * halves) or \
            plan["u_mask"].numel() != plan["u_in"].numel():
        raise ValueError("the plan's u_in, u_mask and u_w must describe one "
                         "item a row")
    x = _aligned(x)
    if sparse:
        ints = tuple((k, plan[k]) for k in ("u_ptr", "u_in", "u_pairs",
                                            "u_woff", "grp_col"))
        _check_common(fn, x, (("w", w),), bsize, ints)   # before packing w
        if w.dtype != x.dtype:
            raise TypeError(f"{fn} takes x and w of one dtype, got {x.dtype} "
                            f"and {w.dtype}")
        wp = xprop_sparse_pack(_aligned(w), plan["w_order"], bsize)
        return _xprop(fn, source, f"{source}_nc", x, wp, ints,
                      grp.shape[0] + 1, bsize, n_out_blocks, trans_w,
                      extra=(grp.shape[0],))
    ints = tuple((k, plan[k]) for k in ("u_ptr", "u_in", "u_mask", "u_w",
                                        "grp_col"))
    w = _aligned(w)
    return _xprop(fn, source, f"{source}_nc", x, w, ints, grp.shape[0] + 1,
                  bsize, n_out_blocks, trans_w,
                  extra=(grp.shape[0], w.shape[0]))


def _unsplit(fn, x, w, ints, n_ptr, bsize, n_out_blocks, trans_w,
             partial=False, plan=None):
    """The unsplit xprop kernel for x's dtype, x and w 16-byte aligned
    (``_aligned``): ``csrc/bsmm_fprop.cu`` (fp32 on the CUDA cores) for
    f32, over ``plan`` (``xprop_launch``: grp_col an int32 tensor on x's
    device, gn and tm); for bf16 and f16 ``csrc/bsmm_xprop_wgmma.cu`` over
    a ``plan`` of ``xprop_wgmma_plan`` (``_wgmma_xprop``; not for the
    partial tiles; a plan marked "sparse": ``csrc/bsmm_xprop_sparse.cu``),
    else ``csrc/bsmm_xprop_mma.cu`` (tensor cores, mma.sync), which reads
    no plan (an f32 launch plan is ignored)."""
    suffix = "_partials" if partial else ""
    if plan_kernel(plan) != "mma" and not partial:
        return _wgmma_xprop(fn, x, w, plan, bsize, n_out_blocks, trans_w)
    x, w = _aligned(x), _aligned(w)
    extra = ()
    if x.dtype == torch.float32:
        source, cfn = "bsmm_fprop", "bsmm_xprop_nc" + suffix
        if plan is None:
            raise ValueError(f"{fn} in f32 runs over xprop_launch's plan: "
                             f"pass plan")
        grp, gn, tm = plan["grp_col"], plan["gn"], plan["tm"]
        if (gn, tm) not in _F32_TILES.get(bsize, ()):
            raise ValueError(f"bsmm_fprop.cu is built for (gn, tm) in "
                             f"{_F32_TILES.get(bsize)} at b{bsize}, got "
                             f"{(gn, tm)}")
        shape = grp.shape
        if len(shape) != 2 or shape[1] != gn or shape[0] > 65535:
            raise ValueError(f"the plan's grp_col must be (groups <= 65535, "
                             f"{gn}), got {tuple(shape)}")
        ints = (*ints, ("grp_col", grp))
        extra = (shape[0], gn, tm)
    else:
        source, cfn = "bsmm_xprop_mma", "bsmm_xprop_mma_nc" + suffix
    return _xprop(fn, source, cfn, x, w, ints, n_ptr, bsize, n_out_blocks,
                  trans_w, out_dtype=torch.float32 if partial else None,
                  extra=extra)


def bsmm_fprop(x, w, row_ptr, ent_c, ent_w, bsize, n_out_blocks, plan=None):
    """y (N, n_out_blocks*bsize) = x (N, C) · W over a CSR LUT, on the card.

    row_ptr (n_out_blocks+1,), ent_c, ent_w (nnz,): int32 CUDA tensors, the
    LUT entries of each output block-column in accumulation order.
    w: (blocks, bsize, bsize).  x and w: f32, bf16 or f16, same dtype,
    contiguous, on one CUDA device.  f32 also takes ``plan``, the launch
    (``xprop_launch`` over ``xprop_groups`` of row_ptr, its grp_col on
    x's device).  bf16 and f16 run ``csrc/bsmm_xprop_wgmma.cu`` given
    ``xprop_wgmma_plan``'s plan of row_ptr (its arrays on x's device;
    row_ptr and the entries are then not read), a launch counted in
    ``launches_wgmma`` too, or given ``xprop_sparse_plan``'s (marked
    "sparse") ``csrc/bsmm_xprop_sparse.cu``, counted in
    ``launches_sparse`` too; else ``csrc/bsmm_xprop_mma.cu``, which reads
    no plan.  Raises on anything else."""
    y = _unsplit("bsmm_fprop", x, w,
                 (("row_ptr", row_ptr), ("ent_c", ent_c), ("ent_w", ent_w)),
                 n_out_blocks + 1, bsize, n_out_blocks, trans_w=False,
                 plan=plan)
    bsmm_fprop.launches += 1
    _count_kernel(bsmm_fprop, x, plan)
    return y


def bsmm_bprop(dy, w, row_ptr, ent_k, ent_w, bsize, n_out_blocks, plan=None):
    """dx (N, n_out_blocks*bsize) = dy (N, K) · Wᵀ over the bprop CSR (one
    row per input block-column c, entries (k, w) in accumulation order),
    on the card.  Same types, plans, checks and counts as
    ``bsmm_fprop``."""
    dx = _unsplit("bsmm_bprop", dy, w,
                  (("row_ptr", row_ptr), ("ent_k", ent_k), ("ent_w", ent_w)),
                  n_out_blocks + 1, bsize, n_out_blocks, trans_w=True,
                  plan=plan)
    bsmm_bprop.launches += 1
    _count_kernel(bsmm_bprop, dy, plan)
    return dx


def _count_kernel(fn, x, plan):
    """Counts a bf16/f16 launch of ``fn`` on the wgmma or the sparse
    kernel in its ``launches_wgmma`` or ``launches_sparse``."""
    kernel = plan_kernel(plan) if x.dtype != torch.float32 else "mma"
    if kernel != "mma":
        setattr(fn, f"launches_{kernel}",
                getattr(fn, f"launches_{kernel}") + 1)


def bsmm_partials(x, w, tile_ptr, ent_in, ent_w, bsize, n_tiles,
                  trans_w=False, plan=None):
    """The split route's partial tiles, on the card: (N, n_tiles·bsize) f32,
    tile t the unrounded f32 sum of x · W (Wᵀ with ``trans_w``) over the
    entries tile_ptr[t]..tile_ptr[t+1] (``split_plan``), by the unsplit
    kernel over the tile CSR (its partials entry point).  A launch counts
    as one of ``bsmm_fprop`` (or of ``bsmm_bprop`` with ``trans_w``),
    whose kernel it is.  Same types and checks as ``bsmm_fprop``; in f32
    ``plan`` is the launch over the tiles (``xprop_groups`` of
    tile_ptr)."""
    fn = bsmm_bprop if trans_w else bsmm_fprop
    parts = _unsplit("bsmm_partials", x, w,
                     (("tile_ptr", tile_ptr), ("ent_in", ent_in),
                      ("ent_w", ent_w)),
                     n_tiles + 1, bsize, n_tiles, trans_w, partial=True,
                     plan=plan)
    fn.launches += 1
    return parts


def bsmm_split(x, w, tile_ptr, ent_in, ent_w, merge_idx, bsize, n_out_blocks,
               trans_w=False):
    """The split route in one launch, on the card, bf16 or f16: y (N,
    n_out_blocks·bsize) of x's dtype, column o the sum in phase order of
    the f32 partial tiles of its runs merge_idx[o, :] (``split_plan``:
    tile_ptr, merge_idx (n_out_blocks, P ≤ ``SPLIT_MAX_PHASES``) int32;
    ent_in, ent_w the LUT's entries), rounded once.  The P thread blocks of
    one (N-tile, column) form a cluster and sum their tiles through
    distributed shared memory (``csrc/bsmm_xprop_mma.cu``, OUT_SPLIT): the
    result equals ``bsmm_merge(bsmm_partials(...))`` bit for bit.  f32
    runs ``bsmm_partials`` + ``bsmm_merge`` and raises here; otherwise the
    types and checks of ``bsmm_fprop``."""
    if x.dtype == torch.float32:
        raise TypeError("bsmm_split runs bf16 and f16; f32 takes "
                        "bsmm_partials and bsmm_merge")
    if merge_idx.dim() != 2 or merge_idx.shape[0] != n_out_blocks \
            or not 1 <= merge_idx.shape[1] <= SPLIT_MAX_PHASES:
        raise ValueError(f"merge_idx must be ({n_out_blocks}, P) with 1 <= "
                         f"P <= {SPLIT_MAX_PHASES}, got "
                         f"{tuple(merge_idx.shape)}")
    y = _xprop("bsmm_split", "bsmm_xprop_mma", "bsmm_xprop_mma_nc_split",
               _aligned(x), _aligned(w),
               (("tile_ptr", tile_ptr), ("ent_in", ent_in),
                ("ent_w", ent_w), ("merge_idx", merge_idx)),
               tile_ptr.numel(), bsize, n_out_blocks, trans_w,
               extra=(merge_idx.shape[1],))
    bsmm_split.launches += 1
    return y


def _mode_source(name, x, w):
    """(source, x, w) of a schedule mode's kernel for x's dtype:
    ``csrc/<name>.cu`` (fp32 on the CUDA cores, equal to ``bsmm_fprop``'s
    result bit for bit) for f32, ``csrc/<name>_mma.cu`` (tensor cores)
    for bf16 and f16, with x and w 16-byte aligned (``_aligned``)."""
    if x.dtype == torch.float32:
        return name, x, w
    return f"{name}_mma", _aligned(x), _aligned(w)


def bsmm_fine(x, w, chunk_ptr, slot_in, slot_w, bsize, n_out_blocks,
              trans_w=False, kernel="mma"):
    """y (N, n_out_blocks·bsize) = x · W (Wᵀ with ``trans_w``) on the card,
    in 128-deep chunks of each output column's entries (``fine_plan``:
    chunk_ptr (n_out_blocks+1,), slot_in/slot_w (chunks, 128/bsize)
    int32).  bsize 8, 16 or 32; otherwise the types and checks of
    ``bsmm_fprop``.  bf16 and f16 run ``csrc/bsmm_fine_wgmma.cu`` with
    ``kernel`` "wgmma" (N >= 1; counted in ``launches_wgmma`` too), else
    ``csrc/bsmm_fine_mma.cu``; ``fine_kernel`` is the op's rule.  f32 runs
    ``csrc/bsmm_fine.cu``, whose result equals ``bsmm_fprop``'s bit for
    bit."""
    if bsize not in FINE_BLOCK_SIZES:
        raise ValueError(f"bsmm_fine takes block sizes {FINE_BLOCK_SIZES}, "
                         f"got {bsize}")
    wgmma = kernel == "wgmma" and x.dtype != torch.float32
    ints = (("chunk_ptr", chunk_ptr), ("slot_in", slot_in),
            ("slot_w", slot_w))
    if wgmma:
        _check_mode_wgmma("bsmm_fine", x, w, bsize, ints)
        source, x, w = "bsmm_fine_wgmma", _aligned(x), _aligned(w)
    else:
        source, x, w = _mode_source("bsmm_fine", x, w)
    y = _xprop("bsmm_fine", source, f"{source}_nc", x, w, ints,
               n_out_blocks + 1, bsize, n_out_blocks, trans_w)
    bsmm_fine.launches += 1
    bsmm_fine.launches_wgmma += wgmma
    return y


def bsmm_window(x, w, ptr, ent_slot, ent_w, bsize, n_out_blocks,
                trans_w=False, plan=None, packed=None):
    """y (N, n_out_blocks·bsize) = x · W (Wᵀ with ``trans_w``) on the card,
    x staged once per window slab for each super-group of output columns
    (``window_plan``: ptr, ent_slot, ent_w int32).  Types and checks of
    ``bsmm_fprop``.  bf16 and f16 run ``csrc/bsmm_window_wgmma.cu`` given
    ``window_wgmma_plan``'s ``plan`` (its arrays as int32 tensors on x's
    device; ptr and the entries are then not read; the cells packed a call
    by ``window_wgmma_pack``, or given as ``packed``, its output for this
    plan and W, where W is unchanged; N >= 1; counted in
    ``launches_wgmma`` too), else
    ``csrc/bsmm_window_mma.cu`` in N-tiles of ``window_tn`` rows;
    ``window_kernel`` is the op's rule.  f32 runs ``csrc/bsmm_window.cu``,
    whose result equals ``bsmm_fprop``'s bit for bit."""
    if bsize not in WINDOW_SG:
        raise ValueError(f"unsupported block size {bsize}")
    wgmma = plan is not None and x.dtype != torch.float32
    if wgmma:
        G = WINDOW_WG_FEATURES // bsize
        groups = plan["u_ptr"].numel() - 1
        if plan["G"] != G or groups != max(1, -(-n_out_blocks // G)):
            raise ValueError(f"the plan must hold {-(-n_out_blocks // G)} "
                             f"groups of {G} columns, got {groups} of "
                             f"{plan['G']}")
        ints = tuple((k, plan[k]) for k in ("u_ptr", "u_in", "u_mask",
                                            "u_woff"))
        _check_mode_wgmma("bsmm_window", x, w, bsize, ints)
        if packed is None:
            wp = window_wgmma_pack(_aligned(w), plan["cell_w"], bsize,
                                   trans_w)
        else:
            wp = packed
            want = (plan["cell_w"].shape[0], 64, _window_wg_shape(bsize)[0])
            if tuple(wp.shape) != want or wp.dtype != x.dtype or \
                    wp.device != x.device or not wp.is_contiguous():
                raise ValueError(f"packed must be window_wgmma_pack's "
                                 f"contiguous {want} of {x.dtype} on "
                                 f"{x.device}, got {tuple(wp.shape)} of "
                                 f"{wp.dtype} on {wp.device}")
        y = _xprop("bsmm_window", "bsmm_window_wgmma",
                   "bsmm_window_wgmma_nc", _aligned(x),
                   wp.view(-1, bsize, bsize) if wp.numel() else
                   wp.new_zeros(1, bsize, bsize), ints, groups + 1, bsize,
                   n_out_blocks, trans_w, extra=(groups,))
    else:
        sg, wb = WINDOW_SG[bsize], WINDOW_SLAB // bsize
        n_sg = -(-n_out_blocks // sg)
        n_ptr = n_sg * -(-(x.shape[-1] // bsize) // wb) * sg + 1
        source, x, w = _mode_source("bsmm_window", x, w)
        extra = ()
        if source == "bsmm_window_mma" and x.is_cuda:
            extra = (window_tn(x.shape[0], n_sg, device_sm_count(x.device)),)
        y = _xprop("bsmm_window", source, f"{source}_nc", x, w,
                   (("ptr", ptr), ("ent_slot", ent_slot), ("ent_w", ent_w)),
                   n_ptr, bsize, n_out_blocks, trans_w, extra=extra)
    bsmm_window.launches += 1
    bsmm_window.launches_wgmma += wgmma
    return y


def _check_mode_wgmma(fn, x, w, bsize, ints):
    """The wgmma mode kernels' checks before their weights are packed:
    those of ``bsmm_fprop``, bf16 or f16 alone, N >= 1."""
    _check_common(fn, x, (("w", w),), bsize, ints)
    if w.dtype != x.dtype or x.dtype == torch.float32:
        raise TypeError(f"{fn} on its wgmma kernel takes x and w of one "
                        f"dtype, bf16 or f16, got {x.dtype} and {w.dtype}")
    if x.dim() != 2 or x.shape[0] < 1 or x.shape[1] % bsize:
        raise ValueError(f"{fn} on its wgmma kernel takes x (N >= 1, C) "
                         f"with C a multiple of {bsize}, got "
                         f"{tuple(x.shape)}")


def mode_kernel_info(source, dtype, bsize, trans_w=False):
    """Registers, local (spilled) bytes, dynamic shared memory, resident
    thread blocks an SM and ring slots of ``csrc/bsmm_window_wgmma.cu``'s
    kernel or ``csrc/bsmm_fine_wgmma.cu``'s in direction ``trans_w``
    (``source`` "bsmm_window_wgmma" or "bsmm_fine_wgmma") in ``dtype``
    (bf16 or f16) at ``bsize``, as the runtime reports them (on the card
    only)."""
    info = (ctypes.c_int * 5)()
    if source == "bsmm_window_wgmma":
        err = _build.function(source, f"{source}_info", [_I, _I, _P])(
            _DTYPE_CODE[dtype], bsize, info)
    else:
        err = _build.function(source, f"{source}_info", [_I, _I, _I, _P])(
            _DTYPE_CODE[dtype], bsize, int(trans_w), info)
    if err != 0:
        raise RuntimeError(f"mode_kernel_info({source}, {dtype}, b{bsize}): "
                           f"cudaError {err}")
    return dict(zip(("registers", "local_bytes", "smem_bytes",
                     "blocks_per_sm", "stages"), info))


def bsmm_merge(tiles, idx, bsize, out_dtype):
    """y (N, n_out·bsize) of ``out_dtype`` = Σ_p tiles[:, idx[o, p]] in f32,
    in phase order, rounded once, on the card.  tiles: (N, T·bsize)
    contiguous f32 partial tiles (``bsmm_partials``); idx: (n_out, P)
    contiguous int32 tile ids < T (``split_plan``'s merge_idx).  Raises on
    a CPU tensor, on other dtypes and on a failed launch."""
    _check_common("bsmm_merge", tiles, (), bsize, (("idx", idx),))
    if tiles.dtype != torch.float32:
        raise TypeError(f"bsmm_merge sums f32 tiles, got {tiles.dtype}")
    if out_dtype not in _DTYPE_CODE:
        raise TypeError(f"bsmm_merge writes f32, bf16 or f16, got "
                        f"{out_dtype}")
    if tiles.dim() != 2 or tiles.shape[1] % bsize or not tiles.is_contiguous():
        raise ValueError(f"tiles must be a contiguous (N, T·{bsize}) array, "
                         f"got {tuple(tiles.shape)}")
    if idx.dim() != 2 or idx.shape[1] < 1:
        raise ValueError(f"idx must be (n_out, P >= 1), got {tuple(idx.shape)}")
    N, n_all = tiles.shape[0], tiles.shape[1] // bsize
    n_out, P = idx.shape
    y = torch.empty((N, n_out * bsize), dtype=out_dtype, device=tiles.device)
    if N == 0:
        return y
    with torch.cuda.device(tiles.get_device()):
        err = _build.function("bsmm_merge", "bsmm_merge_nc", _MERGE_ARGS)(
            _DTYPE_CODE[out_dtype], bsize, tiles.data_ptr(), idx.data_ptr(),
            y.data_ptr(), N, n_out, P, n_all, _stream(tiles))
    if err != 0:
        raise RuntimeError(f"bsmm_merge launch failed: cudaError {err}")
    bsmm_merge.launches += 1
    return y


def bsmm_updat(x, dy, ent_c, ent_k, bsize, plan=None, splits=1,
               kernel="mma"):
    """dw (blocks, bsize, bsize) f32 = x_cᵀ · dy_k per layout block, summed
    over N, on the card.  x (N, C), dy (N, K): contiguous, one dtype (f32,
    bf16 or f16); ent_c, ent_k: (blocks,) int32, the updat list; ``plan``:
    ``updat_plan``'s groups (grp_q, slot_p, slot_e as int32 tensors on x's
    device, and by_c), or for ``kernel`` "sparse" ``updat_sparse_plan``'s
    (and its R).

    f32 runs ``csrc/bsmm_updat.cu`` on the CUDA cores over the plan's
    groups, each output one chain over all of N (``splits`` is not read).
    bf16 and f16 run on the tensor cores over the plan, ``kernel`` "mma"
    ``csrc/bsmm_updat_mma.cu`` (mma.sync), "wgmma"
    ``csrc/bsmm_updat_wgmma.cu`` (wgmma fed by TMA: block sizes of
    WGMMA_BLOCK_SIZES, N >= 1; counted in ``launches_wgmma`` too) or
    "sparse" ``csrc/bsmm_updat_sparse.cu`` (wgmma fed by TMA over the
    sparse plan's bundles: block sizes of UPDAT_SP_BUNDLES, N >= 1;
    counted in ``launches_sparse`` too); with ``splits`` > 1 in runs of
    ``updat_run_rows(N, splits, kernel)`` rows, whose f32 partials
    ``bsmm_updat_reduce`` sums in order.  Each sum runs in a fixed
    order."""
    if plan is None:
        raise ValueError("bsmm_updat runs over updat_plan's groups: pass plan")
    if kernel not in ("mma", "wgmma", "sparse"):
        raise ValueError(f"bsmm_updat's kernel is 'mma', 'wgmma' or "
                         f"'sparse', got {kernel!r}")
    grp_q, slot_p, slot_e = plan["grp_q"], plan["slot_p"], plan["slot_e"]
    _check_common("bsmm_updat", x, (("dy", dy),), bsize,
                  (("ent_c", ent_c), ("ent_k", ent_k), ("grp_q", grp_q),
                   ("slot_p", slot_p), ("slot_e", slot_e)))
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
    sparse, wgmma = kernel == "sparse", kernel == "wgmma"
    R = plan["R"] if sparse else 1
    groups, G = grp_q.shape[0] if grp_q.dim() else 0, UPDAT_ROWS // bsize
    shapes = ((groups, R), (groups, G), (groups, G, R)) if sparse else \
        ((groups,), (groups, G), (groups, G))
    if (grp_q.shape, slot_p.shape, slot_e.shape) != shapes:
        raise ValueError(f"grp_q, slot_p and slot_e must be {shapes}, got "
                         f"{tuple(grp_q.shape)}, {tuple(slot_p.shape)}, "
                         f"{tuple(slot_e.shape)}")
    (N, C), K, blocks = x.shape, dy.shape[1], ent_c.numel()
    f32 = x.dtype == torch.float32
    takes = UPDAT_SP_BUNDLES if sparse else WGMMA_BLOCK_SIZES
    if kernel != "mma" and (f32 or bsize not in takes or N < 1 or (
            sparse and R not in UPDAT_SP_BUNDLES[bsize])):
        raise ValueError(f"bsmm_updat on bsmm_updat_{kernel}.cu takes bf16 "
                         f"or f16, block sizes {tuple(takes)} and N >= 1, "
                         f"got {x.dtype}, {bsize}, N={N}"
                         + (f", R={R}" if sparse else ""))
    x, dy = _aligned(x), _aligned(dy)
    p, q, ldp, ldq = (dy, x, K, C) if plan["by_c"] else (x, dy, C, K)
    ptrs = (p.data_ptr(), q.data_ptr(), grp_q.data_ptr(), slot_p.data_ptr(),
            slot_e.data_ptr())
    rows = N if f32 else updat_run_rows(N, splits, kernel)
    runs = -(-N // rows) if splits > 1 and not f32 else 1
    out = torch.empty((runs, blocks, bsize, bsize) if runs > 1 else
                      (blocks, bsize, bsize), dtype=torch.float32,
                      device=x.device)
    with torch.cuda.device(x.get_device()):
        if f32:
            err = _build.function("bsmm_updat", "bsmm_updat_nc", _UPDAT_ARGS)(
                0, bsize, int(plan["by_c"]), *ptrs, out.data_ptr(), N, ldp,
                ldq, groups, _stream(x))
        elif sparse:
            err = _build.function(
                "bsmm_updat_sparse", "bsmm_updat_sparse_nc", _UPDAT_SP_ARGS)(
                _DTYPE_CODE[x.dtype], bsize, R, int(plan["by_c"]), *ptrs,
                out.data_ptr(), N, ldp, ldq, groups, runs, rows, blocks,
                _stream(x))
        else:
            source = f"bsmm_updat_{kernel}"
            err = _build.function(source, f"{source}_nc", _UPDAT_MMA_ARGS)(
                _DTYPE_CODE[x.dtype], bsize, int(plan["by_c"]), *ptrs,
                out.data_ptr(), N, ldp, ldq, groups, runs, rows, blocks,
                _stream(x))
    if err != 0:
        raise RuntimeError(f"bsmm_updat launch failed: cudaError {err}")
    bsmm_updat.launches += 1
    bsmm_updat.launches_wgmma += wgmma
    bsmm_updat.launches_sparse += sparse
    return out if runs == 1 else bsmm_updat_reduce(out)


def sparse_kernel_info(dtype, trans_w=False):
    """Registers, local (spilled) bytes, dynamic shared memory, resident
    thread blocks an SM and ring slots of ``csrc/bsmm_xprop_sparse.cu``'s
    kernel in ``dtype`` (bf16 or f16), fprop or bprop (``trans_w``), as
    the runtime reports them for the built library (on the card only)."""
    info = (ctypes.c_int * 5)()
    err = _build.function("bsmm_xprop_sparse", "bsmm_xprop_sparse_info",
                          [_I, _I, _P])(_DTYPE_CODE[dtype], int(trans_w),
                                        info)
    if err != 0:
        raise RuntimeError(f"sparse_kernel_info({dtype}, {trans_w}): "
                           f"cudaError {err}")
    return dict(zip(("registers", "local_bytes", "smem_bytes",
                     "blocks_per_sm", "stages"), info))


def bsmm_updat_reduce(parts):
    """The updat split's second pass on the card: parts[0] + parts[1] + ...
    in that order, in f32 (equal bit for bit to ``updat_reduce_plain``).
    parts: (S, ...) contiguous f32 on a CUDA device, a partial's size a
    multiple of 4.  Raises on anything else."""
    if not parts.is_cuda:
        raise ValueError("bsmm_updat_reduce launches a CUDA kernel: its "
                         "input must be on a CUDA device")
    if parts.dtype != torch.float32 or not parts.is_contiguous() \
            or parts.dim() < 2 or parts[0].numel() % 4:
        raise ValueError(f"parts must be a contiguous f32 (S, ...) array "
                         f"with a partial's size a multiple of 4, got "
                         f"{parts.dtype} {tuple(parts.shape)}")
    dw = torch.empty(parts.shape[1:], dtype=torch.float32,
                     device=parts.device)
    with torch.cuda.device(parts.get_device()):
        err = _build.function("bsmm_updat_mma", "bsmm_updat_reduce_nc",
                              _REDUCE_ARGS)(
            parts.data_ptr(), dw.data_ptr(), parts.shape[0],
            parts[0].numel() // 4, _stream(parts))
    if err != 0:
        raise RuntimeError(f"bsmm_updat_reduce launch failed: cudaError "
                           f"{err}")
    bsmm_updat_reduce.launches += 1
    return dw


bsmm_fprop.launches = 0
bsmm_bprop.launches = 0
bsmm_updat.launches = 0
# the launches of the wgmma kernels among those above
bsmm_fprop.launches_wgmma = 0
bsmm_bprop.launches_wgmma = 0
bsmm_updat.launches_wgmma = 0
# and of the sparse column groups' kernel (bsmm_xprop_sparse.cu)
bsmm_fprop.launches_sparse = 0
bsmm_bprop.launches_sparse = 0
# and of the updat's on bsmm_updat_sparse.cu
bsmm_updat.launches_sparse = 0
xprop_sparse_pack.launches = 0
bsmm_updat_reduce.launches = 0
bsmm_fine.launches = 0
bsmm_window.launches = 0
# the launches of the wgmma mode kernels among those above, and of the
# window kernel's packing
bsmm_fine.launches_wgmma = 0
bsmm_window.launches_wgmma = 0
window_wgmma_pack.launches = 0
bsmm_merge.launches = 0
bsmm_split.launches = 0
