"""The ``fprop_packed`` weight store's shape and block order.

The JAX package's ``BlocksparseMatMul(w_layout="fprop_packed")`` keeps
its weights in the order of its TPU fprop schedule, so that the TPU
kernel reads its weight panels with no gather.  That order is whatever
the op's cost model picked among its schedule builders
(``blocksparse_tpu/ops/matmul.py:183-339``): the dense-tile, phased or
window schedule gives a *panel* store ``(chunks, R·b, G·b)`` whose cells
hold transposed blocks and whose padding cells are zero; the grouped or
supertile schedule gives a *slot* store ``(packed_blocks, b, b)``.

This module holds NumPy copies of those builders and of the op's choice,
fprop side only, so that the port rebuilds the same store bit for bit
and a store saved by either package loads in the other.  Nothing here
runs a kernel: the port's op unpacks the store to canonical blocks and
runs its own kernels (``ops/matmul.py``).  The bprop and updat schedules,
the VMEM estimates and the tile pickers, which decide nothing about the
store, are not copied.

At ``NATIVE_MIN_NNZ`` entries and above the grouped and supertile
builders call the host library (``blocksparse_tpu_torch.native``), and
``cluster_rows`` calls it at every size, as the JAX builders do; the
library and the NumPy builders give the same arrays.  ``native=False``
runs the NumPy builders alone (minutes at 10^5 blocks).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from blocksparse_tpu_torch import native as native_lib

CONTRACT = 128           # the TPU's MXU contraction depth
STEP_OVERHEAD_LANES = 52  # a grid step's fixed cost, in MXU lanes
NATIVE_MIN_NNZ = 20000   # below this the NumPy builders are fast enough
# an extra phased-cover group's cost, in MXU pass-equivalents, and the
# supertile schedule's largest zero-padding inflation (the JAX op's)
PHASED_EXTRA_GROUP_PASSES = 9
SUPERTILE_MAX_INFLATION = 1.8


def choose_contract_blocks(bsize: int, entries_per_row, max_contract=512,
                           max_waste=0.15) -> int:
    """G, the blocks packed per grouped chunk: the deepest contraction
    whose row padding wastes at most ``max_waste``."""
    total = sum(max(1, len(r)) for r in entries_per_row)
    best = max(1, CONTRACT // bsize)
    for contract in (max_contract, 256, 128):
        if contract < bsize:
            continue
        G = max(1, contract // bsize)
        padded = sum(max(1, -(-len(r) // G)) * G for r in entries_per_row)
        waste = (padded - total) / padded
        if waste <= max_waste:
            return G
    return best


# ------------------------------------------------------------------
# Grouped and supertile schedules: the slot store
# ------------------------------------------------------------------

@dataclass
class GroupedSchedule:
    rows: np.ndarray      # (groups, CH) local out-row (0..R-1) per chunk
    in_idx: np.ndarray    # (groups, CH, G) input block-rows per slot
    w_idx: np.ndarray     # (groups, CH, G) weight block ids
    w_valid: np.ndarray   # (groups, CH, G)
    n_out_blocks: int
    R: int
    G: int
    contiguous: bool = False   # every chunk one contiguous supertile

    @property
    def groups(self):
        return self.rows.shape[0]

    @property
    def CH(self):
        return self.rows.shape[1]


def build_grouped_schedule(entries_per_row, n_out_blocks: int, G: int,
                           R: int, flat=None,
                           native: bool = True) -> GroupedSchedule:
    """Each group of R output rows emits each row's entries in chunks of
    G slots (an empty row one empty chunk); groups are padded to the
    longest with all-invalid chunks.  flat: (in_blk, w_id, row_of)
    entries sorted by row, for the host library at large sizes."""
    if native and flat is not None and flat[0].shape[0] >= NATIVE_MIN_NNZ:
        out = native_lib.grouped_schedule(flat[2], flat[0], flat[1],
                                          n_out_blocks, G, R)
        if out is not None:
            rows, in_idx, w_idx, w_valid = out
            return GroupedSchedule(rows=rows, in_idx=in_idx, w_idx=w_idx,
                                   w_valid=w_valid,
                                   n_out_blocks=n_out_blocks, R=R, G=G)
    groups = -(-n_out_blocks // R)
    per_group = []
    for g in range(groups):
        chunks = []
        for r in range(R):
            row = g * R + r
            if row >= n_out_blocks:
                break
            ents = entries_per_row[row]
            nch = max(1, -(-len(ents) // G))
            for s in range(nch):
                chunk = ents[s * G:(s + 1) * G]
                ii = [chunk[i][0] if i < len(chunk) else 0 for i in range(G)]
                wi = [chunk[i][1] if i < len(chunk) else 0 for i in range(G)]
                wv = [1 if i < len(chunk) else 0 for i in range(G)]
                chunks.append((r, ii, wi, wv))
        per_group.append(chunks)
    CH = max(len(c) for c in per_group)
    rows = np.zeros((groups, CH), np.int32)
    in_idx = np.zeros((groups, CH, G), np.int32)
    w_idx = np.zeros((groups, CH, G), np.int32)
    w_valid = np.zeros((groups, CH, G), np.int32)
    for g, chunks in enumerate(per_group):
        for j, (r, ii, wi, wv) in enumerate(chunks):
            rows[g, j] = r
            in_idx[g, j] = ii
            w_idx[g, j] = wi
            w_valid[g, j] = wv
    return GroupedSchedule(rows=rows, in_idx=in_idx, w_idx=w_idx,
                           w_valid=w_valid, n_out_blocks=n_out_blocks,
                           R=R, G=G)


def default_rows_per_group(bsize: int, n_out_blocks: int,
                           avg_entries: float = 8.0,
                           panel_budget: int = 1536 * 1024) -> int:
    """R for a 256-row output tile, halved while a group's weight panel
    would pass ``panel_budget`` bytes."""
    R = min(max(1, 256 // bsize), n_out_blocks)
    while R > 1 and R * avg_entries * bsize * bsize * 4 > panel_budget:
        R //= 2
    return R


def packed_len(sched: GroupedSchedule) -> int:
    return sched.groups * sched.CH * sched.G


def packed_positions(sched: GroupedSchedule, blocks: int) -> np.ndarray:
    """pos[w_id]: the slot of canonical block w_id in the slot store."""
    flat_w = sched.w_idx.reshape(-1)
    slots = np.flatnonzero(sched.w_valid.reshape(-1))
    pos = np.full(blocks, -1, np.int64)
    pos[flat_w[slots]] = slots
    if (pos < 0).any() or len(slots) != blocks:
        raise ValueError("the schedule does not hold each block once")
    return pos.astype(np.int32)


def supertile_rows(entries_per_row, bsize):
    """Each row's entries on the grid of supertiles (V = 128 / b
    consecutive input blocks): (new_rows, inflation), new_rows[r] the
    present supertiles as (first input block, [slot -> w_id or -1])."""
    V = max(1, CONTRACT // bsize)
    total = 0
    kept = 0
    new_rows = []
    for ents in entries_per_row:
        by_st = {}
        for (cb, w) in ents:
            by_st.setdefault(cb // V, {})[cb % V] = w
        row = []
        for st in sorted(by_st):
            slots = [by_st[st].get(i, -1) for i in range(V)]
            row.append((st * V, slots))
            total += V
        kept += len(ents)
        new_rows.append(row)
    inflation = total / max(kept, 1)
    return new_rows, inflation


def build_supertile_schedule(entries_per_row, n_out_blocks, bsize, R,
                             flat=None, native: bool = True):
    """A grouped schedule whose every chunk is one supertile (absent
    blocks invalid), and its inflation."""
    V = max(1, CONTRACT // bsize)
    if native and flat is not None and flat[0].shape[0] >= NATIVE_MIN_NNZ:
        out = native_lib.supertile_schedule(flat[2], flat[0], flat[1],
                                            n_out_blocks, V, R)
        if out is not None:
            rows, in_idx, w_idx, w_valid, padded = out
            sched = GroupedSchedule(rows=rows, in_idx=in_idx, w_idx=w_idx,
                                    w_valid=w_valid,
                                    n_out_blocks=n_out_blocks, R=R, G=V,
                                    contiguous=True)
            return sched, padded / max(flat[0].shape[0], 1)
    st_rows, inflation = supertile_rows(entries_per_row, bsize)
    groups = -(-n_out_blocks // R)
    per_group = []
    for g in range(groups):
        chunks = []
        for r in range(R):
            row = g * R + r
            if row >= n_out_blocks:
                break
            tiles = st_rows[row]
            if not tiles:
                tiles = [(0, [-1] * V)]
            for (start, slots) in tiles:
                chunks.append((r, start, slots))
        per_group.append(chunks)
    CH = max(len(c) for c in per_group)
    rows = np.zeros((groups, CH), np.int32)
    in_idx = np.zeros((groups, CH, V), np.int32)
    w_idx = np.zeros((groups, CH, V), np.int32)
    w_valid = np.zeros((groups, CH, V), np.int32)
    for g, chunks in enumerate(per_group):
        for j, (r, start, slots) in enumerate(chunks):
            rows[g, j] = r
            in_idx[g, j] = [start + i for i in range(V)]
            for i, w in enumerate(slots):
                if w >= 0:
                    w_idx[g, j, i] = w
                    w_valid[g, j, i] = 1
    sched = GroupedSchedule(rows=rows, in_idx=in_idx, w_idx=w_idx,
                            w_valid=w_valid, n_out_blocks=n_out_blocks,
                            R=R, G=V, contiguous=True)
    return sched, inflation


# ------------------------------------------------------------------
# Dense-tile (rectangle) schedules: the panel store
# ------------------------------------------------------------------

@dataclass
class DenseTileSchedule:
    """Chunk s of output group grp[s] covers an (R x G) rectangle of
    layout cells; wpos[s, r, i] is the block of cell (r, i), or
    ``blocks`` for a zero cell.  ``perm``: the clustered row order;
    ``wcls``: each chunk's width in MXU passes (the width ladder);
    ``rows_at``: a phased cover's canonical row of each group's lane
    band (-1 padding)."""
    grp: np.ndarray
    last: np.ndarray
    slot: np.ndarray
    wpos: np.ndarray
    n_out_blocks: int
    R: int
    G: int
    blocks: int
    perm: np.ndarray | None = None
    wcls: np.ndarray | None = None
    rows_at: np.ndarray | None = None

    @property
    def groups(self):
        if self.rows_at is not None:
            return self.rows_at.shape[0]
        return -(-self.n_out_blocks // self.R)

    @property
    def num_chunks(self):
        return self.grp.shape[0]

    def mxu_passes(self, bsize: int):
        """128-deep MXU pass-equivalents: chunks x ceil(depth / 128) x
        the 128-row bands of the output tile."""
        full = -(-(self.G * bsize) // CONTRACT)
        rows = max(1, (self.R * bsize) // CONTRACT)
        if self.wcls is None:
            return self.num_chunks * full * rows
        return int(np.minimum(self.wcls, full).sum()) * rows


def cluster_rows(entries_per_row, R: int, native: bool = True) -> np.ndarray:
    """Greedy union-minimising order of output rows: consecutive R rows
    of the returned permutation form one dense-tile group."""
    n = len(entries_per_row)
    n_cols = 0
    for ents in entries_per_row:
        for (cb, _w) in ents:
            n_cols = max(n_cols, cb + 1)
    if native:
        flat_r, flat_c = [], []
        for r, ents in enumerate(entries_per_row):
            for (cb, _w) in ents:
                flat_r.append(r)
                flat_c.append(cb)
        perm = native_lib.cluster_rows_native(
            np.asarray(flat_r, np.int32), np.asarray(flat_c, np.int32),
            n, max(n_cols, 1), R)
        if perm is not None:
            return perm
    return cluster_rows_py(entries_per_row, R, n_cols)


def cluster_rows_py(entries_per_row, R: int, n_cols: int) -> np.ndarray:
    """``cluster_rows`` in NumPy (the host library's bit-parity twin):
    seeds by descending support, stable; each pick the lowest-index
    unused row that grows the group's union least; then swap
    refinement."""
    n = len(entries_per_row)
    sup = np.zeros((n, max(n_cols, 1)), bool)
    for r, ents in enumerate(entries_per_row):
        for (cb, _w) in ents:
            sup[r, cb] = True
    used = np.zeros(n, bool)
    order = np.argsort(-sup.sum(1), kind="stable")
    perm = []
    for seed in order:
        if used[seed]:
            continue
        used[seed] = True
        u = sup[seed].copy()
        perm.append(int(seed))
        for _ in range(R - 1):
            cand = np.nonzero(~used)[0]
            if len(cand) == 0:
                break
            growth = (sup[cand] & ~u).sum(1)
            pick = cand[int(np.argmin(growth))]
            used[pick] = True
            u |= sup[pick]
            perm.append(int(pick))
    perm = np.asarray(perm, np.int64)
    _refine_swaps_py(sup, R, perm, passes=2)
    return perm


def _refine_swaps_py(sup, R, perm, passes=2):
    """Deterministic swap search in place: rows in ascending order, each
    swapped with the partner (ascending id) of the largest strict drop
    in the two groups' union sizes."""
    n = sup.shape[0]
    pos_of = np.empty(n, np.int64)
    pos_of[perm] = np.arange(n)

    def union_size(g, skip=-1, add=-1):
        rows = [int(perm[p]) for p in range(g * R, min((g + 1) * R, n))
                if perm[p] != skip]
        if add >= 0:
            rows.append(add)
        if not rows:
            return 0
        return int(np.any(sup[rows], axis=0).sum())

    for _ in range(passes):
        improved = False
        for r in range(n):
            g = pos_of[r] // R
            base_g = union_size(g)
            best_delta, best = 0, -1
            base_cache = {}
            for r2 in range(r + 1, n):
                g2 = pos_of[r2] // R
                if g2 == g:
                    continue
                if g2 not in base_cache:
                    base_cache[g2] = union_size(g2)
                delta = (union_size(g, skip=r, add=r2)
                         + union_size(g2, skip=r2, add=r)
                         - base_g - base_cache[g2])
                if delta < best_delta:
                    best_delta, best = delta, r2
            if best >= 0:
                pa, pb = pos_of[r], pos_of[best]
                perm[pa], perm[pb] = perm[pb], perm[pa]
                pos_of[r], pos_of[best] = pb, pa
                improved = True
        if not improved:
            break


def choose_dense_tile_G(bsize: int, union_sizes) -> int:
    """G for chunks all of full width: steps x (depth in 128-lane
    passes + a step's overhead), least over G up to 768 / b."""
    u = np.asarray([max(int(x), 1) for x in union_sizes], np.int64)
    g_max = max(1, 768 // bsize)
    best_g, best_cost = g_max, None
    for G in range(1, g_max + 1):
        ch = np.maximum(1, -(-u // G))
        depth_lanes = -(-(G * bsize) // CONTRACT) * CONTRACT
        steps = int(ch.sum())
        cost = steps * depth_lanes + steps * STEP_OVERHEAD_LANES
        if best_cost is None or cost < best_cost:
            best_g, best_cost = G, cost
    return int(best_g)


def choose_dense_tile_G_ladder(bsize: int, union_sizes):
    """G for a width-ladder schedule (each group's remainder one chunk
    of its own width in passes), a multiple of the slots a pass holds."""
    u = np.asarray([max(int(x), 1) for x in union_sizes], np.int64)
    spp = max(1, CONTRACT // bsize)
    g_max = max(spp, (768 // bsize) // spp * spp)
    best_g, best_cost = g_max, None
    for G in range(spp, g_max + 1, spp):
        full = u // G
        rem = u - full * G
        rem_lanes = -(-(rem * bsize) // CONTRACT) * CONTRACT
        steps = full + (rem > 0)
        steps = np.maximum(steps, 1)
        lanes = full * G * bsize + np.where(rem > 0, rem_lanes, 0)
        lanes = np.maximum(lanes, CONTRACT)
        cost = int(lanes.sum()) + int(steps.sum()) * STEP_OVERHEAD_LANES
        if best_cost is None or cost < best_cost:
            best_g, best_cost = G, cost
    return int(best_g)


def build_dense_tile_schedule(entries_per_row, n_out_blocks: int, bsize: int,
                              blocks: int, R: int | None = None,
                              G: int | None = None, cluster: bool = False,
                              tails: bool = True,
                              native: bool = True) -> DenseTileSchedule:
    """The partition schedule: groups of R rows (clustered with
    ``cluster``), each group's column union cut into chunks of G slots
    (the width ladder with ``tails`` and G None)."""
    R = R or max(1, CONTRACT // bsize)
    groups = -(-n_out_blocks // R)
    perm = None
    row_at = lambda p: p  # noqa: E731
    if cluster and n_out_blocks > R:
        perm = cluster_rows(entries_per_row, R, native)
        row_at = lambda p: int(perm[p])  # noqa: E731

    group_rows, group_cols = [], []
    for g in range(groups):
        ents_g, cols = [], set()
        for r in range(R):
            p = g * R + r
            if p >= n_out_blocks:
                break
            ents = entries_per_row[row_at(p)]
            ents_g.append((r, ents))
            for (cb, _w) in ents:
                cols.add(cb)
        group_rows.append(ents_g)
        group_cols.append(sorted(cols))
    ladder = tails
    if G is None:
        if ladder:
            G = choose_dense_tile_G_ladder(
                bsize, [len(c) for c in group_cols])
        else:
            G = choose_dense_tile_G(bsize, [len(c) for c in group_cols])
    return _emit_dense_tile_chunks(group_rows, group_cols, n_out_blocks,
                                   bsize, blocks, R, G, ladder=ladder,
                                   perm=perm)


def _emit_dense_tile_chunks(group_rows, group_cols, n_out_blocks, bsize,
                            blocks, R, G, ladder=False, perm=None,
                            rows_at=None):
    """The chunks of the partition and phased builders.  group_rows[g]:
    (lane band r, covered entries) pairs; group_cols[g]: the sorted
    column union of those entries."""
    groups = len(group_rows)
    spp = max(1, CONTRACT // bsize)
    grp, last, wcls, slot, wpos = [], [], [], [], []
    for g in range(groups):
        cols = group_cols[g]
        u = len(cols)
        if ladder:
            nfull = u // G
            rem = u - nfull * G
            nch = max(1, nfull + (1 if rem > 0 else 0))
            rem_slots = -(-max(rem, 1) // spp) * spp
        else:
            nfull = nch = max(1, -(-u // G))
            rem = 0
            rem_slots = G
        slot_of = {cb: p for p, cb in enumerate(cols)}
        base = len(grp)
        for j in range(nch):
            is_rem = ladder and j >= nfull
            width = rem_slots if is_rem else G
            grp.append(g)
            last.append(1 if j == nch - 1 else 0)
            wcls.append(-(-(width * bsize) // CONTRACT))
            row = []
            for i in range(G):
                p = j * G + i
                if p < u and i < width:
                    row.append(cols[p])
                elif len(slot) > 0:
                    row.append(slot[-1][i])
                else:
                    row.append(0)
            slot.append(row)
            wpos.append(np.full((R, G), blocks, np.int64))
        for r, ents in group_rows[g]:
            for (cb, w) in ents:
                p = slot_of[cb]
                wpos[base + p // G][r, p % G] = w
    return DenseTileSchedule(
        grp=np.asarray(grp, np.int32), last=np.asarray(last, np.int32),
        slot=np.asarray(slot, np.int32),
        wpos=np.stack(wpos).astype(np.int32),
        n_out_blocks=n_out_blocks, R=R, G=G, blocks=blocks, perm=perm,
        wcls=np.asarray(wcls, np.int32) if ladder else None,
        rows_at=(None if rows_at is None
                 else np.asarray(rows_at, np.int32)))


def build_dense_tile_schedule_phased(entries_per_row, n_out_blocks: int,
                                     bsize: int, blocks: int,
                                     R: int | None = None,
                                     thresholds=(3, 2, 2),
                                     G: int | None = None,
                                     tails: bool = True,
                                     native: bool = True
                                     ) -> DenseTileSchedule:
    """The phased (flexible-cover) schedule: each phase clusters the rows
    with uncovered cells, groups them, and covers only the columns at
    least ``threshold`` of a group's rows share; the last phase takes
    what is left.  A row may sit in several groups (``rows_at``)."""
    R = R or max(1, CONTRACT // bsize)
    residual = [list(ents) for ents in entries_per_row]
    group_rows, group_cols, rows_at = [], [], []
    for t in list(thresholds) + [1]:
        active = [r for r in range(n_out_blocks) if residual[r]]
        if not active:
            break
        ents_active = [residual[r] for r in active]
        if len(active) > R:
            perm = cluster_rows(ents_active, R, native)
        else:
            perm = np.arange(len(active))
        for g0 in range(0, len(active), R):
            prows = [active[int(perm[p])]
                     for p in range(g0, min(g0 + R, len(active)))]
            mult = {}
            for row in prows:
                for (cb, _w) in residual[row]:
                    mult[cb] = mult.get(cb, 0) + 1
            keep = {cb for cb, m in mult.items() if m >= t}
            if not keep:
                continue
            ents_g, rat = [], []
            for slot_r, row in enumerate(prows):
                take = [e for e in residual[row] if e[0] in keep]
                if take:
                    residual[row] = [e for e in residual[row]
                                     if e[0] not in keep]
                ents_g.append((slot_r, take))
                rat.append(row if take else -1)
            group_rows.append(ents_g)
            group_cols.append(sorted(keep))
            rows_at.append(rat + [-1] * (R - len(rat)))
    if G is None:
        if tails:
            G = choose_dense_tile_G_ladder(
                bsize, [len(c) for c in group_cols])
        else:
            G = choose_dense_tile_G(bsize, [len(c) for c in group_cols])
    return _emit_dense_tile_chunks(group_rows, group_cols, n_out_blocks,
                                   bsize, blocks, R, G, ladder=tails,
                                   rows_at=rows_at)


def dense_tile_flat_pos(sched) -> np.ndarray:
    """pos[w_id]: the flat cell (s·R + r)·G + i of canonical block w_id
    in the panel store (a dense-tile or window schedule)."""
    pos = np.full(sched.blocks, -1, np.int64)
    s, r, i = np.nonzero(sched.wpos != sched.blocks)
    w = sched.wpos[s, r, i]
    pos[w] = (s * sched.R + r) * sched.G + i
    if (pos < 0).any():
        raise ValueError("a layout block is missing from the schedule")
    return pos.astype(np.int32)


# ------------------------------------------------------------------
# The window-slab schedule (mode="window"): a panel store too
# ------------------------------------------------------------------

@dataclass
class WindowSchedule:
    """Window-major dense-tile chunks: within a super-group of SG output
    groups, the chunks of each input window of WB block-rows in turn."""
    win: np.ndarray
    pend: np.ndarray
    gl: np.ndarray
    zero: np.ndarray
    last: np.ndarray
    slot: np.ndarray
    wpos: np.ndarray      # (S, R, G) block id, or `blocks` (zero cell)
    n_out_blocks: int
    n_in_blocks: int
    R: int
    G: int
    WB: int
    SG: int
    blocks: int

    @property
    def groups(self):
        return -(-self.n_out_blocks // self.R)

    @property
    def num_chunks(self):
        return self.win.shape[0]


def build_window_schedule(entries_per_row, n_out_blocks: int,
                          n_in_blocks: int, bsize: int, blocks: int,
                          R: int | None = None, G: int | None = None,
                          WB: int = 64, SG: int = 8) -> WindowSchedule:
    R = R or max(1, CONTRACT // bsize)
    G = G or max(1, CONTRACT // bsize)
    groups = -(-n_out_blocks // R)
    nwin = -(-n_in_blocks // WB)
    nsg = -(-groups // SG)

    gw_cols = []
    for g in range(groups):
        per_win = [[] for _ in range(nwin)]
        seen = set()
        for r in range(R):
            row = g * R + r
            if row >= n_out_blocks:
                break
            for (cb, _w) in entries_per_row[row]:
                if cb not in seen:
                    seen.add(cb)
                    per_win[cb // WB].append(cb)
        for lst in per_win:
            lst.sort()
        gw_cols.append(per_win)

    win, gl, slot, wpos = [], [], [], []
    first_of = np.full(groups, -1, np.int64)
    last_of = np.full(groups, -1, np.int64)
    for sg in range(nsg):
        sg_groups = range(sg * SG, min((sg + 1) * SG, groups))
        for w in range(nwin):
            for g in sg_groups:
                cols = gw_cols[g][w]
                # an empty group emits one chunk in window 0, so that its
                # output tile is written
                if not cols and not (w == 0 and
                                     not any(gw_cols[g][v]
                                             for v in range(nwin))):
                    continue
                nch = max(1, -(-len(cols) // G))
                slot_of = {cb: p for p, cb in enumerate(cols)}
                base = len(win)
                for j in range(nch):
                    win.append(w)
                    gl.append(g - sg * SG)
                    slot.append([cols[j * G + i] - w * WB
                                 if j * G + i < len(cols) else 0
                                 for i in range(G)])
                    wpos.append(np.full((R, G), blocks, np.int64))
                for r in range(R):
                    row = g * R + r
                    if row >= n_out_blocks:
                        break
                    for (cb, wid) in entries_per_row[row]:
                        if cb // WB == w:
                            p = slot_of[cb]
                            wpos[base + p // G][r, p % G] = wid
                if first_of[g] < 0:
                    first_of[g] = base
                last_of[g] = base + nch - 1
    S = len(win)
    zero = np.zeros(S, np.int32)
    last = np.zeros(S, np.int32)
    zero[first_of] = 1
    last[last_of] = 1
    pend = np.zeros(S, np.int32)
    order = np.argsort(last_of)
    nxt_write = 0
    for s in range(S):
        pend[s] = order[nxt_write]
        if last_of[order[nxt_write]] == s:
            nxt_write += 1
    return WindowSchedule(
        win=np.asarray(win, np.int32), pend=pend,
        gl=np.asarray(gl, np.int32), zero=zero, last=last,
        slot=np.asarray(slot, np.int32),
        wpos=np.stack(wpos).astype(np.int32),
        n_out_blocks=n_out_blocks, n_in_blocks=n_in_blocks,
        R=R, G=G, WB=WB, SG=SG, blocks=blocks)


# ------------------------------------------------------------------
# The op's choice, fprop side
# ------------------------------------------------------------------

@dataclass
class PackedOrder:
    """The ``fprop_packed`` store of one layout.

    panels: True for the panel store ``(S, R·b, G·b)`` (cells hold
        transposed blocks; ``wpos`` (S, R, G) names each cell's block or
        ``blocks`` for a zero cell), False for the slot store
        ``(packed_blocks, b, b)``.
    pos: (blocks,) each canonical block's flat cell (panel store) or slot
        (slot store), the JAX op's ``_dt_flat_pos`` / ``_packed_pos``.
    mode_f: the JAX op's fprop schedule, "grouped", "dense_tile",
        "resident" or "window"; supertile: the grouped schedule is the
        contiguous-supertile one; phased: the panel store follows a
        phased cover."""
    panels: bool
    w_shape: tuple
    packed_blocks: int
    pos: np.ndarray
    mode_f: str
    supertile: bool
    phased: bool
    wpos: np.ndarray | None = None


def fprop_order(fprop_rows, n_in_blocks: int, blocks: int, bsize: int,
                mode: str = "auto", dense_tile_G=None, dense_tile_R=None,
                native: bool = True) -> PackedOrder:
    """The store the JAX op builds for a layout: fprop_rows[k] the
    sorted (input block-row, block id) entries of output block-column k,
    and the op's mode and dense-tile knobs."""
    KB, CB = len(fprop_rows), n_in_blocks
    flat = tuple(np.array(a, np.int32) for a in (
        [i for lut in fprop_rows for (i, _w) in lut],
        [w for lut in fprop_rows for (_i, w) in lut],
        [r for r, lut in enumerate(fprop_rows) for _ in lut]))

    # the grouped schedule: supertiles where their zero padding is small
    _, infl = supertile_rows(fprop_rows, bsize)
    if infl <= SUPERTILE_MAX_INFLATION:
        R_s = default_rows_per_group(bsize, KB, infl * blocks / KB)
        grouped, _ = build_supertile_schedule(fprop_rows, KB, bsize, R_s,
                                              flat=flat, native=native)
    else:
        G_f = choose_contract_blocks(bsize, fprop_rows)
        R_f = default_rows_per_group(bsize, KB, blocks / KB)
        grouped = build_grouped_schedule(fprop_rows, KB, G_f, R_f,
                                         flat=flat, native=native)

    R_dt = CONTRACT // bsize
    R_use = dense_tile_R or R_dt
    base_groups = -(-KB // R_use)
    sched, mode_f = None, "grouped"

    def dt_cost(s):
        extra = max(0, s.groups - base_groups) \
            if s.rows_at is not None else 0
        return (s.mxu_passes(bsize) * CONTRACT
                + s.num_chunks * STEP_OVERHEAD_LANES
                + extra * PHASED_EXTRA_GROUP_PASSES * CONTRACT)

    def grouped_cost(s):
        chunks = s.groups * s.CH * max(1, s.G * bsize // CONTRACT)
        return chunks * CONTRACT + s.groups * s.CH * STEP_OVERHEAD_LANES

    # (the JAX op also builds the dense-tile schedules in mode "window",
    # where the window schedule then replaces them)
    if R_use > 1 and mode not in ("grouped", "window"):
        dt = build_dense_tile_schedule(fprop_rows, KB, bsize, blocks,
                                       R=R_use, G=dense_tile_G, cluster=True,
                                       native=native)
        if dense_tile_G is None and dense_tile_R is None:
            for th in ((2,), (3, 2), (3, 2, 2)):
                ph = build_dense_tile_schedule_phased(
                    fprop_rows, KB, bsize, blocks, thresholds=th,
                    native=native)
                if dt_cost(ph) < dt_cost(dt):
                    dt = ph
        if mode in ("dense_tile", "resident") \
                or dt_cost(dt) < grouped_cost(grouped):
            sched = dt
            mode_f = "resident" if mode == "resident" else "dense_tile"
    if mode == "window":
        Gw = max(1, 2 * CONTRACT // bsize) if bsize <= 64 else 1
        sched = build_window_schedule(
            fprop_rows, KB, CB, bsize, blocks, G=Gw,
            WB=max(Gw, min(2048 // bsize, CB)),
            SG=min(8, max(1, KB // max(1, R_dt))))
        mode_f = "window"

    supertile = grouped.contiguous
    if sched is not None:
        S, R, G = sched.wpos.shape
        return PackedOrder(
            panels=True, w_shape=(S, R * bsize, G * bsize),
            packed_blocks=S * R * G, pos=dense_tile_flat_pos(sched),
            mode_f=mode_f, supertile=supertile,
            phased=getattr(sched, "rows_at", None) is not None,
            wpos=sched.wpos)
    n = packed_len(grouped)
    return PackedOrder(panels=False, w_shape=(n, bsize, bsize),
                       packed_blocks=n, pos=packed_positions(grouped, blocks),
                       mode_f=mode_f, supertile=supertile, phased=False)
