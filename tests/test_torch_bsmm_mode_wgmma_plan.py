"""The wgmma mode kernels' host side, on the CPU:
``csrc/bsmm_window_wgmma.cu``'s plan (``window_wgmma_plan``: groups of
256 output features, windows of 64 input features, the present cells of
each) and its cells' packing
(``window_wgmma_pack``), the weights of ``fine_plan``'s chunks as
``csrc/bsmm_fine_wgmma.cu``'s producer warps stage them
(``fine_wgmma_stage_plain``), and the route rules
``window_kernel``/``fine_kernel`` (the wgmma window kernel's tiles of
``WINDOW_WG_TN`` rows filling the card).

The kernels run only on the card (``test_torch_cuda.py`` holds them
against the plain versions there).  Here the plan's invariants are
checked on random, banded, dense and empty-column layouts at every block
size, in both directions; the rules are pinned by value; and the
kernels' work decomposition is replayed in f32 from the weights as the
kernels read them (un-swizzled here): the window kernel item by
item, k-block by k-block, k16 step by k16 step into each m-slot's
accumulator, the fine kernel chunk by chunk over its present slots (at
b8 an odd last slot paired with zeros), each held against
``xprop_plain`` at the sparse and dense layouts and N of 1, 63, 64, 65
and 300.  Tolerance 1e-5 of the largest |output|: the same f32 products
of f32 inputs, summed in other orders.
"""
import numpy as np
import pytest
import torch

from blocksparse_tpu_torch import BlocksparseMatMul
from blocksparse_tpu_torch.kernels import bsmm as bk

torch.set_num_threads(2)
F32_TOL = 1e-5
KINDS = ("random", "banded", "dense", "empty_column")
NS = (1, 63, 64, 65, 300)


def _layout(kind, CB, KB, seed):
    """A (CB, KB) layout: random at 0.4 (every row and column set once),
    a band, all ones, or random with empty output columns (fprop) and
    empty input rows (bprop)."""
    rng = np.random.RandomState(seed)
    if kind == "dense":
        return np.ones((CB, KB), np.int32)
    if kind == "banded":
        lay = np.zeros((CB, KB), np.int32)
        for c in range(CB):
            k = c * KB // CB
            lay[c, max(0, k - 1):k + 2] = 1
        return lay
    lay = (rng.rand(CB, KB) < 0.4).astype(np.int32)
    lay[np.arange(CB), np.arange(CB) % KB] = 1
    lay[np.arange(KB) % CB, np.arange(KB)] = 1
    if kind == "empty_column":
        lay[:, 1::3] = 0
        lay[1::4, :] = 0
        lay[0, 0] = 1
    return lay


def _op(kind, bsize, seed=0):
    """A layout of about two 256-feature groups by two 256-feature
    windows and a partial one, at block size ``bsize``."""
    CB = max(2, (2 * 256 + 96) // bsize)
    KB = max(2, (256 + 192) // bsize)
    return BlocksparseMatMul(_layout(kind, CB, KB, seed + bsize),
                             block_size=bsize, feature_axis=1)


def _csr(op, d):
    row_ptr, (ib, wb, _), n_out, n_in = op._csr(d)
    return np.asarray(row_ptr), np.asarray(ib), np.asarray(wb), n_out, n_in


def _unswizzle(packed, rows, row_bytes):
    """Packed tiles (..., rows, row_bytes // 2) as the kernels read them,
    back in logical order: chunk c of row r is at c ^ f(r)."""
    sw = torch.as_tensor(bk._swizzle_rows(rows, row_bytes))
    t = packed.reshape(*packed.shape[:-2], rows, row_bytes // 16, 8)
    return t[..., torch.arange(rows)[:, None], sw, :].reshape(packed.shape)


# ---------------- window_wgmma_plan ----------------

@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("bsize", bk.BLOCK_SIZES)
def test_window_wgmma_plan_covers_every_entry_once(bsize, kind):
    """Every LUT entry lies in its cells once (b128: four quarter cells,
    each at its offset in the block), a cell's other positions hold -1;
    a group's items in ascending windows, u_woff the running count of
    the items' cells, each cell's bit in its item's mask; the groups
    cover the output columns; both directions."""
    op = _op(kind, bsize)
    for d in "fb":
        row_ptr, ib, wb, n_out, _ = _csr(op, d)
        p = bk.window_wgmma_plan(row_ptr, ib, wb, bsize)
        G, kd = p["G"], p["KD"]
        _, subm, subk = bk._window_wg_shape(bsize)
        assert G == 256 // bsize and kd == min(max(bsize, 16), 64)
        groups = len(p["u_ptr"]) - 1
        assert groups == -(-n_out // G)
        masks = p["u_mask"].astype(np.int64)
        counts = np.array([bin(m).count("1") for m in masks])
        assert (counts > 0).all()
        np.testing.assert_array_equal(
            p["u_woff"], np.concatenate([[0], np.cumsum(counts)[:-1]]))
        assert counts.sum() == p["cells"] == len(p["cell_w"])
        assert masks.max(initial=0) < 1 << (64 // kd * 4)
        seen = {}
        for g in range(groups):
            wins = p["u_in"][p["u_ptr"][g]:p["u_ptr"][g + 1]]
            assert (np.diff(wins) > 0).all()
            for it in range(p["u_ptr"][g], p["u_ptr"][g + 1]):
                bits = [e for e in range(16) if masks[it] >> e & 1]
                for k, e in enumerate(bits):
                    cell = p["cell_w"][p["u_woff"][it] + k]
                    q, s = divmod(e, 4)
                    for pos, w in enumerate(cell[:-1]):
                        if w < 0:
                            continue
                        jm, jk = divmod(pos, subk)
                        if bsize < 64:
                            col = g * G + (s * 64 + jm * bsize) // bsize
                            blk = (p["u_in"][it] * 64 + q * kd
                                   + jk * bsize) // bsize
                            key = (col, blk, 0, 0)
                        else:
                            mo, ko = cell[-1] >> 16, cell[-1] & 0xffff
                            col = (g * 256 + s * 64 - mo) // bsize
                            blk = (p["u_in"][it] * 64 - ko) // bsize
                            key = (col, blk, mo, ko)
                        assert key not in seen
                        seen[key] = w
        want = {}
        for o in range(n_out):
            for e in range(row_ptr[o], row_ptr[o + 1]):
                for mo in range(0, max(bsize, 64) - 63, 64):
                    for ko in range(0, max(bsize, 64) - 63, 64):
                        off = (mo, ko) if bsize >= 64 else (0, 0)
                        want[(o, ib[e], *off)] = wb[e]
        assert seen == want


def test_window_wgmma_plan_refuses_unordered_entries():
    with pytest.raises(ValueError, match="ascending"):
        bk.window_wgmma_plan([0, 2], [3, 1], [0, 1], 32)


@pytest.mark.parametrize("bsize", bk.BLOCK_SIZES)
def test_window_wgmma_pack_lays_cells_out(bsize):
    """The packed cells un-swizzled: each (jm, jk) sub-tile the block
    cell_w names, transposed in fprop, as stored in bprop, zeros for -1;
    at b64/b128 the 64 x 64 part at (mo, ko)."""
    op = _op("random", bsize, seed=3)
    rng = np.random.RandomState(bsize)
    w = torch.as_tensor(rng.randn(*op.w_shape).astype(np.float32))
    kd, subm, subk = bk._window_wg_shape(bsize)
    for d in "fb":
        row_ptr, ib, wb, _, _ = _csr(op, d)
        p = bk.window_wgmma_plan(row_ptr, ib, wb, bsize)
        cw = torch.as_tensor(p["cell_w"])
        a = _unswizzle(bk.window_wgmma_pack(w, cw, bsize, d == "b"), 64,
                       kd * 2)
        assert a.shape == (p["cells"], 64, kd)
        for c in range(0, p["cells"], max(1, p["cells"] // 23)):
            cell = p["cell_w"][c]
            for pos, wid in enumerate(cell[:-1]):
                jm, jk = divmod(pos, subk)
                blk = w[wid] if d == "b" else w[wid].t()
                if bsize >= 64:
                    mo, ko = cell[-1] >> 16, cell[-1] & 0xffff
                    want, got = blk[mo:mo + 64, ko:ko + 64], a[c]
                else:
                    got = a[c, jm * bsize:(jm + 1) * bsize,
                            jk * bsize:(jk + 1) * bsize]
                    want = blk if wid >= 0 else torch.zeros_like(got)
                assert torch.equal(got, want), (d, c, pos)


# ---------------- the fine kernel's staged weights ----------------

def _fine_b(staged, bsize, trans_w):
    """The staged weights of each chunk un-swizzled into wgmma's B, (chunks,
    128 inputs k, bsize features n): fprop's rows k as they are, bprop's
    panels' rows n side by side, transposed."""
    if not trans_w:
        return _unswizzle(staged.reshape(-1, 128, bsize), 128, 2 * bsize)
    panels = _unswizzle(staged.reshape(-1, 2, bsize, 64), bsize, 128)
    return panels.permute(0, 2, 1, 3).reshape(-1, bsize, 128).transpose(1, 2)


@pytest.mark.parametrize("bsize", bk.FINE_BLOCK_SIZES)
def test_fine_wgmma_stage_lays_chunks_out(bsize):
    """Each chunk's staged weights un-swizzled are B = (128 inputs) x (b
    features): slot t's block at inputs t·b .., W[t] as stored in fprop
    (B[k][n] = W[k][n]), transposed in bprop, zeros past the column's last
    entry."""
    op = _op("empty_column", bsize, seed=5)
    rng = np.random.RandomState(bsize + 1)
    w = torch.as_tensor(rng.randn(*op.w_shape).astype(np.float32))
    for d in "fb":
        row_ptr, ib, wb, _, _ = _csr(op, d)
        plan = bk.fine_plan(row_ptr, ib, wb, bsize)
        staged = bk.fine_wgmma_stage_plain(
            w, torch.as_tensor(plan["slot_w"]), bsize, d == "b")
        assert staged.shape == (len(plan["slot_w"]), 128 * bsize)
        b_op = _fine_b(staged, bsize, d == "b")
        for ch, slots in enumerate(plan["slot_w"]):
            for t, wid in enumerate(slots):
                got = b_op[ch, t * bsize:(t + 1) * bsize]
                want = torch.zeros_like(got) if wid < 0 else \
                    (w[wid].t() if d == "b" else w[wid])
                assert torch.equal(got, want), (d, ch, t)


# ---------------- the rules ----------------

@pytest.mark.parametrize("N,groups,want", [
    (2048, 32, "wgmma"), (1031, 17, "wgmma"), (1024, 16, "mma"),
    (129, 66, "wgmma"), (128, 131, "mma"), (1, 132, "wgmma")])
def test_window_wgmma_tiles_fill_the_card(N, groups, want):
    """window_kernel counts the wgmma kernel's tiles of WINDOW_WG_TN rows
    by its groups of 256 features (b32: 8 columns), one tile an SM at
    least; window_tn stays the mma.sync kernel's rule."""
    assert bk.WINDOW_WG_TN == 128
    assert bk.window_kernel(N, 32, groups * 8, 132) == want
    assert bk.window_tn(2048, 32, 132) == 128 and \
        bk.window_tn(256, 32, 132) == 32


@pytest.mark.parametrize("N,bsize,n_out,want", [
    (2048, 32, 256, "wgmma"),  # the window regime: 512 tiles
    (256, 32, 256, "mma"),     # 64 tiles
    (64, 8, 960, "mma"),       # the canonical b8 row: 30 tiles
    (64, 32, 240, "mma"),
    (1024, 32, 256, "wgmma"),  # 256 tiles
    (4224, 16, 512, "wgmma"),  # 33 x 32
    (4224, 16, 48, "mma"),     # 33 x 3
    (2048, 128, 272, "wgmma"), (1, 8, 1 << 16, "wgmma"),
    (0, 32, 256, "mma")])
def test_window_kernel_rule(N, bsize, n_out, want):
    assert bk.WINDOW_WG_MIN_FILL == 1.0
    assert bk.window_kernel(N, bsize, n_out, 132) == want


@pytest.mark.parametrize("N,bsize,n_out,want", [
    (64, 8, 960, "mma"), (64, 16, 480, "wgmma"), (64, 32, 240, "wgmma"),
    (1000, 8, 128, "mma"), (4224, 32, 32, "wgmma"), (0, 16, 960, "mma")])
def test_fine_kernel_rule(N, bsize, n_out, want):
    assert bk.FINE_WG_BLOCK_SIZES == (16, 32)
    assert bk.fine_kernel(N, bsize, n_out, 132) == want


def test_op_names_the_mode_sources():
    """kernel_of names the source the rules pick in bf16 (the wgmma fine
    kernel at b16, the wgmma window kernel past one wave of its tiles),
    the CUDA-core ones in f32."""
    lay = _layout("random", 40, 24, 1)
    for mode, N, want in (("fine", 64, "wgmma"), ("window", 64, "mma"),
                          ("window", 16384, "wgmma")):
        op = BlocksparseMatMul(lay, block_size=16, feature_axis=1, mode=mode)
        for d in "fb":
            assert op.kernel_of(N, d, sm_count=132) == f"bsmm_{mode}_{want}"
            assert op.kernel_of(N, d, torch.float32, 132) == f"bsmm_{mode}"


# ---------------- the kernels' work, replayed ----------------

def _window_replay(x, w, op, d):
    """bsmm_window_wgmma.cu's decomposition in f32: each group's items in
    order, their k-blocks, k16 steps and present m-slots, D = A · xᵀ from
    the packed cells (all N rows at once: rows are independent)."""
    b = op.bsize
    row_ptr, ib, wb, n_out, _ = _csr(op, d)
    p = bk.window_wgmma_plan(row_ptr, ib, wb, b)
    kd = p["KD"]
    cells = _unswizzle(bk.window_wgmma_pack(w, torch.as_tensor(p["cell_w"]),
                                            b, d == "b"), 64, kd * 2)
    N, C = x.shape
    xp = torch.nn.functional.pad(x, (0, -C % 64 + 64))    # boxes past C: 0
    y = torch.zeros((N, (len(p["u_ptr"]) - 1) * 256))
    for g in range(len(p["u_ptr"]) - 1):
        acc = torch.zeros((4, 64, N))
        for it in range(p["u_ptr"][g], p["u_ptr"][g + 1]):
            box = xp[:, p["u_in"][it] * 64:(p["u_in"][it] + 1) * 64]
            mask, k = int(p["u_mask"][it]), p["u_woff"][it]
            for q in range(64 // kd):
                for t in range(kd // 16):
                    xs = box[:, q * kd + t * 16:q * kd + t * 16 + 16]
                    for s in range(4):
                        e = q * 4 + s
                        if mask >> e & 1:
                            a = cells[k + bin(mask & ((1 << e) - 1))
                                      .count("1")]
                            acc[s] += a[:, t * 16:t * 16 + 16] @ xs.t()
        y[:, g * 256:(g + 1) * 256] = acc.reshape(256, N).t()
    return y[:, :n_out * b]


def _fine_replay(x, w, op, d):
    """bsmm_fine_wgmma.cu's decomposition in f32: each (N-tile of 64,
    column) item's chunks, their present slots' x boxes (b8: an odd last
    slot paired with a box of zeros) times the chunk's staged weights, k16
    step by k16 step."""
    b = op.bsize
    row_ptr, ib, wb, n_out, _ = _csr(op, d)
    plan = bk.fine_plan(row_ptr, ib, wb, b)
    b_op = _fine_b(bk.fine_wgmma_stage_plain(
        w, torch.as_tensor(plan["slot_w"]), b, d == "b"), b, d == "b")
    N = x.shape[0]
    y = torch.zeros((N, n_out * b))
    for n0 in range(0, N, bk.FINE_WG_TM):
        rows = x[n0:n0 + bk.FINE_WG_TM]
        for o in range(n_out):
            acc = torch.zeros((rows.shape[0], b))
            for c in range(plan["chunk_ptr"][o], plan["chunk_ptr"][o + 1]):
                slots = plan["slot_in"][c]
                nv = int((slots >= 0).sum())
                boxes = [rows[:, i * b:(i + 1) * b] for i in slots[:nv]]
                if b == 8 and nv % 2:
                    boxes.append(torch.zeros_like(boxes[0]))
                a = torch.cat(boxes, 1)
                steps = len(boxes) * b // 16
                for t in range(steps):
                    acc += a[:, t * 16:t * 16 + 16] @ \
                        b_op[c, t * 16:t * 16 + 16]
            y[n0:n0 + bk.FINE_WG_TM, o * b:(o + 1) * b] = acc
    return y


def _replay_case(replay, bsize, kind):
    op = _op(kind, bsize, seed=11)
    rng = np.random.RandomState(bsize + 7)
    w = torch.as_tensor(rng.uniform(-1, 1, op.w_shape).astype(np.float32))
    lut = op._lut(torch.device("cpu"))
    for d in "fb":
        width, n_out = (op.C, op.KB) if d == "f" else (op.K, op.CB)
        for N in NS:
            x = torch.as_tensor(rng.uniform(-1, 1, (N, width))
                                .astype(np.float32))
            want = bk.xprop_plain(x, w, lut[f"{d}_in"], lut[f"{d}_w"],
                                  lut[f"{d}_out"], n_out, bsize, 1,
                                  trans_w=d == "b")
            got = replay(x, w, op, d)
            tol = F32_TOL * max(1.0, want.abs().max().item())
            torch.testing.assert_close(got, want, rtol=0, atol=tol)


@pytest.mark.parametrize("kind", ("empty_column", "dense"))
@pytest.mark.parametrize("bsize", bk.BLOCK_SIZES)
def test_window_wgmma_replay_matches_plain(bsize, kind):
    _replay_case(_window_replay, bsize, kind)


@pytest.mark.parametrize("kind", ("empty_column", "dense"))
@pytest.mark.parametrize("bsize", bk.FINE_BLOCK_SIZES)
def test_fine_wgmma_replay_matches_plain(bsize, kind):
    _replay_case(_fine_replay, bsize, kind)


# ---------------- a non-finite input ----------------

def window_non_finite_block(op, d):
    """(i, reads, partners) for an infinity in x's input block i of
    direction d: the output block-columns with an LUT entry at i (which
    every kernel and the plain version make non-finite in its row), and
    the others of the m-slots whose cell at i's k-block is present in
    ``window_wgmma_plan`` (``bsmm_window_wgmma.cu`` meets the infinity
    through the cell's zero block: NaN); the first i with such a
    partner.  b < 64: at b64 and b128 a cell lies in one block."""
    row_ptr, ib, wb, n_out, n_in = _csr(op, d)
    b = op.bsize
    p = bk.window_wgmma_plan(row_ptr, ib, wb, b)
    per = 64 // b                                  # columns an m-slot
    for i in range(n_in):
        reads = {c for c in range(n_out)
                 if i in ib[row_ptr[c]:row_ptr[c + 1]]}
        q = i * b % 64 // p["KD"]
        partners = set()
        for g in range(len(p["u_ptr"]) - 1):
            for it in range(p["u_ptr"][g], p["u_ptr"][g + 1]):
                if p["u_in"][it] != i * b // 64:
                    continue
                for s in range(4):
                    if p["u_mask"][it] >> (q * 4 + s) & 1:
                        c0 = g * p["G"] + s * per
                        partners |= {c for c in range(c0, c0 + per)
                                     if c < n_out and c not in reads}
        if partners:
            return i, reads, partners
    raise AssertionError("no input block with an absent partner")


def _non_finite_columns(y, row, bsize):
    bad = ~torch.isfinite(y[row].reshape(-1, bsize))
    assert torch.equal(bad.any(1), bad.all(1))
    return set(torch.nonzero(bad.all(1)).flatten().tolist())


@pytest.mark.parametrize("bsize", (8, 16, 32))
@pytest.mark.parametrize("d", ["f", "b"])
def test_window_wgmma_decomposition_spreads_a_non_finite_input(d, bsize):
    """An infinity in x at one input block: the plain version makes its
    row non-finite in the output columns with an entry at that block; the
    window kernel's decomposition also, as NaN, in the other columns of
    the m-slots whose cell there is present (a zero block times the
    infinity), and nowhere else; the fine kernel's multiplies no zero
    block with x and matches the plain version's columns."""
    op = _op("random", bsize, seed=12)
    i, reads, partners = window_non_finite_block(op, d)
    rng = np.random.RandomState(3)
    w = torch.as_tensor(rng.uniform(-1, 1, op.w_shape).astype(np.float32))
    x = torch.as_tensor(rng.uniform(-1, 1, (5, op.C if d == "f" else op.K))
                        .astype(np.float32))
    x[3, i * bsize + 1] = float("inf")
    lut = op._lut(torch.device("cpu"))
    n_out = op.KB if d == "f" else op.CB
    plain = bk.xprop_plain(x, w, lut[f"{d}_in"], lut[f"{d}_w"],
                           lut[f"{d}_out"], n_out, bsize, 1,
                           trans_w=d == "b")
    assert _non_finite_columns(plain, 3, bsize) == reads
    y = _window_replay(x, w, op, d)
    assert _non_finite_columns(y, 3, bsize) == reads | partners
    assert torch.isnan(y[3].reshape(-1, bsize)[sorted(partners)]).all()
    assert _non_finite_columns(_fine_replay(x, w, op, d), 3, bsize) == reads
    for r in (0, 1, 2, 4):
        assert torch.isfinite(y[r]).all()
