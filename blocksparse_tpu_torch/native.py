"""ctypes bindings of the host library ``csrc/bs_host.cpp``.

The library turns 0/1 block layouts into the TPU schedules that decide
the ``fprop_packed`` weight store's shape and order
(``kernels/packed_order.py``), and gathers byte windows from a corpus.
At first use ``g++ -O2 -shared -fPIC -std=c++17`` builds it from the
repo-root source, read in place, into ``build/blocksparse_tpu_torch/``;
it is built again when the source is newer than the library.  Each entry
point returns None where the library cannot be built or loaded, and the
callers then run their NumPy builders, which give the same arrays bit
for bit (only slower: minutes at 10^5 blocks where the library takes
seconds).

Nothing here runs at import.
"""
from __future__ import annotations

import ctypes
import functools
import os
import subprocess
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "csrc" / "bs_host.cpp"
LIBRARY = ROOT / "build" / "blocksparse_tpu_torch" / "libbs_host.so"
GXX_FLAGS = ["-O2", "-shared", "-fPIC", "-std=c++17"]

_i32p = ctypes.POINTER(ctypes.c_int32)
_i64p = ctypes.POINTER(ctypes.c_int64)
_u8p = ctypes.POINTER(ctypes.c_uint8)
_ARGTYPES = {
    "bs_grouped_schedule": (ctypes.c_int, [
        ctypes.c_int64, _i32p, _i32p, _i32p, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, _i32p, _i32p, _i32p, _i32p, _i32p]),
    "bs_supertile_schedule": (ctypes.c_int, [
        ctypes.c_int64, _i32p, _i32p, _i32p, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, _i32p, _i64p, _i32p, _i32p, _i32p, _i32p]),
    "bs_cluster_rows": (ctypes.c_int, [
        ctypes.c_int64, _i32p, _i32p, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, _i32p]),
    "bs_sample_batch": (None, [
        _u8p, ctypes.c_int64, _i64p, ctypes.c_int32, ctypes.c_int32,
        _i32p, _i32p]),
}


def _build() -> Path | None:
    """The library, compiled unless it is newer than its source; None if
    the source or a working ``g++`` is missing."""
    if not SOURCE.exists():
        return None
    if LIBRARY.exists() and \
            LIBRARY.stat().st_mtime >= SOURCE.stat().st_mtime:
        return LIBRARY
    LIBRARY.parent.mkdir(parents=True, exist_ok=True)
    # concurrent builders (test workers) each write their own file, and
    # the rename is atomic: no process loads a half-written library
    tmp = LIBRARY.with_name(f"{LIBRARY.name}.{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", *GXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                       check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
        return None
    os.replace(tmp, LIBRARY)
    return LIBRARY


@functools.lru_cache(maxsize=None)
def get_lib() -> ctypes.CDLL | None:
    """The loaded library with its functions' types set, built at first
    use; None where it cannot be built or loaded."""
    path = _build()
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(str(path))
    except OSError:
        return None
    for name, (restype, argtypes) in _ARGTYPES.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes
    return lib


def available() -> bool:
    """Whether the library built and loaded."""
    return get_lib() is not None


def _i32(a):
    return a.ctypes.data_as(_i32p)


def _entries(*arrays):
    return tuple(np.ascontiguousarray(a, np.int32) for a in arrays)


def grouped_schedule(row_of, in_blk, w_id, n_rows, G, R):
    """The grouped gather schedule of entries sorted by output row:
    (rows, in_idx, w_idx, w_valid), or None without the library."""
    lib = get_lib()
    if lib is None:
        return None
    row_of, in_blk, w_id = _entries(row_of, in_blk, w_id)
    nnz = row_of.shape[0]
    CH = ctypes.c_int32(0)
    groups = lib.bs_grouped_schedule(
        nnz, _i32(row_of), _i32(in_blk), _i32(w_id), n_rows, G, R,
        ctypes.byref(CH), None, None, None, None)
    if groups < 0:
        return None
    CH = CH.value
    rows = np.zeros((groups, CH), np.int32)
    in_idx, w_idx, w_valid = (np.zeros((groups, CH, G), np.int32)
                              for _ in range(3))
    lib.bs_grouped_schedule(
        nnz, _i32(row_of), _i32(in_blk), _i32(w_id), n_rows, G, R,
        None, _i32(rows), _i32(in_idx), _i32(w_idx), _i32(w_valid))
    return rows, in_idx, w_idx, w_valid


def supertile_schedule(row_of, in_blk, w_id, n_rows, V, R):
    """The contiguous-supertile schedule of entries sorted by output row:
    (rows, in_idx, w_idx, w_valid, padded_blocks), or None without the
    library."""
    lib = get_lib()
    if lib is None:
        return None
    row_of, in_blk, w_id = _entries(row_of, in_blk, w_id)
    nnz = row_of.shape[0]
    CH = ctypes.c_int32(0)
    padded = ctypes.c_int64(0)
    groups = lib.bs_supertile_schedule(
        nnz, _i32(row_of), _i32(in_blk), _i32(w_id), n_rows, V, R,
        ctypes.byref(CH), ctypes.byref(padded), None, None, None, None)
    if groups < 0:
        return None
    CH = CH.value
    rows = np.zeros((groups, CH), np.int32)
    in_idx, w_idx, w_valid = (np.zeros((groups, CH, V), np.int32)
                              for _ in range(3))
    lib.bs_supertile_schedule(
        nnz, _i32(row_of), _i32(in_blk), _i32(w_id), n_rows, V, R,
        None, None, _i32(rows), _i32(in_idx), _i32(w_idx), _i32(w_valid))
    return rows, in_idx, w_idx, w_valid, padded.value


def cluster_rows_native(row_of, in_blk, n_rows, n_cols, R):
    """The greedy union-minimising row permutation (int64), or None
    without the library."""
    lib = get_lib()
    if lib is None:
        return None
    row_of, in_blk = _entries(row_of, in_blk)
    perm = np.empty(n_rows, np.int32)
    rc = lib.bs_cluster_rows(row_of.shape[0], _i32(row_of), _i32(in_blk),
                             n_rows, n_cols, R, _i32(perm))
    if rc != 0:
        return None
    return perm.astype(np.int64)


def sample_batch(data: np.ndarray, offsets: np.ndarray, ctx: int):
    """Windows of ``ctx + 1`` bytes of a uint8 corpus at ``offsets``, as
    int32 (x, y) of shape (batch, ctx); None without the library.  The
    caller keeps each offset at most ``len(data) - ctx - 1``."""
    lib = get_lib()
    if lib is None:
        return None
    data = np.ascontiguousarray(data, np.uint8)
    offsets = np.ascontiguousarray(offsets, np.int64)
    if offsets.size and (offsets.min() < 0
                         or offsets.max() + ctx + 1 > data.shape[0]):
        raise ValueError("a window runs past the corpus")
    batch = offsets.shape[0]
    x = np.empty((batch, ctx), np.int32)
    y = np.empty((batch, ctx), np.int32)
    lib.bs_sample_batch(data.ctypes.data_as(_u8p), data.shape[0],
                        offsets.ctypes.data_as(_i64p), batch, ctx,
                        _i32(x), _i32(y))
    return x, y
