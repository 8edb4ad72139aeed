"""The port's loader of the host library ``csrc/bs_host.cpp``
(``blocksparse_tpu_torch/native.py``) against the JAX package's.

Each of the four entry points gives the JAX loader's arrays bit for bit,
and the schedule builders also the port's NumPy builders'
(``kernels/packed_order.py`` with ``native=False``), on layouts small
enough for those.  The library is built with g++ into
``build/blocksparse_tpu_torch/`` and rebuilt when its source is newer;
without it each entry point returns None.  The loader imports no JAX.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from blocksparse_tpu import native as jax_native
from blocksparse_tpu_torch import native
from blocksparse_tpu_torch.kernels import packed_order as po

ROOT = Path(__file__).resolve().parents[1]


def layout_rows(CB, KB, density, seed, empty=False):
    """A random layout's output rows: sorted (input row, block id)
    entries, ids in row-major order, and the flat (in, w, row) arrays."""
    rng = np.random.RandomState(seed)
    layout = (rng.rand(CB, KB) < density).astype(np.int32)
    layout[0, 0] = 1
    if empty:
        layout[:, KB // 3] = 0
    rows = [[] for _ in range(KB)]
    for w, (c, k) in enumerate(zip(*np.nonzero(layout))):
        rows[k].append((int(c), w))
    for r in rows:
        r.sort()
    flat = tuple(np.array(a, np.int32) for a in (
        [i for lut in rows for (i, _w) in lut],
        [w for lut in rows for (_i, w) in lut],
        [r for r, lut in enumerate(rows) for _ in lut]))
    return rows, flat


def same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert np.array_equal(np.asarray(x), np.asarray(y))


LAYOUTS = [(24, 20, 0.3, 1, False), (40, 33, 0.15, 2, True),
           (16, 64, 0.5, 3, False)]


@pytest.mark.parametrize("CB,KB,density,seed,empty", LAYOUTS)
@pytest.mark.parametrize("G,R", [(4, 2), (16, 8), (1, 3)])
def test_grouped_schedule_matches_jax_and_numpy(CB, KB, density, seed,
                                                 empty, G, R):
    rows, flat = layout_rows(CB, KB, density, seed, empty)
    got = native.grouped_schedule(flat[2], flat[0], flat[1], KB, G, R)
    same(got, jax_native.grouped_schedule(flat[2], flat[0], flat[1], KB, G,
                                          R))
    py = po.build_grouped_schedule(rows, KB, G, R, native=False)
    same(got, (py.rows, py.in_idx, py.w_idx, py.w_valid))


@pytest.mark.parametrize("CB,KB,density,seed,empty", LAYOUTS)
@pytest.mark.parametrize("bsize,R", [(32, 2), (16, 4), (64, 1)])
def test_supertile_schedule_matches_jax_and_numpy(CB, KB, density, seed,
                                                   empty, bsize, R):
    rows, flat = layout_rows(CB, KB, density, seed, empty)
    V = 128 // bsize
    got = native.supertile_schedule(flat[2], flat[0], flat[1], KB, V, R)
    same(got, jax_native.supertile_schedule(flat[2], flat[0], flat[1], KB,
                                            V, R))
    py, inflation = po.build_supertile_schedule(rows, KB, bsize, R,
                                                native=False)
    same(got[:4], (py.rows, py.in_idx, py.w_idx, py.w_valid))
    assert got[4] / len(flat[0]) == inflation


@pytest.mark.parametrize("CB,KB,density,seed,empty", LAYOUTS)
@pytest.mark.parametrize("R", [2, 4, 16])
def test_cluster_rows_matches_jax_and_numpy(CB, KB, density, seed, empty,
                                            R):
    rows, flat = layout_rows(CB, KB, density, seed, empty)
    got = native.cluster_rows_native(flat[2], flat[0], KB, CB, R)
    assert got.dtype == np.int64
    assert np.array_equal(got, jax_native.cluster_rows_native(
        flat[2], flat[0], KB, CB, R))
    assert np.array_equal(got, po.cluster_rows_py(rows, R, CB))
    assert np.array_equal(got, po.cluster_rows(rows, R))


def test_sample_batch_matches_jax_and_slicing():
    data = np.random.RandomState(0).randint(0, 256, 5000).astype(np.uint8)
    offsets = np.array([0, 17, 4000, 5000 - 65], np.int64)
    x, y = native.sample_batch(data, offsets, 64)
    jx, jy = jax_native.sample_batch(data, offsets, 64)
    assert x.dtype == np.int32 and np.array_equal(x, jx)
    assert np.array_equal(y, jy)
    for b, o in enumerate(offsets):
        assert np.array_equal(x[b], data[o:o + 64])
        assert np.array_equal(y[b], data[o + 1:o + 65])
    with pytest.raises(ValueError):            # past the corpus' end
        native.sample_batch(data, np.array([5000 - 64]), 64)


def test_library_builds_into_the_port_build_directory():
    assert native.available()
    assert native.LIBRARY == ROOT / "build" / "blocksparse_tpu_torch" / \
        "libbs_host.so"
    assert native.LIBRARY.stat().st_mtime >= \
        native.SOURCE.stat().st_mtime


def test_rebuilt_when_the_source_is_newer_and_none_without_it(
        tmp_path, monkeypatch):
    src = tmp_path / "bs_host.cpp"
    src.write_bytes(native.SOURCE.read_bytes())
    lib = tmp_path / "build" / "libbs_host.so"
    monkeypatch.setattr(native, "SOURCE", src)
    monkeypatch.setattr(native, "LIBRARY", lib)
    native.get_lib.cache_clear()
    try:
        assert native.available() and lib.exists()
        built = lib.stat().st_mtime_ns
        os.utime(src, ns=(built + 10**9, built + 10**9))   # edited later
        native.get_lib.cache_clear()
        assert native.available() and lib.stat().st_mtime_ns > built
        # a checkout without the source: every entry point returns None,
        # and the builders run their NumPy versions to the same arrays
        monkeypatch.setattr(native, "SOURCE", tmp_path / "missing.cpp")
        monkeypatch.setattr(native, "LIBRARY", tmp_path / "none.so")
        native.get_lib.cache_clear()
        assert not native.available()
        rows, flat = layout_rows(24, 20, 0.3, 1)
        assert native.grouped_schedule(flat[2], flat[0], flat[1], 20, 4,
                                       2) is None
        assert native.supertile_schedule(flat[2], flat[0], flat[1], 20, 4,
                                         2) is None
        assert native.cluster_rows_native(flat[2], flat[0], 20, 24,
                                          4) is None
        assert native.sample_batch(np.zeros(10, np.uint8), np.zeros(1),
                                   4) is None
        assert np.array_equal(po.cluster_rows(rows, 4),
                              jax_native.cluster_rows_native(
                                  flat[2], flat[0], 20, 24, 4))
    finally:
        native.get_lib.cache_clear()


def test_loader_imports_no_jax():
    code = ("import sys; import blocksparse_tpu_torch.native as n; "
            "import blocksparse_tpu_torch.kernels.packed_order; "
            "assert n.available(); "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'blocksparse_tpu')]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)
