"""Sparsity layouts, masks and structure tools in one place.

Counterpart of ``blocksparse_tpu/sparsity.py``: the attention patterns
(fixed, strided, dense causal; the conv-emulating layouts of ``utils``),
the weight patterns (Barabasi-Albert and Watts-Strogatz graphs of
``make_mask``, random block layouts), the causal sub-block mask and
``layout_stats``.  NumPy over a ``RandomState``: the same seed gives the
JAX package's layout bit for bit; ``coarsen_layout`` lifts a fine layout
to larger blocks.
"""
from __future__ import annotations

import numpy as np

from blocksparse_tpu_torch.models.sparse_lstm import make_mask  # noqa: F401
from blocksparse_tpu_torch.ops.matmul import coarsen_layout  # noqa: F401
from blocksparse_tpu_torch.models.sparse_transformer import (  # noqa: F401
    causal_subblock_mask, dense_causal_layout, fixed_layout, strided_layout)
from blocksparse_tpu_torch.utils import (  # noqa: F401
    bst_conv_layout, bst_deconv_layout)


def random_layout(CB, KB, density=0.25, seed=0, ensure_diagonal=True):
    """Random 0/1 block layout (CB, KB) int32 from ``RandomState(seed)``;
    with ``ensure_diagonal`` no row or column is empty."""
    rng = np.random.RandomState(seed)
    layout = (rng.rand(CB, KB) < density).astype(np.int32)
    if ensure_diagonal:
        idx = np.arange(min(CB, KB))
        layout[idx, idx % KB] = 1
        layout[idx % CB, idx] = 1
    return layout


def layout_stats(layout):
    """Structure report: density, row and column degree spread, and the
    fill of 128-wide supertiles at block sizes 8-64."""
    layout = (np.asarray(layout) != 0).astype(np.int32)
    CB, KB = layout.shape
    rows = layout.sum(axis=0)
    cols = layout.sum(axis=1)
    out = {
        "shape": (CB, KB),
        "blocks": int(layout.sum()),
        "density": float(layout.mean()),
        "row_degree_min_max": (int(rows.min()), int(rows.max())),
        "col_degree_min_max": (int(cols.min()), int(cols.max())),
    }
    for b in (8, 16, 32, 64):
        V = 128 // b
        CBp = -(-CB // V) * V
        KBp = -(-KB // V) * V
        pad = np.zeros((CBp, KBp), np.int32)
        pad[:CB, :KB] = layout
        coarse = pad.reshape(CBp // V, V, KBp // V, V)
        present = coarse.max(axis=(1, 3)).sum()
        out[f"supertile128_fill_b{b}"] = (
            float(layout.sum() / max(present * V * V, 1)))
    return out
