"""Embedding lookup: counterpart of ``blocksparse_tpu/ops/embed.py``.
Plain PyTorch; the gradient is autograd's (``index_select``'s backward,
which on CUDA sums rows with atomics, in no fixed order)."""
from __future__ import annotations


def embedding_lookup(emb, idx):
    """Rows of ``emb`` (vocab, d) at integer ``idx`` of any shape ->
    idx.shape + (d,)."""
    return emb.index_select(0, idx.reshape(-1)).reshape(*idx.shape,
                                                         emb.shape[1])
