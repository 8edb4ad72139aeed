"""Embedding lookup: counterpart of ``blocksparse_tpu/ops/embed.py``.

Plain PyTorch, as the JAX package leaves it to XLA.  The gradient has the
reference's sorted-grad semantics on every device: the ids are sorted
stably and each id's rows are summed in that fixed order (f32, rounded
once to the incoming gradient's dtype), so two backward runs give the
same bits.  ``index_select``'s own backward would sum them with atomics
on CUDA, in no fixed order.
"""
from __future__ import annotations

import torch


def embedding_lookup(emb, idx, sort_grad=True, bench=0, use_tf=False):
    """Rows of ``emb`` (vocab, d) at integer ``idx`` of any shape ->
    idx.shape + (d,).  ``sort_grad``, ``bench`` and ``use_tf`` are the
    reference's knobs, accepted and ignored: the gradient is always the
    sorted, deterministic one."""
    return _EmbeddingLookup.apply(emb, idx)


def convert_gradient_to_tensor(x):
    """Returns its input: autograd's gradients are dense tensors already
    (the reference turned TF's sparse IndexedSlices into one)."""
    return x


class _EmbeddingLookup(torch.autograd.Function):

    @staticmethod
    def forward(ctx, emb, idx):
        flat = idx.reshape(-1).long()
        ctx.save_for_backward(flat)
        ctx.vocab = emb.shape[0]
        return emb.index_select(0, flat).reshape(*idx.shape, emb.shape[1])

    @staticmethod
    def backward(ctx, dy):
        flat, = ctx.saved_tensors
        ids, order = torch.sort(flat, stable=True)
        rows = dy.reshape(-1, dy.shape[-1])[order].float()
        grad = torch.zeros((ctx.vocab, dy.shape[-1]), dtype=torch.float32,
                           device=dy.device)
        # sorted ids: a segment sum, each id's rows added in their order
        grad.index_put_((ids,), rows, accumulate=True)
        return grad.to(dy.dtype), None
