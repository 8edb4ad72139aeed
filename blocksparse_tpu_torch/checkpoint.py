"""Checkpoint and resume.

Counterpart of ``blocksparse_tpu/checkpoint.py``, with its signatures: a
checkpoint is a directory holding the arrays (params, optimizer state,
EMA state, loss scale) and a metadata sidecar (step, layouts, config), so
a run resumes exactly, sparsity structure included.  The arrays go
through ``torch.save`` (``arrays.pt``; every tensor moved to the CPU,
each keeping its dtype and bits, packed16 uint16 slots included), the
metadata through pickle (``meta.pkl``, the JAX package's keys).
"""
from __future__ import annotations

import os
import pickle

import torch


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    return tree


def save(path, params, opt_state=None, ema_state=None, step=0,
         loss_scale=None, layouts=None, config=None):
    """Write a checkpoint directory at ``path``.

    params, opt_state, ema_state: dicts of tensors (``state_dict()``, the
    optimizers' states); loss_scale a float or a 0-d tensor; layouts:
    dict name -> 0/1 NumPy layout (the structure that rebuilds the
    block-sparse ops); config: anything picklable."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    tree = {"params": params}
    if opt_state is not None:
        tree["opt_state"] = opt_state
    if ema_state is not None:
        tree["ema_state"] = ema_state
    if loss_scale is not None:
        tree["loss_scale"] = loss_scale
    torch.save(_to_cpu(tree), os.path.join(path, "arrays.pt"))
    meta = {"step": int(step), "layouts": layouts or {}, "config": config}
    with open(os.path.join(path, "meta.pkl"), "wb") as f:
        pickle.dump(meta, f)


def restore(path, device=None):
    """Returns (tree, meta): tree has params/opt_state/ema_state/
    loss_scale as saved (on ``device``, default the CPU); meta has
    step/layouts/config.  Reads only a checkpoint this package wrote: the
    metadata is unpickled."""
    path = os.path.abspath(path)
    tree = torch.load(os.path.join(path, "arrays.pt"),
                      map_location=device or "cpu", weights_only=True)
    with open(os.path.join(path, "meta.pkl"), "rb") as f:
        meta = pickle.load(f)
    return tree, meta
