"""The README example: one block-sparse matmul.

The port of ``examples/simple.py``: a random 0/1 layout of 4096² at block
size 32, ``feature_axis=0``, a minibatch of 64 and identity weights; the
layout and x are drawn from NumPy's global generator in the JAX example's
order, so after one ``np.random.seed`` both print the same lines.

    python -m blocksparse_tpu_torch.examples.simple [--device cpu]

On the card (the default) the product runs the port's CUDA kernel; with
``--device cpu`` its plain version.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from blocksparse_tpu_torch import BlocksparseMatMul

HIDDEN_SIZE, BLOCK_SIZE, MINIBATCH_SIZE = 4096, 32, 64


def run(device):
    """(op, x, w, y) of the example on ``device``, after printing its two
    lines."""
    # a (random) sparsity pattern
    sparsity = np.random.randint(2, size=(HIDDEN_SIZE // BLOCK_SIZE,
                                          HIDDEN_SIZE // BLOCK_SIZE))
    bsmm = BlocksparseMatMul(sparsity, block_size=BLOCK_SIZE, feature_axis=0)
    x = torch.as_tensor(np.random.uniform(-1.0, 1.0,
                                          bsmm.i_shape(MINIBATCH_SIZE))
                        .astype(np.float32), device=device)
    w = torch.as_tensor(bsmm.identity_init()(None), device=device)
    y = bsmm(x, w)
    print("y shape:", tuple(y.shape), "blocks:", bsmm.blocks,
          "sparsity:", bsmm.sparsity)
    print("max |y - x| (identity init):", float((y - x).abs().max()))
    return bsmm, x, w, y


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (the card) or cpu")
    run(torch.device(p.parse_args(argv).device))
    return 0


if __name__ == "__main__":
    sys.exit(main())
