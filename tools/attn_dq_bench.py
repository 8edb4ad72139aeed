"""The bf16/f16 attention kernels on wgmma against those on mma.sync, on
one CUDA card, alone: ``chip_smoke.py``'s attention checks at the train
step's shape (the forward with lse, dq in both epilogues and dk/dv on the
route's kernels and on the mma.sync ones, against the plain versions, two
runs bit-equal, device time in turns), its attention report (TFLOP/s, a
call's host time, each wgmma instantiation's registers, local bytes and
shared memory, what ptxas warned of), its wgmma phase (the pipeline's
microbatch, an sp-4 gather shard and ring pair, 4 heads of 128, a ring
pair whose rows see no key) and its checks at every block and head size
the op takes, without the rest of the smoke run.

    python tools/attn_dq_bench.py          # from the repo root, one GPU

Exits 1 without a CUDA device, and on a failed check.
"""
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SOURCES = ("bst_attn_dq_wgmma", "bst_attn_bwd_mma", "bst_attn_fwd_wgmma",
           "bst_attn_dkv_wgmma", "bst_attn_fwd_mma", "bst_attn_fwd",
           "bst_attn_bwd")


def main():
    if not torch.cuda.is_available():
        print("attn_dq_bench: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    import blocksparse_tpu_torch as bt

    dev = torch.device("cuda", 0)
    card_line = cs.card()
    print(f"card: {card_line}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)
    cs.build_all(SOURCES)
    model = bt.SparseTransformerLM(cs.flagship_config(bt), device=dev)
    g = torch.Generator(device=dev).manual_seed(cs.SEED)
    rows = {}
    try:
        cs.attn_training_checks(model, dev, g, rows)
        cs.attn_report(model, rows, card_line)
        cs.attn_wgmma_phase(bt, model, dev, g, card_line, rows)
        cs.attn_block_size_checks(bt, dev, g)
    except cs.CheckFailed as e:
        print(f"FAILED: {e}", file=sys.stderr)
        return 1
    print(cs.card(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
