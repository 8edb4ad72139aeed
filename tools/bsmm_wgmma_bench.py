"""The bf16/f16 block-sparse matmul kernels on wgmma against those on
mma.sync, on one CUDA card, alone: ``chip_smoke.py``'s block-size checks of
the xprop and updat kernels (every block size, bf16 and f16, all the
kernels, two runs bit-equal, the split route bit for bit against
``bsmm_partials`` + ``bsmm_merge``, the sparse xprop against the wgmma
one) and its wgmma phase (the kernels in turns at the main path's shapes
beside the bound and the library call, their registers and spills),
without the rest of the smoke run.  ``--updat``: the updat's checks and
turns alone (its three kernels).  ``--modes``: the fine and window modes'
checks and turns alone (``chip_smoke.py``'s ``mode_block_size_checks``:
the wgmma and mma.sync kernels at every block size; ``mode_wgmma_phase``:
the wgmma kernels in turns against the mma.sync ones, mode "grouped" and
a dense torch.matmul at the canonical rows and the window's regime, and
their registers, spills and shared memory).

    python tools/bsmm_wgmma_bench.py [--updat | --modes]   # repo root, a GPU

Exits 1 without a CUDA device, and on a failed check.
"""
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SOURCES = ("bsmm_xprop_wgmma", "bsmm_updat_wgmma", "bsmm_xprop_mma",
           "bsmm_updat_mma", "bsmm_merge", "bsmm_xprop_sparse",
           "bsmm_updat_sparse")
MODE_SOURCES = ("bsmm_window_wgmma", "bsmm_fine_wgmma", "bsmm_window_mma",
                "bsmm_fine_mma", "bsmm_xprop_mma", "bsmm_xprop_wgmma",
                "bsmm_xprop_sparse")


def main():
    if not torch.cuda.is_available():
        print("bsmm_wgmma_bench: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    import blocksparse_tpu_torch as bt

    dev = torch.device("cuda", 0)
    card_line = cs.card()
    print(f"card: {card_line}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)
    g = torch.Generator(device=dev).manual_seed(cs.SEED)
    if "--modes" in sys.argv[1:]:
        cs.build_all(MODE_SOURCES)
        try:
            cs.mode_block_size_checks(bt, dev, g)
            cs.mode_wgmma_phase(bt, dev, g, card_line, {})
        except cs.CheckFailed as e:
            print(f"FAILED: {e}", file=sys.stderr)
            return 1
        print(cs.card(), flush=True)
        return 0
    cs.build_all(SOURCES)
    model = bt.SparseTransformerLM(cs.flagship_config(bt), device=dev)
    updat_only = "--updat" in sys.argv[1:]
    try:
        cs.wgmma_ptxas_report()
        if not updat_only:
            cs.xprop_block_size_checks(bt, dev, g)
        cs.updat_block_size_checks(bt, dev, g)
        cs.wgmma_turns(bt, model, dev, g, card_line, {},
                       "u" if updat_only else "fbu")
    except cs.CheckFailed as e:
        print(f"FAILED: {e}", file=sys.stderr)
        return 1
    print(cs.card(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
