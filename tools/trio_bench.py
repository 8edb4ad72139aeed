"""Time the unfused attention's tensor-core kernels (``bst_nt``, ``bst_xn``
NN and TN) at the LM's check shape on the card, for one checkout of the
port.

    python3 tools/trio_bench.py [--root DIR] [--label NAME]

``--root`` is the root of the checkout whose ``blocksparse_tpu_torch`` is
timed (default: this one), so two commits compare in one run on one card:
unpack the other with ``git archive`` under ``build/`` and call this
script for each, in turns.  The check shape is batch 8, ctx 2048, block
64, the LM's fixed layout (312 of 1024 blocks, 8 local) and 2 heads of
256, bf16, q, k and v sliced from one packed qkv.  Each kernel's device
time is the mean of 20 calls captured as one CUDA graph and replayed
between CUDA events (a call's host work outlasts the kernel, so events
around eager calls time the host; that time is printed beside it); its
bound is the larger of its bytes (inputs read once, output written once)
over 3.35 TB/s and its operations over 989 TFLOP/s.  Prints one line a
kernel and a JSON line of the times.
"""
import argparse
import json
import os
import subprocess
import sys

import torch

BATCH, CTX, BLK, HEADS, HS, ITERS = 8, 2048, 64, 2, 256, 20
PEAK_FLOPS, PEAK_BYTES = 989e12, 3.35e12


def graph_ms(fn, iters=ITERS):
    """Device time of one fn() call: ``iters`` calls captured as one CUDA
    graph, its replay timed by CUDA events, over iters.  A call's host
    work (the op's checks and the ctypes launch) takes longer than these
    kernels run, so timing the calls themselves would time the host."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_ms(fn, iters=ITERS):
    """The same calls enqueued one by one, timed by CUDA events: what a
    caller outside a graph waits."""
    for _ in range(2):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--label", default="this checkout")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("trio_bench: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.root))
    import blocksparse_tpu_torch as bt
    from blocksparse_tpu_torch.models.sparse_transformer import (
        causal_subblock_mask, fixed_layout)

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    op = bt.BlocksparseTransformer(fixed_layout(CTX // BLK, local_blocks=8),
                                   block_size=BLK, heads=HEADS,
                                   mask_callback=causal_subblock_mask)
    g = torch.Generator(device=dev).manual_seed(0)
    qkv = torch.randn((BATCH, CTX, 3 * HEADS * HS), device=dev,
                      generator=g).to(torch.bfloat16)
    q, k, v = qkv.split(HEADS * HS, dim=-1)
    w = (torch.randn((BATCH, HEADS, op.blocks, BLK, BLK), device=dev,
                     generator=g) * 0.1).to(torch.bfloat16)
    fns = {"bst_nt": lambda: op.nt_op(q, k),
           "bst_xn": lambda: op.nn_op(w, v),
           "bst_xn_tn": lambda: op.tn_op(w, q)}
    with torch.no_grad():
        for fn in fns.values():
            fn()
        torch.cuda.synchronize()
        times = {name: graph_ms(fn) for name, fn in fns.items()}
        eager = {name: host_ms(fn) for name, fn in fns.items()}
    nbytes = (w.numel() + 2 * BATCH * CTX * HEADS * HS) * 2
    flops = 2 * w.numel() * HS
    bound = max(nbytes / PEAK_BYTES, flops / PEAK_FLOPS) * 1e3
    for name, ms in times.items():
        print(f"{args.label}: {name} {ms:.4f} ms of device time, "
              f"{bound / ms:.0%} of the bound {bound:.4f} ms (bytes); "
              f"{eager[name]:.4f} ms a call enqueued eagerly [{card}]",
              flush=True)
    print(json.dumps({"label": args.label, "card": card, "ms": times,
                      "eager_ms": eager, "bound_ms": bound}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
