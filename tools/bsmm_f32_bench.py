"""Time and check the f32 block-sparse matmul kernels (``csrc/bsmm_fprop.cu``:
fprop, bprop, the split route's partials; ``csrc/bsmm_updat.cu``) at the
shapes of the MoE LM's experts and of the sparse LSTM, on one card, against
an earlier version of the two sources.

    python3 tools/bsmm_f32_bench.py [--parent-src DIR] [--out PATH]

``--parent-src`` is a directory holding another version of
``bsmm_fprop.cu`` and ``bsmm_updat.cu`` with the C interface they had
before their column groups and plans (``bsmm_xprop_nc(dtype, bsize,
trans_w, x, w, row_ptr, ent_in, ent_w, y, N, C, K, stream)``, its
``_partials`` twin, ``bsmm_updat_nc(dtype, bsize, x, dy, ent_c, ent_k,
dw, N, C, K, blocks, stream)``), e.g. written by ``git show
<commit>:blocksparse_tpu_torch/csrc/bsmm_fprop.cu``.  They are built with
nvcc into ``build/parent_f32/`` and each product of this checkout's
kernels is held bit for bit against theirs on the same inputs.

The shapes: the MoE LM's expert products at N = C = 2,560 (8 experts'
capacity at batch 8 x 2048; bsmm1 512 -> 2048 and bsmm2 2048 -> 512, dense
b32, 1,024 blocks), fprop and bprop of both and bsmm2's updat; the sparse
LSTM's gate product (``LSTMConfig``'s defaults: C 1120 -> K 4480, the
``ba_10`` layout tiled over the four gates, 2,428 b32 blocks) at N 128:
fprop, bprop's partials over the split plan's tiles (the route the op
takes there), updat; and the bprop's two routes there, unsplit (this
checkout's kernel over the columns in each configuration) against the
split route (partials + ``bsmm_merge``), in turns.  Each kernel's device
time is the mean of 20 calls captured as one CUDA graph and replayed
between CUDA events (L2 warm: the same inputs each call); this checkout's
xprop in both configurations it is built for (``xprop_f32_tiles``: full
column groups, one column a thread block), the one ``xprop_tile`` picks
marked; the parent and this checkout in turns (parent, new, new, parent);
beside each, a dense f32 ``torch.matmul`` of the same function (the layout
scattered into a dense weight) and the bound (f32 operations at 67
TFLOP/s).  Prints a line each and writes the numbers as JSON to ``--out``
(default ``build/bsmm_f32_bench.json``).  Imports no JAX.
"""
import argparse
import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from blocksparse_tpu_torch import BlocksparseMatMul, LSTMConfig, SparseLSTM  # noqa: E402
from blocksparse_tpu_torch.kernels import _build  # noqa: E402
from blocksparse_tpu_torch.kernels import bsmm as bk  # noqa: E402

ITERS = 20
PEAK_F32 = 67e12
MOE_N, LSTM_N = 2560, 128
P, I = ctypes.c_void_p, ctypes.c_int


def card():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
        check=True).stdout.strip().splitlines()[0]


def graph_ms(fn, iters=ITERS):
    """Device time of one fn() call: iters calls captured as one CUDA graph,
    its replay between CUDA events, over iters."""
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


def build_parent(src):
    """The parent's two sources built into build/parent_f32, loaded."""
    out = ROOT / "build" / "parent_f32"
    out.mkdir(parents=True, exist_ok=True)
    libs = {}
    procs = {}
    for name in ("bsmm_fprop", "bsmm_updat"):
        lib = out / f"lib{name}.so"
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
             str(Path(src) / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for the parent's {name}.cu:\n{log}")
        libs[name] = ctypes.CDLL(str(out / f"lib{name}.so"))
    x = libs["bsmm_fprop"]
    for fn in (x.bsmm_xprop_nc, x.bsmm_xprop_nc_partials):
        fn.argtypes = [I, I, I, P, P, P, P, P, P, I, I, I, P]
        fn.restype = I
    u = libs["bsmm_updat"].bsmm_updat_nc
    u.argtypes = [I, I, P, P, P, P, P, I, I, I, I, P]
    u.restype = I
    return libs


def stream():
    return torch.cuda.current_stream().cuda_stream


def parent_xprop(libs, partial, x, w, row_ptr, ent_in, ent_w, bsize, n_out,
                 trans):
    y = torch.empty((x.shape[0], n_out * bsize), device=x.device)
    fn = libs["bsmm_fprop"].bsmm_xprop_nc_partials if partial \
        else libs["bsmm_fprop"].bsmm_xprop_nc
    err = fn(0, bsize, int(trans), x.data_ptr(), w.data_ptr(),
             row_ptr.data_ptr(), ent_in.data_ptr(), ent_w.data_ptr(),
             y.data_ptr(), x.shape[0], x.shape[1], n_out * bsize, stream())
    assert err == 0, err
    return y


def parent_updat(libs, x, dy, ent_c, ent_k, bsize):
    dw = torch.empty((ent_c.numel(), bsize, bsize), device=x.device)
    err = libs["bsmm_updat"].bsmm_updat_nc(
        0, bsize, x.data_ptr(), dy.data_ptr(), ent_c.data_ptr(),
        ent_k.data_ptr(), dw.data_ptr(), x.shape[0], x.shape[1], dy.shape[1],
        ent_c.numel(), stream())
    assert err == 0, err
    return dw


def dense_weight(op, w):
    wd = torch.zeros((op.C, op.K), device=w.device)
    b = op.bsize
    for i, (c, k) in enumerate(op.updat_lut):
        wd[c * b:(c + 1) * b, k * b:(k + 1) * b] = w[i]
    return wd


def xprop_info(bsize, trans, gn, tm):
    out = (ctypes.c_int * 5)()
    fn = _build.function("bsmm_fprop", "bsmm_xprop_nc_info", [I, I, I, I, P])
    assert fn(bsize, int(trans), gn, tm, ctypes.cast(out, P)) == 0
    return dict(zip(("threads", "smem", "regs", "local", "resident"), out))


def updat_info(bsize, by_c):
    out = (ctypes.c_int * 5)()
    fn = _build.function("bsmm_updat", "bsmm_updat_nc_info", [I, I, P])
    assert fn(bsize, int(by_c), ctypes.cast(out, P)) == 0
    return dict(zip(("threads", "smem", "regs", "local", "resident"), out))


def xprop_case(res, libs, label, op, d, N, dev, g, sms, partial=False):
    """One xprop direction: this checkout's kernel in each configuration
    against the parent's bit for bit, timed beside the parent and a dense
    torch.matmul."""
    b, trans = op.bsize, d == "b"
    lut = op._lut(dev)
    n_in = op.CB if d == "f" else op.KB
    x = torch.randn((N, n_in * b), device=dev, generator=g)
    w = torch.randn(op.w_shape, device=dev, generator=g) * 0.05
    phases = op._phases(N, d, sms) if partial else 0
    if partial:
        split = op._plan_tensors(dev, "split", d, phases)
        ptr, n_out = split["tile_ptr"], split["tile_ptr"].numel() - 1
        kernel = bk.bsmm_partials
    else:
        ptr, n_out = lut[f"{d}_row_ptr"], op.KB if d == "f" else op.CB
        kernel = bk.bsmm_bprop if trans else bk.bsmm_fprop
    plan = op._plan_tensors(dev, "xgroup", d, phases)
    ents = (lut[f"{d}_ent_in"], lut[f"{d}_ent_w"])

    def new(tile):
        launch = bk.xprop_launch(plan, tile)
        if partial:
            return kernel(x, w, ptr, *ents, b, n_out, trans, plan=launch)
        return kernel(x, w, ptr, *ents, b, n_out, plan=launch)

    def old():
        return parent_xprop(libs, partial, x, w, ptr, *ents, b, n_out, trans)

    picked = bk.xprop_tile(N, b, plan, sms)
    ref = old()
    flops = 2 * N * int(ents[0].numel()) * b * b
    wd = dense_weight(op, w)
    lib = graph_ms(lambda: x @ (wd.t() if trans else wd))
    row = {"N": N, "bsize": b, "blocks": op.blocks, "gn": plan["gn"],
           "groups": plan["grp_col"].shape[0], "tile_rule": picked,
           "bound_ms": flops / PEAK_F32 * 1e3, "dense_matmul_ms": lib,
           "tiles": {}}
    for tile in bk.xprop_f32_tiles(b):
        if tile[0] > 1 and plan["gn"] != tile[0]:
            continue
        info = xprop_info(b, trans, *tile)
        y = new(tile)
        same = torch.equal(y, ref) and torch.equal(new(tile), y)
        ms = graph_ms(lambda: new(tile))
        row["tiles"][f"gn {tile[0]} TM {tile[1]}"] = {
            "ms": ms, "bit_equal": same, **info}
        print(f"{label}: gn {tile[0]} TM {tile[1]}"
              f"{' (rule)' if tile == picked else ''}: {ms:.4f} ms "
              f"({flops / ms / 1e9:.1f} TFLOP/s), bit for bit the parent's "
              f"{same}; {info}", flush=True)
    turns = {"parent": [], "new": []}
    for k in ("parent", "new", "new", "parent"):
        turns[k].append(graph_ms(old if k == "parent" else
                                 (lambda: new(picked))))
    row["turns"] = turns
    print(f"{label}: in turns parent {turns['parent']} new {turns['new']} ms; "
          f"bound {row['bound_ms']:.4f}; dense f32 torch.matmul {lib:.4f}",
          flush=True)
    res[label] = row


def route_case(res, label, op, d, N, dev, g, sms):
    """Direction d's two routes at N rows in f32: the unsplit kernel over
    the columns in each configuration against the split route (partials +
    bsmm_merge over the split rule's runs), in turns (split, unsplit,
    unsplit, split), device time."""
    b, trans = op.bsize, d == "b"
    lut = op._lut(dev)
    x = torch.randn((N, (op.CB if d == "f" else op.KB) * b), device=dev,
                    generator=g)
    w = torch.randn(op.w_shape, device=dev, generator=g) * 0.05
    ents = (lut[f"{d}_ent_in"], lut[f"{d}_ent_w"])
    phases = op._phases(N, d, sms)
    split = op._plan_tensors(dev, "split", d, phases)
    kernel = bk.bsmm_bprop if trans else bk.bsmm_fprop
    n_out = op.KB if d == "f" else op.CB
    plan = op._plan_tensors(dev, "xgroup", d)

    def unsplit(tile):
        return kernel(x, w, lut[f"{d}_row_ptr"], *ents, b, n_out,
                      plan=bk.xprop_launch(plan, tile))

    def split_route():
        return bk.bsmm_merge(bk.bsmm_partials(
            x, w, split["tile_ptr"], *ents, b,
            split["tile_ptr"].numel() - 1, trans,
            plan=op._xlaunch(dev, d, N, phases)), split["merge_idx"], b,
            torch.float32)
    row = {"N": N, "phases": phases, "unsplit": {}}
    for tile in bk.xprop_f32_tiles(b):
        if tile[0] > 1 and plan["gn"] != tile[0]:
            continue
        turns = {"split": [], "unsplit": []}
        for k in ("split", "unsplit", "unsplit", "split"):
            turns[k].append(graph_ms(split_route if k == "split" else
                                     (lambda: unsplit(tile))))
        row["unsplit"][f"gn {tile[0]} TM {tile[1]}"] = turns
        print(f"{label}: split route ({phases} runs, partials + merge) "
              f"{turns['split']} ms; unsplit gn {tile[0]} TM {tile[1]} "
              f"{turns['unsplit']} ms (in turns)", flush=True)
    res[label] = row


def updat_case(res, libs, label, op, N, dev, g):
    b = op.bsize
    lut = op._lut(dev)
    plan = op._plan_tensors(dev, "updat", "u")
    x = torch.randn((N, op.C), device=dev, generator=g)
    dy = torch.randn((N, op.K), device=dev, generator=g)

    def new():
        return bk.bsmm_updat(x, dy, lut["u_c32"], lut["u_k32"], b, plan)

    def old():
        return parent_updat(libs, x, dy, lut["u_c32"], lut["u_k32"], b)
    dw, ref = new(), old()
    same = torch.equal(dw, ref) and torch.equal(new(), dw)
    flops = 2 * N * op.blocks * b * b
    lib = graph_ms(lambda: x.t() @ dy)
    turns = {"parent": [], "new": []}
    for k in ("parent", "new", "new", "parent"):
        turns[k].append(graph_ms(old if k == "parent" else new))
    info = updat_info(b, plan["by_c"])
    res[label] = {"N": N, "bsize": b, "blocks": op.blocks,
                  "groups": plan["grp_q"].numel(), "by_c": plan["by_c"],
                  "bit_equal": same, "turns": turns, **info,
                  "bound_ms": flops / PEAK_F32 * 1e3, "dense_matmul_ms": lib}
    print(f"{label}: {plan['grp_q'].numel()} groups by "
          f"{'x' if plan['by_c'] else 'dy'}; in turns parent "
          f"{turns['parent']} new {turns['new']} ms; bit for bit the "
          f"parent's {same}; bound {flops / PEAK_F32 * 1e3:.4f}; dense f32 "
          f"torch.matmul (x^T dy) {lib:.4f}; {info}", flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent-src", default=str(ROOT / "build" / "parent_src"))
    ap.add_argument("--out", default=str(ROOT / "build" /
                                         "bsmm_f32_bench.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("bsmm_f32_bench.py needs a CUDA card")
    dev = torch.device("cuda")
    line = card()
    print(line, flush=True)
    libs = build_parent(args.parent_src)
    for name in ("bsmm_fprop", "bsmm_updat"):
        _build.load(name)
    g = torch.Generator(device=dev).manual_seed(0)
    sms = bk.device_sm_count(dev)
    res = {"card": line}
    moe1 = BlocksparseMatMul(np.ones((16, 64), np.int32), block_size=32,
                             feature_axis=1)
    moe2 = BlocksparseMatMul(np.ones((64, 16), np.int32), block_size=32,
                             feature_axis=1)
    lstm = SparseLSTM(LSTMConfig(isteps=5), device="cpu").bsmm_h
    with torch.no_grad():
        xprop_case(res, libs, "MoE bsmm1 fprop", moe1, "f", MOE_N, dev, g, sms)
        xprop_case(res, libs, "MoE bsmm1 bprop", moe1, "b", MOE_N, dev, g, sms)
        xprop_case(res, libs, "MoE bsmm2 fprop", moe2, "f", MOE_N, dev, g, sms)
        xprop_case(res, libs, "MoE bsmm2 bprop", moe2, "b", MOE_N, dev, g, sms)
        updat_case(res, libs, "MoE bsmm2 updat", moe2, MOE_N, dev, g)
        xprop_case(res, libs, "LSTM fprop", lstm, "f", LSTM_N, dev, g, sms)
        xprop_case(res, libs, "LSTM bprop partials", lstm, "b", LSTM_N, dev,
                   g, sms, partial=True)
        route_case(res, "LSTM bprop routes", lstm, "b", LSTM_N, dev, g, sms)
        updat_case(res, libs, "LSTM updat", lstm, LSTM_N, dev, g)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1)
    ok = all(r.get("bit_equal", True) and all(
        t.get("bit_equal", False) for t in r.get("tiles", {}).values())
        for r in res.values() if isinstance(r, dict))
    print(json.dumps({"bit_equal_everywhere": ok, "card": line}))
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
