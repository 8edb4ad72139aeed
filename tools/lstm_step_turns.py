"""Time the sparse LSTM's entry-point step, and the host time of its three
f32 block-sparse calls, for two or more checkouts in alternating turns on
one card.

    python3 tools/lstm_step_turns.py ROOT [ROOT ...] [--labels A B ...]
        [--rounds 2] [--steps 6] [--calls 200] [--reps 9] [--profile N]
        [--out PATH]

Each ROOT is a checkout of the repo: this one (``.``) or another commit
unpacked with ``git archive <commit> | tar -x -C build/parent``.  A turn is
one child process that imports ``blocksparse_tpu_torch`` from its ROOT
(kernels built there first, all ROOTs at once, before any turn) and
measures, at ``examples/lstm_train.py``'s full width (isteps 5, batch 128,
f32):

- the host's ms a call of the gate product's fprop ``op._xprop(x, w,
  "f")``, bprop ``op._xprop(dy, w, "b")`` (the split route: partials and
  merge) and updat ``op._updat(x, dy)`` (``SparseLSTM.bsmm_h``, C 1120 ->
  K 4480, N 128): ``--reps`` runs of ``--calls`` calls each between two
  syncs, each run's time over ``--calls`` by the host clock and by the
  calling thread's CPU time (``time.thread_time``), the least of each
  and the median CPU time (the card outpaces the host at this shape, so
  the queue never fills; the CPU time leaves out the time the thread
  waits for a core, which the machine's other tenants vary);
- ms a step of the entry point's step after a warm-up step, each of
  ``--steps`` and their median: by the host clock, synchronized, and the
  thread's CPU time to issue the step (up to the sync).

With ``--profile N`` each turn also runs N calls of each of the three
under ``cProfile`` and keeps the functions that took the most of their
own time (us a call of the op); the first turn of each checkout prints
them.

The turns run in ABBA order, ``--rounds`` times (A B B A A B B A for two
ROOTs and two rounds), so a drift of the host linear in time cancels in
each checkout's mean; each pair of turns (A B B A) also gives its own
estimate of B - A.  Prints a line a turn and a summary of means and
medians; writes all of it as JSON to ``--out`` (default
``build/lstm_step_turns.json``).  Imports no JAX.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

SOURCES = ("bsmm_fprop", "bsmm_updat", "bsmm_merge")
BATCH, ISTEPS = 128, 5


def profiled(fn, calls, top=14):
    """[(function, calls of it per op call, own us per op call)] of the
    ``top`` functions by own time over ``calls`` calls of fn."""
    import cProfile
    import pstats
    prof = cProfile.Profile()
    prof.enable()
    for _ in range(calls):
        fn()
    prof.disable()
    stats = pstats.Stats(prof).stats
    rows = sorted(((f"{Path(f).name}:{line}({name})", cc / calls,
                    tt * 1e6 / calls)
                   for (f, line, name), (cc, _, tt, _, _) in stats.items()),
                  key=lambda r: -r[2])
    return rows[:top]


def child(root, mode, steps, calls, reps, profile=0):
    """One turn in this process: the package from ``root``."""
    sys.path.insert(0, str(root))
    import numpy as np
    import torch
    import blocksparse_tpu_torch as bt
    from blocksparse_tpu_torch.examples import lstm_train
    from blocksparse_tpu_torch.kernels import _build
    assert Path(bt.__file__).resolve().is_relative_to(Path(root).resolve())
    if mode == "build":
        with ThreadPoolExecutor(len(SOURCES)) as pool:
            list(pool.map(_build.build, SOURCES))
        return {}
    dev = torch.device("cuda")
    args = lstm_train.parse_args(["--isteps", str(ISTEPS), "--batch",
                                  str(BATCH)])
    model, optm, ema, state, ema_state, _ = lstm_train.build(args)
    nsteps = args.nsteps
    step = lstm_train.make_step(model, optm, ema)
    train, _ = lstm_train.load_data(None, nsteps, BATCH)
    rng = np.random.RandomState(1)
    batches = [tuple(torch.from_numpy(a).long().to(dev) for a in
                     lstm_train.get_batch(train, rng, BATCH, nsteps))
               for _ in range(steps + 1)]

    op = model.bsmm_h
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(op.i_shape(BATCH), device=dev, generator=g)
    dy = torch.randn(op.o_shape(BATCH), device=dev, generator=g)
    w = torch.randn(op.w_shape, device=dev, generator=g) * 0.05
    calls_of = {"fprop": lambda: op._xprop(x, w, "f"),
                "bprop": lambda: op._xprop(dy, w, "b"),
                "updat": lambda: op._updat(x, dy)}
    host = {}
    with torch.no_grad():
        for name, fn in calls_of.items():
            fn()
            wall, cpu = [], []
            for _ in range(reps):
                torch.cuda.synchronize()
                t0, c0 = time.perf_counter(), time.thread_time()
                for _ in range(calls):
                    fn()
                cpu.append((time.thread_time() - c0) * 1e3 / calls)
                wall.append((time.perf_counter() - t0) * 1e3 / calls)
            torch.cuda.synchronize()
            host[name] = {"min": min(wall), "cpu_min": min(cpu),
                          "cpu_median": statistics.median(cpu)}
            if profile:
                host[name]["profile"] = profiled(fn, profile)
                torch.cuda.synchronize()

    state, ema_state, _, _ = step(state, ema_state, *batches[0])
    torch.cuda.synchronize()
    step_ms, step_cpu_ms = [], []
    for xb, yb in batches[1:]:
        t0, c0 = time.perf_counter(), time.thread_time()
        state, ema_state, loss, _ = step(state, ema_state, xb, yb)
        step_cpu_ms.append((time.thread_time() - c0) * 1e3)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    return {"host_ms_a_call": host, "step_ms": step_ms,
            "step_median_ms": statistics.median(step_ms),
            "step_cpu_ms": step_cpu_ms,
            "step_cpu_median_ms": statistics.median(step_cpu_ms),
            "loss": float(loss)}


def run_child(root, mode, steps=0, calls=0, reps=0, profile=0):
    out = subprocess.run(
        [sys.executable, __file__, "--child", str(root), "--mode", mode,
         "--steps", str(steps), "--calls", str(calls), "--reps", str(reps),
         "--profile", str(profile)],
        capture_output=True, text=True)
    if out.returncode:
        raise RuntimeError(f"turn in {root} ({mode}) failed:\n{out.stdout}"
                           f"\n{out.stderr[-4000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def card():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
        check=True).stdout.strip().splitlines()[0]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("roots", nargs="*")
    ap.add_argument("--labels", nargs="*")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--calls", type=int, default=200)
    ap.add_argument("--reps", type=int, default=9)
    ap.add_argument("--profile", type=int, default=0)
    ap.add_argument("--out", default=str(Path(__file__).resolve().parents[1]
                                         / "build"
                                         / "lstm_step_turns.json"))
    ap.add_argument("--child")
    ap.add_argument("--mode", default="time")
    a = ap.parse_args()
    if a.child:
        print(json.dumps(child(a.child, a.mode, a.steps, a.calls, a.reps,
                               a.profile)))
        return
    import torch
    if not torch.cuda.is_available():
        sys.exit("lstm_step_turns.py needs a CUDA card")
    if not a.roots:
        sys.exit("give at least one ROOT")
    labels = a.labels or a.roots
    line = card()
    print(line, flush=True)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(a.roots)) as pool:
        list(pool.map(lambda r: run_child(r, "build"), a.roots))
    print(f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    pairs = list(zip(labels, a.roots))
    order = []
    for _ in range(a.rounds):
        order += pairs + pairs[::-1]
    turns = []
    for label, root in order:
        r = run_child(root, "time", a.steps, a.calls, a.reps, a.profile)
        r["label"] = label
        turns.append(r)
        h = r["host_ms_a_call"]
        if a.profile and sum(t["label"] == label for t in turns) == 1:
            for k, v in h.items():
                print(f"{label}: {k} under cProfile, own us an op call: "
                      + "; ".join(f"{f} x{n:g} {us:.2f}"
                                  for f, n, us in v["profile"]), flush=True)
        print(f"{label}: host ms a call ({a.reps} runs: least by the clock, "
              f"least / median CPU): " + ", ".join(
                  f"{k} {v['min']:.4f}, {v['cpu_min']:.4f} / "
                  f"{v['cpu_median']:.4f}" for k, v in h.items())
              + "; step ms " + ", ".join(f"{m:.1f}" for m in r["step_ms"])
              + f" (median {r['step_median_ms']:.1f}), CPU ms to issue "
              + ", ".join(f"{m:.1f}" for m in r["step_cpu_ms"])
              + f" (median {r['step_cpu_median_ms']:.1f})", flush=True)
    summary = {}
    for label in labels:
        mine = [t for t in turns if t["label"] == label]
        summary[label] = {
            "host_ms_a_call_least_mean": {
                k: statistics.mean(t["host_ms_a_call"][k]["min"]
                                   for t in mine)
                for k in ("fprop", "bprop", "updat")},
            "cpu_ms_a_call_least_mean": {
                k: statistics.mean(t["host_ms_a_call"][k]["cpu_min"]
                                   for t in mine)
                for k in ("fprop", "bprop", "updat")},
            "step_cpu_ms_mean_of_medians": statistics.mean(
                t["step_cpu_median_ms"] for t in mine),
            "step_median_ms_by_turn": [t["step_median_ms"] for t in mine],
            "step_ms_mean_of_medians": statistics.mean(
                t["step_median_ms"] for t in mine),
            "step_ms_median_all": statistics.median(
                m for t in mine for m in t["step_ms"])}
        s = summary[label]
        print(f"{label} [{line}]: host ms a call, the turns' mean of the "
              f"least run ({len(mine)} turns) " + ", ".join(
                  f"{k} {v:.4f}" for k, v in
                  s["host_ms_a_call_least_mean"].items())
              + "; CPU ms a call, the turns' mean of the least run "
              + ", ".join(f"{k} {v:.4f}" for k, v in
                          s["cpu_ms_a_call_least_mean"].items())
              + f"; step ms, mean of the turns' medians "
              f"{s['step_ms_mean_of_medians']:.1f}, median of all steps "
              f"{s['step_ms_median_all']:.1f}; CPU ms to issue a step, "
              f"mean of the turns' medians "
              f"{s['step_cpu_ms_mean_of_medians']:.1f}", flush=True)
    if len(labels) == 2:
        (la, _), (lb, _) = pairs
        pair_est = []
        for i in range(0, len(turns), 4):
            q = turns[i:i + 4]
            def diff(get):
                return (get(q[1]) + get(q[2]) - get(q[0]) - get(q[3])) / 2
            pair_est.append({
                "step_ms": diff(lambda t: t["step_median_ms"]),
                "step_cpu_ms": diff(lambda t: t["step_cpu_median_ms"]),
                **{k: diff(lambda t: t["host_ms_a_call"][k]["min"])
                   for k in ("fprop", "bprop", "updat")},
                **{f"{k}_cpu": diff(
                    lambda t: t["host_ms_a_call"][k]["cpu_min"])
                   for k in ("fprop", "bprop", "updat")}})
        summary["abba"] = pair_est
        print(f"{lb} - {la}, each A B B A round: " + "; ".join(
            f"step {e['step_ms']:+.1f} ms (CPU {e['step_cpu_ms']:+.1f}), "
            f"a call by the clock / CPU fprop {e['fprop'] * 1e3:+.1f} / "
            f"{e['fprop_cpu'] * 1e3:+.1f} us, bprop "
            f"{e['bprop'] * 1e3:+.1f} / {e['bprop_cpu'] * 1e3:+.1f}, updat "
            f"{e['updat'] * 1e3:+.1f} / {e['updat_cpu'] * 1e3:+.1f}"
            for e in pair_est), flush=True)
    os.makedirs(os.path.dirname(a.out), exist_ok=True)
    with open(a.out, "w") as f:
        json.dump({"card": line, "order": [lb for lb, _ in order],
                   "turns": turns, "summary": summary}, f, indent=1)


if __name__ == "__main__":
    main()
