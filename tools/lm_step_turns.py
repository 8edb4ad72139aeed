"""Time the flagship LM's captured train step for two or more checkouts in
alternating turns on one card.

    python3 tools/lm_step_turns.py ROOT [ROOT ...] [--labels A B ...]
        [--rounds 2] [--steps 5] [--reps 3] [--out PATH]

Each ROOT is a checkout of the repo: this one (``.``) or another commit
unpacked with ``git archive <commit> | tar -x -C build/parent``.  A turn is
one child process that imports ``blocksparse_tpu_torch`` and
``chip_smoke.py`` from its ROOT (the kernels of every ROOT built first, all
at once, each into its ROOT's ``build/``) and measures the flagship's step
as ``chip_smoke.py``'s training path takes it: ``chip_smoke.FLAGSHIP``
(batch 8 x 2048, bf16, recompute), random weights and tokens from the
seed, Adam with clipping, the step captured as one CUDA graph at its first
call, then ``--reps`` times the mean device time of ``--steps`` replays by
CUDA events; a turn prints its median.  The turns run in ABBA order,
``--rounds`` times, so a drift linear in time cancels in each checkout's
mean.  Prints a line a turn, the card's name and power limit, and a summary
of medians; writes the turns as JSON to ``--out`` (default
``build/lm_step_turns.json``).  Imports no JAX.  Exits 1 without a CUDA
device.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path


def child(root, steps, reps):
    """One turn in this process: the package and chip_smoke.py of
    ``root``; prints one JSON line."""
    sys.path.insert(0, str(root))
    import numpy as np
    import torch
    import blocksparse_tpu_torch as bt
    import chip_smoke as cs
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    cfg = cs.flagship_config(bt)
    model = bt.SparseTransformerLM(cfg, device=dev)
    model.load_state_dict(bt.params_from_jax(
        bt.random_jax_params(model, seed=cs.SEED), model))
    rng = np.random.RandomState(cs.SEED)
    seq = torch.from_numpy(rng.randint(0, cfg.n_vocab,
                                       (cs.BATCH, cfg.ctx + 1))).to(dev)
    tokens, targets = seq[:, :-1], seq[:, 1:]
    opt = bt.AdamOptimizer(learning_rate=cs.LR, zero_nans=True,
                           zero_infs=True)
    step = model.make_train_step(opt, clip_norm=cs.CLIP)
    holder = {"state": opt.init(dict(model.named_parameters())),
              "scale": torch.tensor(cs.LOSS_SCALE, device=dev)}

    def one():
        holder["state"], _, holder["scale"] = step(
            holder["state"], tokens, targets, holder["scale"])
    one()                                     # warm-up and capture
    times = [cs.time_ms(one, steps) for _ in range(reps)]
    print(json.dumps({"ms": times, "median": statistics.median(times)}),
          flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("roots", nargs="+")
    ap.add_argument("--labels", nargs="*")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--out", default="build/lm_step_turns.json")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        return child(args.roots[0], args.steps, args.reps)
    import torch
    if not torch.cuda.is_available():
        print("lm_step_turns: no CUDA device", file=sys.stderr)
        return 1
    roots = [Path(r).resolve() for r in args.roots]
    labels = args.labels or [str(r) for r in args.roots]
    # every root's kernels built first, all at once (each into its root)
    build = ("import sys; sys.path.insert(0, {r!r}); import chip_smoke as cs;"
             " cs.build_all()")
    with ThreadPoolExecutor(len(roots)) as pool:
        for root, proc in zip(roots, pool.map(lambda r: subprocess.run(
                [sys.executable, "-c", build.format(r=str(r))], cwd=r,
                capture_output=True, text=True), roots)):
            print(f"build {root}: rc {proc.returncode}, "
                  f"{proc.stdout.strip().splitlines()[-1:]}", flush=True)
            if proc.returncode:
                print(proc.stderr[-4000:], file=sys.stderr)
                return 1
    order = list(range(len(roots)))
    turns = []
    for _ in range(args.rounds):
        for i in order + order[::-1]:
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), str(roots[i]),
                 "--child", "--steps", str(args.steps), "--reps",
                 str(args.reps)], cwd=roots[i], capture_output=True,
                text=True)
            if proc.returncode:
                print(proc.stdout[-2000:], proc.stderr[-4000:],
                      file=sys.stderr)
                return 1
            r = json.loads(proc.stdout.strip().splitlines()[-1])
            turns.append({"label": labels[i], **r})
            print(f"turn {len(turns)} {labels[i]}: captured step "
                  f"{' / '.join(f'{t:.3f}' for t in r['ms'])} ms (median "
                  f"{r['median']:.3f})", flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    summary = {lab: statistics.median(t["median"] for t in turns
                                      if t["label"] == lab)
               for lab in labels}
    print(f"captured train step, median of the turns' medians [{card}]: "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in summary.items()),
          flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps({"card": card, "turns": turns,
                                          "summary": summary}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
