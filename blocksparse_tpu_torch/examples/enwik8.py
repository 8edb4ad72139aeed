"""Sparse Transformer language model on enwik8 (or synthetic bytes).

The port of ``examples/enwik8.py``: block-sparse attention (the fixed
pattern with causal sub-block masks), layer norm and fast gelu, bf16
compute on the card with f32 masters and dynamic loss scaling, Adam with
global-norm clipping, per-block recompute; the train step
``make_train_step`` returns (one CUDA graph on the card).  Reports bits
per byte.

    python -m blocksparse_tpu_torch.examples.enwik8 [--n_iter 100] ...
    python -m blocksparse_tpu_torch.examples.enwik8 --device cpu \\
        --n_ctx 64 --n_embd 64 --n_layer 2 --n_head 4 --blk_size 16
    torchrun --nproc_per_node 4 -m blocksparse_tpu_torch.examples.enwik8 \\
        --device cpu --tp 2 --sp 2 ...      # 4 gloo ranks (nccl on cuda)
    torchrun --nproc_per_node 4 -m blocksparse_tpu_torch.examples.enwik8 \\
        --device cpu --pp 2 --ep 2 --moe_experts 2 ...   # GPipe x experts

Data: ``--data_file`` with the enwik8 bytes; without it the JAX example's
synthetic byte stream (``load_data``, ``batch_iter``: the same bytes and
batches for the same sizes and seeds).  The weights are drawn from seed 0
with the JAX initialiser's shapes and scales (``random_jax_params``), not
from JAX's PRNG.  Flags are the JAX example's.  ``--tp``, ``--sp`` and
``--sp_mode``, ``--pp`` (with ``--pp_microbatch``) and ``--ep`` shard the
model over the ranks of a torchrun (or of a process group the caller
initialised): dp is the world size over tp·sp·pp·ep, and every rank draws
the same global batch and takes its (batch/(dp·ep), ctx/sp) piece, as the
JAX example's mesh splits it; a batch that does not divide by dp·ep
raises (the JAX example leaves devices idle instead).  One process with
tp = sp = pp = ep = 1 runs the single-device step, as the JAX example's
``use_mesh`` rule; with a mesh only rank 0 prints, and checkpoints go to
a ``rank{r}`` directory each.
``--moe_experts`` > 0 (with ``--moe_k``) makes each MLP a
block-sparse Mixture-of-Experts and, as in the JAX example, forces
``--mlp_block_size`` 32.  Added: ``--device`` (default the
card), ``--mlp_block_size``/``--mlp_density`` (a block-sparse MLP, the
flagship's b32 d0.5; default the example's dense MLP) and
``--trace_dir`` (``--profile``'s output).  ``--resume`` restores params, optimizer state, loss scale and
step from ``--ckpt_dir`` and, as the JAX example does, starts the batch
iterator over from its first batch.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from blocksparse_tpu_torch import checkpoint as ck
from blocksparse_tpu_torch.convert import params_from_jax, random_jax_params
from blocksparse_tpu_torch.models import SparseTransformerLM, TransformerConfig
from blocksparse_tpu_torch.ops.optimize import AdamOptimizer
from blocksparse_tpu_torch.parallel import (allreduce, data_sharding,
                                            make_mesh, mpi_size)
from blocksparse_tpu_torch.profiling import trace


def load_data(path, n_train, n_valid):
    if path and os.path.exists(path):
        with open(path, "rb") as f:
            data = np.frombuffer(f.read(), dtype=np.uint8)
    else:
        print("no data file; using synthetic byte stream")
        rng = np.random.RandomState(0)
        # markov-ish synthetic bytes so the LM has something to learn
        data = rng.randint(0, 64, size=n_train + n_valid).astype(np.uint8)
        data[1:] = (data[1:] + data[:-1] * 3) % 223
    return data[:n_train], data[n_train:n_train + n_valid]


def batch_iter(data, batch, ctx, rng):
    while True:
        idx = rng.randint(0, len(data) - ctx - 1, size=batch)
        x = np.stack([data[i:i + ctx] for i in idx]).astype(np.int32)
        y = np.stack([data[i + 1:i + ctx + 1] for i in idx]).astype(np.int32)
        yield x, y


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--data_file", type=str, default=None)
    p.add_argument("--n_iter", type=int, default=100)
    p.add_argument("--n_batch", type=int, default=8)
    p.add_argument("--n_ctx", type=int, default=2048)
    p.add_argument("--n_embd", type=int, default=512)
    p.add_argument("--n_layer", type=int, default=6)
    p.add_argument("--n_head", type=int, default=8)
    p.add_argument("--blk_size", type=int, default=64)
    p.add_argument("--attn_layout", type=str, default="fixed")
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--loss_scale", type=float, default=2.0 ** 15)
    p.add_argument("--dtype", type=str, default=None)
    p.add_argument("--profile", type=int, default=0)
    p.add_argument("--ckpt_dir", type=str, default=None)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--ckpt_every", type=int, default=0)
    p.add_argument("--eval_every", type=int, default=0)
    p.add_argument("--tp", type=int, default=1)
    p.add_argument("--sp", type=int, default=1)
    p.add_argument("--sp_mode", type=str, default="gather",
                   choices=("gather", "ring"))
    p.add_argument("--pp", type=int, default=1)
    p.add_argument("--pp_microbatch", type=int, default=0)
    p.add_argument("--moe_experts", type=int, default=0)
    p.add_argument("--moe_k", type=int, default=1)
    p.add_argument("--ep", type=int, default=1)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (the card) or cpu")
    p.add_argument("--mlp_block_size", type=int, default=0,
                   help=">0: block-sparse MLP at this block size")
    p.add_argument("--mlp_density", type=float, default=1.0)
    p.add_argument("--trace_dir", type=str, default=None,
                   help="--profile's trace directory (default: a new "
                        "temporary one)")
    return p.parse_args(argv)


def _mesh(args, dev):
    """The mesh of a sharded run (None for one process at tp = sp = pp =
    ep = 1): dp = world size / (tp·sp·pp·ep), initialising the process
    group from the environment if the caller has not."""
    world = (torch.distributed.get_world_size()
             if torch.distributed.is_initialized()
             else int(os.environ.get("WORLD_SIZE", "1")))
    model_par = args.tp * args.sp * args.pp * args.ep
    if world == 1 and model_par == 1:
        return None
    if world % model_par:
        raise SystemExit(f"--tp {args.tp} x --sp {args.sp} x --pp {args.pp} "
                         f"x --ep {args.ep} must divide the world size "
                         f"({world})")
    dp = world // model_par
    if args.n_batch % (dp * args.ep):
        raise SystemExit(f"--n_batch {args.n_batch} must divide by dp*ep = "
                         f"{dp * args.ep}")
    return make_mesh(dp=dp, tp=args.tp, pp=args.pp, sp=args.sp, ep=args.ep,
                     device=dev.type)


def build(args):
    """(config, model with seed-0 weights, optimizer, train step) for the
    parsed flags; with --tp/--sp/--pp/--ep (or several ranks) the model is
    this rank's shard and the step the sharded one."""
    dev = torch.device(args.device)
    mesh = _mesh(args, dev)
    if mesh is not None and dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    dtype = args.dtype or ("bfloat16" if dev.type == "cuda" else "float32")
    cfg = TransformerConfig(
        n_vocab=256, n_embd=args.n_embd, n_layer=args.n_layer,
        n_head=args.n_head, ctx=args.n_ctx, blk_size=args.blk_size,
        attn_layout=args.attn_layout, local_blocks=8, mlp_ratio=4,
        dtype=dtype, recompute=True, tp=args.tp, sp=args.sp,
        sp_mode=args.sp_mode, pp=args.pp, pp_microbatch=args.pp_microbatch,
        moe_experts=args.moe_experts, moe_k=args.moe_k, ep=args.ep,
        mlp_block_size=32 if args.moe_experts else args.mlp_block_size,
        mlp_density=args.mlp_density)
    model = SparseTransformerLM(cfg, device=dev, mesh=mesh)
    model.load_state_dict(params_from_jax(random_jax_params(model, seed=0),
                                          model))
    optm = AdamOptimizer(learning_rate=args.lr, zero_nans=True,
                         zero_infs=True)
    return cfg, model, optm, model.make_train_step(optm, mesh=mesh)


def train(args, on_step=None):
    """The training loop of the JAX example.  ``on_step(step, model,
    opt_state, loss_scale, metrics)``, if given, runs after each step's
    checkpoint.  Returns {"losses": [loss a step from the start step],
    "start": start step, "eval": [(step, bits/byte)]}."""
    cfg, model, optm, step_fn = build(args)
    dev = model.wte.device
    mesh = model.mesh
    say = print if mesh is None or torch.distributed.get_rank() == 0 \
        else (lambda *a, **k: None)
    shard = (data_sharding(mesh, ("dp", "ep"), "sp") if mesh is not None
             else None)
    ckpt_dir = args.ckpt_dir
    if mesh is not None and ckpt_dir:
        ckpt_dir = os.path.join(ckpt_dir,
                                f"rank{torch.distributed.get_rank()}")
    say(f"model: {cfg.n_layer}L x {cfg.n_embd}d ctx {cfg.ctx} "
        f"attn blocks {model.bst.blocks} | device "
        f"{torch.cuda.get_device_name(dev) if dev.type == 'cuda' else dev}"
        + ("" if mesh is None else f" | mesh {tuple(mesh.mesh.shape)}"))
    opt_state = optm.init(dict(model.named_parameters()))
    train_data, valid = load_data(args.data_file, 9 * 10 ** 7, 5 * 10 ** 6)
    it = batch_iter(train_data, args.n_batch, args.n_ctx,
                    np.random.RandomState(1))

    def on_dev(a):
        if shard is not None:
            a = shard.shard(a)
        return torch.from_numpy(np.ascontiguousarray(a)).long().to(dev)
    loss_scale = torch.tensor(args.loss_scale if cfg.dtype != "float32"
                              else 1.0, device=dev)
    start = 0
    if args.resume and ckpt_dir:
        tree, meta = ck.restore(ckpt_dir, device=dev)
        model.load_state_dict(tree["params"])
        opt_state = tree["opt_state"]
        loss_scale = tree.get("loss_scale", loss_scale)
        start = meta["step"]
        say(f"resumed from step {start}")

    losses, evals = [], []
    t0 = time.time()
    for step in range(start, args.n_iter):
        x, y = next(it)
        opt_state, metrics, loss_scale = step_fn(opt_state, on_dev(x),
                                                 on_dev(y), loss_scale)
        losses.append(metrics["loss"])
        if step % 10 == 0 or step == args.n_iter - 1:
            loss = float(metrics["loss"])
            say(f"step {step:5d} loss {loss:7.4f} bits/byte "
                f"{loss / np.log(2):6.3f} gnorm "
                f"{float(metrics['grad_norm']):8.2f} scale "
                f"{float(loss_scale):9.1f} ({time.time() - t0:5.1f}s)",
                flush=True)
        if args.ckpt_every and ckpt_dir \
                and (step + 1) % args.ckpt_every == 0:
            ck.save(ckpt_dir, model.state_dict(), opt_state=opt_state,
                    step=step + 1, loss_scale=loss_scale, config=vars(args))
        if on_step is not None:
            on_step(step, model, opt_state, loss_scale, metrics)
        if args.eval_every and (step + 1) % args.eval_every == 0:
            vx, vy = next(batch_iter(valid, args.n_batch, args.n_ctx,
                                     np.random.RandomState(9)))
            with torch.no_grad():
                vl = model.loss(on_dev(vx), on_dev(vy))
                if mesh is not None:              # the shards' mean
                    if cfg.pp > 1:                # loss_pp: loss/pp + aux
                        vl = allreduce(vl, axis="pp", mesh=mesh)
                    axes = ("dp", "sp", "ep")
                    vl = allreduce(vl, axis=axes, mesh=mesh) \
                        / mpi_size(mesh, axes)
            vl = float(vl)
            evals.append((step + 1, vl / np.log(2)))
            say(f"  eval bits/byte {vl / np.log(2):6.3f}", flush=True)
        if args.profile and step == args.profile:
            with trace(args.trace_dir) as logdir:
                opt_state, metrics, loss_scale = step_fn(
                    opt_state, on_dev(x), on_dev(y), loss_scale)
            say(f"profiler trace written to {logdir}")
            break
    return {"losses": [float(l) for l in losses], "start": start,
            "eval": evals}


def main(argv=None):
    train(parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
