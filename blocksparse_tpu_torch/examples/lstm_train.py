"""Sparse LSTM language model training (text8/wiki3-style bytes).

The port of ``examples/lstm_train.py``: the block-sparse mLSTM with a
small-world (Barabasi-Albert) layout, strided ``SparseProj``
projections, fused gates with the segmented layer norm, Adam with
global-norm clipping, an EMA of the parameters with an EMA eval,
stacked layers (``--lsteps``), recompute, dropout, and checkpoint save
and restore (``--save_path``/``--restore``: ``checkpoint.py`` with the
layouts sidecar and the config).  Reports bits per character.

    python -m blocksparse_tpu_torch.examples.lstm_train [--n_iter 100] ...
    python -m blocksparse_tpu_torch.examples.lstm_train --device cpu \\
        --nhidden 128 --nsteps 16 --batch 4 --mask_kind ba_2 --n_iter 3

Data: ``--data_file`` with the corpus bytes; without it the JAX example's
synthetic stream (``load_data``: the same bytes), batches drawn as its
``get_batch`` draws them.  The weights are drawn from seed 0 with the JAX
initialiser's shapes and scales (``random_jax_lstm_params``), not from
JAX's PRNG; dropout draws from a ``torch.Generator`` seeded with the
iteration, where JAX keys on it.  Flags are the JAX example's; added:
``--device`` (default the card).
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch
from torch.func import functional_call

from blocksparse_tpu_torch import checkpoint as ck
from blocksparse_tpu_torch.convert import (lstm_params_from_jax,
                                           random_jax_lstm_params)
from blocksparse_tpu_torch.models.sparse_lstm import LSTMConfig, SparseLSTM
from blocksparse_tpu_torch.ops.optimize import (AdamOptimizer, Ema,
                                                clip_by_global_norm)
from blocksparse_tpu_torch.ops.transformer import softmax_cross_entropy


def load_data(path, nsteps, batch):
    """(train, val) bytes: the file's, or the JAX example's synthetic
    stream (10^7 bytes of a mod-27 recurrence); the last twentieth (at
    least a batch) is the validation split."""
    if path and os.path.exists(path):
        with open(path, "rb") as f:
            data = np.frombuffer(f.read(), dtype=np.uint8)
    else:
        rng = np.random.RandomState(0)
        data = rng.randint(0, 27, size=10 ** 7).astype(np.uint8)
        data[1:] = (data[1:] + 7 * data[:-1]) % 27
    n_val = max(len(data) // 20, nsteps * batch + 2)
    return data[:-n_val], data[-n_val:]


def get_batch(data, rng, batch, nsteps):
    """(x, y) int32 (batch, nsteps): random windows and their next bytes."""
    idx = rng.randint(0, len(data) - nsteps - 1, batch)
    x = np.stack([data[i:i + nsteps] for i in idx]).astype(np.int32)
    y = np.stack([data[i + 1:i + nsteps + 1] for i in idx]).astype(np.int32)
    return x, y


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--data_file", type=str, default=None)
    p.add_argument("--n_iter", type=int, default=100)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--nsteps", type=int, default=64)
    p.add_argument("--nhidden", type=int, default=1120)
    p.add_argument("--isteps", type=int, default=2)
    p.add_argument("--lsteps", type=int, default=1,
                   help="stacked sparse LSTM layers")
    p.add_argument("--share_masks", type=int, default=1)
    p.add_argument("--forget_bias", type=float, default=1.0)
    p.add_argument("--dropout", type=float, default=0.0)
    p.add_argument("--recompute", type=int, default=0)
    p.add_argument("--mask_kind", type=str, default="ba_10")
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--save_path", type=str, default=None)
    p.add_argument("--ckpt_every", type=int, default=0)
    p.add_argument("--restore", type=str, default="")
    p.add_argument("--eval_every", type=int, default=0,
                   help="run an EMA-weights eval every N iters")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (the card) or cpu")
    return p.parse_args(argv)


def make_step(model, optm, ema, clip_norm=1.0):
    """The JAX example's step: loss and its gradients, the global norm
    clipped to ``clip_norm``, Adam (the parameters written in place), then
    the EMA of the new parameters.  step(opt_state, ema_state, x, y,
    dropout) -> (opt_state, ema_state, loss, grad_norm); ``dropout`` as
    ``SparseLSTM.loss`` takes it."""
    names, params = zip(*model.named_parameters())

    def step(opt_state, ema_state, x, y, dropout=None):
        loss = model.loss(x, y, dropout=dropout)
        grads = dict(zip(names, torch.autograd.grad(loss, params)))
        gn, ns = clip_by_global_norm(grads, clip_norm=clip_norm)
        new, opt_state = optm.apply(
            grads, {n: p.detach() for n, p in zip(names, params)},
            opt_state, norm_scale=ns)
        with torch.no_grad():
            for n, p in zip(names, params):
                p.copy_(new[n])
        ema_state = ema.apply(new, ema_state)
        return opt_state, ema_state, loss.detach(), gn
    return step


def build(args):
    """(model, optimizer, EMA, opt_state, ema_state, start iteration) for
    the parsed flags: a new model with seed-0 weights, or the one
    ``--restore`` names with its config, states and step."""
    dev = torch.device(args.device)
    cfg = LSTMConfig(nhidden=args.nhidden, nsteps=args.nsteps,
                     mask_kind=args.mask_kind, isteps=args.isteps,
                     lsteps=args.lsteps, share_masks=bool(args.share_masks),
                     forget_bias=args.forget_bias, dropout=args.dropout,
                     recompute=bool(args.recompute))
    tree = meta = None
    if args.restore:
        tree, meta = ck.restore(args.restore, device=dev)
        cfg = LSTMConfig(**meta["config"])
        print(f"restored config from {args.restore} (step {meta['step']})")
    model = SparseLSTM(cfg, device=dev)
    optm = AdamOptimizer(learning_rate=args.lr, zero_nans=True)
    ema = Ema(decay=0.999)
    if tree is not None:
        model.load_state_dict(tree["params"])
        params = dict(model.named_parameters())
        opt_state = tree.get("opt_state") or optm.init(params)
        ema_state = tree.get("ema_state") or ema.init(params)
        return model, optm, ema, opt_state, ema_state, int(meta["step"])
    model.load_state_dict(lstm_params_from_jax(
        random_jax_lstm_params(model, seed=0), model))
    params = dict(model.named_parameters())
    return model, optm, ema, optm.init(params), ema.init(params), 0


def train(args):
    """The training loop of the JAX example.  Returns {"losses": [loss a
    step], "start": start step, "eval": [(step, EMA val loss)]}."""
    model, optm, ema, opt_state, ema_state, start = build(args)
    cfg, dev = model.config, model.wte.device
    print(f"sparse LSTM: nhidden {cfg.nhidden} x {cfg.lsteps}L, layout "
          f"{cfg.mask_kind}, blocks {model.bsmm_h.blocks} "
          f"(density {model.bsmm_h.sparsity:.3f}) | device "
          f"{torch.cuda.get_device_name(dev) if dev.type == 'cuda' else dev}")
    train_data, val_data = load_data(args.data_file, args.nsteps,
                                     args.batch)
    step = make_step(model, optm, ema)

    def on_dev(a):
        return torch.from_numpy(a).long().to(dev)
    rng = np.random.RandomState(1 + start)
    losses, evals = [], []
    t0 = time.time()
    for it in range(start, start + args.n_iter):
        x, y = get_batch(train_data, rng, args.batch, args.nsteps)
        drop = torch.Generator(device=dev).manual_seed(it) \
            if cfg.dropout > 0 else None
        opt_state, ema_state, loss, gn = step(opt_state, ema_state,
                                              on_dev(x), on_dev(y), drop)
        losses.append(loss)
        if it % 10 == 0 or it == start + args.n_iter - 1:
            its = (it - start + 1) / (time.time() - t0)
            print(f"iter {it:5d} loss {float(loss):7.4f} "
                  f"bits/char {float(loss) / np.log(2):6.3f} gnorm "
                  f"{float(gn):8.2f} {its:5.2f} it/s", flush=True)
        if args.eval_every and (it + 1) % args.eval_every == 0:
            # the EMA weights' loss on a fixed validation batch
            vx, vy = get_batch(val_data, np.random.RandomState(7),
                               args.batch, args.nsteps)
            vl = float(ema_loss(model, ema, ema_state, on_dev(vx),
                                on_dev(vy)))
            evals.append((it + 1, vl))
            print(f"iter {it:5d} EMA val loss {vl:7.4f} "
                  f"bits/char {vl / np.log(2):6.3f}", flush=True)
        if args.save_path and args.ckpt_every and \
                (it + 1) % args.ckpt_every == 0:
            save(args.save_path, model, opt_state, ema_state, it + 1)
            print(f"iter {it:5d} checkpoint -> {args.save_path}")
    if args.save_path:
        save(args.save_path, model, opt_state, ema_state,
             start + args.n_iter)
        print(f"saved checkpoint -> {args.save_path}")
    return {"losses": [float(l) for l in losses], "start": start,
            "eval": evals}


@torch.no_grad()
def ema_loss(model, ema, ema_state, x, y):
    """The model's loss with the EMA's averaged parameters in place of its
    own, which stay as they are."""
    logits = functional_call(model, ema.params(ema_state), (x,))
    return softmax_cross_entropy(logits, y).mean()


def save(path, model, opt_state, ema_state, step):
    """A checkpoint of the model, its Adam and EMA states and the step,
    with the layouts sidecar and the config."""
    ck.save(path, model.state_dict(), opt_state=opt_state,
            ema_state=ema_state, step=step, layouts=model.layouts(),
            config=model.config_dict())


def main(argv=None):
    train(parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
