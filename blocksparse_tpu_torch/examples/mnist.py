"""Dense-attention transformer on MNIST-sized digits with the quantize
harness.

The port of ``examples/mnist.py``: 784-pixel images cut into 16 patches
of 49, two layers of dense ``masked_softmax`` attention and a gelu MLP at
width 64, mean-pooled to 10 classes; global-norm clipping and Adam; with
``--quantize``, q and k of each layer quantized e4f3 forward and e5f2
backward (stochastic rounding, each emax tracked by a
``QuantizeTracker``).  Reports the loss and, last, the accuracy on the
first 1,024 training images.  Like the JAX example it runs no
block-sparse kernel: the whole model is plain torch.

    python -m blocksparse_tpu_torch.examples.mnist [--n_iter 200] \\
        [--batch 128] [--quantize] [--device cpu]

Data: the JAX example's synthetic digits (``get_data``: the same bytes),
batches drawn as it draws them.  The weights are drawn from a
``torch.Generator`` seeded 0 with the JAX initialiser's shapes and scale
(``init_params``), not from JAX's PRNG; ``params_from_jax`` loads the JAX
example's ``init_params`` given as NumPy instead.  Stochastic rounding
draws from a generator seeded with the iteration, where JAX keys on it.
Flags are the JAX example's; added: ``--device`` (default the card).
"""
from __future__ import annotations

import argparse
import math
import sys
import time

import numpy as np
import torch

from blocksparse_tpu_torch.ops.ewops import fast_gelu
from blocksparse_tpu_torch.ops.norms import layer_norm
from blocksparse_tpu_torch.ops.optimize import (AdamOptimizer,
                                                clip_by_global_norm)
from blocksparse_tpu_torch.ops.quantize import (QuantizeSpec,
                                                QuantizeTracker, quantize)
from blocksparse_tpu_torch.ops.transformer import (masked_softmax,
                                                   softmax_cross_entropy)

PATCHES, PATCH = 16, 49
LAYER_KEYS = ("wq", "wk", "wv", "wo", "w1", "w2")


def get_data(n=4096):
    """Synthetic digits: uniform noise plus a class-dependent band."""
    rng = np.random.RandomState(0)
    x = rng.rand(n, 784).astype(np.float32)
    y = rng.randint(0, 10, n)
    for i in range(n):
        x[i, y[i] * 70:(y[i] + 1) * 70] += 1.5
    return x, y


def make_qspecs(enabled):
    """(forward, backward) specs: e4f3 and e5f2, stochastic rounding,
    emax tracked from max|x| (mode 1); (None, None) when off."""
    if not enabled:
        return None, None
    fwd = QuantizeSpec(ebits=4, fbits=3, stochastic=2, mode=1)
    bwd = QuantizeSpec(ebits=5, fbits=2, stochastic=2, mode=1)
    return fwd, bwd


def flatten(tree, prefix=""):
    """A nested dict/list of arrays as one dict, in JAX's ``tree_leaves``
    order (dict keys sorted, lists in order): "layers.0.wq", ..."""
    if isinstance(tree, dict):
        items = ((f"{prefix}{k}", tree[k]) for k in sorted(tree))
    elif isinstance(tree, (list, tuple)):
        items = ((f"{prefix}{i}", v) for i, v in enumerate(tree))
    else:
        return {prefix[:-1]: tree}
    out = {}
    for name, v in items:
        out.update(flatten(v, name + "."))
    return out


def init_params(generator, D=64, n_layer=2, device="cpu"):
    """The JAX example's parameters, N(0, 0.05²) weights drawn from
    ``generator`` (on the CPU) in its order, unit gains, zero biases."""
    def rnd(*shape):
        return torch.randn(shape, generator=generator) * 0.05

    w_in, w_out = rnd(PATCH, D), rnd(D, 10)
    layers = []
    for _ in range(n_layer):
        layer = {k: rnd(*s) for k, s in zip(
            LAYER_KEYS, ((D, D),) * 4 + ((D, 4 * D), (4 * D, D)))}
        layer.update(ln_g=torch.ones(D), ln_b=torch.zeros(D),
                     ln2_g=torch.ones(D), ln2_b=torch.zeros(D))
        layers.append(layer)
    tree = {"w_in": w_in, "b_in": torch.zeros(D), "w_out": w_out,
            "b_out": torch.zeros(10), "layers": layers}
    return {k: v.to(device) for k, v in flatten(tree).items()}


def params_from_jax(tree, device="cpu"):
    """The JAX example's ``init_params`` tree, its leaves as NumPy, as
    this example's parameters."""
    return {k: torch.as_tensor(np.array(v, np.float32), device=device)
            for k, v in flatten(tree).items()}


def model_apply(p, h, qspecs, generator=None):
    """Logits (n, 10) of patch embeddings h (n, 16, D)."""
    fwd_spec, bwd_spec = qspecs
    D = h.shape[-1]
    n_layer = len({k.split(".")[1] for k in p if k.startswith("layers.")})
    for l in range(n_layer):
        w = {k: p[f"layers.{l}.{k}"] for k in LAYER_KEYS + (
            "ln_g", "ln_b", "ln2_g", "ln2_b")}
        a = layer_norm(h.reshape(-1, D), w["ln_g"], w["ln_b"],
                       axis=-1).reshape(h.shape)
        q, k, v = a @ w["wq"], a @ w["wk"], a @ w["wv"]
        if fwd_spec is not None:
            q = quantize(q, fwd_spec, bwd_spec, name=f"q{l}",
                         generator=generator, b_generator=generator)
            k = quantize(k, fwd_spec, bwd_spec, name=f"k{l}",
                         generator=generator, b_generator=generator)
        s = torch.einsum("ntd,nsd->nts", q, k) / math.sqrt(D)
        pr = masked_softmax(s)
        h = h + torch.einsum("nts,nsd->ntd", pr, v) @ w["wo"]
        m = layer_norm(h.reshape(-1, D), w["ln2_g"], w["ln2_b"],
                       axis=-1).reshape(h.shape)
        h = h + fast_gelu(m @ w["w1"]) @ w["w2"]
    return h.mean(dim=1) @ p["w_out"] + p["b_out"]


def embed(p, x):
    """Patch embeddings (n, 16, D) of images x (n, 784)."""
    xp = x.reshape(-1, PATCHES, PATCH)
    return torch.einsum("ntp,pd->ntd", xp, p["w_in"]) + p["b_in"]


def make_step(optm, qspecs, tracker):
    """The JAX example's step, through the tracker: loss and gradients,
    the global norm clipped to 1, Adam.  step(params, state, x, y,
    generator) -> (params, state, loss)."""
    def step(params, state, x, y, generator):
        p = {k: v.detach().requires_grad_() for k, v in params.items()}
        logits = model_apply(p, embed(p, x), qspecs, generator)
        loss = softmax_cross_entropy(logits, y).mean()
        grads = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
        _, ns = clip_by_global_norm(grads, clip_norm=1.0)
        params, state = optm.apply(grads, params, state, norm_scale=ns)
        return params, state, loss.detach()
    return tracker.wrap_jit(step)


def train(args, params, device):
    """The example's loop from ``params``: a dict of its per-step
    ``losses`` (device scalars), the final ``params``, the ``tracker``
    and the ``accuracy``."""
    X, Y = get_data()
    optm = AdamOptimizer(learning_rate=1e-3)
    state = optm.init(params)
    qspecs = make_qspecs(args.quantize)
    tracker = QuantizeTracker()
    step = make_step(optm, qspecs, tracker)
    rng = np.random.RandomState(1)
    losses = []
    t0 = time.time()
    for it in range(args.n_iter):
        idx = rng.randint(0, len(X), args.batch)
        gen = torch.Generator(device=device).manual_seed(it)
        params, state, loss = step(
            params, state, torch.as_tensor(X[idx], device=device),
            torch.as_tensor(Y[idx], device=device), gen)
        losses.append(loss)
        if it % 20 == 0 or it == args.n_iter - 1:
            print(f"iter {it:4d} loss {float(loss):7.4f} "
                  f"({time.time() - t0:5.1f}s)", flush=True)

    logits = []
    with torch.no_grad():
        for i in range(0, 1024, args.batch):
            x = torch.as_tensor(X[i:i + args.batch], device=device)
            logits.append(model_apply(params, embed(params, x),
                                      (None, None)).cpu().numpy())
    acc = (np.concatenate(logits).argmax(-1) == Y[:1024]).mean()
    print(f"train accuracy: {acc:.3f}", flush=True)
    return {"losses": losses, "params": params, "tracker": tracker,
            "accuracy": float(acc)}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--n_iter", type=int, default=200)
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--quantize", action="store_true")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (the card) or cpu")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    device = torch.device(args.device)
    params = init_params(torch.Generator().manual_seed(0), device=device)
    train(args, params, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
