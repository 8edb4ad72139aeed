"""The ranks of a pipeline or of an expert-parallel group, in one process.

The port's per-stage steps (``parallel.pipeline.stage_forward`` and
``stage_backward``) and per-shard steps (``BlocksparseMoE.dispatch``,
``experts`` and ``combine``) driven rank by rank, the activations and the
all-to-alls handed over by tensor.  The tests hold these drivers against
the gloo ranks and the sequential model; ``chip_smoke.py`` runs them on
one card, where a pipeline or an ep group of several NCCL ranks cannot
run.  Imports no JAX.
"""
import torch

from blocksparse_tpu_torch.parallel.pipeline import (stage_backward,
                                                     stage_forward,
                                                     stage_parameters)


def run_stages(stage_fn, stages, x_micro, with_aux=False):
    """A pipeline of len(stages) stages, stage s on ``stages[s]``: each
    microbatch through every stage in turn (``stage_forward``).  Returns
    (records[s][m] for ``backprop_stages``, the last stage's outputs
    (n_micro, ...), each stage's aux summed over the microbatches, f32,
    or None without aux)."""
    records = [[] for _ in stages]
    ys, auxes = [], [torch.zeros((), dtype=torch.float32,
                                 device=x_micro.device) for _ in stages]
    for m in range(x_micro.shape[0]):
        h = x_micro[m]
        for s, params in enumerate(stages):
            rec = stage_forward(stage_fn, params, h, with_aux)
            records[s].append(rec)
            h = rec[1].detach()
            if with_aux:
                auxes[s] = auxes[s] + rec[2].detach().float()
        ys.append(h)
    return records, torch.stack(ys), auxes if with_aux else None


def backprop_stages(records, stages, dout, daux=None):
    """The backward of ``run_stages`` given the outputs' cotangent dout
    (n_micro, ...) and the auxes' ``daux``: the microbatches in reverse,
    each back through the stages (``stage_backward``), each stage's
    gradients added in the order ``gpipe`` adds them.  Returns (dx_micro,
    [each stage's parameter gradients, in order])."""
    grads = [None] * len(stages)
    dxs = [None] * dout.shape[0]
    for m in reversed(range(dout.shape[0])):
        d = dout[m]
        for s in reversed(range(len(stages))):
            d, dps = stage_backward(records[s][m], d,
                                    stage_parameters(stages[s]),
                                    daux)
            records[s][m] = None
            grads[s] = dps if grads[s] is None else [
                g + dp for g, dp in zip(grads[s], dps)]
        dxs[m] = d
    return torch.stack(dxs), grads


def all_to_all_local(xs, split_dim, concat_dim):
    """``parallel.collectives.all_to_all_dim`` of n ranks: ``xs`` the
    ranks' tensors in rank order, the result each rank's (rank j gets
    piece j of every rank's x, concatenated in rank order), by slicing;
    differentiable."""
    n = len(xs)
    if xs[0].shape[split_dim] % n:
        raise ValueError(f"dim {split_dim} of {tuple(xs[0].shape)} does not "
                         f"divide by {n} ranks")
    pieces = [x.chunk(n, dim=split_dim) for x in xs]
    return [torch.cat([p[j] for p in pieces], dim=concat_dim)
            for j in range(n)]


def run_ep_shards(moe, params, xs):
    """The ep ranks of ``moe`` (a ``BlocksparseMoE`` with ep > 1):
    ``params`` the whole layer (all E experts), ``xs`` each rank's tokens.
    Each rank routes its own tokens at the capacity of its T, the
    all-to-all is done by slicing, and rank j's E/ep experts run on their
    (E/ep, ep·C, d) slots.  Returns each rank's (y, aux), as the ranks of
    ``moe(params, x, ep_axis=...)`` compute them; differentiable."""
    n = moe.E // moe.ep
    routed = [moe.dispatch(params, x) for x in xs]
    xe = all_to_all_local([b for b, _ in routed], 0, 1)
    ye = [moe.experts({k: v[j * n:(j + 1) * n] for k, v in params.items()
                       if k != "wg"}, xe[j])
          for j in range(moe.ep)]
    return [(moe.combine(b, route), moe.aux(route))
            for b, (_, route) in zip(all_to_all_local(ye, 1, 0), routed)]
