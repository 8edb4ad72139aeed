"""The port's GPipe (``parallel.pipeline``) against the JAX package's.

Four gloo ranks (``torch_dist_workers.pipeline_cases``, spawned once for
the file) run ``gpipe`` on ``tests/test_pipeline.py``'s tanh stages (S 4,
8 microbatches of 2 x 16; and S 1 on a pp axis of one rank), without and
with aux (each stage's mean(h²)), then ``broadcast_from_last`` and the
per-rank loss mean((y - 0.1)²)/S (+ 0.3 · aux).  The JAX package runs the
same under ``shard_map`` on four simulated devices; the sequential model
(the stages applied in turn, unpipelined) is the third reference.  Then
``broadcast_from_last`` alone, ``microbatch``/``unmicrobatch``, and the
stage functions driving a pipeline in one process.

Tolerances (f32): outputs, losses and gradients within 1e-6 absolute of
JAX's and of the sequential model's (sums over at most 8 microbatches in
other orders); the forward under ``no_grad`` equals the forward with
gradients bit for bit.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from blocksparse_tpu.parallel import (broadcast_from_last as jax_bcast,
                                      gpipe as jax_gpipe,
                                      microbatch as jax_microbatch)
from blocksparse_tpu_torch.parallel import microbatch, unmicrobatch
from torch_one_process import backprop_stages, run_stages
import torch_dist_workers as workers

WORLD = 4
TOL = 1e-6


@pytest.fixture(scope="module")
def ranks():
    return workers.spawn("pipeline_cases", WORLD)


def _jax_stage(params, h, with_aux):
    w, b = params

    def body(h, wb):
        return jnp.tanh(h @ wb[0] + wb[1]), None
    h, _ = jax.lax.scan(body, h, (w, b))
    return (h, jnp.mean(h * h)) if with_aux else h


_JAX = {}


def _jax(S, with_aux):
    """JAX's per-shard loss, output, aux and gradients (w, b stacked over
    the shards; x's summed over pp) under ``shard_map``."""
    key = (S, with_aux)
    if key not in _JAX:
        ws, bs, x, tgt = (jnp.asarray(a) for a in workers.pipe_inputs(S))
        mesh = Mesh(np.array(jax.devices()[:S]), ("pp",))

        def local(ws, bs, x):
            res = jax_gpipe(lambda p, h: _jax_stage(p, h, with_aux),
                            (ws, bs), x, axis="pp", n_stages=S,
                            with_aux=with_aux)
            y, aux = res if with_aux else (res, jnp.zeros(()))
            y = jax_bcast(y, axis="pp", n_stages=S)
            loss = jnp.mean((y - tgt) ** 2) / S
            if with_aux:
                loss = loss + workers.PIPE_AUX * aux
            return loss, (y, aux)

        def run(ws, bs, x):
            (loss, (y, aux)), g = jax.value_and_grad(
                local, argnums=(0, 1, 2), has_aux=True)(ws, bs, x)
            return (loss[None], y, aux[None], g[0], g[1],
                    jax.lax.psum(g[2], "pp"))

        with mesh:
            out = shard_map(run, mesh=mesh, in_specs=(P("pp"), P("pp"), P()),
                            out_specs=(P("pp"), P(), P("pp"), P("pp"),
                                       P("pp"), P()),
                            check_vma=False)(ws, bs, x)
        _JAX[key] = dict(zip(("loss", "y", "aux", "gw", "gb", "gx"),
                             (np.asarray(a) for a in out)))
    return _JAX[key]


def _sequential(S):
    """The unpipelined model: its output, each stage's summed aux and
    the gradients of the summed loss mean((y - 0.1)²) + 0.3 · Σ aux."""
    ws, bs, x, tgt = (torch.from_numpy(a) for a in workers.pipe_inputs(S))
    ws.requires_grad_()
    bs.requires_grad_()
    x.requires_grad_()
    h, auxes = x, []
    for s in range(S):
        h, a = workers.pipe_stage((ws[s:s + 1], bs[s:s + 1]), h, True)
        # a stage's aux over the microbatches: each microbatch's mean(h²)
        auxes.append((h * h).mean((1, 2)).sum())
    loss = ((h - tgt) ** 2).mean()
    return h, auxes, loss, ws, bs, x


def _by_rank(ranks, S, with_aux):
    outs = [r[(S, with_aux)] for r in ranks]
    return sorted(outs, key=lambda o: o["pp_rank"])[:S] if S > 1 else outs


@pytest.mark.parametrize("with_aux", [False, True])
def test_gpipe_matches_jax_and_the_sequential_model(ranks, with_aux):
    """S 4, 8 microbatches: every rank's replicated output, loss, aux and
    the gradients of its stage's w and b and of x (summed over the
    ranks: zero but on stage 0) against JAX's shard_map and the
    sequential model; the forward under no_grad is the same."""
    S = WORLD
    outs = _by_rank(ranks, S, with_aux)
    want = _jax(S, with_aux)
    h, auxes, loss, ws, bs, x = _sequential(S)
    if with_aux:
        loss = loss + workers.PIPE_AUX * sum(auxes)
    gw, gb, gx = torch.autograd.grad(loss, (ws, bs, x))
    for s, o in enumerate(outs):
        np.testing.assert_allclose(o["y"], want["y"], rtol=0, atol=TOL)
        np.testing.assert_allclose(o["y"], h.detach().numpy(), rtol=0,
                                   atol=TOL)
        np.testing.assert_array_equal(o["y_no_grad"], o["y"])
        np.testing.assert_allclose(o["loss"], want["loss"][s], rtol=0,
                                   atol=TOL)
        if with_aux:
            np.testing.assert_allclose(o["aux"], want["aux"][s], rtol=0,
                                       atol=TOL)
            np.testing.assert_allclose(o["aux"], float(auxes[s].detach()),
                                       rtol=0, atol=TOL)
        for name, g, ref in (("w", o["gw"][0], gw[s]),
                             ("b", o["gb"][0], gb[s])):
            np.testing.assert_allclose(g, want["g" + name][s], rtol=0,
                                       atol=TOL, err_msg=f"stage {s} {name}")
            np.testing.assert_allclose(g, ref.numpy(), rtol=0, atol=TOL,
                                       err_msg=f"stage {s} {name}")
        if s > 0:                     # only stage 0 consumes x
            assert not o["gx"].any()
    np.testing.assert_allclose(outs[0]["gx"], want["gx"], rtol=0, atol=TOL)
    np.testing.assert_allclose(outs[0]["gx"], gx.numpy(), rtol=0, atol=TOL)


def test_gpipe_aux_sums_the_valid_ticks_only(ranks):
    """With aux, each stage's aux is the sum over its n_micro valid ticks
    (JAX masks the bubble ticks; the port runs none): the stages' auxes
    are distinct, and their sum over the pp axis is the sequential
    model's summed aux."""
    outs = _by_rank(ranks, WORLD, True)
    _, auxes, _, _, _, _ = _sequential(WORLD)
    got = [o["aux"] for o in outs]
    assert len(set(got)) == WORLD
    np.testing.assert_allclose(sum(got), float(sum(auxes).detach()),
                               rtol=1e-6)
    np.testing.assert_allclose(sum(got), _jax(WORLD, True)["aux"].sum(),
                               rtol=1e-6)


@pytest.mark.parametrize("with_aux", [False, True])
def test_gpipe_on_one_stage(ranks, with_aux):
    """S 1 (a pp axis of one rank, dp 4): every rank runs the whole model
    over its 8 microbatches, as JAX's gpipe on one device and the
    sequential model."""
    want = _jax(1, with_aux)
    h, auxes, loss, ws, bs, x = _sequential(1)
    if with_aux:
        loss = loss + workers.PIPE_AUX * auxes[0]
    gw, gb, gx = torch.autograd.grad(loss, (ws, bs, x))
    for o in _by_rank(ranks, 1, with_aux):
        np.testing.assert_allclose(o["y"], want["y"], rtol=0, atol=TOL)
        np.testing.assert_allclose(o["y"], h.detach().numpy(), rtol=0,
                                   atol=TOL)
        for g, w, ref in ((o["gw"], want["gw"], gw), (o["gb"], want["gb"],
                                                       gb),
                          (o["gx"], want["gx"], gx)):
            np.testing.assert_allclose(g, w, rtol=0, atol=TOL)
            np.testing.assert_allclose(g, ref.numpy(), rtol=0, atol=TOL)


def test_broadcast_from_last_value_and_gradient(ranks):
    """Rank r holds (r + 1) and the cotangent arange(3) + r: every rank
    gets the last stage's value, and the summed cotangent reaches the last
    stage only, as JAX's mask-and-psum and its transpose."""
    mesh = Mesh(np.array(jax.devices()[:WORLD]), ("pp",))
    v = jnp.repeat(jnp.arange(1.0, WORLD + 1), 3)
    dy = jnp.concatenate([jnp.arange(3.0) + r for r in range(WORLD)])

    def run(v, dy):
        y, vjp = jax.vjp(lambda v: jax_bcast(v, axis="pp", n_stages=WORLD),
                         v)
        return y, vjp(dy)[0]
    with mesh:
        y, g = shard_map(run, mesh=mesh, in_specs=(P("pp"), P("pp")),
                         out_specs=(P("pp"), P("pp")),
                         check_vma=False)(v, dy)
    y, g = np.asarray(y).reshape(WORLD, 3), np.asarray(g).reshape(WORLD, 3)
    for r, o in enumerate(ranks):
        np.testing.assert_array_equal(o["bcast"]["y"], y[r])
        np.testing.assert_array_equal(o["bcast"]["grad"], g[r])
    assert not g[:-1].any() and g[-1].any()


def test_microbatch_round_trip_and_its_error():
    """``microbatch`` splits the batch as JAX's (batch axes 0 and 1),
    ``unmicrobatch`` undoes it; a batch that does not divide raises
    ValueError where JAX asserts."""
    x = np.arange(48.0, dtype=np.float32).reshape(6, 4, 2)
    m = microbatch(torch.from_numpy(x), 3)
    assert tuple(m.shape) == (3, 2, 4, 2)
    np.testing.assert_array_equal(m.numpy(),
                                  np.asarray(jax_microbatch(x, 3)))
    np.testing.assert_array_equal(unmicrobatch(m).numpy(), x)
    np.testing.assert_array_equal(
        microbatch(torch.from_numpy(x), 2, batch_axis=1).numpy(),
        np.asarray(jax_microbatch(x, 2, batch_axis=1)))
    with pytest.raises(ValueError, match="divide"):
        microbatch(torch.from_numpy(x), 4)
    with pytest.raises(ValueError, match="batch_axis"):
        unmicrobatch(m, batch_axis=1)


def test_stage_functions_drive_a_pipeline_in_one_process():
    """``run_stages``/``backprop_stages`` (``stage_forward`` and
    ``stage_backward`` stage by stage in one process, activations handed
    over by tensor, the microbatches backwards in reverse) with aux: the
    output, each stage's aux and every gradient are the sequential
    model's (what ``chip_smoke.py`` runs on the card)."""
    S = WORLD
    ws, bs, x, tgt = (torch.from_numpy(a) for a in workers.pipe_inputs(S))
    stages = [[ws[s:s + 1].clone().requires_grad_(),
               bs[s:s + 1].clone().requires_grad_()] for s in range(S)]
    recs, y, auxes = run_stages(
        lambda p, h: workers.pipe_stage(p, h, True), stages, x,
        with_aux=True)
    y = y.requires_grad_()
    dy, = torch.autograd.grad(((y - tgt) ** 2).mean(), y)
    dx, grads = backprop_stages(recs, stages, dy,
                                torch.tensor(workers.PIPE_AUX))
    h, ref_auxes, ref_loss, rws, rbs, rx = _sequential(S)
    ref_loss = ref_loss + workers.PIPE_AUX * sum(ref_auxes)
    gw, gb, gx = torch.autograd.grad(ref_loss, (rws, rbs, rx))
    np.testing.assert_allclose(y.detach().numpy(), h.detach().numpy(),
                               rtol=0, atol=TOL)
    for s in range(S):
        np.testing.assert_allclose(float(auxes[s]),
                                   float(ref_auxes[s].detach()), rtol=1e-6)
        np.testing.assert_allclose(grads[s][0][0].numpy(), gw[s].numpy(),
                                   rtol=0, atol=TOL)
        np.testing.assert_allclose(grads[s][1][0].numpy(), gb[s].numpy(),
                                   rtol=0, atol=TOL)
    np.testing.assert_allclose(dx.numpy(), gx.numpy(), rtol=0, atol=TOL)
