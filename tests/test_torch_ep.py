"""Expert parallelism (``ep`` > 1) against the JAX package: the MoE layer's
all-to-all, the LM's dp x ep and pp x ep steps, ``convert``'s experts and
the entry point.

Four gloo ranks (``torch_dist_workers.ep_cases``, spawned once for the
file) run the block-sparse MoE layer (8 experts of 32 -> 64 -> 32 at b16,
density 0.6) with its experts split over ep 2 and 4, each rank routing
its own 32 tokens (capacity factor 1.25, where tokens drop, and 8.0,
where none do; k 1 and 2), forward and gradients; JAX's layer runs the
same under ``shard_map`` on four simulated devices.  Then two steps of
the MoE LM (4 experts, top-1, capacity factor 1.25) at dp 2 x ep 2 and
pp 2 x ep 2, the latter with recompute off and on, against JAX's
``make_train_step(mesh=)``; the dp 2 x ep 2
step against the port's dp 4 step (each rank routes the same sequence at
the same capacity either way, so the two compute one function); and the
entry point with ``--pp 2 --ep 2 --moe_experts 2``.

Tolerances (f32): the layer's y, aux and gradients within 1e-5 absolute
of JAX's (the gate's 2e-5: a sum over the tokens of products of the
experts' outputs); the steps as ``test_torch_pp_train.py``.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from blocksparse_tpu.ops import moe as jmoe
from blocksparse_tpu.parallel import make_mesh as jax_make_mesh

from blocksparse_tpu_torch import (SparseTransformerLM, TransformerConfig,
                                   opt_state_from_jax, opt_state_to_jax,
                                   params_from_jax, params_to_jax,
                                   random_jax_params)
from blocksparse_tpu_torch.convert import jax_from_shards
import test_torch_pp_train as ppt
import test_torch_sharded_train as st
import torch_dist_workers as workers
from torch_one_process import run_ep_shards

WORLD = 4
TOL, WG_TOL = 1e-5, 2e-5


@pytest.fixture(scope="module")
def ranks():
    return workers.spawn("ep_cases", WORLD)


def _jax_layer(ep, cf, k):
    """JAX's layer at ep under shard_map (mesh dp x ep over four devices,
    tokens split over both): per rank y, aux and the gradients of its loss
    sum(y·dy) + 0.01·aux, stacked by rank."""
    c = workers.EP_LAYER
    moe = jmoe.BlocksparseMoE(c["E"], c["d"], c["h"], block_size=c["bs"],
                              density=c["density"], capacity_factor=cf, k=k,
                              ep=ep)
    params, x, dy = workers.ep_inputs(WORLD)
    params = {n: jnp.asarray(a) for n, a in params.items()}
    x = jnp.asarray(x.reshape(-1, c["d"]))
    dy = jnp.asarray(dy.reshape(-1, c["d"]))
    mesh = jax_make_mesh(ep=ep, devices=jax.devices()[:WORLD])
    rows = P(("dp", "ep"))

    def run(p, x, dy):
        def loss(p, x):
            y, aux = moe(p, x, ep_axis="ep")
            return jnp.sum(y * dy) + workers.EP_AUX * aux, (y, aux)
        (_, (y, aux)), (gp, gx) = jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True)(p, x)
        return y, aux[None], gx, {n: g[None] for n, g in gp.items()}

    with mesh:
        y, aux, gx, gp = shard_map(
            run, mesh=mesh, in_specs=(moe.param_specs(), rows, rows),
            out_specs=(rows, rows, rows, {n: rows for n in params}),
            check_vma=False)(params, x, dy)
    T = c["T"]
    return {"y": np.asarray(y).reshape(WORLD, T, -1),
            "aux": np.asarray(aux),
            "grads": {"x": np.asarray(gx).reshape(WORLD, T, -1),
                      **{n: np.asarray(g) for n, g in gp.items()}}}


@pytest.mark.parametrize("ep,cf,k", workers.EP_CASES)
def test_moe_layer_matches_jax_under_ep(ranks, ep, cf, k):
    """Each rank's y, aux and gradients (its tokens, the gate's partial,
    its E/ep experts' weights and biases) against JAX's layer under
    shard_map; at capacity factor 1.25 tokens drop; each rank's y
    is also the ep 1 layer's on its own tokens (the routing is per
    rank)."""
    want = _jax_layer(ep, cf, k)
    params, x, _ = workers.ep_inputs(WORLD)
    one = workers.ep_layer(1, cf, k)
    full = {n: torch.from_numpy(a) for n, a in params.items()}
    for rank, o in enumerate(ranks):
        got = o[("layer", ep, cf, k)]
        np.testing.assert_allclose(got["y"], want["y"][rank], rtol=0,
                                   atol=TOL)
        np.testing.assert_allclose(got["aux"], want["aux"][rank], rtol=0,
                                   atol=TOL)
        for name, g in got["grads"].items():
            np.testing.assert_allclose(
                g, want["grads"][name][rank], rtol=0,
                atol=WG_TOL if name == "wg" else TOL,
                err_msg=f"rank {rank} d{name}")
        with torch.no_grad():
            y1, _ = one(full, torch.from_numpy(x[rank]))
        np.testing.assert_allclose(got["y"], y1.numpy(), rtol=0, atol=TOL)
    dropped = any((o[("layer", ep, cf, k)]["y"] == 0).all(-1).any()
                  for o in ranks)
    assert dropped == (cf == 1.25)


@pytest.mark.parametrize("ep,cf,k", workers.EP_CASES)
def test_ep_shards_in_one_process_are_the_ranks(ranks, ep, cf, k):
    """``torch_one_process.run_ep_shards`` (the ranks' routing through
    ``dispatch``/``experts``/``combine``, the all-to-all by slicing,
    each rank's experts; what ``chip_smoke.py`` runs on the card) gives
    the ep group of dp 0 what its ranks computed: each rank's y, aux and
    dx, the gate's gradient summed over the group, and the experts'
    gradients, rank j's the experts it holds."""
    moe = workers.ep_layer(ep, cf, k)
    params, x, dy = workers.ep_inputs(WORLD)
    full = {n: torch.from_numpy(a).requires_grad_() for n, a in
            params.items()}
    xs = [torch.from_numpy(x[r]).requires_grad_() for r in range(ep)]
    outs = run_ep_shards(moe, full, xs)
    loss = sum((y * torch.from_numpy(dy[r])).sum() + workers.EP_AUX * aux
               for r, (y, aux) in enumerate(outs))
    grads = torch.autograd.grad(loss, xs + list(full.values()))
    got = [o[("layer", ep, cf, k)] for o in ranks[:ep]]
    for r in range(ep):
        np.testing.assert_allclose(outs[r][0].detach().numpy(), got[r]["y"],
                                   rtol=0, atol=TOL)
        np.testing.assert_allclose(float(outs[r][1].detach()),
                                   got[r]["aux"], rtol=0, atol=TOL)
        np.testing.assert_allclose(grads[r].numpy(), got[r]["grads"]["x"],
                                   rtol=0, atol=TOL)
    for name, g in zip(full, grads[ep:]):
        want = (sum(o["grads"][name] for o in got) if name == "wg"
                else np.concatenate([o["grads"][name] for o in got]))
        np.testing.assert_allclose(g.numpy(), want, rtol=0,
                                   atol=WG_TOL if name == "wg" else TOL,
                                   err_msg=name)


_JAX = {}


def _jax(name):
    if name not in _JAX:
        dp, pp, ep, fields, batch = workers.EP[name]
        _JAX[name] = ppt.jax_steps(
            dict(workers.EP_BASE, pp=pp, ep=ep, **fields),
            workers.ep_params(), dict(dp=dp, pp=pp, ep=ep),
            *workers.pp_tokens(batch))
    return _JAX[name]


@pytest.mark.parametrize("name", list(workers.EP))
def test_expert_parallel_step_matches_jax(ranks, name):
    """Two steps of the MoE LM at dp 2 x ep 2 and pp 2 x ep 2 (tokens split
    over dp x ep, the experts over ep, the stages over pp), the latter
    also with recompute (the blocks' forwards, all-to-alls included,
    replayed in the stages' backward): metrics, every param and Adam slot
    (the ranks' experts and stages joined) against JAX's sharded step."""
    ppt.check_run(ppt.joined([r[name] for r in ranks], "ep"), _jax(name))


def test_dp_x_ep_step_is_the_dp_step(ranks):
    """ep changes where the experts run, not what is computed: with the
    batch split over dp 2 x ep 2 each rank routes its sequence at the
    capacity of its own tokens, as the dp 4 step's ranks do, so the two
    steps agree (in another order of the experts' gradient sums)."""
    ppt.check_run(ppt.joined([r["dp2_ep2"] for r in ranks], "ep"),
                  ppt.joined([r["dp4"] for r in ranks], "tp"))


def test_entry_point_trains_with_pp_and_ep(ranks):
    """``--pp 2 --ep 2 --moe_experts 2`` on four ranks: two steps, every
    rank the same finite losses."""
    runs = [r["entry"] for r in ranks]
    assert all(len(r["losses"]) == 2 and r["start"] == 0 for r in runs)
    assert all(r["losses"] == runs[0]["losses"] for r in runs)
    assert np.isfinite(runs[0]["losses"]).all()


def test_convert_ep_round_trip_is_bit_for_bit():
    """A JAX pp 2 x ep 2 MoE dict -> each (stage, expert shard)'s piece ->
    the JAX dict, params and an Adam state, bit for bit: rank r holds
    experts [2r, 2r + 2) of each layer's w1, b1, w2, b2 and the whole gate;
    ``random_jax_params`` draws the JAX init's shapes."""
    cfg = dict(workers.EP_BASE, pp=2, ep=2)

    def model():
        return SparseTransformerLM(TransformerConfig(**cfg), device="cpu")
    m0 = model()
    assert tuple(m0.h[0].moe.w1.shape)[0] == 2 and len(m0.h) == 1
    assert tuple(m0.h[0].moe.wg.shape) == (64, 4)
    g = random_jax_params(m0, seed=4)
    init = st.JaxLM(st.JaxConfig(**cfg)).init(jax.random.PRNGKey(0))
    assert jax.tree_util.tree_structure(g) == \
        jax.tree_util.tree_structure(init)
    for a, b in zip(jax.tree_util.tree_leaves(g),
                    jax.tree_util.tree_leaves(init)):
        assert a.shape == b.shape
    state = {"mean": g, "var": jax.tree_util.tree_map(np.square, g),
             "t": np.int32(3)}
    stages = []
    for p in range(2):
        shards, states = [], []
        for e in range(2):
            m = model()
            m.load_state_dict(params_from_jax(g, m, pp_rank=p, ep_rank=e))
            np.testing.assert_array_equal(
                m.h[0].moe.w1.detach().numpy(),
                g["hs"]["moe"]["w1"][p, 2 * e:2 * e + 2])
            shards.append(params_to_jax(m, pp_rank=p))
            states.append(opt_state_to_jax(opt_state_from_jax(
                state, m, pp_rank=p, ep_rank=e), m, pp_rank=p))
        stages.append((jax_from_shards(shards, "ep"),
                       jax_from_shards(states, "ep")))
    back = jax_from_shards([s[0] for s in stages], "pp")
    sback = jax_from_shards([s[1] for s in stages], "pp")
    for got, want in ((back, st._unstack(g)),
                      (sback["mean"], st._unstack(state["mean"])),
                      (sback["var"], st._unstack(state["var"]))):
        assert jax.tree_util.tree_structure(got) == \
            jax.tree_util.tree_structure(want)
        for a, b in zip(jax.tree_util.tree_leaves(got),
                        jax.tree_util.tree_leaves(want)):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="ep_rank"):
        params_from_jax(g, m0, pp_rank=0)
