"""The LM's sharded train step against the JAX package's
``make_train_step(mesh=)``, and ``convert``'s tensor-parallel shards.

Four gloo ranks (``torch_dist_workers.train_cases``, spawned once for the
file) run two steps of the port's sharded step on each mesh of
``torch_dist_workers.TRAIN``: dp 4; dp 2 x tp 2 with a dense MLP and with
a block-sparse one (b16, density 0.5); tp 2 x sp 2 in gather and in ring
mode.  The JAX package runs its sharded step on the same mesh shape on
four simulated devices (``stack_layers=True``: one traced block, which
the port's storage ignores), from the same global params and batch.  The
dp 4, dense tp and sp runs start from one tp-1 draw with ``w_qkv``/
``b_qkv`` in the JAX tp layout, so they compute one function: their
losses agree, and JAX's tp runs report twice the dp run's grad_norm
(ROADMAP F8, which the port reproduces).  Then the entry point with
``--tp 2 --sp 2``.

Tolerances (f32, sums in other orders and over ranks):
- loss, grad_norm, norm_scale: 1e-5 relative; the new loss scale 1e-7;
- Adam's mean slots (the averaged gradients up to the shared norm_scale):
  1e-4 of each tensor's largest entry; the var slots 2e-4;
- parameters after two steps: 1e-5 absolute where the mean slot exceeds
  1e-3 of its tensor's largest; below that the gradient is rounding noise
  whose sign may differ between packages, and Adam moves an element by at
  most lr a step, so there 2·lr a step.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp

from blocksparse_tpu.models import SparseTransformerLM as JaxLM
from blocksparse_tpu.models import TransformerConfig as JaxConfig
from blocksparse_tpu.ops.optimize import AdamOptimizer as JaxAdam
from blocksparse_tpu.parallel import make_mesh as jax_make_mesh

from blocksparse_tpu_torch import (SparseTransformerLM, TransformerConfig,
                                   opt_state_from_jax, opt_state_to_jax,
                                   params_from_jax, params_to_jax,
                                   random_jax_params)
from blocksparse_tpu_torch.convert import jax_from_shards
from blocksparse_tpu_torch.examples import enwik8 as port_enwik8
import torch_dist_workers as workers

WORLD = 4
LR = workers.LR


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The ranks' results, their dropout cases included: one spawn a
    session, shared with ``test_torch_dropout_sharded.py``, which draws
    JAX's masks for them."""
    import test_torch_dropout_sharded as ds
    return workers.shared_spawn("train_cases", WORLD, ds.train_inputs(),
                                workers.session_dir(tmp_path_factory))


def _leaves(tree):
    return jax.tree_util.tree_leaves(tree)


def _unstack(tree):
    """A JAX param-shaped tree with stacked layers (``hs``) as flat
    ``h{l}`` layers."""
    out = {k: v for k, v in tree.items() if k != "hs"}
    n = len(tree["hs"]["ln1_g"])
    for l in range(n):
        out[f"h{l}"] = jax.tree_util.tree_map(lambda a: np.asarray(a)[l],
                                              tree["hs"])
    return out


def _stack(tree):
    layers = [tree[k] for k in sorted(
        (k for k in tree if k.startswith("h") and k[1:].isdigit()),
        key=lambda k: int(k[1:]))]
    out = {k: v for k, v in tree.items() if k not in
           [f"h{l}" for l in range(len(layers))]}
    out["hs"] = jax.tree_util.tree_map(lambda *a: np.stack(a), *layers)
    return out


_JAX = {}


def _jax(name):
    """JAX's two sharded steps of a TRAIN config: per step (loss,
    grad_norm, norm_scale, scale), the params and the Adam state (flat
    layers, NumPy)."""
    if name not in _JAX:
        dp, tp, sp, kw, _ = workers.TRAIN[name]
        cfg = JaxConfig(**dict(workers.TRAIN_BASE, **kw))
        model = JaxLM(cfg)
        optm = JaxAdam(learning_rate=LR)
        params = _stack(workers.train_params(name))
        state = optm.init(params)
        mesh = jax_make_mesh(dp=dp, tp=tp, sp=sp,
                             devices=jax.devices()[:WORLD])
        step = model.make_train_step(optm, mesh=mesh)
        tokens, targets = (jnp.asarray(a.astype(np.int32))
                           for a in workers.train_tokens())
        host = (lambda t: jax.tree_util.tree_map(
            lambda a: jnp.asarray(np.asarray(a)), t))
        scale = jnp.asarray(np.float32(workers.LOSS_SCALE))
        metrics = []
        with mesh:
            for _ in range(workers.STEPS):
                params, state, scale = host((params, state, scale))
                params, state, m, scale = step(params, state, tokens,
                                               targets, scale)
                metrics.append({k: float(v) for k, v in m.items()}
                               | {"scale": float(scale)})
        state = jax.tree_util.tree_map(np.asarray, state)
        _JAX[name] = {"metrics": metrics,
                      "params": _unstack(jax.tree_util.tree_map(
                          np.asarray, params)),
                      "state": {"mean": _unstack(state["mean"]),
                                "var": _unstack(state["var"]),
                                "t": state["t"]}}
    return _JAX[name]


def _port(ranks, name):
    """The port's run of a TRAIN config: rank 0's metrics, and the params
    and Adam state joined from the tp ranks of dp = sp = 0."""
    outs = [r[name] for r in ranks]
    firsts = sorted((o for o in outs if o["coords"]["dp"] == 0
                     and o["coords"]["sp"] == 0),
                    key=lambda o: o["coords"]["tp"])
    return {"metrics": outs[0]["metrics"], "all": outs,
            "params": jax_from_shards([o["params"] for o in firsts]),
            "state": jax_from_shards([o["state"] for o in firsts])}


def _check_tree(got, want, mean):
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(want)
    for (path, g), w, m in zip(
            jax.tree_util.tree_flatten_with_path(got)[0], _leaves(want),
            _leaves(mean)):
        g, w, m = (np.asarray(a, np.float32) for a in (g, w, m))
        assert g.shape == w.shape, path
        big = np.abs(m) > 1e-3 * np.abs(m).max()
        err = np.abs(g - w)
        assert err[big].max(initial=0) <= 1e-5, path
        assert err.max() <= 2 * LR * workers.STEPS + 1e-6, path


@pytest.mark.parametrize("name", list(workers.TRAIN))
def test_sharded_step_matches_jax(ranks, name):
    got, want = _port(ranks, name), _jax(name)
    for mg, mw in zip(got["metrics"], want["metrics"]):
        for k in ("loss", "grad_norm", "norm_scale"):
            np.testing.assert_allclose(mg[k], mw[k], rtol=1e-5, err_msg=k)
        np.testing.assert_allclose(mg["scale"], mw["scale"], rtol=1e-7)
    # every rank reports the same metrics
    for o in got["all"]:
        assert o["metrics"] == got["metrics"]
    assert int(got["state"]["t"]) == int(want["state"]["t"]) == 2
    for slot, tol in (("mean", 1e-4), ("var", 2e-4)):
        for (path, g), w in zip(
                jax.tree_util.tree_flatten_with_path(
                    got["state"][slot])[0],
                _leaves(want["state"][slot])):
            w = np.asarray(w)
            np.testing.assert_allclose(g, w, rtol=0,
                                       atol=tol * np.abs(w).max(),
                                       err_msg=f"{slot} {path}")
    _check_tree(got["params"], want["params"], want["state"]["mean"])


def test_f8_the_tp_step_reports_tp_times_the_true_gradient(ranks):
    """ROADMAP F8: under ``shard_map(check_vma=False)`` the transpose of the
    forward's psum over tp is a psum, so the JAX tp step's gradients are
    tp times the true ones.  From one function (the tp-1 draw, in the tp
    layout), JAX's dp 2 x tp 2 step reports twice the grad_norm of its
    dp 4 step at the same loss, and the port reports JAX's."""
    j1, j2 = _jax("dp4"), _jax("dp2_tp2")
    p1, p2 = _port(ranks, "dp4"), _port(ranks, "dp2_tp2")
    m1, m2 = j1["metrics"][0], j2["metrics"][0]
    np.testing.assert_allclose(m2["loss"], m1["loss"], rtol=1e-6)
    np.testing.assert_allclose(m2["grad_norm"], 2 * m1["grad_norm"],
                               rtol=1e-5)
    np.testing.assert_allclose(p2["metrics"][0]["grad_norm"],
                               m2["grad_norm"], rtol=1e-5)
    np.testing.assert_allclose(p1["metrics"][0]["grad_norm"],
                               m1["grad_norm"], rtol=1e-5)
    # sequence parallelism changes neither the loss nor the factor
    for name in ("tp2_sp2_gather", "tp2_sp2_ring"):
        m = _port(ranks, name)["metrics"][0]
        np.testing.assert_allclose(m["loss"], m1["loss"], rtol=1e-5)
        np.testing.assert_allclose(m["grad_norm"], 2 * m1["grad_norm"],
                                   rtol=1e-5)


def test_sharded_step_on_one_rank_is_the_single_device_step():
    """At world size 1 the sharded step is the single-device step bit for
    bit: a one-rank all-reduce is a copy and the global norm sums its
    squares in the same order (``chip_smoke.py`` holds the same on NCCL
    on the card)."""
    out, = workers.spawn("world1_case", 1)
    assert out["sharded"]["metrics"] == out["single"]["metrics"]
    for k, v in out["single"]["params"].items():
        np.testing.assert_array_equal(out["sharded"]["params"][k], v,
                                      err_msg=k)


def _tp_model(mlp_block_size=0):
    cfg = dict(workers.TRAIN_BASE, tp=2, mlp_block_size=mlp_block_size,
               mlp_density=0.5)
    return SparseTransformerLM(TransformerConfig(**cfg), device="cpu"), cfg


@pytest.mark.parametrize("mlp_block_size", [0, 16])
def test_convert_tp_round_trip_is_bit_for_bit(mlp_block_size):
    """A JAX tp-2 dict -> each rank's shard -> the JAX dict, params and an
    Adam state; and ``random_jax_params`` draws the JAX init's tp-2
    shapes."""
    ranks = [_tp_model(mlp_block_size)[0] for _ in range(2)]
    model, cfg = _tp_model(mlp_block_size)
    g = random_jax_params(model, seed=3)
    init = JaxLM(JaxConfig(**dict(cfg, stack_layers=False))).init(
        jax.random.PRNGKey(0))
    assert jax.tree_util.tree_structure(g) == \
        jax.tree_util.tree_structure(init)
    for a, b in zip(_leaves(g), _leaves(init)):
        assert a.shape == b.shape
    state = {"mean": g, "var": jax.tree_util.tree_map(np.square, g),
             "t": np.int32(5)}
    shards, states = [], []
    for r, m in enumerate(ranks):
        m.load_state_dict(params_from_jax(g, m, tp_rank=r))
        shards.append(params_to_jax(m))
        states.append(opt_state_to_jax(
            opt_state_from_jax(state, m, tp_rank=r), m))
    # rank 1 holds q|k|v columns [96, 192) of the JAX layout, a slice
    np.testing.assert_array_equal(
        ranks[1].h[0].w_qkv.detach().numpy(), g["h0"]["w_qkv"][:, 96:])
    back = jax_from_shards(shards)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(g)
    for a, b in zip(_leaves(back), _leaves(g)):
        np.testing.assert_array_equal(a, b)
    sback = jax_from_shards(states)
    assert int(sback["t"]) == 5
    for a, b in zip(_leaves(sback), _leaves(state)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="tp_rank"):
        params_from_jax(g, model)          # no mesh, no rank: refused


def test_entry_point_trains_with_tp_and_sp(ranks):
    """``--tp 2 --sp 2`` on four ranks: two steps, every rank the same
    finite loss; ``--pp``/``--ep`` 2 in one process exit for lack of
    ranks, as ``--tp`` does (test_torch_ep trains them on four)."""
    runs = [r["entry"] for r in ranks]
    assert all(len(r["losses"]) == 2 and r["start"] == 0 for r in runs)
    assert all(r["losses"] == runs[0]["losses"] for r in runs)
    assert np.isfinite(runs[0]["losses"]).all()
    for flag in ("--pp", "--ep", "--tp"):
        with pytest.raises(SystemExit, match="world size"):
            port_enwik8.build(port_enwik8.parse_args(
                ["--device", "cpu", flag, "2", "--moe_experts", "2"]))
