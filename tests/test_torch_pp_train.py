"""The LM's pipelined train step (``pp`` > 1, ``loss_pp``) against the JAX
package's ``make_train_step(mesh=)``, and ``convert``'s pipeline stages.

Four gloo ranks (``torch_dist_workers.pp_train_cases``, spawned once for
the file) run two steps of the port's sharded step on each mesh of
``torch_dist_workers.PP``: pp 2 x dp 2 with a block-sparse MLP (b16,
density 0.5, four layers: two a stage), pp 2 x dp 2 with four
microbatches (``pp_microbatch``), and pp 2 x tp 2.  The JAX package runs
its sharded step on the same mesh shape on four simulated devices from
the same global params and batch.  The last two start from one dense
draw (in the JAX tp layout for tp 2) and one batch, so they compute one
function: ROADMAP F8 passes through the pipeline, the pp 2 x tp 2 step
reporting the grad_norm of the port's tp 2 step without a pipeline, twice
the single-device step's.

Tolerances (f32, sums in other orders and over ranks), those of
``test_torch_sharded_train.py``:
- loss, grad_norm, norm_scale: 1e-5 relative; the new loss scale 1e-7;
- Adam's mean slots 1e-4 of each tensor's largest entry, var slots 2e-4;
- parameters after two steps: 1e-5 absolute where the mean slot exceeds
  1e-3 of its tensor's largest, 2·lr a step elsewhere (rounding noise
  whose sign may differ, which Adam turns into a step of up to lr).
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
import test_torch_sharded_train as st
import torch_dist_workers as workers

WORLD = 4


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The ranks' results, their dropout cases included: one spawn a
    session, shared with ``test_torch_dropout_sharded.py``, which draws
    JAX's masks for them."""
    import test_torch_dropout_sharded as ds
    return workers.shared_spawn("pp_train_cases", WORLD, ds.pp_inputs(),
                                workers.session_dir(tmp_path_factory))


_JAX = {}


def jax_steps(cfg, params, mesh_axes, tokens, targets):
    """JAX's two sharded steps of ``cfg`` (a config dict) from the flat
    global ``params`` on a mesh of ``mesh_axes``: per step (loss,
    grad_norm, norm_scale, scale), the params and the Adam state (flat
    layers, NumPy)."""
    model = JaxLM(JaxConfig(**cfg))
    optm = JaxAdam(learning_rate=workers.LR)
    params = st._stack(params) if model.stack else params
    state = optm.init(params)
    mesh = jax_make_mesh(devices=jax.devices()[:WORLD], **mesh_axes)
    step = model.make_train_step(optm, mesh=mesh)
    tokens, targets = (jnp.asarray(a.astype(np.int32))
                       for a in (tokens, targets))
    host = (lambda t: jax.tree_util.tree_map(
        lambda a: jnp.asarray(np.asarray(a)), t))
    scale = jnp.asarray(np.float32(workers.LOSS_SCALE))
    metrics = []
    with mesh:
        for _ in range(workers.STEPS):
            params, state, scale = host((params, state, scale))
            params, state, m, scale = step(params, state, tokens, targets,
                                           scale)
            metrics.append({k: float(v) for k, v in m.items()}
                           | {"scale": float(scale)})
    flat = ((lambda t: st._unstack(t)) if model.stack else (lambda t: t))
    state = jax.tree_util.tree_map(np.asarray, state)
    return {"metrics": metrics,
            "params": flat(jax.tree_util.tree_map(np.asarray, params)),
            "state": {"mean": flat(state["mean"]),
                      "var": flat(state["var"]), "t": state["t"]}}


def _jax(name):
    if name not in _JAX:
        dp, tp, pp, fields, _, batch = workers.PP[name]
        _JAX[name] = jax_steps(
            dict(workers.PP_BASE, tp=tp, pp=pp, **fields),
            workers.pp_params(name), dict(dp=dp, tp=tp, pp=pp),
            *workers.pp_tokens(batch))
    return _JAX[name]


def joined(outs, inner):
    """The port's run on the ranks of dp = 0 (and ep = 0 unless ``inner``
    is "ep"), joined into the JAX layout: each pp stage's ``inner`` ranks
    first, then the stages.  Rank 0's metrics, and every rank's."""
    firsts = [o for o in outs if o["coords"]["dp"] == 0
              and (inner == "ep" or o["coords"]["ep"] == 0)
              and (inner == "tp" or o["coords"]["tp"] == 0)]
    stages = []
    for s in sorted({o["coords"]["pp"] for o in firsts}):
        row = sorted((o for o in firsts if o["coords"]["pp"] == s),
                     key=lambda o: o["coords"][inner])
        stages.append({k: jax_from_shards([o[k] for o in row], inner)
                       for k in ("params", "state")})
    return {"metrics": outs[0]["metrics"], "all": outs,
            **{k: jax_from_shards([s[k] for s in stages], "pp")
               for k in ("params", "state")}}


def check_run(got, want):
    """The port's joined run against JAX's, at the module's tolerances."""
    for mg, mw in zip(got["metrics"], want["metrics"]):
        for k in ("loss", "grad_norm", "norm_scale"):
            np.testing.assert_allclose(mg[k], mw[k], rtol=1e-5, err_msg=k)
        np.testing.assert_allclose(mg["scale"], mw["scale"], rtol=1e-7)
    for o in got["all"]:                      # every rank: the same metrics
        assert o["metrics"] == got["metrics"]
    assert int(got["state"]["t"]) == int(want["state"]["t"]) == 2
    for slot, tol in (("mean", 1e-4), ("var", 2e-4)):
        for (path, g), w in zip(
                jax.tree_util.tree_flatten_with_path(
                    got["state"][slot])[0],
                jax.tree_util.tree_leaves(want["state"][slot])):
            w = np.asarray(w)
            np.testing.assert_allclose(g, w, rtol=0,
                                       atol=tol * np.abs(w).max(),
                                       err_msg=f"{slot} {path}")
    st._check_tree(got["params"], want["params"], want["state"]["mean"])


@pytest.mark.parametrize("name", list(workers.PP))
def test_pipelined_step_matches_jax(ranks, name):
    """Two steps: loss, grad_norm, norm_scale and the loss scale each step,
    and every param and Adam slot after (the stages' layers joined to the
    JAX layout), against JAX's sharded step on the same mesh shape."""
    check_run(joined([r[name] for r in ranks], "tp"), _jax(name))


def test_f8_passes_through_the_pipeline(ranks):
    """ROADMAP F8 through the pipeline: from one function and one batch,
    the pp 2 x tp 2 step reports the grad_norm of the port's tp 2 x dp 2
    step (no pipeline), which is twice the single-device step's; the pp 2
    x dp 2 step with four microbatches reports the single-device one.
    All at the single-device loss, and the pp 2 x tp 2 grad_norm is
    JAX's."""
    single = ranks[0]["single"][0]
    pp_tp = ranks[0]["pp2_tp2"]["metrics"][0]
    tp = ranks[0]["tp2_dp2"]["metrics"][0]
    pp_mb = ranks[0]["pp2_mb4"]["metrics"][0]
    for m in (pp_tp, tp, pp_mb):
        np.testing.assert_allclose(m["loss"], single["loss"], rtol=1e-5)
    np.testing.assert_allclose(pp_tp["grad_norm"], tp["grad_norm"],
                               rtol=1e-5)
    np.testing.assert_allclose(pp_tp["grad_norm"], 2 * single["grad_norm"],
                               rtol=1e-5)
    np.testing.assert_allclose(pp_mb["grad_norm"], single["grad_norm"],
                               rtol=1e-5)
    np.testing.assert_allclose(pp_tp["grad_norm"],
                               _jax("pp2_tp2")["metrics"][0]["grad_norm"],
                               rtol=1e-5)


def _pp_model(**kw):
    cfg = dict(workers.PP_BASE, pp=2, mlp_block_size=16, mlp_density=0.5,
               n_layer=4, **kw)
    return SparseTransformerLM(TransformerConfig(**cfg), device="cpu"), cfg


@pytest.mark.parametrize("tp", [1, 2])
def test_convert_pp_round_trip_is_bit_for_bit(tp):
    """A JAX pp-2 dict (stacked ``hs``, as the JAX init's) -> each stage's
    layers -> the JAX dict (flat layers), params and an Adam state, bit
    for bit; with tp 2 each stage's tp shards joined first.  A stage holds
    n_layer/pp blocks, and an unbound model needs its pp rank."""
    model, cfg = _pp_model(tp=tp)
    assert len(model.h) == 2 and model.n_local == 2
    g = random_jax_params(model, seed=3)
    init = JaxLM(JaxConfig(**cfg)).init(jax.random.PRNGKey(0))
    assert jax.tree_util.tree_structure(g) == \
        jax.tree_util.tree_structure(init)
    for a, b in zip(jax.tree_util.tree_leaves(g),
                    jax.tree_util.tree_leaves(init)):
        assert a.shape == b.shape
    state = {"mean": g, "var": jax.tree_util.tree_map(np.square, g),
             "t": np.int32(5)}
    stages = []
    for p in range(2):
        shards, states = [], []
        for r in range(tp):
            m = _pp_model(tp=tp)[0]
            m.load_state_dict(params_from_jax(g, m, tp_rank=r, pp_rank=p))
            shards.append(params_to_jax(m, pp_rank=p))
            states.append(opt_state_to_jax(opt_state_from_jax(
                state, m, tp_rank=r, pp_rank=p), m, pp_rank=p))
        stages.append((jax_from_shards(shards), jax_from_shards(states)))
    back = jax_from_shards([s[0] for s in stages], "pp")
    sback = jax_from_shards([s[1] for s in stages], "pp")
    want = st._unstack(g)
    assert sorted(back) == sorted(want)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(a, b)
    assert int(sback["t"]) == 5
    for slot in ("mean", "var"):
        for a, b in zip(jax.tree_util.tree_leaves(sback[slot]),
                        jax.tree_util.tree_leaves(
                            st._unstack(state[slot]))):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="pp_rank"):
        params_from_jax(g, model, tp_rank=0)
