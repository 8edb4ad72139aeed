"""Residual dropout on the sharded LM against the JAX package's sharded
loss: ``loss_pp``'s dropout under pipeline parallelism, the sequence
shards' own masks, and tp.

The four gloo ranks are the spawns of ``test_torch_sharded_train.py``
(``torch_dist_workers.train_cases``) and ``test_torch_pp_train.py``
(``pp_train_cases``), shared with those files (``shared_spawn``: one
spawn each a session).  This file draws JAX's masks, which the spawns
hand their ranks (``train_inputs``, ``pp_inputs``), and holds the ranks'
``train_dropout`` and ``pp_dropout`` results:

- given JAX's masks, pp 2 x dp 2 (b16 MLP, four layers), pp 2 x dp 2
  with four microbatches and tp 2 x sp 2 in gather and ring mode, the
  port's recompute on and off, against JAX's ``loss(dropout_key=)`` and
  its ``jax.grad`` under ``shard_map`` on four simulated devices (JAX's
  recompute off: the same values), both reduced as the sharded step
  reduces them.  JAX's pipelined loss draws layer g's pair from
  ``split(fold_in(key, g))`` at the microbatch's shape, the same pair for
  every microbatch (ROADMAP F11); its unstacked sp loss from
  ``split(fold_in(key, sp rank), n_layer)``, alike on the tp ranks;
- given a generator seeded alike on every rank: sp shards draw distinct
  masks and tp ranks identical ones; at sp 2 (gather, ring), sp 4, tp 2
  x sp 2 and dp 2 x tp 2 the loss, and at tp 1 the gradients, are the
  unsharded model's from the same seed (the sp shards keep their slices
  of the full context's draw); the
  pipelined loss is the unpipelined loss given the seed's pairs tiled
  over the microbatches (F11), the same twice, at pp 2 x tp 2 too, and
  the MoE LM at pp 2 x ep 2 is the unpipelined ep-1 model's.

In one process: the stages of ``tests/torch_one_process.py`` carrying
their masks, the draw of ``_stage_masks`` and the refusals.

Tolerances (f32, sums in other orders and over ranks), those of
``test_torch_pp_train.py``'s loss: the loss and grad norm 1e-5 relative;
each gradient 1e-5 of its tensor's largest |entry|; masks bit for bit.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import PartitionSpec as P

from blocksparse_tpu.models import SparseTransformerLM as JaxLM
from blocksparse_tpu.models import TransformerConfig as JaxConfig
from blocksparse_tpu.parallel import make_mesh as jax_make_mesh

from blocksparse_tpu_torch import (SparseTransformerLM, TransformerConfig,
                                   params_from_jax)
from blocksparse_tpu_torch.convert import jax_from_shards
from blocksparse_tpu_torch.ops.ewops import uniform
from blocksparse_tpu_torch.ops.transformer import softmax_cross_entropy
from blocksparse_tpu_torch.parallel import microbatch, unmicrobatch
from torch_one_process import backprop_stages, run_stages
import test_torch_sharded_train as st
import torch_dist_workers as workers

torch.set_num_threads(2)
WORLD = 4
TOL, GRAD_TOL = 1e-5, 1e-5
KEY = 11                       # JAX's dropout key, PRNGKey(KEY)
KEEP = 1.0 - workers.DROP


# ----------------------------------------------------------- JAX's masks

def _pair(key, shape):
    k1, k2 = jax.random.split(key)
    return tuple(np.asarray(jax.random.bernoulli(k, p=KEEP, shape=shape))
                 for k in (k1, k2))


def train_inputs():
    """JAX's masks for each DROP_TRAIN config, by sp rank: the unstacked
    ``forward``'s ``split(fold_in(key, sp rank), n_layer)`` (``split(key,
    n_layer)`` without sp), a pair a layer at the rank's residual
    shape."""
    key, out = jax.random.PRNGKey(KEY), {}
    for name in workers.DROP_TRAIN:
        sp = workers.TRAIN[name][2]
        shape = workers.drop_mask_shape(name)
        out[name] = [
            [_pair(k, shape) for k in jax.random.split(
                jax.random.fold_in(key, r) if sp > 1 else key,
                workers.TRAIN_BASE["n_layer"])]
            for r in range(sp)]
    return out


def pp_inputs():
    """JAX's masks for each DROP_PP config: ``_scan_layers``'s
    ``fold_in(key, g)`` for global layer g, a pair at the microbatch's
    shape."""
    key, out = jax.random.PRNGKey(KEY), {}
    for name in workers.DROP_PP:
        n_layer = workers.pp_config(name).n_layer
        out[name] = [_pair(jax.random.fold_in(key, g),
                           workers.drop_mask_shape(name))
                     for g in range(n_layer)]
    return out


@pytest.fixture(scope="module")
def jax_refs():
    """JAX's reduced loss and gradients of every config given masks, made
    before the ranks are asked for (so this work overlaps a spawn that
    another file's worker runs)."""
    out = {}
    for name in workers.DROP_TRAIN:
        dp, tp, sp, kw, _ = workers.TRAIN[name]
        out[name] = jax_sharded(
            dict(workers.TRAIN_BASE, **kw, stack_layers=False,
                 recompute=False, resid_pdrop=workers.DROP),
            workers.train_params(name), dict(dp=dp, tp=tp, sp=sp),
            *workers.train_tokens())
    for name in workers.DROP_PP:
        dp, tp, pp, fields, _, batch = workers.PP[name]
        out[name] = jax_sharded(
            dict(workers.PP_BASE, tp=tp, pp=pp, **fields,
                 resid_pdrop=workers.DROP),
            workers.pp_params(name), dict(dp=dp, tp=tp, pp=pp),
            *workers.pp_tokens(batch))
    return out


@pytest.fixture(scope="module")
def train_ranks(tmp_path_factory):
    return [r["dropout"] for r in workers.shared_spawn(
        "train_cases", WORLD, train_inputs(),
        workers.session_dir(tmp_path_factory))]


@pytest.fixture(scope="module")
def pp_ranks(tmp_path_factory):
    return [r["dropout"] for r in workers.shared_spawn(
        "pp_train_cases", WORLD, pp_inputs(),
        workers.session_dir(tmp_path_factory))]


def jax_sharded(cfg, params, mesh_axes, tokens, targets):
    """JAX's ``loss(dropout_key=PRNGKey(KEY))`` and its gradients under
    ``shard_map`` on a mesh of ``mesh_axes`` (four simulated devices),
    reduced as JAX's sharded step reduces them (``local_step``): (loss,
    grad norm, gradients with flat layers, NumPy)."""
    model = JaxLM(JaxConfig(**cfg))
    c = model.config
    params = st._stack(params) if model.stack else params
    mesh = jax_make_mesh(devices=jax.devices()[:WORLD], **mesh_axes)
    sp_axis = "sp" if c.sp > 1 else None
    pp_axis = "pp" if c.pp > 1 else None
    key = jax.random.PRNGKey(KEY)

    def local(p, tok, tgt):
        loss, g = jax.value_and_grad(lambda p: model.loss(
            p, tok, tgt, tp_axis="tp", sp_axis=sp_axis, pp_axis=pp_axis,
            dropout_key=key))(p)
        g = jax.tree_util.tree_map(
            lambda g, ax: jax.lax.psum(g, ax), g,
            model.grad_reduce_axes(include_sp=sp_axis is not None),
            is_leaf=lambda x: isinstance(x, tuple))
        n = jax.lax.psum(1, "dp")
        if sp_axis:
            n = n * jax.lax.psum(1, "sp")
            loss = jax.lax.pmean(loss, "sp")
        if pp_axis:
            loss = jax.lax.psum(loss, "pp")
        return (jax.lax.pmean(loss, "dp"),
                jax.tree_util.tree_map(lambda g: g / n, g))
    tok = P("dp", "sp") if sp_axis else P("dp", None)
    specs = model.param_specs()
    fn = jax.jit(shard_map(local, mesh=mesh, in_specs=(specs, tok, tok),
                           out_specs=(P(), specs), check_vma=False))
    with mesh:
        loss, grads = fn(params, *(jnp.asarray(a.astype(np.int32))
                                   for a in (tokens, targets)))
    grads = jax.tree_util.tree_map(np.asarray, grads)
    norm = np.sqrt(sum(np.square(g.astype(np.float64)).sum()
                       for g in jax.tree_util.tree_leaves(grads)))
    return float(loss), float(norm), (st._unstack(grads) if model.stack
                                      else grads)


# --------------------------------------------------------------- checks

def joined_grads(outs):
    """The ranks' reduced gradients as the JAX dict: the ranks of dp = sp
    = 0, their tp shards joined, then the pp stages."""
    firsts = [o for o in outs if o["coords"]["dp"] == 0
              and o["coords"]["sp"] == 0]
    stages = [jax_from_shards([o["grads"] for o in sorted(
        (o for o in firsts if o["coords"]["pp"] == s),
        key=lambda o: o["coords"]["tp"])], "tp")
        for s in sorted({o["coords"]["pp"] for o in firsts})]
    return jax_from_shards(stages, "pp")


def close_trees(got, want, what):
    """Every leaf of ``got`` within GRAD_TOL of its ``want`` leaf's largest
    |entry|, the two trees of one structure."""
    got = jax.tree_util.tree_flatten_with_path(got)[0]
    want = jax.tree_util.tree_flatten_with_path(want)[0]
    assert [p for p, _ in got] == [p for p, _ in want], what
    for (path, g), (_, w) in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(np.asarray(g), w, rtol=0,
                                   atol=GRAD_TOL * np.abs(w).max(),
                                   err_msg=f"{what} {path}")


CASES = [(n, r) for n in workers.DROP_PP + workers.DROP_TRAIN
         for r in (True, False)]


@pytest.mark.parametrize("name,recompute", CASES,
                         ids=[f"{n}-recompute_{'on' if r else 'off'}"
                              for n, r in CASES])
def test_dropout_matches_jax_sharded_loss(jax_refs, train_ranks, pp_ranks,
                                          name, recompute):
    """The port's sharded loss given JAX's masks, and its gradients
    reduced as the step reduces them, against JAX's on the same mesh
    shape; every rank reports the same loss."""
    ranks = pp_ranks if name in workers.PP else train_ranks
    outs = [r[(name, recompute)] for r in ranks]
    loss, norm, grads = jax_refs[name]
    for o in outs:
        np.testing.assert_allclose(o["loss"], loss, rtol=TOL)
        assert o["loss"] == outs[0]["loss"]
    np.testing.assert_allclose(outs[0]["grad_norm"], norm, rtol=TOL)
    close_trees(joined_grads(outs), grads, name)


@pytest.mark.parametrize("name", list(workers.DROP_SP))
def test_sp_shards_draw_their_own_masks(train_ranks, name):
    """A generator seeded alike on every rank: the sp shards of one dp
    group draw distinct masks (as JAX's fold-in of the sp index makes
    them), tp ranks identical ones, and each shard's masks are its slice
    of the unsharded model's from the same seed (so they never repeat
    along the context)."""
    dp, tp, sp, _ = workers.DROP_SP[name]
    outs = [r[name] for r in train_ranks]
    L = workers.TRAIN_BASE["ctx"] // sp
    for d in range(dp):
        group = [o for o in outs if o["coords"]["dp"] == d]
        by_sp = {}
        for o in group:
            first = by_sp.setdefault(o["coords"]["sp"], o)
            for a, b in zip(o["masks"], first["masks"]):       # tp ranks
                assert all(np.array_equal(x, y) for x, y in zip(a, b))
        assert sorted(by_sp) == list(range(sp))
        for l in range(workers.TRAIN_BASE["n_layer"]):
            for i in range(2):
                shards = [by_sp[r]["masks"][l][i] for r in range(sp)]
                full = by_sp[0]["ref_masks"][l][i]
                for r in range(sp):
                    np.testing.assert_array_equal(
                        shards[r], full[:, r * L:(r + 1) * L])
                    if r:
                        assert not np.array_equal(shards[r], shards[0]), \
                            (name, d, l, i, r)


@pytest.mark.parametrize("name", list(workers.DROP_SP))
def test_sp_dropout_is_the_unsharded_loss(train_ranks, name):
    """From one seed the sp loss averaged over the shards is the
    unsharded model's on the rank's batch, and at tp 1 so is every
    gradient averaged over sp: the shards drop exactly the units the
    unsharded model drops."""
    for r in train_ranks:
        o = r[name]
        np.testing.assert_allclose(o["loss"], o["ref_loss"], rtol=TOL)
        if "grads" in o:
            assert set(o["grads"]) == set(o["ref_grads"])
            close_trees(o["grads"], o["ref_grads"], name)


@pytest.mark.parametrize("recompute", [True, False],
                         ids=["recompute_on", "recompute_off"])
def test_pipelined_generator_pins_f11(pp_ranks, recompute):
    """ROADMAP F11 pinned: pp 2 x dp 2 with four microbatches and a
    generator gives the unpipelined loss and gradients given the pairs
    that seed draws at the microbatch's shape, tiled over the
    microbatches; one seed gives the same loss twice, and dropout moves
    it."""
    for r in pp_ranks:
        o = r[("gen", "pp2_mb4", recompute)]
        np.testing.assert_allclose(o["loss"], o["ref_loss"], rtol=TOL)
        assert o["again"] == o["loss"]
        assert abs(o["loss"] - o["no_dropout"]) > 10 * TOL * o["loss"]
    first = [r[("gen", "pp2_mb4", recompute)] for r in pp_ranks]
    for d in (0, 1):
        row = sorted((o for o in first if o["coords"]["dp"] == d),
                     key=lambda o: o["coords"]["pp"])
        close_trees(jax_from_shards([o["grads"] for o in row], "pp"),
                    row[0]["ref_grads"], f"dp {d}")


def test_pipelined_generator_composes_with_tp_and_ep(pp_ranks):
    """pp 2 x tp 2 with a generator gives the unpipelined tp-1 loss given
    the seed's tiled pairs; the MoE LM at pp 2 x ep 2 (one microbatch:
    the unpipelined routing) gives the ep-1 unpipelined model's loss,
    aux included, from the same seed, and finite gradients."""
    for r in pp_ranks:
        o = r[("gen", "pp2_tp2", True)]
        np.testing.assert_allclose(o["loss"], o["ref_loss"], rtol=TOL)
        assert o["again"] == o["loss"]
        assert abs(o["loss"] - o["no_dropout"]) > 10 * TOL * o["loss"]
        m = r[("gen", "pp2_ep2")]
        np.testing.assert_allclose(m["loss"], m["ref_loss"], rtol=TOL)
        assert m["finite"]
        assert abs(m["loss"] - m["no_dropout"]) > 10 * TOL * m["loss"]


# -------------------------------------------------------- one process

def _pp_model(recompute=True):
    cfg = dict(workers.PP_BASE, resid_pdrop=workers.DROP,
               recompute=recompute)
    model = SparseTransformerLM(TransformerConfig(**cfg), device="cpu")
    model.load_state_dict(params_from_jax(workers.pp_params("pp2_mb4"),
                                          model))
    return model


@pytest.mark.parametrize("recompute", [True, False],
                         ids=["recompute_on", "recompute_off"])
def test_stages_in_one_process_carry_their_masks(recompute):
    """The pipeline's stages run in turn in one process
    (``run_stages``/``backprop_stages``, as ``chip_smoke.py`` runs them),
    each carrying its layers' pairs as (layers, masks): the loss and
    every stage gradient are the unpipelined model's given the pairs tiled
    over the microbatches; the backward sees the forward's masks with
    recompute on and off."""
    model = _pp_model(recompute)
    tokens, targets = (torch.from_numpy(a[:4]) for a in workers.pp_tokens(8))
    n_micro = 4
    xm = microbatch(model._embed(tokens, model.wpe[None, :tokens.shape[1]]),
                    n_micro)
    masks = model._stage_masks(torch.Generator().manual_seed(5),
                               xm.shape[1:], "cpu")
    stages = [(model.h[s:s + 1], masks[s:s + 1]) for s in range(2)]
    recs, ym, _ = run_stages(model._stage, stages, xm, with_aux=True)
    ym.requires_grad_()
    loss = softmax_cross_entropy(model._logits(unmicrobatch(ym)),
                                 targets).mean()
    dym, = torch.autograd.grad(loss, [ym])
    _, grads = backprop_stages(recs, stages, dym)
    tiled = [tuple(m.repeat(n_micro, 1, 1) for m in p) for p in masks]
    names, params = zip(*model.named_parameters())
    ref = model.loss(tokens, targets, dropout=tiled)
    ref_grads = dict(zip(names, torch.autograd.grad(ref, params)))
    plain = dict(zip(names, torch.autograd.grad(model.loss(tokens, targets),
                                                params)))
    np.testing.assert_allclose(loss.item(), ref.item(), rtol=TOL)
    w = ref_grads["h.1.w_out"]      # dropout moves it far past GRAD_TOL
    assert (w - plain["h.1.w_out"]).abs().max() > 100 * GRAD_TOL * \
        w.abs().max()
    for s in range(2):
        assert len(grads[s]) == len(list(model.h[s].parameters()))
        for (n, _), g in zip(model.h[s].named_parameters(), grads[s]):
            want = ref_grads[f"h.{s}.{n}"]
            np.testing.assert_allclose(
                g.numpy(), want.numpy(), rtol=0,
                atol=GRAD_TOL * want.abs().max().item(), err_msg=n)


def test_stage_masks_are_a_slice_of_one_draw():
    """``_stage_masks``: a pp 2 stage's pairs are its layers' of one draw
    of all n_layer layers in order, the unpipelined model's (so a layer's
    masks do not depend on pp); a list gives its stage's pairs, and one
    of another length is refused; no source or resid_pdrop 0 gives
    None."""
    def lm(pp):
        return SparseTransformerLM(TransformerConfig(**dict(
            workers.PP_BASE, n_layer=4, pp=pp, resid_pdrop=workers.DROP)),
            device="cpu")
    stage = lm(2)
    shape = (2, 16, stage.config.n_embd)
    every = lm(1)._stage_masks(torch.Generator().manual_seed(1), shape,
                               "cpu")
    assert len(every) == 4
    for layer0 in (0, 2):
        got = stage._stage_masks(torch.Generator().manual_seed(1), shape,
                                 "cpu", layer0)
        assert len(got) == 2
        for a, b in zip(got, every[layer0:layer0 + 2]):
            assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert stage._stage_masks(every, shape, "cpu", 2) == every[2:]
    with pytest.raises(ValueError, match="one a layer"):
        stage._stage_masks(every[:3], shape, "cpu")
    assert stage._stage_masks(None, shape, "cpu") is None
    stage.config.resid_pdrop = 0.0
    assert stage._stage_masks(every, shape, "cpu") is None


def test_unsharded_generator_draw_is_unchanged():
    """Without sp a generator's masks are drawn as before sp shards drew
    their slices: U[0, 1) < keep at the residual's shape, two a layer in
    order, bit for bit."""
    model = _pp_model()
    shape = (2, 32, model.config.n_embd)
    g, h = (torch.Generator().manual_seed(4) for _ in range(2))
    for l in range(2):
        got = model._dropout_masks(g, l, shape, "cpu")
        for m in got:
            assert torch.equal(m, uniform(shape, "cpu", h) < KEEP)


def test_pp_with_sp_stays_refused():
    """pp x sp stays refused, as in the JAX package."""
    with pytest.raises(ValueError, match="pp x sp"):
        SparseTransformerLM(TransformerConfig(**dict(
            workers.PP_BASE, pp=2, sp=2)), device="cpu")
