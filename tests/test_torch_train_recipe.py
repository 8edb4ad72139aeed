"""The training recipe around the port's train step, against the JAX
package: residual dropout in ``loss``, the train step with 16-bit Adam
slots, F3 (the train step applies no dropout), checkpoints, profiling and
the enwik8 entry point.

The LM here has one head of 144 (hs > 128), so both packages take the
unfused attention ops on their plain XLA/PyTorch paths (no Pallas
interpretation): the same function either way.

Tolerances (f32, sums in other orders):
- loss, grad_norm: 1e-5 relative; every gradient (and, after one step
  from zero state, every f32 mean slot): 1e-4 of its tensor's largest;
- 16-bit slots: as their f32 values, plus one step of their own grid
  (2^-7 relative for bf16, 2^-9 for packed16);
- parameters after a step: 1e-5 where the gradient is above 1e-3 of its
  tensor's largest, else 2 lr (Adam's first step moves by at most lr,
  and a noise-level gradient may flip sign between packages);
- dropout on and off, recompute on and off, save and restore, the same
  step twice on the CPU: bit for bit;
- the entry point's data stream: the JAX example's bytes, bit for bit.
"""
import importlib.util
import os
import pickle

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from blocksparse_tpu.models import SparseTransformerLM as JaxLM
from blocksparse_tpu.models import TransformerConfig as JaxConfig
from blocksparse_tpu.ops import optimize as jax_opt

import blocksparse_tpu_torch as bt
from blocksparse_tpu_torch.examples import enwik8 as port_enwik8

torch.set_num_threads(2)
TOL, GRAD_TOL, LR = 1e-5, 1e-4, 1e-3
WIDE1 = dict(n_vocab=32, n_embd=144, n_layer=2, n_head=1, ctx=32,
             blk_size=16, attn_layout="fixed", local_blocks=2, mlp_ratio=2,
             mlp_block_size=0, dtype="float32", resid_pdrop=0.1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _setup(recompute=True, seed=1, **kw):
    cfg = dict(WIDE1, recompute=recompute, **kw)
    jm = JaxLM(JaxConfig(**cfg))
    params = _np(jm.init(jax.random.PRNGKey(seed)))
    port = bt.SparseTransformerLM(bt.TransformerConfig(**cfg), device="cpu")
    port.load_state_dict(bt.params_from_jax(params, port))
    rng = np.random.RandomState(seed)
    tokens, targets = (rng.randint(0, 32, (2, 32)).astype(np.int32)
                       for _ in range(2))
    return jm, params, port, tokens, targets


def _jax_masks(key, n_layer, shape, keep):
    """The masks the JAX ``forward`` draws from ``dropout_key=key``: a key
    a layer (``split``), two a block (``split`` again), each a bernoulli
    of the residual's shape (``_block``)."""
    out = []
    for k in jax.random.split(key, n_layer):
        k1, k2 = jax.random.split(k)
        out.append(tuple(
            torch.from_numpy(np.asarray(jax.random.bernoulli(
                kk, p=keep, shape=shape))) for kk in (k1, k2)))
    return out


def _grads(port, tokens, targets, dropout=None):
    names, params = zip(*port.named_parameters())
    loss = port.loss(torch.from_numpy(tokens).long(),
                     torch.from_numpy(targets).long(), dropout=dropout)
    return loss, dict(zip(names, torch.autograd.grad(loss, params)))


def _close_grads(got, want_tree, port):
    for name, want in bt.params_from_jax(_np(want_tree), port).items():
        np.testing.assert_allclose(got[name].numpy(), want.numpy(), rtol=0,
                                   atol=GRAD_TOL * want.abs().max().item(),
                                   err_msg=name)


def test_dropout_loss_and_grads_match_jax_with_recompute_on_and_off():
    """JAX ``loss(dropout_key=k)`` and its gradients against the port's
    ``loss`` given the masks that key draws; the port's recompute on and
    off agree bit for bit (masks drawn outside each checkpoint)."""
    jm, params, port, tokens, targets = _setup(recompute=True)
    key = jax.random.PRNGKey(7)
    ref, jg = jax.value_and_grad(lambda p: jm.loss(
        p, jnp.asarray(tokens), jnp.asarray(targets), dropout_key=key))(
            jax.tree_util.tree_map(jnp.asarray, params))
    masks = _jax_masks(key, WIDE1["n_layer"], (2, 32, 144), 0.9)
    loss_on, g_on = _grads(port, tokens, targets, masks)
    np.testing.assert_allclose(float(loss_on), float(ref), rtol=TOL)
    _close_grads(g_on, jg, port)
    port.config.recompute = False
    loss_off, g_off = _grads(port, tokens, targets, masks)
    assert torch.equal(loss_off, loss_on)
    assert all(torch.equal(g_off[k], g_on[k]) for k in g_on)
    plain, _ = _grads(port, tokens, targets)
    no_drop = jm.loss(jax.tree_util.tree_map(jnp.asarray, params),
                      jnp.asarray(tokens), jnp.asarray(targets))
    np.testing.assert_allclose(float(plain), float(no_drop), rtol=TOL)
    assert abs(float(plain) - float(loss_on)) > 1e-3


def test_dropout_generator_draws_outside_the_checkpoint():
    """A generator seed gives the same loss twice, and the same gradients
    with recompute on and off."""
    _, _, port, tokens, targets = _setup()
    runs = []
    for recompute in (True, True, False):
        port.config.recompute = recompute
        runs.append(_grads(port, tokens, targets,
                           torch.Generator().manual_seed(3)))
    (l0, g0), (l1, _), (l2, g2) = runs
    assert torch.equal(l0, l1) and torch.equal(l0, l2)
    assert all(torch.equal(g0[k], g2[k]) for k in g0)


@pytest.mark.parametrize("fmt", ["bfloat16", "packed16"])
def test_train_step_with_16_bit_slots_matches_jax(fmt):
    """One make_train_step with 16-bit Adam slots against JAX's.  Both
    configs carry resid_pdrop 0.1 and neither step drops (F3): the JAX
    step's loss equals the dropout-free loss, and the port's step with
    resid_pdrop 0.1 equals its step with 0 bit for bit."""
    jm, params, port, tokens, targets = _setup(seed=2)
    make = dict(learning_rate=LR, zero_nans=True, zero_infs=True,
                state_format=fmt)
    ref_opt = jax_opt.AdamOptimizer(**make)
    state0 = ref_opt.init(params)
    rp, rs, rm, rsc = jm.make_train_step(ref_opt)(
        params, state0, jnp.asarray(tokens), jnp.asarray(targets),
        jnp.asarray(1024.0))
    no_drop = jm.loss(params, jnp.asarray(tokens), jnp.asarray(targets))
    np.testing.assert_allclose(float(rm["loss"]), float(no_drop), rtol=TOL)

    step = port.make_train_step(bt.AdamOptimizer(**make))
    ps, pm, psc = step(bt.opt_state_from_jax(_np(state0), port),
                       torch.from_numpy(tokens).long(),
                       torch.from_numpy(targets).long(), 1024.0)
    for k in ("loss", "grad_norm", "norm_scale"):
        np.testing.assert_allclose(float(pm[k]), float(rm[k]), rtol=TOL,
                                   err_msg=k)
    assert float(psc) == float(rsc)
    want_state = bt.opt_state_from_jax(_np(rs), port)
    grid = 2.0 ** (-7 if fmt == "bfloat16" else -9)
    unpack = {"mean": bt.mhalf_unpack, "var": bt.vhalf_unpack}
    for slot in ("mean", "var"):
        for name, want in want_state[slot].items():
            got = ps[slot][name]
            assert got.dtype == want.dtype, name
            if got.dtype == torch.uint16:
                got, want = unpack[slot](got), unpack[slot](want)
            got, want = got.float(), want.float()
            tol = GRAD_TOL * want.abs().max() + grid * want.abs()
            assert ((got - want).abs() <= tol).all(), (slot, name)
    assert ps["mean"]["h.0.w_qkv"].dtype != torch.float32
    want_p = bt.params_from_jax(_np(rp), port)
    for name, got in port.state_dict().items():
        m = want_state["mean"][name]
        m = (bt.mhalf_unpack(m) if m.dtype == torch.uint16 else m).float()
        live = m.abs() > 1e-3 * m.abs().max()
        diff = (got - want_p[name]).abs()
        assert diff[live].max() <= TOL and diff.max() <= 2 * LR + TOL, name

    # F3: the same step on the same model with resid_pdrop 0
    twin = bt.SparseTransformerLM(bt.TransformerConfig(
        **dict(WIDE1, resid_pdrop=0.0)), device="cpu")
    twin.load_state_dict(bt.params_from_jax(params, twin))
    ts, tm, tsc = twin.make_train_step(bt.AdamOptimizer(**make))(
        bt.opt_state_from_jax(_np(state0), twin),
        torch.from_numpy(tokens).long(), torch.from_numpy(targets).long(),
        1024.0)
    assert all(torch.equal(tm[k], pm[k]) for k in pm)
    assert torch.equal(tsc, psc)
    for name, p in twin.state_dict().items():
        assert torch.equal(p, port.state_dict()[name]), name
        for slot in ("mean", "var"):
            assert torch.equal(ts[slot][name], ps[slot][name])


def _tiny(fmt="packed16"):
    cfg = bt.TransformerConfig(n_vocab=64, n_embd=64, n_layer=2, n_head=4,
                               ctx=64, blk_size=16, mlp_block_size=16,
                               mlp_density=0.5, dtype="float32")
    model = bt.SparseTransformerLM(cfg, device="cpu")
    model.load_state_dict(bt.params_from_jax(bt.random_jax_params(model, 3),
                                             model))
    opt = bt.AdamOptimizer(learning_rate=LR, state_format=fmt)
    return cfg, model, opt


def test_checkpoint_round_trip_resumes_bit_for_bit(tmp_path):
    """Save after a step (packed16 slots, a bf16 EMA, a tensor loss scale,
    the layouts); restore into a fresh model; the restored trees equal the
    saved ones bit for bit and the next step equals the uninterrupted
    run's next step bit for bit."""
    cfg, model, opt = _tiny()
    ema = bt.Ema(fp16=True)
    step = model.make_train_step(opt)
    rng = np.random.RandomState(4)
    batches = [tuple(torch.from_numpy(rng.randint(0, 64, (2, 64))).long()
                     for _ in range(2)) for _ in range(2)]
    state = opt.init(dict(model.named_parameters()))
    state, _, scale = step(state, *batches[0], torch.tensor(1024.0))
    ema_state = ema.apply(dict(model.named_parameters()),
                          ema.init(dict(model.named_parameters())))
    layouts = {"bsmm1": model.bsmm1.layout,
               "bst": model.bst.__getstate__()["layout"]}
    bt.checkpoint.save(tmp_path / "ck", model.state_dict(), opt_state=state,
                       ema_state=ema_state, step=1, loss_scale=scale,
                       layouts=layouts, config=vars(cfg))
    with open(tmp_path / "ck" / "meta.pkl", "rb") as f:
        assert set(pickle.load(f)) == {"step", "layouts", "config"}
    tree, meta = bt.checkpoint.restore(tmp_path / "ck")
    assert meta["step"] == 1 and meta["config"] == vars(cfg)
    for k, lay in layouts.items():
        np.testing.assert_array_equal(meta["layouts"][k], lay)

    def same(a, b):
        if isinstance(a, dict):
            assert a.keys() == b.keys()
            for k in a:
                same(a[k], b[k])
        else:
            assert a.dtype == b.dtype and torch.equal(a, b)
    same(tree["params"], model.state_dict())
    same(tree["opt_state"], state)
    same(tree["ema_state"], ema_state)
    same(tree["loss_scale"], scale)
    assert tree["opt_state"]["mean"]["h.0.w_qkv"].dtype == torch.uint16

    _, fresh, _ = _tiny()
    fresh.load_state_dict(tree["params"])
    s2, m2, sc2 = fresh.make_train_step(opt)(
        tree["opt_state"], *batches[1], tree["loss_scale"])
    s1, m1, sc1 = step(state, *batches[1], scale)
    assert all(torch.equal(m1[k], m2[k]) for k in m1)
    assert torch.equal(sc1, sc2)
    same(fresh.state_dict(), model.state_dict())
    same(s2, s1)


def _jax_example():
    spec = importlib.util.spec_from_file_location(
        "jax_enwik8_example", os.path.join(ROOT, "examples", "enwik8.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_entry_point_data_stream_matches_the_jax_example(tmp_path):
    jex = _jax_example()
    for path in (None, str(tmp_path / "missing"), str(tmp_path / "bytes")):
        if path and path.endswith("bytes"):
            (tmp_path / "bytes").write_bytes(
                np.random.RandomState(2).bytes(30000))
        got = port_enwik8.load_data(path, 20000, 3000)
        want = jex.load_data(path, 20000, 3000)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        it_p = port_enwik8.batch_iter(got[0], 3, 48,
                                      np.random.RandomState(1))
        it_j = jex.batch_iter(want[0], 3, 48, np.random.RandomState(1))
        for _ in range(4):
            for a, b in zip(next(it_p), next(it_j)):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)


SMALL = ["--device", "cpu", "--n_ctx", "64", "--n_embd", "64", "--n_layer",
         "2", "--n_head", "4", "--blk_size", "16", "--n_batch", "2",
         "--mlp_block_size", "16",
         "--mlp_density", "0.5", "--lr", "3e-3"]


def test_entry_point_trains_checkpoints_and_resumes_on_the_cpu(tmp_path,
                                                              capsys):
    ck = str(tmp_path / "ck")
    args = port_enwik8.parse_args(SMALL + [
        "--n_iter", "3", "--ckpt_dir", ck, "--ckpt_every", "2",
        "--eval_every", "3"])
    out = port_enwik8.train(args)
    assert len(out["losses"]) == 3 and np.isfinite(out["losses"]).all()
    assert out["eval"] and out["eval"][0][0] == 3
    text = capsys.readouterr().out
    assert "step     0 loss" in text and "eval bits/byte" in text
    tree, meta = bt.checkpoint.restore(ck)
    assert meta["step"] == 2 and meta["config"]["n_iter"] == 3
    # resume: from step 2, the batch iterator started over (as the JAX
    # example does): step 2 runs on the first batch
    resumed = port_enwik8.train(port_enwik8.parse_args(SMALL + [
        "--n_iter", "3", "--ckpt_dir", ck, "--resume"]))
    assert resumed["start"] == 2 and len(resumed["losses"]) == 1
    assert "resumed from step 2" in capsys.readouterr().out
    # profile: one more step under torch.profiler, then stop
    trace_dir = str(tmp_path / "trace")
    prof = port_enwik8.train(port_enwik8.parse_args(SMALL + [
        "--n_iter", "5", "--profile", "1", "--trace_dir", trace_dir]))
    assert len(prof["losses"]) == 2
    assert os.path.exists(os.path.join(trace_dir, "trace.json"))
    # --tp/--sp/--pp/--ep shard over the ranks of a run
    # (test_torch_sharded_train trains --tp 2 --sp 2 on four,
    # test_torch_ep --pp 2 --ep 2): one process has too few
    for flag in ("--tp", "--sp", "--pp", "--ep"):
        with pytest.raises(SystemExit, match="world size"):
            port_enwik8.build(port_enwik8.parse_args(SMALL + [
                flag, "2", "--moe_experts", "2"]))
    # MoE builds, its experts at b32 as the JAX example forces
    cfg, model, _, _ = port_enwik8.build(port_enwik8.parse_args(
        SMALL + ["--moe_experts", "2"]))
    assert (cfg.moe_experts, cfg.mlp_block_size) == (2, 32)
    assert model.moe.bsmm1.bsize == 32


def test_profiling_on_the_cpu_is_host_time_and_reports_no_device():
    x = torch.ones(64, 64)
    with bt.profiling.Benchmark("mm", flops=2 * 64 ** 3, device="cpu") as b:
        x @ x
    assert b.ms >= 0
    s = bt.profiling.bench_op(lambda a, w: torch.tanh(a @ w), x,
                              torch.eye(64), iters=3)
    assert s > 0
    if not torch.cuda.is_available():
        assert bt.profiling.memory_analysis(lambda a: a @ a, x) is None
        assert bt.profiling.live_buffers() == {"per_device": {},
                                               "total_bytes": 0}


def test_checkpoint_matches_the_jax_checkpoint(tmp_path):
    """The same params, Adam state, step, loss scale, layouts and config
    saved by both packages: the metadata equal, and what the port
    restores equal bit for bit to what the JAX package restores, through
    the converters."""
    from blocksparse_tpu import checkpoint as jax_ck
    jm, params, port, _, _ = _setup(seed=3)
    opt = jax_opt.AdamOptimizer(state_format="bfloat16")
    state = _np(opt.init(params))
    layouts = {"attn": np.eye(2, dtype=np.int32)}
    config = {"n_iter": 3}
    jax_ck.save(str(tmp_path / "jax"), params, opt_state=state, step=4,
                loss_scale=np.float32(512.0), layouts=layouts, config=config)
    bt.checkpoint.save(tmp_path / "port", port.state_dict(),
                       opt_state=bt.opt_state_from_jax(state, port), step=4,
                       loss_scale=torch.tensor(512.0), layouts=layouts,
                       config=config)
    jtree, jmeta = jax_ck.restore(str(tmp_path / "jax"))
    ptree, pmeta = bt.checkpoint.restore(tmp_path / "port")
    assert pmeta.keys() == jmeta.keys()
    assert pmeta["step"] == jmeta["step"] and pmeta["config"] == config
    np.testing.assert_array_equal(pmeta["layouts"]["attn"],
                                  jmeta["layouts"]["attn"])
    for k, t in bt.params_from_jax(_np(jtree["params"]), port).items():
        assert torch.equal(ptree["params"][k], t), k
    want = bt.opt_state_from_jax(_np(jtree["opt_state"]), port)
    for slot in ("mean", "var"):
        for k, t in want[slot].items():
            got = ptree["opt_state"][slot][k]
            assert got.dtype == t.dtype and torch.equal(got, t), k
    assert float(ptree["loss_scale"]) == float(jtree["loss_scale"])
