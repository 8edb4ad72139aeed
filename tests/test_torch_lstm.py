"""The sparse LSTM family against the JAX package: the fused LSTM ops, the
``SparseLSTM`` model and the ``lstm_train`` entry point.

Both packages get the same NumPy params (``random_jax_lstm_params``) and
tokens; JAX's matmul runs its CPU path (``impl`` default: XLA).

Tolerances (f32, the same products summed in other orders; the shared
``w_h`` sums its gradient over every application, in the order of a
Python loop here and of JAX's scan there):
- gate math, sparse_relu, the cell and grouped_lstm: 1e-5 of the
  tensor's largest magnitude (at least 1); against the NumPy goldens
  5e-6 (float64 goldens, f32 transcendentals);
- the model's logits and loss: 1e-5 of the largest (at least 1); every
  gradient 1e-4 of its tensor's largest;
- one entry-point step: loss and grad norm 1e-5 relative; parameters
  1e-5 of their tensor's largest where the gradient is above 1e-3 of its
  largest, else 2 lr (Adam's first step moves by at most lr, and a
  noise-level gradient may flip sign between packages); EMA the same;
- recompute on and off, dropout from the same generator twice, save and
  restore: bit for bit.
"""
import importlib.util
import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from blocksparse_tpu.models.sparse_lstm import LSTMConfig as JaxConfig
from blocksparse_tpu.models.sparse_lstm import SparseLSTM as JaxLSTM
from blocksparse_tpu.ops import lstm as jl
from blocksparse_tpu.ops import optimize as jax_opt
import blocksparse_tpu as jbs

import blocksparse_tpu_torch as bt
from blocksparse_tpu_torch import checkpoint as ck
from blocksparse_tpu_torch.examples import lstm_train as port_train
from blocksparse_tpu_torch.ops import lstm as tl

torch.set_num_threads(2)
TOL, GRAD_TOL, LR = 1e-5, 1e-4, 1e-3
TINY = dict(nhidden=128, nembd=16, nproj_in=64, nproj_out=64, nsteps=8,
            block_size=32, mask_kind="ba_2", isteps=2, lsteps=2,
            share_masks=False, n_vocab=32)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _np(a):
    return a.detach().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def close(got, want, tol=TOL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def _t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


# ---------------- the ops ----------------

def test_fused_lstm_gates_both_forms_match_jax_and_the_golden():
    rng = np.random.RandomState(0)
    N, width = 8, 16
    c = rng.uniform(-1, 1, (N, width)).astype(np.float32)
    h = rng.uniform(-1, 1, (N, 4 * width)).astype(np.float32)
    b = rng.uniform(-0.5, 0.5, 4 * width).astype(np.float32)
    got = tl.fused_lstm_gates(_t(c), _t(h), bias=_t(b), forget_bias=1.0)
    want = jl.fused_lstm_gates(jnp.asarray(c), jnp.asarray(h),
                               bias=jnp.asarray(b), forget_bias=1.0)
    gold = tl.lstm_gates_test(c, h, bias=b, forget_bias=1.0)
    for g, w, o in zip(got, want, gold):
        close(g, w)
        close(g, o, 5e-6)
    # the four-tensor form, and forget_bias
    parts = [_t(a) for a in np.split(h, 4, axis=1)]
    got4 = tl.fused_lstm_gates(_t(c), *parts, forget_bias=0.5)
    want4 = jl.fused_lstm_gates(jnp.asarray(c),
                                *[jnp.asarray(a) for a in
                                  np.split(h, 4, axis=1)], forget_bias=0.5)
    for g, w in zip(got4, want4):
        close(g, w)
    with pytest.raises(ValueError):
        tl.fused_lstm_gates(_t(c), *parts, bias=_t(b))
    # bf16 gates: f32 inside, each output in its input's dtype
    cb, hb = tl.fused_lstm_gates(_t(c), _t(h).bfloat16())
    assert cb.dtype == torch.float32 and hb.dtype == torch.bfloat16


def test_split4_concat4_round_trip():
    x = torch.from_numpy(np.random.RandomState(1).randn(4, 16)
                         .astype(np.float32))
    parts = tl.split4(x)
    want = jl.split4(jnp.asarray(x.numpy()))
    for p, w in zip(parts, want):
        assert np.array_equal(p.numpy(), np.asarray(w))
    assert torch.equal(tl.concat4(*parts), x)


def test_sparse_relu_and_its_gradient_match_jax():
    rng = np.random.RandomState(2)
    x = rng.randn(8, 64).astype(np.float32)
    u = rng.randn(8, 64).astype(np.float32)
    X = _t(x, True)
    y = tl.sparse_relu(X, alpha=0.5)
    close(y, jl.sparse_relu(jnp.asarray(x), alpha=0.5))
    close(y, tl.sparse_relu_test(x, alpha=0.5), 5e-6)
    (dx,) = torch.autograd.grad((y * _t(u)).sum(), X)
    want = jax.grad(lambda a: jnp.sum(jl.sparse_relu(a, alpha=0.5) * u))(
        jnp.asarray(x))
    close(dx, want)


def test_fused_cell_with_jax_params_matches_jax():
    N, in_w, width = 4, 8, 16
    jcell = jl.FusedBasicLSTMCell(width, forget_bias=0.7)
    params = jcell.init(jax.random.PRNGKey(0), in_w)
    params["bias"] = jnp.asarray(np.random.RandomState(3).randn(4 * width),
                                 jnp.float32)
    cell = bt.FusedBasicLSTMCell(width, in_w, forget_bias=0.7, device="cpu")
    cell.load_state_dict({k: _t(v) for k, v in params.items()})
    rng = np.random.RandomState(4)
    x, c, h = (rng.randn(N, w).astype(np.float32)
               for w in (in_w, width, width))
    got = cell(_t(x), (_t(c), _t(h)))
    want = jcell(params, jnp.asarray(x), (jnp.asarray(c), jnp.asarray(h)))
    close(got[0], want[0])
    for g, w in zip(got[1], want[1]):
        close(g, w)


@pytest.mark.parametrize("layernorm", [True, False])
def test_grouped_lstm_and_its_shared_kernel_gradient_match_jax(layernorm):
    N, T, in_w, width = 4, 5, 8, 16
    params = jl.grouped_lstm_init(jax.random.PRNGKey(1), in_w, width,
                                  layernorm=layernorm)
    rng = np.random.RandomState(5)
    params = dict(params, bias=jnp.asarray(rng.randn(4 * width) * 0.1,
                                           jnp.float32))
    xs = rng.randn(N, T, in_w).astype(np.float32)
    c0, h0 = (rng.randn(N, width).astype(np.float32) * 0.1
              for _ in range(2))

    def jloss(p, x):
        ys, (c, h) = jl.grouped_lstm(x, width, T, (jnp.asarray(c0),
                                                   jnp.asarray(h0)), p,
                                     layernorm=layernorm, forget_bias=0.9)
        return jnp.sum(ys ** 2) + jnp.sum(c), (ys, c, h)
    (_, (ys, c, h)), (jgp, jgx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(params, jnp.asarray(xs))

    tp = {k: _t(v, True) for k, v in params.items()}
    X = _t(xs, True)
    tys, (tc, th) = tl.grouped_lstm(X, width, T, [_t(c0), _t(h0)], tp,
                                    layernorm=layernorm, forget_bias=0.9)
    for g, w in ((tys, ys), (tc, c), (th, h)):
        close(g, w)
    names = sorted(tp)
    grads = torch.autograd.grad(tys.square().sum() + tc.sum(),
                                [tp[k] for k in names] + [X])
    for k, g in zip(names, grads):
        close(g, jgp[k], GRAD_TOL)
    close(grads[-1], jgx, GRAD_TOL)
    assert tl.group_lstm_grads(grads, tp) is grads


def test_grouped_lstm_init_draws_from_the_generator():
    g = torch.Generator().manual_seed(0)
    p = tl.grouped_lstm_init(g, 8, 16)
    assert tuple(p["kernel"].shape) == (24, 64)
    assert float(p["kernel"].abs().max()) <= 1 / np.sqrt(24)
    assert not p["bias"].any() and bool((p["gain"] == 1).all())
    q = tl.grouped_lstm_init(torch.Generator().manual_seed(0), 8, 16,
                             layernorm=False)
    assert torch.equal(p["kernel"], q["kernel"]) and "gain" not in q


# ---------------- the model ----------------

def _models(**kw):
    cfg = dict(TINY, **kw)
    port = bt.SparseLSTM(bt.LSTMConfig(**cfg), device="cpu")
    jm = JaxLSTM(JaxConfig(**cfg))
    params = bt.random_jax_lstm_params(port, seed=1)
    port.load_state_dict(bt.lstm_params_from_jax(params, port))
    rng = np.random.RandomState(2)
    tokens, targets = (rng.randint(0, cfg["n_vocab"], (3, cfg["nsteps"]))
                       .astype(np.int32) for _ in range(2))
    return port, jm, params, tokens, targets


def _jparams(params):
    return jax.tree_util.tree_map(jnp.asarray, params)


def _port_grads(port, tokens, targets, dropout=None):
    names, params = zip(*port.named_parameters())
    loss = port.loss(_t(tokens).long(), _t(targets).long(), dropout=dropout)
    return loss, dict(zip(names, torch.autograd.grad(loss, params)))


def _check_grads(got, jgrads):
    flat = bt.lstm_params_from_jax(_np_tree(jgrads))
    assert set(flat) == set(got)
    for k, g in got.items():
        close(g, flat[k], GRAD_TOL)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("recompute", [False, True])
def test_sparse_lstm_logits_loss_and_gradients_match_jax(recompute):
    port, jm, params, tokens, targets = _models(recompute=recompute)
    jp = _jparams(params)
    with torch.no_grad():
        logits = port(_t(tokens).long())
    close(logits, jm.forward(jp, jnp.asarray(tokens)))
    jloss, jgrads = jax.value_and_grad(jm.loss)(jp, jnp.asarray(tokens),
                                                jnp.asarray(targets))
    loss, grads = _port_grads(port, tokens, targets)
    close(loss, jloss)
    _check_grads(grads, jgrads)
    # the layouts: one per layer (share_masks off), JAX's
    for a, b in zip(port.bsmm_layers, jm.bsmm_layers):
        assert np.array_equal(a.layout, b.layout)
    assert port.layouts().keys() == jm.layouts().keys()
    assert port.config_dict() == jm.config_dict()


def test_recompute_on_and_off_give_the_same_bits():
    got = []
    for recompute in (False, True):
        port, _, _, tokens, targets = _models(recompute=recompute,
                                              dropout=0.3)
        gen = torch.Generator().manual_seed(5)
        got.append(_port_grads(port, tokens, targets, dropout=gen))
    assert torch.equal(got[0][0], got[1][0])
    for k in got[0][1]:
        assert torch.equal(got[0][1][k], got[1][1][k])


@pytest.mark.parametrize("recompute", [False, True])
def test_dropout_with_jax_mask_matches_jax(recompute):
    """The keep mask JAX's forward draws from ``dropout_key`` (a bernoulli
    of shape (T, lsteps, nhidden, batch)), passed to the port."""
    port, jm, params, tokens, targets = _models(recompute=recompute,
                                                dropout=0.25, lsteps=2)
    key = jax.random.PRNGKey(7)
    c = port.config
    mask = np.asarray(jax.random.bernoulli(
        key, 1.0 - c.dropout, (c.nsteps, c.lsteps, c.nhidden,
                               tokens.shape[0])))
    jloss, jgrads = jax.value_and_grad(jm.loss)(
        _jparams(params), jnp.asarray(tokens), jnp.asarray(targets), key)
    loss, grads = _port_grads(port, tokens, targets,
                              dropout=torch.tensor(mask))
    close(loss, jloss)
    _check_grads(grads, jgrads)
    # the same generator twice: the same masks; no dropout: another loss
    g1, g2 = (torch.Generator().manual_seed(3) for _ in range(2))
    with torch.no_grad():
        a = port.loss(_t(tokens).long(), _t(targets).long(), dropout=g1)
        b = port.loss(_t(tokens).long(), _t(targets).long(), dropout=g2)
        c0 = port.loss(_t(tokens).long(), _t(targets).long())
    assert torch.equal(a, b) and not torch.equal(a, c0)


def test_lstm_params_round_trip_and_shape_checks():
    port, _, params, _, _ = _models()
    back = bt.lstm_params_to_jax(port)
    assert back.keys() == params.keys()
    for k in ("wte", "w_in", "w_out", "b_out"):
        assert np.array_equal(back[k], params[k])
    for lb, lp in zip(back["layers"], params["layers"]):
        assert lb.keys() == lp.keys()
        for k in lp:
            assert np.array_equal(lb[k], lp[k])
    bad = dict(params, w_in=np.zeros((3, 3), np.float32))
    with pytest.raises(ValueError):
        bt.lstm_params_from_jax(bad, port)
    # random params: JAX init's shapes; w_h orthogonal block columns
    w = params["layers"][0]["w_h"]
    op = port.bsmm_layers[0]
    for k, lut in op.fprop_list:
        col = np.concatenate([w[wi] for _, wi in lut])
        np.testing.assert_allclose(col.T @ col, np.eye(op.bsize), atol=1e-5)
    jparams = JaxLSTM(JaxConfig(**TINY)).init(jax.random.PRNGKey(0))
    assert jax.tree_util.tree_map(np.shape, jparams) == \
        jax.tree_util.tree_map(np.shape, params)


def test_sparse_lstm_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is valid here")
    with pytest.raises(RuntimeError):
        bt.SparseLSTM(bt.LSTMConfig(**TINY))
    with pytest.raises(RuntimeError):
        bt.FusedBasicLSTMCell(8, 4)


# ---------------- the entry point ----------------

def _jax_example():
    spec = importlib.util.spec_from_file_location(
        "jax_lstm_train", os.path.join(ROOT, "examples", "lstm_train.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_entry_point_step_matches_the_jax_example_step():
    """One step of ``make_step`` against the JAX example's ``step``
    (``examples/lstm_train.py:112-120``: value_and_grad, clip by the
    global norm of the leaves at 1.0, Adam with zero_nans, EMA 0.999)."""
    port, jm, params, tokens, targets = _models()
    optm = bt.AdamOptimizer(learning_rate=LR, zero_nans=True)
    ema = bt.Ema(decay=0.999)
    named = dict(port.named_parameters())
    step = port_train.make_step(port, optm, ema)
    state, ema_state, loss, gn = step(optm.init(named), ema.init(named),
                                      _t(tokens).long(), _t(targets).long())

    jp = _jparams(params)
    joptm = jax_opt.AdamOptimizer(learning_rate=LR, zero_nans=True)
    jema = jax_opt.Ema(decay=0.999)
    jloss, jgrads = jax.value_and_grad(jm.loss)(jp, jnp.asarray(tokens),
                                                jnp.asarray(targets))
    jgn, ns = jbs.clip_by_global_norm(jax.tree_util.tree_leaves(jgrads),
                                      clip_norm=1.0)
    jnew, jstate = joptm.apply(jgrads, jp, joptm.init(jp), norm_scale=ns)
    jema_state = jema.apply(jnew, jema.init(jp))

    np.testing.assert_allclose(float(loss), float(jloss), rtol=TOL)
    np.testing.assert_allclose(float(gn), float(jgn), rtol=TOL)
    g = bt.lstm_params_from_jax(_np_tree(jgrads))
    new = bt.lstm_params_from_jax(_np_tree(jnew))
    avg = bt.lstm_params_from_jax(_np_tree(jema_state))
    for k, p in port.state_dict().items():
        live = np.abs(g[k].numpy()) > 1e-3 * np.abs(g[k].numpy()).max()
        scale = float(np.abs(new[k].numpy()).max())
        for got, want in ((p, new[k]), (ema_state[k], avg[k])):
            d = np.abs(got.numpy() - want.numpy())
            assert (d[live] <= TOL * scale).all(), k
            assert (d <= 2 * LR).all(), k
    assert int(state["t"]) == int(jstate["t"]) == 1


def test_entry_point_data_matches_the_jax_example():
    """The synthetic stream (the JAX example's ``main``, ``:82-85``) and
    ``get_batch`` bit for bit."""
    jx = _jax_example()
    train, val = port_train.load_data(None, 64, 32)
    rng = np.random.RandomState(0)
    data = rng.randint(0, 27, size=10 ** 7).astype(np.uint8)
    data[1:] = (data[1:] + 7 * data[:-1]) % 27
    n_val = max(len(data) // 20, 64 * 32 + 2)
    assert np.array_equal(train, data[:-n_val])
    assert np.array_equal(val, data[-n_val:])
    got = port_train.get_batch(train, np.random.RandomState(4), 3, 16)
    want = jx.get_batch(train, np.random.RandomState(4), 3, 16)
    for g, w in zip(got, want):
        assert np.array_equal(g, np.asarray(w))


def _args(tmp_path, *extra):
    return port_train.parse_args(
        ["--device", "cpu", "--nhidden", "128", "--nsteps", "8", "--batch",
         "2", "--mask_kind", "ba_2", "--isteps", "1", *extra])


def test_checkpoint_round_trip_resumes_bit_for_bit(tmp_path):
    """A checkpoint of the entry point restored into a fresh model: the
    params, both states, the layouts sidecar and the config as saved, and
    the next step equal to the uninterrupted run's bit for bit."""
    path = str(tmp_path / "ck")
    args = _args(tmp_path, "--lsteps", "2", "--share_masks", "0",
                 "--dropout", "0.1", "--recompute", "1")
    model, optm, ema, state, ema_state, _ = port_train.build(args)
    step = port_train.make_step(model, optm, ema)
    train, _ = port_train.load_data(None, 8, 2)
    rng = np.random.RandomState(1)
    batches = [tuple(_t(a).long() for a in
                     port_train.get_batch(train, rng, 2, 8))
               for _ in range(3)]
    for it in range(2):
        state, ema_state, _, _ = step(state, ema_state, *batches[it],
                                      torch.Generator().manual_seed(it))
    port_train.save(path, model, state, ema_state, 2)
    tree, meta = ck.restore(path)
    assert meta["step"] == 2 and meta["config"] == model.config_dict()
    for name, lay in model.layouts().items():
        assert np.array_equal(meta["layouts"][name], lay)

    restored = port_train.build(_args(tmp_path, "--restore", path))
    m2, o2, e2, s2, es2, start = restored
    assert start == 2 and m2.config == model.config
    for k, v in model.state_dict().items():
        assert torch.equal(m2.state_dict()[k], v)
    outs = []
    for m, o, e, s, es in ((model, optm, ema, state, ema_state),
                           (m2, o2, e2, s2, es2)):
        outs.append(port_train.make_step(m, o, e)(
            s, es, *batches[2], torch.Generator().manual_seed(2)))
    (sa, ea, la, _), (sb, eb, lb, _) = outs
    assert torch.equal(la, lb)
    for k, v in model.state_dict().items():
        assert torch.equal(m2.state_dict()[k], v)
        assert torch.equal(ea[k], eb[k])
        assert torch.equal(sa["mean"][k], sb["mean"][k])
        assert torch.equal(sa["var"][k], sb["var"][k])


def test_entry_point_trains_evaluates_and_restores_on_the_cpu(tmp_path):
    path = str(tmp_path / "run")
    out = port_train.train(_args(tmp_path, "--n_iter", "4", "--eval_every",
                                 "2", "--save_path", path, "--ckpt_every",
                                 "2", "--lr", "3e-3"))
    assert len(out["losses"]) == 4 and np.isfinite(out["losses"]).all()
    assert [s for s, _ in out["eval"]] == [2, 4]
    back = port_train.train(_args(tmp_path, "--n_iter", "1", "--restore",
                                  path))
    assert back["start"] == 4 and np.isfinite(back["losses"]).all()
    assert port_train.main(["--device", "cpu", "--nhidden", "64",
                            "--nsteps", "4", "--batch", "2", "--mask_kind",
                            "ba_1", "--n_iter", "1"]) == 0


def test_the_lstm_surface_is_exported_under_the_jax_names():
    for name in ("fused_lstm_gates", "split4", "concat4", "sparse_relu",
                 "FusedBasicLSTMCell", "grouped_lstm", "grouped_lstm_init",
                 "group_lstm_grads"):
        assert hasattr(jbs, name)
        assert getattr(bt, name) is getattr(tl, name)
    assert bt.models.SparseLSTM is bt.SparseLSTM
