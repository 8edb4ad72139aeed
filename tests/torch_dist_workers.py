"""Gloo ranks for the port's parallel tests.

The parallel tests (``test_torch_parallel.py``, ``test_torch_sequence.py``,
``test_torch_sharded_train.py``, ``test_torch_pipeline.py``,
``test_torch_pp_train.py``, ``test_torch_ep.py``) run the port on several
CPU processes, a ``torch.distributed`` gloo group of ``world`` ranks
rendezvousing through a ``FileStore`` in a temporary directory (loopback
only).  Each test file spawns its ranks once (``spawn``), runs one case
function of this module on every rank, and gets back each rank's results
(nested dicts of NumPy arrays and floats), which it holds against the JAX
package's ``shard_map`` on the simulated devices of ``tests/conftest.py``.

This module imports no JAX (the spawned ranks import it), and pytest does
not collect it.  The inputs both sides use are made here from seeds, but
for JAX's dropout masks, which the test process draws and hands to the
ranks (``spawn``'s ``inputs``).  A spawn that several test files read
(``shared_spawn``) runs once a session.
"""
from __future__ import annotations

import dataclasses
import datetime
import fcntl
import os
import pickle
import tempfile
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

TIMEOUT = 300           # seconds for one spawn, all cases


# ---------------------------------------------------------------- spawning

def spawn(case, world, timeout=TIMEOUT, inputs=None):
    """Runs ``case(rank, world)`` (a function of this module, by name) on
    ``world`` gloo ranks, ``case(rank, world, inputs)`` with ``inputs``
    (picklable), and returns the ranks' results in rank order.  A rank
    that raises fails the call with its traceback; ranks that outlive
    ``timeout`` are killed and the call raises."""
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as d:
        procs = [ctx.Process(target=_rank_main,
                             args=(r, world, d, case, inputs))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.kill()
            p.join()
        errors = []
        for r in range(world):
            path = os.path.join(d, f"rank{r}.err")
            if os.path.exists(path):
                with open(path) as f:
                    errors.append(f"rank {r}:\n{f.read()}")
        if errors:
            raise RuntimeError("\n".join(errors))
        if alive or any(p.exitcode for p in procs):
            raise RuntimeError(f"{case}: ranks timed out or died "
                               f"{[p.exitcode for p in procs]}")
        out = []
        for r in range(world):
            with open(os.path.join(d, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out


_SPAWNED = {}


def shared_spawn(case, world, inputs=None, shared_dir=None):
    """``spawn(case, world, inputs=inputs)`` once a test session for every
    test file that reads it: the result is kept in this process and, with
    ``shared_dir`` (a directory that all of the session's pytest-xdist
    workers see, ``session_dir``), pickled there under a file lock, so
    the first worker to ask spawns the ranks and the others wait for its
    result.  Every caller passes the same ``inputs``."""
    if case in _SPAWNED:
        return _SPAWNED[case]
    if shared_dir is None:
        out = spawn(case, world, inputs=inputs)
    else:
        path = os.path.join(shared_dir, f"spawn_{case}_{world}")
        with open(path + ".lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if os.path.exists(path + ".pkl"):
                with open(path + ".pkl", "rb") as f:
                    out = pickle.load(f)
            else:
                out = spawn(case, world, inputs=inputs)
                with open(path + ".tmp", "wb") as f:
                    pickle.dump(out, f)
                os.replace(path + ".tmp", path + ".pkl")
    _SPAWNED[case] = out
    return out


def session_dir(tmp_path_factory):
    """The directory the session's pytest-xdist workers share (their base
    temporary directories' parent, which pytest removes in time), or None
    without xdist."""
    if not os.environ.get("PYTEST_XDIST_WORKER"):
        return None
    return str(tmp_path_factory.getbasetemp().parent)


def _rank_main(rank, world, d, case, inputs=None):
    try:
        if os.path.exists("/sys/class/net/lo"):
            os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
        torch.set_num_threads(1)
        dist.init_process_group(
            "gloo", store=dist.FileStore(os.path.join(d, "store"), world),
            rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=TIMEOUT - 30))
        args = () if inputs is None else (inputs,)
        result = globals()[case](rank, world, *args)
        dist.barrier()
        dist.destroy_process_group()
        with open(os.path.join(d, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
    except BaseException:
        with open(os.path.join(d, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def _np(t):
    return t.detach().cpu().numpy().copy()


# ------------------------------------------------- collectives (4 ranks)

def collective_inputs(world=4):
    """Per-rank arrays of the collective cases, drawn from seeds."""
    rng = np.random.RandomState(0)
    return {
        "x": rng.randn(world, 3, 4).astype(np.float32),
        "h": rng.randn(world, 4, 4).astype(np.float32),       # 2x2 hier
        "odd": rng.randn(world, 3, 4).astype(np.float32),
        "rs": rng.randn(world, 2 * world, 4).astype(np.float32),
        "sync": rng.randn(world, 4).astype(np.float32),
        "dy": rng.randn(world, 3, 4).astype(np.float32),
        "w": rng.randn(16, 16).astype(np.float32),
        "xs": rng.randn(world, 4, 16).astype(np.float32)}


def parallel_cases(rank, world):
    from blocksparse_tpu_torch import nccl
    from blocksparse_tpu_torch.ops.optimize import adam_apply
    from blocksparse_tpu_torch.parallel import (
        all_gather, allreduce, data_sharding, group_allreduce,
        hierarchical_allreduce, identity_sync, make_mesh, mpi_rank,
        mpi_size, reduce_scatter, serialize_allreduce_ops,
        sync_variables_op)
    inp = collective_inputs(world)
    out = {}

    def t(a):
        return torch.from_numpy(np.array(a))

    out["refused"] = []
    for kw in (dict(dp=3), dict(tp=3)):        # shapes that miss the world
        try:
            make_mesh(device="cpu", **kw)
        except ValueError:
            out["refused"].append(" ".join(f"{k} {v}" for k, v in kw.items()))
    mesh = make_mesh(device="cpu")                          # dp = world
    out["mesh"] = {"shape": tuple(mesh.mesh.shape),
                   "names": tuple(mesh.mesh_dim_names),
                   "size_dp": mpi_size(mesh, "dp"),
                   "rank_dp": mpi_rank("dp", mesh)}
    x = t(inp["x"][rank]).requires_grad_()
    y = allreduce(x, axis="dp")
    y.backward(t(inp["dy"][rank]))
    out["allreduce"], out["allreduce_grad"] = _np(y), _np(x.grad)
    g = group_allreduce([t(inp["x"][rank]), {"b": t(inp["h"][rank])}],
                        cast_all=torch.bfloat16)
    out["group_dtype"] = str(g[0].dtype)
    out["group"] = [_np(g[0].float()), _np(g[1]["b"].float())]
    xr = t(inp["rs"][rank]).requires_grad_()
    r = reduce_scatter(xr, axis="dp", scatter_dimension=0)
    back = all_gather(r, axis="dp", concat_dimension=0)
    (r ** 2).sum().backward()
    out["rs"], out["rs_ag"], out["rs_grad"] = _np(r), _np(back), _np(xr.grad)
    xg = t(inp["x"][rank]).requires_grad_()
    ag = all_gather(xg, axis="dp", concat_dimension=1)
    (ag * ag).sum().backward()
    out["ag1"], out["ag1_grad"] = _np(ag), _np(xg.grad)
    out["sync"] = _np(sync_variables_op({"p": t(inp["sync"][rank])})["p"])
    out["passthrough"] = (serialize_allreduce_ops("ops") == "ops",
                          identity_sync(x) is x,
                          nccl.serialize_nccl_ops is serialize_allreduce_ops)

    # a 2 x 2 mesh: "tp" the fast axis, "dp" the slow one
    mesh2 = make_mesh(dp=2, tp=2, device="cpu")
    out["mesh2"] = {"shape": tuple(mesh2.mesh.shape),
                    "rank": (mpi_rank("dp", mesh2), mpi_rank("tp", mesh2)),
                    "batch": data_sharding(mesh2, "dp", "tp").slices((8, 6)),
                    "joint": data_sharding(mesh2, ("dp", "tp")).slices((8,))}
    h = t(inp["h"][rank])
    out["hier"] = _np(hierarchical_allreduce(h, fast_axis="tp",
                                             slow_axis="dp"))
    out["flat"] = _np(allreduce(h, axis=("dp", "tp")))
    out["prereduce"] = _np(allreduce(h, prereduce=2, axis=("tp", "dp")))
    out["hier_odd"] = _np(hierarchical_allreduce(
        t(inp["odd"][rank]), fast_axis="tp", slow_axis="dp"))

    # the dp training step of test_parallel.test_dp_training_step
    make_mesh(device="cpu")
    w = t(inp["w"]).requires_grad_()
    loss = ((t(inp["xs"][rank]) @ w) ** 2).mean()
    gw, = torch.autograd.grad(loss, w)
    gw = allreduce(gw, axis="dp") / float(world)
    w2, _, _ = adam_apply(gw, w.detach(), torch.zeros_like(w),
                          torch.zeros_like(w), 0.1)
    out["dp_step"] = _np(w2)
    return out


# ------------------------------------------- sequence parallel attention

def _fixed(ctx_blks, local_blocks):
    layout = np.zeros((ctx_blks, ctx_blks), np.int32)
    for q in range(ctx_blks):
        layout[q, max(0, q - local_blocks + 1):q + 1] = 1
        layout[q, 0:q:4] = 1
    return layout


def _empty_column(ctx_blks, n_blocks, col):
    """A causal layout of ``n_blocks`` blocks whose key block-row ``col``
    no query sees; every query row sees a key."""
    layout = np.tril(np.ones((ctx_blks, ctx_blks), np.int32))
    layout[:, col] = 0
    layout[col, max(col - 1, 0)] = 1
    extra = int(layout.sum()) - n_blocks
    for q in range(ctx_blks - 1, -1, -1):          # drop blocks, far first
        for k in range(q - 1):
            if extra > 0 and layout[q, k] and k != col \
                    and layout[q].sum() > 1:
                layout[q, k] = 0
                extra -= 1
    assert extra == 0, extra
    return layout


SEQ = {
    # two layout heads: the fixed pattern, and one whose key block-row 2
    # no query sees (so that key row is empty on every shard)
    "perhead16": dict(bs=16, ctx_blks=8, heads=2, hs=16, batch=2),
    # the shared fixed layout at block size 8 (the kernels' bs-16 view),
    # 12 block-rows: 3 a shard at sp 4, odd
    "shared8": dict(bs=8, ctx_blks=12, heads=2, hs=16, batch=2),
}


def seq_layout(name):
    c = SEQ[name]
    if name == "perhead16":
        fixed = _fixed(c["ctx_blks"], 2)
        return np.stack([fixed, _empty_column(c["ctx_blks"],
                                              int(fixed.sum()), 2)])
    return _fixed(c["ctx_blks"], 3)


def causal_subblock_mask(blk_shape, head, qry, key, blk):
    mask = np.ones(blk_shape, dtype=bool)
    if qry == key:
        for q in range(blk_shape[0]):
            mask[q, q + 1:] = 0
    return mask


def seq_inputs(name):
    """q, k, v, dy (batch, ctx, heads·hs) f32 of a SEQ config."""
    c = SEQ[name]
    rng = np.random.RandomState(1)
    shape = (c["batch"], c["ctx_blks"] * c["bs"], c["heads"] * c["hs"])
    return [rng.randn(*shape).astype(np.float32) for _ in range(4)]


def seq_op(name):
    from blocksparse_tpu_torch.ops.transformer import BlocksparseTransformer
    c = SEQ[name]
    return BlocksparseTransformer(seq_layout(name), block_size=c["bs"],
                                  heads=c["heads"],
                                  mask_callback=causal_subblock_mask)


def seq_scale(name):
    return 1.0 / np.sqrt(SEQ[name]["hs"])


def sequence_cases(rank, world):
    """Gather and ring attention at sp 2 (a dp 2 x sp 2 mesh) and sp 4: each
    rank's output shard and the gradients of its q, k, v shards."""
    from blocksparse_tpu_torch.parallel import (make_mesh, mpi_rank,
                                                ring_attention,
                                                sequence_parallel_attention)
    out = {}
    for n in (2, 4):
        mesh = make_mesh(sp=n, device="cpu")
        r = mpi_rank("sp", mesh)
        for name in SEQ:
            bst = seq_op(name)
            q, k, v, dy = seq_inputs(name)
            L = q.shape[1] // n
            sl = slice(r * L, (r + 1) * L)
            for mode, fn in (("gather", sequence_parallel_attention),
                             ("ring", ring_attention)):
                qkv = [torch.from_numpy(a[:, sl].copy()).requires_grad_()
                       for a in (q, k, v)]
                y = fn(bst, *qkv, axis="sp", n_shards=n,
                       scale=seq_scale(name), mesh=mesh)
                y.backward(torch.from_numpy(dy[:, sl].copy()))
                out[(name, mode, n)] = {
                    "sp_rank": r, "y": _np(y),
                    "dq": _np(qkv[0].grad), "dk": _np(qkv[1].grad),
                    "dv": _np(qkv[2].grad)}
    return out


# ---------------------------------------------------- the sharded LM step

TRAIN_BASE = dict(n_vocab=64, n_embd=64, n_layer=2, n_head=4, ctx=128,
                  blk_size=32, attn_layout="fixed", local_blocks=2,
                  mlp_ratio=4, dtype="float32", recompute=True,
                  stack_layers=True)
TRAIN = {
    # name: (dp, tp, sp, config fields, params: "P" the tp-1 draw in the
    # tp layout, else a draw of the config's own shapes)
    "dp4": (4, 1, 1, {}, "P"),
    "dp2_tp2": (2, 2, 1, dict(tp=2), "P"),
    "dp2_tp2_bsmm": (2, 2, 1, dict(tp=2, mlp_block_size=16,
                                   mlp_density=0.5), "own"),
    "tp2_sp2_gather": (1, 2, 2, dict(tp=2, sp=2), "P"),
    "tp2_sp2_ring": (1, 2, 2, dict(tp=2, sp=2, sp_mode="ring"), "P"),
}
LR = 1e-3
LOSS_SCALE = 128.0
STEPS = 2


def train_config(name, **kw):
    from blocksparse_tpu_torch import TransformerConfig
    return TransformerConfig(**dict(TRAIN_BASE, **TRAIN[name][3]) | kw)


def tp_layout(params, tp):
    """A tp-1 JAX param dict with ``w_qkv``/``b_qkv`` columns reordered
    into the JAX tp layout (rank r's [q_r | k_r | v_r] contiguous), so a
    tp model computes the tp-1 model's function."""
    out = dict(params)
    for key in [k for k in params if k.startswith("h") and k[1:].isdigit()]:
        layer = dict(params[key])
        for name in ("w_qkv", "b_qkv"):
            a = layer[name]
            d = a.shape[-1] // 3
            q, k, v = (a[..., i * d:(i + 1) * d] for i in range(3))
            n = d // tp
            layer[name] = np.concatenate(
                [x[..., r * n:(r + 1) * n] for r in range(tp)
                 for x in (q, k, v)], axis=-1)
        out[key] = layer
    return out


def train_params(name):
    """The global JAX param dict a TRAIN config starts from."""
    from blocksparse_tpu_torch import SparseTransformerLM, random_jax_params
    dp, tp, sp, kw, which = TRAIN[name]
    if which == "P":
        base = SparseTransformerLM(train_config("dp4"), device="cpu")
        return tp_layout(random_jax_params(base, seed=0), tp)
    return random_jax_params(
        SparseTransformerLM(train_config(name), device="cpu"), seed=1)


def train_tokens():
    rng = np.random.RandomState(2)
    c = TRAIN_BASE
    return (rng.randint(0, c["n_vocab"], (4, c["ctx"])).astype(np.int64),
            rng.randint(0, c["n_vocab"], (4, c["ctx"])).astype(np.int64))


def train_cases(rank, world, inputs=None):
    """Two steps of each TRAIN config's sharded step, the entry point
    with --tp 2 --sp 2, and with ``inputs`` (JAX's dropout masks,
    ``DROP_TRAIN``) the dropout cases of ``train_dropout``."""
    from blocksparse_tpu_torch import (AdamOptimizer, SparseTransformerLM,
                                       opt_state_to_jax, params_from_jax,
                                       params_to_jax)
    from blocksparse_tpu_torch.parallel import (data_sharding, make_mesh,
                                                mpi_rank)
    out = {}
    tokens, targets = train_tokens()
    for name, (dp, tp, sp, _, _) in TRAIN.items():
        mesh = make_mesh(dp=dp, tp=tp, sp=sp, device="cpu")
        model = SparseTransformerLM(train_config(name), device="cpu",
                                    mesh=mesh)
        model.load_state_dict(params_from_jax(train_params(name), model))
        optm = AdamOptimizer(learning_rate=LR)
        state = optm.init(dict(model.named_parameters()))
        step = model.make_train_step(optm, mesh=mesh)
        shard = data_sharding(mesh, "dp", "sp")
        x = torch.from_numpy(shard.shard(tokens).copy())
        y = torch.from_numpy(shard.shard(targets).copy())
        scale, metrics = LOSS_SCALE, []
        for _ in range(STEPS):
            state, m, scale = step(state, x, y, scale)
            metrics.append({k: float(v) for k, v in m.items()}
                           | {"scale": float(scale)})
        out[name] = {"coords": {a: mpi_rank(a, mesh)
                                for a in ("dp", "tp", "sp")},
                     "metrics": metrics, "params": params_to_jax(model),
                     "state": opt_state_to_jax(state, model)}
    out["entry"] = _entry_point()
    if inputs is not None:
        out["dropout"] = train_dropout(inputs, tokens, targets)
    return out


def world1_case(rank, world):
    """The dp4 config's model on a mesh of one rank: two sharded steps and
    two single-device steps from the same params."""
    from blocksparse_tpu_torch import (AdamOptimizer, SparseTransformerLM,
                                       params_from_jax)
    from blocksparse_tpu_torch.parallel import make_mesh
    tokens, targets = (torch.from_numpy(a[:1].copy())
                       for a in train_tokens())
    out = {}
    for label, mesh in (("single", None), ("sharded", make_mesh(
            device="cpu"))):
        model = SparseTransformerLM(train_config("dp4"), device="cpu")
        model.load_state_dict(params_from_jax(train_params("dp4"), model))
        optm = AdamOptimizer(learning_rate=LR)
        state = optm.init(dict(model.named_parameters()))
        step = model.make_train_step(optm, mesh=mesh)
        scale, metrics = LOSS_SCALE, []
        for _ in range(STEPS):
            state, m, scale = step(state, tokens, targets, scale)
            metrics.append({k: float(v) for k, v in m.items()})
        out[label] = {"metrics": metrics,
                      "params": {k: _np(v)
                                 for k, v in model.state_dict().items()}}
    return out


def _entry_point(flags=("--tp", "2", "--sp", "2")):
    """The enwik8 entry point with ``flags`` (--tp 2 --sp 2) for two steps,
    on a small data file of the JAX example's synthetic bytes."""
    from blocksparse_tpu_torch.examples import enwik8
    rng = np.random.RandomState(0)
    data = rng.randint(0, 64, size=50_000).astype(np.uint8)
    data[1:] = (data[1:] + data[:-1] * 3) % 223
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "bytes")
        data.tofile(path)
        args = enwik8.parse_args([
            "--device", "cpu", "--n_ctx", "64", "--n_embd", "64",
            "--n_layer", "2", "--n_head", "4", "--blk_size", "16",
            "--n_batch", "2", "--n_iter", "2", *flags,
            "--data_file", path])
        return enwik8.train(args)




# ------------------------------------------------- GPipe (4 ranks, "pp")

PIPE = dict(S=4, n_micro=8, mb=2, d=16)
PIPE_AUX = 0.3                # the aux term's coefficient in the loss


def pipe_inputs(S=PIPE["S"]):
    """TestGpipe's setup (``tests/test_pipeline.py``): S tanh stages'
    weights and biases, the microbatched input and the target."""
    c = PIPE
    rng = np.random.RandomState(0)
    ws = rng.uniform(-0.5, 0.5, (S, c["d"], c["d"])).astype(np.float32)
    bs = rng.uniform(-0.1, 0.1, (S, c["d"])).astype(np.float32)
    x = rng.uniform(-1, 1, (c["n_micro"], c["mb"], c["d"])).astype(np.float32)
    return ws, bs, x, np.full_like(x, 0.1)


def pipe_stage(params, h, with_aux=False):
    """The stage of TestGpipe: h = tanh(h @ w_l + b_l) over its layers;
    with_aux also mean(h²) of its output, the aux of the aux cases."""
    import torch
    w, b = params
    for i in range(w.shape[0]):
        h = torch.tanh(h @ w[i] + b[i])
    return (h, (h * h).mean()) if with_aux else h


def pipeline_cases(rank, world):
    """gpipe at S = world (n_micro 8) and at S 1 (a pp-1 axis), without and
    with aux, each followed by broadcast_from_last and the loss
    mean((y - tgt)²)/S (+ PIPE_AUX · aux); the rank's value, output and
    the gradients of its stage's w, b and of x; broadcast_from_last's value
    and gradient on its own."""
    import torch
    from blocksparse_tpu_torch.parallel import (broadcast_from_last, gpipe,
                                                make_mesh, mpi_rank)
    out = {}
    for S in (world, 1):
        mesh = make_mesh(pp=S, device="cpu")
        r = mpi_rank("pp", mesh)
        ws, bs, x, tgt = pipe_inputs(S)
        for with_aux in (False, True):
            w = torch.from_numpy(ws[r:r + 1].copy()).requires_grad_()
            b = torch.from_numpy(bs[r:r + 1].copy()).requires_grad_()
            xt = torch.from_numpy(x).requires_grad_()
            res = gpipe(lambda p, h: pipe_stage(p, h, with_aux), (w, b), xt,
                        axis="pp", n_stages=S, with_aux=with_aux, mesh=mesh)
            y, aux = res if with_aux else (res, None)
            y = broadcast_from_last(y, axis="pp", n_stages=S, mesh=mesh)
            loss = ((y - torch.from_numpy(tgt)) ** 2).mean() / S
            if with_aux:
                loss = loss + PIPE_AUX * aux
            gw, gb, gx = torch.autograd.grad(loss, (w, b, xt))
            with torch.no_grad():               # the forward alone
                res = gpipe(lambda p, h: pipe_stage(p, h, with_aux),
                            (w, b), xt, axis="pp", n_stages=S,
                            with_aux=with_aux, mesh=mesh)
                y_ng = broadcast_from_last(res[0] if with_aux else res,
                                           axis="pp", n_stages=S, mesh=mesh)
            out[(S, with_aux)] = {
                "pp_rank": r, "y": _np(y), "y_no_grad": _np(y_ng),
                "loss": float(loss.detach()),
                "aux": None if aux is None else float(aux),
                "gw": _np(gw), "gb": _np(gb), "gx": _np(gx)}
    mesh = make_mesh(pp=world, device="cpu")
    r = mpi_rank("pp", mesh)
    v = torch.full((3,), float(r + 1)).requires_grad_()
    y = broadcast_from_last(v, mesh=mesh)
    y.backward(torch.arange(3.0) + r)
    out["bcast"] = {"y": _np(y), "grad": _np(v.grad)}
    return out


# ------------------------------------------------ the pipelined LM step

PP_BASE = dict(n_vocab=64, n_embd=64, n_layer=2, n_head=4, ctx=128,
               blk_size=32, attn_layout="fixed", local_blocks=2,
               mlp_ratio=4, dtype="float32", recompute=False)
PP = {
    # name: (dp, tp, pp, config fields, params, batch).  params "P": the
    # tp-1 draw of the dense pp-1 model (in the tp layout where tp > 1),
    # so these runs compute one function; "own": a draw of the config's.
    "pp2_dp2": (2, 1, 2, dict(n_layer=4, mlp_block_size=16,
                              mlp_density=0.5), "own", 4),
    "pp2_mb4": (2, 1, 2, dict(pp_microbatch=4), "P", 8),
    "pp2_tp2": (1, 2, 2, {}, "P", 8),
}


def pp_config(name, **kw):
    from blocksparse_tpu_torch import TransformerConfig
    dp, tp, pp, fields, _, _ = PP[name]
    return TransformerConfig(**dict(PP_BASE, tp=tp, pp=pp, **fields) | kw)


def pp_params(name):
    """The global JAX param dict (flat h{l} layers) a PP config starts
    from."""
    from blocksparse_tpu_torch import SparseTransformerLM, random_jax_params
    _, tp, _, fields, which, _ = PP[name]
    if which == "P":
        from blocksparse_tpu_torch import TransformerConfig
        base = SparseTransformerLM(TransformerConfig(**PP_BASE),
                                   device="cpu")
        return tp_layout(random_jax_params(base, seed=5), tp)
    model = SparseTransformerLM(pp_config(name, pp=1), device="cpu")
    return random_jax_params(model, seed=6)


def pp_tokens(batch):
    rng = np.random.RandomState(7)
    c = PP_BASE
    return (rng.randint(0, c["n_vocab"], (batch, c["ctx"])).astype(np.int64),
            rng.randint(0, c["n_vocab"], (batch, c["ctx"])).astype(np.int64))


def _steps(model, mesh, tokens, targets, shard=None):
    """STEPS train steps of ``model`` from a fresh Adam state: per step
    the metrics and the new scale; the model's params and state after."""
    import torch
    from blocksparse_tpu_torch import AdamOptimizer
    optm = AdamOptimizer(learning_rate=LR)
    state = optm.init(dict(model.named_parameters()))
    step = model.make_train_step(optm, mesh=mesh)
    if shard is not None:
        tokens, targets = shard.shard(tokens), shard.shard(targets)
    x, y = (torch.from_numpy(np.ascontiguousarray(a)) for a in
            (tokens, targets))
    scale, metrics = LOSS_SCALE, []
    for _ in range(STEPS):
        state, m, scale = step(state, x, y, scale)
        metrics.append({k: float(v) for k, v in m.items()}
                       | {"scale": float(scale)})
    return metrics, state


def _sharded_run(config, params, axes, tokens, targets, batch_axes="dp"):
    """A sharded run on a mesh of ``axes``: the rank's coordinates, its
    metrics, params and Adam state in the JAX layout."""
    from blocksparse_tpu_torch import (SparseTransformerLM, opt_state_to_jax,
                                       params_from_jax, params_to_jax)
    from blocksparse_tpu_torch.parallel import (data_sharding, make_mesh,
                                                mpi_rank)
    mesh = make_mesh(device="cpu", **axes)
    model = SparseTransformerLM(config, device="cpu", mesh=mesh)
    model.load_state_dict(params_from_jax(params, model))
    metrics, state = _steps(model, mesh, tokens, targets,
                            data_sharding(mesh, batch_axes, None))
    return {"coords": {a: mpi_rank(a, mesh)
                       for a in ("dp", "tp", "pp", "ep")},
            "metrics": metrics, "params": params_to_jax(model),
            "state": opt_state_to_jax(state, model)}


def pp_train_cases(rank, world, inputs=None):
    """Two steps of each PP config's pipelined step; then, for ROADMAP F8,
    the P function's tp 2 x dp 2 step (no pipeline) and, on rank 0, its
    single-device step, on the pp2_tp2 batch; with ``inputs`` (JAX's
    dropout masks, ``DROP_PP``) the dropout cases of ``pp_dropout``."""
    from blocksparse_tpu_torch import SparseTransformerLM, TransformerConfig
    from blocksparse_tpu_torch.convert import params_from_jax
    out = {}
    for name, (dp, tp, pp, _, _, batch) in PP.items():
        out[name] = _sharded_run(pp_config(name), pp_params(name),
                                 dict(dp=dp, tp=tp, pp=pp),
                                 *pp_tokens(batch))
    tokens, targets = pp_tokens(PP["pp2_tp2"][5])
    out["tp2_dp2"] = _sharded_run(TransformerConfig(**dict(PP_BASE, tp=2)),
                                  pp_params("pp2_tp2"), dict(dp=2, tp=2),
                                  tokens, targets)
    if rank == 0:
        model = SparseTransformerLM(TransformerConfig(**PP_BASE),
                                    device="cpu")
        model.load_state_dict(params_from_jax(pp_params("pp2_mb4"), model))
        out["single"] = _steps(model, None, tokens, targets)[0]
    if inputs is not None:
        out["dropout"] = pp_dropout(inputs)
    return out


# ------------------------------------------ residual dropout, sharded

DROP = 0.1                # resid_pdrop of the dropout cases
DROP_SEED = 3             # every rank's generator seed
DROP_TRAIN = ("tp2_sp2_gather", "tp2_sp2_ring")             # JAX's masks
DROP_PP = ("pp2_dp2", "pp2_mb4")                            # JAX's masks
DROP_SP = {
    # name: (dp, tp, sp, sp_mode), generator runs of the TRAIN "P"
    # function (in the tp layout at tp 2) against the unsharded model
    "dp2_sp2_gather": (2, 1, 2, "gather"),
    "dp2_sp2_ring": (2, 1, 2, "ring"),
    "sp4_gather": (1, 1, 4, "gather"),
    "tp2_sp2_gather": (1, 2, 2, "gather"),
    "dp2_tp2": (2, 2, 1, "gather"),
}


def drop_mask_shape(name):
    """The residual's shape on a rank of a DROP_TRAIN or DROP_PP config:
    (batch/dp, ctx/sp, n_embd), with pp the microbatch's."""
    if name in TRAIN:
        dp, _, sp, _, _ = TRAIN[name]
        c = TRAIN_BASE
        return (len(train_tokens()[0]) // dp, c["ctx"] // sp, c["n_embd"])
    dp, _, pp, fields, _, batch = PP[name]
    n_micro = fields.get("pp_microbatch") or pp
    return (batch // dp // n_micro, PP_BASE["ctx"], PP_BASE["n_embd"])


def _torch_masks(pairs):
    return [tuple(torch.from_numpy(np.asarray(m)) for m in p) for p in pairs]


def _coords(mesh):
    from blocksparse_tpu_torch.parallel import mpi_rank
    return {a: mpi_rank(a, mesh) for a in ("dp", "tp", "sp", "pp", "ep")}


def _local(mesh, spec, *arrays):
    from blocksparse_tpu_torch.parallel import data_sharding
    shard = data_sharding(mesh, *spec)
    return [torch.from_numpy(np.ascontiguousarray(shard.shard(a)))
            for a in arrays]


def _loss_grads(model, x, y, dropout):
    """(loss, {parameter name: gradient}) of ``model.loss``."""
    names, params = zip(*model.named_parameters())
    loss = model.loss(x, y, dropout=dropout)
    return loss.detach(), dict(zip(names, torch.autograd.grad(loss,
                                                              params)))


def _reduced(model, mesh, x, y, dropout):
    """The rank's loss and gradients with ``dropout``, reduced as the
    sharded step reduces them (each gradient over its grad_reduce_axes,
    over dp·sp·ep; the loss over sp, pp and dp): the loss, the grad norm
    and the gradients as the rank's shard of a JAX dict."""
    from blocksparse_tpu_torch import AdamOptimizer, opt_state_to_jax
    loss, grads = _loss_grads(model, x, y, dropout)
    step = model.make_train_step(AdamOptimizer(learning_rate=LR), mesh=mesh)
    grads, loss, gn, _ = step._sharded_grads(grads, loss, torch.ones(()))
    return {"coords": _coords(mesh), "loss": float(loss),
            "grad_norm": float(gn), "grads": opt_state_to_jax(grads, model)}


def _recorded(model):
    """Wraps ``model._dropout_masks`` to log every pair it returns (NumPy,
    in draw order); returns the log."""
    seen, draw = [], model._dropout_masks

    def record(*args, **kw):
        pair = draw(*args, **kw)
        seen.append([_np(m) for m in pair])
        return pair
    model._dropout_masks = record
    return seen


def train_dropout(inputs, tokens, targets):
    """Residual dropout on the sharded LM.  Each DROP_TRAIN config given
    JAX's masks (``inputs[name][sp rank]``), recompute on and off: the
    loss and gradients reduced as the step reduces them.  Each DROP_SP
    mesh given a generator seeded DROP_SEED on every rank: the masks the
    rank drew, its loss averaged over sp, with tp 1 its gradients
    averaged over sp, and the unsharded model's masks, loss and
    gradients on the rank's batch from the same seed."""
    from blocksparse_tpu_torch import SparseTransformerLM, params_from_jax
    from blocksparse_tpu_torch.parallel import allreduce, make_mesh, mpi_rank
    out = {}
    for name in DROP_TRAIN:
        dp, tp, sp, _, _ = TRAIN[name]
        mesh = make_mesh(dp=dp, tp=tp, sp=sp, device="cpu")
        model = SparseTransformerLM(train_config(name, resid_pdrop=DROP),
                                    device="cpu", mesh=mesh)
        model.load_state_dict(params_from_jax(train_params(name), model))
        x, y = _local(mesh, ("dp", "sp"), tokens, targets)
        masks = _torch_masks(inputs[name][mpi_rank("sp", mesh)])
        for recompute in (True, False):
            model.config.recompute = recompute
            out[(name, recompute)] = _reduced(model, mesh, x, y, masks)
    ref = SparseTransformerLM(train_config("dp4", resid_pdrop=DROP),
                              device="cpu")
    ref.load_state_dict(params_from_jax(train_params("dp4"), ref))
    ref_seen = _recorded(ref)
    for name, (dp, tp, sp, mode) in DROP_SP.items():
        mesh = make_mesh(dp=dp, tp=tp, sp=sp, device="cpu")
        model = SparseTransformerLM(
            train_config("dp4", tp=tp, sp=sp, sp_mode=mode,
                         resid_pdrop=DROP), device="cpu", mesh=mesh)
        model.load_state_dict(params_from_jax(
            train_params("dp2_tp2" if tp > 1 else "dp4"), model))
        seen = _recorded(model)
        x, y = _local(mesh, ("dp", "sp"), tokens, targets)
        loss, grads = _loss_grads(model, x, y, torch.Generator()
                                  .manual_seed(DROP_SEED))
        bx, by = _local(mesh, ("dp", None), tokens, targets)
        ref_seen.clear()
        ref_loss, ref_grads = _loss_grads(ref, bx, by, torch.Generator()
                                          .manual_seed(DROP_SEED))
        res = {"coords": _coords(mesh), "masks": seen,
               "ref_masks": list(ref_seen),
               "loss": float(allreduce(loss, axis="sp", mesh=mesh)) / sp,
               "ref_loss": float(ref_loss)}
        if tp == 1:
            res["grads"] = {k: _np(allreduce(g, axis="sp", mesh=mesh) / sp)
                            for k, g in grads.items()}
            res["ref_grads"] = {k: _np(g) for k, g in ref_grads.items()}
        out[name] = res
    return out


def pp_dropout(inputs):
    """Residual dropout through the pipeline (``loss_pp``).  Each DROP_PP
    config given JAX's masks (``inputs[name]``, n_layer pairs at the
    microbatch's shape), recompute on and off: the loss and gradients
    reduced as the step reduces them.  Then generators seeded DROP_SEED:
    pp2_mb4, recompute on and off, its loss twice, and its loss and
    gradients (the shared ones summed over pp) beside the unpipelined
    model's given the pairs the seed draws tiled over the microbatches
    (ROADMAP F11); pp2_tp2's loss beside the unpipelined tp-1 model's so;
    the MoE LM at pp 2 x ep 2 in one microbatch beside the ep-1,
    unpipelined model on the rank's batch from the same seed."""
    from blocksparse_tpu_torch import (SparseTransformerLM,
                                       TransformerConfig, opt_state_to_jax,
                                       params_from_jax)
    from blocksparse_tpu_torch.parallel import allreduce, make_mesh
    out = {}
    for name in DROP_PP:
        dp, tp, pp, _, _, batch = PP[name]
        mesh = make_mesh(dp=dp, tp=tp, pp=pp, device="cpu")
        model = SparseTransformerLM(pp_config(name, resid_pdrop=DROP),
                                    device="cpu", mesh=mesh)
        model.load_state_dict(params_from_jax(pp_params(name), model))
        x, y = _local(mesh, ("dp", None), *pp_tokens(batch))
        masks = _torch_masks(inputs[name])
        for recompute in (True, False):
            model.config.recompute = recompute
            out[(name, recompute)] = _reduced(model, mesh, x, y, masks)

    def gen():
        return torch.Generator().manual_seed(DROP_SEED)

    def tiled(model, x, n_micro):
        shape = (x.shape[0] // n_micro, x.shape[1], model.config.n_embd)
        return [tuple(m.repeat(n_micro, 1, 1) for m in pair)
                for pair in model._stage_masks(gen(), shape, "cpu")]

    def pp_sum(t):
        return allreduce(t, axis="pp", mesh=mesh)
    unpiped = SparseTransformerLM(pp_config("pp2_mb4", pp=1,
                                            resid_pdrop=DROP), device="cpu")
    unpiped.load_state_dict(params_from_jax(pp_params("pp2_mb4"), unpiped))
    for name in ("pp2_mb4", "pp2_tp2"):
        dp, tp, pp, fields, _, batch = PP[name]
        mesh = make_mesh(dp=dp, tp=tp, pp=pp, device="cpu")
        model = SparseTransformerLM(pp_config(name, resid_pdrop=DROP),
                                    device="cpu", mesh=mesh)
        model.load_state_dict(params_from_jax(pp_params(name), model))
        x, y = _local(mesh, ("dp", None), *pp_tokens(batch))
        n_micro = fields.get("pp_microbatch") or pp
        ref_loss, ref_grads = _loss_grads(unpiped, x, y,
                                          tiled(unpiped, x, n_micro))
        for recompute in ((True, False) if tp == 1 else (True,)):
            model.config.recompute = recompute
            loss, grads = _loss_grads(model, x, y, gen())
            res = {"coords": _coords(mesh), "loss": float(pp_sum(loss)),
                   "again": float(pp_sum(model.loss(x, y, dropout=gen())
                                         .detach())),
                   "no_dropout": float(pp_sum(model.loss(x, y).detach())),
                   "ref_loss": float(ref_loss)}
            if tp == 1:
                grads = {k: g if k.startswith("h.") else pp_sum(g)
                         for k, g in grads.items()}
                res["grads"] = opt_state_to_jax(grads, model)
                res["ref_grads"] = opt_state_to_jax(ref_grads, unpiped)
            out[("gen", name, recompute)] = res
    mesh = make_mesh(pp=2, ep=2, device="cpu")
    model = SparseTransformerLM(ep_config("pp2_ep2", pp_microbatch=1,
                                          resid_pdrop=DROP), device="cpu",
                                mesh=mesh)
    model.load_state_dict(params_from_jax(ep_params(), model))
    x, y = _local(mesh, (("dp", "ep"), None), *pp_tokens(EP["pp2_ep2"][4]))
    one = SparseTransformerLM(TransformerConfig(**EP_BASE | dict(
        resid_pdrop=DROP)), device="cpu")
    one.load_state_dict(params_from_jax(ep_params(), one))
    loss, grads = _loss_grads(model, x, y, gen())
    out[("gen", "pp2_ep2")] = {
        "coords": _coords(mesh), "loss": float(pp_sum(loss)),
        "no_dropout": float(pp_sum(model.loss(x, y).detach())),
        "ref_loss": float(one.loss(x, y, dropout=gen()).detach()),
        "finite": all(bool(torch.isfinite(g).all()) for g in grads.values())}
    return out


# ------------------------------------- expert parallelism (4 ranks, "ep")

EP_LAYER = dict(E=8, d=32, h=64, bs=16, density=0.6, T=32)
EP_CASES = [  # (ep, capacity factor, k): 1.25 drops tokens, 8.0 none
    (2, 1.25, 1), (4, 1.25, 2), (4, 8.0, 1)]
EP_AUX = 0.01


def ep_layer(ep, cf, k):
    from blocksparse_tpu_torch.ops.moe import BlocksparseMoE
    c = EP_LAYER
    return BlocksparseMoE(c["E"], c["d"], c["h"], block_size=c["bs"],
                          density=c["density"], capacity_factor=cf, k=k,
                          ep=ep)


def ep_inputs(world=4):
    """The layer's global params (NumPy f32, all E experts), each rank's
    tokens (world, T, d) and cotangents for y."""
    c = EP_LAYER
    rng = np.random.RandomState(11)
    params = {n: (rng.standard_normal(s) * (0.3 if n == "wg" else 0.1))
              .astype(np.float32)
              for n, s in ep_layer(1, 1.25, 1).shapes().items()}
    # tokens of positive mean skew the router: at capacity factor 1.25
    # every rank drops tokens, k 1 and 2
    x = rng.uniform(0, 2, (world, c["T"], c["d"])).astype(np.float32)
    dy = rng.standard_normal((world, c["T"], c["d"])).astype(np.float32)
    return params, x, dy


EP_BASE = dict(n_vocab=64, n_embd=64, n_layer=2, n_head=4, ctx=128,
               blk_size=32, attn_layout="fixed", local_blocks=2,
               mlp_ratio=2, mlp_block_size=16, mlp_density=0.6,
               dtype="float32", recompute=False, moe_experts=4, moe_k=1,
               moe_capacity_factor=1.25)
EP = {
    # name: (dp, pp, ep, config fields, batch).  pp2_ep2_recompute: the
    # path the entry point runs, each block's forward (its all-to-alls
    # too) replayed by torch.utils.checkpoint inside stage_backward
    "dp2_ep2": (2, 1, 2, {}, 4),
    "pp2_ep2": (1, 2, 2, {}, 4),
    "pp2_ep2_recompute": (1, 2, 2, dict(recompute=True), 4),
}


def ep_config(name, **kw):
    from blocksparse_tpu_torch import TransformerConfig
    dp, pp, ep, fields, _ = EP[name]
    return TransformerConfig(**dict(EP_BASE, pp=pp, ep=ep, **fields) | kw)


def ep_params():
    """The global JAX param dict (flat h{l} layers, all experts) every EP
    config starts from: one function."""
    from blocksparse_tpu_torch import (SparseTransformerLM, TransformerConfig,
                                       random_jax_params)
    model = SparseTransformerLM(TransformerConfig(**EP_BASE), device="cpu")
    return random_jax_params(model, seed=8)


def ep_cases(rank, world):
    """The MoE layer at each EP_CASES (tokens and experts split over ep,
    each rank routing its own): the rank's y, aux and the gradients of its
    loss sum(y·dy) + EP_AUX·aux in x, the gate (partial) and its experts;
    two steps of each EP config; the dp 4 step of the same function (the
    batch split four ways, experts whole); the entry point with --pp 2
    --ep 2 --moe_experts 2."""
    import torch
    from blocksparse_tpu_torch import TransformerConfig
    from blocksparse_tpu_torch.parallel import make_mesh, mpi_rank
    out = {}
    params, x, dy = ep_inputs(world)
    for ep, cf, k in EP_CASES:
        mesh = make_mesh(ep=ep, device="cpu")
        r = mpi_rank("ep", mesh)
        moe = ep_layer(ep, cf, k)
        n = moe.E // ep
        local = {name: torch.from_numpy(
            (a if name == "wg" else a[r * n:(r + 1) * n]).copy())
            .requires_grad_() for name, a in params.items()}
        xt = torch.from_numpy(x[rank].copy()).requires_grad_()
        y, aux = moe(local, xt, ep_axis="ep", mesh=mesh)
        loss = (y * torch.from_numpy(dy[rank])).sum() + EP_AUX * aux
        grads = torch.autograd.grad(loss, [xt] + list(local.values()))
        out[("layer", ep, cf, k)] = {
            "ep_rank": r, "y": _np(y), "aux": float(aux.detach()),
            "grads": dict(zip(["x"] + list(local), map(_np, grads)))}
    g = ep_params()
    for name, (dp, pp, ep, _, batch) in EP.items():
        out[name] = _sharded_run(ep_config(name), g, dict(dp=dp, pp=pp,
                                                         ep=ep),
                                 *pp_tokens(batch), batch_axes=("dp", "ep"))
    out["dp4"] = _sharded_run(TransformerConfig(**EP_BASE), g, dict(dp=4),
                              *pp_tokens(EP["dp2_ep2"][4]))
    out["entry"] = _entry_point(["--pp", "2", "--ep", "2", "--moe_experts",
                                 "2", "--n_batch", "4"])
    return out
