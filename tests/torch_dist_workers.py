"""Gloo ranks for the port's parallel tests.

The parallel tests (``test_torch_parallel.py``, ``test_torch_sequence.py``,
``test_torch_sharded_train.py``) run the port on several CPU processes, a
``torch.distributed`` gloo group of ``world`` ranks rendezvousing through a
``FileStore`` in a temporary directory (loopback only).  Each test file
spawns its ranks once (``spawn``), runs one case function of this module
on every rank, and gets back each rank's results (nested dicts of NumPy
arrays and floats), which it holds against the JAX package's ``shard_map``
on the simulated devices of ``tests/conftest.py``.

This module imports no JAX (the spawned ranks import it), and pytest does
not collect it.  The inputs both sides use are made here from seeds.
"""
from __future__ import annotations

import datetime
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

def spawn(case, world, timeout=TIMEOUT):
    """Runs ``case(rank, world)`` (a function of this module, by name) on
    ``world`` gloo ranks and returns the ranks' results in rank order.  A
    rank that raises fails the call with its traceback; ranks that outlive
    ``timeout`` are killed and the call raises."""
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as d:
        procs = [ctx.Process(target=_rank_main, args=(r, world, d, case))
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


def _rank_main(rank, world, d, case):
    try:
        if os.path.exists("/sys/class/net/lo"):
            os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
        torch.set_num_threads(1)
        dist.init_process_group(
            "gloo", store=dist.FileStore(os.path.join(d, "store"), world),
            rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=TIMEOUT - 30))
        result = globals()[case](rank, world)
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


def train_config(name):
    from blocksparse_tpu_torch import TransformerConfig
    return TransformerConfig(**dict(TRAIN_BASE, **TRAIN[name][3]))


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


def train_cases(rank, world):
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


def _entry_point():
    """The enwik8 entry point with --tp 2 --sp 2 for two steps, on a small
    data file of the JAX example's synthetic bytes."""
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
            "--n_batch", "2", "--n_iter", "2", "--tp", "2", "--sp", "2",
            "--data_file", path])
        return enwik8.train(args)


