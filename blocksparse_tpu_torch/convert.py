"""Move parameters between the JAX package and the port.

The JAX ``SparseTransformerLM`` keeps its parameters in a flat dict
(``wte``, ``wpe``, ``lnf_g``, ``lnf_b`` and one ``h{l}`` dict per layer,
or one stacked ``hs`` dict with a leading layer dim), with a leading
tensor-parallel dim of size ``tp`` on block-sparse ``w_fc``/``w_proj``;
an MoE layer holds a ``moe`` dict (``wg``, ``w1``, ``b1``, ``w2``, ``b2``)
in place of the MLP's four, the port's ``h.{l}.moe.*``.
``params_from_jax`` turns such a dict of NumPy arrays into the port's
``state_dict`` and ``params_to_jax`` turns the port's parameters back;
with tensor parallelism (tp > 1) the JAX dict holds the global arrays in
the JAX tp layout, ``params_from_jax`` slices the model's tp rank out of
it (``w_qkv``/``b_qkv`` columns [r·3D/tp, (r+1)·3D/tp), ``w_out`` rows
[r·D/tp, ...), the block-sparse ``w_fc``/``w_proj`` at [r] or the dense
ones' column/row slice, ``b_fc`` by hidden/tp), ``params_to_jax`` gives
the rank's shard in the JAX layout and ``jax_from_shards`` assembles the
ranks' shards into the global dict.  With pipeline parallelism (pp > 1)
the JAX dict holds every layer, stacked in ``hs``, and a rank loads its
stage's layers [layer0, layer0 + n_layer/pp) (``pp_rank``, or its mesh's)
and writes them back as ``h{layer0 + l}``; with expert parallelism (ep >
1) a rank loads experts [r·E/ep, (r+1)·E/ep) of each ``moe.w1``, ``b1``,
``w2``, ``b2`` (``ep_rank``, or its mesh's).  Slices only, never a
reorder; ``jax_from_shards(shards, axis)`` joins one axis's shards at a
time (innermost first: tp or ep, then pp);
``opt_state_from_jax`` turns a JAX optimizer state into the port's and
``opt_state_to_jax`` turns one back: an ``AdamOptimizer`` state
(``{"mean", "var", "t"}``, f32, bfloat16 or packed16 uint16 slots), an
``AdafactorOptimizer`` state (``{"slots", "t"}``) or an ``Ema`` state (a
param dict), each slot keeping its dtype and bits.  ``random_jax_params`` makes
a param dict from a seed, with the JAX initialiser's shapes and scales,
for runs that need no checkpoint.

For the block-sparse conv, ``conv_filter_from_jax`` moves a JAX
``BlocksparseConv`` filter onto a device and ``random_jax_conv_filter``
draws one from a seed.

For the sparse LSTM (JAX tree ``wte``, ``w_in``, ``w_out``, ``b_out`` and
a list ``layers`` of ``w_h``, ``b_h``, ``g_h``; ``w_h`` in canonical
blocks, unchanged), ``lstm_params_from_jax`` gives the port's state dict,
``lstm_params_to_jax`` the JAX tree, and ``random_jax_lstm_params`` a tree
drawn from a seed with the JAX ``init``'s shapes and scales.
"""
from __future__ import annotations

import numpy as np
import torch

_ATTN_KEYS = ("ln1_g", "ln1_b", "ln2_g", "ln2_b", "w_qkv", "b_qkv",
              "w_out", "b_out")
_MLP_KEYS = ("w_fc", "b_fc", "w_proj", "b_proj")
_MOE_KEYS = ("wg", "w1", "b1", "w2", "b2")


def _tensor(a):
    """A NumPy array as a CPU tensor of the same dtype and bits (JAX's
    bfloat16, an ml_dtypes array in NumPy, as torch.bfloat16)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).bfloat16()
    return torch.from_numpy(np.array(a))


def _array(t):
    """A tensor as a NumPy array of the same dtype and bits (bfloat16 as
    ml_dtypes' bfloat16, the dtype JAX gives NumPy)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.float().numpy().astype(ml_dtypes.bfloat16)
    return t.numpy()


def _at(tree, l):
    """Layer l of a stacked tree (every array indexed on its first dim)."""
    if isinstance(tree, dict):
        return {k: _at(a, l) for k, a in tree.items()}
    return tree[l]


def _layers(np_params):
    if "hs" in np_params:
        stacked = np_params["hs"]
        n = len(stacked["ln1_g"])
        return [_at(stacked, l) for l in range(n)]
    n = sum(1 for k in np_params if k.startswith("h") and k[1:].isdigit())
    return [np_params[f"h{l}"] for l in range(n)]


# The dim each tp-sharded array of the JAX layout is split along (the
# block-sparse w_fc/w_proj: their leading tp dim, 0).
_TP_DIM = {"w_qkv": 1, "b_qkv": 0, "w_out": 0, "b_fc": 0, "w_fc": 1,
           "w_proj": 0}


def _tp_slice(k, a, tp, rank):
    """Rank ``rank``'s piece of the JAX global array ``a`` of key ``k``
    (tp ranks): a slice, never a reordering; the block-sparse MLP weights'
    leading tp dim indexed."""
    if k in ("w_fc", "w_proj") and a.ndim == 4:
        if a.shape[0] != tp:
            raise ValueError(f"{k}: leading tp dim {a.shape[0]}, model tp "
                             f"{tp}")
        return a[rank]
    if k not in _TP_DIM or tp == 1:
        return a
    d = _TP_DIM[k]
    n = a.shape[d] // tp
    return np.take(a, np.arange(rank * n, (rank + 1) * n), axis=d)


def _rank(model, axis, rank):
    """(size, the rank to load) along ``axis`` ("tp", "pp" or "ep"):
    ``rank``, else the model mesh's."""
    n = 1 if model is None else getattr(model.config, axis)
    if rank is not None or n == 1:
        return n, rank or 0
    if model.mesh is None:
        raise ValueError(f"{axis}={n}: pass {axis}_rank, or bind the model "
                         f"to a mesh, to say which shard to load")
    from blocksparse_tpu_torch.parallel.mesh import mpi_rank
    return n, mpi_rank(axis, model.mesh)


def _coords(model, tp_rank=None, pp_rank=None, ep_rank=None):
    return {"tp": _rank(model, "tp", tp_rank),
            "pp": _rank(model, "pp", pp_rank),
            "ep": _rank(model, "ep", ep_rank)}


def _piece(a, n, r):
    """Piece r of n along a's first dim (a list's items)."""
    step = len(a) // n
    return a[r * step:(r + 1) * step]


def _flat_from_jax(tree, tp=(1, 0), pp=(1, 0), ep=(1, 0)):
    """A JAX param-shaped tree -> {port parameter name: leaf} of one rank,
    at its (size, rank) along tp, pp and ep: the tp rank's piece of each
    tp-sharded array (``_tp_slice``; at tp 1 the leading tp dim of 1
    dropped from block-sparse ``w_fc``/``w_proj``), the pp stage's layers
    renumbered from 0, the ep rank's experts.  A leaf is an array or a
    dict of arrays (Adafactor's slots, unsharded only)."""
    flat = {k: tree[k] for k in ("wte", "wpe", "lnf_g", "lnf_b")}
    layers = _layers(tree)
    if pp[0] > 1:
        layers = _piece(layers, *pp)
    for l, layer in enumerate(layers):
        if "moe" in layer:
            for k in _MOE_KEYS:
                a = layer["moe"][k]
                if ep[0] > 1 and k != "wg":
                    if isinstance(a, dict):
                        raise NotImplementedError(
                            "factored (Adafactor) slots of ep-sharded "
                            "experts: the JAX sharded step takes Adam only")
                    a = _piece(np.asarray(a), *ep)
                flat[f"h.{l}.moe.{k}"] = a
        for k in _ATTN_KEYS + (() if "moe" in layer else _MLP_KEYS):
            a = layer[k]
            if isinstance(a, dict):
                if tp[0] > 1:
                    raise NotImplementedError(
                        "factored (Adafactor) slots of tp-sharded "
                        "parameters: the JAX sharded step takes Adam only")
            else:
                a = _tp_slice(k, np.asarray(a), *tp)
            flat[f"h.{l}.{k}"] = a
    return flat


def _layer0(model, pp_rank):
    """The JAX index of the model's first layer: its stage's."""
    n, r = _rank(model, "pp", pp_rank)
    return r * model.n_local


def _flat_to_jax(flat, model, layer0=0):
    """{port parameter name: leaf} -> the JAX param layout (flat ``h{l}``
    layers, l from ``layer0``), with the leading tp dim of 1 on
    block-sparse ``w_fc`` and ``w_proj`` arrays."""
    out = {}
    for name, a in flat.items():
        if name.startswith("h."):
            _, l, *path = name.split(".")
            layer = out.setdefault(f"h{int(l) + layer0}", {})
            if path[0] == "moe":
                layer.setdefault("moe", {})[path[1]] = a
                continue
            k, = path
            if k in ("w_fc", "w_proj") and model.bsmm1 is not None \
                    and not isinstance(a, dict):
                a = a[None]
            layer[k] = a
        else:
            out[name] = a
    return out


def _check_shapes(sd, model):
    own = model.state_dict()
    if set(own) != set(sd):
        raise ValueError(f"parameter names differ: "
                         f"{sorted(set(own) ^ set(sd))}")
    for k, t in sd.items():
        if tuple(t.shape) != tuple(own[k].shape):
            raise ValueError(f"{k}: {tuple(t.shape)} vs model "
                             f"{tuple(own[k].shape)}")


def params_from_jax(np_params, model=None, tp_rank=None, pp_rank=None,
                    ep_rank=None):
    """JAX param dict (NumPy arrays) -> the port's state dict (f32).

    With ``model`` given, every tensor is also checked against the
    model's own shapes.  A model with tp, pp or ep > 1 gets its rank's
    shard of the JAX global dict: ``tp_rank``/``pp_rank``/``ep_rank``, or
    by default its mesh's."""
    sd = {k: torch.tensor(np.asarray(a), dtype=torch.float32)
          for k, a in _flat_from_jax(np_params, **_coords(
              model, tp_rank, pp_rank, ep_rank)).items()}
    if model is not None:
        _check_shapes(sd, model)
    return sd


def params_to_jax(model, pp_rank=None):
    """The port's parameters as a JAX param dict of NumPy f32 arrays (flat
    ``h{l}`` layers), with the leading tp dim of 1 on block-sparse
    ``w_fc``/``w_proj``; with tp, pp or ep > 1 the rank's shard of the JAX
    global dict (a pp stage's layers at their JAX indices: ``pp_rank``,
    or its mesh's), which ``jax_from_shards`` joins."""
    return _flat_to_jax({k: p.detach().float().cpu().numpy()
                         for k, p in model.state_dict().items()}, model,
                        _layer0(model, pp_rank))


def jax_from_shards(shards, axis="tp"):
    """The JAX tree from the shards of the ranks along one mesh ``axis``,
    in rank order (each a ``params_to_jax`` dict, an ``opt_state_to_jax``
    Adam state or EMA dict, or an earlier join): "tp" concatenates each
    tp-sharded array along its split dim, "ep" each expert array
    (``moe.w1``, ``b1``, ``w2``, ``b2``) along its expert dim, and "pp"
    takes the union of the stages' layers; the rest is rank 0's.  Over
    several axes, join the innermost first (tp or ep, then pp)."""
    if axis not in ("tp", "pp", "ep"):
        raise ValueError(f"axis is tp, pp or ep, not {axis!r}")

    def join(k, leaves):
        a = leaves[0]
        if not isinstance(a, np.ndarray) or a.ndim == 0:
            return a
        if axis == "ep":
            return np.concatenate(leaves) if k in _MOE_KEYS[1:] else a
        if axis == "pp" or k not in _TP_DIM:
            return a
        d = 0 if (k in ("w_fc", "w_proj") and a.ndim == 4) else _TP_DIM[k]
        return np.concatenate(leaves, axis=d)

    def walk(k, nodes):
        if isinstance(nodes[0], dict):
            keys = dict.fromkeys(kk for n in nodes for kk in n)
            return {kk: walk(kk, [n[kk] for n in nodes if kk in n])
                    for kk in keys}
        return join(k, nodes)
    return walk(None, list(shards))


def _slots_from_jax(tree, model, dev, ranks):
    sd = {k: _tensor(a) for k, a in _flat_from_jax(
        tree, **_coords(model, *ranks)).items()}
    _check_shapes(sd, model)
    return {k: t.to(dev) for k, t in sd.items()}


def opt_state_from_jax(np_state, model, tp_rank=None, pp_rank=None,
                       ep_rank=None):
    """A JAX optimizer state of NumPy arrays -> the port's, on the model's
    device, each slot in its own dtype, keyed by the model's parameter
    names (with tp, pp or ep > 1 the rank's shard, as
    ``params_from_jax``):

    - ``AdamOptimizer``: ``{"mean": params, "var": params, "t": int}``
      (f32, bfloat16 or packed16 uint16 slots);
    - ``AdafactorOptimizer``: ``{"slots": {param: {"cv", "rv"}}, "t"}``;
    - ``Ema``: the averaged param dict itself (f32 or bfloat16).

    t becomes an int32 scalar tensor."""
    dev = model.wte.device
    ranks = (tp_rank, pp_rank, ep_rank)

    def step(t):
        return torch.tensor(int(t), dtype=torch.int32, device=dev)
    if "slots" in np_state:
        return {"slots": {k: {s: _tensor(a).to(dev) for s, a in d.items()}
                          for k, d in _flat_from_jax(
                              np_state["slots"],
                              **_coords(model, *ranks)).items()},
                "t": step(np_state["t"])}
    if "mean" in np_state:
        return {"mean": _slots_from_jax(np_state["mean"], model, dev, ranks),
                "var": _slots_from_jax(np_state["var"], model, dev, ranks),
                "t": step(np_state["t"])}
    return _slots_from_jax(np_state, model, dev, ranks)


def opt_state_to_jax(state, model, pp_rank=None):
    """The port's optimizer state (any of ``opt_state_from_jax``'s three
    forms) as the JAX package's, NumPy arrays of the same dtypes and bits
    (bfloat16 as ml_dtypes' bfloat16) and t an int32; a pp stage's layers
    at their JAX indices, as ``params_to_jax``."""
    layer0 = _layer0(model, pp_rank)

    def tree(flat):
        return _flat_to_jax({k: _array(t) for k, t in flat.items()}, model,
                            layer0)
    if "slots" in state:
        return {"slots": _flat_to_jax(
            {k: {s: _array(a) for s, a in d.items()}
             for k, d in state["slots"].items()}, model, layer0),
                "t": np.int32(int(state["t"]))}
    if "mean" in state:
        return {"mean": tree(state["mean"]), "var": tree(state["var"]),
                "t": np.int32(int(state["t"]))}
    return tree(state)


def random_jax_params(model, seed=0):
    """A JAX-layout param dict of NumPy f32 arrays for ``model``'s config,
    drawn from ``seed`` with the JAX initialiser's scales (normal, std
    0.02, output projections 0.02/sqrt(2·n_layer); gains 1, biases 0; an
    MoE layer's ``wg``, ``w1`` and ``w2`` std 0.02).  With tp, pp or ep >
    1 the global arrays of the JAX init's shapes (a block-sparse MLP
    weight with a leading tp dim, all n_layer layers, all E experts), of
    which each rank loads its shard; with pp > 1 the layers stacked in
    ``hs``, as the JAX init's (the same draws as the flat layers of the
    pp-1 model)."""
    c = model.config
    rng = np.random.RandomState(seed)
    std = 0.02
    proj_std = std / np.sqrt(2 * c.n_layer)

    def normal(shape, s):
        return (rng.standard_normal(shape) * s).astype(np.float32)

    params = {"wte": normal((c.n_vocab, c.n_embd), std),
              "wpe": normal((c.ctx, c.n_embd), std),
              "lnf_g": np.ones(c.n_embd, np.float32),
              "lnf_b": np.zeros(c.n_embd, np.float32)}
    for l in range(c.n_layer):
        if model.moe is not None:
            mlp = {}
        elif model.bsmm1 is not None:
            mlp = {"w_fc": normal((c.tp,) + model.bsmm1.w_shape, std),
                   "w_proj": normal((c.tp,) + model.bsmm2.w_shape, proj_std)}
        else:
            mlp = {"w_fc": normal((c.n_embd, model.hidden), std),
                   "w_proj": normal((model.hidden, c.n_embd), proj_std)}
        params[f"h{l}"] = {
            "ln1_g": np.ones(c.n_embd, np.float32),
            "ln1_b": np.zeros(c.n_embd, np.float32),
            "ln2_g": np.ones(c.n_embd, np.float32),
            "ln2_b": np.zeros(c.n_embd, np.float32),
            "w_qkv": normal((c.n_embd, 3 * c.n_embd), std),
            "b_qkv": np.zeros(3 * c.n_embd, np.float32),
            "w_out": normal((c.n_embd, c.n_embd), proj_std),
            "b_out": np.zeros(c.n_embd, np.float32)}
        if model.moe is not None:
            params[f"h{l}"]["moe"] = {
                k: (np.zeros(shape, np.float32) if k.startswith("b")
                    else normal(shape, std))
                for k, shape in model.moe.shapes().items()}
        else:
            params[f"h{l}"].update(
                w_fc=mlp["w_fc"], b_fc=np.zeros(model.hidden, np.float32),
                w_proj=mlp["w_proj"], b_proj=np.zeros(c.n_embd, np.float32))
    if c.pp > 1:
        params["hs"] = _stacked([params.pop(f"h{l}")
                                 for l in range(c.n_layer)])
    return params


def _stacked(layers):
    """Per-layer trees stacked on a leading layer dim (the JAX ``hs``)."""
    if isinstance(layers[0], dict):
        return {k: _stacked([t[k] for t in layers]) for k in layers[0]}
    return np.stack(layers)


def conv_filter_from_jax(F, conv, device):
    """A JAX ``BlocksparseConv`` filter (a NumPy array of ``conv.f_shape()``,
    f32, f16 or bf16) as a tensor of the same dtype on ``device``."""
    a = np.asarray(F)
    if list(a.shape) != list(conv.f_shape()):
        raise ValueError(f"filter shape {list(a.shape)} is not the conv's "
                         f"f_shape() {list(conv.f_shape())}")
    if a.dtype.name == "bfloat16":        # NumPy holds JAX bf16 as ml_dtypes
        return torch.tensor(a.astype(np.float32), device=device).bfloat16()
    return torch.tensor(a, device=device)


def random_jax_conv_filter(conv, seed=0):
    """A filter of ``conv.f_shape()`` as NumPy f32, uniform in [-0.1, 0.1)
    from ``seed`` (the range of the repo's conv benchmark)."""
    rng = np.random.RandomState(seed)
    return rng.uniform(-0.1, 0.1, conv.f_shape()).astype(np.float32)


def lstm_params_from_jax(np_params, model=None):
    """A JAX ``SparseLSTM`` param tree (NumPy arrays) -> the port's state
    dict (f32), checked against ``model``'s shapes where given."""
    sd = {k: torch.tensor(np.asarray(np_params[k]), dtype=torch.float32)
          for k in ("wte", "w_in", "w_out", "b_out")}
    for l, layer in enumerate(np_params["layers"]):
        for k, a in layer.items():
            sd[f"layers.{l}.{k}"] = torch.tensor(np.asarray(a),
                                                 dtype=torch.float32)
    if model is not None:
        _check_shapes(sd, model)
    return sd


def lstm_params_to_jax(model):
    """The port's ``SparseLSTM`` parameters as the JAX param tree of NumPy
    f32 arrays."""
    out = {"layers": [{} for _ in model.layers]}
    for name, p in model.state_dict().items():
        a = p.detach().float().cpu().numpy()
        if name.startswith("layers."):
            _, l, k = name.split(".")
            out["layers"][int(l)][k] = a
        else:
            out[name] = a
    return out


def random_jax_lstm_params(model, seed=0):
    """A JAX-layout ``SparseLSTM`` param tree of NumPy f32 arrays for
    ``model``'s config, drawn from ``seed`` with the JAX ``init``'s shapes
    and scales: ``wte``, ``w_in``, ``w_out`` normal with std 0.05,
    ``b_out`` and ``b_h`` 0, ``g_h`` 1, each ``w_h`` orthogonal blocks
    (``ortho_init``'s construction, drawn from this seed rather than the
    global ``np.random``)."""
    c = model.config
    rng = np.random.RandomState(seed)

    def normal(shape):
        return (rng.standard_normal(shape) * 0.05).astype(np.float32)

    params = {"wte": normal((c.n_vocab, c.nembd)),
              "w_in": normal((c.nembd, model.proj_in.nproj)),
              "w_out": normal((model.proj_out.nproj, c.n_vocab)),
              "b_out": np.zeros(c.n_vocab, np.float32), "layers": []}
    for bsmm in model.bsmm_layers:
        layer = {"w_h": bsmm._ortho_blocks(rng.normal),
                 "b_h": np.zeros(4 * c.nhidden, np.float32)}
        if c.layernorm:
            layer["g_h"] = np.ones(4 * c.nhidden, np.float32)
        params["layers"].append(layer)
    return params
