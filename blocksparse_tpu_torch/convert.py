"""Move parameters between the JAX package and the port.

The JAX ``SparseTransformerLM`` keeps its parameters in a flat dict
(``wte``, ``wpe``, ``lnf_g``, ``lnf_b`` and one ``h{l}`` dict per layer,
or one stacked ``hs`` dict with a leading layer dim), with a leading
tensor-parallel dim of size ``tp`` on block-sparse ``w_fc``/``w_proj``;
an MoE layer holds a ``moe`` dict (``wg``, ``w1``, ``b1``, ``w2``, ``b2``)
in place of the MLP's four, the port's ``h.{l}.moe.*``.
``params_from_jax`` turns such a dict of NumPy arrays into the port's
``state_dict`` and ``params_to_jax`` turns the port's parameters back;
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


def _flat_from_jax(tree):
    """A JAX param-shaped tree -> {port parameter name: leaf}, the leading
    tp dim of 1 dropped from block-sparse ``w_fc``/``w_proj`` arrays.  A
    leaf is an array or a dict of arrays (Adafactor's slots)."""
    flat = {k: tree[k] for k in ("wte", "wpe", "lnf_g", "lnf_b")}
    for l, layer in enumerate(_layers(tree)):
        if "moe" in layer:
            for k in _MOE_KEYS:
                flat[f"h.{l}.moe.{k}"] = layer["moe"][k]
        for k in _ATTN_KEYS + (() if "moe" in layer else _MLP_KEYS):
            a = layer[k]
            if not isinstance(a, dict):
                a = np.asarray(a)
                if k in ("w_fc", "w_proj") and a.ndim == 4:
                    if a.shape[0] != 1:
                        raise NotImplementedError(
                            "tensor-parallel (tp > 1) weights are not "
                            "ported yet")
                    a = a[0]
            flat[f"h.{l}.{k}"] = a
    return flat


def _flat_to_jax(flat, model):
    """{port parameter name: leaf} -> the JAX param layout (flat ``h{l}``
    layers), with the leading tp dim of 1 on block-sparse ``w_fc`` and
    ``w_proj`` arrays."""
    out = {}
    for name, a in flat.items():
        if name.startswith("h."):
            _, l, *path = name.split(".")
            layer = out.setdefault(f"h{l}", {})
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


def params_from_jax(np_params, model=None):
    """JAX param dict (NumPy arrays) -> the port's state dict (f32).

    With ``model`` given, every tensor is also checked against the
    model's own shapes."""
    sd = {k: torch.tensor(np.asarray(a), dtype=torch.float32)
          for k, a in _flat_from_jax(np_params).items()}
    if model is not None:
        _check_shapes(sd, model)
    return sd


def params_to_jax(model):
    """The port's parameters as a JAX param dict of NumPy f32 arrays (flat
    ``h{l}`` layers), with the leading tp dim of 1 on block-sparse
    ``w_fc``/``w_proj``."""
    return _flat_to_jax({k: p.detach().float().cpu().numpy()
                         for k, p in model.state_dict().items()}, model)


def _slots_from_jax(tree, model, dev):
    sd = {k: _tensor(a) for k, a in _flat_from_jax(tree).items()}
    _check_shapes(sd, model)
    return {k: t.to(dev) for k, t in sd.items()}


def opt_state_from_jax(np_state, model):
    """A JAX optimizer state of NumPy arrays -> the port's, on the model's
    device, each slot in its own dtype, keyed by the model's parameter
    names:

    - ``AdamOptimizer``: ``{"mean": params, "var": params, "t": int}``
      (f32, bfloat16 or packed16 uint16 slots);
    - ``AdafactorOptimizer``: ``{"slots": {param: {"cv", "rv"}}, "t"}``;
    - ``Ema``: the averaged param dict itself (f32 or bfloat16).

    t becomes an int32 scalar tensor."""
    dev = model.wte.device

    def step(t):
        return torch.tensor(int(t), dtype=torch.int32, device=dev)
    if "slots" in np_state:
        return {"slots": {k: {s: _tensor(a).to(dev) for s, a in d.items()}
                          for k, d in _flat_from_jax(
                              np_state["slots"]).items()},
                "t": step(np_state["t"])}
    if "mean" in np_state:
        return {"mean": _slots_from_jax(np_state["mean"], model, dev),
                "var": _slots_from_jax(np_state["var"], model, dev),
                "t": step(np_state["t"])}
    return _slots_from_jax(np_state, model, dev)


def opt_state_to_jax(state, model):
    """The port's optimizer state (any of ``opt_state_from_jax``'s three
    forms) as the JAX package's, NumPy arrays of the same dtypes and bits
    (bfloat16 as ml_dtypes' bfloat16) and t an int32."""
    def tree(flat):
        return _flat_to_jax({k: _array(t) for k, t in flat.items()}, model)
    if "slots" in state:
        return {"slots": _flat_to_jax(
            {k: {s: _array(a) for s, a in d.items()}
             for k, d in state["slots"].items()}, model),
                "t": np.int32(int(state["t"]))}
    if "mean" in state:
        return {"mean": tree(state["mean"]), "var": tree(state["var"]),
                "t": np.int32(int(state["t"]))}
    return tree(state)


def random_jax_params(model, seed=0):
    """A JAX-layout param dict of NumPy f32 arrays for ``model``'s config,
    drawn from ``seed`` with the JAX initialiser's scales (normal, std
    0.02, output projections 0.02/sqrt(2·n_layer); gains 1, biases 0; an
    MoE layer's ``wg``, ``w1`` and ``w2`` std 0.02)."""
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
    for l, layer in enumerate(model.h):
        if model.moe is not None:
            mlp = {}
        elif model.bsmm1 is not None:
            mlp = {"w_fc": normal((1,) + model.bsmm1.w_shape, std),
                   "w_proj": normal((1,) + model.bsmm2.w_shape, proj_std)}
        else:
            mlp = {"w_fc": normal(tuple(layer.w_fc.shape), std),
                   "w_proj": normal(tuple(layer.w_proj.shape), proj_std)}
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
    return params


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
