"""Sparse Transformer language model: serving, and training on one device or
sharded over data, tensor, sequence, pipeline and expert parallel ranks.

Counterpart of ``blocksparse_tpu/models/sparse_transformer.py``:
layout-driven block-sparse attention (fixed/strided/dense
patterns with a causal sub-block mask), an optionally block-sparse MLP or
a top-k Mixture-of-Experts MLP (``moe_experts``, ``ops/moe.py``), layer
norm and fast-gelu, with ``forward``, ``prefill``,
``decode_forward``, ``generate``, ``generate_cached`` and
``generate_cached_scan`` for serving and ``loss`` and ``make_train_step``
(clip by global norm, Adam, dynamic loss scaling, per-block recompute)
for training.  On the card the loops leave the host: the decode step of
``generate_cached_scan`` is one CUDA graph replayed a token, and the
train step one CUDA graph replayed a step (the counterparts of the JAX
package's ``lax.scan`` and ``jax.jit``).  Parameters carry the JAX package's
names and shapes (``convert.params_from_jax`` loads a JAX param dict,
``convert.params_to_jax`` writes one), so both packages compute the same
thing from the same weights.

Residual dropout (``resid_pdrop``) acts where the JAX package's does:
through ``loss`` (``loss_pp`` with pp > 1) and ``forward`` given a dropout
source, never in ``make_train_step`` (the JAX train step passes no dropout
key: ROADMAP F3).  Sharded, the ranks draw from a ``torch.Generator`` as
JAX's ranks draw from its key: tp ranks alike (the residual is
replicated), from the caller's seed; sp shards each their own masks, which
the model makes so by drawing the full context and keeping the shard's
slice (JAX folds the sp index into the key), so they are the unsharded
model's masks from the same seed; dp ranks as the caller's generators
give them (JAX leaves the key to its caller); pp stages each their own
layers' masks of one draw of all n_layer layers (``loss_pp``).  With MoE
the loss adds ``moe_aux_coef`` times the layers' summed load-balance
loss, and the KV-cached decode raises as the JAX package's asserts
(``generate``, a full forward a token, works).

Parallelism (``config.tp``, ``sp``, ``sp_mode``; a ``DeviceMesh`` from
``parallel.make_mesh``, one process a rank): the model holds its rank's
shard, as the JAX ``shard_map`` hands each device its piece.  dp splits
the batch and sums the gradients.  tp is Megatron's: each rank holds
n_head/tp heads (``w_qkv``/``b_qkv`` in the JAX per-shard column layout:
rank r's columns [r·3D/tp, (r+1)·3D/tp), split into its q|k|v) and
hidden/tp of the MLP (the block-sparse MLP's layout drawn at
``hidden_local``, the same on every rank), and the output projection and
the MLP end in an all-reduce over "tp" whose gradient is an all-reduce of
dy, as JAX's transpose of ``psum`` under ``check_vma=False``: so the
sharded step's gradients, and its grad_norm, are tp times the true ones
(ROADMAP F8, carried over and pinned).  sp splits the context: the
forward offsets ``wpe`` by the rank's shard and the attention runs
``parallel.sequence``'s gather or ring mode.  pp is GPipe
(``parallel.pipeline``): the rank holds its stage's n_layer/pp blocks,
layers [layer0, layer0 + n_layer/pp) of the JAX model with layer0 = its pp
rank · n_layer/pp, and ``loss`` runs ``loss_pp``: the embedding on every
stage, ``pp_microbatch`` (or pp) microbatches through ``gpipe`` with each
stage's MoE aux, ``broadcast_from_last``, and the head on every stage;
its value is the true loss / pp plus the stage's aux term.  ep splits an
MoE's experts (``ops/moe.py``): the rank holds E/ep of them and routes its
own tokens (the batch splits over dp·ep).  ``convert.params_from_jax``
loads the rank's shard of a JAX param dict.

On the card a step with pp or ep > 1 runs eagerly by design: its point-
to-point sends and all-to-alls need several ranks, which NCCL gives one
card each, and the card's host has one; the single-device and the other
sharded steps stay one CUDA graph.
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.utils.checkpoint import checkpoint

from blocksparse_tpu_torch.ops import optimize as opt
from blocksparse_tpu_torch.ops.embed import embedding_lookup
from blocksparse_tpu_torch.ops.ewops import (dropout, fast_gelu,
                                              float_cast, uniform)
from blocksparse_tpu_torch.ops.matmul import BlocksparseMatMul
from blocksparse_tpu_torch.ops.moe import BlocksparseMoE
from blocksparse_tpu_torch.ops.norms import layer_norm
from blocksparse_tpu_torch.ops.transformer import (BlocksparseTransformer,
                                                   position_tensor,
                                                   softmax_cross_entropy)
from blocksparse_tpu_torch.parallel import collectives as col
from blocksparse_tpu_torch.parallel import sequence as seq
from blocksparse_tpu_torch.parallel.mesh import axis_group, mpi_rank, \
    mpi_size
from blocksparse_tpu_torch.utils import default_device

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def causal_subblock_mask(blk_shape, head, qry, key, blk):
    """Sub-block causal mask on the diagonal."""
    mask = np.ones(blk_shape, dtype=bool)
    if qry == key:
        for q in range(blk_shape[0]):
            mask[q, q + 1:] = 0
    return mask


def fixed_layout(ctx_blks, local_blocks=32, num_verts=4):
    """'Fixed' Sparse-Transformer pattern: blockwise causal local window
    plus periodic summary columns."""
    layout = np.zeros((ctx_blks, ctx_blks), dtype=np.int32)
    for q in range(ctx_blks):
        lo = max(0, q - local_blocks + 1)
        layout[q, lo:q + 1] = 1
        for k in range(0, q, num_verts):
            layout[q, k] = 1
    return layout


def strided_layout(ctx_blks, local_blocks=32, stride=None):
    """'Strided' pattern: local band plus strided history."""
    stride = stride or max(1, int(np.sqrt(ctx_blks)))
    layout = np.zeros((ctx_blks, ctx_blks), dtype=np.int32)
    for q in range(ctx_blks):
        lo = max(0, q - local_blocks + 1)
        layout[q, lo:q + 1] = 1
        k = q - stride
        while k >= 0:
            layout[q, k] = 1
            k -= stride
    return layout


def dense_causal_layout(ctx_blks):
    return np.tril(np.ones((ctx_blks, ctx_blks), dtype=np.int32))


_LAYOUTS = {
    "fixed": fixed_layout,
    "strided": strided_layout,
    "dense": dense_causal_layout,
}


@dataclass
class TransformerConfig:
    """The JAX package's config, field for field.  ``recompute`` reruns
    each block's forward in the backward (``torch.utils.checkpoint``);
    ``stack_layers`` shapes only the JAX parameter storage and changes no
    result here (the JAX stacked layers, which its pipelined loss needs,
    key their dropout masks by ``fold_in``, the unstacked by ``split``: a
    generator's stream is the port's own, and JAX's masks of either kind
    go in as ``loss``'s list form).  ``resid_pdrop`` drops each block's
    two residual branches when ``loss``/``forward`` get a dropout source,
    at any tp, sp and pp.  ``moe_experts`` > 0 replaces each MLP by a
    ``BlocksparseMoE`` (block-sparse experts at ``mlp_block_size``).  tp,
    sp, sp_mode, pp (with ``pp_microbatch`` microbatches, 0 for pp) and ep
    shard the model over a mesh (the module's docstring)."""
    n_vocab: int = 256
    n_embd: int = 512
    n_layer: int = 6
    n_head: int = 8
    ctx: int = 2048
    blk_size: int = 64
    attn_layout: str = "fixed"        # fixed | strided | dense
    local_blocks: int = 8
    mlp_ratio: int = 4
    mlp_block_size: int = 0           # 0 => dense MLP; else bsmm block size
    mlp_density: float = 1.0
    dtype: str = "bfloat16"           # compute dtype
    recompute: bool = True
    resid_pdrop: float = 0.0
    tp: int = 1
    sp: int = 1
    sp_mode: str = "gather"
    pp: int = 1
    pp_microbatch: int = 0
    stack_layers: bool = False
    moe_experts: int = 0
    moe_k: int = 1
    moe_capacity_factor: float = 1.25
    moe_aux_coef: float = 0.01
    ep: int = 1


def _check_supported(c: TransformerConfig):
    """The JAX constructor's asserts, as ValueErrors."""
    if c.ep != 1 and not c.moe_experts:
        raise ValueError("ep needs moe_experts > 0")
    if c.pp < 1 or c.ep < 1 or c.pp_microbatch < 0:
        raise ValueError(f"pp {c.pp} and ep {c.ep} must be at least 1, "
                         f"pp_microbatch {c.pp_microbatch} at least 0")
    if c.n_layer % c.pp:
        raise ValueError(f"n_layer {c.n_layer} must divide by pp {c.pp}")
    if c.pp > 1 and c.sp > 1:
        raise ValueError("pp x sp composition not supported (pick one of "
                         "pipeline/sequence parallelism; both compose with "
                         "dp and tp), as in the JAX package")
    if c.moe_experts % c.ep:
        raise ValueError(f"moe_experts {c.moe_experts} must divide by ep "
                         f"{c.ep}")
    if c.tp < 1 or c.sp < 1 or c.n_head % c.tp:
        raise ValueError(f"n_head {c.n_head} must divide by tp {c.tp}")
    if (c.ctx // c.blk_size) % c.sp:
        raise ValueError("ctx block-rows must divide by sp shards")
    if c.sp_mode not in ("gather", "ring"):
        raise ValueError(f"sp_mode is gather or ring, not {c.sp_mode!r}")
    if c.moe_experts and (c.tp > 1 or c.sp > 1):
        raise ValueError("MoE composes with dp x ep x pp (tp/sp + MoE: "
                         "future), as in the JAX package")
    if not 0.0 <= c.resid_pdrop < 1.0:
        raise ValueError("resid_pdrop must lie in [0, 1)")
    if c.dtype not in _DTYPES:
        raise ValueError(f"unknown dtype {c.dtype!r}")
    if c.ctx % c.blk_size:
        raise ValueError("ctx must be a multiple of blk_size")


def _param(*shape, fill=0.0):
    """A trainable f32 master parameter."""
    return nn.Parameter(torch.full(shape, fill))


class _Layer(nn.Module):
    """One transformer block's parameters (the JAX ``h{l}`` dict, the
    rank's shard of it: ``d_local`` = n_embd/tp columns of each of q, k
    and v, ``hidden`` the MLP's hidden/tp): with ``moe`` (a
    ``BlocksparseMoE``) a ``moe`` dict of its parameters, the rank's E/ep
    experts, in place of the MLP's four."""

    def __init__(self, c: TransformerConfig, d_local, hidden, w_fc_shape,
                 w_proj_shape, moe=None):
        super().__init__()
        self.ln1_g = _param(c.n_embd, fill=1.0)
        self.ln1_b = _param(c.n_embd)
        self.ln2_g = _param(c.n_embd, fill=1.0)
        self.ln2_b = _param(c.n_embd)
        self.w_qkv = _param(c.n_embd, 3 * d_local)
        self.b_qkv = _param(3 * d_local)
        self.w_out = _param(d_local, c.n_embd)
        self.b_out = _param(c.n_embd)
        if moe is not None:
            self.moe = nn.ParameterDict({
                k: _param(*shape)
                for k, shape in moe.shapes(local=True).items()})
            return
        self.w_fc = _param(*w_fc_shape)
        self.b_fc = _param(hidden)
        self.w_proj = _param(*w_proj_shape)
        self.b_proj = _param(c.n_embd)


class SparseTransformerLM(nn.Module):
    """The flagship LM: forward, KV-cached decode, loss and the train step,
    on one device or, with tp/sp/pp/ep > 1 or a ``mesh``, as one rank's
    shard (with pp its stage: ``n_local`` = n_layer/pp blocks in ``h``).

    Parameters start as zeros (gains as ones); load real ones with
    ``load_state_dict(convert.params_from_jax(...))``.  They hold f32
    masters and are cast to ``config.dtype`` at use, as in the JAX
    package.  The model lives on ``device``: by default the CUDA card
    (a host without one raises), ``device="cpu"`` for the CPU.
    impl=None runs the CUDA kernels on a CUDA device (the plain versions
    on the CPU); impl="xla" runs the plain versions everywhere, the
    reference the kernels are held against on the card.

    ``mesh``: the ``DeviceMesh`` (``parallel.make_mesh``) this rank's
    shard lives on, needed where tp, sp, pp or ep > 1
    (``make_train_step(mesh=)`` sets it too); its shapes come from the
    config alone (n_head/tp heads, ``hidden_local``, n_layer/pp blocks,
    E/ep experts), as the JAX constructor's."""

    def __init__(self, config: TransformerConfig, device=None, impl=None,
                 mesh=None):
        super().__init__()
        c = self.config = config
        _check_supported(c)
        if impl not in (None, "xla"):
            raise ValueError(f"unknown impl {impl!r}")
        self.impl = impl
        self.mesh = None
        self.hs = c.n_embd // c.n_head
        self.n_local = c.n_layer // c.pp
        self.heads_local = c.n_head // c.tp
        self.d_local = self.heads_local * self.hs
        ctx_blks = c.ctx // c.blk_size
        layout = _LAYOUTS[c.attn_layout](
            ctx_blks, **({} if c.attn_layout == "dense"
                         else {"local_blocks": c.local_blocks}))
        self.bst = BlocksparseTransformer(
            layout, block_size=c.blk_size, heads=self.heads_local,
            mask_callback=causal_subblock_mask, impl=impl)

        self.hidden = c.mlp_ratio * c.n_embd
        self.hidden_local = self.hidden // c.tp
        self.moe = None
        if c.moe_experts:
            self.moe = BlocksparseMoE(
                c.moe_experts, c.n_embd, self.hidden,
                block_size=c.mlp_block_size, density=c.mlp_density,
                capacity_factor=c.moe_capacity_factor, k=c.moe_k, ep=c.ep,
                impl=impl)
        if c.mlp_block_size and not c.moe_experts:
            bs = c.mlp_block_size
            CB = c.n_embd // bs
            KB = self.hidden_local // bs
            rng = np.random.RandomState(0)
            lay1 = (rng.rand(CB, KB) < c.mlp_density).astype(np.int32)
            lay1[np.arange(CB), np.arange(CB) % KB] = 1   # no empty rows
            lay1[np.arange(KB) % CB, np.arange(KB)] = 1
            self.bsmm1 = BlocksparseMatMul(lay1, block_size=bs,
                                           feature_axis=1, impl=impl)
            self.bsmm2 = BlocksparseMatMul(lay1.T.copy(), block_size=bs,
                                           feature_axis=1, impl=impl)
            w_fc_shape, w_proj_shape = self.bsmm1.w_shape, self.bsmm2.w_shape
        else:
            self.bsmm1 = self.bsmm2 = None
            w_fc_shape = (c.n_embd, self.hidden_local)
            w_proj_shape = (self.hidden_local, c.n_embd)

        self.wte = _param(c.n_vocab, c.n_embd)
        self.wpe = _param(c.ctx, c.n_embd)
        self.lnf_g = _param(c.n_embd, fill=1.0)
        self.lnf_b = _param(c.n_embd)
        self.h = nn.ModuleList(
            _Layer(c, self.d_local, self.hidden_local, w_fc_shape,
                   w_proj_shape, self.moe)
            for _ in range(self.n_local))
        self._decode_graphs = {}      # generate_cached_scan's, by key
        self.to(default_device(device, "SparseTransformerLM"))
        if mesh is not None:
            self._use_mesh(mesh)

    # ---------------- the mesh ----------------

    def _use_mesh(self, mesh):
        """Binds this rank's shard to ``mesh``, checking its tp, sp, pp and
        ep sizes against the config."""
        if not isinstance(mesh, DeviceMesh):
            raise TypeError(f"mesh must be a DeviceMesh (make_mesh), not "
                            f"{type(mesh).__name__}")
        if self.mesh is not None and mesh is not self.mesh:
            raise ValueError("the model is bound to another mesh")
        for axis in ("tp", "sp", "pp", "ep"):
            want = getattr(self.config, axis)
            if mpi_size(mesh, axis) != want:
                raise ValueError(f"config.{axis} = {want} needs a mesh whose "
                                 f"{axis!r} axis has {want} ranks "
                                 f"(make_mesh({axis}={want}))")
        self.mesh = mesh

    def _sharded(self):
        """The mesh, or None on one device; raises where the config shards
        the model and no mesh is bound."""
        c = self.config
        if self.mesh is None and max(c.tp, c.sp, c.pp, c.ep) > 1:
            raise ValueError(f"tp={c.tp}, sp={c.sp}, pp={c.pp}, ep={c.ep}: "
                             f"the model is one rank's shard; bind it to a "
                             f"mesh (SparseTransformerLM(mesh=) or "
                             f"make_train_step(mesh=))")
        return self.mesh

    def _tp_sum(self, y):
        """The JAX ``psum`` over "tp" that ends the attention and the MLP:
        an all-reduce whose gradient is an all-reduce of dy (F8)."""
        if self._sharded() is None:
            return y
        return col.allreduce(y, axis="tp", mesh=self.mesh)

    def param_specs(self):
        """Per parameter name, the mesh axes its dims are split over (the
        JAX ``PartitionSpec`` tree, as tuples): the tp-sharded qkv,
        output projection and MLP; the block-sparse MLP weights, whose
        JAX leading tp dim the port drops, name "tp" on their block dim;
        the MoE's experts "ep" on their expert dim.  A pp stage's blocks,
        whose JAX leading layer dim the port drops, are also split over
        "pp" (``param_shard_axes``)."""
        specs = {}
        moe = self.moe.param_specs() if self.moe is not None else {}
        for name, p in self.named_parameters():
            key = name.split(".")[-1]
            spec = {"w_qkv": (None, "tp"), "b_qkv": ("tp",),
                    "w_out": ("tp", None), "b_fc": ("tp",),
                    "w_fc": (None, "tp"), "w_proj": ("tp", None)}.get(key)
            if key in ("w_fc", "w_proj") and self.bsmm1 is not None:
                spec = ("tp", None, None)
            if ".moe." in name:
                spec = moe[key]
            specs[name] = spec or (None,) * p.dim()
        return specs

    def param_shard_axes(self):
        """Per parameter name, the mesh axes it is split over (pp first for
        a stage's blocks, as JAX's stacked spec): the global grad norm sums
        each such parameter's squares over them, so every rank computes
        one norm_scale."""
        stage = ("pp",) if self.config.pp > 1 else ()
        return {name: tuple(dict.fromkeys(
            (stage if name.startswith("h.") else ()) + tuple(
                a for a in spec if a)))
            for name, spec in self.param_specs().items()}

    def grad_reduce_axes(self, include_sp=False):
        """Per parameter name, the mesh axes its gradient is summed over:
        each of dp, tp, pp (pp > 1) and ep (ep > 1) that the parameter is
        not split over (its ranks hold partial sums: tp's of a replicated
        parameter, pp's of the embeddings, final norm and head, where
        ``loss_pp``'s 1/pp makes the sum exact, ep's of the gate and every
        other parameter, since the batch splits over dp·ep), and sp with
        sequence parallelism."""
        c = self.config
        active = ("dp", "tp") + (("pp",) if c.pp > 1 else ()) + (
            ("ep",) if c.ep > 1 else ())
        sp = ("sp",) if include_sp else ()
        return {name: tuple(a for a in active if a not in split) + sp
                for name, split in self.param_shard_axes().items()}

    @property
    def nd(self):
        return _DTYPES[self.config.dtype]

    # ---------------- blocks ----------------

    def _qkv(self, layer, x):
        nd = self.nd
        h = float_cast(layer_norm(x, layer.ln1_g, layer.ln1_b, axis=-1), nd)
        qkv = h @ float_cast(layer.w_qkv, nd) + layer.b_qkv.to(nd)
        return qkv.split(self.d_local, dim=-1)

    def _attend(self, q, k, v):
        # the fused kernels up to hs 128, the unfused ops past it, as the
        # JAX model; impl="xla" keeps both routes on their plain versions.
        # With sp the context-sharded attention (fused kernels only).
        c = self.config
        scale = 1.0 / np.sqrt(self.hs)
        if c.sp > 1 and self._sharded() is not None:
            fn = (seq.ring_attention if c.sp_mode == "ring"
                  else seq.sequence_parallel_attention)
            return fn(self.bst, q, k, v, axis="sp", n_shards=c.sp,
                      scale=scale, mesh=self.mesh)
        return self.bst.attention(q, k, v, scale=scale)

    def _mlp(self, layer, x):
        """(y, aux): the MLP's output and its load-balance loss (None
        without MoE).  The MoE's y is f32 (its f32 expert weights, ROADMAP
        F6), the other MLPs' of the compute dtype."""
        nd = self.nd
        h = float_cast(layer_norm(x, layer.ln2_g, layer.ln2_b, axis=-1), nd)
        if self.moe is not None:
            B, L, D = h.shape
            if self.config.ep > 1:
                y, aux = self.moe(layer.moe, h.reshape(B * L, D),
                                  ep_axis="ep", mesh=self._sharded())
            else:
                y, aux = self.moe(layer.moe, h.reshape(B * L, D))
            return y.reshape(B, L, D), aux
        if self.bsmm1 is not None:
            h = self.bsmm1(h, float_cast(layer.w_fc, nd))
        else:
            h = h @ float_cast(layer.w_fc, nd)
        h = fast_gelu(h + layer.b_fc.to(nd))
        if self.bsmm2 is not None:
            h = self.bsmm2(h, float_cast(layer.w_proj, nd))
        else:
            h = h @ float_cast(layer.w_proj, nd)
        return self._tp_sum(h) + layer.b_proj.to(nd), None

    def _out(self, layer, a):
        nd = self.nd
        return self._tp_sum(a.to(nd) @ float_cast(layer.w_out, nd)) \
            + layer.b_out.to(nd)

    def _logits(self, x):
        nd = self.nd
        h = layer_norm(x, self.lnf_g, self.lnf_b, axis=-1)
        return (h.to(nd) @ float_cast(self.wte, nd).t()).float()

    def _embed(self, tokens, wpe):
        return (embedding_lookup(self.wte, tokens) + wpe).float()

    def _block(self, layer, x, caches=None, masks=None):
        """One transformer block: (x, the MLP's load-balance loss or None);
        appends
        its K/V to ``caches`` when given.  ``masks``: the (attention, MLP)
        residual dropout masks, or None."""
        keep = 1.0 - self.config.resid_pdrop

        def drop(h, i):
            return h if masks is None else dropout(h, keep, mask=masks[i])[0]
        q, k, v = self._qkv(layer, x)
        if caches is not None:
            caches.append({"k": k.contiguous(), "v": v.contiguous()})
        x = x + drop(self._out(layer, self._attend(q, k, v)), 0).to(x.dtype)
        m, aux = self._mlp(layer, x)
        return x + drop(m, 1).to(x.dtype), aux

    def _dropout_masks(self, source, l, shape, device, off=0, ctx=None):
        """Layer l's two residual dropout masks of the residual's
        ``shape`` (batch, L, d) from ``source``, or None.

        A ``torch.Generator`` draws each mask at (batch, ``ctx``, d), ctx
        the full context (default L), and keeps positions [off, off + L):
        so every sp shard keeps its own slice of one draw, the unsharded
        model's masks from the same seed, where JAX folds the sp index
        into its key; tp ranks, whose residual is replicated, draw alike
        from generators seeded alike.  Per-layer mask pairs (JAX's masks)
        give ``source[l]``, already at ``shape``."""
        p = self.config.resid_pdrop
        if source is None or not p:
            return None
        if isinstance(source, torch.Generator):
            B, L, d = shape
            full = (B, L if ctx is None else ctx, d)
            return tuple((uniform(full, device, source) < 1.0 - p)
                         [:, off:off + L].contiguous() for _ in range(2))
        return tuple(m.to(device) for m in source[l])

    def _full_context(self, tokens, caches=None, dropout=None):
        """(logits over all positions, the layers' summed load-balance loss
        or None without MoE); appends each layer's K/V to ``caches`` when
        given.  With ``config.recompute`` and a gradient
        to take, each block's activations are recomputed in the backward
        (the JAX ``jax.checkpoint`` per block).  A block's dropout masks
        are drawn before its checkpoint, so the recompute reuses them and
        the checkpoint saves no RNG state (which a CUDA graph capture
        forbids).  The MoE's routing is a function of the block's input,
        so the recompute routes every token as the forward did.  With sp,
        ``tokens`` are the rank's context shard, at its offset into
        ``wpe`` and into the full context's dropout masks.  A pipeline
        stage holds only its blocks: with pp > 1 this raises (``loss``
        runs the pipeline)."""
        if self.config.pp > 1:
            raise ValueError(f"pp={self.config.pp}: the model is one "
                             f"pipeline stage ({self.n_local} of "
                             f"{self.config.n_layer} blocks); loss runs the "
                             f"pipeline (loss_pp)")
        L, n_sp = tokens.shape[1], 1
        off = 0
        if self.config.sp > 1 and self._sharded() is not None:
            n_sp, off = self.config.sp, mpi_rank("sp", self.mesh) * L
        x = self._embed(tokens, self.wpe[None, off:off + L])
        recompute = self.config.recompute and torch.is_grad_enabled()
        aux = None
        for l, layer in enumerate(self.h):
            masks = self._dropout_masks(dropout, l, x.shape, x.device, off,
                                        n_sp * L)
            if recompute and caches is None:
                x, a = checkpoint(self._block, layer, x, None, masks,
                                  use_reentrant=False,
                                  preserve_rng_state=False)
            else:
                x, a = self._block(layer, x, caches, masks)
            if a is not None:
                aux = a if aux is None else aux + a
        return self._logits(x), aux

    # ---------------- forward ----------------

    @torch.no_grad()
    def forward(self, tokens, dropout=None, return_aux=False):
        """tokens (batch, L) int -> logits (batch, L, n_vocab) f32, and with
        ``return_aux`` the layers' summed MoE load-balance loss (zero
        without MoE).  ``dropout`` as in ``loss``."""
        logits, aux = self._full_context(tokens, dropout=dropout)
        if not return_aux:
            return logits
        return logits, aux if aux is not None else torch.zeros(
            (), device=logits.device)

    # ---------------- training ----------------

    def _stage(self, layers, x):
        """A pipeline stage: the blocks ``layers`` (a list or ModuleList of
        this model's ``_Layer``s) on x, each recomputed in the backward
        under ``config.recompute`` (the JAX ``_scan_layers``).  With
        residual dropout ``layers`` is the pair (blocks, masks), masks one
        (attention, MLP) pair a block: the stage parameters ``loss_pp``
        hands ``gpipe``, so that one function serves every stage.  The
        masks go into each block's checkpoint as arguments, so the
        recompute reuses them.  Returns (x, the blocks' summed MoE aux,
        f32, zero without MoE)."""
        masks = None
        if isinstance(layers, tuple):
            layers, masks = layers
        recompute = self.config.recompute and torch.is_grad_enabled()
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for i, layer in enumerate(layers):
            m = None if masks is None else masks[i]
            if recompute:
                x, a = checkpoint(self._block, layer, x, None, m,
                                  use_reentrant=False,
                                  preserve_rng_state=False)
            else:
                x, a = self._block(layer, x, None, m)
            if a is not None:
                aux = aux + a
        return x, aux

    def _stage_masks(self, dropout, shape, device, layer0=0):
        """The dropout pairs of global layers [layer0, layer0 + n_local)
        at the microbatch's residual ``shape``, or None: from a
        ``torch.Generator``, the pairs of all n_layer layers drawn in
        layer order (so every stage's generator stays in step and a
        layer's masks do not depend on pp); from a list, its n_layer
        pairs."""
        c = self.config
        if dropout is None or not c.resid_pdrop:
            return None
        if not isinstance(dropout, torch.Generator) \
                and len(dropout) != c.n_layer:
            raise ValueError(f"dropout: {len(dropout)} mask pairs, not one "
                             f"a layer ({c.n_layer})")
        pairs = [self._dropout_masks(dropout, l, shape, device)
                 for l in range(c.n_layer)]
        return pairs[layer0:layer0 + self.n_local]

    def loss_pp(self, tokens, targets, dropout=None):
        """The pipelined loss (the JAX ``loss_pp``): the TRUE loss / pp on
        every stage plus ``moe_aux_coef`` times this stage's aux over the
        microbatches' mean, so a sum over "pp" gives the loss and makes a
        plain sum over "pp" of the shared parameters' gradients exact
        (``parallel/pipeline.py``).  Every stage embeds the tokens and
        runs the head; the embedding's input reaches the pipeline on stage
        0 only.  ``config.pp_microbatch`` (0: pp) microbatches; the model
        must be bound to a mesh (its pp axis may have one rank).

        dropout: as in ``loss``, at the microbatch's residual shape
        (batch/n_micro, L, d): a ``torch.Generator``, from which every
        stage draws the pairs of all n_layer layers in turn and keeps its
        own layers' (``_stage_masks``), or a list of n_layer pairs (the
        masks JAX's ``_scan_layers`` draws by ``fold_in`` of the global
        layer).  Every microbatch gets its layer's one pair, as JAX's
        ``gpipe`` hands its stage the same key at every tick (ROADMAP
        F11)."""
        from blocksparse_tpu_torch.parallel import pipeline as pl
        c, mesh = self.config, self._sharded()
        if mesh is None:
            raise ValueError("loss_pp runs on a mesh: bind the model to one")
        S = mpi_size(mesh, "pp")
        n_micro = c.pp_microbatch or S
        x = self._embed(tokens, self.wpe[None, :tokens.shape[1]])
        xm = pl.microbatch(x, n_micro)
        masks = self._stage_masks(dropout, xm.shape[1:], x.device,
                                 mpi_rank("pp", mesh) * self.n_local)
        ym, aux = pl.gpipe(self._stage,
                           self.h if masks is None else (self.h, masks),
                           xm, axis="pp", n_stages=S, with_aux=True,
                           mesh=mesh)
        y = pl.unmicrobatch(pl.broadcast_from_last(ym, axis="pp",
                                                   n_stages=S, mesh=mesh))
        losses = softmax_cross_entropy(self._logits(y), targets)
        return losses.mean() / S + c.moe_aux_coef * aux / n_micro

    def loss(self, tokens, targets, dropout=None):
        """Mean softmax cross entropy of the next-token logits against
        ``targets`` (batch, L), differentiable in the parameters.

        dropout: the counterpart of the JAX ``dropout_key``, used when
        ``config.resid_pdrop`` > 0: a ``torch.Generator`` (on any device)
        from which each layer draws its two masks in turn, or a list of
        one (attention, MLP) pair of bool masks of the residual's shape a
        layer (the masks the JAX ``_block`` draws, for parity runs).
        None drops nothing.  With MoE, plus ``moe_aux_coef`` times the
        layers' summed load-balance loss.  With sp the generator's masks
        are the full context's, each shard keeping its slice, and the
        list's are the rank's own shard's.  With pp > 1 the pipelined
        ``loss_pp``, whose masks are the microbatch's."""
        if self.config.pp > 1:
            return self.loss_pp(tokens, targets, dropout=dropout)
        logits, aux = self._full_context(tokens, dropout=dropout)
        loss = softmax_cross_entropy(logits, targets).mean()
        if self.moe is None:
            return loss
        return loss + self.config.moe_aux_coef * aux

    def make_train_step(self, optimizer: opt.AdamOptimizer, mesh=None,
                        clip_norm=1.0):
        """Returns train_step(opt_state, tokens, targets, loss_scale) ->
        (opt_state, metrics, loss_scale), the JAX ``make_train_step``:
        without a ``mesh`` its single-device branch, with one its sharded
        branch (below).

        It takes the gradient of loss·loss_scale, clips by the global norm
        of the unscaled gradient, applies ``optimizer`` and writes the new
        parameters into this module in place.  A non-finite norm gives
        norm_scale 0: the update is skipped and the scale halved (not
        below 1); otherwise the scale grows by 2^(1/2000) (not above
        2^24).  metrics holds loss, grad_norm and norm_scale.  Everything
        stays on the device: no value is read back to the host.
        loss_scale: a float or a 0-d tensor.

        On the CPU the step runs eagerly.  On a CUDA model it is one CUDA
        graph (the counterpart of the JAX step's ``jax.jit``), captured
        at the first call for each batch shape and MLP route and replayed
        afterwards; see ``_TrainStep``.

        The step applies no dropout whatever ``config.resid_pdrop`` says:
        the JAX step calls ``loss`` with no dropout key (ROADMAP F3).

        With ``mesh`` (``parallel.make_mesh``; its tp, sp, pp and ep sizes
        the config's) this module is the rank's shard and tokens and
        targets are its (batch/(dp·ep), ctx/sp) piece.  The step is the JAX
        ``local_step`` under ``shard_map``: each gradient summed over its
        ``grad_reduce_axes`` and divided by dp·sp·ep, the loss averaged
        over sp and ep, summed over pp (``loss_pp``'s 1/pp) and averaged
        over dp, the global norm from each parameter's squares summed over
        its ``param_shard_axes``; the tp all-reduces' gradient is an
        all-reduce (F8: gradients and grad_norm tp times the true ones, as
        JAX's, through the pipeline too).  On the card the step,
        collectives included, is one CUDA graph as without a mesh, except
        with pp or ep > 1, where it runs eagerly by design (the module's
        docstring).  A model bound to a mesh trains on it when ``mesh`` is
        None."""
        if mesh is None:
            mesh = self._sharded()
        else:
            self._use_mesh(mesh)
        return _TrainStep(self, optimizer, clip_norm, mesh)

    def _mlp_routes(self, N):
        """What the MLP's products launch for N tokens: each op's ``mode``
        and route (``dispatch_mode``), with MoE at the experts' N, the
        capacity.  A graph captured under one replays only that one, so
        the graphs are keyed on it (only steps with pp = ep = 1 are
        captured: ``_TrainStep.graphed``)."""
        ops = (self.bsmm1, self.bsmm2)
        if self.moe is not None:
            ops, N = (self.moe.bsmm1, self.moe.bsmm2), self.moe.capacity(N)
        if ops[0] is None:
            return ()
        return tuple((op.mode, op.dispatch_mode(N)) for op in ops)

    def _no_moe_decode(self):
        if self.moe is not None:
            raise NotImplementedError(
                "KV-cached decode with MoE MLPs is not implemented (as in "
                "the JAX package); generate runs a full forward a token")
        if self.config.tp > 1 or self.config.sp > 1 or self.config.pp > 1:
            raise NotImplementedError(
                "the KV-cached decode runs unsharded (tp = sp = pp = 1), as "
                "in the JAX package")

    # ---------------- KV-cached decode ----------------

    def init_kv_cache(self, batch):
        """Per-layer K/V caches over the full layout context."""
        self._no_moe_decode()
        c = self.config
        dev = self.wte.device
        return [{"k": torch.zeros((batch, c.ctx, c.n_embd), dtype=self.nd,
                                  device=dev),
                 "v": torch.zeros((batch, c.ctx, c.n_embd), dtype=self.nd,
                                  device=dev)}
                for _ in range(c.n_layer)]

    @torch.no_grad()
    def prefill(self, tokens):
        """Full-context forward that also captures per-layer K/V.

        tokens: (batch, ctx) int (positions past the prompt may be padding:
        causal masking keeps them out of earlier logits).
        Returns (logits, caches)."""
        self._no_moe_decode()
        caches = []
        return self._full_context(tokens, caches)[0], caches

    @torch.no_grad()
    def decode_forward(self, tok, caches, pos):
        """One-token forward at position ``pos`` against the K/V caches.

        tok: (batch,) int; pos: an int or an int64 device tensor of one
        element, read on the device (one code path: an int becomes such a
        tensor), so the step can be captured in a CUDA graph.  Writes this
        position's K/V into the caches in place (saving a copy of every
        cache per token) and returns (logits (batch, n_vocab) f32,
        caches)."""
        self._no_moe_decode()
        pos = position_tensor(pos, self.wte.device)
        x = self._embed(tok[:, None], self.wpe.index_select(0, pos)[None])
        for layer, cache in zip(self.h, caches):
            q, k, v = self._qkv(layer, x)            # (batch, 1, embd)
            cache["k"].index_copy_(1, pos, k)
            cache["v"].index_copy_(1, pos, v)
            a = self.bst.decode_step(q, cache["k"], cache["v"], pos,
                                     scale=1.0 / np.sqrt(self.hs))
            x = x + self._out(layer, a).to(x.dtype)
            x = x + self._mlp(layer, x)[0].to(x.dtype)
        return self._logits(x)[:, 0], caches

    def _decode_graph(self, batch, temperature):
        """The CUDA graph of one decode token for this batch and
        temperature, captured at first use (``_DecodeGraph``) and kept,
        keyed on everything that changes what the step launches."""
        key = (batch, self.nd, float(temperature), self._mlp_routes(batch))
        if key not in self._decode_graphs:
            self._decode_graphs[key] = _DecodeGraph(self, batch, temperature)
        return self._decode_graphs[key]


class _TrainStep:
    """The step ``make_train_step`` returns.

    On the CPU it runs ``_eager``.  On a CUDA model the step is one CUDA
    graph, captured at the first call for each (tokens shape, targets
    shape, MLP route) and replayed by every call:

    - the graph reads static buffers: tokens, targets, the loss scale and
      the optimizer state, and writes the parameters in place;
    - the state it returns is its own static state: passed back, it is
      used in place (the next call overwrites it); any other state is
      copied in first.  metrics and the new scale are copies;
    - before the capture one eager step runs on a side stream (the
      warm-up: it builds the kernels, the LUTs, the plans and cuBLAS'
      workspace, which a capture cannot), and the parameters and state
      are restored after it, so the first call gives one step;
    - a capture that fails raises: nothing falls back to the eager step
      on the card.

    ``captures`` holds each graph's warm-up and capture seconds.

    With a ``mesh`` the step is the sharded one (``_sharded_grads``), its
    collectives captured in the graph like any other launch.  With pp or
    ep > 1 it is ``_eager`` on the card too, by design: those steps need
    several NCCL ranks, one card each, which the card's host lacks, so a
    capture of their sends and all-to-alls could not be checked."""

    def __init__(self, model, optimizer, clip_norm, mesh=None):
        self.model, self.optimizer, self.clip_norm = model, optimizer, \
            clip_norm
        self.mesh = mesh
        self.names, self.params = zip(*model.named_parameters())
        self._graphs = {}
        self.captures = []
        c = model.config
        self.graphed = c.pp == 1 and c.ep == 1

    def __call__(self, opt_state, tokens, targets, loss_scale):
        if not self.params[0].is_cuda or not self.graphed:
            return self._eager(opt_state, tokens, targets, loss_scale)
        key = (tuple(tokens.shape), tuple(targets.shape),
               self.model._mlp_routes(tokens.numel()))
        g = self._graphs.get(key)
        if g is None:
            g = self._graphs[key] = self._capture(opt_state, tokens,
                                                  targets, loss_scale)
        self._load(g, opt_state, tokens, targets, loss_scale)
        g["graph"].replay()
        return (g["state"], {k: v.clone() for k, v in g["metrics"].items()},
                g["new_scale"].clone())

    def _eager(self, opt_state, tokens, targets, loss_scale):
        """One step, op by op: what the graph captures."""
        names, params = self.names, self.params
        dev = params[0].device
        if isinstance(loss_scale, torch.Tensor):
            ls = loss_scale.to(device=dev, dtype=torch.float32)
        else:
            ls = torch.full((), float(loss_scale), dtype=torch.float32,
                            device=dev)
        scaled = self.model.loss(tokens, targets) * ls
        grads = dict(zip(names, torch.autograd.grad(scaled, params)))
        gs = 1.0 / ls
        if self.mesh is None:
            loss = scaled.detach()
            gn, norm_scale = opt.clip_by_global_norm(
                grads, clip_norm=self.clip_norm, grad_scale=gs,
                zero_infs=False, zero_nans=False)
        else:
            grads, loss, gn, norm_scale = self._sharded_grads(
                grads, scaled.detach(), gs)
        new, opt_state = self.optimizer.apply(
            grads, {n: p.detach() for n, p in zip(names, params)},
            opt_state, norm_scale=norm_scale, grad_scale=gs)
        with torch.no_grad():
            for n, p in zip(names, params):
                p.copy_(new[n])
        new_scale = torch.where(
            norm_scale > 0.0,
            torch.clamp(ls * 2.0 ** (1 / 2000), max=2.0 ** 24),
            torch.clamp(ls * 0.5, min=1.0))
        metrics = {"loss": loss / ls, "grad_norm": gn,
                   "norm_scale": norm_scale}
        return opt_state, metrics, new_scale

    def _sharded_grads(self, grads, loss, gs):
        """The JAX sharded step between the gradient and the optimizer:
        (grads, loss, grad_norm, norm_scale).  Each gradient summed over
        its ``grad_reduce_axes`` (one all-reduce for the gradients of one
        set of axes) and divided by dp·sp·ep; the scaled loss averaged over
        sp and ep, summed over pp and averaged over dp, in JAX's order; the
        norm of the unscaled gradients from each parameter's squares,
        summed over its ``param_shard_axes``."""
        model, mesh, c = self.model, self.mesh, self.model.config
        use_sp = c.sp > 1
        means = (("sp",) if use_sp else ()) + (("ep",) if c.ep > 1 else ())
        nshards = mpi_size(mesh, ("dp",) + means)
        grads = _sum_over(grads, model.grad_reduce_axes(include_sp=use_sp),
                          mesh)
        grads = {n: g / nshards for n, g in grads.items()}
        for axis in means + (("pp",) if c.pp > 1 else ()) + ("dp",):
            loss = col.all_reduce_(loss.clone(), axis_group(mesh, axis))
            if axis != "pp":
                loss = loss / mpi_size(mesh, axis)
        sqs = {n: (g.float() * gs).square().sum() for n, g in grads.items()}
        sqs = _sum_over(sqs, model.param_shard_axes(), mesh)
        total = torch.zeros((), dtype=torch.float32, device=loss.device)
        for sq in sqs.values():          # in order, as JAX's sum(leaves)
            total = total + sq
        gn = torch.sqrt(total)
        clip = torch.full((), self.clip_norm, dtype=torch.float32,
                          device=gn.device)
        norm_scale = clip / torch.maximum(gn, clip)
        norm_scale = torch.where(torch.isfinite(gn), norm_scale,
                                 torch.zeros_like(norm_scale))
        return grads, loss, gn, norm_scale

    def _body(self, g):
        """The eager step on the graph's static buffers; its new state is
        copied into the static state."""
        state, g["metrics"], g["new_scale"] = self._eager(
            g["state"], g["tokens"], g["targets"], g["scale"])
        _copy_tree(g["state"], state)

    @staticmethod
    def _load(g, opt_state, tokens, targets, loss_scale):
        g["tokens"].copy_(tokens)
        g["targets"].copy_(targets)
        if isinstance(loss_scale, torch.Tensor):
            g["scale"].copy_(loss_scale)
        else:
            g["scale"].fill_(float(loss_scale))
        _copy_tree(g["state"], opt_state)

    def _capture(self, opt_state, tokens, targets, loss_scale):
        dev = self.params[0].device
        g = {"tokens": tokens.clone(memory_format=torch.contiguous_format),
             "targets": targets.clone(
                 memory_format=torch.contiguous_format),
             "scale": torch.empty((), dtype=torch.float32, device=dev),
             "state": _clone_tree(opt_state)}
        self._load(g, opt_state, tokens, targets, loss_scale)
        snapshot = [p.detach().clone() for p in self.params]
        t0 = time.perf_counter()
        side = _warm_up(dev, lambda: self._body(g))
        torch.cuda.synchronize(dev)
        with torch.no_grad():
            for p, saved in zip(self.params, snapshot):
                p.copy_(saved)
        del snapshot
        _copy_tree(g["state"], opt_state)
        t1 = time.perf_counter()
        g["graph"] = capture_graph(side, lambda: self._body(g))
        self.captures.append((t1 - t0, time.perf_counter() - t1))
        return g


def _sum_over(tensors, axes, mesh):
    """{name: tensor} with each tensor summed over its ``axes[name]`` (a
    tuple of mesh axes; () leaves it as it is): one all-reduce of the
    flattened tensors that share a tuple."""
    out = dict(tensors)
    buckets = {}
    for name, ax in axes.items():
        if ax:
            buckets.setdefault(ax, []).append(name)
    for ax, names in buckets.items():
        flat = torch.cat([tensors[n].reshape(-1) for n in names])
        col.all_reduce_(flat, axis_group(mesh, ax))
        for n, piece in zip(names, flat.split(
                [tensors[n].numel() for n in names])):
            out[n] = piece.view_as(tensors[n])
    return out


def _warm_up(device, fn):
    """Runs fn() once on a new side stream, ordered after the current
    stream's work and before its later work, and returns the stream (the
    capture's)."""
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream(device).wait_stream(side)
    return side


def capture_graph(stream, body):
    """A new CUDA graph of body() captured on ``stream``.

    A capture that raises (a host sync in the body, say) propagates its
    error, but first leaves the process as it found it.  torch's
    ``capture_end`` raises on an invalidated capture before it runs the
    registered generators' capture epilogue, so the default CUDA
    generator stays marked as capturing and every later draw outside a
    capture (``torch.randn`` on the card) raises "Offset increment outside
    graph capture encountered unexpectedly".  A one-op capture on the
    same stream runs the prologue and epilogue once more and clears the
    mark; the generator's seed and offset are left as they were."""
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph, stream=stream):
            body()
    except BaseException:
        with torch.cuda.graph(torch.cuda.CUDAGraph(), stream=stream):
            torch.zeros((), device=stream.device)
        raise
    return graph


def _clone_tree(tree):
    if isinstance(tree, dict):
        return {k: _clone_tree(v) for k, v in tree.items()}
    return tree.clone()


def _copy_tree(dst, src):
    """Copies each tensor of ``src`` into ``dst``'s, where they differ."""
    if isinstance(dst, dict):
        for k, d in dst.items():
            _copy_tree(d, src[k])
    elif dst is not src:
        dst.copy_(src)


# ---------------- sampling and the token loops ----------------

def sample_noise(shape, generator=None, device=None):
    """Exp(1) noise for ``sample_tokens`` (f32), drawn from ``generator``
    (a ``torch.Generator`` on ``device``; default the device's)."""
    return torch.empty(shape, dtype=torch.float32, device=device) \
        .exponential_(generator=generator)


def sample_tokens(logits, temperature, noise):
    """One token a row of ``logits`` (batch, n_vocab) from
    softmax(logits / temperature), by the exponential race:
    argmax(softmax(logits / T) / E) with E ~ Exp(1) (``noise``, the shape
    of logits).  ``torch.multinomial`` draws a single sample so too; here
    the noise comes in, so nothing is read back to the host and a CUDA
    graph can capture the draw."""
    probs = torch.softmax(logits / temperature, dim=-1)
    return torch.argmax(probs / noise, dim=-1)


def _prompt_state(model, prompt, steps, generator):
    """The token loop's state after the prefill of ``prompt``: tokens
    (batch, ctx) int64 with the prompt in front, the K/V caches, the
    prompt's last logits, Exp(1) noise for every step (steps, batch,
    n_vocab), the position ``pos`` and the step ``step`` as (1,) int64
    device counters."""
    c = model.config
    batch, n = prompt.shape
    if n < 1 or n + steps > c.ctx:
        raise ValueError("need 1 <= n and n + steps <= ctx")
    dev = prompt.device
    tokens = torch.zeros((batch, c.ctx), dtype=torch.int64, device=dev)
    tokens[:, :n] = prompt
    logits_all, caches = model.prefill(tokens)
    return {"tokens": tokens, "caches": caches,
            "logits": logits_all[:, n - 1].clone(),
            "noise": sample_noise((steps, batch, c.n_vocab), generator, dev),
            "pos": torch.full((1,), n, dtype=torch.int64, device=dev),
            "step": torch.zeros((1,), dtype=torch.int64, device=dev)}


def _token_step(model, s, temperature):
    """One token of the cached decode on the loop's state ``s``: sample
    from s["logits"] with the noise of s["step"], write the token into
    s["tokens"] at s["pos"], run ``decode_forward`` there, keep its
    logits and advance both counters.  Nothing leaves the device."""
    pos = s["pos"]
    tok = sample_tokens(s["logits"], temperature,
                        s["noise"].index_select(0, s["step"])[0])
    s["tokens"].index_copy_(1, pos, tok[:, None])
    logits, _ = model.decode_forward(tok, s["caches"], pos)
    s["logits"].copy_(logits)
    pos += 1
    s["step"] += 1


class _DecodeGraph:
    """``_token_step`` captured in one CUDA graph over static state: the
    tokens (batch, ctx), the K/V caches, the last logits, noise for up to
    ctx - 1 steps and the two counters.  Built on first use: one step runs
    eagerly on a side stream from a zero state (the warm-up: the kernels,
    LUTs, plans and cuBLAS' workspace, which a capture cannot build), then
    one is captured.  ``run`` copies a prefilled state in and replays the
    graph once a token.  A capture that fails raises.  The graph reads
    the model's parameters in place: load new weights with
    ``load_state_dict``, not by replacing a parameter."""

    def __init__(self, model, batch, temperature):
        c = model.config
        dev = model.wte.device
        self.state = {
            "tokens": torch.zeros((batch, c.ctx), dtype=torch.int64,
                                  device=dev),
            "caches": model.init_kv_cache(batch),
            "logits": torch.zeros((batch, c.n_vocab), dtype=torch.float32,
                                  device=dev),
            "noise": torch.ones((c.ctx - 1, batch, c.n_vocab),
                                dtype=torch.float32, device=dev),
            "pos": torch.zeros((1,), dtype=torch.int64, device=dev),
            "step": torch.zeros((1,), dtype=torch.int64, device=dev)}

        def step():
            _token_step(model, self.state, temperature)
        t0 = time.perf_counter()
        side = _warm_up(dev, step)
        torch.cuda.synchronize(dev)
        t1 = time.perf_counter()
        self.graph = capture_graph(side, step)
        self.warmup_s, self.capture_s = t1 - t0, time.perf_counter() - t1

    def run(self, s, steps):
        """Copies the prefilled state ``s`` in, replays the graph
        ``steps`` times and returns the static token buffer (batch, ctx),
        which the next run overwrites."""
        st = self.state
        for k in ("tokens", "logits", "pos", "step"):
            st[k].copy_(s[k])
        st["noise"][:s["noise"].shape[0]].copy_(s["noise"])
        for dst, src in zip(st["caches"], s["caches"]):
            dst["k"].copy_(src["k"])
            dst["v"].copy_(src["v"])
        for _ in range(steps):
            self.graph.replay()
        return st["tokens"]


@torch.no_grad()
def generate(model: SparseTransformerLM, prompt, steps, temperature=1.0,
             generator=None):
    """Autoregressive sampling by a full-context forward per token
    (O(ctx^2) a sequence; ``generate_cached`` is the KV-cached path), the
    counterpart of the JAX ``generate``: a Python loop whose token buffer
    and position stay on the device.  Same sampler and noise as
    ``generate_cached``, so for one seed the two emit the same tokens
    wherever their logits pick the same winner.

    prompt: (batch, n) int tensor on the model's device, 1 <= n, n + steps
    <= ctx.  generator: a ``torch.Generator`` on that device, for
    reproducible draws.  Returns (batch, n + steps) int64."""
    c = model.config
    batch, n = prompt.shape
    if n < 1 or n + steps > c.ctx:
        raise ValueError("need 1 <= n and n + steps <= ctx")
    dev = prompt.device
    tokens = torch.zeros((batch, c.ctx), dtype=torch.int64, device=dev)
    tokens[:, :n] = prompt
    noise = sample_noise((steps, batch, c.n_vocab), generator, dev)
    pos = torch.full((1,), n, dtype=torch.int64, device=dev)
    for i in range(steps):
        last = model(tokens).index_select(1, pos - 1)[:, 0]
        tok = sample_tokens(last, temperature, noise[i])
        tokens.index_copy_(1, pos, tok[:, None])
        pos += 1
    return tokens[:, :n + steps].clone()


@torch.no_grad()
def generate_cached(model: SparseTransformerLM, prompt, steps,
                    temperature=1.0, generator=None):
    """KV-cached autoregressive sampling: one prefill over the prompt,
    then one single-token decode per generated token, a Python loop
    (``_token_step``) with the position as a device counter.

    prompt: (batch, n) int tensor on the model's device, 1 <= n, n + steps
    <= ctx.  generator: a ``torch.Generator`` on that device, for
    reproducible draws: the noise of every step is drawn from it up front
    (``sample_noise``).  Returns (batch, n + steps) int64."""
    s = _prompt_state(model, prompt, steps, generator)
    for _ in range(steps):
        _token_step(model, s, temperature)
    return s["tokens"][:, :prompt.shape[1] + steps].clone()


@torch.no_grad()
def generate_cached_scan(model: SparseTransformerLM, prompt, steps,
                         temperature=1.0, generator=None):
    """``generate_cached`` with the decode loop off the host, the
    counterpart of the JAX ``generate_cached_scan`` (one ``lax.scan``):
    the prefill runs eagerly, then on a CUDA model one token step
    (sample, ``decode_forward`` against static K/V caches, the token
    written into a static buffer, the position advanced on the device) is
    a CUDA graph, captured at first use (``SparseTransformerLM``
    keeps it, keyed on batch, dtype, temperature and the MLP's mode and
    route) and replayed ``steps`` times.  On a CPU model it is
    ``generate_cached``: the same step, eagerly in a loop.  Emits the same
    tokens as ``generate_cached`` for the same seed.  A capture that fails
    raises."""
    if not model.wte.is_cuda:
        return generate_cached(model, prompt, steps, temperature, generator)
    s = _prompt_state(model, prompt, steps, generator)
    tokens = model._decode_graph(prompt.shape[0], temperature).run(s, steps)
    return tokens[:, :prompt.shape[1] + steps].clone()
