"""Sparse Transformer language model: serving and single-device training.

Counterpart of ``blocksparse_tpu/models/sparse_transformer.py`` for a
single device: layout-driven block-sparse attention (fixed/strided/dense
patterns with a causal sub-block mask), an optionally block-sparse MLP,
layer norm and fast-gelu, with ``forward``, ``prefill``,
``decode_forward`` and ``generate_cached`` for serving and ``loss`` and
``make_train_step`` (clip by global norm, Adam, dynamic loss scaling,
per-block recompute) for training.  Parameters carry the JAX package's
names and shapes (``convert.params_from_jax`` loads a JAX param dict,
``convert.params_to_jax`` writes one), so both packages compute the same
thing from the same weights.

Tensor, sequence and pipeline parallelism, MoE and dropout are later
slices of the port and raise ``NotImplementedError`` here.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from blocksparse_tpu_torch.ops import optimize as opt
from blocksparse_tpu_torch.ops.embed import embedding_lookup
from blocksparse_tpu_torch.ops.ewops import fast_gelu, float_cast
from blocksparse_tpu_torch.ops.matmul import BlocksparseMatMul
from blocksparse_tpu_torch.ops.norms import layer_norm
from blocksparse_tpu_torch.ops.transformer import (BlocksparseTransformer,
                                                   softmax_cross_entropy)

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
    ``stack_layers`` shapes only the JAX parameter storage.  Neither
    changes a result.  The parallel, MoE and dropout fields must stay at
    their defaults here."""
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
    for field, default in (("tp", 1), ("sp", 1), ("pp", 1), ("ep", 1),
                           ("moe_experts", 0), ("resid_pdrop", 0.0)):
        if getattr(c, field) != default:
            raise NotImplementedError(
                f"{field}={getattr(c, field)} is not ported yet (the port "
                f"runs one device, dense or block-sparse MLP, no dropout)")
    if c.dtype not in _DTYPES:
        raise ValueError(f"unknown dtype {c.dtype!r}")
    if c.ctx % c.blk_size:
        raise ValueError("ctx must be a multiple of blk_size")


def _param(*shape, fill=0.0):
    """A trainable f32 master parameter."""
    return nn.Parameter(torch.full(shape, fill))


class _Layer(nn.Module):
    """One transformer block's parameters (the JAX ``h{l}`` dict)."""

    def __init__(self, c: TransformerConfig, hidden, w_fc_shape,
                 w_proj_shape):
        super().__init__()
        self.ln1_g = _param(c.n_embd, fill=1.0)
        self.ln1_b = _param(c.n_embd)
        self.ln2_g = _param(c.n_embd, fill=1.0)
        self.ln2_b = _param(c.n_embd)
        self.w_qkv = _param(c.n_embd, 3 * c.n_embd)
        self.b_qkv = _param(3 * c.n_embd)
        self.w_out = _param(c.n_embd, c.n_embd)
        self.b_out = _param(c.n_embd)
        self.w_fc = _param(*w_fc_shape)
        self.b_fc = _param(hidden)
        self.w_proj = _param(*w_proj_shape)
        self.b_proj = _param(c.n_embd)


class SparseTransformerLM(nn.Module):
    """The flagship LM on one device: forward, KV-cached decode, loss and
    the train step.

    Parameters start as zeros (gains as ones); load real ones with
    ``load_state_dict(convert.params_from_jax(...))``.  They hold f32
    masters and are cast to ``config.dtype`` at use, as in the JAX
    package.  The model lives on ``device``: by default the CUDA card
    (a host without one raises), ``device="cpu"`` for the CPU.
    impl=None runs the CUDA kernels on a CUDA device (the plain versions
    on the CPU); impl="xla" runs the plain versions everywhere, the
    reference the kernels are held against on the card."""

    def __init__(self, config: TransformerConfig, device=None, impl=None):
        super().__init__()
        c = self.config = config
        _check_supported(c)
        if impl not in (None, "xla"):
            raise ValueError(f"unknown impl {impl!r}")
        self.impl = impl
        self.hs = c.n_embd // c.n_head
        ctx_blks = c.ctx // c.blk_size
        layout = _LAYOUTS[c.attn_layout](
            ctx_blks, **({} if c.attn_layout == "dense"
                         else {"local_blocks": c.local_blocks}))
        self.bst = BlocksparseTransformer(
            layout, block_size=c.blk_size, heads=c.n_head,
            mask_callback=causal_subblock_mask)

        self.hidden = c.mlp_ratio * c.n_embd
        if c.mlp_block_size:
            bs = c.mlp_block_size
            CB = c.n_embd // bs
            KB = self.hidden // bs
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
            w_fc_shape = (c.n_embd, self.hidden)
            w_proj_shape = (self.hidden, c.n_embd)

        self.wte = _param(c.n_vocab, c.n_embd)
        self.wpe = _param(c.ctx, c.n_embd)
        self.lnf_g = _param(c.n_embd, fill=1.0)
        self.lnf_b = _param(c.n_embd)
        self.h = nn.ModuleList(
            _Layer(c, self.hidden, w_fc_shape, w_proj_shape)
            for _ in range(c.n_layer))
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "SparseTransformerLM runs on the CUDA card by default and "
                    "this host has none: pass device=\"cpu\" to run it on "
                    "the CPU")
            device = torch.device("cuda")
        self.to(device)

    @property
    def nd(self):
        return _DTYPES[self.config.dtype]

    # ---------------- blocks ----------------

    def _qkv(self, layer, x):
        nd = self.nd
        h = float_cast(layer_norm(x, layer.ln1_g, layer.ln1_b, axis=-1), nd)
        qkv = h @ float_cast(layer.w_qkv, nd) + layer.b_qkv.to(nd)
        return qkv.split(self.config.n_embd, dim=-1)

    def _attend(self, q, k, v):
        return self.bst.attention(q, k, v, scale=1.0 / np.sqrt(self.hs),
                                  use_fused=self.impl != "xla")

    def _mlp(self, layer, x):
        nd = self.nd
        h = float_cast(layer_norm(x, layer.ln2_g, layer.ln2_b, axis=-1), nd)
        if self.bsmm1 is not None:
            h = self.bsmm1(h, float_cast(layer.w_fc, nd))
        else:
            h = h @ float_cast(layer.w_fc, nd)
        h = fast_gelu(h + layer.b_fc.to(nd))
        if self.bsmm2 is not None:
            h = self.bsmm2(h, float_cast(layer.w_proj, nd))
        else:
            h = h @ float_cast(layer.w_proj, nd)
        return h + layer.b_proj.to(nd)

    def _out(self, layer, a):
        nd = self.nd
        return a.to(nd) @ float_cast(layer.w_out, nd) + layer.b_out.to(nd)

    def _logits(self, x):
        nd = self.nd
        h = layer_norm(x, self.lnf_g, self.lnf_b, axis=-1)
        return (h.to(nd) @ float_cast(self.wte, nd).t()).float()

    def _embed(self, tokens, wpe):
        return (embedding_lookup(self.wte, tokens) + wpe).float()

    def _block(self, layer, x, caches=None):
        """One transformer block; appends its K/V to ``caches`` when
        given."""
        q, k, v = self._qkv(layer, x)
        if caches is not None:
            caches.append({"k": k.contiguous(), "v": v.contiguous()})
        x = x + self._out(layer, self._attend(q, k, v)).to(x.dtype)
        return x + self._mlp(layer, x).to(x.dtype)

    def _full_context(self, tokens, caches=None):
        """Logits over all positions; appends each layer's K/V to
        ``caches`` when given.  With ``config.recompute`` and a gradient
        to take, each block's activations are recomputed in the backward
        (the JAX ``jax.checkpoint`` per block)."""
        x = self._embed(tokens, self.wpe[None, :tokens.shape[1]])
        recompute = self.config.recompute and torch.is_grad_enabled()
        for layer in self.h:
            if recompute and caches is None:
                x = checkpoint(self._block, layer, x, use_reentrant=False)
            else:
                x = self._block(layer, x, caches)
        return self._logits(x)

    # ---------------- forward ----------------

    @torch.no_grad()
    def forward(self, tokens):
        """tokens (batch, L) int -> logits (batch, L, n_vocab) f32."""
        return self._full_context(tokens)

    # ---------------- training ----------------

    def loss(self, tokens, targets):
        """Mean softmax cross entropy of the next-token logits against
        ``targets`` (batch, L), differentiable in the parameters."""
        return softmax_cross_entropy(self._full_context(tokens),
                                     targets).mean()

    def make_train_step(self, optimizer: opt.AdamOptimizer, mesh=None,
                        clip_norm=1.0):
        """Returns train_step(opt_state, tokens, targets, loss_scale) ->
        (opt_state, metrics, loss_scale), the single-device branch of the
        JAX ``make_train_step``: a ``mesh`` other than None (its sharded
        branch) is not ported and raises.

        It takes the gradient of loss·loss_scale, clips by the global norm
        of the unscaled gradient, applies ``optimizer`` and writes the new
        parameters into this module in place.  A non-finite norm gives
        norm_scale 0: the update is skipped and the scale halved (not
        below 1); otherwise the scale grows by 2^(1/2000) (not above
        2^24).  metrics holds loss, grad_norm and norm_scale.  Everything
        stays on the device: no value is read back to the host."""
        if mesh is not None:
            raise NotImplementedError("make_train_step(mesh=...) (the "
                                      "sharded train step) is not ported "
                                      "yet")
        names, params = zip(*self.named_parameters())

        def train_step(opt_state, tokens, targets, loss_scale):
            ls = torch.as_tensor(loss_scale, dtype=torch.float32,
                                 device=params[0].device)
            scaled = self.loss(tokens, targets) * ls
            grads = dict(zip(names, torch.autograd.grad(scaled, params)))
            gs = 1.0 / ls
            gn, norm_scale = opt.clip_by_global_norm(
                grads, clip_norm=clip_norm, grad_scale=gs, zero_infs=False,
                zero_nans=False)
            new, opt_state = optimizer.apply(
                grads, {n: p.detach() for n, p in zip(names, params)},
                opt_state, norm_scale=norm_scale, grad_scale=gs)
            with torch.no_grad():
                for n, p in zip(names, params):
                    p.copy_(new[n])
            new_scale = torch.where(
                norm_scale > 0.0,
                torch.clamp(ls * 2.0 ** (1 / 2000), max=2.0 ** 24),
                torch.clamp(ls * 0.5, min=1.0))
            metrics = {"loss": scaled.detach() / ls, "grad_norm": gn,
                       "norm_scale": norm_scale}
            return opt_state, metrics, new_scale
        return train_step

    # ---------------- KV-cached decode ----------------

    def init_kv_cache(self, batch):
        """Per-layer K/V caches over the full layout context."""
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
        caches = []
        return self._full_context(tokens, caches), caches

    @torch.no_grad()
    def decode_forward(self, tok, caches, pos):
        """One-token forward at position ``pos`` against the K/V caches.

        tok: (batch,) int; pos: int.  Writes this position's K/V into the
        caches in place (saving a copy of every cache per token) and
        returns (logits (batch, n_vocab) f32, caches)."""
        pos = int(pos)
        x = self._embed(tok[:, None], self.wpe[None, pos:pos + 1])
        for layer, cache in zip(self.h, caches):
            q, k, v = self._qkv(layer, x)            # (batch, 1, embd)
            cache["k"][:, pos:pos + 1] = k
            cache["v"][:, pos:pos + 1] = v
            a = self.bst.decode_step(q, cache["k"], cache["v"], pos,
                                     scale=1.0 / np.sqrt(self.hs))
            x = x + self._out(layer, a).to(x.dtype)
            x = x + self._mlp(layer, x).to(x.dtype)
        return self._logits(x)[:, 0], caches


@torch.no_grad()
def generate_cached(model: SparseTransformerLM, prompt, steps,
                    temperature=1.0, generator=None):
    """KV-cached autoregressive sampling: one prefill over the prompt,
    then one single-token decode per generated token.

    prompt: (batch, n) int tensor on the model's device, n + steps <= ctx.
    generator: a ``torch.Generator`` on that device, for reproducible
    draws.  Returns (batch, n + steps) int64."""
    c = model.config
    batch, n = prompt.shape
    if n + steps > c.ctx:
        raise ValueError("n + steps must not exceed ctx")
    tokens_full = torch.zeros((batch, c.ctx), dtype=torch.int64,
                              device=prompt.device)
    tokens_full[:, :n] = prompt
    logits_all, caches = model.prefill(tokens_full)
    last_logits = logits_all[:, n - 1]
    out = [prompt.to(torch.int64)]
    for i in range(steps):
        probs = torch.softmax(last_logits / temperature, dim=-1)
        tok = torch.multinomial(probs, 1, generator=generator)[:, 0]
        last_logits, caches = model.decode_forward(tok, caches, n + i)
        out.append(tok[:, None])
    return torch.cat(out, dim=1)
