"""Sparse LSTM language model: block-sparse mLSTM with small-world layouts.

Counterpart of ``blocksparse_tpu/models/sparse_lstm.py``: the hidden-to-
hidden weights of each layer are one block-sparse matmul over the four
gates (``BlocksparseMatMul(np.tile(layout, (1, 4)), feature_axis=0)``, h
feature-major (nhidden, batch)), with ``isteps`` internal steps of bsmm →
4-segment layer norm → ``fused_lstm_gates`` a token; strided
``SparseProj`` projections in and out of the hidden space; ``lsteps``
stacked layers, each fed the one below; recurrent-output dropout; and
per-timestep recompute.  On the card the matmuls run the hand-written
kernels (f32, CN).  Parameters carry the JAX names (``wte``, ``w_in``,
``w_out``, ``b_out``, ``layers.<l>.{w_h, b_h, g_h}``): ``convert``'s
``lstm_params_from_jax`` / ``lstm_params_to_jax`` move them.

``make_mask`` gives the small-world layouts (the reference's masks.py),
also those of the canonical block-sparse matmul bench.  The JAX version
draws its graphs with networkx; this module carries the two generators
itself, in Python and NumPy, step for step as networkx 3.6 runs them
(``barabasi_albert_graph`` from a star on m + 1 nodes,
``watts_strogatz_graph`` with its rewiring loop), from
``random.Random(seed)`` as networkx seeds an integer.  So the same
``(n, kind, seed)`` gives the same 0/1 layout in both packages.
"""
from __future__ import annotations

import random
from dataclasses import asdict, dataclass

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from blocksparse_tpu_torch.ops.ewops import uniform
from blocksparse_tpu_torch.ops.lstm import fused_lstm_gates
from blocksparse_tpu_torch.ops.matmul import BlocksparseMatMul, SparseProj
from blocksparse_tpu_torch.ops.norms import layer_norm
from blocksparse_tpu_torch.ops.transformer import softmax_cross_entropy
from blocksparse_tpu_torch.utils import default_device


def _barabasi_albert_edges(n, m, rng):
    """The edges of networkx's ``barabasi_albert_graph(n, m)``: a star on
    nodes 0..m, then each new node draws m distinct targets from the list
    of nodes repeated once per incident edge (preferential attachment).
    The targets are kept in a set, as networkx keeps them, so the list
    grows in the same order and later draws pick the same nodes."""
    if m < 1 or m >= n:
        raise ValueError(f"Barabasi-Albert needs 1 <= m < n, got m={m}, "
                         f"n={n}")
    edges = [(0, v) for v in range(1, m + 1)]
    repeated = [0] * m + list(range(1, m + 1))
    for source in range(m + 1, n):
        targets = set()
        while len(targets) < m:
            targets.add(rng.choice(repeated))
        edges.extend((source, t) for t in targets)
        repeated.extend(targets)
        repeated.extend([source] * m)
    return edges


def _watts_strogatz_adjacency(n, k, p, rng):
    """Neighbour sets of networkx's ``watts_strogatz_graph(n, k, p)``: a
    ring joining each node to its k // 2 nearest neighbours on each side,
    then each ring edge (u, u + j), by distance j and then by node,
    rewired with probability p to (u, w) for a uniform w that is neither
    u nor a neighbour of u (skipped once u neighbours every other node)."""
    if k > n:
        raise ValueError("k > n: choose a smaller k or a larger n")
    if k == n:
        return [set(range(n)) - {u} for u in range(n)]
    adj = [set() for _ in range(n)]
    nodes = list(range(n))
    for j in range(1, k // 2 + 1):
        for u in nodes:
            v = (u + j) % n
            if u != v:
                adj[u].add(v)
                adj[v].add(u)
    for j in range(1, k // 2 + 1):
        for u in nodes:
            v = (u + j) % n
            if rng.random() < p:
                w = rng.choice(nodes)
                skipped = False
                while w == u or w in adj[u]:
                    w = rng.choice(nodes)
                    if len(adj[u]) >= n - 1:
                        skipped = True
                        break
                if not skipped:
                    adj[u].discard(v)
                    adj[v].discard(u)
                    adj[u].add(w)
                    adj[w].add(u)
    return adj


def make_mask(n, kind="ba_10", seed=0):
    """(n, n) int32 block layout: ``"dense"``, ``"ba_<m>"`` (Barabasi-
    Albert with m edges a new node, plus the diagonal, with the first m
    rows and columns dense) or ``"ws_<m>_<pct>"`` (Watts-Strogatz on a
    ring of 2m nearest neighbours, pct percent of edges rewired, plus the
    diagonal)."""
    if kind == "dense":
        return np.ones((n, n), dtype=np.int32)
    rng = random.Random(seed)
    a = np.zeros((n, n), dtype=np.int32)
    if kind.startswith("ba_"):
        m = int(kind.split("_")[1])
        edges = np.asarray(_barabasi_albert_edges(n, m, rng), np.int64)
        a[edges[:, 0], edges[:, 1]] = 1
        a[edges[:, 1], edges[:, 0]] = 1
        a += np.eye(n, dtype=np.int32)
        a[0:m, 0:m] = 1
        return a
    if kind.startswith("ws_"):
        _, m, pct = kind.split("_")
        adj = _watts_strogatz_adjacency(n, int(m) * 2, float(pct) / 100.0,
                                        rng)
        for u, nbrs in enumerate(adj):
            a[u, list(nbrs)] = 1
        return a + np.eye(n, dtype=np.int32)
    raise ValueError("Unknown mask kind: " + str(kind))


@dataclass
class LSTMConfig:
    n_vocab: int = 256
    nhidden: int = 1120
    nembd: int = 64
    nproj_in: int = 512
    nproj_out: int = 512
    nsteps: int = 64
    block_size: int = 32
    mask_kind: str = "ba_10"
    isteps: int = 2           # internal (multi-step) recurrence depth
    lsteps: int = 1           # stacked sparse LSTM layers
    share_masks: bool = True  # one layout for all layers
    forget_bias: float = 1.0
    dropout: float = 0.0      # recurrent-output dropout (train only)
    recompute: bool = False   # per-timestep rematerialization
    layernorm: bool = True
    dtype: str = "float32"    # kept for the JAX config; both run f32


class _LSTMLayer(nn.Module):
    """One layer's parameters (the JAX ``layers[l]`` dict)."""

    def __init__(self, w_shape, nhidden, layernorm):
        super().__init__()
        self.w_h = nn.Parameter(torch.zeros(w_shape))
        self.b_h = nn.Parameter(torch.zeros(4 * nhidden))
        if layernorm:
            self.g_h = nn.Parameter(torch.ones(4 * nhidden))


class SparseLSTM(nn.Module):
    """The sparse mLSTM LM on one device.

    Parameters start as zeros (gains as ones); load real ones with
    ``load_state_dict(convert.lstm_params_from_jax(...))``.  The model
    lives on ``device``: by default the CUDA card (a host without one
    raises), ``device="cpu"`` for the CPU.  impl=None runs the CUDA
    kernels on a CUDA device (the plain versions on the CPU); impl="xla"
    runs the plain versions everywhere, the reference the kernels are held
    against on the card."""

    def __init__(self, config: LSTMConfig, device=None, impl=None):
        super().__init__()
        c = self.config = config
        bs = c.block_size
        if c.nhidden % bs:
            raise ValueError("nhidden must be a multiple of block_size")
        if not 0.0 <= c.dropout < 1.0:
            raise ValueError("dropout must lie in [0, 1)")
        nb = c.nhidden // bs
        # the four gates' hidden-to-hidden weights are one block-sparse
        # matmul a layer; share_masks gives every layer layer 0's layout
        self.bsmm_layers = []
        for l in range(c.lsteps):
            layout = make_mask(nb, c.mask_kind, seed=0 if c.share_masks
                               else l)
            self.bsmm_layers.append(BlocksparseMatMul(
                np.tile(layout, (1, 4)), block_size=bs, feature_axis=0,
                name=f"bsmm_h{l}", impl=impl))
        self.bsmm_h = self.bsmm_layers[0]
        # strided projections, each clamped to the hidden width
        nproj_in = min(c.nproj_in, c.nhidden)
        nproj_out = min(c.nproj_out, c.nhidden)
        self.proj_in = SparseProj(c.nhidden,
                                  proj_stride=max(c.nhidden // nproj_in, 1))
        self.proj_out = SparseProj(c.nhidden,
                                   proj_stride=max(c.nhidden // nproj_out, 1))

        self.wte = nn.Parameter(torch.zeros(c.n_vocab, c.nembd))
        self.w_in = nn.Parameter(torch.zeros(c.nembd, self.proj_in.nproj))
        self.w_out = nn.Parameter(torch.zeros(self.proj_out.nproj,
                                              c.n_vocab))
        self.b_out = nn.Parameter(torch.zeros(c.n_vocab))
        self.layers = nn.ModuleList(
            _LSTMLayer(b.w_shape, c.nhidden, c.layernorm)
            for b in self.bsmm_layers)
        self.to(default_device(device, "SparseLSTM"))

    def layouts(self):
        """name -> 0/1 layout, for the checkpoint sidecar."""
        return {b.name: np.asarray(b.layout) for b in self.bsmm_layers}

    def config_dict(self):
        return asdict(self.config)

    def _cell(self, lp, bsmm, c_state, h_state, x_inj):
        """One step of one layer, h feature-major (nhidden, batch) for the
        CN-oriented bsmm.  x_inj: the input injected into the hidden space
        (the scattered x for layer 0, the layer below's h above)."""
        cfg = self.config
        h_in = h_state + x_inj
        for _ in range(cfg.isteps):
            gates = bsmm(h_in, lp.w_h)                 # (4 nhidden, batch)
            if cfg.layernorm:
                gates = layer_norm(gates, lp.g_h, lp.b_h, axis=0,
                                   segments=4)
            else:
                gates = gates + lp.b_h[:, None]
            cT, hT = fused_lstm_gates(c_state.t(), gates.t(),
                                      forget_bias=cfg.forget_bias)
            c_state, h_in = cT.t(), hT.t()
        return c_state, h_in

    def _step(self, c, h, x_t, keep_t):
        """One token through every layer: (c, h) (L, nhidden, batch), x_t
        (batch, nproj_in), keep_t the token's scaled keep masks (L or 1,
        nhidden, batch) or None.  Returns (c, h, the top layer's projected
        output (nproj_out, batch))."""
        cfg = self.config
        inj = self.proj_in.scatter_add(
            x_t.new_zeros((cfg.nhidden, x_t.shape[0])), x_t.t())
        cs, hs = [], []
        for l, (lp, bsmm) in enumerate(zip(self.layers, self.bsmm_layers)):
            cl, hl = self._cell(lp, bsmm, c[l], h[l], inj)
            if keep_t is not None:
                hl = hl * keep_t[min(l, keep_t.shape[0] - 1)]
            cs.append(cl)
            hs.append(hl)
            inj = hl                          # feeds the layer above
        return torch.stack(cs), torch.stack(hs), self.proj_out.gather(hs[-1])

    def _keep(self, dropout, T, batch, device):
        """The scaled keep masks (T, L, nhidden, batch) f32 of the JAX
        forward's dropout, or None: from a ``torch.Generator`` (U[0, 1) <
        1 - p), or the 0/1 keep mask given."""
        p = self.config.dropout
        if dropout is None or not p:
            return None
        if isinstance(dropout, torch.Generator):
            shape = (T, self.config.lsteps, self.config.nhidden, batch)
            keep = uniform(shape, device, dropout) < 1.0 - p
        else:
            keep = torch.as_tensor(dropout, device=device)
        return keep.to(torch.float32) / (1.0 - p)

    def forward(self, tokens, dropout=None):
        """tokens (batch, nsteps) int -> logits (batch, nsteps, n_vocab).

        dropout: the counterpart of the JAX ``dropout_key``, used when
        ``config.dropout`` > 0: a ``torch.Generator`` (on any device) from
        which every keep mask is drawn up front, or the 0/1 keep mask (T,
        lsteps, nhidden, batch) itself (the one JAX's
        ``jax.random.bernoulli`` draws, for parity runs).  None drops
        nothing.  With ``config.recompute`` and a gradient to take, each
        timestep's activations are recomputed in the backward (the JAX
        ``jax.checkpoint`` of a scan step); the masks are drawn outside
        the checkpoints, so they save no RNG state."""
        cfg = self.config
        batch, T = tokens.shape
        dev = self.wte.device
        emb = self.wte[tokens.long()]                      # (B, T, nembd)
        xproj = torch.einsum("bte,ep->btp", emb, self.w_in)
        L = cfg.lsteps
        c = torch.zeros((L, cfg.nhidden, batch), device=dev)
        h = torch.zeros((L, cfg.nhidden, batch), device=dev)
        keep = self._keep(dropout, T, batch, dev)
        recompute = cfg.recompute and torch.is_grad_enabled()
        outs = []
        for t in range(T):
            keep_t = None if keep is None else keep[t]
            if recompute:
                c, h, out = checkpoint(self._step, c, h, xproj[:, t],
                                       keep_t, use_reentrant=False,
                                       preserve_rng_state=False)
            else:
                c, h, out = self._step(c, h, xproj[:, t], keep_t)
            outs.append(out)
        return torch.einsum("tpb,pv->btv", torch.stack(outs),
                            self.w_out) + self.b_out

    def loss(self, tokens, targets, dropout=None):
        """Mean softmax cross entropy of the logits against ``targets``
        (batch, nsteps); ``dropout`` as in ``forward``."""
        logits = self.forward(tokens, dropout=dropout)
        return softmax_cross_entropy(logits, targets.long()).mean()
