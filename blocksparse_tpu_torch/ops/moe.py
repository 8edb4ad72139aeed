"""Block-sparse Mixture-of-Experts, with expert parallelism ("ep").

Counterpart of ``blocksparse_tpu/ops/moe.py``: static-shape top-k routing
with a fixed capacity per expert (``route_topk``: a choice's slots are
assigned after all of the previous choice's, in token order within a
choice; overflow tokens are dropped; the Switch aux loss on first
choices) and ``BlocksparseMoE``, E experts of d -> h -> d whose two
products are ``BlocksparseMatMul`` ops (feature_axis 1) over one layout
with per-expert weights.

The layer computes the JAX layer's function without its (T, E, C)
one-hot tensors: each token's (expert, slot) comes from the same ranks
``route_topk`` uses, the dispatch gathers the tokens into an (E, C, d)
buffer (empty slots zero), and the combine gathers each token's slots
back and sums its k choices in choice order.  A one-hot selection is
exact and at most k terms add, so this is the same function at a
fraction of the work.  The backward of both is a gather too (each slot
belongs to at most one token, each token to at most k slots): no float
atomics in either direction, so the layer is deterministic.  Top-k is k
rounds of ``argmax`` (the first maximum) with the chosen entries masked
out, which breaks ties by the lower index as ``lax.top_k`` does.

The experts run as a loop over E (the JAX ``lax.scan``).  Dtypes follow
the JAX layer exactly (ROADMAP F6): the expert weights and biases stay in
their own dtype (f32 masters), so under a bf16 compute dtype bsmm1 forms
f32 products of the bf16 tokens and rounds them to bf16, the bias add
promotes to f32, and gelu, bsmm2, the combine and the output are f32;
the router's product is promoted to f32 and the combine's gates are
rounded to the tokens' dtype.

Expert parallelism (``ep`` > 1, called with an ``ep_axis``): the experts
are split over the mesh axis, each rank holding E/ep of them (``w1``,
``b1``, ``w2``, ``b2`` with E/ep leading; the gate ``wg`` whole), and each
rank routes its own tokens at the capacity of its own T (the routing, the
capacity and the drops are per rank, as in the JAX package).  The (E, C,
d) buffer goes to the experts' owners by a tiled all-to-all over the axis
(``parallel.collectives.all_to_all``: (E, C, d) -> (E/ep, ep·C, d), the
sources concatenated in rank order), the local experts run at N = ep·C,
and the all-to-all back returns (E, C, d) for the combine; the backward of
each all-to-all is the other.  The tokens' buffer travels in x's dtype and
the experts' outputs in theirs (f32 under F6).  The three steps are
methods (``dispatch``, ``experts``, ``combine``), so one process can run
each rank's share in turn.
"""
from __future__ import annotations

import numpy as np
import torch

from blocksparse_tpu_torch.ops.ewops import fast_gelu
from blocksparse_tpu_torch.ops.matmul import BlocksparseMatMul
from blocksparse_tpu_torch.parallel.collectives import all_to_all
from blocksparse_tpu_torch.parallel.mesh import current_mesh, mpi_size


def _top_k(probs, k):
    """(topv, topi) of each row: k rounds of argmax (the first maximum),
    each masking its pick out; ties go to the lower index, as
    ``lax.top_k``'s.  topv is a masked sum (one nonzero term), so its
    gradient is a product, not a scatter."""
    E = probs.shape[-1]
    iota = torch.arange(E, device=probs.device)
    masked, vals, idx = probs.detach(), [], []
    for _ in range(k):
        i = torch.argmax(masked, dim=-1)
        hit = iota == i[:, None]
        idx.append(i)
        vals.append((probs * hit).sum(-1))
        masked = masked.masked_fill(hit, -torch.inf)
    return torch.stack(vals, 1), torch.stack(idx, 1)


def _slots(topi, E, capacity):
    """Each (token, choice)'s slot in its expert's buffer and whether it
    fits: (pos (T, k) int64, keep (T, k) bool).  Choice c's slots follow
    all of choice c-1's; within a choice, tokens take slots in token
    order (a cumsum); slots past ``capacity`` are dropped."""
    T, k = topi.shape
    base = torch.zeros((E, 1), dtype=torch.int64, device=topi.device)
    experts = torch.arange(E, device=topi.device)[:, None]
    pos = []
    for c in range(k):
        # (E, T): the scan runs along the inner dim (along the outer one
        # CUDA's scan takes milliseconds at the LM's 16,384 tokens)
        onehot = (experts == topi[:, c]).long()
        ranks = torch.cumsum(onehot, 1) - 1 + base
        pos.append(ranks.gather(0, topi[None, :, c])[0])
        base = base + onehot.sum(1, keepdim=True)
    pos = torch.stack(pos, 1)
    return pos, pos < capacity


def _aux(probs, first, E):
    """The Switch aux loss E · Σ_e f_e · P_e on first choices."""
    f = torch.nn.functional.one_hot(first, E).to(probs.dtype).mean(0)
    return E * (f * probs.mean(0)).sum()


def route_topk(probs, k, capacity):
    """Static-shape top-k routing (GShard normalize; Switch aux loss).

    probs: (T, E) softmax gate probabilities.
    Returns (dispatch (T, E, C) {0,1}, combine (T, E, C) float,
    aux_loss scalar), of probs' dtype.  Choice c's slots are assigned
    after all choice-(c-1) slots (first choices win capacity), each in
    token order."""
    T, E = probs.shape
    C = int(capacity)
    topv, topi = _top_k(probs, k)
    gates = topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)
    pos, keep = _slots(topi, E, C)
    dispatch = probs.new_zeros((T, E, C))
    combine = probs.new_zeros((T, E, C))
    for c in range(k):
        slot = torch.nn.functional.one_hot(
            torch.where(keep[:, c], pos[:, c] + 1, 0), C + 1)[:, 1:]
        d_c = torch.nn.functional.one_hot(topi[:, c], E)[:, :, None] \
            * slot[:, None, :]
        d_c = d_c.to(probs.dtype)
        dispatch = dispatch + d_c
        combine = combine + d_c * gates[:, c][:, None, None]
    return dispatch, combine, _aux(probs, topi[:, 0], E)


class _Dispatch(torch.autograd.Function):
    """xe (E·C, d) = the token each slot holds, zero where a slot is empty
    (``src`` (E·C,) token ids, T for an empty slot).  Backward: each
    token's gradient is the sum of its slots' in choice order (``dst``
    (T, k) slot ids, E·C where dropped), in f32, cast to x's dtype: a
    gather, no scatter."""

    @staticmethod
    def forward(ctx, x, src, dst):
        ctx.save_for_backward(dst)
        return torch.cat([x, x.new_zeros((1, x.shape[1]))])[src]

    @staticmethod
    def backward(ctx, dxe):
        dst, = ctx.saved_tensors
        pad = torch.cat([dxe, dxe.new_zeros((1, dxe.shape[1]))]).float()
        dx = pad[dst[:, 0]]
        for c in range(1, dst.shape[1]):
            dx = dx + pad[dst[:, c]]
        return dx.to(dxe.dtype), None, None


class _Combine(torch.autograd.Function):
    """y[t] = Σ_c gates[t, c] · ye[dst[t, c]] in choice order, in f32
    (a dropped choice adds the zero row), of the promoted dtype of ye and
    gates.  Backward: dye[s] = gates of s's owner · dy[owner] (``src``
    (E·C,) the owning (token·k + choice), T·k where empty), dgates[t, c]
    = <dy[t], ye[dst[t, c]]> in gates' dtype: gathers, no scatter."""

    @staticmethod
    def forward(ctx, ye, gates, src, dst, k):
        ctx.save_for_backward(ye, gates, src, dst)
        ctx.k = k
        pad = torch.cat([ye, ye.new_zeros((1, ye.shape[1]))])
        g = gates.float()
        y = pad[dst[:, 0]].float() * g[:, :1]
        for c in range(1, k):
            y = y + pad[dst[:, c]].float() * g[:, c:c + 1]
        return y.to(torch.promote_types(ye.dtype, gates.dtype))

    @staticmethod
    def backward(ctx, dy):
        ye, gates, src, dst = ctx.saved_tensors
        k = ctx.k
        dy32 = dy.float()
        dpad = torch.cat([dy32, dy32.new_zeros((1, dy.shape[1]))])
        gflat = torch.cat([gates.float().reshape(-1),
                           gates.new_zeros(1, dtype=torch.float32)])
        dye = dpad[torch.div(src, k, rounding_mode="floor")] \
            * gflat[src][:, None]
        pad = torch.cat([ye, ye.new_zeros((1, ye.shape[1]))]).float()
        dg = torch.stack([(dy32 * pad[dst[:, c]]).sum(-1) for c in range(k)],
                         1)
        return dye.to(ye.dtype), dg.to(gates.dtype), None, None, None


def _matmul(a, b):
    """a @ b in the promoted dtype of the two (the JAX product of a bf16
    and an f32 operand, which torch refuses unpromoted)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt) @ b.to(dt)


class BlocksparseMoE:
    """Top-k MoE layer: y, aux = moe(params, x).

    n_experts experts of d_model -> d_hidden -> d_model; block-sparse
    when block_size > 0 (one random-but-covered layout shared by all
    experts, per-expert weights).  impl: the experts' ``BlocksparseMatMul``
    impl (None: the kernels on CUDA tensors; "xla": the plain versions)."""

    def __init__(self, n_experts, d_model, d_hidden, block_size=0,
                 density=1.0, capacity_factor=1.25, k=1, ep=1, seed=0,
                 impl=None):
        if n_experts % ep:
            raise ValueError(f"n_experts {n_experts} must divide by ep {ep}")
        if not 1 <= k <= n_experts:
            raise ValueError(f"k must lie in [1, {n_experts}], got {k}")
        self.E, self.d, self.h = n_experts, d_model, d_hidden
        self.cf, self.k, self.ep = float(capacity_factor), k, ep
        if block_size:
            bs = block_size
            CB, KB = d_model // bs, d_hidden // bs
            rng = np.random.RandomState(seed)
            lay = (rng.rand(CB, KB) < density).astype(np.int32)
            lay[np.arange(CB), np.arange(CB) % KB] = 1   # no empty rows
            lay[np.arange(KB) % CB, np.arange(KB)] = 1   # no empty cols
            self.bsmm1 = BlocksparseMatMul(lay, block_size=bs,
                                           feature_axis=1, impl=impl)
            self.bsmm2 = BlocksparseMatMul(lay.T.copy(), block_size=bs,
                                           feature_axis=1, impl=impl)
        else:
            self.bsmm1 = self.bsmm2 = None

    def shapes(self, local=False):
        """Each parameter's shape: the JAX ``init``'s tree; ``local``: one
        ep rank's (E/ep experts)."""
        E, d, h = self.E // (self.ep if local else 1), self.d, self.h
        if self.bsmm1 is not None:
            w1, w2 = (E,) + self.bsmm1.w_shape, (E,) + self.bsmm2.w_shape
        else:
            w1, w2 = (E, d, h), (E, h, d)
        return {"wg": (d, self.E), "w1": w1, "b1": (E, h), "w2": w2,
                "b2": (E, d)}

    def init(self, generator=None, device=None):
        """Parameters as the JAX ``init`` draws them (normal, std 0.02; the
        biases zero), from ``generator`` (a ``torch.Generator`` on
        ``device``), f32."""
        out = {}
        for name, shape in self.shapes().items():
            if name.startswith("b"):
                out[name] = torch.zeros(shape, device=device)
            else:
                out[name] = torch.randn(shape, generator=generator,
                                        device=device) * 0.02
        return out

    def param_specs(self):
        """Each parameter's sharding, one entry a dim: experts over "ep",
        the gate replicated (the JAX PartitionSpecs as tuples)."""
        nw = len(self.bsmm1.w_shape) if self.bsmm1 is not None else 2
        ew = ("ep",) + (None,) * nw
        return {"wg": (None, None), "w1": ew, "b1": ("ep", None),
                "w2": ew, "b2": ("ep", None)}

    def param_reduce_axes(self, dp_axis="dp", ep_axis="ep"):
        """Axes each gradient sums over: the gate's is partial per ep
        shard, the expert weights' ep-local."""
        return {"wg": (dp_axis, ep_axis), "w1": (dp_axis,),
                "b1": (dp_axis,), "w2": (dp_axis,), "b2": (dp_axis,)}

    def capacity(self, n_tokens):
        c = int(np.ceil(self.k * self.cf * n_tokens / self.E))
        return max(8, -(-c // 8) * 8)   # multiple of 8 sublanes

    def _ffn(self, w1, b1, w2, b2, x):
        """One expert: x (Cap, d) -> (Cap, d)."""
        u = self.bsmm1(x, w1) if self.bsmm1 is not None else _matmul(x, w1)
        u = fast_gelu(u + b1[None])
        y = self.bsmm2(u, w2) if self.bsmm2 is not None else _matmul(u, w2)
        return y + b2[None]

    def _route(self, probs, C):
        """(gates (T, k) f32, topi (T, k), src (E·C,), dst (T, k)): each
        slot's owner as token·k + choice (T·k where empty) and each
        (token, choice)'s slot (E·C where dropped)."""
        T, E, k = probs.shape[0], self.E, self.k
        topv, topi = _top_k(probs, k)
        gates = topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)
        pos, keep = _slots(topi, E, C)
        dst = torch.where(keep, topi * C + pos, E * C)
        owner = torch.arange(T * k, device=probs.device)
        # each kept (token, choice) writes its own slot (distinct ids,
        # ints): every dropped one writes the sentinel row, cut off
        src = torch.full((E * C + 1,), T * k, dtype=torch.int64,
                         device=probs.device)
        src.index_put_((dst.reshape(-1),), owner)
        return gates, topi, src[:E * C], dst

    def dispatch(self, params, x):
        """Route x's tokens (T, d) at the capacity of T: (xe, route), xe
        (E, C, d) each expert's slots (x's dtype, empty slots zero), route
        what ``combine`` and ``aux`` need."""
        T, d = x.shape
        if d != self.d:
            raise ValueError(f"x must be (T, {self.d}), got {tuple(x.shape)}")
        E, k, C = self.E, self.k, self.capacity(T)
        probs = torch.softmax(_matmul(x, params["wg"]).float(), dim=-1)
        gates, topi, src, dst = self._route(probs, C)
        xe = _Dispatch.apply(x, torch.div(src, k, rounding_mode="floor"),
                             dst).reshape(E, C, d)
        return xe, (probs, gates.to(x.dtype), topi, src, dst)

    def experts(self, params, xe):
        """The experts of ``params`` (n leading: E, or one rank's E/ep) on
        their slots xe (n, N, d): ye (n, N, d), a loop over the n."""
        if params["w1"].shape[0] != xe.shape[0]:
            raise ValueError(f"{params['w1'].shape[0]} experts' weights for "
                             f"{xe.shape[0]} experts' slots (one ep rank's "
                             f"experts need the ep_axis)")
        # unbind, not indexing: its backward stacks the n gradients once
        # (an index's backward would scatter each into zeros, then sum)
        per_expert = zip(*(params[n].unbind(0)
                           for n in ("w1", "b1", "w2", "b2")), xe.unbind(0))
        return torch.stack([self._ffn(*args) for args in per_expert])

    def combine(self, ye, route):
        """Each token's output from its experts' slots ye (E, C, d): y (T,
        d) of the promoted dtype of ye and the gates."""
        _, gates, _, src, dst = route
        return _Combine.apply(ye.reshape(-1, ye.shape[-1]), gates, src, dst,
                              self.k)

    def aux(self, route):
        """The Switch load-balance loss of a routing (f32)."""
        probs, _, topi, _, _ = route
        return _aux(probs, topi[:, 0], self.E).float()

    def __call__(self, params, x, ep_axis=None, mesh=None):
        """x: (T, d) this rank's tokens -> (y (T, d), aux_loss f32).
        params: a mapping with the JAX ``init``'s names and shapes (a
        ``ParameterDict`` in the LM).

        With ``ep_axis`` (and ep > 1): params' experts are this rank's
        E/ep (``shapes(local=True)``) and the slots travel to their owners
        and back by all-to-all over the axis of ``mesh`` (default the last
        ``make_mesh``'s).  Without it the layer runs as ep = 1 on the
        params it is given, as the JAX layer does."""
        xe, route = self.dispatch(params, x)
        if ep_axis is not None and self.ep > 1:
            n = mpi_size(current_mesh(mesh), ep_axis)
            if n != self.ep:
                raise ValueError(f"ep {self.ep} is not the mesh's {ep_axis} "
                                 f"size {n}")
            xe = all_to_all(xe, ep_axis, 0, 1, mesh)       # (E/ep, ep·C, d)
            ye = all_to_all(self.experts(params, xe), ep_axis, 1, 0, mesh)
        else:
            ye = self.experts(params, xe)
        return self.combine(ye, route), self.aux(route)
