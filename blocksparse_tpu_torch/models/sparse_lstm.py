"""Small-world block layouts of the sparse LSTM: ``make_mask`` only.

Counterpart of ``make_mask`` in ``blocksparse_tpu/models/sparse_lstm.py``
(the reference's masks.py), the layouts of the canonical block-sparse
matmul bench.  The JAX version draws its graphs with networkx; this module
carries the two generators itself, in Python and NumPy, step for step as
networkx 3.6 runs them (``barabasi_albert_graph`` from a star on m + 1
nodes, ``watts_strogatz_graph`` with its rewiring loop), from
``random.Random(seed)`` as networkx seeds an integer.  So the same
``(n, kind, seed)`` gives the same 0/1 layout in both packages.

The LSTM itself (``fused_lstm_gates``, the mLSTM cell, the model) is a
later slice of the port (``ROADMAP.md`` §1 item 12).
"""
from __future__ import annotations

import random

import numpy as np


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
