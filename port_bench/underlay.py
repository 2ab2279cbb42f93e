"""The benchmark's underlay: a frozen copy of the program's
``sim/topology.sparse_fast``.

Every cell's network is built here from ``--seed``, and the same arrays go
to the program and to the reference. It is the same kind of graph as the
BASELINE builders' ``topology.sparse`` (each peer dials ``degree`` random
targets, edges symmetric, degree capped at ``k``), not the same sample:
``sparse`` walks an O(N^2) Python loop that would cost minutes of set-up
in every run at 102,400 peers.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class Topology(NamedTuple):
    neighbors: np.ndarray      # [N, K] int32, -1 padded
    outbound: np.ndarray       # [N, K] bool
    reverse_slot: np.ndarray   # [N, K] int32, -1 padded
    degree: np.ndarray         # [N] int32


def sparse_fast(n: int, k: int, degree: int = 8,
                seed: int = 314159) -> Topology:
    """Vectorized random underlay for frontier-scale networks.

    :func:`sparse` walks a Python loop with an O(N) permutation per peer —
    O(N²) work that takes hours at 1M peers. This builder produces the
    same KIND of graph (each peer dials ``degree`` random targets, edges
    symmetric, per-peer degree capped at ``k``, ``reverse_slot`` a true
    involution, sorted-neighbor slot order exactly like ``_finalize``) in
    a handful of numpy passes, in O(N·degree) host RAM (the build is
    global, so 10M peers need :func:`sparse_hash` instead). It is NOT
    sample-identical to ``sparse`` for the same seed — the frontier
    scenario family (sim/scenarios.py) owns it; the BASELINE scenarios
    keep their historical builder and seeds.

    Construction: draw N·degree dials, dedupe unordered pairs, drop the
    (rare: Poisson tail) edges that would push an endpoint past ``k`` —
    whole edges, so symmetry is preserved — then assign slots per peer in
    sorted-neighbor order and pair the two directions of each edge for
    ``reverse_slot``.
    """
    if n < 2:
        raise ValueError(f"sparse_fast needs n >= 2, got {n}")
    rng = np.random.default_rng(seed)
    src = np.repeat(np.arange(n, dtype=np.int64), degree)
    dst = rng.integers(0, n - 1, n * degree, dtype=np.int64)
    dst += dst >= src                                   # never self
    a, b = np.minimum(src, dst), np.maximum(src, dst)
    pair_key, first_idx = np.unique(a * n + b, return_index=True)
    a, b = pair_key // n, pair_key % n
    # dial direction: the first drawn occurrence of the pair keeps its
    # orientation (that endpoint dialed -> outbound on its side)
    dialed_by_a = src[first_idx] == a

    # capacity: arrival rank of each edge within its endpoint's FULL
    # incidence list (both roles — a node's degree counts every edge it
    # touches), edges in pair-key order — deterministic; drop edges where
    # either endpoint is already at k
    ec = len(a)
    ends = np.concatenate([a, b])                       # [2E] endpoint ids
    eidx = np.concatenate([np.arange(ec), np.arange(ec)])
    order = np.lexsort((eidx, ends))
    starts = np.searchsorted(ends[order], ends[order])
    rank = np.empty(2 * ec, np.int64)
    rank[order] = np.arange(2 * ec) - starts
    keep = (rank[:ec] < k) & (rank[ec:] < k)
    a, b, dialed_by_a = a[keep], b[keep], dialed_by_a[keep]

    # directed views: edge e appears as (a->b) and (b->a)
    e = len(a)
    u = np.concatenate([a, b])                          # [2E] source
    v = np.concatenate([b, a])                          # [2E] target
    outbound_dir = np.concatenate([dialed_by_a, ~dialed_by_a])
    # slot per directed edge: position of v among u's sorted neighbors
    order = np.lexsort((v, u))
    starts = np.searchsorted(u[order], u[order])
    slot = np.empty(2 * e, np.int64)
    slot[order] = np.arange(2 * e) - starts
    # the reverse direction of directed edge i is i±E by construction
    rev = np.concatenate([slot[e:], slot[:e]])

    neighbors = np.full((n, k), -1, np.int32)
    outbound = np.zeros((n, k), bool)
    reverse_slot = np.full((n, k), -1, np.int32)
    neighbors[u, slot] = v.astype(np.int32)
    outbound[u, slot] = outbound_dir
    reverse_slot[u, slot] = rev.astype(np.int32)
    degree_arr = (neighbors >= 0).sum(axis=1).astype(np.int32)
    return Topology(neighbors, outbound, reverse_slot, degree_arr)
