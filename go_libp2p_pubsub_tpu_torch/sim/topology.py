"""Adjacency constructors for the simulated swarm (host-side numpy).

A copy of the JAX package's ``sim/topology.py`` builders the slice uses,
array-equal for the same seed. Mirrors the reference test harness's
``sparseConnect`` (floodsub_test.go:75-82) as padded arrays:

- ``neighbors [N, K] int32``: peer index per slot, -1 for empty
- ``outbound  [N, K] bool``: True where this side dialed (gossipsub.go:467-476)
- ``reverse_slot [N, K] int32``: slot of me in my neighbor's table, -1 padding
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class Topology(NamedTuple):
    neighbors: np.ndarray      # [N, K] int32, -1 padded
    outbound: np.ndarray       # [N, K] bool
    reverse_slot: np.ndarray   # [N, K] int32, -1 padded
    degree: np.ndarray         # [N] int32


def _finalize(n: int, k: int, adj: list[set[int]], dialed: set[tuple[int, int]]) -> Topology:
    neighbors = np.full((n, k), -1, dtype=np.int32)
    outbound = np.zeros((n, k), dtype=bool)
    slot_of: dict[tuple[int, int], int] = {}
    degree = np.zeros(n, dtype=np.int32)
    for i in range(n):
        nbrs = sorted(adj[i])[:k]
        degree[i] = len(nbrs)
        for s, j in enumerate(nbrs):
            neighbors[i, s] = j
            outbound[i, s] = (i, j) in dialed
            slot_of[(i, j)] = s
    reverse_slot = np.full((n, k), -1, dtype=np.int32)
    for (i, j), s in slot_of.items():
        rs = slot_of.get((j, i))
        if rs is not None:
            reverse_slot[i, s] = rs
    # capacity truncation can orphan one side of an edge; drop such slots so
    # every surviving edge is symmetric
    orphan = (neighbors >= 0) & (reverse_slot < 0)
    if orphan.any():
        neighbors[orphan] = -1
        outbound[orphan] = False
        degree = (neighbors >= 0).sum(axis=1).astype(np.int32)
    return Topology(neighbors, outbound, reverse_slot, degree)


def sparse(n: int, k: int, degree: int = 3, seed: int = 314159) -> Topology:
    """Random graph, ``degree`` dials per peer (floodsub_test.go:75-82)."""
    rng = np.random.default_rng(seed)
    adj: list[set[int]] = [set() for _ in range(n)]
    dialed: set[tuple[int, int]] = set()
    for i in range(n):
        choices = rng.permutation(n)
        added = 0
        for j in choices:
            j = int(j)
            if j == i or j in adj[i]:
                continue
            if len(adj[i]) >= k or len(adj[j]) >= k:
                continue
            adj[i].add(j)
            adj[j].add(i)
            dialed.add((i, j))
            added += 1
            if added >= degree:
                break
    return _finalize(n, k, adj, dialed)
