"""Adjacency constructors for the simulated swarm (host-side numpy).

A copy of the JAX package's ``sim/topology.py`` builders, array-equal for
the same arguments: ``sparse``/``dense`` (floodsub_test.go:75-91),
``full`` (connectAll, floodsub_test.go:93-100), ``star``
(gossipsub_test.go:1044-1127), ``from_hosts`` (the functional runtime's
live connections, net/network.py), and the frontier-scale underlays
``sparse_fast``, ``sparse_hash`` and ``powerlaw`` (the last two
shard-constructible through ``rows=(start, count)``), with the power-law
graph's degree-bucket partition (``powerlaw_buckets``,
``align_degree_buckets``) and ``degree_stats``. Results are padded
arrays:

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


def dense(n: int, k: int, degree: int = 10, seed: int = 314159) -> Topology:
    """Random graph, 10 dials per peer (floodsub_test.go:84-91)."""
    return sparse(n, k, degree=degree, seed=seed)


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


def hash_offsets(n: int, degree: int, seed: int = 314159) -> np.ndarray:
    """The ``degree`` seed-derived circulant offsets :func:`sparse_hash`
    builds from — distinct, never 0 or n/2, and no two complements mod n
    (rejection-sampled), so every peer's 2·degree targets are distinct
    and every edge appears exactly once per direction."""
    if degree < 1 or degree > max(0, (n - 1) // 2):
        raise ValueError(
            f"sparse_hash: degree={degree} needs 1 <= degree <= "
            f"(n-1)//2 = {(n - 1) // 2} distinct offset classes at n={n}")
    rng = np.random.default_rng(seed)
    offs: list[int] = []
    taken: set[int] = set()
    while len(offs) < degree:
        o = int(rng.integers(1, n))
        if o in taken or (n - o) in taken or 2 * o == n:
            continue
        taken.add(o)
        offs.append(o)
    return np.array(sorted(offs), np.int64)


def sparse_hash(n: int, k: int, degree: int = 8, seed: int = 314159,
                rows: tuple[int, int] | None = None,
                chunk_rows: int = 16384) -> Topology:
    """Shard-constructible pseudo-random underlay: a circulant graph on
    seeded-hash offsets, where EVERY row is a pure function of
    ``(n, degree, seed, row)`` — no global table, ever.

    ``sparse_fast``'s pair-dedup / capacity-rank passes are global (row
    i's slots depend on every other row's draws), so it needs the whole
    table on one host. Here peer i's neighbors are
    ``{(i ± o_d) mod n}`` for ``degree`` offsets drawn once from the
    seed (:func:`hash_offsets`): a ``rows=(start, count)`` build
    materializes ONLY that shard of every ``[N, K]`` plane, and the
    concat of the shards equals the full build bit for bit BY
    CONSTRUCTION.

    Graph shape: 2·degree-regular (uniform — the degree-histogram
    analogue of ``sparse_fast``'s Poisson spread), symmetric, slots in
    sorted-neighbor order like ``_finalize``; the "+" offset direction
    is the dialed (outbound) side. ``reverse_slot`` is computed locally
    by ranking ``i`` inside its neighbor's formulaic neighbor set —
    [chunk, 2·degree, 2·degree] comparisons per chunk, never a global
    pass. Like ``sparse_fast`` it is not sample-identical to ``sparse``.
    """
    if n < 2:
        raise ValueError(f"sparse_hash needs n >= 2, got {n}")
    if 2 * degree > k:
        raise ValueError(
            f"sparse_hash: 2*degree={2 * degree} slots needed > k={k}")
    offs = hash_offsets(n, degree, seed)
    r0, cnt = (0, n) if rows is None else rows
    if r0 < 0 or cnt < 0 or r0 + cnt > n:
        raise ValueError(f"sparse_hash: rows=({r0}, {cnt}) outside [0, {n})")
    neighbors = np.full((cnt, k), -1, np.int32)
    outbound = np.zeros((cnt, k), bool)
    reverse_slot = np.full((cnt, k), -1, np.int32)
    d2 = 2 * degree
    for c0 in range(0, cnt, chunk_rows):
        c1 = min(c0 + chunk_rows, cnt)
        i = np.arange(r0 + c0, r0 + c1, dtype=np.int64)[:, None]   # [R, 1]
        nbrs = np.concatenate([(i + offs) % n, (i - offs) % n], 1)  # [R, 2D]
        dialed = np.concatenate([np.ones_like(offs, bool),
                                 np.zeros_like(offs, bool)])        # [2D]
        order = np.argsort(nbrs, axis=1, kind="stable")
        nb_s = np.take_along_axis(nbrs, order, 1)
        out_s = np.take_along_axis(np.broadcast_to(dialed, nbrs.shape),
                                   order, 1)
        # my slot in neighbor j's table = rank of i among j's OWN sorted
        # neighbor set {(j ± o) mod n} — formulaic, so strictly local
        j_nbrs = np.concatenate([(nb_s[:, :, None] + offs) % n,
                                 (nb_s[:, :, None] - offs) % n], 2)
        rev = np.sum(j_nbrs < i[:, :, None], axis=2, dtype=np.int64)
        neighbors[c0:c1, :d2] = nb_s.astype(np.int32)
        outbound[c0:c1, :d2] = out_s
        reverse_slot[c0:c1, :d2] = rev.astype(np.int32)
    degree_arr = np.full(cnt, d2, np.int32)
    return Topology(neighbors, outbound, reverse_slot, degree_arr)


def powerlaw_levels(n: int, d_min: int = 8, d_max: int = 64,
                    alpha: float = 2.0) -> list[tuple[int, int]]:
    """The prefix-nested ring schedule realizing a truncated power-law
    degree sequence: ``[(m_l, c_l)]`` where level ``l`` is a circulant on
    the id-prefix ``[0, m_l)`` with ``c_l`` seed-drawn offsets (2 edges
    per offset per member). Peer ``i``'s degree is ``2 * sum(c_l for
    m_l > i)`` — non-increasing with id, so the hubs are the LOW ids
    (the contiguous region eclipse windows target, sim/faults.py).

    Level ``l`` covers the prefix ``m_l ~ n * 2^(-l*(alpha-1))`` and
    doubles the prefix's degree, which realizes the complementary-CDF
    ``P(D >= x) ~ (x/d_min)^-(alpha-1)`` of a truncated power law with
    tail exponent ``alpha`` (alpha=2 halves the prefix per doubling).
    The last level is trimmed so the hub degree lands on ``d_max``
    exactly when the prefix has room for its offset classes; levels
    whose prefix gets too small for distinct offset classes are dropped
    (the realized hub degree is then below ``d_max``)."""
    if n < 4:
        raise ValueError(f"powerlaw needs n >= 4, got {n}")
    if d_min < 2 or d_min % 2:
        raise ValueError(f"powerlaw: d_min must be even >= 2, got {d_min}")
    if d_max < d_min:
        raise ValueError(f"powerlaw: d_max={d_max} < d_min={d_min}")
    if alpha <= 1.0:
        raise ValueError(f"powerlaw: alpha={alpha} needs alpha > 1")
    levels = [(n, d_min // 2)]
    deg = 2 * (d_min // 2)
    lev = 1
    while deg < d_max:
        m = int(np.ceil(n * 2.0 ** (-lev * (alpha - 1.0))))
        c = min((d_max - deg) // 2, deg // 2)       # doubling, d_max-trimmed
        if c < 1 or m < 4 * c + 4:
            break                # prefix too small for c distinct classes
        levels.append((m, c))
        deg += 2 * c
        lev += 1
    return levels


def _powerlaw_offsets(levels: list[tuple[int, int]],
                      seed: int) -> list[np.ndarray]:
    """Per-level circulant offsets with GLOBALLY disjoint difference
    classes: an accepted offset ``o`` of level ``l`` reserves the integer
    class ``{o, m_l - o}``, and every candidate colliding with any
    reserved value (its own level's or another's) is rejected. Disjoint
    classes mean two levels can never produce the same (i, j) pair — the
    construction is duplicate-free WITHOUT a dedup pass, so every row's
    slot count is exactly its formulaic degree and ``reverse_slot``
    ranks against a formulaic (never materialized) neighbor set."""
    rng = np.random.default_rng(seed)
    taken: set[int] = set()
    out: list[np.ndarray] = []
    for m, c in levels:
        offs: list[int] = []
        tries = 0
        while len(offs) < c:
            tries += 1
            if tries > 1000 * c:
                raise ValueError(
                    f"powerlaw: could not draw {c} disjoint offset "
                    f"classes in a ring of {m} (degree schedule too "
                    "dense for this n — lower d_max or raise n)")
            o = int(rng.integers(1, m))
            if o in taken or (m - o) in taken or 2 * o == m:
                continue
            taken.add(o)
            taken.add(m - o)
            offs.append(o)
        out.append(np.array(sorted(offs), np.int64))
    return out


def powerlaw(n: int, k: int, d_min: int = 8, d_max: int = 64,
             alpha: float = 2.0, seed: int = 314159,
             rows: tuple[int, int] | None = None,
             chunk_elems: int = 1 << 22) -> Topology:
    """Shard-constructible heavy-tailed underlay: a truncated power-law
    degree sequence (tail exponent ``alpha``, degrees in
    ``[d_min, ~d_max]``, non-increasing with peer id) realized as
    prefix-nested seeded circulants — the configuration-model analogue
    of :func:`sparse_hash`, where every row is a pure function of
    ``(n, d_min, d_max, alpha, seed, row)`` and a ``rows=(start,
    count)`` build materializes only that shard of every plane (concat
    across shards equals the full build bit for bit).

    Graph shape: symmetric, duplicate-free (disjoint difference classes
    across levels — :func:`_powerlaw_offsets`), slots in sorted-neighbor
    order like ``_finalize``, the "+" offset direction dialed
    (outbound). Hubs are the LOW ids: the contiguous region an eclipse
    window targets (sim/faults.py). ``reverse_slot`` ranks
    ``i`` inside each neighbor's formulaic candidate set — strictly
    local, chunk cost ``[R, D_row, D_max]`` with ``R`` auto-shrunk near
    the hubs (``chunk_elems`` bounds the temporary)."""
    levels = powerlaw_levels(n, d_min=d_min, d_max=d_max, alpha=alpha)
    offs = _powerlaw_offsets(levels, seed)
    dmax_real = 2 * sum(c for _, c in levels)
    if k < dmax_real:
        raise ValueError(
            f"powerlaw: hub degree {dmax_real} needs k >= {dmax_real}, "
            f"got k={k}")
    r0, cnt = (0, n) if rows is None else rows
    if r0 < 0 or cnt < 0 or r0 + cnt > n:
        raise ValueError(f"powerlaw: rows=({r0}, {cnt}) outside [0, {n})")

    # flattened per-level candidate schedule: for each level l and offset
    # o, two signed columns (+o then -o) in canonical (level, offset,
    # sign) order — first occurrence IS the only occurrence (disjoint
    # classes), so direction needs no tie-break
    col_m = np.concatenate([np.full(2 * len(o), m, np.int64)
                            for (m, _), o in zip(levels, offs)])
    # interleave so sign order within (level, offset) is [+, -]
    col_off = np.concatenate([np.stack([o, -o], 1).reshape(-1)
                              for o in offs])
    col_out = np.tile(np.array([True, False]),
                      col_m.size // 2)                  # '+' side dialed
    return _powerlaw_fill(n, k, cnt, r0, levels, offs, col_m, col_off,
                          col_out, chunk_elems)


def _ring_rank_below(j: np.ndarray, i: np.ndarray, offs_sorted: np.ndarray,
                     m: int) -> np.ndarray:
    """#{x in {(j±o) mod m : o in offs_sorted} : x < i} in closed form —
    each of the four (sign, wrap) branches is a contiguous offset
    interval, counted by searchsorted on the SORTED offsets. This is
    what keeps ``reverse_slot`` construction at ``ΣD·levels·log c``
    instead of materializing every neighbor's candidate set
    (``ΣD·D_max``, minutes at 1M)."""
    O = offs_sorted

    def upto(v):                              # #{o in O : o <= v}
        return np.searchsorted(O, v, side="right")

    # '+' no wrap: o <= m-1-j, x = j+o < i          -> o <= min(i-j-1, m-1-j)
    ca = upto(np.minimum(i - j - 1, m - 1 - j))
    # '+' wrap:    o >= m-j,   x = j+o-m < i        -> o <= m-j+i-1
    cb = upto(np.minimum(m - j + i - 1, m - 1)) - upto(m - j - 1)
    # '-' no wrap: o <= j,     x = j-o < i          -> o >= j-i+1
    cc = upto(np.minimum(j, m - 1)) - upto(np.maximum(j - i + 1, 1) - 1)
    # '-' wrap:    o >= j+1,   x = j-o+m < i        -> o >= m+j-i+1
    cd = upto(m - 1) - upto(np.maximum(j + 1, m + j - i + 1) - 1)
    return ca + cb + cc + cd


def _powerlaw_fill(n, k, cnt, r0, levels, offs, col_m, col_off, col_out,
                   chunk_elems) -> Topology:
    neighbors = np.full((cnt, k), -1, np.int32)
    outbound = np.zeros((cnt, k), bool)
    reverse_slot = np.full((cnt, k), -1, np.int32)
    c0 = 0
    while c0 < cnt:
        # the chunk's first row is its widest (degrees non-increasing);
        # drop columns of levels no chunk row belongs to
        act = col_m > r0 + c0
        am, ao, aout = col_m[act], col_off[act], col_out[act]
        width = int(act.sum())
        rchunk = max(64, int(chunk_elems // max(width, 1)))
        c1 = min(c0 + rchunk, cnt)
        i = np.arange(r0 + c0, r0 + c1, dtype=np.int64)[:, None]   # [R, 1]
        member = i < am[None, :]                                   # [R, W]
        cand = np.where(member, (i + ao[None, :]) % am[None, :],
                        np.int64(n))
        order = np.argsort(cand, axis=1, kind="stable")
        nb_s = np.take_along_axis(cand, order, 1)                  # [R, W]
        out_s = np.take_along_axis(
            np.broadcast_to(aout, cand.shape), order, 1)
        valid = nb_s < n
        j = np.where(valid, nb_s, 0)
        # my slot in neighbor j's table = rank of i among j's formulaic
        # candidates, summed over the levels j belongs to (duplicate-free
        # across levels, so rank == sorted-slot index)
        rev = np.zeros_like(j)
        for (m, _), o in zip(levels, offs):
            lvl = j < m                                            # [R, W]
            cnt_l = _ring_rank_below(np.where(lvl, j, 0), i, o, m)
            rev += np.where(lvl, cnt_l, 0)
        take = min(width, k)
        neighbors[c0:c1, :take] = np.where(valid, nb_s, -1)[:, :take]
        outbound[c0:c1, :take] = (valid & out_s)[:, :take]
        reverse_slot[c0:c1, :take] = np.where(valid, rev, -1)[:, :take]
        c0 = c1
    degree_arr = (neighbors >= 0).sum(axis=1).astype(np.int32)
    return Topology(neighbors, outbound, reverse_slot, degree_arr)


def powerlaw_buckets(n: int, d_min: int = 8, d_max: int = 64,
                     alpha: float = 2.0, round_to: int = 8,
                     ) -> tuple[tuple[int, int], ...]:
    """The degree-bucket partition a :func:`powerlaw` graph induces
    (topology.py:430-449): ``((n_rows, k_ceil), ...)`` in id order, one
    bucket per maximal contiguous equal-degree id range (the level-prefix
    boundaries), each ceiling rounded up to ``round_to`` slots. This is
    the value ``SimConfig.degree_buckets`` takes; ``k_slots`` must equal
    the first (hub) bucket's ceiling (``sim.bucketed.check_bucketable``)."""
    levels = powerlaw_levels(n, d_min=d_min, d_max=d_max, alpha=alpha)
    bounds = sorted({m for m, _ in levels})             # ascending prefixes
    out = []
    prev = 0
    for m in bounds:
        deg = 2 * sum(c for (ml, c) in levels if ml >= m)
        ceil = -(-max(deg, 1) // round_to) * round_to
        out.append((m - prev, ceil))
        prev = m
    return tuple(out)


def align_degree_buckets(buckets, align: int) -> tuple:
    """``buckets`` with every cumulative bucket boundary rounded UP to a
    multiple of ``align`` (topology.py:452-485): the partition a
    row-sharded bucketed state needs. Rounding up moves boundary rows into
    the earlier, wider bucket, so their edges still fit; buckets emptied
    by the move drop out."""
    bks = tuple((int(r), int(k)) for r, k in buckets)
    n = sum(r for r, _ in bks)
    if align <= 0 or n % align:
        raise ValueError(
            f"align_degree_buckets: {n} rows do not tile align={align}; "
            "the id space itself must be a multiple of the alignment")
    out, prev = [], 0
    end = 0
    for r, kb in bks:
        end += r
        new_end = min(n, -(-end // align) * align)
        new_end = max(new_end, prev)             # keep boundaries monotone
        if new_end > prev:
            out.append((new_end - prev, kb))
        prev = new_end
    return tuple(out)


def degree_stats(topo: "Topology | np.ndarray") -> dict:
    """Shape summary of an underlay's degree sequence (topology.py:
    488-509): min/mean/p99/max degree and the Gini coefficient of the
    distribution (0 = uniform degree, ~0.5+ = heavy-tailed)."""
    deg = np.asarray(topo.degree if isinstance(topo, Topology) else topo,
                     np.int64)
    if deg.size == 0:
        raise ValueError("degree_stats: empty degree sequence")
    srt = np.sort(deg)
    total = int(srt.sum())
    if total > 0:
        cum = np.cumsum(srt, dtype=np.int64)
        gini = float((deg.size + 1 - 2 * (cum.sum() / total)) / deg.size)
    else:
        gini = 0.0
    return {"n": int(deg.size), "sum": total,
            "min": int(srt[0]), "max": int(srt[-1]),
            "mean": round(float(srt.mean()), 3),
            "p99": int(np.percentile(srt, 99, method="lower")),
            "gini": round(gini, 4)}


def full(n: int, k: int) -> Topology:
    """Complete graph (connectAll, floodsub_test.go:93-100). Requires k >= n-1."""
    if k < n - 1:
        raise ValueError(f"full({n=}) needs k >= {n - 1}, got {k}")
    adj = [set(range(n)) - {i} for i in range(n)]
    dialed = {(i, j) for i in range(n) for j in range(i + 1, n)}
    return _finalize(n, k, adj, dialed)


def from_hosts(hosts, k: int) -> tuple[Topology, dict]:
    """Topology mirroring a functional-runtime network's live connections
    (net/network.py Host.conns), plus the peer-id -> index map.

    Slot assignment matches ``_finalize`` (sorted neighbor ids), so a trace
    replayed into this topology addresses the same (peer, slot) cells the
    live routers mutated. Dial direction comes from the substrate's
    "outbound"/"inbound" conn tags (gossipsub.go:467-476 feeds Dout).
    """
    n = len(hosts)
    peer_index = {h.peer_id: i for i, h in enumerate(hosts)}
    adj: list[set[int]] = [set() for _ in range(n)]
    dialed: set[tuple[int, int]] = set()
    for i, h in enumerate(hosts):
        for pid, direction in h.conns.items():
            j = peer_index.get(pid)
            if j is None:
                continue
            adj[i].add(j)
            if direction == "outbound":
                dialed.add((i, j))
    return _finalize(n, k, adj, dialed), peer_index


def star(n: int, k: int) -> Topology:
    """Peer 0 is the hub (gossipsub_test.go:1044-1127)."""
    adj: list[set[int]] = [set() for _ in range(n)]
    dialed = set()
    for i in range(1, n):
        adj[0].add(i)
        adj[i].add(0)
        dialed.add((i, 0))
    return _finalize(n, k, adj, dialed)
