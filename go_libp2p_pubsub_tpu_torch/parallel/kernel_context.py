"""The peer group: a ``torch.distributed`` group over which the peer axis
is split (port of parallel/kernel_context.py).

The reference shards the peer axis over a JAX device mesh and lets XLA's
partitioner insert the collectives every cross-shard read needs; only its
Pallas kernels are wrapped by hand (``shard_kernel``: tables replicated,
rows local). PyTorch has no partitioner, so in the port every read of
another rank's rows is an explicit collective, and it goes through one of
the helpers below:

- :func:`replicate` all-gathers a peer-major plane along its peer axis
  (the counterpart of a ``(None, None)`` spec, the kernels' tables);
- :func:`owner_rows` reads a peer-major plane at global peer ids;
- :func:`psum`, :func:`pany` and :func:`por` fold a per-rank partial of a
  global scalar (a count, a flag, a flag word) over the group;
- :func:`all_to_all` is the halo route's exchange (parallel/halo.py).

Rank ``r`` of a ``P``-rank group owns the contiguous peer rows
``[r N/P, (r+1) N/P)`` (hosts-major, as the reference's meshes). Every op
of the step reads its own rows through the state it is given and the
global row offset through :func:`row0`; neighbour ids stay global.
Without an active group every helper is the identity (or returns the
single-process value), so a single-process run launches exactly what it
did before.

The context lives in a ``ContextVar`` as the reference's does: threads
(the supervisor's writer) and nested runs each see their own.

A gloo group takes CUDA tensors in every collective used here
(all-gather, all-to-all, all-reduce and broadcast: checked with torch
2.11.0+cu128 on an H100; gloo stages them through the host itself), so
tensors go to the collectives as they lie, on the CPU and on the card.
"""

from __future__ import annotations

import contextvars
from contextlib import contextmanager
from typing import NamedTuple

import torch

ROUTES = ("replicated", "halo")


class KernelMesh(NamedTuple):
    group: object               # torch.distributed ProcessGroup (None: WORLD)
    rank: int
    world: int
    n: int                      # global peer count
    r0: int                     # first owned row
    nl: int                     # owned rows
    route: str = "replicated"   # "replicated" | "halo" (parallel/halo.py)
    capacity_factor: int = 4    # halo bucket capacity over the uniform mean
    bucket_capacity: int = 0    # exact per-(src, dst) bucket capacity; 0 =
                                # derive from capacity_factor
    overflow_notes: list = None  # halo overflow counts noted this tick,
                                 # drained by engine.step into
                                 # SimState.halo_overflow
    recorder: list = None       # (op, dtype, result elements) per collective
                                # when recording (tests, byte counts)
    ids: torch.Tensor = None    # bucket-major layout: [nl] global ids of the
                                # owned rows (None: the contiguous block)
    order: torch.Tensor = None  # [N] position of each global id in the
                                # rank-order concatenation of every rank's
                                # rows (None: the identity)
    local_of: torch.Tensor = None  # [N] owned row of each global id, nl
                                   # where another rank owns it


_current: contextvars.ContextVar[KernelMesh | None] = \
    contextvars.ContextVar("kernel_mesh", default=None)


def bucket_rows(buckets, rank: int, world: int) -> torch.Tensor:
    """[N / world] global ids a rank owns under the bucket-major layout of
    a ``degree_buckets`` partition: its window ``[s_b + rank c_b / P,
    s_b + (rank + 1) c_b / P)`` of every bucket, bucket after bucket."""
    out, s = [], 0
    for b, (c, kb) in enumerate(buckets):
        c = int(c)
        if c % world:
            raise ValueError(
                f"bucket {b} ({c} rows x k_ceil {int(kb)}) does not tile "
                f"the {world}-rank group — realign the partition with "
                "topology.align_degree_buckets")
        cl = c // world
        out.append(torch.arange(s + rank * cl, s + (rank + 1) * cl))
        s += c
    return torch.cat(out)


@contextmanager
def kernel_mesh(n_peers: int, group=None, route: str = "replicated",
                capacity_factor: int = 4, bucket_capacity: int = 0,
                recorder: list | None = None,
                buckets=None):
    """Run the code inside on this rank's rows of an ``n_peers`` network
    split over ``group`` (the default process group when None), which
    must be initialised. ``recorder``: a list that collects one ``(op, dtype,
    elements)`` entry per collective. ``buckets`` (a ``degree_buckets``
    partition) selects the bucket-major layout of the sharded bucketed
    engine: each rank owns its window of every bucket (:func:`bucket_rows`)
    instead of one contiguous block, and :func:`replicate` returns rows in
    global id order all the same."""
    import torch.distributed as dist

    if route not in ROUTES:
        raise ValueError(f"unknown sharded_route {route!r}; expected one of "
                         f"{ROUTES}")
    if not dist.is_initialized():
        raise RuntimeError("kernel_mesh: torch.distributed is not "
                           "initialised (parallel/multihost.initialize)")
    world = dist.get_world_size(group)
    rank = dist.get_rank(group)
    if n_peers % world:
        raise ValueError(f"n_peers {n_peers} does not divide the "
                         f"{world}-rank peer axis")
    nl = n_peers // world
    ids = order = local_of = None
    if buckets is not None:
        ids = bucket_rows(buckets, rank, world)
        order = torch.empty(n_peers, dtype=torch.int64)
        order[torch.cat([bucket_rows(buckets, q, world)
                         for q in range(world)])] = torch.arange(n_peers)
        local_of = torch.full((n_peers,), nl, dtype=torch.int64)
        local_of[ids] = torch.arange(nl)
    tok = _current.set(KernelMesh(group, rank, world, n_peers, rank * nl, nl,
                                  route, capacity_factor, bucket_capacity,
                                  [], recorder, ids, order,
                                  local_of))
    try:
        yield _current.get()
    finally:
        _current.reset(tok)


def current_kernel_mesh() -> KernelMesh | None:
    return _current.get()


def note_halo_overflow(count) -> None:
    """Record a halo-route overflow count (already summed over the group)
    for the current step to absorb."""
    ctx = _current.get()
    if ctx is not None and ctx.overflow_notes is not None:
        ctx.overflow_notes.append(count)


def drain_halo_overflow() -> list:
    """Take (and clear) the overflow counts noted since the last drain."""
    ctx = _current.get()
    if ctx is None or not ctx.overflow_notes:
        return []
    notes, ctx.overflow_notes[:] = list(ctx.overflow_notes), []
    return notes


def peer_shards() -> int:
    """Number of ranks the peer axis splits over (1 without a group)."""
    ctx = _current.get()
    return 1 if ctx is None else ctx.world


def local_rows(n: int) -> int:
    """Rows a rank owns of an ``n``-peer axis (``n`` without a group)."""
    shards = peer_shards()
    if n % shards:
        raise ValueError(
            f"n_peers {n} does not divide the {shards}-shard peer axis")
    return n // shards


def row0() -> int:
    """Global id of this rank's first row (0 without a group): its rows
    are ``[row0, row0 + n_local)``. Refused under the bucket-major layout,
    whose rows are no one block (:func:`row_ids`)."""
    ctx = _current.get()
    if ctx is not None and ctx.ids is not None:
        raise RuntimeError("row0: the bucket-major layout's rows are not "
                           "one contiguous block; use row_ids")
    return 0 if ctx is None else ctx.r0


def global_rows(n_local: int) -> int:
    """The global peer count of a plane with ``n_local`` owned rows."""
    ctx = _current.get()
    return n_local if ctx is None else n_local * ctx.world


def row_ids(n_local: int, device) -> torch.Tensor:
    """[n_local] int64 global ids of the owned rows."""
    ctx = _current.get()
    if ctx is not None and ctx.ids is not None:
        return ctx.ids.to(device)
    return torch.arange(n_local, device=device) + row0()


def own_rows(idx: torch.Tensor, n_local: int) -> torch.Tensor:
    """The local row of each global peer id in ``idx``; ids another rank
    owns map to ``n_local``, the scratch row :func:`scratch_row` adds
    (``idx`` itself without a group)."""
    ctx = _current.get()
    if ctx is None:
        return idx
    if ctx.local_of is not None:
        return ctx.local_of.to(idx.device)[idx]
    loc = idx - ctx.r0
    return torch.where((loc >= 0) & (loc < n_local), loc,
                       torch.full_like(loc, n_local))


def scratch_row(x: torch.Tensor) -> torch.Tensor:
    """``x`` with one scratch row appended, for writes at :func:`own_rows`
    indices (``x`` itself without a group); slice ``[:n_local]`` after."""
    if _current.get() is None:
        return x
    return torch.cat([x, x[:1]])


# --- collectives -------------------------------------------------------------

def _record(ctx: KernelMesh, op: str, t: torch.Tensor) -> None:
    if ctx.recorder is not None:
        ctx.recorder.append((op, str(t.dtype), int(t.numel())))


# dtypes gloo's collectives refuse, moved as bits of one it takes
_WIRE = {torch.bool: torch.uint8, torch.int16: torch.float16,
         torch.bfloat16: torch.float16}


def _gather_cat(ctx: KernelMesh, x: torch.Tensor) -> torch.Tensor:
    """[world * x.shape[0], ...]: every rank's ``x`` stacked in rank
    order along dim 0."""
    import torch.distributed as dist

    src = x.contiguous()
    wire = _WIRE.get(src.dtype)
    if wire is not None:
        src = src.view(wire)
    out = torch.empty((ctx.world * src.shape[0],) + tuple(src.shape[1:]),
                      dtype=src.dtype, device=src.device)
    dist.all_gather_into_tensor(out, src, group=ctx.group)
    if wire is not None:
        out = out.view(x.dtype)
    _record(ctx, "all_gather", out)
    return out


def replicate(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """The whole peer axis of a peer-major plane whose ``dim`` holds this
    rank's rows, in global id order: one all-gather (the identity without
    a group)."""
    ctx = _current.get()
    if ctx is None:
        return x
    out = gather_rows(x.movedim(dim, 0) if dim else x)
    if ctx.order is not None:
        out = out.index_select(0, ctx.order.to(out.device))
    return out.movedim(0, dim).contiguous() if dim else out


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """Every rank's ``x`` stacked along dim 0 in rank order (one
    all-gather; the identity without a group): a bucket plane's whole
    bucket under the bucket-major layout."""
    ctx = _current.get()
    if ctx is None:
        return x
    return _gather_cat(ctx, x)


def owner_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x_global[idx]`` of a peer-major plane ``x`` (this rank's rows) at
    global peer ids ``idx`` (any shape, already in range)."""
    return replicate(x)[idx.long()]


def psum(x: torch.Tensor) -> torch.Tensor:
    """The group's sum of a per-rank partial (the value without a group)."""
    import torch.distributed as dist

    ctx = _current.get()
    if ctx is None:
        return x
    y = x.clone()
    dist.all_reduce(y, group=ctx.group)
    _record(ctx, "all_reduce", y)
    return y


def por(x: torch.Tensor) -> torch.Tensor:
    """The group's bitwise OR of an integer tensor (each rank's copy
    gathered and folded, in rank order)."""
    ctx = _current.get()
    if ctx is None:
        return x
    parts = _gather_cat(ctx, x.reshape((1,) + tuple(x.shape)))
    out = parts[0]
    for i in range(1, ctx.world):
        out = out | parts[i]
    return out


def pany(x: torch.Tensor) -> torch.Tensor:
    """The group's any() of a bool tensor (elementwise)."""
    ctx = _current.get()
    if ctx is None:
        return x
    return por(x.to(torch.int32)) != 0


def all_to_all(send: torch.Tensor) -> torch.Tensor:
    """[world, ...] blocks: block ``d`` goes to rank ``d``; returns the
    blocks received, block ``s`` from rank ``s``."""
    import torch.distributed as dist

    ctx = _current.get()
    if ctx is None:
        return send
    src = send.contiguous()
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=ctx.group)
    _record(ctx, "all_to_all", out)
    return out


def broadcast(x: torch.Tensor, src: int = 0) -> torch.Tensor:
    """Rank ``src``'s ``x`` on every rank (same shape and dtype on all)."""
    import torch.distributed as dist

    ctx = _current.get()
    if ctx is None:
        return x
    y = x.clone()
    dist.broadcast(y, src, group=ctx.group)
    _record(ctx, "broadcast", y)
    return y
