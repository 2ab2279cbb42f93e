"""The peer axis split over a ``torch.distributed`` group (port of
parallel/sharding.py).

The reference shards every ``[N, ...]`` plane of the state along a
``peers`` mesh axis and replicates the message tables and scalars; XLA
inserts the collectives. Here a "mesh" is a :class:`PeerMesh`, a process
group with the shape the reference's mesh would have: rank ``r`` holds
rows ``[r N/P, (r+1) N/P)`` of every peer-major plane (hosts-major on a
``(dcn, peers)`` mesh, so the split is the same contiguous one) and a
whole copy of every replicated field. The step runs each rank's rows
inside :func:`~.kernel_context.kernel_mesh`, where every read of another
rank's rows is an explicit collective (parallel/kernel_context.py).

- :func:`make_mesh` / :func:`make_mesh_2d`: the group (the default one
  when None), and its ``(dcn, peers)`` split;
- :func:`state_partition_specs`: per field ``"peers"`` (split) or None
  (replicated), from ``sim.state.state_spec``;
- :func:`shard_state`: this rank's rows of a whole state;
- :func:`make_sharded_step`, :func:`make_sharded_run_keys`: the sharded
  plans of parallel/compile_plan.py;
- the row-sharded bucketed plane (sharding.py:121-181):
  :func:`bucketed_partition_specs`, :func:`shard_bucketed_state`,
  :func:`gather_bucketed` and :func:`make_sharded_bucketed_run`. Every
  bucket's rows split over the ranks, so each rank owns the same fraction
  of every degree class; unlike the reference's, a rank's global half
  ``g`` holds the same rows as its bucket windows (bucket after bucket,
  parallel/kernel_context.bucket_rows), so a bucket's view of ``g`` is a
  local slice and only the cross-peer reads are collectives.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..sim.config import SimConfig, TopicParams
from ..sim.state import SimState

PEER_AXIS = "peers"
DCN_AXIS = "dcn"


class PeerMesh(NamedTuple):
    group: object           # torch.distributed ProcessGroup (None: WORLD)
    size: int               # ranks
    rank: int
    shape: dict             # axis name -> ranks along it


def _group_info(group):
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError("make_mesh: torch.distributed is not initialised "
                           "(parallel/multihost.initialize)")
    return dist.get_world_size(group), dist.get_rank(group)


def make_mesh(group=None) -> PeerMesh:
    """A 1-D ``peers`` mesh over ``group`` (the default group when None)."""
    size, rank = _group_info(group)
    return PeerMesh(group, size, rank, {PEER_AXIS: size})


def make_mesh_2d(n_hosts: int, group=None) -> PeerMesh:
    """A ``(dcn, peers)`` mesh: the peer axis splits over both axes,
    hosts-major, so each host holds one contiguous block of peers (the
    reference's multi-host layout, sharding.py:35-52)."""
    size, rank = _group_info(group)
    if n_hosts <= 0 or size % n_hosts:
        raise ValueError(
            f"make_mesh_2d: {size} devices do not split over "
            f"{n_hosts} hosts")
    return PeerMesh(group, size, rank,
                    {DCN_AXIS: n_hosts, PEER_AXIS: size // n_hosts})


def state_partition_specs(mesh: PeerMesh, cfg: SimConfig) -> dict:
    """field -> the axes its leading dimension splits over (``"peers"``, or
    ``("dcn", "peers")`` on a 2-D mesh) or None for a replicated field,
    from the layout's one source (``sim.state.state_spec``)."""
    from ..sim.state import state_spec

    peer_axes = (DCN_AXIS, PEER_AXIS) if DCN_AXIS in mesh.shape \
        else PEER_AXIS
    return {f: peer_axes if peer_major else None
            for f, (_shape, _dtype, peer_major) in state_spec(cfg).items()}


def state_shardings(mesh: PeerMesh, cfg: SimConfig) -> dict:
    """:func:`state_partition_specs` after the divisibility check."""
    if mesh.size <= 0 or cfg.n_peers % mesh.size:
        raise ValueError(
            f"state_shardings: n_peers {cfg.n_peers} must divide the "
            f"{mesh.size}-device mesh")
    return state_partition_specs(mesh, cfg)


def shard_state(state: SimState, mesh: PeerMesh, cfg: SimConfig) -> SimState:
    """This rank's rows of a whole state: peer-major fields sliced (as
    their own contiguous tensors), replicated fields as they are."""
    specs = state_shardings(mesh, cfg)
    nl = cfg.n_peers // mesh.size
    r0 = mesh.rank * nl
    return SimState(**{
        f: getattr(state, f)[r0:r0 + nl].clone() if specs[f] is not None
        else getattr(state, f) for f in SimState._fields})


def make_sharded_step(mesh: PeerMesh, cfg: SimConfig, tp: TopicParams):
    """The sharded step: ``fn(state, key)`` on this rank's rows
    (:func:`parallel.compile_plan.sharded_step_plan`)."""
    from .compile_plan import sharded_step_plan
    return sharded_step_plan(mesh, cfg, tp)


def make_sharded_run_keys(mesh: PeerMesh, cfg: SimConfig, tp: TopicParams,
                          telemetry: bool = False):
    """The sharded chunk: ``fn(state, keys)`` over ``[C, 2]`` tick keys
    (:func:`parallel.compile_plan.sharded_chunk_plan`)."""
    from .compile_plan import sharded_chunk_plan
    return sharded_chunk_plan(mesh, cfg, tp, telemetry=telemetry)


def gather_full(state: SimState, cfg: SimConfig, group=None) -> SimState:
    """The whole state from every rank's rows: one all-gather per
    peer-major field (a collective: every rank calls it; each gets the
    whole state on its own device)."""
    from ..sim.state import state_spec
    from .kernel_context import kernel_mesh, replicate

    spec = state_spec(cfg)
    with kernel_mesh(cfg.n_peers, group):
        return SimState(**{
            f: replicate(getattr(state, f)) if spec[f][2]
            else getattr(state, f) for f in SimState._fields})


_DIGEST_MUL = 0x9E3779B97F4A7C15 - 2 ** 64     # odd, as an int64


def _field_digest(x: torch.Tensor, flat0: int) -> torch.Tensor:
    """sum over elements of bits(x[i]) * (2 i + 1) * M, int64 wrapping:
    additive over row blocks given each block's global flat offset."""
    v = x.reshape(-1)
    if v.dtype == torch.bool:
        v = v.to(torch.int64)
    elif v.dtype in (torch.float32, torch.int32):
        v = v.view(torch.int32).to(torch.int64)
    else:
        v = v.to(torch.int64)
    idx = torch.arange(v.numel(), dtype=torch.int64, device=v.device) + flat0
    return (v * (2 * idx + 1) * _DIGEST_MUL).sum()


def state_digests(state: SimState, cfg: SimConfig, group=None) -> dict:
    """field -> an int64 digest of the WHOLE state, computed from this
    rank's rows and summed over the group (a collective inside one), so a
    sharded run and a single-process run of the same trajectory give the
    same digests. Every rank gets them."""
    import torch.distributed as dist

    from ..sim.state import state_spec
    from .kernel_context import kernel_mesh, psum

    spec = state_spec(cfg)
    grouped = dist.is_available() and dist.is_initialized() \
        and dist.get_world_size(group) > 1
    rank = dist.get_rank(group) if grouped else 0
    world = dist.get_world_size(group) if grouped else 1
    parts = []
    for f in SimState._fields:
        x = getattr(state, f)
        if spec[f][2]:
            flat0 = rank * x.numel()
            d = _field_digest(x, flat0)
        else:
            # replicated: each rank adds its share of one copy
            d = _field_digest(x, 0) if rank == 0 else \
                torch.zeros((), dtype=torch.int64, device=x.device)
        parts.append(d)
    tot = torch.stack(parts)
    if grouped:
        with kernel_mesh(cfg.n_peers, group):
            tot = psum(tot)
    del world
    return {f: int(v) for f, v in zip(SimState._fields, tot.tolist())}


# ---------------------------------------------------------------------------
# the row-sharded bucketed plane


def bucketed_partition_specs(mesh: PeerMesh, cfg: SimConfig):
    """A BucketedState-shaped tree of split axes: ``g`` as
    :func:`state_partition_specs` (its zero-width edge placeholders keep
    the N axis), every bucket's edge planes and ``rev`` split along their
    own rows."""
    from ..sim.bucketed import EDGE_FIELDS, BucketedState, EdgePlanes

    peer_axes = (DCN_AXIS, PEER_AXIS) if DCN_AXIS in mesh.shape \
        else PEER_AXIS
    nb = len(cfg.degree_buckets)
    edge = EdgePlanes(**{f: peer_axes for f in EDGE_FIELDS})
    return BucketedState(g=state_partition_specs(mesh, cfg),
                         e=(edge,) * nb, rev=(peer_axes,) * nb)


def bucketed_state_shardings(mesh: PeerMesh, cfg: SimConfig):
    """:func:`bucketed_partition_specs` after the checks: a bucketable
    config, and every bucket's rows tiling the mesh (refused by bucket)."""
    from ..sim.bucketed import check_bucketable

    check_bucketable(cfg)
    for b, (n_rows, kb) in enumerate(cfg.degree_buckets):
        if int(n_rows) % mesh.size:
            raise ValueError(
                f"bucketed_state_shardings: bucket {b} ({int(n_rows)} rows "
                f"x k_ceil {int(kb)}) does not tile the {mesh.size}-device "
                "mesh — realign the partition with "
                "topology.align_degree_buckets")
    return bucketed_partition_specs(mesh, cfg)


def shard_bucketed_state(bs, mesh: PeerMesh, cfg: SimConfig):
    """This rank's part of a whole BucketedState: each bucket's window of
    rows (edge planes and ``rev``), and ``g``'s rows at those ids, bucket
    after bucket; replicated fields as they are."""
    from ..sim.bucketed import BucketedState, EdgePlanes
    from ..sim.state import state_spec
    from .kernel_context import bucket_rows

    bucketed_state_shardings(mesh, cfg)
    spec = state_spec(cfg)
    ids = bucket_rows(cfg.degree_buckets, mesh.rank, mesh.size)
    g = SimState(**{
        f: getattr(bs.g, f).index_select(
            0, ids.to(getattr(bs.g, f).device)) if spec[f][2]
        else getattr(bs.g, f) for f in SimState._fields})
    e, rev = [], []
    for b, (c, _kb) in enumerate(cfg.degree_buckets):
        cl = int(c) // mesh.size
        sl = slice(mesh.rank * cl, (mesh.rank + 1) * cl)
        e.append(EdgePlanes(*(x[sl].clone() for x in bs.e[b])))
        rev.append(bs.rev[b][sl].clone())
    return BucketedState(g=g, e=tuple(e), rev=tuple(rev))


def gather_bucketed(bs, cfg: SimConfig, group=None):
    """The whole BucketedState from every rank's part (a collective: every
    rank calls it and gets the whole state on its device)."""
    from ..sim.bucketed import BucketedState, EdgePlanes
    from ..sim.state import state_spec
    from .kernel_context import gather_rows, kernel_mesh, replicate

    spec = state_spec(cfg)
    with kernel_mesh(cfg.n_peers, group, buckets=cfg.degree_buckets):
        g = SimState(**{
            f: replicate(getattr(bs.g, f)) if spec[f][2]
            else getattr(bs.g, f) for f in SimState._fields})
        e = tuple(EdgePlanes(*(gather_rows(x) for x in ep)) for ep in bs.e)
        rev = tuple(gather_rows(r) for r in bs.rev)
    return BucketedState(g=g, e=e, rev=rev)


def make_sharded_bucketed_run(mesh: PeerMesh, cfg: SimConfig,
                              tp: TopicParams):
    """The sharded bucketed chunk: ``fn(bs, keys, tp_arg=None)``
    (:func:`parallel.compile_plan.bucketed_chunk_plan`)."""
    from .compile_plan import bucketed_chunk_plan
    return bucketed_chunk_plan(mesh, cfg, tp)


def bucketed_digests(bs, cfg: SimConfig, group=None) -> dict:
    """leaf name -> an int64 digest of the WHOLE BucketedState (gathered
    first inside a group of more than one process: a collective), the
    names of ``sim.bucketed.named_leaves``; equal for a sharded and a
    single-process run of one trajectory."""
    import torch.distributed as dist

    from ..sim.bucketed import named_leaves
    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size(group) > 1:
        bs = gather_bucketed(bs, cfg, group)
    return {name: int(_field_digest(x, 0))
            for name, x, _dt in named_leaves(bs)}
