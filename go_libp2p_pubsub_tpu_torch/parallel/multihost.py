"""Multi-process runs: one process per rank of a ``torch.distributed``
group (port of parallel/multihost.py).

- :func:`initialize` — ``torch.distributed.init_process_group`` from
  explicit arguments or the ``GRAFT_*`` environment, with the backend the
  caller names (``"gloo"`` or ``"nccl"``; nothing picks one for it). A
  process with no coordinator anywhere is a single process and is left
  alone;
- :func:`init_state_local` — only this rank's contiguous ``[N/P, ...]``
  block of every peer-major plane (the message tables and scalars whole),
  built from the host-side topology without the whole state existing
  anywhere;
- :func:`global_state` — a rank's host-local block on its device, the
  state the sharded plans take (parallel/sharding.py);
- :func:`gather_state` / :func:`local_rows_state` — the rank-0 write
  discipline: ``gather_state`` (a collective: every rank calls it) gives
  the whole state as host tensors, so that rank 0 alone writes
  checkpoints and journals; ``local_rows_state`` slices a whole state back
  to this rank's rows on resume, at any process count that divides N.

The bucketed counterparts (:func:`init_bucketed_local`,
:func:`global_bucketed_state`, :func:`local_bucketed_rows_state`) hold
each rank's window of every bucket and ``g``'s rows at those ids
(parallel/sharding.py's bucket-major layout).

``python -m go_libp2p_pubsub_tpu_torch.run_multihost`` glues these into
one supervised sharded run per process.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..sim.config import SimConfig
from ..sim.state import SimState, state_spec
from ..sim.topology import Topology

# the environment the launchers and initialize() share
ENV_COORDINATOR = "GRAFT_COORDINATOR"      # host:port of rank 0, or an
                                           # init method URL (file://...)
ENV_NUM_PROCESSES = "GRAFT_NUM_PROCESSES"
ENV_PROCESS_ID = "GRAFT_PROCESS_ID"
ENV_BACKEND = "GRAFT_BACKEND"              # "gloo" or "nccl"

BACKENDS = ("gloo", "nccl")


def init_method_url(coordinator: str) -> str:
    """``tcp://host:port`` for a bare ``host:port``; a URL as it is."""
    return coordinator if "://" in coordinator else f"tcp://{coordinator}"


def initialize(coordinator: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               backend: str | None = None) -> None:
    """Join the process group from the arguments or the ``GRAFT_*``
    environment. No coordinator anywhere: a single process, left alone.
    Calling twice is a no-op. ``backend`` (or ``$GRAFT_BACKEND``) must be
    ``"gloo"`` or ``"nccl"``: there is no default and no fallback."""
    import torch.distributed as dist

    coordinator = coordinator or os.environ.get(ENV_COORDINATOR)
    if coordinator is None:
        return
    if dist.is_initialized():
        return
    backend = backend or os.environ.get(ENV_BACKEND)
    if backend not in BACKENDS:
        raise ValueError(f"initialize: backend {backend!r}; name one of "
                         f"{BACKENDS} (argument or ${ENV_BACKEND})")
    if num_processes is None:
        num_processes = int(os.environ[ENV_NUM_PROCESSES])
    if process_id is None:
        process_id = int(os.environ[ENV_PROCESS_ID])
    dist.init_process_group(backend, init_method=init_method_url(coordinator),
                            world_size=num_processes, rank=process_id)


def process_index() -> int:
    import torch.distributed as dist
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    import torch.distributed as dist
    return dist.get_world_size() if dist.is_initialized() else 1


def is_coordinator() -> bool:
    """True on the one process that writes checkpoints, journals, crash
    dumps and metric lines (rank 0)."""
    return process_index() == 0


def local_peer_rows(n_peers: int, num_processes: int,
                    process_id: int) -> tuple[int, int]:
    """(first row, row count) of this process's contiguous peer block."""
    if num_processes <= 0 or n_peers % num_processes:
        raise ValueError(
            f"local_peer_rows: n_peers={n_peers} must divide evenly over "
            f"{num_processes} processes (the peer sharding raises the same)")
    if not (0 <= process_id < num_processes):
        raise ValueError(
            f"local_peer_rows: process_id={process_id} outside "
            f"[0, {num_processes})")
    nl = n_peers // num_processes
    return process_id * nl, nl


def _rank_args(process_id, num_processes):
    if num_processes is None:
        num_processes = process_count()
    if process_id is None:
        process_id = process_index()
    return process_id, num_processes


def init_state_local(cfg: SimConfig, topo: Topology,
                     process_id: int | None = None,
                     num_processes: int | None = None,
                     subscribed: np.ndarray | None = None,
                     ip_group: np.ndarray | None = None,
                     app_score: np.ndarray | None = None,
                     malicious: np.ndarray | None = None,
                     topo_local: bool = False, device=None) -> SimState:
    """This rank's shard of the initial state on ``device``: peer-major
    planes cover rows ``[n0, n0 + nl)``, replicated planes are whole. The
    per-peer inputs are the GLOBAL host arrays; the receiver view
    ``nbr_subscribed`` is built from the whole subscription table (a row's
    neighbours can live on any rank). ``topo_local=True`` declares that
    ``topo`` holds only this rank's rows. Rank and size default to the
    live group's; a single process builds the whole state, equal to
    ``init_state``."""
    from ..device import resolve_device
    from ..sim.state import _init_rows, check_precision

    check_precision(cfg)
    process_id, num_processes = _rank_args(process_id, num_processes)
    n, t = cfg.n_peers, cfg.n_topics
    n0, nl = local_peer_rows(n, num_processes, process_id)
    want_rows = nl if topo_local else n
    if topo.neighbors.shape[0] != want_rows:
        raise ValueError(
            f"init_state_local: topo carries {topo.neighbors.shape[0]} "
            f"rows but topo_local={topo_local} expects {want_rows} "
            f"(n_peers={n}, {num_processes} processes)")
    trows = slice(0, nl) if topo_local else slice(n0, n0 + nl)
    rows = slice(n0, n0 + nl)
    if subscribed is None:
        subscribed = np.ones((n, t), dtype=bool)
    if ip_group is None:
        ip_group = np.zeros(n, np.int32)
    if app_score is None:
        app_score = np.zeros(n, np.float32)
    if malicious is None:
        malicious = np.zeros(n, bool)
    nbr_l = np.asarray(topo.neighbors[trows])
    nbr_sub_l = np.transpose(subscribed[np.clip(nbr_l, 0, n - 1)],
                             (0, 2, 1)) & (nbr_l >= 0)[:, None, :]
    return _init_rows(cfg, nbr_l, np.asarray(topo.outbound[trows]),
                      np.asarray(topo.reverse_slot[trows]),
                      subscribed[rows], ip_group[rows], app_score[rows],
                      malicious[rows], nbr_sub_l, resolve_device(device))


def global_state(local, mesh, cfg: SimConfig, device=None) -> SimState:
    """A rank's shard (a SimState or a field -> array dict, host or device)
    as the sharded plans take it: every field a contiguous tensor on
    ``device``, peer-major fields checked to be ``N / P`` rows."""
    from ..device import resolve_device
    from ..sim.state import field_from_reference

    dev = resolve_device(device)
    spec = state_spec(cfg)
    nl = cfg.n_peers // mesh.size
    out = {}
    for f in SimState._fields:
        v = local[f] if isinstance(local, dict) else getattr(local, f)
        t = v.to(dev).contiguous() if isinstance(v, torch.Tensor) \
            else field_from_reference(f, v, dev)
        if spec[f][2] and t.shape[0] != nl:
            raise ValueError(f"global_state: field {f} carries {t.shape[0]} "
                             f"rows, expected {nl} on a {mesh.size}-rank "
                             "mesh")
        out[f] = t
    return SimState(**out)


def gather_state(state, cfg: SimConfig, group=None):
    """The whole state, a SimState or a BucketedState, as host tensors
    (the supervisor's ``state_to_host``: what ``sim.checkpoint.save`` and
    the crash dump write; ``sim.state.state_to_numpy`` or
    ``sim.bucketed.bucketed_state_to_numpy`` make numpy of it). A
    COLLECTIVE inside a group of more than one process: every rank calls
    it, and all get the whole state; rank 0 alone should write it."""
    from ..sim.bucketed import BucketedState, EdgePlanes

    bucketed = isinstance(state, BucketedState)
    if process_count() > 1:
        from .sharding import gather_bucketed, gather_full
        state = gather_bucketed(state, cfg, group) if bucketed \
            else gather_full(state, cfg, group)
    if not bucketed:
        return SimState(*(x.cpu() for x in state))
    return BucketedState(g=SimState(*(x.cpu() for x in state.g)),
                         e=tuple(EdgePlanes(*(x.cpu() for x in ep))
                                 for ep in state.e),
                         rev=tuple(r.cpu() for r in state.rev))


def local_rows_state(full, cfg: SimConfig, process_id: int | None = None,
                     num_processes: int | None = None) -> dict:
    """A whole state (a SimState or a field -> array dict) sliced to this
    rank's rows as numpy arrays: the resume path, at any process count
    that divides N."""
    process_id, num_processes = _rank_args(process_id, num_processes)
    n0, nl = local_peer_rows(cfg.n_peers, num_processes, process_id)
    spec = state_spec(cfg)

    def arr(f):
        v = full[f] if isinstance(full, dict) else getattr(full, f)
        return v.cpu().numpy() if isinstance(v, torch.Tensor) \
            else np.asarray(v)
    return {f: arr(f)[n0:n0 + nl] if spec[f][2] else arr(f)
            for f in SimState._fields}


def init_bucketed_local(cfg: SimConfig, topo, process_id: int | None = None,
                        num_processes: int | None = None,
                        subscribed: np.ndarray | None = None,
                        ip_group: np.ndarray | None = None,
                        app_score: np.ndarray | None = None,
                        malicious: np.ndarray | None = None, device=None):
    """This rank's part of the initial degree-bucketed state, built one
    bucket window at a time (the transient peak is one window's dense
    slab, never the graph): for bucket b the rows ``[s_b + p c_b / P,
    s_b + (p + 1) c_b / P)``, their edge planes and ``rev``, and ``g``'s
    rows at those ids, bucket after bucket. ``topo`` is a whole host-side
    Topology or a callable ``topo(start, count)`` giving a row window
    (e.g. ``topology.powerlaw(..., rows=(start, count))``). The parts of
    every rank, laid out by ``parallel/kernel_context.bucket_rows``, make
    up ``init_bucketed_state``'s state."""
    from ..device import resolve_device
    from ..sim.bucketed import (BucketedState, bucketize_state,
                                check_bucketable, encode_bucketed)
    from ..sim.state import _init_rows, decode_state

    check_bucketable(cfg)
    process_id, num_processes = _rank_args(process_id, num_processes)
    dev = resolve_device(device)
    n, t = cfg.n_peers, cfg.n_topics
    if subscribed is None:
        subscribed = np.ones((n, t), dtype=bool)
    if ip_group is None:
        ip_group = np.zeros(n, np.int32)
    if app_score is None:
        app_score = np.zeros(n, np.float32)
    if malicious is None:
        malicious = np.zeros(n, bool)
    if isinstance(topo, Topology):
        whole = topo

        def topo_rows(start, count):
            sl = slice(start, start + count)
            return Topology(neighbors=whole.neighbors[sl],
                            outbound=whole.outbound[sl],
                            reverse_slot=whole.reverse_slot[sl],
                            degree=whole.degree[sl])
    else:
        topo_rows = topo
    spec = state_spec(cfg)
    gs, e, rev, start = [], [], [], 0
    for b, (c, kb) in enumerate(cfg.degree_buckets):
        c, kb = int(c), int(kb)
        if c % num_processes:
            raise ValueError(
                f"init_bucketed_local: bucket {b} ({c} rows x k_ceil {kb}) "
                f"does not split over {num_processes} processes — realign "
                "the partition with topology.align_degree_buckets")
        cb = c // num_processes
        g0 = start + process_id * cb
        tb = topo_rows(g0, cb)
        nbr = np.asarray(tb.neighbors)
        if nbr.shape[0] != cb:
            raise ValueError(f"init_bucketed_local: topo({g0}, {cb}) "
                             f"returned {nbr.shape[0]} rows")
        nbr_sub = np.transpose(subscribed[np.clip(nbr, 0, n - 1)],
                               (0, 2, 1)) & (nbr >= 0)[:, None, :]
        rows = slice(g0, g0 + cb)
        slab = _init_rows(cfg, nbr, np.asarray(tb.outbound),
                          np.asarray(tb.reverse_slot), subscribed[rows],
                          ip_group[rows], app_score[rows], malicious[rows],
                          nbr_sub, dev)
        part = bucketize_state(decode_state(slab, cfg), cfg, rows=(g0, cb))
        gs.append(part.g)
        e.append(part.e[b])
        rev.append(part.rev[b])
        start += c
    g = SimState(**{f: torch.cat([getattr(x, f) for x in gs])
                    if spec[f][2] else getattr(gs[0], f)
                    for f in SimState._fields})
    return encode_bucketed(BucketedState(g=g, e=tuple(e), rev=tuple(rev)),
                           cfg)


def global_bucketed_state(local, mesh, cfg: SimConfig, device=None):
    """A rank's bucketed part (tensors anywhere) on ``device``, checked
    against the layout: ``g``'s peer-major fields N/P rows, bucket b's
    planes c_b/P rows."""
    from ..device import resolve_device
    from ..sim.bucketed import BucketedState, EdgePlanes

    dev = resolve_device(device)
    g = global_state(local.g, mesh, cfg, dev)
    e, rev = [], []
    for b, (c, _kb) in enumerate(cfg.degree_buckets):
        cl = int(c) // mesh.size
        planes = [x.to(dev).contiguous() for x in local.e[b]]
        if any(x.shape[0] != cl for x in planes) or \
                local.rev[b].shape[0] != cl:
            raise ValueError(f"global_bucketed_state: bucket {b}'s planes "
                             f"are not {cl} rows")
        e.append(EdgePlanes(*planes))
        rev.append(local.rev[b].to(dev).contiguous())
    return BucketedState(g=g, e=tuple(e), rev=tuple(rev))


def local_bucketed_rows_state(full, cfg: SimConfig,
                              process_id: int | None = None,
                              num_processes: int | None = None):
    """A whole BucketedState sliced to this rank's part (the bucketed
    resume path, at any process count that every bucket's rows divide)."""
    from .sharding import PeerMesh, shard_bucketed_state

    process_id, num_processes = _rank_args(process_id, num_processes)
    return shard_bucketed_state(
        full, PeerMesh(None, num_processes, process_id,
                       {"peers": num_processes}), cfg)
