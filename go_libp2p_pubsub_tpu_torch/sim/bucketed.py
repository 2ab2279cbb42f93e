"""Degree-bucketed edge planes: per-tick cost O(ΣD), not O(N·D_max) (port
of sim/bucketed.py).

Heavy-tailed underlays (``topology.powerlaw``) give a few hub peers two
orders of magnitude more edges than the median peer. The dense engine
pads every peer's slot axis to ``k_slots = D_max``, so the resting bytes
of the K-axis planes and every per-edge op pay N·D_max. This layout keeps
the peers in O(log D_max) contiguous, id-ordered degree classes, hubs
first (``cfg.degree_buckets``, :func:`topology.powerlaw_buckets`), each
class's edge planes padded only to its own ceiling K_b:

- resting bytes of a K-axis plane: Σ_b N_b · bytes_row(K_b) ≈ ΣD;
- per-edge work: every op runs once per bucket at [N_b, ·, K_b].

The only cross-bucket traffic is the reverse-edge exchange: the buckets'
edge payloads concatenate into one flat ΣD-element space, and each bucket
gathers its reverse values through a precomputed flat index
(``BucketedState.rev``). No gather here is sized N·D_max.

:func:`bucketed_step` is a fork of ``engine.step``, op for op and key
split for key split, on the non-fused formulation (the fused kernels are
dense-only, :func:`check_bucketable`): per-bucket views run the dense
ops (publish, scoring, selection, gater admission, edge transitions, the
fault hashes), and the forks below run the heartbeat, the forwarding
pass, churn, the fault pass and the sentinel at bucket width. As in the
dense port, the reference's ``lax.cond`` gates run ungated (each gated
block equals its skipped form on the rows it leaves alone) and the hop
loop runs exactly ``prop_substeps`` hops, so a tick reads nothing on the
host. Under ``bucketed_rng="dense"`` each noise draw is made once at the
dense [N, ·, k_slots] shape of its call site and key, and each bucket
takes its slice, so the trajectory equals the dense engine's on the same
graph; ``"bucket"`` folds the bucket index into the key and draws at
bucket width (ΣD-cost draws, another trajectory).

The state's edge planes may be stored compact (:func:`encode_bucketed`:
the dense codecs per plane, packed at K_b width). The sharded half (the
row-sharded buckets and the halo exchange) is not ported (ROADMAP.md,
Queue 1 item 7).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import rng
from ..parallel import kernel_context as pg
from ..device import check_on, resolve_device
from ..ops.bits import I32
from .config import SimConfig, TopicParams
from .hostio import fetch_local
from .state import (_COMPACT_CODECS, _ENCODE, NEVER, U32_FIELDS, SimState,
                    check_precision, decode_plane, decode_state,
                    field_from_reference, init_state)

# SimState fields carrying the K (neighbor-slot) axis: stored per bucket
# at that bucket's ceiling K_b
EDGE_FIELDS = (
    "neighbors", "connected", "outbound", "reverse_slot",
    "nbr_subscribed", "disconnect_tick", "direct", "mesh", "fanout",
    "backoff", "graft_tick", "mesh_active",
    "first_message_deliveries", "mesh_message_deliveries",
    "mesh_failure_penalty", "invalid_message_deliveries",
    "behaviour_penalty",
    "gater_deliver", "gater_duplicate", "gater_ignore", "gater_reject",
)

# K-free peer-major planes a bucket view row-slices (and _merge
# concatenates back). ip_group, app_score and malicious stay global in a
# view: compute_scores and the forward pass index them by global id.
ROW_FIELDS = (
    "subscribed", "fanout_lastpub", "gater_validate", "gater_throttle",
    "gater_last_throttle", "have", "deliver_tick", "deliver_from",
    "iwant_pending",
)


class EdgePlanes(NamedTuple):
    """One degree class's K-axis planes at that class's width K_b."""

    neighbors: torch.Tensor            # [Nb, Kb] int32 global peer ids
    connected: torch.Tensor            # [Nb, Kb] bool
    outbound: torch.Tensor             # [Nb, Kb] bool
    reverse_slot: torch.Tensor         # [Nb, Kb] int32 slot in the neighbor
    nbr_subscribed: torch.Tensor       # [Nb, T, Kb] bool
    disconnect_tick: torch.Tensor      # [Nb, Kb] int32
    direct: torch.Tensor               # [Nb, Kb] bool
    mesh: torch.Tensor                 # [Nb, T, Kb] bool
    fanout: torch.Tensor               # [Nb, T, Kb] bool
    backoff: torch.Tensor              # [Nb, T, Kb] int32
    graft_tick: torch.Tensor           # [Nb, T, Kb] int32
    mesh_active: torch.Tensor          # [Nb, T, Kb] bool
    first_message_deliveries: torch.Tensor    # [Nb, T, Kb] f32
    mesh_message_deliveries: torch.Tensor     # [Nb, T, Kb] f32
    mesh_failure_penalty: torch.Tensor        # [Nb, T, Kb] f32
    invalid_message_deliveries: torch.Tensor  # [Nb, T, Kb] f32
    behaviour_penalty: torch.Tensor    # [Nb, Kb] f32
    gater_deliver: torch.Tensor        # [Nb, Kb] f32
    gater_duplicate: torch.Tensor      # [Nb, Kb] f32
    gater_ignore: torch.Tensor         # [Nb, Kb] f32
    gater_reject: torch.Tensor         # [Nb, Kb] f32


class BucketedState(NamedTuple):
    """The degree-bucketed twin of :class:`SimState`.

    ``g`` is a SimState whose EDGE_FIELDS are zero-width placeholders
    (``[N, ..., 0]``: the leading N axis intact, so every op that reads
    the peer count from ``neighbors.shape[0]`` still sees N); the edge
    planes live in ``e``, one :class:`EdgePlanes` per bucket. ``rev[b]``
    is the [Nb, Kb] int32 flat reverse-edge index into the concatenated
    ΣD edge space (invalid slots point at themselves), computed once in
    :func:`bucketize_state`."""

    g: SimState
    e: tuple            # tuple[EdgePlanes], hubs first
    rev: tuple          # tuple[torch.Tensor [Nb, Kb] int32]

    # the supervisor and checkpoint plumbing read ``.tick`` and
    # ``.fault_flags`` off whatever state an engine carries
    @property
    def tick(self):
        return self.g.tick

    @property
    def fault_flags(self):
        return self.g.fault_flags


def _buckets(cfg: SimConfig) -> list:
    """cfg.degree_buckets -> [(row_start, n_rows, k_ceil)], hubs first."""
    out, start = [], 0
    for n_rows, kb in cfg.degree_buckets:
        out.append((start, int(n_rows), int(kb)))
        start += int(n_rows)
    return out


def check_bucketable(cfg: SimConfig) -> None:
    """Refuse, by name, every config the bucketed fork does not carry
    (bucketed.py:143-200): the fork mirrors ``engine.step`` op for op, and
    a feature it does not mirror must fail here instead of diverging."""
    if cfg.degree_buckets is None:
        raise ValueError("bucketed execution needs cfg.degree_buckets "
                         "(see sim/topology.powerlaw_buckets)")
    bks = tuple((int(r), int(k)) for r, k in cfg.degree_buckets)
    if any(r <= 0 or k <= 0 for r, k in bks):
        raise ValueError(f"degree_buckets={bks}: every (n_rows, k_ceil) "
                         "entry must be positive")
    if sum(r for r, _ in bks) != cfg.n_peers:
        raise ValueError(
            f"degree_buckets rows sum to {sum(r for r, _ in bks)} but "
            f"n_peers={cfg.n_peers}; buckets must tile the id space")
    if any(bks[i][1] < bks[i + 1][1] for i in range(len(bks) - 1)):
        raise ValueError(f"degree_buckets={bks}: k_ceil must be "
                         "non-increasing (hubs first)")
    if bks[0][1] != cfg.k_slots:
        raise ValueError(
            f"degree_buckets[0] k_ceil={bks[0][1]} != k_slots="
            f"{cfg.k_slots}: the widest bucket defines the dense width")
    if cfg.bucketed_rng not in ("dense", "bucket"):
        raise ValueError(f"bucketed_rng={cfg.bucketed_rng!r}: expected "
                         "'dense' (bit-exact vs the dense engine) or "
                         "'bucket' (ΣD-cost draws)")
    if cfg.router != "gossipsub":
        raise ValueError(f"router={cfg.router!r}: the bucketed fork "
                         "mirrors only the gossipsub step")
    if cfg.flood_publish:
        raise ValueError("flood_publish is not bucketed")
    if cfg.record_provenance:
        raise ValueError("record_provenance (deliver_from attribution) "
                         "is not bucketed")
    if cfg.validation_queue_cap > 0:
        raise ValueError("validation_queue_cap > 0 (throttle charging) "
                         "is not bucketed")
    if cfg.edge_queue_cap > 0:
        raise ValueError("edge_queue_cap > 0 is not bucketed")
    if cfg.sub_leave_prob > 0.0 or cfg.sub_join_prob > 0.0:
        raise ValueError("subscription churn (sub_leave_prob/"
                         "sub_join_prob) is not bucketed")
    if cfg.max_iwant_per_tick < cfg.msg_window:
        raise ValueError(
            f"max_iwant_per_tick={cfg.max_iwant_per_tick} < msg_window="
            f"{cfg.msg_window}: the budgeted-IWANT scan is not bucketed")
    if cfg.hop_mode in ("pallas", "pallas-mxu"):
        raise ValueError(f"hop_mode={cfg.hop_mode!r}: the fused VMEM hop "
                         "kernels are dense-only")
    if 2 * cfg.n_topics > 32:
        raise ValueError(
            f"n_topics={cfg.n_topics}: the bucketed reverse-edge "
            "exchange packs 2*n_topics mask bits into one u32 payload; "
            "2*n_topics > 32 is refused")


def _check_sharded(cfg: SimConfig) -> None:
    """The kernel-mesh check (bucketed.py:1391-1403): inside a
    torch.distributed group of more than one process the step runs only
    on its rank's rows, under the peer group's bucket-major layout
    (parallel/sharding.make_sharded_bucketed_run enters it); there every
    bucket's rows must tile the group."""
    ctx = pg.current_kernel_mesh()
    dist = torch.distributed
    if ctx is None:
        if dist.is_available() and dist.is_initialized() \
                and dist.get_world_size() > 1:
            raise ValueError(
                f"bucketed_step inside a {dist.get_world_size()}-process "
                "torch.distributed group but outside its peer group: drive "
                "the sharded step through parallel/sharding."
                "make_sharded_bucketed_run")
        return
    for b, (n_rows, kb) in enumerate(cfg.degree_buckets):
        if int(n_rows) % ctx.world:
            raise ValueError(
                f"bucketed_step under the sharded kernel mesh: bucket {b} "
                f"({int(n_rows)} rows x k_ceil {int(kb)}) does not tile the "
                f"{ctx.world}-device mesh — realign the partition with "
                "topology.align_degree_buckets and drive the step through "
                "parallel/sharding.make_sharded_bucketed_run")
    if ctx.ids is None:
        raise ValueError("bucketed_step under a peer group without the "
                         "bucket-major layout (kernel_mesh(..., buckets=))")


def _local_buckets(cfg: SimConfig) -> list:
    """(first row in ``g``, rows, k_ceil) of each bucket's rows this process
    holds: :func:`_buckets` in one process; under a peer group's
    bucket-major layout the rank's window of each bucket, whose rows
    follow each other in ``g`` bucket after bucket."""
    ctx = pg.current_kernel_mesh()
    if ctx is None:
        return _buckets(cfg)
    out, sl = [], 0
    for _s, c, kb in _buckets(cfg):
        out.append((sl, c // ctx.world, kb))
        sl += c // ctx.world
    return out


def _global_starts(cfg: SimConfig) -> list:
    """The global id of each local bucket window's first row."""
    ctx = pg.current_kernel_mesh()
    return [s + (0 if ctx is None else ctx.rank * (c // ctx.world))
            for s, c, _ in _buckets(cfg)]


# ---------------------------------------------------------------------------
# bucketize / densify


def _rev_tables(cfg: SimConfig):
    bks = _buckets(cfg)
    starts = np.array([s for s, _, _ in bks], np.int64)
    kbs = np.array([kb for _, _, kb in bks], np.int64)
    bases = np.cumsum([0] + [c * kb for _, c, kb in bks])[:-1].astype(
        np.int64)
    return bks, starts, kbs, bases


def _flat_rev(cfg: SimConfig, e: tuple, row_offsets=None) -> tuple:
    """Per-bucket [Nb, Kb] int32 flat reverse-edge index into the ΣD space
    (bucketed.py:213-246): for a valid edge (row i of bucket b, slot s)
    whose neighbor j lies in bucket c, ``bases[c] + (j - starts[c]) * K_c +
    reverse_slot``. Invalid slots index themselves, so an exchange returns
    the slot's own payload there (callers mask with the valid-slot
    predicate). ``row_offsets[b]`` declares that ``e[b]`` carries a row
    window of bucket b starting that many rows in; the self indices stay
    global flat positions."""
    bks, starts, kbs, bases = _rev_tables(cfg)
    n = cfg.n_peers
    dev = e[0].neighbors.device
    t_starts = torch.from_numpy(starts).to(dev)
    t_kbs = torch.from_numpy(kbs).to(dev)
    t_bases = torch.from_numpy(bases).to(dev)
    out = []
    for b, (s, c, kb) in enumerate(bks):
        nbr = e[b].neighbors
        rsl = e[b].reverse_slot
        off = 0 if row_offsets is None else int(row_offsets[b])
        rows = nbr.shape[0]
        valid = (nbr >= 0) & (rsl >= 0)
        nc = nbr.clamp(0, n - 1).long()
        cb = torch.searchsorted(t_starts, nc, right=True) - 1
        flat = t_bases[cb] + (nc - t_starts[cb]) * t_kbs[cb] \
            + rsl.clamp(min=0).long()
        own = int(bases[b]) \
            + (off + torch.arange(rows, device=dev))[:, None] * kb \
            + torch.arange(kb, device=dev)[None, :]
        out.append(torch.where(valid, flat, own).to(I32))
    return tuple(out)


def bucketize_state(state: SimState, cfg: SimConfig,
                    rows: tuple | None = None) -> BucketedState:
    """Split a decoded (compute-layout) dense SimState into bucket planes
    (bucketed.py:249-300). Slots at or beyond a bucket's ceiling are
    dropped; they must be empty, and a live edge there is refused.

    ``rows=(start, count)`` declares that ``state``'s peer-major planes
    carry only that contiguous row window of the id space (a shard
    build): each bucket's planes cover the window's intersection with the
    bucket (possibly 0 rows) and the flat reverse indices stay global, so
    the shards' buckets concatenate row-wise into the full build's."""
    check_bucketable(cfg)
    bks = _buckets(cfg)
    r0 = 0 if rows is None else int(rows[0])
    rc = cfg.n_peers if rows is None else int(rows[1])
    if rows is not None and int(state.neighbors.shape[0]) != rc:
        raise ValueError(
            f"bucketize_state: rows={tuple(rows)} declared but the state "
            f"carries {int(state.neighbors.shape[0])} peer rows")
    e, offs = [], []
    for s, c, kb in bks:
        lo, hi = max(s, r0), min(s + c, r0 + rc)
        cnt = max(0, hi - lo)
        lo = lo if cnt else s                 # empty window: offset 0
        sl = slice(lo - r0, lo - r0 + cnt)
        if cnt:
            tail = state.neighbors[sl, kb:]
            if tail.numel() and not bool((tail < 0).all()):
                raise ValueError(
                    f"bucketize_state: bucket rows [{lo}, {lo + cnt}) carry "
                    f"live edges beyond their k_ceil={kb} — the "
                    "degree_buckets partition does not cover this graph")
        # copies: a bucket's planes keep no storage of the dense state
        e.append(EdgePlanes(**{
            f: getattr(state, f)[sl][..., :kb].clone(
                memory_format=torch.contiguous_format)
            for f in EDGE_FIELDS}))
        offs.append(lo - s)
    e = tuple(e)
    g = state._replace(**{
        f: torch.empty(tuple(getattr(state, f).shape[:-1]) + (0,),
                       dtype=getattr(state, f).dtype,
                       device=getattr(state, f).device)
        for f in EDGE_FIELDS})
    return BucketedState(g=g, e=e, rev=_flat_rev(
        cfg, e, row_offsets=None if rows is None else offs))


# the dense engine's resting values at never-used slots
_PAD_FILLS = dict(
    neighbors=-1, reverse_slot=-1,
    disconnect_tick=NEVER, graft_tick=NEVER, backoff=0,
)


def densify_state(bs: BucketedState, cfg: SimConfig) -> SimState:
    """Pad every bucket back to k_slots and concatenate: the dense
    compute-layout SimState (bucketed.py:308-326), the inverse of
    :func:`bucketize_state`."""
    k = cfg.k_slots
    cols = {f: [] for f in EDGE_FIELDS}
    for ep in bs.e:
        for f in EDGE_FIELDS:
            v = getattr(ep, f)
            pad = k - v.shape[-1]
            if pad:
                fill = _PAD_FILLS.get(f, False if v.dtype == torch.bool
                                      else 0)
                v = torch.cat([v, torch.full(
                    tuple(v.shape[:-1]) + (pad,), fill, dtype=v.dtype,
                    device=v.device)], dim=-1)
            cols[f].append(v)
    return bs.g._replace(
        **{f: torch.cat(vs, dim=0) for f, vs in cols.items()})


# ---------------------------------------------------------------------------
# storage codecs (the bucketed twin of state.encode_state/decode_state)


def _is_encoded(bs: BucketedState) -> bool:
    """The reference's discriminator: ``deliver_from`` is int8 only in the
    stored compact layout."""
    return bs.g.deliver_from.dtype == torch.int8


def encode_bucketed(bs: BucketedState, cfg: SimConfig) -> BucketedState:
    """The stored layout of a bucketed state (bucketed.py:362-382): the
    dense codec table applied per plane, bucket planes packed at K_b
    width, so the stored bytes scale with ΣD. The zero-width edge
    placeholders on ``g`` stay compute-typed in both layouts. Identity
    under ``"f32"``."""
    if cfg.state_precision == "f32":
        return bs
    check_precision(cfg)
    if _is_encoded(bs):
        raise TypeError("encode_bucketed: state is already in the compact "
                        "storage layout")
    tick = bs.g.tick
    gout = {f: _ENCODE[codec](getattr(bs.g, f), tick)
            for f, codec in _COMPACT_CODECS.items()
            if codec is not None and f not in EDGE_FIELDS}
    e = tuple(ep._replace(**{
        f: _ENCODE[_COMPACT_CODECS[f]](getattr(ep, f), tick)
        for f in EDGE_FIELDS if _COMPACT_CODECS[f] is not None})
        for ep in bs.e)
    return BucketedState(g=bs.g._replace(**gout), e=e, rev=bs.rev)


def decode_bucketed(bs: BucketedState, cfg: SimConfig) -> BucketedState:
    """Inverse of :func:`encode_bucketed` (bucketed.py:385-407)."""
    if cfg.state_precision == "f32":
        return bs
    check_precision(cfg)
    if not _is_encoded(bs):
        raise TypeError(
            "decode_bucketed: state is already in the compute layout")
    tick = bs.g.tick
    gout = {f: decode_plane(codec, getattr(bs.g, f), tick, cfg.k_slots)
            for f, codec in _COMPACT_CODECS.items()
            if codec is not None and f not in EDGE_FIELDS}
    e = tuple(ep._replace(**{
        f: decode_plane(_COMPACT_CODECS[f], getattr(ep, f), tick, kb)
        for f in EDGE_FIELDS if _COMPACT_CODECS[f] is not None})
        for ep, (_, _, kb) in zip(bs.e, _buckets(cfg)))
    return BucketedState(g=bs.g._replace(**gout), e=e, rev=bs.rev)


# ---------------------------------------------------------------------------
# the reference's checkpoint layout (its checkpoint._named_leaves)


def _leaf_dtype(field: str, v: torch.Tensor, encoded: bool) -> np.dtype:
    """The numpy dtype the reference stores a leaf in: uint32 for the
    port's int32 words, uint16 for its int16 bf16 patterns."""
    codec = _COMPACT_CODECS[field] if encoded else None
    if field in U32_FIELDS or codec == "packK":
        return np.dtype(np.uint32)
    if codec == "bf16":
        return np.dtype(np.uint16)
    return torch.empty(0, dtype=v.dtype).numpy().dtype


def named_leaves(bs: BucketedState) -> list:
    """``[(name, tensor, reference dtype), ...]``: ``g.<field>``, then per
    bucket ``e<b>.<field>``, then ``rev<b>``, in the reference's order
    (its checkpoint._named_leaves, checkpoint.py:91-111)."""
    enc = _is_encoded(bs)
    out = [(f"g.{f}", v, _leaf_dtype(f, v, enc and f not in EDGE_FIELDS))
           for f, v in zip(SimState._fields, bs.g)]
    for b, ep in enumerate(bs.e):
        out.extend((f"e{b}.{f}", v, _leaf_dtype(f, v, enc))
                   for f, v in zip(EdgePlanes._fields, ep))
    out.extend((f"rev{b}", r, np.dtype(np.int32))
               for b, r in enumerate(bs.rev))
    return out


def bucketed_state_to_numpy(bs: BucketedState) -> dict:
    """Leaf name -> numpy array in the reference's dtypes, either layout:
    the arrays the reference's ``.npz`` checkpoint of the same state
    holds."""
    return {name: fetch_local(v, dt) for name, v, dt in named_leaves(bs)}


def bucketed_state_from_reference(arrays: dict, cfg: SimConfig,
                                  device=None) -> BucketedState:
    """The reference's ``BucketedState`` (numpy arrays keyed as its
    checkpoint names them: ``g.<field>``, ``e<b>.<field>``, ``rev<b>``), in
    either storage layout, as the port's state on ``device``."""
    dev = resolve_device(device)
    g = SimState(**{f: field_from_reference(f, arrays[f"g.{f}"], dev)
                    for f in SimState._fields})
    e = tuple(EdgePlanes(**{
        f: field_from_reference(f, arrays[f"e{b}.{f}"], dev)
        for f in EdgePlanes._fields})
        for b in range(len(cfg.degree_buckets)))
    rev = tuple(field_from_reference("rev", arrays[f"rev{b}"], dev)
                for b in range(len(cfg.degree_buckets)))
    return BucketedState(g=g, e=e, rev=rev)


# ---------------------------------------------------------------------------
# bucket views: the per-bucket SimState the dense ops run on


def _view(bs: BucketedState, b: int, cfg: SimConfig) -> SimState:
    """Bucket ``b`` as a SimState (bucketed.py:414-424): its edge planes at
    [Nb, ·, Kb], the ROW_FIELDS sliced to its rows, everything else
    global."""
    s, c, _ = _local_buckets(cfg)[b]
    out = {f: getattr(bs.e[b], f) for f in EDGE_FIELDS}
    for f in ROW_FIELDS:
        out[f] = getattr(bs.g, f)[s:s + c]
    return bs.g._replace(**out)


def _rows_of(part: torch.Tensor, base: torch.Tensor, start: int) -> bool:
    """Whether ``part`` is still the very row slice ``base[start:...]`` a
    view took (no op replaced it)."""
    return (part.shape[1:] == base.shape[1:]
            and part.stride() == base.stride()
            and part.data_ptr() == base[start:].data_ptr())


def _merge(bs: BucketedState, views: list) -> BucketedState:
    """Put per-bucket views back (bucketed.py:427-436): edge planes to
    ``e``, ROW_FIELDS rows in bucket (= id) order, every other plane from
    ``bs.g`` (no view writes one). A row plane that every view left as
    its slice of ``bs.g`` stays ``bs.g``'s, uncopied."""
    e = tuple(EdgePlanes(**{f: getattr(v, f) for f in EDGE_FIELDS})
              for v in views)
    starts = np.cumsum([0] + [v.neighbors.shape[0] for v in views])
    rows = {}
    for f in ROW_FIELDS:
        base = getattr(bs.g, f)
        parts = [getattr(v, f) for v in views]
        if not all(_rows_of(p, base, int(s)) for p, s in zip(parts, starts)):
            rows[f] = torch.cat(parts, dim=0)
    return BucketedState(g=bs.g._replace(**rows), e=e, rev=bs.rev)


# ---------------------------------------------------------------------------
# the cross-bucket primitive: the flat reverse-edge exchange


def _exchange_flat(bs: BucketedState, payloads: list) -> list:
    """``payloads[b]`` is [Nb, Kb]; returns each edge's reverse edge's
    payload, per bucket (bucketed.py:443-462): one ΣD-element concatenation
    and per-bucket [Nb, Kb] gathers (int32 indices, no widening). Inside a
    peer group each bucket's rows are gathered whole first (the replicated
    route), or the exchange rides ``halo.route_bucketed_flat`` (the halo
    route: each rank pushes its slots to the owners of their reverse
    slots, capacity-padded all-to-alls of ~ΣD/P² a rank pair)."""
    ctx = pg.current_kernel_mesh()
    if ctx is not None and ctx.route == "halo":
        from ..parallel.halo import route_bucketed_flat
        return route_bucketed_flat(payloads, list(bs.rev))
    flat = torch.cat([pg.gather_rows(p).reshape(-1) for p in payloads])
    return [torch.index_select(flat, 0, r.reshape(-1)).reshape(r.shape)
            for r in bs.rev]


def _exchange_masks(bs: BucketedState, planes_per_bucket: list) -> list:
    """Exchange a list of bool mask planes (each [Nb, Kb] or [Nb, T, Kb])
    across the reverse edges (bucketed.py:471-506): up to 32 planes packed
    into one int32 word by OR (bit 31 included), gathered by
    :func:`_exchange_flat`, unpacked by shift and ``& 1`` and ANDed with
    the valid-slot predicate. Returns, per bucket, the gathered planes in
    the same shapes."""
    from ..ops.heartbeat import _plane_payloads
    stacked = [torch.cat([p if p.dim() == 3 else p[:, None, :]
                          for p in planes], dim=1)
               for planes in planes_per_bucket]
    nb = stacked[0].shape[1]
    if nb > 32:
        raise ValueError(f"_exchange_masks: {nb} bit planes exceed one "
                         "u32 payload")
    got = _exchange_flat(bs, [_plane_payloads(p)[0] for p in stacked])
    sh = torch.arange(nb, dtype=I32, device=got[0].device)[None, :, None]
    out = []
    for b, gword in enumerate(got):
        ep = bs.e[b]
        valid = (ep.neighbors >= 0) & (ep.reverse_slot >= 0)
        bits = ((gword[:, None, :] >> sh) & 1).bool() & valid[:, None, :]
        res, i = [], 0
        for p in planes_per_bucket[b]:
            if p.dim() == 2:
                res.append(bits[:, i, :])
                i += 1
            else:
                res.append(bits[:, i:i + p.shape[1], :])
                i += p.shape[1]
        out.append(res)
    return out


def _gw_b(table: torch.Tensor, idx_kn: torch.Tensor) -> torch.Tensor:
    """[W, N] global packed word table gathered along a bucket's
    neighbors -> [W, Kb, Nb] (bucketed.py:509-519). ``idx_kn`` is the
    bucket's [Kb, Nb] int32 neighbor ids clipped to [0, N-1], as the dense
    forward pass clips before its gather (invalid slots read row 0; every
    consumer masks them)."""
    kb, nb = idx_kn.shape
    return torch.index_select(table, 1, idx_kn.reshape(-1)).reshape(
        table.shape[0], kb, nb)



# ---------------------------------------------------------------------------
# the draws


def _mk_noise(cfg: SimConfig):
    """``noise(key, kind)`` -> the per-bucket uniform noise one selection,
    admission, churn or link-fault call site consumes; kind ``"ntk"``
    ([·, T, Kb]) or ``"nk"`` ([·, Kb]) (bucketed.py:523-550).

    ``"dense"``: one draw at the full dense shape from the call site's key,
    each bucket its row and slot slice, so every bucket consumes the dense
    stream (the reference draws per bucket and XLA merges the duplicate
    draws; eager PyTorch draws once here). ``"bucket"``: the bucket index
    folded into the key, a draw at bucket width (O(ΣD) RNG)."""
    bks = _buckets(cfg)
    n, t, kmax = cfg.n_peers, cfg.n_topics, cfg.k_slots

    def shape(rows, k, kind):
        return (rows, t, k) if kind == "ntk" else (rows, k)

    if pg.current_kernel_mesh() is not None:
        # a rank draws only its windows' rows of each draw
        loc, gs = _local_buckets(cfg), _global_starts(cfg)
        if cfg.bucketed_rng == "dense":
            def noise(key, kind):
                return [rng.uniform(key, shape(c, kmax, kind),
                                    row0=g0)[..., :kb]
                        for (_, c, kb), g0 in zip(loc, gs)]
        else:
            def noise(key, kind):
                return [rng.uniform(rng.fold_in(key, b), shape(c, kb, kind),
                                    row0=g0 - s)
                        for b, ((_, c, kb), g0, (s, _, _)) in
                        enumerate(zip(loc, gs, bks))]
    elif cfg.bucketed_rng == "dense":
        def noise(key, kind):
            full = rng.uniform(key, shape(n, kmax, kind))
            return [full[s:s + c, ..., :kb] for s, c, kb in bks]
    else:
        def noise(key, kind):
            return [rng.uniform(rng.fold_in(key, b), shape(c, kb, kind))
                    for b, (s, c, kb) in enumerate(bks)]
    return noise


# ---------------------------------------------------------------------------
# heartbeat fork (ops/heartbeat.heartbeat at bucket width)


def _heartbeat_b(bs: BucketedState, cfg: SimConfig, tp: TopicParams,
                 key: torch.Tensor, noise):
    """Per-bucket mirror of ops/heartbeat.heartbeat (bucketed.py:557-822):
    every local decision runs once per bucket at [Nb, T, Kb], the three
    cross-peer exchanges ride the flat reverse-edge index. The reference
    gates its blocks with ``lax.cond`` on predicates over all buckets;
    here, as in the dense port, every block runs ungated and a row a
    block leaves alone keeps the block's else value. Returns (merged
    state, scores, scores_all, inc_gossip, fwd_send), the last four
    per-bucket lists."""
    from ..ops.bits import prefix_count
    from ..ops.score_ops import (advance_active_latch, apply_prune_penalty,
                                 compute_scores, decayed)
    from ..ops.selection import masked_median, select_random, select_top

    bks = _local_buckets(cfg)
    B = len(bks)
    t = cfg.n_topics
    tick = bs.g.tick
    ks = rng.split(key, 8)
    sel = cfg.selection_mode

    views = [advance_active_latch(_view(bs, b, cfg), tp) for b in range(B)]
    scores_all = [compute_scores(v, cfg, tp, mask_disconnected=False,
                                 apply_decay=True) for v in views]
    zero = torch.zeros((), dtype=torch.float32, device=tick.device)
    scores = [torch.where(v.connected, sa, zero)
              for v, sa in zip(views, scores_all)]

    # the local maintenance of each bucket, steps 1-5
    loc = []
    for v, sc in zip(views, scores):
        c, kb = sc.shape
        s = sc[:, None, :]
        d = dict(s=s, sb=s.expand(c, t, kb), joined=v.subscribed[:, :, None],
                 conn=v.connected[:, None, :], out3=v.outbound[:, None, :],
                 direct3=v.direct[:, None, :])
        d["nbr_sub"] = v.nbr_subscribed & d["conn"]
        backoff_ok = tick >= v.backoff
        d["backoff_active"] = ~backoff_ok
        mesh = v.mesh & d["joined"]
        cand = d["conn"] & d["nbr_sub"] & ~mesh & backoff_ok & (s >= 0) \
            & ~d["direct3"] & d["joined"]
        d["prune_neg"] = mesh & (s < 0)
        d["mesh1"] = mesh & ~d["prune_neg"]
        d["candidate"] = cand & ~d["prune_neg"]
        n_mesh = d["mesh1"].sum(-1)
        d["need"] = torch.where(n_mesh < cfg.dlo, cfg.d - n_mesh, 0)
        loc.append(d)

    # 2. undersubscribed graft
    nz = noise(ks[0], "ntk")
    for b, d in enumerate(loc):
        d["graft1"] = select_random(d["candidate"], d["need"], None,
                                    max_count=cfg.d, mode=sel, noise=nz[b])
        d["mesh2"] = d["mesh1"] | d["graft1"]

    # 3. oversubscribed trim: top-Dscore by score, random rest to D, then
    # up to Dout outbound among the kept; rows not over keep mesh2
    nz1, nz2, nz3 = (noise(ks[i], "ntk") for i in (1, 2, 3))
    for b, d in enumerate(loc):
        mesh2, out3 = d["mesh2"], d["out3"]
        over = (mesh2.sum(-1) > cfg.dhi)[..., None]
        protected = select_top(d["sb"], mesh2, cfg.dscore,
                               max_count=cfg.dscore, mode=sel)
        rest = mesh2 & ~protected
        keep_rand = select_random(rest, cfg.d - cfg.dscore, None,
                                  max_count=cfg.d - cfg.dscore, mode=sel,
                                  noise=nz1[b])
        kept = protected | keep_rand
        n_out_kept = (kept & out3).sum(-1)
        deficit_out = torch.clamp(cfg.dout - n_out_kept, min=0)
        add_out = select_random(mesh2 & ~kept & out3, deficit_out, None,
                                max_count=cfg.dout, mode=sel, noise=nz2[b])
        remove_nonout = select_random(keep_rand & ~out3, add_out.sum(-1),
                                      None, max_count=cfg.dout, mode=sel,
                                      noise=nz3[b])
        kept = (kept | add_out) & ~remove_nonout
        d["over"] = over
        d["mesh3"] = torch.where(over, kept, mesh2)
        d["prune_over"] = mesh2 & ~d["mesh3"]
    del nz1, nz2, nz3

    # 4. outbound quota top-up
    nz = noise(ks[4], "ntk")
    for b, d in enumerate(loc):
        mesh3, out3 = d["mesh3"], d["out3"]
        n3 = mesh3.sum(-1)
        n_out = (mesh3 & out3).sum(-1)
        need_out = torch.where(
            (n3 >= cfg.dlo) & ~d["over"][..., 0] & (n_out < cfg.dout),
            cfg.dout - n_out, 0)
        d["graft_out"] = select_random(d["candidate"] & out3 & ~mesh3,
                                       need_out, None, max_count=cfg.dout,
                                       mode=sel, noise=nz[b])
        d["mesh4"] = mesh3 | d["graft_out"]

    # 5. opportunistic grafting on the graft tick (every row's count is 0
    # off it)
    og_tick = (tick % cfg.opportunistic_graft_ticks) == 0
    nz = noise(ks[5], "ntk")
    for b, d in enumerate(loc):
        mesh4, sb = d["mesh4"], d["sb"]
        med = masked_median(sb, mesh4)
        og_cond = (mesh4.sum(-1) > 1) \
            & (med < cfg.opportunistic_graft_threshold) & og_tick
        og_need = torch.where(og_cond, cfg.opportunistic_graft_peers, 0)
        og = select_random(d["candidate"] & (sb > med[..., None]) & ~mesh4,
                           og_need, None,
                           max_count=cfg.opportunistic_graft_peers,
                           mode=sel, noise=nz[b])
        d["mesh5"] = mesh4 | og
        d["grafts"] = d["graft1"] | d["graft_out"] | og
        d["prunes"] = d["prune_neg"] | d["prune_over"]

    # --- exchange 1: GRAFT/PRUNE receiver views ---
    ex1 = _exchange_masks(bs, [[d["grafts"], d["prunes"]] for d in loc])

    for b, d in enumerate(loc):
        ig, ip = ex1[b]
        d["inc_prune"] = ip
        mesh5, out3 = d["mesh5"], d["out3"]
        already = ig & mesh5
        hard_refuse = ig & ~already & (~d["joined"] | d["backoff_active"]
                                       | (d["s"] < 0) | d["direct3"])
        cand_graft = ig & ~already & ~hard_refuse
        n_mine = mesh5.sum(-1, keepdim=True)
        acc_out = cand_graft & out3
        nonout = cand_graft & ~out3
        c_out_excl = prefix_count(acc_out, exclusive=True)
        rank = prefix_count(nonout)                         # 1-based
        d["accept"] = already | acc_out | \
            (nonout & (n_mine + c_out_excl + rank <= cfg.dhi))
        d["refuse"] = ig & ~d["accept"]
        v = views[b]
        prune_tick = v.backoff - cfg.prune_backoff_ticks
        flood = d["backoff_active"] & (tick < prune_tick
                                       + cfg.graft_flood_ticks)
        bp_add = (ig & d["backoff_active"]).sum(1).float() \
            + (ig & flood).sum(1).float()
        d["bp_new"] = decayed(v.behaviour_penalty,
                              cfg.behaviour_penalty_decay,
                              cfg.decay_to_zero) + bp_add

    # --- exchange 2: refusal PRUNEs back to the grafting side ---
    ex2 = _exchange_masks(bs, [[d["refuse"]] for d in loc])

    sts = []
    nz = noise(ks[7], "ntk")
    for b, d in enumerate(loc):
        v = views[b]
        refused_back, = ex2[b]
        joined, conn, nbr_sub = d["joined"], d["conn"], d["nbr_sub"]
        s, direct3 = d["s"], d["direct3"]
        nm = ((d["mesh5"] | d["accept"]) & ~d["inc_prune"]
              & ~refused_back) & joined
        pruned_any = d["prunes"] | d["inc_prune"] | refused_back \
            | (d["refuse"] & joined)
        new_backoff = torch.where(pruned_any,
                                  tick + cfg.prune_backoff_ticks, v.backoff)
        newly = nm & ~v.mesh
        removed = v.mesh & ~nm
        # fanout maintenance: rows with no live fanout keep and add nothing
        fanout_alive = (v.fanout_lastpub < NEVER) \
            & (tick <= v.fanout_lastpub + cfg.fanout_ttl_ticks) \
            & ~v.subscribed
        fa3 = fanout_alive[..., None]
        keep_f = v.fanout & conn & nbr_sub \
            & (s >= cfg.publish_threshold) & fa3
        need_f = torch.where(fanout_alive,
                             torch.clamp(cfg.d - keep_f.sum(-1), min=0), 0)
        add_f = select_random(
            conn & nbr_sub & ~keep_f & ~direct3
            & (s >= cfg.publish_threshold) & fa3,
            need_f, None, max_count=cfg.d, mode=sel, noise=nz[b])
        nf = keep_f | add_f
        fanout_lastpub = torch.where(
            fanout_alive, v.fanout_lastpub,
            torch.full_like(v.fanout_lastpub, NEVER))
        st = v._replace(mesh=nm, backoff=new_backoff,
                        behaviour_penalty=d["bp_new"], fanout=nf,
                        fanout_lastpub=fanout_lastpub)
        st = apply_prune_penalty(st, removed, tp,
                                 decay_to_zero=cfg.decay_to_zero,
                                 apply_decay=True)
        st = st._replace(
            graft_tick=torch.where(newly, tick, st.graft_tick),
            mesh_active=torch.where(newly, False, st.mesh_active))
        sts.append(st)
        d.update(new_mesh=nm, new_fanout=nf, fa3=fa3)

    # emitGossip peer selection: target max(Dlazy, floor(f32(factor) *
    # n_cand)) in float32; the static bound from the bucket's width
    factor = float(np.float32(cfg.gossip_factor))
    nz = noise(ks[6], "ntk")
    gossip_sel, send = [], []
    for b, d in enumerate(loc):
        kb = bks[b][2]
        gossip_cand = d["conn"] & d["nbr_sub"] & ~d["new_mesh"] \
            & ~d["new_fanout"] & ~d["direct3"] \
            & (d["s"] >= cfg.gossip_threshold) & (d["joined"] | d["fa3"])
        n_cand = gossip_cand.sum(-1)
        target = torch.clamp(torch.floor(n_cand.float() * factor).to(I32),
                             min=cfg.dlazy)
        gossip_bound = max(cfg.dlazy, int(np.floor(
            np.float32(cfg.gossip_factor) * np.float32(kb))))
        gossip_sel.append(select_random(gossip_cand, target, None,
                                        max_count=gossip_bound, mode=sel,
                                        noise=nz[b]))
        send.append(d["new_mesh"]
                    | (d["new_fanout"] & ~views[b].subscribed[:, :, None]))
    del nz, loc

    # --- exchange 3: emitGossip + eager-forward receiver views ---
    ex3 = _exchange_masks(bs, [[gossip_sel[b], send[b]] for b in range(B)])
    inc_gossip = [x[0] for x in ex3]
    fwd_send = [x[1] for x in ex3]
    return (_merge(bs, sts), scores, scores_all, inc_gossip, fwd_send)


# ---------------------------------------------------------------------------
# forward fork (ops/propagate.forward_tick's non-fused formulation)


def _forward_b(bs: BucketedState, cfg: SimConfig, tp: TopicParams,
               inc_gossip_l: list, scores_l: list, key: torch.Tensor,
               fwd_send_l: list, noise, link_ok_l=None, dup_edges_l=None,
               censor_bits=None) -> BucketedState:
    """Per-bucket mirror of ops/propagate.forward_tick on the non-fused
    formulation (bucketed.py:829-1133; the fused kernels, the queue caps,
    flood publish and provenance are refused by check_bucketable). The
    message-window tables stay global [W, N] words; the [W, K, N] edge
    event planes split per bucket, so each gather, expansion and count
    runs at [W, Kb, Nb] and a hop costs W·ΣD. Exactly ``prop_substeps``
    hops run (the reference's loop stops at an empty frontier, where a
    hop is a no-op), and hop 0's duplicate offers ride only a non-empty
    starting frontier, a device-side mask, as in the dense port."""
    from ..ops.bits import (exclusive_prefix_or, n_words, pack_bool,
                            pack_words, popcount, popcount_sum, reduce_or,
                            unpack_words)
    from ..ops.gater import accept_data
    from ..ops.propagate import (_COUNT_DTYPES, _bits_to_slot,
                                 _edge_topic_bits, _ones, _slot_bitplanes)
    from ..ops.score_ops import decayed

    g = bs.g
    n, t, m = cfg.n_peers, cfg.n_topics, cfg.msg_window
    w = n_words(m)
    bks = _local_buckets(cfg)
    B = len(bks)
    dev = g.tick.device
    tick = g.tick
    _, k_gate = rng.split(key, 2)   # gossipsub with fwd_send draws no k_fwd
    mal = g.malicious
    zero = torch.zeros((), dtype=I32, device=dev)
    views = [_view(bs, b, cfg) for b in range(B)]
    idx_kn = [ep.neighbors.clamp(0, n - 1).T.contiguous() for ep in bs.e]
    sls = [slice(s, s + c) for s, c, _ in bks]

    # --- per-tick packed masks (global: message-window sized) ---
    age_pub = tick - g.msg_publish_tick
    alive = (age_pub >= 0) & (age_pub < cfg.history_length)
    t_m = g.msg_topic.clamp(0, t - 1)
    live_topic = (g.msg_topic >= 0) & alive
    topic_bits = pack_bool((t_m[None, :] == torch.arange(t, device=dev)[
        :, None]) & live_topic[None, :])
    alive_bits = pack_bool(alive[None, :])[0]
    invalid_bits = pack_bool((g.msg_invalid & alive)[None, :])[0]
    ignored_bits = pack_bool((g.msg_ignored & alive)[None, :])[0]
    valid_msg_bits = alive_bits & ~invalid_bits & ~ignored_bits
    vm = torch.where(mal[None, :], alive_bits[:, None],
                     valid_msg_bits[:, None])                        # [W,N]
    inv_n = torch.where(mal[None, :], zero, invalid_bits[:, None])
    ign_n = torch.where(mal[None, :], zero, ignored_bits[:, None])

    have_bits = g.have.T.contiguous()                                # [W,N]
    dlv_bits = pack_words(g.deliver_tick < NEVER)
    dlv_start = dlv_bits
    n_have_start = popcount(have_bits).to(torch.int64).sum()

    gate_noise = noise(k_gate, "nk") if cfg.gater_enabled else None
    data_ok_l = []
    for b, (s, c, kb) in enumerate(bks):
        if cfg.scoring_enabled:
            d = scores_l[b] >= cfg.graylist_threshold
        else:
            d = torch.ones((c, kb), dtype=torch.bool, device=dev)
        if cfg.gater_enabled:
            d = d & (accept_data(views[b], cfg, None, noise=gate_noise[b])
                     | mal[s:s + c, None])
        if link_ok_l is not None:
            d = d & link_ok_l[b]
        data_ok_l.append(d)
    del gate_noise

    cdt = _COUNT_DTYPES.get(cfg.count_dtype)
    if cdt is None:
        raise ValueError(f"count_dtype={cfg.count_dtype!r}: only 'uint8' and "
                         "'int32' are supported")
    if m > torch.iinfo(cdt).max:
        raise ValueError(f"msg_window={m} > {torch.iinfo(cdt).max} would wrap "
                         f"the {cfg.count_dtype} hop-count accumulators; "
                         "shrink the window or widen count_dtype")

    def topic_counts(events):
        """[W, Kb, Nb] event words -> [T, Kb, Nb] per-topic counts."""
        return torch.stack([
            popcount_sum(events & topic_bits[ti][:, None, None], axis=0,
                         dtype=cdt) for ti in range(t)])

    # -- step 1: resolve last tick's IWANTs --
    answer_bits = torch.where(mal[None, :], zero, dlv_bits)
    if censor_bits is not None:
        answer_bits = answer_bits & ~censor_bits
    got_any_l, got_valid_any_l, nv, ni, ig = [], [], [], [], []
    # the sender tables of the gathers are read whole: inside a peer group
    # each is this rank's columns, replicated once
    answer_w = pg.replicate(answer_bits, dim=1)
    for b, (s, c, kb) in enumerate(bks):
        sl = sls[b]
        asked_k = _slot_bitplanes(views[b].iwant_pending, kb) \
            & alive_bits[:, None, None]
        answers_k = _gw_b(answer_w, idx_kn[b])                   # [W,Kb,Nb]
        hb_c = have_bits[:, sl]
        got_k = asked_k & answers_k & ~hb_c[:, None, :] \
            & _ones(data_ok_l[b].T)[None]
        if link_ok_l is None:
            broken_k = asked_k & ~answers_k
        else:
            broken_k = asked_k & ~(answers_k & _ones(link_ok_l[b].T)[None])
        views[b] = views[b]._replace(
            behaviour_penalty=views[b].behaviour_penalty
            + popcount_sum(broken_k, axis=0).T)
        got_any_l.append(reduce_or(got_k, axis=1))
        got_valid = got_k & vm[:, None, sl]
        got_valid_any_l.append(reduce_or(got_valid, axis=1))
        nv.append(topic_counts(got_valid))
        ni.append(topic_counts(got_k & inv_n[:, None, sl]))
        if cfg.gater_enabled:
            ig.append(popcount_sum(got_k & ign_n[:, None, sl], axis=0,
                                   dtype=cdt))
    got_any = torch.cat(got_any_l, dim=1)                            # [W,N]
    got_valid_any = torch.cat(got_valid_any_l, dim=1)
    have_bits = have_bits | got_any
    dlv_bits = dlv_bits | got_valid_any
    validated = popcount_sum(got_any, axis=0, dtype=I32).float()     # [N]

    # -- step 2: eager forwarding, exactly prop_substeps hops --
    allowed_l = [_edge_topic_bits(fwd_send_l[b] & data_ok_l[b][:, None, :],
                                  topic_bits, w) for b in range(B)]
    mesh_eb_l = [_edge_topic_bits(views[b].mesh, topic_bits, w)
                 for b in range(B)]
    frontier = pack_words(g.deliver_tick == tick) | got_valid_any
    dup_offer_l = None
    if dup_edges_l is not None:
        age_d = tick - g.deliver_tick
        dup_window = pack_words((age_d >= 0) & (age_d < cfg.history_gossip)) \
            & alive_bits[:, None]
        if censor_bits is not None:
            dup_window = dup_window & ~censor_bits
        # the reference's loop runs no hop on an empty starting frontier,
        # so the duplicate offers ride only a non-empty one
        started = torch.where(pg.pany((frontier != 0).any()), -1, 0) \
            .to(I32)
        dup_w = pg.replicate(dup_window, dim=1)
        dup_offer_l = [
            _gw_b(dup_w, idx_kn[b]) & mesh_eb_l[b]
            & _ones((dup_edges_l[b] & data_ok_l[b]).T)[None] & started
            for b in range(B)]
    age_dlv = tick - g.deliver_tick
    window_old = pack_words(
        (age_dlv >= 0) & (age_dlv <= cfg.mesh_message_deliveries_window_ticks))
    dlv_new = got_valid_any
    dup = [torch.zeros((t, kb, c), dtype=cdt, device=dev)
           for (s, c, kb) in bks]
    gdup = [torch.zeros((kb, c), dtype=cdt, device=dev)
            for (s, c, kb) in bks] if cfg.gater_enabled else None
    for i in range(cfg.prop_substeps):
        src = frontier if censor_bits is None else frontier & ~censor_bits
        new_any_l, new_valid_l = [], []
        src = pg.replicate(src, dim=1)
        for b in range(B):
            sl = sls[b]
            offered = _gw_b(src, idx_kn[b]) & allowed_l[b]
            if i == 0 and dup_offer_l is not None:
                offered = offered | dup_offer_l[b]
            excl = exclusive_prefix_or(offered, axis=1)
            hb_c = have_bits[:, sl]
            new_from_k = offered & ~excl & ~hb_c[:, None, :]
            new_any = (excl[:, -1] | offered[:, -1]) & ~hb_c         # [W,Nb]
            new_valid = new_any & vm[:, sl]
            nv[b] = nv[b] + topic_counts(new_from_k & vm[:, None, sl])
            ni[b] = ni[b] + topic_counts(new_from_k & inv_n[:, None, sl])
            elig = (window_old[:, sl] | dlv_new[:, sl] | new_valid) \
                & valid_msg_bits[:, None]
            dup[b] = dup[b] + topic_counts(offered & mesh_eb_l[b]
                                           & elig[:, None, :])
            if cfg.gater_enabled:
                ig[b] = ig[b] + popcount_sum(new_from_k & ign_n[:, None, sl],
                                             axis=0, dtype=cdt)
                gdup[b] = gdup[b] + popcount_sum(
                    offered & ~new_from_k & (hb_c | new_any)[:, None, :],
                    axis=0, dtype=cdt)
            new_any_l.append(new_any)
            new_valid_l.append(new_valid)
        new_any = torch.cat(new_any_l, dim=1)                        # [W,N]
        new_valid = torch.cat(new_valid_l, dim=1)
        if cfg.gater_enabled:
            # unbounded queue: every admitted message counts as validated
            validated = validated + popcount_sum(new_any, axis=0)
        frontier = new_valid
        have_bits = have_bits | new_any
        dlv_bits = dlv_bits | new_valid
        dlv_new = dlv_new | new_valid

    # [T, Kb, Nb] counts -> [Nb, T, Kb] f32 counter increments, folded
    # with this tick's decay
    def t2(x):
        return x[None, :, None]
    z = cfg.decay_to_zero
    for b in range(B):
        v = views[b]
        v = v._replace(
            first_message_deliveries=torch.minimum(
                decayed(v.first_message_deliveries,
                        t2(tp.first_message_deliveries_decay), z)
                + nv[b].permute(2, 0, 1).float(),
                t2(tp.first_message_deliveries_cap)),
            mesh_message_deliveries=torch.minimum(
                decayed(v.mesh_message_deliveries,
                        t2(tp.mesh_message_deliveries_decay), z)
                + dup[b].permute(2, 0, 1).float(),
                t2(tp.mesh_message_deliveries_cap)),
            invalid_message_deliveries=decayed(
                v.invalid_message_deliveries,
                t2(tp.invalid_message_deliveries_decay), z)
            + ni[b].permute(2, 0, 1).float())
        if cfg.gater_enabled:
            # the validation cap is refused, so throttle stays untouched
            v = v._replace(
                gater_deliver=v.gater_deliver + nv[b].float().sum(0).T,
                gater_duplicate=v.gater_duplicate + gdup[b].float().T,
                gater_ignore=v.gater_ignore + ig[b].float().T,
                gater_reject=v.gater_reject + ni[b].float().sum(0).T)
        views[b] = v

    newly_dlv = dlv_bits & ~dlv_start
    deliver_tick = torch.where(unpack_words(newly_dlv, m), tick,
                               g.deliver_tick)
    # counts over every peer, taken whole before the float32 difference
    totals = pg.psum(torch.stack([popcount(have_bits).to(torch.int64).sum(),
                                  n_have_start]))
    delivered = totals[0].float() - totals[1].float()

    # -- step 3: IHAVE/IWANT for next tick (the updated deliveries) --
    age = tick - deliver_tick
    window_bits = pack_words((age >= 0) & (age < cfg.history_gossip)) \
        & alive_bits[:, None]
    window_bits = torch.where(mal[None, :], alive_bits[:, None], window_bits)
    pend_l = []
    window_w = pg.replicate(window_bits, dim=1)
    for b, (s, c, kb) in enumerate(bks):
        ep = bs.e[b]
        if cfg.scoring_enabled:
            gossip_ok = scores_l[b] >= cfg.gossip_threshold
        else:
            gossip_ok = torch.ones((c, kb), dtype=torch.bool, device=dev)
        valid_slots = ((ep.neighbors >= 0)
                       & (ep.reverse_slot >= 0))[:, None, :]
        inc_g = inc_gossip_l[b] & valid_slots & gossip_ok[:, None, :]
        offer = _gw_b(window_w, idx_kn[b]) \
            & _edge_topic_bits(inc_g, topic_bits, w)
        # max_iwant_per_tick >= msg_window (check_bucketable): the budget
        # cannot bind, the lowest offering slot per message is asked
        excl = exclusive_prefix_or(offer, axis=1)
        pend_l.append(_bits_to_slot(
            offer & ~excl & ~have_bits[:, None, sls[b]], m))

    out = _merge(bs, views)
    g2 = out.g._replace(
        have=have_bits.T.contiguous(), deliver_tick=deliver_tick,
        delivered_total=out.g.delivered_total + delivered,
        iwant_pending=torch.cat(pend_l, dim=0))
    if cfg.gater_enabled:
        g2 = g2._replace(gater_validate=g2.gater_validate + validated)
    return out._replace(g=g2)


# ---------------------------------------------------------------------------
# churn fork (ops/churn.churn_edges over the flat exchange)


def _churn_b(bs: BucketedState, cfg: SimConfig, tp: TopicParams,
             key: torch.Tensor, scores_all_l: list, noise,
             forbid_up_l=None) -> BucketedState:
    """Per-bucket mirror of ops/churn.churn_edges (bucketed.py:1140-1195):
    the lower global id's down/up/direct bits decide each edge (buckets
    are contiguous id ranges, so row ids are global ids), the three
    decision planes ride one packed exchange, and take_edges_down /
    bring_edges_up run on the views."""
    from ..ops.churn import bring_edges_up, take_edges_down

    bks = _local_buckets(cfg)
    B = len(bks)
    tick = bs.g.tick
    kd, ku = rng.split(key, 2)
    views = [_view(bs, b, cfg) for b in range(B)]
    d_down_l = [x < cfg.churn_disconnect_prob for x in noise(kd, "nk")]
    up_noise = noise(ku, "nk")
    d_up_l = []
    for b in range(B):
        v = views[b]
        if cfg.px_enabled:
            down_age = tick - v.disconnect_tick
            px_score = torch.where(down_age > cfg.retain_score_ticks,
                                   torch.zeros_like(scores_all_l[b]),
                                   scores_all_l[b])
            p_up = torch.where(px_score >= cfg.accept_px_threshold,
                               cfg.churn_reconnect_prob,
                               cfg.churn_reconnect_prob
                               * cfg.px_low_score_factor)
        else:
            p_up = cfg.churn_reconnect_prob
        d_up_l.append(up_noise[b] < p_up)
    del up_noise

    ex = _exchange_masks(
        bs, [[d_down_l[b], d_up_l[b], views[b].direct] for b in range(B)])
    sts = []
    redial = (tick % cfg.direct_connect_ticks) == 0
    gs = _global_starts(cfg)
    for b, (s, c, kb) in enumerate(bks):
        v = views[b]
        nbr = v.neighbors
        gd, gu, gdir = ex[b]
        mine_wins = (gs[b] + torch.arange(c, device=nbr.device))[:, None] \
            < nbr
        d_down = torch.where(mine_wins, d_down_l[b], gd)
        d_up = torch.where(mine_wins, d_up_l[b], gu)
        direct_low = torch.where(mine_wins, v.direct, gdir)
        known = nbr >= 0
        down = known & ~v.connected
        live = known & v.connected
        go_down = live & d_down
        come_up = (down & d_up) | (down & direct_low & redial)
        if forbid_up_l is not None:
            come_up = come_up & ~forbid_up_l[b]
        v = take_edges_down(v, cfg, tp, go_down)
        sts.append(bring_edges_up(v, cfg, come_up))
    return _merge(bs, sts)


# ---------------------------------------------------------------------------
# fault fork (sim/faults.apply_faults, per-bucket cut masks and draws)


class BucketedFaultTick(NamedTuple):
    """Per-bucket twin of sim/faults.FaultTick: the edge-plane members are
    tuples (one [Nb, Kb] plane per bucket); corrupt and injected stay
    global."""

    want_down: tuple
    link_ok: tuple | None
    dup_edges: tuple | None
    corrupt: torch.Tensor | None
    injected: torch.Tensor


def _apply_faults_b(bs: BucketedState, cfg: SimConfig, tp: TopicParams,
                    key: torch.Tensor, noise
                    ) -> tuple[BucketedState, BucketedFaultTick]:
    """Per-bucket mirror of sim/faults.apply_faults (bucketed.py:
    1213-1318): cut masks from edge_cut_mask's row slices (global-id
    predicates, so the buckets' masks concatenate into the dense mask);
    injected bits OR across buckets (any() over the slices is the global
    any())."""
    from ..ops.churn import bring_edges_up, take_edges_down
    from .faults import _bit, _family_salt, _thr32, edge_cut_mask, \
        slow_edge_hash
    from .invariants import (FAULT_CENSOR, FAULT_LINK_DROP, FAULT_LINK_DUP,
                             FAULT_SLOWLINK, FAULT_STORM)

    plan = cfg.fault_plan
    bks = _local_buckets(cfg)
    B = len(bks)
    n = cfg.n_peers
    tick = bs.g.tick
    # the cut sets read every peer's flag; rows at their global ids
    mal = pg.replicate(bs.g.malicious) if plan.eclipses else bs.g.malicious
    gs = _global_starts(cfg)
    if plan.slowlinks:
        kd, kdup, kc, kslow = rng.split(key, 4)
    else:
        kd, kdup, kc = rng.split(key, 3)
        kslow = None

    want_down_l = []
    inj = torch.zeros((), dtype=I32, device=tick.device)
    if plan.partitions or plan.outages or plan.eclipses or plan.waves:
        sts = []
        for b, (s, c, kb) in enumerate(bks):
            v = _view(bs, b, cfg)
            wd, heal, inj_b = edge_cut_mask(
                plan, tick, v.neighbors, v.reverse_slot,
                disconnect_tick=v.disconnect_tick, malicious=mal,
                row_start=gs[b], n_global=n)
            v = take_edges_down(v, cfg, tp, v.connected & wd)
            v = bring_edges_up(v, cfg, heal & ~v.connected & ~wd)
            want_down_l.append(wd)
            inj = inj | inj_b
            sts.append(v)
        bs = _merge(bs, sts)
    else:
        for b, (s, c, kb) in enumerate(bks):
            wd, _, inj_b = edge_cut_mask(
                plan, tick, bs.e[b].neighbors, bs.e[b].reverse_slot,
                malicious=mal, row_start=gs[b], n_global=n)
            want_down_l.append(wd)
            inj = inj | inj_b

    for fam, bit in ((plan.storms, FAULT_STORM),
                     (plan.censorships, FAULT_CENSOR)):
        for w in fam:
            inj = inj | _bit((tick >= w.start) & (tick < w.end), bit)

    conn_l = [ep.connected for ep in bs.e]
    link_ok_l = dup_edges_l = corrupt = None
    if plan.link_drop_prob > 0.0:
        link_ok_l = [x >= plan.link_drop_prob for x in noise(kd, "nk")]
        drop_any = torch.zeros((), dtype=torch.bool, device=tick.device)
        for ok, conn in zip(link_ok_l, conn_l):
            drop_any = drop_any | (~ok & conn).any()
        inj = inj | _bit(drop_any, FAULT_LINK_DROP)
    if plan.slowlinks:
        kss = rng.split(kslow, len(plan.slowlinks))
        lk_l = [torch.ones_like(conn) for conn in conn_l]
        stalled = torch.zeros((), dtype=torch.bool, device=tick.device)
        for ci, cl in enumerate(plan.slowlinks):
            salt = _family_salt(plan.seed, "slowlink", ci)
            drops = noise(kss[ci], "nk") if cl.drop > 0.0 else None
            for b, (s, c, kb) in enumerate(bks):
                nbr_b = bs.e[b].neighbors
                h = slow_edge_hash(nbr_b, salt, row_start=gs[b],
                                   n_global=n)
                member = (h < _thr32(cl.fraction)) & (nbr_b >= 0)
                phase = (h % cl.period).to(I32)
                open_now = ((tick + phase) % cl.period) == 0
                ok = open_now
                if drops is not None:
                    ok = ok & (drops[b] >= cl.drop)
                lk_l[b] = lk_l[b] & (~member | ok)
                stalled = stalled | (member & ~open_now & conn_l[b]).any()
        link_ok_l = lk_l if link_ok_l is None \
            else [a & o for a, o in zip(link_ok_l, lk_l)]
        inj = inj | _bit(stalled, FAULT_SLOWLINK)
    if plan.link_dup_prob > 0.0:
        dup_edges_l = [(x < plan.link_dup_prob) & conn
                       for x, conn in zip(noise(kdup, "nk"), conn_l)]
        dup_any = torch.zeros((), dtype=torch.bool, device=tick.device)
        for d in dup_edges_l:
            dup_any = dup_any | d.any()
        inj = inj | _bit(dup_any, FAULT_LINK_DUP)
    if plan.corrupt_prob > 0.0:
        # a [P]-sized global draw, identical to the dense site
        corrupt = rng.uniform(kc, (cfg.publishers_per_tick,)) \
            < plan.corrupt_prob
    return bs, BucketedFaultTick(
        want_down=tuple(want_down_l),
        link_ok=None if link_ok_l is None else tuple(link_ok_l),
        dup_edges=None if dup_edges_l is None else tuple(dup_edges_l),
        corrupt=corrupt, injected=pg.por(inj))


# ---------------------------------------------------------------------------
# gater decay and the invariant sentinel


def _gater_decay_b(bs: BucketedState, cfg: SimConfig) -> BucketedState:
    """ops/gater.gater_decay split across the layout (bucketed.py:
    1325-1344): the global validate/throttle planes decay on ``g``, the
    four per-source planes per bucket."""
    z = cfg.decay_to_zero

    def dec(v, factor):
        v = v * factor
        return torch.where(v < z, torch.zeros_like(v), v)

    g = bs.g._replace(
        gater_validate=dec(bs.g.gater_validate, cfg.gater_global_decay),
        gater_throttle=dec(bs.g.gater_throttle, cfg.gater_global_decay))
    e = tuple(ep._replace(
        gater_deliver=dec(ep.gater_deliver, cfg.gater_source_decay),
        gater_duplicate=dec(ep.gater_duplicate, cfg.gater_source_decay),
        gater_ignore=dec(ep.gater_ignore, cfg.gater_source_decay),
        gater_reject=dec(ep.gater_reject, cfg.gater_source_decay))
        for ep in bs.e)
    return bs._replace(g=g, e=e)


def _record_flags_b(bs: BucketedState, cfg: SimConfig,
                    injected=None) -> BucketedState:
    """sim/invariants.record_flags over the buckets (bucketed.py:
    1347-1372): every check is an any() reduction, so the OR of the
    buckets' words is the dense word. Under ``"raise"`` the state is the
    ``"record"`` one, as the dense step's: the reference's
    ``bucketed_run`` cannot evaluate its check, and the port's refuses
    ``"raise"`` (:func:`bucketed_run`)."""
    from .invariants import tick_flags

    flags = None
    for b in range(len(bs.e)):
        fb = tick_flags(_view(bs, b, cfg), cfg, n_global=cfg.n_peers)
        flags = fb if flags is None else flags | fb
    if injected is not None:
        flags = flags | injected
    return bs._replace(g=bs.g._replace(
        fault_flags=bs.g.fault_flags | pg.por(flags)))


# ---------------------------------------------------------------------------
# the bucketed tick and the run wrappers


def _bucketed_tick(bs: BucketedState, cfg: SimConfig, tp: TopicParams,
                   key: torch.Tensor) -> BucketedState:
    """One tick of a stored bucketed state (bucketed.py:1379-1451)."""
    from ..ops.propagate import publish
    from .engine import choose_publishers
    from .faults import censor_word_mask
    from .invariants import FAULT_CORRUPT

    _check_sharded(cfg)
    check_bucketable(cfg)
    check_precision(cfg)
    noise = _mk_noise(cfg)
    bs = decode_bucketed(bs, cfg)
    if cfg.fault_plan is not None:
        key, k_fault = rng.split(key, 2)
        bs, fault = _apply_faults_b(bs, cfg, tp, k_fault, noise)
    else:
        fault = None
    # k_sub is never consumed: subscription churn is refused
    k_pub, k_hb, k_fwd, k_churn, k_ign, _ = rng.split(key, 6)
    peers, topics = choose_publishers(bs.g, cfg, k_pub)
    if fault is not None and fault.corrupt is not None:
        corrupt = fault.corrupt & ~pg.owner_rows(bs.g.malicious, peers)
        fault = fault._replace(corrupt=corrupt, injected=fault.injected | (
            corrupt.any().to(torch.int32) * FAULT_CORRUPT))
    bs = bs._replace(g=publish(
        bs.g, cfg, peers, topics, k_ign,
        corrupt=fault.corrupt if fault is not None else None))
    censor_bits = censor_word_mask(bs.g, cfg)
    if cfg.gater_enabled:
        bs = _gater_decay_b(bs, cfg)
    bs, scores, scores_all, inc_gossip, fwd_send = _heartbeat_b(
        bs, cfg, tp, k_hb, noise)
    bs = _forward_b(bs, cfg, tp, inc_gossip, scores, k_fwd, fwd_send, noise,
                    link_ok_l=fault.link_ok if fault is not None else None,
                    dup_edges_l=fault.dup_edges if fault is not None
                    else None,
                    censor_bits=censor_bits)
    del inc_gossip, fwd_send, scores
    if cfg.churn_disconnect_prob > 0.0:
        bs = _churn_b(bs, cfg, tp, k_churn, scores_all, noise,
                      forbid_up_l=fault.want_down if fault is not None
                      else None)
    notes = pg.drain_halo_overflow()
    if notes:
        # halo-route overflows of this tick's flat exchanges
        bs = bs._replace(g=bs.g._replace(
            halo_overflow=bs.g.halo_overflow + sum(notes)))
    if cfg.invariant_mode != "off":
        bs = _record_flags_b(bs, cfg, injected=fault.injected
                             if fault is not None else None)
    bs = bs._replace(g=bs.g._replace(tick=bs.g.tick + 1))
    return encode_bucketed(bs, cfg)


def bucketed_step(bs: BucketedState, cfg: SimConfig, tp: TopicParams,
                  key: torch.Tensor, device=None) -> BucketedState:
    """One tick on the degree-bucketed layout, on ``device`` (cuda unless
    the caller passes ``device="cpu"``; the state must lie there):
    ``engine.step`` with every edge-plane op at bucket width. Key splits,
    op order and every draw site mirror ``engine.step``; under
    ``bucketed_rng="dense"`` the tick equals a dense step on the same
    graph. Under ``invariant_mode="raise"`` it computes the ``"record"``
    state, as the dense ``step`` does."""
    check_on(bs.g.tick.device, device)
    return _bucketed_tick(bs, cfg, tp, key)


def bucketed_run(bs: BucketedState, cfg: SimConfig, tp: TopicParams,
                 key: torch.Tensor, n_ticks: int,
                 device=None) -> BucketedState:
    """Advance ``n_ticks`` heartbeats from one master key under
    ``cfg.key_schedule`` (bucketed.py:1454-1477): ``"host"`` splits the
    master into per-tick keys, ``"fold_in"`` folds it with the state's
    absolute tick. ``invariant_mode="raise"`` is refused with a
    ValueError, as the reference's jitted ``bucketed_run`` refuses it
    (its checkify check cannot be evaluated there)."""
    from .engine import _plain, _schedule

    check_on(bs.g.tick.device, device)
    _plain(cfg, "bucketed_run")
    key_of = _schedule(bs, cfg, key, n_ticks)
    for i in range(n_ticks):
        bs = _bucketed_tick(bs, cfg, tp, key_of(i, bs))
    return bs


def init_bucketed_state(cfg: SimConfig, topo, device=None,
                        **planes) -> BucketedState:
    """``state.init_state``, then bucketized (bucketed.py:1480-1488): the
    stored-layout BucketedState a bucketed run starts from, on ``device``
    (cuda unless the caller passes ``device="cpu"``). Takes init_state's
    keyword planes (subscribed, ip_group, app_score, malicious)."""
    check_bucketable(cfg)
    dense = decode_state(init_state(cfg, topo, device=device, **planes), cfg)
    return encode_bucketed(bucketize_state(dense, cfg), cfg)
