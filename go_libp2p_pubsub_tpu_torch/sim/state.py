"""Device-resident simulation state (PyTorch port of sim/state.py).

One ``SimState`` holds the whole N-peer network as tensors with the field
names, order, shapes and meaning of the reference's ``SimState``. Dtypes
follow the reference with two substitutions, since PyTorch's unsigned
types beyond uint8 have few operators: the reference's ``uint32`` planes
(``have``, ``fault_flags``, and under compact storage every packed bool
plane) are int32 tensors holding the same bits (ops/bits.py), and its
``uint16`` planes (compact storage's bf16 bit patterns) are int16 tensors
holding the same bits. :func:`state_from_reference` and
:func:`state_to_numpy` carry a state across the two packages in either
layout.

``cfg.state_precision`` picks how the state is STORED between ticks:
``"f32"`` (the compute layout) or ``"compact"`` (``_COMPACT_CODECS``:
bf16 counters, int16 relative ticks, bit-packed bool slot planes, int8
slot indices). Compute always runs in the f32 layout: ``engine.step``
decodes at entry and encodes at exit (:func:`decode_state`,
:func:`encode_state`). :func:`state_spec`, :func:`state_nbytes` and
:func:`check_hbm_budget` price the stored layout in the reference's
dtypes before anything is allocated.
"""

from __future__ import annotations

import dataclasses
import os
from typing import NamedTuple

import numpy as np
import torch

from ..device import resolve_device
from .config import SimConfig
from .hostio import fetch_local
from .topology import Topology

NEVER = 2 ** 30          # sentinel for "never" ticks (int32)

# fields the reference stores as uint32 in either layout (the port: int32,
# same bits)
U32_FIELDS = frozenset({"have", "fault_flags"})


class SimState(NamedTuple):
    tick: torch.Tensor                 # scalar int32 heartbeat counter

    # --- static-ish topology ---
    neighbors: torch.Tensor            # [N, K] int32, -1 padded
    connected: torch.Tensor            # [N, K] bool
    outbound: torch.Tensor             # [N, K] bool
    reverse_slot: torch.Tensor         # [N, K] int32
    subscribed: torch.Tensor           # [N, T] bool
    nbr_subscribed: torch.Tensor       # [N, T, K] bool receiver view of
                                       #   neighbor subscriptions; refresh via
                                       #   refresh_nbr_subscribed()
    disconnect_tick: torch.Tensor      # [N, K] int32, NEVER if up
    direct: torch.Tensor               # [N, K] bool (direct peers)
    ip_group: torch.Tensor             # [N] int32 (P6 colocation groups)
    app_score: torch.Tensor            # [N] float32 (P5)
    malicious: torch.Tensor            # [N] bool adversary attribute

    # --- router state ---
    mesh: torch.Tensor                 # [N, T, K] bool
    fanout: torch.Tensor               # [N, T, K] bool
    fanout_lastpub: torch.Tensor       # [N, T] int32 tick, NEVER if none
    backoff: torch.Tensor              # [N, T, K] int32 expiry tick

    # --- score state (observer-major) ---
    graft_tick: torch.Tensor           # [N, T, K] int32
    mesh_active: torch.Tensor          # [N, T, K] bool (P3 activation latch)
    first_message_deliveries: torch.Tensor    # [N, T, K] f32
    mesh_message_deliveries: torch.Tensor     # [N, T, K] f32
    mesh_failure_penalty: torch.Tensor        # [N, T, K] f32
    invalid_message_deliveries: torch.Tensor  # [N, T, K] f32
    behaviour_penalty: torch.Tensor    # [N, K] f32

    # --- peer gater (not on this slice's path; carried verbatim) ---
    gater_validate: torch.Tensor       # [N] f32
    gater_throttle: torch.Tensor       # [N] f32
    gater_last_throttle: torch.Tensor  # [N] int32
    gater_deliver: torch.Tensor        # [N, K] f32
    gater_duplicate: torch.Tensor      # [N, K] f32
    gater_ignore: torch.Tensor         # [N, K] f32
    gater_reject: torch.Tensor         # [N, K] f32

    # --- message window (rotating slots) ---
    msg_topic: torch.Tensor            # [M] int32 topic of slot, -1 idle
    msg_publish_tick: torch.Tensor     # [M] int32
    msg_invalid: torch.Tensor          # [M] bool
    msg_ignored: torch.Tensor          # [M] bool
    msg_publisher: torch.Tensor        # [M] int32 origin peer, -1 idle
    have: torch.Tensor                 # [N, ceil(M/32)] int32 packed seen-set
    deliver_tick: torch.Tensor         # [N, M] int32, NEVER if not delivered
    deliver_from: torch.Tensor         # [N, M] int32 (provenance; dormant)
    iwant_pending: torch.Tensor        # [N, M] int32 source slot, -1 if none

    # --- stats ---
    delivered_total: torch.Tensor      # scalar f32
    halo_overflow: torch.Tensor        # scalar int32 (multi-device only: 0)
    fault_flags: torch.Tensor          # scalar int32 bits (sim/invariants.py)


def n_msg_words(cfg: SimConfig) -> int:
    """Words of the packed per-peer message seen-set (``have``)."""
    return (cfg.msg_window + 31) // 32


def unpack_have(state: SimState, m: int) -> torch.Tensor:
    """The seen-set as [N, M] bool."""
    from ..ops.bits import unpack_words
    return unpack_words(state.have.T, m)


def have_set_bit(have: torch.Tensor, peer, slot) -> torch.Tensor:
    """``have`` with bit ``slot`` of row ``peer`` set (trace replay's
    single-delivery updates; ``peer`` and ``slot`` may be ints or scalar
    tensors)."""
    from ..ops.bits import to_i32
    slot = torch.as_tensor(slot, dtype=torch.int64, device=have.device)
    w = slot // 32
    bit = to_i32(torch.ones_like(slot) << (slot % 32))
    out = have.clone()
    out[peer, w] = have[peer, w] | bit
    return out


# --- compact storage codecs (cfg.state_precision="compact") ------------
#
# Every SimState field names its storage codec here (state.py:167-217),
# and _check_compact refuses a table that drifted from the fields:
#
#   bf16    f32 counter -> bfloat16, stored as its bit pattern (the
#           reference: uint16; the port: int16 with the same bits).
#           Rounding is to nearest even, as XLA's convert; a NaN encodes
#           as the quiet NaN of its sign, as XLA's does (torch's own
#           conversion gives other NaN bits)
#   tick16  bounded int32 tick plane -> int16 RELATIVE to state.tick;
#           NEVER maps to the reserved +32767, other deltas saturate at
#           +/-32766 (gater_last_throttle's -NEVER fill saturates to
#           "32766 ticks ago", which every quiet-period compare treats as
#           -NEVER)
#   packK   bool [..., K] slot plane -> 32-bit words [..., ceil(K/32)]
#           (ops/bits.pack_bool; pad bits zero) — lossless
#   slot8   neighbor-slot index int32 -> int8 (values in [-1, k_slots);
#           compact refuses k_slots > 127 by name) — lossless
#   None    stored as-is
_COMPACT_CODECS = dict(
    tick=None,
    neighbors=None, connected="packK", outbound="packK",
    reverse_slot="slot8", subscribed=None, nbr_subscribed="packK",
    disconnect_tick="tick16", direct="packK",
    ip_group=None, app_score=None, malicious=None,
    mesh="packK", fanout="packK", fanout_lastpub="tick16",
    backoff="tick16", graft_tick="tick16", mesh_active="packK",
    first_message_deliveries="bf16", mesh_message_deliveries="bf16",
    mesh_failure_penalty="bf16", invalid_message_deliveries="bf16",
    behaviour_penalty="bf16",
    gater_validate=None, gater_throttle=None,
    gater_last_throttle="tick16",
    gater_deliver="bf16", gater_duplicate="bf16",
    gater_ignore="bf16", gater_reject="bf16",
    msg_topic=None, msg_publish_tick=None, msg_invalid=None,
    msg_ignored=None, msg_publisher=None,
    have=None, deliver_tick="tick16", deliver_from="slot8",
    iwant_pending=None,
    delivered_total=None, halo_overflow=None, fault_flags=None,
)

_TICK16_NEVER = 32767     # reserved int16 encoding of the NEVER sentinel
_TICK16_SAT = 32766       # saturation bound for live relative ticks
_BF16_QNAN = 0x7FC0       # bf16 quiet NaN
_BF16_NEG_QNAN = 0xFFC0 - 0x10000   # with the sign bit, as an int16


def _check_compact(cfg: SimConfig) -> None:
    if cfg.state_precision != "compact":
        raise ValueError(
            f"state_precision={cfg.state_precision!r}: expected 'f32' or "
            "'compact'")
    if cfg.k_slots > 127:
        raise ValueError(
            f"state_precision='compact': the slot8 codec stores neighbor "
            f"slots as int8, so k_slots={cfg.k_slots} > 127 is refused")
    if set(_COMPACT_CODECS) != set(SimState._fields):
        raise RuntimeError("_COMPACT_CODECS drifted from SimState._fields")


def check_precision(cfg: SimConfig) -> None:
    """Refuse an unknown ``state_precision``, and compact storage where
    its codecs cannot hold the config (k_slots > 127), by name."""
    if cfg.state_precision != "f32":
        _check_compact(cfg)


def _compact_entry(codec, shape, dtype):
    """(shape, dtype) a codec stores the f32-layout (shape, dtype) as, in
    the reference's dtypes."""
    if codec == "bf16":
        return shape, np.uint16
    if codec == "tick16":
        return shape, np.int16
    if codec == "slot8":
        return shape, np.int8
    if codec == "packK":
        return shape[:-1] + ((shape[-1] + 31) // 32,), np.uint32
    return shape, dtype


def is_compact(state: SimState) -> bool:
    """True when ``state`` is in the compact storage layout (its mesh
    plane packed into words)."""
    return state.mesh.dtype != torch.bool


def reference_dtype(state: SimState, field: str) -> np.dtype:
    """The numpy dtype the reference stores ``field`` of ``state`` in: the
    tensor's own, but uint32 for the port's int32 words and uint16 for its
    int16 bf16 patterns."""
    codec = _COMPACT_CODECS[field] if is_compact(state) else None
    if field in U32_FIELDS or codec == "packK":
        return np.dtype(np.uint32)
    if codec == "bf16":
        return np.dtype(np.uint16)
    return torch.empty(0, dtype=getattr(state, field).dtype).numpy().dtype


def state_spec(cfg: SimConfig) -> dict:
    """field -> (shape, dtype, peer_major): the state AS STORED under
    ``cfg.state_precision``, in the reference's numpy dtypes
    (state.py:249-295): the port's int32/int16 stand-ins for uint32/uint16
    hold the same bytes. ``peer_major`` fields lead with the N axis (a
    peer sharding divides them); the rest replicate."""
    n, k, t, m = cfg.n_peers, cfg.k_slots, cfg.n_topics, cfg.msg_window
    w = n_msg_words(cfg)
    i32, f32, b, u32 = np.int32, np.float32, np.bool_, np.uint32
    spec = dict(
        tick=((), i32, False),
        neighbors=((n, k), i32, True), connected=((n, k), b, True),
        outbound=((n, k), b, True), reverse_slot=((n, k), i32, True),
        subscribed=((n, t), b, True), nbr_subscribed=((n, t, k), b, True),
        disconnect_tick=((n, k), i32, True), direct=((n, k), b, True),
        ip_group=((n,), i32, True), app_score=((n,), f32, True),
        malicious=((n,), b, True),
        mesh=((n, t, k), b, True), fanout=((n, t, k), b, True),
        fanout_lastpub=((n, t), i32, True), backoff=((n, t, k), i32, True),
        graft_tick=((n, t, k), i32, True), mesh_active=((n, t, k), b, True),
        first_message_deliveries=((n, t, k), f32, True),
        mesh_message_deliveries=((n, t, k), f32, True),
        mesh_failure_penalty=((n, t, k), f32, True),
        invalid_message_deliveries=((n, t, k), f32, True),
        behaviour_penalty=((n, k), f32, True),
        gater_validate=((n,), f32, True), gater_throttle=((n,), f32, True),
        gater_last_throttle=((n,), i32, True),
        gater_deliver=((n, k), f32, True),
        gater_duplicate=((n, k), f32, True),
        gater_ignore=((n, k), f32, True), gater_reject=((n, k), f32, True),
        msg_topic=((m,), i32, False), msg_publish_tick=((m,), i32, False),
        msg_invalid=((m,), b, False), msg_ignored=((m,), b, False),
        msg_publisher=((m,), i32, False),
        have=((n, w), u32, True), deliver_tick=((n, m), i32, True),
        deliver_from=((n, m), i32, True), iwant_pending=((n, m), i32, True),
        delivered_total=((), f32, False), halo_overflow=((), i32, False),
        fault_flags=((), u32, False),
    )
    if set(spec) != set(SimState._fields):
        raise RuntimeError("state_spec drifted from SimState._fields")
    if cfg.state_precision == "f32":
        return spec
    _check_compact(cfg)
    return {f: _compact_entry(_COMPACT_CODECS[f], shape, dtype)
            + (peer_major,)
            for f, (shape, dtype, peer_major) in spec.items()}


def _encode_bf16(v: torch.Tensor, tick: torch.Tensor) -> torch.Tensor:
    bits = v.to(torch.bfloat16).view(torch.int16)
    qnan = torch.full_like(bits, _BF16_QNAN).masked_fill(torch.signbit(v),
                                                         _BF16_NEG_QNAN)
    return torch.where(torch.isnan(v), qnan, bits)


def _encode_tick16(v: torch.Tensor, tick: torch.Tensor) -> torch.Tensor:
    rel = (v - tick).clamp(-_TICK16_SAT, _TICK16_SAT)
    return rel.masked_fill(v == NEVER, _TICK16_NEVER).to(torch.int16)


def _encode_pack(v: torch.Tensor, tick: torch.Tensor) -> torch.Tensor:
    from ..ops.bits import pack_bool
    return pack_bool(v)


def _encode_slot8(v: torch.Tensor, tick: torch.Tensor) -> torch.Tensor:
    return v.to(torch.int8)


_ENCODE = {"bf16": _encode_bf16, "tick16": _encode_tick16,
           "packK": _encode_pack, "slot8": _encode_slot8}


def decode_plane(codec: str, v: torch.Tensor, tick: torch.Tensor,
                 k: int) -> torch.Tensor:
    """One stored plane back in the compute layout: the inverse of
    ``_ENCODE[codec]`` (``k``: the slot count a packed plane unpacks to)."""
    if codec == "bf16":
        return v.view(torch.bfloat16).to(torch.float32)
    if codec == "tick16":
        e = v.to(torch.int32)
        return (tick + e).masked_fill(e == _TICK16_NEVER, NEVER)
    if codec == "packK":
        from ..ops.bits import unpack_bool
        return unpack_bool(v, k)
    if codec == "slot8":
        return v.to(torch.int32)
    raise ValueError(f"unknown storage codec {codec!r}")


def encode_state(state: SimState, cfg: SimConfig) -> SimState:
    """The STORED representation of a compute-layout state
    (state.py:298-330): identity under ``"f32"``; under ``"compact"`` the
    codecs of ``_COMPACT_CODECS`` field by field, the tick planes relative
    to ``state.tick``. ``engine.step`` calls it at exit."""
    if cfg.state_precision == "f32":
        return state
    _check_compact(cfg)
    if is_compact(state):
        raise TypeError(
            "encode_state: state is already in the compact storage "
            f"layout (mesh dtype {state.mesh.dtype})")
    return state._replace(**{
        f: _ENCODE[codec](getattr(state, f), state.tick)
        for f, codec in _COMPACT_CODECS.items() if codec is not None})


def decode_state(state: SimState, cfg: SimConfig) -> SimState:
    """Inverse of :func:`encode_state` (state.py:333-363): the f32/int32
    compute layout. Identity under ``"f32"``. The tick planes decode
    relative to ``state.tick``, so decode must see the tick the encode
    saw (the step's decode at entry and encode at exit bracket the tick's
    increment)."""
    if cfg.state_precision == "f32":
        return state
    _check_compact(cfg)
    if not is_compact(state):
        raise TypeError(
            "decode_state: state is already in the compute layout")
    return state._replace(**{
        f: decode_plane(codec, getattr(state, f), state.tick, cfg.k_slots)
        for f, codec in _COMPACT_CODECS.items() if codec is not None})


def per_peer_byte_ceilings(cfg: SimConfig) -> dict:
    """field -> the most bytes per peer each peer-major plane may price
    under ``cfg.state_precision`` (state.py:366-411): formulas written
    apart from :func:`state_spec`, so that a layout change trips the
    audit that walks one against the other."""
    k, t, m = cfg.k_slots, cfg.n_topics, cfg.msg_window
    w, kw = (m + 31) // 32, (k + 31) // 32
    if cfg.state_precision == "compact":
        return dict(
            neighbors=4 * k, connected=4 * kw, outbound=4 * kw,
            reverse_slot=k, subscribed=t, nbr_subscribed=4 * t * kw,
            disconnect_tick=2 * k, direct=4 * kw, ip_group=4,
            app_score=4, malicious=1,
            mesh=4 * t * kw, fanout=4 * t * kw, fanout_lastpub=2 * t,
            backoff=2 * t * k, graft_tick=2 * t * k,
            mesh_active=4 * t * kw,
            first_message_deliveries=2 * t * k,
            mesh_message_deliveries=2 * t * k,
            mesh_failure_penalty=2 * t * k,
            invalid_message_deliveries=2 * t * k,
            behaviour_penalty=2 * k,
            gater_validate=4, gater_throttle=4, gater_last_throttle=2,
            gater_deliver=2 * k, gater_duplicate=2 * k,
            gater_ignore=2 * k, gater_reject=2 * k,
            have=4 * w, deliver_tick=2 * m, deliver_from=m,
            iwant_pending=4 * m,
        )
    return dict(
        neighbors=4 * k, connected=k, outbound=k, reverse_slot=4 * k,
        subscribed=t, nbr_subscribed=t * k, disconnect_tick=4 * k,
        direct=k, ip_group=4, app_score=4, malicious=1,
        mesh=t * k, fanout=t * k, fanout_lastpub=4 * t,
        backoff=4 * t * k, graft_tick=4 * t * k, mesh_active=t * k,
        first_message_deliveries=4 * t * k,
        mesh_message_deliveries=4 * t * k,
        mesh_failure_penalty=4 * t * k,
        invalid_message_deliveries=4 * t * k,
        behaviour_penalty=4 * k,
        gater_validate=4, gater_throttle=4, gater_last_throttle=4,
        gater_deliver=4 * k, gater_duplicate=4 * k, gater_ignore=4 * k,
        gater_reject=4 * k,
        have=4 * w, deliver_tick=4 * m, deliver_from=4 * m,
        iwant_pending=4 * m,
    )


def bucketed_edge_nbytes(cfg: SimConfig, per_bucket: bool = False):
    """field -> bytes of each K-axis edge plane under the degree-bucketed
    layout (sim/bucketed.py; state.py:414-446): the sum over buckets of
    the field priced at the bucket's ``(n_rows, k_ceil)`` by
    :func:`state_spec`, plus ``bucket_rev``, the flat int32 reverse-index
    planes. ``per_bucket=True`` returns the unsummed list, one ``{"rows":
    n_b, "k_ceil": k_b, <field>: bytes, ..., "bucket_rev": b}`` per
    bucket."""
    from .bucketed import EDGE_FIELDS, _buckets, check_bucketable
    check_bucketable(cfg)
    out = {f: 0 for f in EDGE_FIELDS}
    rev = 0
    buckets = []
    for _, n_b, k_b in _buckets(cfg):
        sub_spec = state_spec(dataclasses.replace(
            cfg, n_peers=n_b, k_slots=k_b, degree_buckets=None))
        entry = {"rows": n_b, "k_ceil": k_b}
        for f in EDGE_FIELDS:
            shape, dtype, _ = sub_spec[f]
            nb = int(np.prod(shape, dtype=np.int64)) \
                * np.dtype(dtype).itemsize
            out[f] += nb
            entry[f] = nb
        rev += n_b * k_b * 4
        entry["bucket_rev"] = n_b * k_b * 4
        buckets.append(entry)
    out["bucket_rev"] = rev
    return buckets if per_bucket else out


def state_nbytes(cfg: SimConfig, n_dev: int | dict = 1) -> dict:
    """The state's device bytes before anything is allocated
    (state.py:449-507): per-field bytes, the total, and the bytes per
    shard of an ``n_dev``-way peer sharding (peer-major fields divide
    their N axis, the rest replicate). ``n_dev`` may be a mesh dict such
    as ``{'dcn': 2, 'peers': 4}``: the peer axis shards over every mesh
    axis. Under ``degree_buckets`` the K-axis planes are priced at the
    bucketed layout (:func:`bucketed_edge_nbytes`, each plane padded to
    its bucket's ceiling, plus ``bucket_rev``), and ``bucket_shards``
    lists each bucket's planes split over the shards (a one-row ceiling
    where a bucket's rows do not divide)."""
    mesh = None
    if isinstance(n_dev, dict):
        mesh = dict(n_dev)
        n_dev = int(np.prod(list(mesh.values()), dtype=np.int64))
    n = cfg.n_peers
    if n_dev <= 0 or n % n_dev:
        raise ValueError(
            f"state_nbytes: n_peers={n} must divide evenly over "
            f"n_dev={n_dev} (the peer sharding raises the same)")
    fields, total, per_shard = {}, 0, 0
    for f, (shape, dtype, peer_major) in state_spec(cfg).items():
        nbytes = int(np.prod(shape, dtype=np.int64)) * np.dtype(dtype).itemsize
        fields[f] = nbytes
        total += nbytes
        per_shard += nbytes // n_dev if peer_major else nbytes
    bucket_shards = None
    if cfg.degree_buckets is not None:
        agg = {f: 0 for f in bucketed_edge_nbytes(cfg)}
        bucket_shards = []
        for entry in bucketed_edge_nbytes(cfg, per_bucket=True):
            shard_entry = {"rows": entry["rows"], "k_ceil": entry["k_ceil"]}
            for f, nb in entry.items():
                if f in ("rows", "k_ceil"):
                    continue
                agg[f] += nb
                shard_entry[f] = -(-nb // n_dev)
                per_shard += shard_entry[f]
            bucket_shards.append(shard_entry)
        for f, nbytes in agg.items():
            old = fields.get(f, 0)
            fields[f] = nbytes
            total += nbytes - old
            per_shard -= old // n_dev
    out = {"total": total, "per_shard": per_shard, "n_dev": n_dev,
           "fields": fields}
    if bucket_shards is not None:
        out["bucket_shards"] = bucket_shards
    if mesh is not None:
        out["mesh"] = mesh
    return out


def hbm_budget_bytes() -> int | None:
    """The ``GRAFT_HBM_BUDGET`` gate value in bytes (suffixes KiB / MiB /
    GiB / K / M / G accepted, case-insensitive); None when unset/empty."""
    raw = os.environ.get("GRAFT_HBM_BUDGET", "").strip()
    if not raw:
        return None
    low = raw.lower()
    mult = 1
    for suf, m in (("kib", 2 ** 10), ("mib", 2 ** 20), ("gib", 2 ** 30),
                   ("k", 2 ** 10), ("m", 2 ** 20), ("g", 2 ** 30)):
        if low.endswith(suf):
            low, mult = low[: -len(suf)], m
            break
    try:
        return int(float(low) * mult)
    except ValueError as e:
        raise ValueError(
            f"GRAFT_HBM_BUDGET={raw!r}: expected bytes with an optional "
            "KiB/MiB/GiB suffix") from e


def check_hbm_budget(cfg: SimConfig, n_dev: int | dict = 1,
                     budget: int | None = None, what: str = "state") -> dict:
    """Price the state (:func:`state_nbytes`) and refuse with a ValueError
    naming the four largest planes when the bytes per shard exceed
    ``budget`` (state.py:531-576). ``budget=None`` reads
    ``GRAFT_HBM_BUDGET``; with no gate set the pricing is returned. Under
    ``degree_buckets`` the refusal names the worst (field x bucket)
    planes, such as ``mesh[b0 16384x64]``."""
    acct = state_nbytes(cfg, n_dev)
    if budget is None:
        budget = hbm_budget_bytes()
    if budget is None or acct["per_shard"] <= budget:
        return acct
    spec = state_spec(cfg)
    if "bucket_shards" in acct:
        per_bucket = []
        for b, entry in enumerate(acct["bucket_shards"]):
            tag = f"b{b} {entry['rows']}x{entry['k_ceil']}"
            per_bucket += [(f"{f}[{tag}]", nb) for f, nb in entry.items()
                           if f not in ("rows", "k_ceil")]
        edge = set(f for e in acct["bucket_shards"] for f in e)
        per_bucket += [(f, b // acct["n_dev"] if f not in spec or spec[f][2]
                        else b)
                       for f, b in acct["fields"].items() if f not in edge]
        worst = sorted(per_bucket, key=lambda kv: -kv[1])[:4]
    else:
        shard_fields = {f: (b // acct["n_dev"] if spec[f][2] else b)
                        for f, b in acct["fields"].items()}
        worst = sorted(shard_fields.items(), key=lambda kv: -kv[1])[:4]
    names = ", ".join(f"{f}={b / 2 ** 20:.1f}MiB" for f, b in worst)
    raise ValueError(
        f"GRAFT_HBM_BUDGET: {what} prices "
        f"{acct['per_shard'] / 2 ** 30:.2f} GiB/shard on {acct['n_dev']} "
        f"shards, over the {budget / 2 ** 30:.2f} GiB budget "
        f"(n_peers={cfg.n_peers}, "
        f"state_precision={cfg.state_precision!r}); worst fields: "
        f"{names}. Shrink the config, raise the budget, or set "
        "state_precision='compact'.")


def _nbr_view(subscribed, neighbors):
    from ..parallel import kernel_context as kc
    # inside a peer group the neighbours' rows come from the group
    n = kc.global_rows(subscribed.shape[0])
    view = kc.owner_rows(subscribed, neighbors.clamp(0, n - 1)) \
        .permute(0, 2, 1)
    return view & (neighbors >= 0)[:, None, :]


def refresh_nbr_subscribed(state: SimState) -> SimState:
    """Recompute the cached neighbor-subscription receiver view. MUST be
    called after any mutation of ``state.subscribed``."""
    return state._replace(
        nbr_subscribed=_nbr_view(state.subscribed, state.neighbors))


def init_state(cfg: SimConfig, topo: Topology,
               subscribed: np.ndarray | None = None,
               ip_group: np.ndarray | None = None,
               app_score: np.ndarray | None = None,
               malicious: np.ndarray | None = None,
               device=None) -> SimState:
    """The initial state of ``cfg`` on ``topo``, built on ``device`` (cuda
    unless the caller passes ``device="cpu"``), in the layout
    ``cfg.state_precision`` stores (a compact state is the encoded f32
    one, as the reference's init)."""
    check_precision(cfg)
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

    return _init_rows(cfg, topo.neighbors, topo.outbound, topo.reverse_slot,
                      subscribed, ip_group, app_score, malicious, None, dev)


def _init_rows(cfg: SimConfig, neighbors, outbound, reverse_slot, subscribed,
               ip_group, app_score, malicious, nbr_subscribed,
               dev) -> SimState:
    """The initial state of the rows the host arrays hold (all N, or one
    rank's block: parallel/multihost.init_state_local, which passes the
    receiver view ``nbr_subscribed`` built from the whole subscription
    table; None computes it from these rows)."""
    n, m = neighbors.shape[0], cfg.msg_window
    k, t = cfg.k_slots, cfg.n_topics

    def host(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype)).to(dev)

    def full(shape, fill, dtype):
        return torch.full(shape, fill, dtype=dtype, device=dev)

    i32, f32, b = torch.int32, torch.float32, torch.bool
    neighbors = host(neighbors, np.int32)
    sub = host(subscribed, bool)
    return encode_state(SimState(
        tick=full((), 0, i32),
        neighbors=neighbors,
        connected=neighbors >= 0,
        outbound=host(outbound, bool),
        reverse_slot=host(reverse_slot, np.int32),
        subscribed=sub,
        nbr_subscribed=_nbr_view(sub, neighbors) if nbr_subscribed is None
        else host(nbr_subscribed, bool),
        disconnect_tick=full((n, k), NEVER, i32),
        direct=full((n, k), False, b),
        ip_group=host(ip_group, np.int32),
        app_score=host(app_score, np.float32),
        malicious=host(malicious, bool),
        mesh=full((n, t, k), False, b),
        fanout=full((n, t, k), False, b),
        fanout_lastpub=full((n, t), NEVER, i32),
        backoff=full((n, t, k), 0, i32),
        graft_tick=full((n, t, k), NEVER, i32),
        mesh_active=full((n, t, k), False, b),
        first_message_deliveries=full((n, t, k), 0.0, f32),
        mesh_message_deliveries=full((n, t, k), 0.0, f32),
        mesh_failure_penalty=full((n, t, k), 0.0, f32),
        invalid_message_deliveries=full((n, t, k), 0.0, f32),
        behaviour_penalty=full((n, k), 0.0, f32),
        gater_validate=full((n,), 0.0, f32),
        gater_throttle=full((n,), 0.0, f32),
        gater_last_throttle=full((n,), -NEVER, i32),
        gater_deliver=full((n, k), 0.0, f32),
        gater_duplicate=full((n, k), 0.0, f32),
        gater_ignore=full((n, k), 0.0, f32),
        gater_reject=full((n, k), 0.0, f32),
        msg_topic=full((m,), -1, i32),
        msg_publish_tick=full((m,), NEVER, i32),
        msg_invalid=full((m,), False, b),
        msg_ignored=full((m,), False, b),
        msg_publisher=full((m,), -1, i32),
        have=full((n, n_msg_words(cfg)), 0, i32),
        deliver_tick=full((n, m), NEVER, i32),
        deliver_from=full((n, m), -1, i32),
        iwant_pending=full((n, m), -1, i32),
        delivered_total=full((), 0.0, f32),
        halo_overflow=full((), 0, i32),
        fault_flags=full((), 0, i32),
    ), cfg)


def field_from_reference(field: str, a, device) -> torch.Tensor:
    """One field of a reference state (a numpy array in the reference's
    dtype) as the port's tensor on ``device``: uint32 planes become int32
    and uint16 planes int16 tensors with the same bits. The tensor is
    contiguous whatever the array's memory order (a CPU run's transposed
    planes reach ``.npz`` files in Fortran order; the card's kernels take
    contiguous rows)."""
    a = np.asarray(a)
    if field in U32_FIELDS:
        a = a.astype(np.uint32)
    if a.dtype in (np.uint32, np.uint16):
        a = a.view(np.int32 if a.dtype == np.uint32 else np.int16)
    return torch.from_numpy(np.array(a, order="C")).to(device)


def state_from_reference(arrays: dict, device=None) -> SimState:
    """The reference package's ``SimState`` (as numpy arrays, one per field
    name: ``np.asarray(getattr(st, f))``), in either storage layout, as the
    port's state on ``device``."""
    dev = resolve_device(device)
    return SimState(**{f: field_from_reference(f, arrays[f], dev)
                       for f in SimState._fields})


def state_to_numpy(state: SimState) -> dict:
    """Field name -> numpy array in the reference's dtypes, either layout
    (inverse of :func:`state_from_reference`)."""
    return {f: fetch_local(getattr(state, f), reference_dtype(state, f))
            for f in SimState._fields}
