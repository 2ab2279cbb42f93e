"""Device-resident simulation state (PyTorch port of sim/state.py).

One ``SimState`` holds the whole N-peer network as tensors with the field
names, order, shapes and meaning of the reference's ``SimState``. Dtypes
follow the reference with two substitutions, since PyTorch's unsigned
types beyond uint8 have few operators: the reference's ``uint32`` planes
(``have``, ``fault_flags``, and under compact storage every packed bool
plane) are int32 tensors holding the same bits (ops/bits.py), and its
``uint16`` planes (compact storage's bf16 bit patterns) are int16 tensors
holding the same bits.

``cfg.state_precision`` picks how the state is STORED between ticks:
``"f32"`` (the compute layout) or ``"compact"`` (``_COMPACT_CODECS``:
bf16 counters, int16 relative ticks, bit-packed bool slot planes, int8
slot indices). Compute always runs in the f32 layout: ``engine.step``
decodes at entry and encodes at exit (:func:`decode_state`,
:func:`encode_state`).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .device import resolve_device
from .config import SimConfig

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
    from .bits import unpack_words
    return unpack_words(state.have.T, m)


def have_set_bit(have: torch.Tensor, peer, slot) -> torch.Tensor:
    """``have`` with bit ``slot`` of row ``peer`` set (trace replay's
    single-delivery updates; ``peer`` and ``slot`` may be ints or scalar
    tensors)."""
    from .bits import to_i32
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


def is_compact(state: SimState) -> bool:
    """True when ``state`` is in the compact storage layout (its mesh
    plane packed into words)."""
    return state.mesh.dtype != torch.bool


def _encode_bf16(v: torch.Tensor, tick: torch.Tensor) -> torch.Tensor:
    bits = v.to(torch.bfloat16).view(torch.int16)
    qnan = torch.full_like(bits, _BF16_QNAN).masked_fill(torch.signbit(v),
                                                         _BF16_NEG_QNAN)
    return torch.where(torch.isnan(v), qnan, bits)


def _encode_tick16(v: torch.Tensor, tick: torch.Tensor) -> torch.Tensor:
    rel = (v - tick).clamp(-_TICK16_SAT, _TICK16_SAT)
    return rel.masked_fill(v == NEVER, _TICK16_NEVER).to(torch.int16)


def _encode_pack(v: torch.Tensor, tick: torch.Tensor) -> torch.Tensor:
    from .bits import pack_bool
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
        from .bits import unpack_bool
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


def _nbr_view(subscribed, neighbors):
    from . import kc
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


def init_state(cfg: SimConfig, topo,
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


