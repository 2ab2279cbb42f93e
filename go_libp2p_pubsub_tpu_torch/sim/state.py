"""Device-resident simulation state (PyTorch port of sim/state.py).

One ``SimState`` holds the whole N-peer network as tensors with the field
names, order, shapes and meaning of the reference's ``SimState`` (f32
layout; the compact storage codecs are not ported). Dtypes follow the
reference with one substitution: the reference's ``uint32`` planes
(``have``, ``fault_flags``) are int32 tensors holding the same bits
(ops/bits.py). :func:`state_from_reference` and :func:`state_to_numpy`
carry a state across the two packages.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..device import resolve_device
from .config import SimConfig
from .topology import Topology

NEVER = 2 ** 30          # sentinel for "never" ticks (int32)

# fields the reference stores as uint32 (the port: int32, same bits)
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


def _nbr_view(subscribed, neighbors):
    n = subscribed.shape[0]
    view = subscribed[neighbors.clamp(0, n - 1).long()].permute(0, 2, 1)
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
    unless the caller passes ``device="cpu"``)."""
    if cfg.state_precision != "f32":
        raise NotImplementedError(
            f"state_precision={cfg.state_precision!r}: the port carries the "
            "f32 layout only (the compact codecs: ROADMAP.md, Queue 1 "
            "item 5)")
    dev = resolve_device(device)
    n, k, t, m = cfg.n_peers, cfg.k_slots, cfg.n_topics, cfg.msg_window
    if subscribed is None:
        subscribed = np.ones((n, t), dtype=bool)
    if ip_group is None:
        ip_group = np.zeros(n, np.int32)
    if app_score is None:
        app_score = np.zeros(n, np.float32)
    if malicious is None:
        malicious = np.zeros(n, bool)

    def host(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype)).to(dev)

    def full(shape, fill, dtype):
        return torch.full(shape, fill, dtype=dtype, device=dev)

    i32, f32, b = torch.int32, torch.float32, torch.bool
    neighbors = host(topo.neighbors, np.int32)
    sub = host(subscribed, bool)
    return SimState(
        tick=full((), 0, i32),
        neighbors=neighbors,
        connected=neighbors >= 0,
        outbound=host(topo.outbound, bool),
        reverse_slot=host(topo.reverse_slot, np.int32),
        subscribed=sub,
        nbr_subscribed=_nbr_view(sub, neighbors),
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
    )


def state_from_reference(arrays: dict, device=None) -> SimState:
    """The reference package's ``SimState`` (as numpy arrays, one per field
    name: ``np.asarray(getattr(st, f))``) as the port's state on
    ``device``. uint32 planes become int32 tensors with the same bits."""
    dev = resolve_device(device)
    out = {}
    for f in SimState._fields:
        a = np.asarray(arrays[f])
        if f in U32_FIELDS:
            a = a.astype(np.uint32).view(np.int32)
        out[f] = torch.from_numpy(np.array(a)).to(dev)
    return SimState(**out)


def state_to_numpy(state: SimState) -> dict:
    """Field name -> numpy array in the reference's dtypes (inverse of
    :func:`state_from_reference`)."""
    out = {}
    for f in SimState._fields:
        a = getattr(state, f).detach().cpu().numpy()
        if f in U32_FIELDS:
            a = a.view(np.uint32)
        out[f] = a
    return out
