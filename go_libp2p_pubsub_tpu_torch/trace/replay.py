"""Trace replay: drive the batched engine's state from recorded trace events
(port of trace/replay.py).

A stream of TraceEvents (the tracer-bus dicts of the reference's host
runtime, a decoded PBTracer file, or ``sim/trace_export.py``'s export of a
batched run) is *tensorized* on the host into a flat op stream
(:class:`ReplayFeed`, host numpy, a copy of the reference's host half),
then *injected* into a ``SimState`` in trace order by :func:`replay`.
:func:`tensorize_trace_file` takes a PBTracer file straight to a feed,
through the native tensorizer (trace/native.py) where it builds.

The reference applies the stream with ``lax.scan`` + ``lax.switch``. The
op stream is host data here, so :func:`replay` dispatches each op's branch
in Python from the host copy, and what depends on the state stays on the
state's device: the slot lookup's first hit (``argmax``/``any``), the
retention branch's slot score, and every ``where(ok, ...)`` mask. No op
reads the device, and no op copies host data to it (indices are Python
ints in views; scalars are fills). ``lax.switch``'s clamp is kept: an op
code outside [0, N_OPS) runs the nearest end branch. Indices follow JAX's
semantics: a negative index counts from the end, a read clamps, a write
out of range is dropped.

The input state is never written: each field is copied the first time an
op writes it (a donated chunk's result, which is a captured graph's
static state, stays intact).

Time quantization, the P3 activation shift (:func:`replay_topic_params`)
and the scope limits are the reference's (its module docstring): grafts
record ``graft_tick = tick + 1``; behaviour-penalty events are not traced
by the reference's schema, so P7 replays only from synthetic PENALTY ops.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..sim.config import SimConfig, TopicParams
from ..sim.state import NEVER, SimState, is_compact
from . import events as ev

# primitive op codes (the reference's lax.switch branch index)
OP_NOP = 0
OP_DECAY = 1        # tick += 1, then refreshScores decay pass
OP_GRAFT = 2        # a=observer, b=peer, c=topic
OP_PRUNE = 3        # a=observer, b=peer, c=topic
OP_FIRST = 4        # first message delivery from b (score.go:920-947)
OP_DUP = 5          # in-window mesh duplicate from b (score.go:949-981)
OP_INVALID = 6      # invalid delivery from b (score.go:899-918)
OP_PENALTY = 7      # a=observer, b=peer, c=count (score.go:439 AddPenalty)
OP_JOIN = 8         # a=observer, c=topic
OP_LEAVE = 9
OP_PUBLISH = 10     # a=publisher, b=msg slot, c=topic
OP_DELIVER = 11     # a=observer, b=msg slot (local delivery bookkeeping)
OP_CONNECT = 12     # a=observer, b=peer (ADD_PEER)
OP_DISCONNECT = 13  # a=observer, b=peer (REMOVE_PEER, score.go:611-644)
N_OPS = 14

_SIG_REJECTS = frozenset({
    ev.REJECT_MISSING_SIGNATURE, ev.REJECT_INVALID_SIGNATURE,
    ev.REJECT_UNEXPECTED_SIGNATURE, ev.REJECT_UNEXPECTED_AUTH_INFO,
    ev.REJECT_SELF_ORIGIN,
})
_SILENT_REJECTS = frozenset({
    ev.REJECT_BLACKLISTED_PEER, ev.REJECT_BLACKLISTED_SOURCE,
    ev.REJECT_VALIDATION_QUEUE_FULL,
})

# delivery-record states (score.go:90-120)
_UNKNOWN, _VALID, _INVALID_ST, _THROTTLED, _IGNORED = range(5)


class ReplayFeed(NamedTuple):
    """Flat tensorized op stream + the mid -> slot assignment used."""

    op: np.ndarray      # [E] int32
    a: np.ndarray       # [E] int32
    b: np.ndarray       # [E] int32
    c: np.ndarray       # [E] int32
    mid_slot: dict      # message id -> slot index


def replay_topic_params(topics, heartbeat_interval: float = 1.0,
                        device=None) -> TopicParams:
    """TopicParams for replay on ``device`` (cuda unless the caller passes
    ``device="cpu"``): activation threshold shifted by -1 tick to
    compensate the graft-at-next-boundary convention (module docstring)."""
    tp = TopicParams.from_topic_params(topics, heartbeat_interval,
                                       device=device)
    return tp._replace(
        mesh_message_deliveries_activation_ticks=(
            tp.mesh_message_deliveries_activation_ticks - 1.0))


class _Record:
    __slots__ = ("status", "peers", "validated")

    def __init__(self):
        self.status = _UNKNOWN
        self.peers: list[str] = []      # insertion-ordered, deterministic
        self.validated = 0.0


def tensorize_trace(events: list[dict], peer_index: dict, topic_index: dict,
                    *, msg_window: int, decay_interval: float = 1.0,
                    dup_window=None, t_end: float | None = None) -> ReplayFeed:
    """Expand a trace-ordered event stream into primitive replay ops.

    events: tracer-bus dicts, globally ordered as emitted (a shared
    EventTracer preserves the true scheduler order; timestamp order is
    equivalent for distinct instants).
    dup_window: per-topic-index mesh_message_deliveries_window seconds
    (score_params.go:117-170); scalar or list; default 0 (same-instant only).
    t_end: run end time — trailing decay boundaries up to here are emitted.
    """
    t_count = len(topic_index)
    if dup_window is None:
        dup_window = [0.0] * t_count
    elif np.isscalar(dup_window):
        dup_window = [float(dup_window)] * t_count

    ops: list[tuple[int, int, int, int]] = []
    records: dict[tuple[str, str], _Record] = {}
    mid_slot: dict[str, int] = {}
    next_decay = decay_interval
    eps = 1e-9

    def slot_of(mid: str) -> int:
        s = mid_slot.get(mid)
        if s is None:
            s = len(mid_slot)
            if s >= msg_window:
                raise ValueError(
                    f"trace has more than msg_window={msg_window} message ids")
            mid_slot[mid] = s
        return s

    def rec_of(observer: str, mid: str) -> _Record:
        r = records.get((observer, mid))
        if r is None:
            r = _Record()
            records[(observer, mid)] = r
        return r

    for e in events:
        ts = e.get("timestamp", 0.0)
        while ts >= next_decay - eps:
            ops.append((OP_DECAY, 0, 0, 0))
            next_decay += decay_interval
        typ = e["type"]
        obs = e.get("peerID")
        ai = peer_index.get(obs, -1)
        if ai < 0:
            continue

        if typ == "GRAFT" or typ == "PRUNE":
            pl = e["graft" if typ == "GRAFT" else "prune"]
            bi = peer_index.get(pl["peerID"], -1)
            ci = topic_index.get(pl["topic"], -1)
            if bi >= 0 and ci >= 0:
                ops.append((OP_GRAFT if typ == "GRAFT" else OP_PRUNE,
                            ai, bi, ci))
        elif typ == "JOIN":
            ci = topic_index.get(e["join"]["topic"], -1)
            if ci >= 0:
                ops.append((OP_JOIN, ai, -1, ci))
        elif typ == "LEAVE":
            ci = topic_index.get(e["leave"]["topic"], -1)
            if ci >= 0:
                ops.append((OP_LEAVE, ai, -1, ci))
        elif typ == "ADD_PEER":
            bi = peer_index.get(e["addPeer"]["peerID"], -1)
            if bi >= 0:
                ops.append((OP_CONNECT, ai, bi, -1))
        elif typ == "REMOVE_PEER":
            bi = peer_index.get(e["removePeer"]["peerID"], -1)
            if bi >= 0:
                ops.append((OP_DISCONNECT, ai, bi, -1))
        elif typ == "PUBLISH_MESSAGE":
            pl = e["publishMessage"]
            ci = topic_index.get(pl.get("topic"), -1)
            if ci >= 0:
                ops.append((OP_PUBLISH, ai, slot_of(pl["messageID"]), ci))
        elif typ == "DELIVER_MESSAGE":
            pl = e["deliverMessage"]
            mid = pl["messageID"]
            ci = topic_index.get(pl.get("topic"), -1)
            rf = pl.get("receivedFrom")
            if ci < 0:
                continue
            sl = slot_of(mid)
            # the raw score hook is gated on received_from != observer
            # (trace/bus.py deliver_message; pubsub self-publish path)
            if rf is not None and rf != obs:
                bi = peer_index.get(rf, -1)
                if bi >= 0:
                    ops.append((OP_FIRST, ai, bi, ci))
                r = rec_of(obs, mid)
                if r.status == _UNKNOWN:
                    r.status = _VALID
                    r.validated = ts
                    # retro-credit duplicates that arrived during validation
                    # (score.go deliver: always in-window)
                    for p in r.peers:
                        if p != rf:
                            pi = peer_index.get(p, -1)
                            if pi >= 0:
                                ops.append((OP_DUP, ai, pi, ci))
            ops.append((OP_DELIVER, ai, sl, ci))
        elif typ == "DUPLICATE_MESSAGE":
            pl = e["duplicateMessage"]
            mid = pl["messageID"]
            ci = topic_index.get(pl.get("topic"), -1)
            rf = pl.get("receivedFrom")
            if ci < 0 or rf is None or rf == obs:
                continue
            r = rec_of(obs, mid)
            if rf in r.peers:
                continue
            if r.status == _UNKNOWN:
                r.peers.append(rf)
            elif r.status == _VALID:
                r.peers.append(rf)
                if ts - r.validated <= dup_window[ci]:
                    pi = peer_index.get(rf, -1)
                    if pi >= 0:
                        ops.append((OP_DUP, ai, pi, ci))
            elif r.status == _INVALID_ST:
                pi = peer_index.get(rf, -1)
                if pi >= 0:
                    ops.append((OP_INVALID, ai, pi, ci))
            # throttled/ignored: nothing
        elif typ == "REJECT_MESSAGE":
            pl = e["rejectMessage"]
            mid = pl["messageID"]
            ci = topic_index.get(pl.get("topic"), -1)
            rf = pl.get("receivedFrom")
            reason = pl.get("reason", "")
            if ci < 0 or rf is None or rf == obs:
                continue
            pi = peer_index.get(rf, -1)
            if reason in _SIG_REJECTS:
                if pi >= 0:
                    ops.append((OP_INVALID, ai, pi, ci))
                continue
            if reason in _SILENT_REJECTS:
                continue
            r = rec_of(obs, mid)
            if r.status != _UNKNOWN:
                continue
            if reason == ev.REJECT_VALIDATION_THROTTLED:
                r.status = _THROTTLED
                r.peers = []
            elif reason == ev.REJECT_VALIDATION_IGNORED:
                r.status = _IGNORED
                r.peers = []
            else:
                r.status = _INVALID_ST
                if pi >= 0:
                    ops.append((OP_INVALID, ai, pi, ci))
                for p in r.peers:
                    qi = peer_index.get(p, -1)
                    if qi >= 0:
                        ops.append((OP_INVALID, ai, qi, ci))
                r.peers = []

    if t_end is not None:
        while next_decay <= t_end + eps:
            ops.append((OP_DECAY, 0, 0, 0))
            next_decay += decay_interval

    if not ops:
        ops.append((OP_NOP, 0, 0, 0))
    arr = np.asarray(ops, dtype=np.int32)
    return ReplayFeed(op=arr[:, 0], a=arr[:, 1], b=arr[:, 2], c=arr[:, 3],
                      mid_slot=mid_slot)


def tensorize_trace_file(path: str, peer_index: dict, topic_index: dict,
                         **kw) -> ReplayFeed:
    """The :class:`ReplayFeed` of a PBTracer file (uvarint-delimited
    TraceEvents): the native tensorizer (trace/native.py), or, where its
    library cannot be built, the file decoded and tensorized by
    :func:`tensorize_trace`. Both give the same arrays; ``kw`` are
    :func:`tensorize_trace`'s."""
    from .native import tensorize_file
    return tensorize_file(path, peer_index, topic_index, **kw)


# --- injection into the state ---


def _norm(i: int, n: int) -> int:
    return i + n if i < 0 else i


def _rd(i: int, n: int) -> int:
    """A read index: JAX's gather clamps."""
    return min(max(_norm(i, n), 0), n - 1)


# the fields set_at/get_at index by a peer first
_PEER_ROWS = frozenset({"subscribed", "have", "deliver_tick"})


class _Injector:
    """The state's fields while a stream is applied: each written field is
    copied on its first write, then updated in place through views indexed
    by the op's Python ints and the device-side slot ``k``."""

    def __init__(self, state: SimState, cfg: SimConfig, tp: TopicParams):
        from ..parallel import kernel_context as kc

        self.f = state._asdict()
        self.own: set = set()
        self.cfg, self.tp = cfg, tp
        n, t, k = state.mesh.shape
        # inside a peer group the state holds rows [r0, r0 + n) of a
        # network of ng peers: an op on another rank's peer writes nothing
        # here, and reads of the group's rows come replicated
        self.n, self.t, self.kk = n, t, k
        self.r0, self.ng = kc.row0(), kc.global_rows(n)
        self.app_all = kc.replicate(state.app_score) \
            if cfg.app_specific_weight != 0.0 else state.app_score
        self.m = state.msg_topic.shape[0]
        self.k1 = None      # [1] int64 slot of the current op's lookup

    def row(self, a: int) -> int | None:
        """The local row of peer ``a`` (negative ids wrap over the whole
        network), None when another rank owns it or it is out of range."""
        i = _norm(a, self.ng) - self.r0
        return i if 0 <= i < self.n else None

    def rd(self, a: int) -> int:
        """The local row a read of peer ``a`` takes: the clamped global
        row, clamped again into this rank's rows (a read for a peer this
        rank does not own feeds only writes that are dropped)."""
        return min(max(_rd(a, self.ng) - self.r0, 0), self.n - 1)

    def state(self) -> SimState:
        return SimState(**self.f)

    def w(self, name: str) -> torch.Tensor:
        if name not in self.own:
            self.f[name] = self.f[name].clone()
            self.own.add(name)
        return self.f[name]

    def put(self, name: str, value: torch.Tensor) -> None:
        """A whole field replaced by a fresh tensor."""
        self.f[name] = value
        self.own.add(name)

    # ---- the slot lookup and per-slot reads/writes ------------------------

    def lookup(self, a: int, b: int) -> torch.Tensor:
        """Slot of peer b in observer a's neighbor table: sets ``k1`` (the
        first hit, 0 if none) and returns ``found`` (0-d bool)."""
        row = self.f["neighbors"][self.rd(a)]
        hit = row == b
        self.k1 = hit.to(torch.int32).argmax().reshape(1)
        found = hit.any()
        return found if b >= 0 else found & False

    def _ok_ac(self, a: int, c: int) -> bool:
        return self.row(a) is not None and 0 <= _norm(c, self.t) < self.t

    def get_ack(self, name: str, a: int, c: int) -> torch.Tensor:
        """x[a, c, k] as a [1] tensor."""
        return self.f[name][self.rd(a), _rd(c, self.t)].index_select(
            0, self.k1)

    def set_ack(self, name: str, a: int, c: int, v: torch.Tensor) -> None:
        if self._ok_ac(a, c):
            self.w(name)[self.row(a), _norm(c, self.t)].index_copy_(
                0, self.k1, v.to(self.f[name].dtype))

    def get_ak(self, name: str, a: int) -> torch.Tensor:
        """x[a, k] ([1]) of an [N, K] field, x[a, :, k] ([T, 1]) of an
        [N, T, K] one."""
        x = self.f[name][self.rd(a)]
        return x.index_select(x.dim() - 1, self.k1)

    def set_ak(self, name: str, a: int, v: torch.Tensor) -> None:
        if self.row(a) is not None:
            x = self.w(name)[self.row(a)]
            x.index_copy_(x.dim() - 1, self.k1, v.to(x.dtype))

    # ---- whole-element writes without a slot ----------------------------

    def set_at(self, name: str, idx: tuple, v) -> None:
        """x[idx] = v (a Python number or a 0-d tensor), dropped when an
        index is out of range."""
        x = self.f[name]
        norm = []
        if name in _PEER_ROWS:
            r = self.row(idx[0])
            if r is None:
                return
            norm.append(r)
            idx = idx[1:]
        for i, n in zip(idx, x.shape[len(norm):]):
            i = _norm(i, n)
            if not 0 <= i < n:
                return
            norm.append(i)
        x = self.w(name)
        view = x[tuple(norm[:-1])].narrow(0, norm[-1], 1)
        if isinstance(v, torch.Tensor):
            view.copy_(v.reshape(1))
        else:
            view.fill_(v)

    def get_at(self, name: str, idx: tuple) -> torch.Tensor:
        x = self.f[name]
        rd = [_rd(i, n) for i, n in zip(idx, x.shape)]
        if name in _PEER_ROWS:
            rd[0] = self.rd(idx[0])
        return x[tuple(rd[:-1])].narrow(0, rd[-1], 1)

    def have_set_bit(self, peer: int, slot: int) -> None:
        """``have`` with bit ``slot`` of row ``peer`` set (state.py's
        have_set_bit: a read of the clamped word, a dropped write)."""
        word, bit = slot // 32, slot % 32
        val = self.get_at("have", (peer, word)) | (
            (1 << bit) - (1 << 32 if bit == 31 else 0))
        self.set_at("have", (peer, word), val)

    def refresh_nbr_subscribed(self) -> None:
        from ..sim.state import _nbr_view
        self.put("nbr_subscribed", _nbr_view(self.f["subscribed"],
                                             self.f["neighbors"]))

    def slot_score(self, a: int) -> torch.Tensor:
        """Score of the peer in observer a's slot k (score.go:265-342), a
        [1] tensor: the retention branch of OP_DISCONNECT (score.go:614-618:
        positive scores are not retained)."""
        cfg, tp, f = self.cfg, self.tp, self.f
        col = self.get_ak
        in_mesh = col("mesh", a)
        zero = torch.zeros((), dtype=torch.float32, device=in_mesh.device)
        mesh_time = torch.where(
            in_mesh, (f["tick"] - col("graft_tick", a)).float(), zero)
        q = tp.time_in_mesh_quantum_ticks[:, None]
        p1 = torch.minimum(torch.floor(mesh_time / q + 1e-9),
                           tp.time_in_mesh_cap[:, None])
        t_score = torch.where(in_mesh, p1 * tp.time_in_mesh_weight[:, None],
                              zero)
        t_score = t_score + col("first_message_deliveries", a) * \
            tp.first_message_deliveries_weight[:, None]
        deficit = tp.mesh_message_deliveries_threshold[:, None] - \
            col("mesh_message_deliveries", a)
        p3 = torch.where(col("mesh_active", a) & (deficit > 0),
                         deficit * deficit, zero)
        t_score = t_score + p3 * tp.mesh_message_deliveries_weight[:, None]
        t_score = t_score + col("mesh_failure_penalty", a) * \
            tp.mesh_failure_penalty_weight[:, None]
        t_score = t_score + (col("invalid_message_deliveries", a) ** 2) * \
            tp.invalid_message_deliveries_weight[:, None]
        score = (t_score * tp.topic_weight[:, None]).sum(0)
        if cfg.topic_score_cap > 0:
            score = torch.clamp(score, max=cfg.topic_score_cap)
        if cfg.app_specific_weight != 0.0:
            nbr = col("neighbors", a).clamp(0, cfg.n_peers - 1)
            score = score + cfg.app_specific_weight * \
                self.app_all.index_select(0, nbr.long())
        if cfg.behaviour_penalty_weight != 0.0:
            excess = col("behaviour_penalty", a) - \
                cfg.behaviour_penalty_threshold
            score = score + torch.where(excess > 0, excess * excess, zero) \
                * cfg.behaviour_penalty_weight
        return score


# ---- the 14 branches (trace/replay.py:333-487) ------------------------------


def _nop(s: _Injector, a, b, c):
    pass


def _decay(s: _Injector, a, b, c):
    from ..ops.score_ops import decay_counters
    st = s.state()
    st = decay_counters(st._replace(tick=st.tick + 1), s.cfg, s.tp)
    for name in ("tick", "first_message_deliveries", "mesh_message_deliveries",
                 "mesh_failure_penalty", "invalid_message_deliveries",
                 "behaviour_penalty", "mesh_active"):
        s.put(name, getattr(st, name))


def _graft(s: _Injector, a, b, c):
    ok = s.lookup(a, b)
    # score.go:649-667 Graft: in_mesh, graft time = now, latch reset;
    # graft_tick = tick+1 (module docstring: next-boundary convention)
    s.set_ack("mesh", a, c, ok | s.get_ack("mesh", a, c))
    s.set_ack("graft_tick", a, c,
              torch.where(ok, s.f["tick"] + 1, s.get_ack("graft_tick", a, c)))
    s.set_ack("mesh_active", a, c,
              torch.where(ok, False, s.get_ack("mesh_active", a, c)))


def _prune(s: _Injector, a, b, c):
    ok = s.lookup(a, b)
    tp = s.tp
    # score.go:669-694 Prune: sticky penalty while the P3 latch is active
    # and under threshold; the latch itself is NOT cleared
    deficit = tp.mesh_message_deliveries_threshold[_rd(c, s.t)] - \
        s.get_ack("mesh_message_deliveries", a, c)
    zero = torch.zeros((), dtype=torch.float32, device=deficit.device)
    add = torch.where(ok & s.get_ack("mesh_active", a, c) & (deficit > 0),
                      deficit * deficit, zero)
    s.set_ack("mesh_failure_penalty", a, c,
              s.get_ack("mesh_failure_penalty", a, c) + add)
    s.set_ack("mesh", a, c, torch.where(ok, False, s.get_ack("mesh", a, c)))
    s.set_ack("backoff", a, c, torch.where(
        ok, s.f["tick"] + s.cfg.prune_backoff_ticks,
        s.get_ack("backoff", a, c)))


def _first(s: _Injector, a, b, c):
    ok = s.lookup(a, b)
    ok = ok & s.get_ak("connected", a)
    tp, cc = s.tp, _rd(c, s.t)
    fmd = s.get_ack("first_message_deliveries", a, c)
    mmd = s.get_ack("mesh_message_deliveries", a, c)
    in_mesh = ok & s.get_ack("mesh", a, c)
    s.set_ack("first_message_deliveries", a, c, torch.where(
        ok, torch.minimum(fmd + 1.0, tp.first_message_deliveries_cap[cc]),
        fmd))
    s.set_ack("mesh_message_deliveries", a, c, torch.where(
        in_mesh, torch.minimum(mmd + 1.0, tp.mesh_message_deliveries_cap[cc]),
        mmd))


def _dup(s: _Injector, a, b, c):
    ok = s.lookup(a, b)
    ok = ok & s.get_ak("connected", a) & s.get_ack("mesh", a, c)
    mmd = s.get_ack("mesh_message_deliveries", a, c)
    s.set_ack("mesh_message_deliveries", a, c, torch.where(
        ok, torch.minimum(mmd + 1.0,
                          s.tp.mesh_message_deliveries_cap[_rd(c, s.t)]),
        mmd))


def _invalid(s: _Injector, a, b, c):
    ok = s.lookup(a, b)
    ok = ok & s.get_ak("connected", a)
    imd = s.get_ack("invalid_message_deliveries", a, c)
    s.set_ack("invalid_message_deliveries", a, c, imd + ok.float())


def _penalty(s: _Injector, a, b, c):
    ok = s.lookup(a, b)
    bp = s.get_ak("behaviour_penalty", a)
    s.set_ak("behaviour_penalty", a, bp + torch.where(ok, float(c), 0.0))


def _join(s: _Injector, a, b, c):
    s.set_at("subscribed", (a, c), True)
    s.refresh_nbr_subscribed()


def _leave(s: _Injector, a, b, c):
    s.set_at("subscribed", (a, c), False)
    s.refresh_nbr_subscribed()


def _publish(s: _Injector, a, b, c):
    tick = s.f["tick"]
    s.set_at("msg_topic", (b,), c)
    s.set_at("msg_publish_tick", (b,), tick)
    s.have_set_bit(a, b)
    s.set_at("deliver_tick", (a, b), tick)


def _deliver(s: _Injector, a, b, c):
    s.have_set_bit(a, b)
    s.set_at("deliver_tick", (a, b), torch.minimum(
        s.get_at("deliver_tick", (a, b)), s.f["tick"]))


_COUNTERS = ("first_message_deliveries", "mesh_message_deliveries",
             "mesh_failure_penalty", "invalid_message_deliveries")


def _connect(s: _Injector, a, b, c):
    ok = s.lookup(a, b)
    expired = ok & (s.f["tick"] - s.get_ak("disconnect_tick", a)
                    > s.cfg.retain_score_ticks)
    for name in _COUNTERS:
        x = s.get_ak(name, a)
        s.set_ak(name, a, torch.where(expired, 0.0, x))
    s.set_ak("behaviour_penalty", a, torch.where(
        expired, 0.0, s.get_ak("behaviour_penalty", a)))
    s.set_ak("connected", a, ok | s.get_ak("connected", a))
    s.set_ak("disconnect_tick", a, torch.where(
        ok, NEVER, s.get_ak("disconnect_tick", a)))


def _disconnect(s: _Injector, a, b, c):
    ok = s.lookup(a, b)
    # score.go:611-644 RemovePeer: positive score -> stats dropped
    # outright; otherwise retention (FMD cleared, sticky P3b, frozen)
    drop = ok & (s.slot_score(a) > 0)
    retain = ok & ~drop
    zero = torch.zeros((), dtype=torch.float32, device=drop.device)
    mmd = s.get_ak("mesh_message_deliveries", a)
    deficit = s.tp.mesh_message_deliveries_threshold[:, None] - mmd
    sticky = torch.where(
        retain & s.get_ak("mesh", a) & s.get_ak("mesh_active", a)
        & (deficit > 0), deficit * deficit, zero)
    fmd = s.get_ak("first_message_deliveries", a)
    mfp = s.get_ak("mesh_failure_penalty", a)
    imd = s.get_ak("invalid_message_deliveries", a)
    s.set_ak("first_message_deliveries", a,
             torch.where(drop | retain, zero, fmd))
    s.set_ak("mesh_message_deliveries", a, torch.where(drop, zero, mmd))
    s.set_ak("mesh_failure_penalty", a, torch.where(drop, zero, mfp + sticky))
    s.set_ak("invalid_message_deliveries", a, torch.where(drop, zero, imd))
    s.set_ak("behaviour_penalty", a, torch.where(
        drop, zero, s.get_ak("behaviour_penalty", a)))
    for name in ("mesh", "fanout", "connected"):
        s.set_ak(name, a, torch.where(ok, False, s.get_ak(name, a)))
    s.set_ak("disconnect_tick", a, torch.where(
        ok, s.f["tick"], s.get_ak("disconnect_tick", a)))


BRANCHES = (_nop, _decay, _graft, _prune, _first, _dup, _invalid, _penalty,
            _join, _leave, _publish, _deliver, _connect, _disconnect)


def _host_ints(x) -> list:
    if isinstance(x, torch.Tensor):
        if x.device.type != "cpu":
            raise ValueError(
                "replay: the op stream is host data (numpy arrays or CPU "
                f"tensors); got a tensor on {x.device}, whose read would "
                "synchronize with the device")
        x = x.numpy()
    return np.asarray(x).astype(np.int64).reshape(-1).tolist()


def replay(state: SimState, cfg: SimConfig, tp: TopicParams, op, a, b,
           c) -> SimState:
    """Inject a tensorized op stream into the state, in trace order, on the
    state's device; the input state is left as it was. ``op``/``a``/``b``/
    ``c`` are host arrays of one length."""
    if is_compact(state):
        raise ValueError(
            "replay: the state is stored compact (state_precision="
            "'compact'); replay writes the f32 layout — decode_state it "
            "first")
    ops, aa, bb, cc = (_host_ints(x) for x in (op, a, b, c))
    if not len(ops) == len(aa) == len(bb) == len(cc):
        raise ValueError("replay: op, a, b and c differ in length")
    inj = _Injector(state, cfg, tp)
    last = N_OPS - 1
    for o, i, j, t in zip(ops, aa, bb, cc):
        # lax.switch's clamp: an out-of-range code runs the nearest end
        BRANCHES[min(max(o, 0), last)](inj, i, j, t)
    return inj.state()


def replay_feed(state: SimState, cfg: SimConfig, tp: TopicParams,
                feed: ReplayFeed) -> SimState:
    return replay(state, cfg, tp, feed.op, feed.a, feed.b, feed.c)
