"""Live command plane: bounded host->device directive ingestion (port of
sim/commands.py).

An NDJSON directive stream (publish / join / leave / attack windows) is
validated on the host, coalesced per supervised chunk into fixed-shape op
frames and injected at the chunk boundaries through ``trace/replay.py``:

- **refusal by name**: every malformed or out-of-range directive line is
  refused with a :class:`DirectiveError` naming the field; refusals are
  journaled (``directive_refused``) and consumed: the stream offset
  advances past them, so a resumed run re-refuses identically instead of
  replaying garbage.
- **admission control**: each chunk gets at most ``slots`` primitive ops.
  Offered load beyond the slot budget is shed deterministically by stream
  position, never a crash; the shed count is journaled per chunk and
  totalled in the terminal marker.
- **coast mode**: the chunk-boundary drain waits for the stream's tick
  watermark to cover the chunk. When the producer goes silent past
  ``stall_timeout_s`` the run coasts: the card keeps stepping with empty
  frames, the journal gets an ``ingest_stalled`` marker carrying the
  consumed offset and the producer-restart command, and each coasting
  boundary throttles by ``coast_poll_s``. New bytes end the episode
  (``ingest_resumed``).
- **exactly-once resume**: frames consume a contiguous prefix of the
  stream (shed and refused lines included), so one byte offset is a
  complete ingestion cursor. The supervisor stamps it into every
  checkpoint sidecar (``stream_offset=``) and seeks the queue there on
  resume, applying every directive exactly once.

The parser and queue are host code, copied from the reference.
:func:`apply_frame` runs the frame through the port's ``trace.replay``
(its op codes dispatched on the host, its updates on the state's device,
the input state never written) and the attack lanes through
:func:`_attack_pass`; inside a peer group each rank applies the frame to
its own rows. The multi-process wrapper :class:`BroadcastCommands` has
rank 0 drain the stream and broadcast each frame to every rank.

Directive grammar (one JSON object per line)::

    {"op": "publish", "tick": T, "peer": P, "topic": C}
    {"op": "join",    "tick": T, "peer": P, "topic": C}
    {"op": "leave",   "tick": T, "peer": P, "topic": C}
    {"op": "attack",  "tick": T, "kind": "storm", "topic": C,
     "peers": [P0, P1, ...]}        # coordinated publish storm
    {"op": "attack",  "tick": T, "kind": "eclipse",
     "peers": [P0, ...]}            # cut targets' honest<->honest edges
    {"op": "attack",  "tick": T, "kind": "censor",
     "peers": [P0, ...]}            # flip peers into censoring actors
    {"op": "compose", "tick": T, "parts": [{...}, ...]}
                                    # several tickless parts, one boundary
    {"op": "tick", "tick": T}       # watermark only: "stream covers < T"
    {"op": "end"}                   # producer finished (clean EOF)

``tick`` is optional (default: apply at the next drained boundary, live
mode, outside the bit-exact contract); timed directives apply at the
boundary of the chunk containing their tick. Producers should emit
non-decreasing ticks: a directive behind a later-tick line still applies
(prefix consumption), just late (journaled ``lag_ticks``). Recorded trace
events feed the same queue: JOIN/LEAVE/PUBLISH_MESSAGE events map to
directives (``timestamp``->tick via ``heartbeat_interval``), other event
types are counted and skipped (``directive_skipped``: they describe
router internals the engine derives itself).
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
from typing import NamedTuple

import numpy as np

# primitive op codes: trace/replay.py's (asserted by
# tests/test_torch_commands.py)
OP_NOP = 0
OP_JOIN = 8
OP_LEAVE = 9
OP_PUBLISH = 10

# command-plane-only op codes: deliberately OUTSIDE replay's op space
# [0, N_OPS=14): apply_frame masks them to NOP before the replay (its
# clamp would run them as DISCONNECT otherwise) and routes them through
# the attack pass instead
ATTACK_OP_BASE = 16
OP_ECLIPSE = 16     # a=target peer: cut its honest<->honest edges
OP_CENSOR = 17      # a=peer: flip it into a censoring spam actor

# trace-event types that map onto live directives; everything else in
# the L5 schema is router bookkeeping the engine derives itself
_TRACE_OPS = {"JOIN": "join", "LEAVE": "leave", "PUBLISH_MESSAGE": "publish"}


class DirectiveError(ValueError):
    """A directive line was refused BY NAME (malformed JSON, unknown op,
    out-of-range peer/topic, oversized batch). Refused lines are
    journaled and consumed — never a crash, never a retrace."""


class Parsed(NamedTuple):
    """One accepted line: primitive ``(kind, peer, topic)`` ops (empty
    for watermark/end lines), the apply tick (-1 = next boundary), and
    what the line was (``directive``/``trace``/``tick``/``end``)."""

    ops: tuple
    tick: int
    kind: str


def _int_field(d: dict, name: str, lo: int, hi: int, what: str) -> int:
    v = d.get(name)
    if not isinstance(v, int) or isinstance(v, bool):
        raise DirectiveError(
            f"directive {what!r}: field {name!r} must be an integer, got "
            f"{v!r}")
    if not lo <= v < hi:
        raise DirectiveError(
            f"directive {what!r}: {name}={v} out of range [{lo}, {hi})")
    return v


def _tick_of(d: dict, what: str) -> int:
    v = d.get("tick", -1)
    if not isinstance(v, int) or isinstance(v, bool) or v < -1:
        raise DirectiveError(
            f"directive {what!r}: tick must be a non-negative integer "
            f"(or absent for apply-on-arrival), got {v!r}")
    return v


def parse_line(line, *, n_peers: int, n_topics: int,
               max_batch: int = 256, peer_index: dict | None = None,
               topic_index: dict | None = None,
               heartbeat_interval: float = 1.0) -> Parsed:
    """Parse one NDJSON line into primitive ops; raises
    :class:`DirectiveError` naming the offence on anything malformed.
    Accepts both the directive grammar and recorded trace events
    (module docstring); unsupported trace types return an empty
    ``Parsed(kind="skip:<TYPE>")`` so callers can count them."""
    if isinstance(line, bytes):
        try:
            line = line.decode()
        except UnicodeDecodeError as e:
            raise DirectiveError(f"directive line is not UTF-8: {e}") from e
    line = line.strip()
    if not line:
        return Parsed((), -1, "blank")
    try:
        d = json.loads(line)
    except json.JSONDecodeError as e:
        raise DirectiveError(
            f"directive line is not valid JSON: {e} — {line[:80]!r}") from e
    if not isinstance(d, dict):
        raise DirectiveError(
            f"directive line must be a JSON object, got "
            f"{type(d).__name__}")

    if "type" in d and "op" not in d:       # recorded trace event (L5)
        return _parse_trace_event(d, n_peers=n_peers, n_topics=n_topics,
                                  peer_index=peer_index,
                                  topic_index=topic_index,
                                  heartbeat_interval=heartbeat_interval)

    op = d.get("op")
    if op == "end":
        return Parsed((), -1, "end")
    if op == "tick":
        t = _tick_of(d, "tick")
        if t < 0:
            raise DirectiveError(
                "directive 'tick': a watermark line requires an explicit "
                "non-negative tick")
        return Parsed((), t, "tick")
    if op in ("publish", "join", "leave"):
        p = _int_field(d, "peer", 0, n_peers, op)
        c = _int_field(d, "topic", 0, n_topics, op)
        return Parsed(((op, p, c),), _tick_of(d, op), "directive")
    if op == "attack":
        ops = _attack_ops(d, n_peers=n_peers, n_topics=n_topics,
                          max_batch=max_batch)
        return Parsed(tuple(ops), _tick_of(d, "attack"), "directive")
    if op == "compose":
        ops = _compose_ops(d, n_peers=n_peers, n_topics=n_topics,
                           max_batch=max_batch)
        return Parsed(tuple(ops), _tick_of(d, "compose"), "directive")
    raise DirectiveError(
        f"directive op {op!r} unknown (supported: publish, join, leave, "
        "attack, compose, tick, end)")


_ATTACK_KINDS = ("storm", "eclipse", "censor")


def _attack_ops(d: dict, *, n_peers: int, n_topics: int,
                max_batch: int) -> list:
    """The ``attack`` directive body shared by the top-level line and
    ``compose`` parts: kind + peers → primitive ops, every malformation
    refused BY NAME."""
    kind = d.get("kind")
    if kind not in _ATTACK_KINDS:
        raise DirectiveError(
            f"directive 'attack': unknown kind {kind!r} (supported: "
            "'storm' — a coordinated publish storm from the listed "
            "peers; 'eclipse' — cut the listed targets' honest edges; "
            "'censor' — flip the listed peers into censoring spam "
            "actors; combine kinds with op 'compose')")
    if kind == "storm":
        c = _int_field(d, "topic", 0, n_topics, "attack")
    else:
        if "topic" in d:
            raise DirectiveError(
                f"directive 'attack': kind {kind!r} takes no 'topic' "
                "field (it acts on peers, not a topic)")
        c = 0
    peers = d.get("peers")
    if not isinstance(peers, list) or not peers:
        raise DirectiveError(
            "directive 'attack': field 'peers' must be a non-empty "
            "list of peer ids")
    if len(peers) > max_batch:
        raise DirectiveError(
            f"directive 'attack': batch of {len(peers)} peers exceeds "
            f"max_batch={max_batch} — split the window into smaller "
            "directives")
    prim = {"storm": "publish", "eclipse": "eclipse",
            "censor": "censor"}[kind]
    ops = []
    for p in peers:
        if not isinstance(p, int) or isinstance(p, bool) \
                or not 0 <= p < n_peers:
            raise DirectiveError(
                f"directive 'attack': peer {p!r} out of range "
                f"[0, {n_peers})")
        ops.append((prim, p, c))
    return ops


def _compose_ops(d: dict, *, n_peers: int, n_topics: int,
                 max_batch: int) -> list:
    """The ``compose`` form: one timed line carrying several directive
    parts that land at the SAME boundary (composed attack scenarios:
    eclipse+censorship on one region, storms against the gater's RED
    admission). Parts are ordinary
    directive objects WITHOUT their own tick; nesting is refused."""
    parts = d.get("parts")
    if not isinstance(parts, list) or not parts:
        raise DirectiveError(
            "directive 'compose': field 'parts' must be a non-empty "
            "list of directive objects")
    ops: list = []
    for i, part in enumerate(parts):
        if not isinstance(part, dict):
            raise DirectiveError(
                f"directive 'compose': part {i} must be a JSON object, "
                f"got {type(part).__name__}")
        if "tick" in part:
            raise DirectiveError(
                f"directive 'compose': part {i} must not carry its own "
                "tick — the compose line's tick times every part")
        pop = part.get("op")
        if pop == "compose":
            raise DirectiveError(
                "directive 'compose': parts cannot nest another compose")
        if pop in ("publish", "join", "leave"):
            p = _int_field(part, "peer", 0, n_peers, pop)
            c = _int_field(part, "topic", 0, n_topics, pop)
            ops.append((pop, p, c))
        elif pop == "attack":
            ops.extend(_attack_ops(part, n_peers=n_peers,
                                   n_topics=n_topics,
                                   max_batch=max_batch))
        else:
            raise DirectiveError(
                f"directive 'compose': part {i} op {pop!r} unknown "
                "(supported parts: publish, join, leave, attack)")
    if len(ops) > max_batch:
        raise DirectiveError(
            f"directive 'compose': {len(ops)} primitive ops exceed "
            f"max_batch={max_batch} — split the scenario into smaller "
            "compose lines")
    return ops


def _parse_trace_event(d: dict, *, n_peers: int, n_topics: int,
                       peer_index, topic_index,
                       heartbeat_interval: float) -> Parsed:
    typ = d.get("type")
    if not isinstance(typ, str):
        raise DirectiveError(
            f"trace event field 'type' must be a string, got {typ!r}")
    mapped = _TRACE_OPS.get(typ)
    if mapped is None:
        return Parsed((), -1, f"skip:{typ}")
    ts = d.get("timestamp", 0.0)
    if not isinstance(ts, (int, float)) or isinstance(ts, bool):
        raise DirectiveError(
            f"trace event {typ!r}: timestamp must be a number, got {ts!r}")
    tick = max(0, int(float(ts) / max(heartbeat_interval, 1e-9)))

    def _peer(v):
        if peer_index is not None:
            if v not in peer_index:
                raise DirectiveError(
                    f"trace event {typ!r}: peer {v!r} not in peer_index")
            return int(peer_index[v])
        try:
            p = int(v)
        except (TypeError, ValueError):
            raise DirectiveError(
                f"trace event {typ!r}: peer id {v!r} is not an integer "
                "and no peer_index was provided") from None
        if not 0 <= p < n_peers:
            raise DirectiveError(
                f"trace event {typ!r}: peer {p} out of range "
                f"[0, {n_peers})")
        return p

    def _topic(v):
        if topic_index is not None:
            if v not in topic_index:
                raise DirectiveError(
                    f"trace event {typ!r}: topic {v!r} not in topic_index")
            return int(topic_index[v])
        try:
            c = int(v)
        except (TypeError, ValueError):
            raise DirectiveError(
                f"trace event {typ!r}: topic {v!r} is not an integer and "
                "no topic_index was provided") from None
        if not 0 <= c < n_topics:
            raise DirectiveError(
                f"trace event {typ!r}: topic {c} out of range "
                f"[0, {n_topics})")
        return c

    pl_key = {"JOIN": "join", "LEAVE": "leave",
              "PUBLISH_MESSAGE": "publishMessage"}[typ]
    pl = d.get(pl_key) or {}
    peer = _peer(d.get("peerID"))
    topic = _topic(pl.get("topic"))
    return Parsed(((mapped, peer, topic),), tick, "trace")


class Frame(NamedTuple):
    """One chunk's coalesced directive tensors + host-side ingest vitals.
    ``op/a/b/c`` are ``[slots]`` int32 (NOP-padded) — the fixed traced
    shape every chunk shares. ``offset`` is the consumed stream cursor
    AFTER this frame (the exactly-once stamp); ``notes`` are journal
    events accumulated since the previous frame, submitted by the
    supervisor only after the chunk that carried them confirmed."""

    op: np.ndarray
    a: np.ndarray
    b: np.ndarray
    c: np.ndarray
    count: int              # ops applied this frame
    shed: int               # ops shed this frame
    shed_total: int
    refused_total: int
    applied_total: int
    offset: int             # consumed stream byte offset after this frame
    lag: int                # worst (chunk_start - directive tick) applied
    depth: int              # queued directive lines after the drain
    coasting: bool
    notes: tuple            # ((kind, meta-dict), ...) for the journal


def empty_frame(slots: int, *, offset: int = 0, coasting: bool = False,
                notes: tuple = ()) -> Frame:
    z = np.zeros(int(slots), np.int32)
    return Frame(op=z, a=z.copy(), b=z.copy(), c=z.copy(), count=0, shed=0,
                 shed_total=0, refused_total=0, applied_total=0,
                 offset=int(offset), lag=0, depth=0, coasting=coasting,
                 notes=notes)


def apply_frame(state, cfg, tp, frame: Frame):
    """Inject a frame into the state through trace/replay.py's
    :func:`~..trace.replay.replay`: join/leave flip ``subscribed`` and
    refresh the neighbour view, publish seeds the message ring. The input
    state is never written (replay copies a field on its first write; the
    attack pass builds new tensors), so a frame applied to a donated
    chunk's result leaves the graph's static buffers as they were.

    Attack lanes (``op >= ATTACK_OP_BASE``) live outside replay's op
    space, so they are masked to NOP before the replay and routed through
    :func:`_attack_pass`, which runs only on frames that carry them."""
    from ..trace.replay import replay
    op_h = np.asarray(frame.op)
    has_attack = bool((op_h >= ATTACK_OP_BASE).any())
    rep_op = np.where(op_h >= ATTACK_OP_BASE,
                      np.int32(OP_NOP), op_h) if has_attack else op_h
    state = replay(state, cfg, tp, rep_op, frame.a, frame.b, frame.c)
    if has_attack:
        state = _attack_pass(state, cfg, tp, op_h, np.asarray(frame.a))
    return state


def _attack_pass(state, cfg, tp, op: np.ndarray, a: np.ndarray):
    """The OP_ECLIPSE/OP_CENSOR lanes of a frame (host arrays).

    Censor flips the listed peers into spam actors (``state.malicious``:
    they answer no IWANTs and are counted by faults.attacker_mask, so
    ScoreResponse contracts see them). Eclipse cuts every honest<->honest
    edge crossing the target boundary through churn's take_edges_down: the
    edge-symmetric construction of faults.edge_cut_mask, driven by the
    directive's peer list instead of a prefix fraction. Sybil edges stay
    up: an eclipsed peer keeps its attacker links.

    The lane masks are filled on the device from the host's peer ids (no
    host-to-device copy, no read)."""
    import torch

    from ..ops.churn import take_edges_down
    from .invariants import FAULT_CENSOR, FAULT_ECLIPSE

    from ..parallel import kernel_context as kc

    # the lane masks cover every peer; inside a peer group this rank keeps
    # its rows of them and reads its neighbours' flags from the group
    nl = state.neighbors.shape[0]
    n, r0 = kc.global_rows(nl), kc.row0()
    dev = state.neighbors.device
    lanes = np.clip(a.astype(np.int64), 0, n - 1)

    def mask(kind: int):
        m = torch.zeros(n, dtype=torch.bool, device=dev)
        peers = sorted(set(lanes[op == kind].tolist()))
        for p in peers:
            m.narrow(0, p, 1).fill_(True)
        return m, bool(peers)

    tgt, any_ecl = mask(OP_ECLIPSE)
    coh, any_cen = mask(OP_CENSOR)
    malicious = kc.replicate(state.malicious) | coh
    honest = ~malicious
    known = (state.neighbors >= 0) & (state.reverse_slot >= 0)
    nbr = state.neighbors.clamp(0, n - 1).long()
    mine = slice(r0, r0 + nl)
    cross = ((tgt[mine, None] ^ tgt[nbr])
             & honest[mine, None] & honest[nbr] & known)
    go_down = cross & state.connected & any_ecl
    state = state._replace(malicious=malicious[mine])
    state = take_edges_down(state, cfg, tp, go_down)
    bits = (FAULT_ECLIPSE if any_ecl else 0) | (FAULT_CENSOR if any_cen else 0)
    return state._replace(fault_flags=state.fault_flags | bits)


class _Entry(NamedTuple):
    tick: int
    ops: tuple
    offset: int             # stream offset after this line


class CommandQueue:
    """Bounded directive ingestion from an NDJSON stream (module
    docstring). A reader thread tails ``source`` from the resume offset,
    refusing malformed lines by name and enqueueing valid ones into a
    bounded deque — a full queue blocks the reader (producer
    backpressure: memory stays bounded however far the producer runs
    ahead; through a FIFO the pause reaches the producer as real pipe
    backpressure). ``frame_for`` drains a contiguous stream prefix at
    each chunk boundary into a fixed-``slots`` :class:`Frame`.

    ``chaos`` (parallel/resilience.ChaosPlan) drills the degradation
    paths: its ingest drills pause or kill the reader at a boundary."""

    def __init__(self, source: str, *, n_peers: int, n_topics: int,
                 msg_window: int, slots: int = 64, maxlen: int = 4096,
                 stall_timeout_s: float = 10.0, coast_poll_s: float = 0.05,
                 follow: bool = True, max_batch: int = 256,
                 peer_index: dict | None = None,
                 topic_index: dict | None = None,
                 heartbeat_interval: float = 1.0, chaos=None,
                 poll_s: float = 0.02):
        if slots < 1:
            raise ValueError(f"CommandQueue: slots={slots} must be >= 1")
        self.source = source
        self.n_peers = int(n_peers)
        self.n_topics = int(n_topics)
        self.msg_window = int(msg_window)
        self.slots = int(slots)
        self.maxlen = int(maxlen)
        self.stall_timeout_s = float(stall_timeout_s)
        self.coast_poll_s = float(coast_poll_s)
        self.follow = follow
        self.max_batch = int(max_batch)
        self.peer_index = peer_index
        self.topic_index = topic_index
        self.heartbeat_interval = float(heartbeat_interval)
        self._poll_s = float(poll_s)
        self._chaos = chaos
        self._pause_until = 0.0     # chaos ingest_stall
        self._killed = False        # chaos ingest_kill

        self._cond = threading.Condition()
        self._q: collections.deque = collections.deque()
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        self._eof = False
        self._primed = False        # reader has parsed >= 1 line
        self._watermark = -1        # highest timed tick parsed
        self._clean_offset = 0      # offset after the last parsed line
        self._consumed = 0          # offset after the last drained line
        self._last_progress = time.monotonic()
        self._coasting = False
        self._notes: list = []
        self._frames: collections.OrderedDict = collections.OrderedDict()
        self.refused_total = 0
        self.skipped_total = 0
        self.shed_total = 0
        self.applied_total = 0

    # ---- lifecycle --------------------------------------------------------

    def start(self, offset: int = 0) -> "CommandQueue":
        """Begin tailing at ``offset`` (the checkpoint's stamped
        ``stream_offset`` on resume; 0 for a fresh run)."""
        if self._thread is not None:
            return self
        self._consumed = self._clean_offset = int(offset)
        self._last_progress = time.monotonic()
        self._thread = threading.Thread(target=self._read_loop, daemon=True,
                                        name="graft-ingest")
        self._thread.start()
        return self

    def close(self) -> None:
        self._stop.set()
        with self._cond:
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    @property
    def consumed_offset(self) -> int:
        return self._consumed

    @property
    def stalled(self) -> bool:
        return self._coasting

    def resume_cmd(self, offset: int) -> str:
        """The producer-restart command of record (the dashboard's
        COASTING banner surfaces this verbatim): at a stall the consumed
        offset equals the producer's durable progress — the queue only
        reports a stall once it has drained every written byte."""
        return (f"python -m go_libp2p_pubsub_tpu_torch.directive_producer "
                f"--stream <input> --out {self.source} "
                f"--from-offset {offset}")

    # ---- chaos hooks (parallel/resilience.ChaosPlan) ----------------------

    def pause_reader(self, seconds: float) -> None:
        self._pause_until = time.monotonic() + float(seconds)

    def kill_reader(self) -> None:
        self._killed = True

    # ---- reader thread ----------------------------------------------------

    def _read_loop(self) -> None:
        fh = None
        pos = self._clean_offset
        try:
            while not self._stop.is_set():
                if self._killed:
                    return
                if time.monotonic() < self._pause_until:
                    time.sleep(self._poll_s)
                    continue
                if fh is None:
                    try:
                        fh = open(self.source, "rb")
                        fh.seek(pos)
                    except OSError:
                        time.sleep(self._poll_s)
                        continue
                line = fh.readline()
                if not line or not line.endswith(b"\n"):
                    # torn tail mid-append rides to the next poll; plain
                    # EOF only ends a non-follow stream
                    fh.seek(pos)
                    if not self.follow and not line:
                        with self._cond:
                            self._eof = True
                            self._cond.notify_all()
                        return
                    time.sleep(self._poll_s)
                    continue
                pos += len(line)
                self._ingest_line(line, pos)
                if self._eof:
                    return
        finally:
            if fh is not None:
                try:
                    fh.close()
                except OSError:
                    pass

    def _ingest_line(self, line: bytes, offset_after: int) -> None:
        try:
            parsed = parse_line(
                line, n_peers=self.n_peers, n_topics=self.n_topics,
                max_batch=self.max_batch, peer_index=self.peer_index,
                topic_index=self.topic_index,
                heartbeat_interval=self.heartbeat_interval)
        except DirectiveError as e:
            with self._cond:
                self._primed = True
                self.refused_total += 1
                self._notes.append(("directive_refused",
                                    {"reason": str(e)[:200],
                                     "offset": offset_after}))
                self._clean_offset = offset_after
                self._last_progress = time.monotonic()
                self._cond.notify_all()
            return
        with self._cond:
            self._primed = True
            self._last_progress = time.monotonic()
            if parsed.kind == "end":
                self._eof = True
                self._clean_offset = offset_after
                self._cond.notify_all()
                return
            if parsed.kind.startswith("skip:"):
                self.skipped_total += 1
                self._notes.append(("directive_skipped",
                                    {"type": parsed.kind[5:],
                                     "offset": offset_after}))
                self._clean_offset = offset_after
                self._cond.notify_all()
                return
            if parsed.tick >= 0:
                self._watermark = max(self._watermark, parsed.tick)
            if parsed.ops:
                while len(self._q) >= self.maxlen \
                        and not self._stop.is_set():
                    # producer backpressure: bounded memory — the drain
                    # frees slots and notifies
                    self._cond.wait(0.2)
                self._q.append(_Entry(parsed.tick, parsed.ops,
                                      offset_after))
            # watermark/blank lines advance the consumable offset only
            # once nothing queued precedes them (prefix discipline is
            # enforced at drain time via entry offsets)
            self._clean_offset = offset_after
            self._cond.notify_all()

    # ---- chunk-boundary drain ---------------------------------------------

    def frame_for(self, chunk_start: int, chunk_ticks: int) -> Frame:
        """The boundary drain: a contiguous stream prefix of directives
        due before ``chunk_start + chunk_ticks``, coalesced into the
        fixed-shape frame (admission-controlled, overflow shed), cached
        by ``chunk_start`` so retries and speculation re-fetch the SAME
        frame instead of draining twice."""
        cached = self._frames.get(int(chunk_start))
        if cached is not None:
            return cached
        if self._chaos is not None:
            try:
                self._chaos.fire_ingest(int(chunk_start), self)
            except Exception:
                pass        # chaos drills must never fail the run
        chunk_end = int(chunk_start) + int(chunk_ticks)
        frame = self._drain(int(chunk_start), chunk_end)
        self._frames[int(chunk_start)] = frame
        while len(self._frames) > 8:
            self._frames.popitem(last=False)
        return frame

    def _covered(self, chunk_end: int) -> bool:
        """The stream is known complete for this chunk: EOF, or the tick
        watermark proves every directive before ``chunk_end`` arrived
        (requires non-decreasing producer ticks). An UNTIMED stream —
        primed, watermark still -1 — never blocks; an unread one (the
        reader hasn't parsed a single line yet) is indistinguishable
        from a slow producer and must wait, not free-run."""
        if self._eof:
            return True
        if not self._primed:
            return False
        return self._watermark < 0 or self._watermark >= chunk_end

    def _drain(self, chunk_start: int, chunk_end: int) -> Frame:
        with self._cond:
            while not self._covered(chunk_end) and not self._stop.is_set():
                idle = time.monotonic() - self._last_progress
                if self._coasting and idle < self.stall_timeout_s:
                    # new bytes since the stall: the episode is over —
                    # resume the blocking discipline so directives due
                    # THIS chunk still land on time
                    self._coasting = False
                    self._notes.append(("ingest_resumed",
                                        {"tick": chunk_start,
                                         "offset": self._offset_now()}))
                    continue
                if self._coasting:
                    break       # still silent: keep coasting
                if idle >= self.stall_timeout_s:
                    self._coasting = True
                    off = self._offset_now()
                    self._notes.append((
                        "ingest_stalled",
                        {"tick": chunk_start, "offset": off,
                         "source": self.source,
                         "resume_cmd": self.resume_cmd(off)}))
                    break
                self._cond.wait(min(0.1, self.stall_timeout_s - idle
                                    + 0.01))
            if self._coasting and self._covered(chunk_end):
                # the stream caught up (or hit EOF) while we coasted
                self._coasting = False
                self._notes.append(("ingest_resumed",
                                    {"tick": chunk_start,
                                     "offset": self._offset_now()}))

            ops: list = []
            shed = 0
            lag = 0
            while self._q and self._q[0].tick < chunk_end:
                e = self._q.popleft()
                if e.tick >= 0:
                    lag = max(lag, chunk_start - e.tick)
                for prim in e.ops:
                    if len(ops) < self.slots:
                        ops.append(prim)
                    else:
                        shed += 1
                self._consumed = e.offset
                self._cond.notify_all()     # free backpressured reader
            if not self._q:
                # nothing queued precedes the reader head: watermark,
                # refused, and skipped lines are consumed too
                self._consumed = max(self._consumed, self._clean_offset)
            self.shed_total += shed
            self.applied_total += len(ops)
            if shed:
                self._notes.append(("ingest_shed",
                                    {"tick": chunk_start, "shed": shed,
                                     "slots": self.slots}))
            notes, self._notes = tuple(self._notes), []
            depth = len(self._q)
            coasting = self._coasting
            offset = self._consumed

        op = np.zeros(self.slots, np.int32)
        a = np.zeros(self.slots, np.int32)
        b = np.zeros(self.slots, np.int32)
        c = np.zeros(self.slots, np.int32)
        for i, (kind, peer, topic) in enumerate(ops):
            a[i] = peer
            c[i] = topic
            if kind == "publish":
                op[i] = OP_PUBLISH
                # deterministic ring slot: a pure function of (boundary,
                # frame position) — resume-safe with no extra cursor;
                # collisions recycle the oldest window entry, the
                # engine's own msg-ring semantics
                op_b = (chunk_start * self.slots + i) % self.msg_window
                b[i] = op_b
            elif kind == "eclipse":
                op[i] = OP_ECLIPSE
                b[i] = -1
            elif kind == "censor":
                op[i] = OP_CENSOR
                b[i] = -1
            else:
                op[i] = OP_JOIN if kind == "join" else OP_LEAVE
                b[i] = -1
        if coasting:
            time.sleep(self.coast_poll_s)   # coast-mode pacing
        return Frame(op=op, a=a, b=b, c=c, count=len(ops), shed=shed,
                     shed_total=self.shed_total,
                     refused_total=self.refused_total,
                     applied_total=self.applied_total, offset=int(offset),
                     lag=int(lag), depth=depth, coasting=coasting,
                     notes=notes)

    def _offset_now(self) -> int:
        # producer-restart cursor: everything durably PARSED is on disk
        # in the source file, so a producer resuming the feed appends
        # after the last complete line — distinct from ``Frame.offset``
        # (the consumer cursor checkpoints stamp), which only advances
        # as entries drain into frames
        return self._clean_offset

    # the supervisor's apply hook (one shared implementation)
    apply = staticmethod(apply_frame)


class BroadcastCommands:
    """The multi-process wrapper (commands.py:831-896): rank 0 owns the real
    :class:`CommandQueue`; every rank calls ``frame_for`` at the same
    boundary, and rank 0's frame goes to every rank as two fixed-shape
    broadcasts (the ``[4, slots]`` int32 lanes and an int64 meta vector),
    so every rank applies the same directives to its own rows. A frame is
    cached after its broadcast: a repeated fetch (a retry) never runs the
    collective on one rank alone. Every rank must construct it with the
    same ``slots``; ``inner`` is None on ranks other than 0. ``group`` is
    the process group (the default one when None)."""

    def __init__(self, inner: CommandQueue | None, *, slots: int,
                 group=None):
        self.inner = inner
        self.slots = int(slots)
        self.group = group
        self._frames: collections.OrderedDict = collections.OrderedDict()
        self.applied_total = 0
        self.shed_total = 0
        self.refused_total = 0
        self.consumed_offset = 0

    def start(self, offset: int = 0) -> "BroadcastCommands":
        if self.inner is not None:
            self.inner.start(offset)
        return self

    def close(self) -> None:
        if self.inner is not None:
            self.inner.close()

    def frame_for(self, chunk_start: int, chunk_ticks: int) -> Frame:
        import torch
        import torch.distributed as dist

        cached = self._frames.get(int(chunk_start))
        if cached is not None:
            return cached
        if self.inner is not None:
            f = self.inner.frame_for(chunk_start, chunk_ticks)
            payload = np.stack([f.op, f.a, f.b, f.c]).astype(np.int32)
            meta = np.array([f.count, f.shed, f.shed_total,
                             f.refused_total, f.applied_total, f.offset,
                             f.lag, f.depth, int(f.coasting)], np.int64)
            notes = f.notes
        else:
            payload = np.zeros((4, self.slots), np.int32)
            meta = np.zeros(9, np.int64)
            notes = ()
        # the group's broadcast runs on host tensors (gloo) or on the
        # current card (nccl)
        dev = torch.device("cuda", torch.cuda.current_device()) \
            if dist.get_backend(self.group) == "nccl" else "cpu"
        pt = torch.from_numpy(payload).to(dev)
        mt = torch.from_numpy(meta).to(dev)
        dist.broadcast(pt, 0, group=self.group)
        dist.broadcast(mt, 0, group=self.group)
        payload = pt.cpu().numpy()
        meta = [int(v) for v in mt.cpu().tolist()]
        frame = Frame(op=payload[0], a=payload[1], b=payload[2],
                      c=payload[3], count=meta[0], shed=meta[1],
                      shed_total=meta[2], refused_total=meta[3],
                      applied_total=meta[4], offset=meta[5], lag=meta[6],
                      depth=meta[7], coasting=bool(meta[8]), notes=notes)
        self.applied_total = frame.applied_total
        self.shed_total = frame.shed_total
        self.refused_total = frame.refused_total
        self.consumed_offset = frame.offset
        self._frames[int(chunk_start)] = frame
        while len(self._frames) > 8:
            self._frames.popitem(last=False)
        return frame

    @property
    def stalled(self) -> bool:
        return self.inner.stalled if self.inner is not None else False

    apply = staticmethod(apply_frame)


def write_stream(path: str, directives: list, *, end: bool = True) -> int:
    """Test/bench helper: write a directive list as an fsync'd NDJSON
    stream (+ terminal ``end`` marker); returns the byte size."""
    with open(path, "w") as f:
        for d in directives:
            f.write(json.dumps(d) + "\n")
        if end:
            f.write(json.dumps({"op": "end"}) + "\n")
        f.flush()
        os.fsync(f.fileno())
    return os.path.getsize(path)
