"""Streaming telemetry: the per-tick health record and its journal (port of
sim/telemetry.py).

A :class:`HealthRecord` reduces the state a tick left behind to a few
aggregates on the device: per-topic settled delivery, mesh degree
min/mean/max, the backoff and graylist census split by the attacker mask,
score stats, the message window, the delivery counter, ``halo_overflow``
and the ``fault_flags`` word. ``engine.run_keys``, ``run_window`` and
``run_checked_keys`` with ``telemetry=True``, and
``parallel.compile_plan.engine_chunk`` / ``engine_window`` with
``telemetry=True``, return ``(state, HealthRecord)`` with ``[C]``-stacked
leaves: one record per tick, computed from the post-step state, with no
host read (a captured chunk records them into its graph). Telemetry never
writes to the state.

Parity (tests/test_torch_telemetry.py): every column equals the
reference's exactly (integer counts, integer-valued float32 sums below
2**24, min/max) except ``score_mean``, a float32 sum of arbitrary values
whose reduction order differs between torch and XLA (3.1e-6 relative
apart at 1024 terms; the tests hold it to rtol 1e-5).

On the host, :func:`records_to_rows` lays a chunk's records out as one
float64 row matrix (one transfer), :func:`encode_rows` writes NDJSON (the
native codec of trace/native.py formats a chunk in one C call; the Python
encoder where its library cannot be built) and :class:`HealthJournal`
appends fsync'd run / chunk / note markers and health rows;
:func:`read_journal` reads it back, tolerating a torn tail and
deduplicating re-streamed ticks.
"""

from __future__ import annotations

import json
import os
import time
from typing import NamedTuple

import numpy as np
import torch

from .config import SimConfig, TopicParams
from .hostio import fetch_local
from .state import SimState, decode_state, is_compact, unpack_have

# sentinels, as the reference's (telemetry.py:62-63)
_BIG_I32 = 2 ** 30
_BIG_F32 = float(np.float32(3.0e38))


class HealthRecord(NamedTuple):
    """Per-tick aggregates (telemetry.py:67-98). Every leaf is a scalar
    tensor except ``delivery_frac`` (``[T]``); the run lanes stack a
    leading ``[C]`` axis. ``tick`` is the tick that ran (the record
    describes the state after it). ``fault_flags`` is int32 holding the
    reference's uint32 bits."""

    tick: torch.Tensor             # int32: the tick this record closes
    delivery_frac: torch.Tensor    # [T] f32 per-topic settled delivery
    mesh_deg_min: torch.Tensor     # int32 over subscribed (peer, topic)
    mesh_deg_mean: torch.Tensor    # f32
    mesh_deg_max: torch.Tensor     # int32
    backoff_count: torch.Tensor    # int32 live backoff entries
    graylist_count: torch.Tensor   # int32 connected edges below graylist
    connected_edges: torch.Tensor  # int32 connected neighbor slots
    attacker_edges: torch.Tensor   # int32 connected slots to an attacker
    attacker_graylisted: torch.Tensor  # int32 attacker edges graylisted
    honest_graylisted: torch.Tensor    # int32 honest edges graylisted
    score_mean: torch.Tensor       # f32 over connected slots
    score_min: torch.Tensor        # f32
    published_window: torch.Tensor  # int32 live slots of the window
    delivered_total: torch.Tensor  # f32 cumulative delivery counter
    halo_overflow: torch.Tensor    # int32
    fault_flags: torch.Tensor      # int32 bits (sim/invariants.py)


def health_record(state: SimState, cfg: SimConfig,
                  tp: TopicParams) -> HealthRecord:
    """The record of the state a tick left behind (telemetry.py:101-233),
    in either storage layout (a compact state is decoded first). Device
    tensors throughout, so a captured chunk can record it; applied after
    the fact to a stored trajectory it gives the streamed records."""
    from ..ops.score_ops import compute_scores
    from .faults import attacker_mask

    if is_compact(state):
        state = decode_state(state, cfg)
    n, t_topics, k = state.mesh.shape
    tick = state.tick
    i32, f32 = torch.int32, torch.float32

    # per-topic settled delivery over deliverable traffic (valid, alive,
    # neither invalid nor ignored) to honest subscribers; an empty census
    # reads 1.0
    age = tick - state.msg_publish_tick
    alive = (age < cfg.history_length) & (age >= 0)
    valid = state.msg_topic >= 0
    deliverable = valid & alive & ~state.msg_invalid & ~state.msg_ignored
    t_m = state.msg_topic.clamp(0, t_topics - 1).long()
    att = attacker_mask(state, cfg)                               # [N]
    should = state.subscribed[:, t_m] & ~att[:, None] \
        & deliverable[None, :]                                    # [N, M]
    got = unpack_have(state, cfg.msg_window) & should
    zero = torch.zeros((), dtype=f32, device=tick.device)
    # per-topic sums as masked row sums, not a scatter-add: the card's
    # atomic adds would vary the float32 order from run to run, and past
    # 2**24 deliveries (a million peers) the order shows in the sum
    of_topic = (t_m[None, :] == torch.arange(t_topics, device=tick.device)
                [:, None]) & deliverable[None, :]                 # [T, M]
    got_t = torch.where(of_topic, got.sum(0).to(f32), zero).sum(1)
    should_t = torch.where(of_topic, should.sum(0).to(f32), zero).sum(1)
    delivery_frac = torch.where(should_t > 0.0,
                                got_t / should_t.clamp(min=1.0), 1.0)

    # mesh degree over subscribed (peer, topic) pairs
    deg = state.mesh.sum(-1).to(i32)                              # [N, T]
    sub = state.subscribed
    n_sub = sub.sum()
    any_sub = n_sub > 0
    deg_min = torch.where(any_sub, deg.masked_fill(~sub, _BIG_I32).min(),
                          0).to(i32)
    deg_max = torch.where(any_sub, deg.masked_fill(~sub, -1).max(),
                          0).to(i32)
    deg_mean = deg.masked_fill(~sub, 0).sum().to(f32) \
        / n_sub.clamp(min=1).to(f32)

    # backoff / graylist census, split by the attacker mask
    backoff_count = (state.backoff > tick).sum().to(i32)
    scores = compute_scores(state, cfg, tp, apply_decay=True)     # [N, K]
    gray = state.connected & (scores < cfg.graylist_threshold)
    graylist_count = gray.sum().to(i32)
    nbr_att = att[state.neighbors.clamp(0, n - 1).long()] \
        & (state.neighbors >= 0)                                  # [N, K]
    attacker_edges = (state.connected & nbr_att).sum().to(i32)
    attacker_graylisted = (gray & nbr_att).sum().to(i32)

    # score stats over connected slots
    conn = state.connected
    n_conn = conn.sum()
    score_mean = torch.where(conn, scores, zero).sum() \
        / n_conn.clamp(min=1).to(f32)
    score_min = torch.where(n_conn > 0,
                            scores.masked_fill(~conn, _BIG_F32).min(),
                            zero).to(f32)

    return HealthRecord(
        tick=(tick - 1).to(i32),
        delivery_frac=delivery_frac,
        mesh_deg_min=deg_min,
        mesh_deg_mean=deg_mean,
        mesh_deg_max=deg_max,
        backoff_count=backoff_count,
        graylist_count=graylist_count,
        connected_edges=n_conn.to(i32),
        attacker_edges=attacker_edges,
        attacker_graylisted=attacker_graylisted,
        honest_graylisted=graylist_count - attacker_graylisted,
        score_mean=score_mean,
        score_min=score_min,
        published_window=valid.sum().to(i32),
        delivered_total=state.delivered_total,
        halo_overflow=state.halo_overflow,
        fault_flags=state.fault_flags,
    )


def stack_records(records: list) -> HealthRecord:
    """Per-tick records -> one record with ``[C]``-stacked leaves."""
    return HealthRecord(*(torch.stack(leaf) for leaf in zip(*records)))


# ---------------------------------------------------------------------------
# row schema: one flat numeric row per (tick[, member])

_INT_COLS = {"tick", "member", "mesh_deg_min", "mesh_deg_max",
             "backoff_count", "graylist_count", "connected_edges",
             "attacker_edges", "attacker_graylisted", "honest_graylisted",
             "published_window", "halo_overflow", "fault_flags"}

# the ingest marker's fields (telemetry.py:262-270): one
# ``{"kind": "ingest", ...}`` journal note per chunk of a live command
# plane
INGEST_COLUMNS = ("tick", "directives", "shed", "shed_total",
                  "refused_total", "queue_depth", "lag_ticks", "offset",
                  "coasting")

_SCALAR_FIELDS = ["mesh_deg_min", "mesh_deg_mean", "mesh_deg_max",
                  "backoff_count", "graylist_count", "connected_edges",
                  "attacker_edges", "attacker_graylisted",
                  "honest_graylisted", "score_mean", "score_min",
                  "published_window", "delivered_total", "halo_overflow",
                  "fault_flags"]


def health_columns(n_topics: int) -> list:
    """Ordered ``(name, is_int)`` columns of a journal health row.
    ``member`` is the fleet input index (-1 for an unbatched run);
    ``delivery_frac`` flattens to one column per topic."""
    names = ["tick", "member"] \
        + [f"delivery_frac_t{j}" for j in range(n_topics)] + _SCALAR_FIELDS
    return [(nm, nm in _INT_COLS) for nm in names]


def records_to_rows(records: HealthRecord,
                    member_ids=None) -> tuple[np.ndarray, list]:
    """One host transfer per leaf for a whole chunk: the stacked records
    as a float64 row matrix (tick-major; fleet members, a ``[C, B]``
    leading shape, interleave within a tick) and its columns.
    ``member_ids`` maps a fleet lane to its member index (an unbatched
    run's rows carry -1)."""
    leaves = HealthRecord(*(
        fetch_local(x, np.uint32 if f == "fault_flags" else None)
        for f, x in zip(HealthRecord._fields, records)))
    tick = leaves.tick
    batched = tick.ndim == 2
    c = tick.shape[0]
    b = tick.shape[1] if batched else 1
    t_topics = leaves.delivery_frac.shape[-1]
    cols = health_columns(t_topics)
    if member_ids is None:
        member_ids = list(range(b)) if batched else [-1]
    if len(member_ids) != b:
        raise ValueError(
            f"records_to_rows: {len(member_ids)} member ids for a "
            f"B={b} record batch")
    mat = np.empty((c * b, len(cols)), np.float64)
    mat[:, 0] = np.asarray(tick, np.float64).reshape(-1)
    mat[:, 1] = np.tile(np.asarray(member_ids, np.float64), c)
    mat[:, 2:2 + t_topics] = np.asarray(
        leaves.delivery_frac, np.float64).reshape(c * b, t_topics)
    for i, f in enumerate(_SCALAR_FIELDS):
        mat[:, 2 + t_topics + i] = np.asarray(
            getattr(leaves, f), np.float64).reshape(c * b)
    return mat, cols


def record_to_row(record: HealthRecord, member: int = -1) -> dict:
    """One unstacked record as a flat row dict."""
    stacked = HealthRecord(*(torch.as_tensor(x)[None] for x in record))
    mat, cols = records_to_rows(stacked, member_ids=[member])
    return rows_to_dicts(mat, cols)[0]


def rows_to_dicts(matrix: np.ndarray, columns: list) -> list:
    """Row matrix -> list of plain dicts."""
    out = []
    for r in np.asarray(matrix, np.float64):
        out.append({nm: (int(v) if is_int else float(v))
                    for (nm, is_int), v in zip(columns, r)})
    return out


def encode_rows_py(matrix: np.ndarray, columns: list) -> bytes:
    """NDJSON ``health`` lines; non-finite floats encode as null."""
    lines = []
    for d in rows_to_dicts(matrix, columns):
        for k, v in d.items():
            if isinstance(v, float) and not np.isfinite(v):
                d[k] = None
        lines.append(json.dumps({"kind": "health", **d}))
    return ("\n".join(lines) + "\n").encode() if lines else b""


def encode_rows(matrix: np.ndarray, columns: list,
                prefer_native: bool = True) -> tuple[bytes, str]:
    """A chunk's rows as ``(payload, encoder_name)`` (telemetry.py:329-345):
    ``"native"``, the whole matrix formatted in one call of the native
    codec (trace/native.py), when ``prefer_native`` and its library
    builds, else ``"python"``. The two parse to the same values (the float
    text differs, %.17g against repr, and round-trips to the same
    doubles)."""
    if prefer_native:
        from ..trace.native import encode_health_json
        payload = encode_health_json(matrix, columns)
        if payload is not None:
            return payload, "native"
    return encode_rows_py(matrix, columns), "python"


# ---------------------------------------------------------------------------
# the journal sink


class HealthJournal:
    """Append-only NDJSON health journal (telemetry.py:359-486).

    Line kinds: ``run`` (header: config fingerprint, shape, columns,
    ``flags_version``, the plan's attack windows), ``chunk`` (one per
    streamed chunk, with a wall-clock stamp), ``health`` (the rows) and
    free-form notes. Each append is flushed and, by default, fsync'd, so a
    kill leaves at most one torn tail line, which :func:`read_journal`
    skips; a resumed run keeps appending and readers deduplicate rows by
    ``(member, tick)``. ``sync_every_write=False`` batches the fsync into
    :meth:`sync`. ``prefer_native`` picks :func:`encode_rows`' encoder;
    each ``chunk`` note names the one that ran (:attr:`encoder`)."""

    def __init__(self, path: str, prefer_native: bool = True,
                 sync_every_write: bool = True):
        self.path = path
        self.prefer_native = prefer_native
        self.sync_every_write = sync_every_write
        self.encoder = "python"
        self._dirty = False
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._fh = open(path, "ab")

    def _write(self, payload: bytes) -> None:
        self._fh.write(payload)
        self._fh.flush()
        if self.sync_every_write:
            os.fsync(self._fh.fileno())
        else:
            self._dirty = True

    def sync(self) -> None:
        """fsync everything appended since the last sync."""
        if self._dirty and not self._fh.closed:
            self._fh.flush()
            os.fsync(self._fh.fileno())
            self._dirty = False

    def note(self, kind: str, **meta) -> None:
        self._write((json.dumps({"kind": kind, "wall": time.time(),
                                 **meta}) + "\n").encode())

    def header(self, cfg: SimConfig, **meta) -> None:
        from . import checkpoint
        from .faults import attack_schedule
        from .invariants import FLAGS_VERSION

        meta.setdefault("flags_version", FLAGS_VERSION)
        sched = attack_schedule(cfg.fault_plan)
        if sched:
            meta.setdefault("attack_windows", sched)
        if cfg.degree_buckets:
            meta.setdefault("degree_buckets",
                            [list(b) for b in cfg.degree_buckets])
        self.note("run",
                  fingerprint=checkpoint.config_fingerprint(cfg),
                  n_peers=cfg.n_peers, n_topics=cfg.n_topics,
                  invariant_mode=cfg.invariant_mode,
                  columns=[nm for nm, _ in health_columns(cfg.n_topics)],
                  **meta)

    def append_records(self, records: HealthRecord, member_ids=None,
                       **chunk_meta) -> int:
        """Stream one chunk: a ``chunk`` marker, then its health rows.
        Returns the row count."""
        mat, cols = records_to_rows(records, member_ids=member_ids)
        payload, self.encoder = encode_rows(mat, cols, self.prefer_native)
        self.note("chunk", rows=int(mat.shape[0]), encoder=self.encoder,
                  **chunk_meta)
        self._write(payload)
        return int(mat.shape[0])

    def append_dicts(self, rows: list, **chunk_meta) -> int:
        """Rows already built as dicts (``None`` passes as JSON null)."""
        self.note("chunk", rows=len(rows), encoder="python", **chunk_meta)
        if rows:
            self._write(("\n".join(
                json.dumps({"kind": "health", **r}) for r in rows)
                + "\n").encode())
        return len(rows)

    def close(self) -> None:
        if not self._fh.closed:
            self.sync()
            self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_journal(path: str) -> dict:
    """``{"runs", "chunks", "notes", "rows"}`` of a journal
    (telemetry.py:489-534): torn lines are skipped, health rows keep the
    last line of each ``(member, tick)`` and come sorted by tick, and
    ``contract_verdict`` notes keep one line per id, at the first one's
    position."""
    runs, chunks, notes = [], [], []
    rows: dict = {}
    verdict_ids: dict = {}
    if not os.path.exists(path):
        return {"runs": runs, "chunks": chunks, "notes": notes, "rows": []}
    with open(path, "rb") as f:
        for raw in f:
            try:
                d = json.loads(raw)
            except (json.JSONDecodeError, UnicodeDecodeError):
                continue                        # torn tail line
            kind = d.get("kind")
            if kind == "health":
                rows[(d.get("member", -1), d.get("tick"))] = d
            elif kind == "run":
                runs.append(d)
            elif kind == "chunk":
                chunks.append(d)
            elif kind == "contract_verdict" and d.get("id") is not None:
                vid = d["id"]
                if vid in verdict_ids:
                    notes[verdict_ids[vid]] = d
                else:
                    verdict_ids[vid] = len(notes)
                    notes.append(d)
            else:
                notes.append(d)
    ordered = sorted(rows.values(),
                     key=lambda r: (r.get("tick", 0), r.get("member", -1)))
    return {"runs": runs, "chunks": chunks, "notes": notes, "rows": ordered}
