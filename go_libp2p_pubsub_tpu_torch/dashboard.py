"""Live dashboard over a streaming health journal (port of
scripts/dashboard.py).

Tails the fsync'd health journal a supervised run streams
(``GRAFT_HEALTH_STREAM=path`` / ``SupervisorConfig.health_path``, fleet
and multihost included) and renders the run's vitals without touching the
device:

- progress: last completed tick / scheduled ticks, chunk cadence
- throughput: heartbeats/sec from consecutive chunk markers' wall stamps
  (recent median)
- delivery fraction per topic (+ sparkline of the recent trend)
- mesh degree min/mean/max, backoff + graylist census, score mean/min
- the decoded ``fault_flags`` health word (a poisoned run shows its
  VIOLATION bits here the moment the chunk that lit them lands)
- checkpoint ticks and crash markers (post-mortem starts here: the crash
  line names the dump directory ``replay_crash`` replays)
- live contract verdicts: rendered from the run's journaled
  ``contract_verdict`` notes when the supervisor carries monitors (deduped
  by their deterministic id), with a CONTRACT BREACH / VERDICT ABORT
  banner on failure; runs that stamp contracts but journal no verdicts
  fall back to the tailer's own incremental monitors, and older journals
  to a full evaluation over the visible rows
- fleet journals: per-member summary (worst delivery / tripped flags)
- multihost journals: per-rank heartbeat age, relaunch count, degrade
  rung, and a DEAD-RANK banner with the mh_supervisor resume command
  (parallel/resilience.py heartbeats in the run's shared run directory)
- the live command plane: queue depth, lag, shed, the consumed offset, and
  a COASTING banner with the directive producer's restart command

Usage:
    python -m go_libp2p_pubsub_tpu_torch.dashboard HEALTH_JSONL   # live
    python -m go_libp2p_pubsub_tpu_torch.dashboard HEALTH_JSONL --once
    python -m go_libp2p_pubsub_tpu_torch.dashboard HEALTH_JSONL --once --json

It reads a journal of either package, through the port's own
``sim.telemetry.read_journal``, ``sim.invariants.decode_flags`` and
``sim.adversary`` contracts, so it runs where JAX is not installed. The
journal is read tolerantly: torn tail lines from a kill mid-append are
skipped, resumed runs dedup by tick. Exit: 0 on a readable journal (even
mid-run), 1 when the file never appears within ``--wait`` seconds.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import re
import sys
import time

from .sim import adversary
from .sim.invariants import decode_flags
from .sim.telemetry import read_journal

REPLAY_CMD = "python -m go_libp2p_pubsub_tpu_torch.replay_crash"

_SPARK = " ▁▂▃▄▅▆▇█"


def _decode_flags(flags, version=None):
    if not flags:
        return []
    try:
        return decode_flags(int(flags), flags_version=version)
    except ValueError as e:
        # the journal header stamps which fault_flags bit layout wrote it
        # (flags_version); a word from another layout is refused by name:
        # rendering it through the current table would misread moved bits
        return [f"UNDECODABLE({e})"[:140]]


def _sparkline(vals, width: int = 40) -> str:
    if not vals:
        return ""
    vals = vals[-width:]
    lo, hi = min(vals), max(vals)
    span = (hi - lo) or 1.0
    return "".join(_SPARK[int((v - lo) / span * (len(_SPARK) - 1))]
                   for v in vals)


def _bytes(n) -> str:
    """Human bytes for the pricing block (GiB/MiB/KiB to one decimal)."""
    for unit, width in (("GiB", 2 ** 30), ("MiB", 2 ** 20), ("KiB", 2 ** 10)):
        if n >= width:
            return f"{n / width:.1f}{unit}"
    return f"{int(n)}B"


def _topic_fracs(row: dict) -> list:
    out = []
    t = 0
    while f"delivery_frac_t{t}" in row:
        out.append(row[f"delivery_frac_t{t}"])
        t += 1
    return out


def _hbps(chunks: list, window: int = 8):
    """Recent heartbeats/sec from consecutive chunk markers: prefer each
    marker's ``done_wall`` — stamped when the chunk's DEVICE result was
    confirmed — over ``wall`` (stamped at journal append). Under the
    async supervisor the writer thread appends markers in bursts whenever
    its queue drains, so append-time deltas alias to ~0 or the whole
    burst; dispatch-complete deltas price the device work itself. Old
    journals (no ``done_wall`` field) fall back to ``wall`` per stamp.
    ``rows`` is member-ticks (ticks × active members under fleet, ==
    ticks unbatched), so the number is the aggregate rate, fleet
    included. Median of the last few deltas."""
    rates = []
    for a, b in list(zip(chunks, chunks[1:]))[-window:]:
        dt = (b.get("done_wall") or b.get("wall", 0)) \
            - (a.get("done_wall") or a.get("wall", 0))
        ticks = b.get("rows") or b.get("ticks") or 0
        if dt > 0 and ticks:
            rates.append(ticks / dt)
    if not rates:
        return None
    rates.sort()
    return rates[len(rates) // 2]


class _Tailer:
    """Incremental journal reader for live mode: O(new bytes) per poll
    and bounded memory regardless of run length — a multi-day unattended
    window's journal grows one row per member-tick, and re-parsing the
    whole file every refresh would lag the interval and grow RSS without
    bound. Keeps exactly the bounded recent window the render uses."""

    MAX_ROWS = 4096

    def __init__(self, path: str):
        self.path = path
        self.offset = 0
        self.buf = b""
        self.runs: list = []
        self.chunks = collections.deque(maxlen=64)
        self.chunk_count = 0
        self.notes = collections.deque(maxlen=256)
        self.rows = collections.OrderedDict()
        # live contract verdicts: journaled contract_verdict notes dedup
        # by their deterministic id (a relaunch may re-derive a transition
        # the killed run already journaled; it renders once), and when a
        # run stamps contracts but journals no verdicts the tailer folds
        # rows into its own incremental monitors, O(1) per row
        self.verdicts: dict = {}
        self._mon: tuple | None = None

    def poll(self) -> None:
        try:
            size = os.path.getsize(self.path)
        except OSError:
            return
        if size < self.offset:              # truncated/rotated: restart
            self.offset, self.buf = 0, b""
        with open(self.path, "rb") as f:
            f.seek(self.offset)
            data = self.buf + f.read()
            self.offset = f.tell()
        lines = data.split(b"\n")
        self.buf = lines.pop()              # torn tail rides to next poll
        for ln in lines:
            if not ln.strip():
                continue
            try:
                d = json.loads(ln)
            except (json.JSONDecodeError, UnicodeDecodeError):
                continue
            kind = d.get("kind")
            if kind == "health":
                key = (d.get("member", -1), d.get("tick"))
                self.rows.pop(key, None)    # resume overlap: last wins
                self.rows[key] = d
                while len(self.rows) > self.MAX_ROWS:
                    self.rows.popitem(last=False)
                self._fold_live(d)
            elif kind == "run":
                self.runs = self.runs[-7:] + [d]
            elif kind == "chunk":
                self.chunks.append(d)
                self.chunk_count += 1
            elif kind == "contract_verdict" and d.get("id"):
                self.verdicts.setdefault(d["id"], d)
            else:
                self.notes.append(d)

    def _fold_live(self, row: dict) -> None:
        """Tailer-side incremental contract monitors: the live fallback
        for journals whose run stamps ``contracts`` but whose supervisor
        journals no verdict notes. One O(1) fold per NEW row — resume
        overlap (a re-sent tick) and fleet journals (per-member streams
        need the batch path) are skipped."""
        if self.verdicts or row.get("member", -1) != -1:
            return
        run = self.runs[-1] if self.runs else None
        specs = run.get("contracts") if run else None
        if not specs:
            return
        key = json.dumps(specs, sort_keys=True)
        if self._mon is None or self._mon[0] != key:
            try:
                mons = adversary.ContractMonitors(
                    adversary.contracts_from_json(specs))
            except Exception:
                mons = None     # render falls back to batch evaluation
            self._mon = (key, mons, -1)
        key0, mons, last = self._mon
        tick = row.get("tick", -1)
        if mons is None or tick <= last:
            return
        mons.fold_rows([row])
        self._mon = (key0, mons, tick)

    def journal(self) -> dict:
        return {"runs": self.runs, "chunks": list(self.chunks),
                "notes": list(self.notes),
                "verdicts": list(self.verdicts.values()),
                "live_monitors": self._mon[1] if self._mon else None,
                "rows": sorted(self.rows.values(),
                               key=lambda r: (r.get("tick", 0),
                                              r.get("member", -1))),
                "chunks_total": self.chunk_count}


def snapshot(path: str) -> dict:
    """One machine-readable view of the journal (the --json form; the
    text renderer formats exactly this). Reads the whole file — the
    --once path; live mode feeds :func:`_snapshot_of` from a bounded
    incremental :class:`_Tailer` instead."""
    return _snapshot_of(read_journal(path), path)


def _snapshot_of(j: dict, path: str) -> dict:
    rows = j["rows"]
    run = j["runs"][-1] if j["runs"] else {}
    # terminal markers count only AFTER the newest run header: a resumed
    # run must not inherit its previous window's run_end/window_end
    run_wall = run.get("wall", 0)
    current = [n for n in j["notes"] if n.get("wall", 0) >= run_wall]
    snap: dict = {
        "path": path,
        "run": {k: run.get(k) for k in ("scenario", "n_peers", "n_topics",
                                        "n_ticks", "invariant_mode",
                                        "plane", "group", "member_names")
                if run.get(k) is not None},
        "chunks": j.get("chunks_total", len(j["chunks"])),
        "rows": len(rows),
        "hbps": _hbps(j["chunks"]),
        "checkpoints": [n.get("tick", n.get("done"))
                        for n in j["notes"] if n.get("kind") == "checkpoint"],
        "crashes": [{"tick": n.get("tick"), "dump": n.get("dump"),
                     "error": n.get("error")}
                    for n in current if n.get("kind") == "crash"],
        "done": any(n.get("kind") == "run_end" for n in current),
        # a bounded window stopped cleanly and will resume the same
        # schedule (supervisor max_chunks): live-tail keeps tailing
        "paused": any(n.get("kind") == "window_end" for n in current),
    }
    _attach_liveness(snap, run)
    _attach_launcher(snap, j)
    _attach_ingest(snap, current)
    if not rows:
        return snap
    members = sorted({r.get("member", -1) for r in rows})
    fleet = members != [-1]
    last_tick = max(r["tick"] for r in rows)
    latest = [r for r in rows if r["tick"] == last_tick]
    head = latest[0]
    fracs = [_topic_fracs(r) for r in latest]
    flat = [f for fr in fracs for f in fr]
    snap.update({
        "tick": last_tick,
        "fleet_members": len(members) if fleet else None,
        "delivery_frac": (sum(flat) / len(flat)) if flat else None,
        "delivery_frac_topics": fracs[0] if not fleet else None,
        "mesh_deg": {k: head.get(f"mesh_deg_{k}")
                     for k in ("min", "mean", "max")},
        "backoff_count": head.get("backoff_count"),
        "graylist_count": head.get("graylist_count"),
        "score_mean": head.get("score_mean"),
        "score_min": head.get("score_min"),
        "published_window": head.get("published_window"),
        "delivered_total": head.get("delivered_total"),
        "halo_overflow": max((r.get("halo_overflow") or 0) for r in latest),
        "fault_flags": None if head.get("fault_flags") is None else
        int(max((r.get("fault_flags") or 0) for r in latest)),
    })
    if snap["run"].get("invariant_mode") == "off":
        # the numeric row schema streams 0 when the sentinel is off, but
        # an untracked run must never read as verified-clean (the same
        # not-tracked ≠ clean rule run_traced's None flags encode)
        snap["fault_flags"] = None
    snap["fault_flag_names"] = _decode_flags(snap["fault_flags"],
                                             version=run.get("flags_version"))
    _attach_verdicts(snap, j, current)
    _attach_attacks(snap, run, rows)
    # recent trend for the sparkline: mean delivery per tick
    trend: dict = {}
    for r in rows:
        fr = _topic_fracs(r)
        if fr:
            trend.setdefault(r["tick"], []).append(sum(fr) / len(fr))
    snap["trend"] = [sum(v) / len(v)
                     for _t, v in sorted(trend.items())[-60:]]
    if fleet:
        worst = min(latest,
                    key=lambda r: (sum(_topic_fracs(r)) /
                                   max(len(_topic_fracs(r)), 1)))
        wf = _topic_fracs(worst)
        snap["worst_member"] = {
            "member": worst.get("member"),
            "delivery_frac": sum(wf) / len(wf) if wf else None,
            "fault_flags": worst.get("fault_flags")}
    return snap


def _attach_liveness(snap: dict, run: dict) -> None:
    """Multihost resilience view (parallel/resilience.py): a run launched
    with a ``--run-dir`` stamps ``mh_run_dir`` (+ rung/relaunch
    provenance) into its health header; the dashboard reads the shared
    directory's heartbeat files and ``mh_journal.jsonl`` live — per-rank
    heartbeat age, relaunch count, the current degrade rung, and a
    DEAD-RANK banner carrying the mh_supervisor resume command."""
    run_dir = run.get("mh_run_dir")
    if not run_dir or not os.path.isdir(run_dir):
        return
    procs = run.get("processes")
    now = time.time()
    ranks = []
    for name in sorted(os.listdir(run_dir)):
        m = re.match(r"hb_rank(\d+)\.json$", name)
        if not m:
            continue
        r = int(m.group(1))
        if isinstance(procs, int) and r >= procs:
            continue    # stale heartbeat from an earlier, larger attempt
        try:
            with open(os.path.join(run_dir, name)) as f:
                d = json.load(f)
        except (OSError, ValueError):
            continue    # torn mid-rename read: next refresh gets it
        ranks.append({"rank": r,
                      "age_s": round(now - float(d.get("wall", 0.0)), 1),
                      "tick": d.get("tick"), "chunk": d.get("chunk"),
                      "done": bool(d.get("done"))})
    mh: dict = {"ranks": ranks,
                "relaunches": run.get("mh_relaunches", 0),
                "rung": run.get("mh_rung", 0)}
    jpath = os.path.join(run_dir, "mh_journal.jsonl")
    if os.path.exists(jpath):
        recs = []
        try:
            with open(jpath) as f:
                for ln in f:
                    try:
                        recs.append(json.loads(ln))
                    except ValueError:
                        pass        # torn tail line mid-append
        except OSError:
            pass
        attempts = [r for r in recs if r.get("kind") == "mh_attempt"]
        if attempts:
            mh["relaunches"] = max(mh["relaunches"], len(attempts) - 1)
            mh["rung"] = attempts[-1].get("rung", mh["rung"])
        head = next((r for r in recs if r.get("kind") == "mh_run"), None)
        if head and head.get("resume_cmd"):
            mh["resume_cmd"] = head["resume_cmd"]
    timeout = run.get("mh_peer_timeout_s") or 30.0
    # a finished run's ranks stopped beating LEGITIMATELY — no banner
    mh["dead_ranks"] = [] if snap.get("done") else [
        r["rank"] for r in ranks
        if not r["done"] and r["age_s"] > float(timeout)]
    snap["mh"] = mh


def _attach_launcher(snap: dict, j: dict) -> None:
    """Multihost-launcher view (``run_multihost --journal``):
    the launcher leads its journal with the run header — engine, process
    and device counts, and for the row-sharded bucketed engine the
    per-(bucket x shard) byte pricing the HBM gate computed closed-form.
    The dashboard renders THAT accounting instead of re-deriving a dense
    [N, K] estimate it can't get right for bucketed layouts. The
    launcher's metric line (same journal) supplies hb/s and delivery for
    engines that refuse the health stream (bucketed: sim/telemetry reads
    the dense planes)."""
    head = next((n for n in reversed(j["notes"])
                 if n.get("info") == "multihost run"), None)
    if head is None:
        return
    snap["launcher"] = {k: head.get(k) for k in (
        "scenario", "engine", "n_peers", "processes", "devices",
        "topology", "state_precision", "state_nbytes_per_shard",
        "bucket_shards") if head.get(k) is not None}
    for k in ("scenario", "n_peers"):
        if snap["run"].get(k) is None and head.get(k) is not None:
            snap["run"][k] = head[k]
    metric = next((n for n in reversed(j["notes"])
                   if "metric" in n and "hbps" in n), None)
    if metric is not None:
        snap["launcher"]["hbps"] = metric.get("hbps")
        snap["launcher"]["delivery_fraction"] = \
            metric.get("delivery_fraction")
        snap["launcher"]["resumed_from"] = metric.get("resumed_from")


def _render_launcher(snap: dict, out: list) -> None:
    la = snap.get("launcher")
    if not la:
        return
    line = f"  engine {la.get('engine', 'dense')}"
    if la.get("processes"):
        line += f"   procs {la['processes']}"
    if la.get("devices"):
        line += f"   devices {la['devices']}"
    if la.get("state_nbytes_per_shard") is not None:
        line += f"   state/shard {_bytes(la['state_nbytes_per_shard'])}"
    out.append(line)
    for b, e in enumerate(la.get("bucket_shards") or []):
        per = sum(v for k, v in e.items() if k not in ("rows", "k_ceil"))
        out.append(f"    bucket b{b} {e['rows']}x{e['k_ceil']}: "
                   f"{_bytes(per)}/shard")
    if la.get("hbps") is not None:
        line = f"  launcher hb/s {la['hbps']}"
        if la.get("delivery_fraction") is not None:
            line += f"   delivery {la['delivery_fraction']}"
        if la.get("resumed_from") is not None:
            line += f"   resumed@{la['resumed_from']}"
        out.append(line)


def _attach_verdicts(snap: dict, j: dict, current: list) -> None:
    """Live contract verdict view, in preference order:

    1. journaled ``contract_verdict`` notes (the supervisor's monitors
       already judged the stream — O(new bytes): latest status per
       contract by seq, deduped by deterministic id by the tailer /
       ``telemetry.read_journal``);
    2. the tailer's own incremental monitors (runs that stamp contracts
       but journal no verdicts);
    3. nothing here — ``_attach_attacks`` falls back to full
       re-evaluation over the visible rows (older journals, fleet).

    Also surfaces the ``verdict_abort``/``contract_alarm`` teardown and
    breach markers for the render banners."""
    verd = j.get("verdicts")
    if verd is None:        # read_journal path: notes, already deduped
        verd = [n for n in j["notes"]
                if n.get("kind") == "contract_verdict"]
    if verd:
        latest: dict = {}
        for v in verd:
            i = v.get("contract", 0)
            if i not in latest or v.get("seq", 0) >= \
                    latest[i].get("seq", 0):
                latest[i] = v
        snap["contracts"] = [
            # note dicts carry the contract's kind as contract_kind
            # ("kind" is the note's own type tag, contract_verdict)
            {"kind": v.get("contract_kind"), "status": v.get("status"),
             "detail": v.get("detail"), "tick": v.get("tick"),
             "source": "journal"}
            for _i, v in sorted(latest.items())]
    else:
        mons = j.get("live_monitors")
        if mons is not None:
            snap["contracts"] = [
                {"kind": r.kind, "status": r.status, "detail": r.detail,
                 "source": "monitor"}
                for r in mons.results(final=bool(snap.get("done")))]
    abort = next((n for n in reversed(current)
                  if n.get("kind") == "verdict_abort"), None)
    if abort is not None:
        snap["verdict_abort"] = {
            "contract": abort.get("contract"),
            "kind": abort.get("contract_kind"),
            "tick": abort.get("tick"), "detail": abort.get("detail")}
    if any(n.get("kind") == "contract_alarm" for n in current):
        snap["contract_alarm"] = True


def _attach_attacks(snap: dict, run: dict, rows: list) -> None:
    """Attack-scenario view: the run header stamps its
    ``attack_windows`` schedule (sim/telemetry.py header) and optionally
    its declared ``contracts`` (SupervisorConfig.health_meta); the
    dashboard marks which windows cover the newest tick and evaluates
    the contracts over the visible rows — ``pending`` while a decision
    tick is still ahead, final once the run ended/crashed. Live mode's
    tailer keeps a bounded recent row window, so a long-scrolled-past
    delivery dip may age out of the live view; ``--once`` reads the
    whole journal and judges the full stream."""
    windows = run.get("attack_windows")
    if not windows:
        return
    tick = snap.get("tick", -1)
    snap["attacks"] = [dict(w, active=(w["start"] <= tick
                                       and (w["end"] is None
                                            or tick < w["end"])))
                       for w in windows]
    if "contracts" in snap:
        # the verdict plane already judged the stream (journaled notes or
        # the tailer's incremental monitors) — never re-evaluate O(rows)
        return
    final = bool(snap.get("done") or snap.get("crashes"))
    try:
        if run.get("contracts"):
            contracts = adversary.contracts_from_json(run["contracts"])
        else:
            contracts = adversary.contracts_from_schedule(windows)
        members = sorted({r.get("member", -1) for r in rows})
        out = []
        for c in contracts:
            per = [c.evaluate(adversary.member_rows(rows, m), final=final)
                   for m in members]
            worst = next((r for r in per if r.status == "fail"),
                         next((r for r in per if r.status == "pending"),
                              per[0]))
            out.append({"kind": worst.kind, "status": worst.status,
                        "detail": worst.detail})
        snap["contracts"] = out
    except Exception as e:           # the dashboard must render anyway
        snap["contracts"] = [{"kind": "error", "status": "fail",
                              "detail": f"contract evaluation failed: {e}"}]


def _attach_ingest(snap: dict, notes: list) -> None:
    """Live command plane view (sim/commands.py): the per-chunk
    ``ingest`` markers carry queue depth, lag, shed and the consumed
    stream offset (telemetry.INGEST_COLUMNS); an ``ingest_stalled``
    marker opens a coast episode and carries the producer-restart
    command the COASTING banner surfaces (the DEAD-RANK pattern)."""
    last = next((n for n in reversed(notes)
                 if n.get("kind") == "ingest"), None)
    if last is None:
        return
    ing = {k: last.get(k) for k in
           ("tick", "directives", "shed", "shed_total", "refused_total",
            "queue_depth", "lag_ticks", "offset", "coasting")}
    if ing.get("coasting"):
        stall = next((n for n in reversed(notes)
                      if n.get("kind") == "ingest_stalled"), None)
        if stall is not None:
            ing["stalled_tick"] = stall.get("tick")
            ing["source"] = stall.get("source")
            ing["resume_cmd"] = stall.get("resume_cmd")
    snap["ingest"] = ing


def _render_ingest(snap: dict, out: list) -> None:
    """The ingest-health block (``_attach_ingest``) — shared by the
    normal render path and the no-health-rows-yet early return."""
    ing = snap.get("ingest")
    if not ing:
        return
    out.append(f"  ingest q {ing.get('queue_depth', 0)}"
               f"   lag {ing.get('lag_ticks', 0)} ticks"
               f"   shed {ing.get('shed_total', 0)}"
               f"   refused {ing.get('refused_total', 0)}"
               f"   offset {ing.get('offset', 0)}")
    if ing.get("coasting") and not snap.get("done"):
        out.append(f"  COASTING: directive ingest stalled @ tick "
                   f"{ing.get('stalled_tick', ing.get('tick'))} — chip "
                   "stepping with empty frames; restart the producer "
                   f"from offset {ing.get('offset', 0)}")
        if ing.get("resume_cmd"):
            out.append(f"    resume: {ing['resume_cmd']}")


def _render_mh(snap: dict, out: list) -> None:
    """The multihost rank-liveness block (``_attach_liveness``) — shared
    by the normal render path and the no-health-rows-yet early return."""
    if not snap.get("mh"):
        return
    mh = snap["mh"]
    if mh.get("ranks"):
        out.append("  ranks " + "  ".join(
            f"r{r['rank']}:" + ("done" if r["done"]
                                else f"t{r['tick']} {r['age_s']:.0f}s")
            for r in mh["ranks"]))
    out.append(f"  relaunches {mh.get('relaunches', 0)}   "
               f"degrade rung {mh.get('rung', 0)}")
    for r in mh.get("dead_ranks", []):
        out.append(f"  DEAD RANK {r}: heartbeat stale — group "
                   "relaunch required")
    if mh.get("dead_ranks") and mh.get("resume_cmd"):
        out.append(f"    resume: {mh['resume_cmd']}")


def render(snap: dict) -> str:
    out = []
    run = snap.get("run", {})
    title = run.get("scenario") or os.path.basename(snap["path"])
    shape = f"{run.get('n_peers', '?')} peers"
    if snap.get("fleet_members"):
        shape += f" x {snap['fleet_members']} members"
    status = "ENDED" if snap.get("done") else (
        "CRASHED" if snap.get("crashes") else
        "PAUSED (resumable)" if snap.get("paused") else "live")
    out.append(f"== graft telemetry :: {title} ({shape}) [{status}] ==")
    ds = run.get("degree_stats")
    if ds:
        # heavy-tailed underlays: the run header states the graph shape
        # every number below was measured on (sim/topology.degree_stats)
        out.append(f"  underlay degree min/mean/p99/max "
                   f"{ds.get('min')}/{ds.get('mean')}/{ds.get('p99')}/"
                   f"{ds.get('max')}   gini {ds.get('gini')}")
    elif run.get("degree_buckets"):
        out.append("  degree buckets " + " ".join(
            f"{nb}x{kb}" for nb, kb in run["degree_buckets"]))
    if "tick" not in snap:
        # a first-chunk crash journals no health rows — the crash pointer
        # (the post-mortem entry point) must still render, and so must the
        # rank-liveness block: a rank that dies during init/compile is
        # exactly the DEAD-RANK-banner case
        out.append("  (no health rows yet)")
        _render_launcher(snap, out)
        _render_mh(snap, out)
        _render_ingest(snap, out)
        for c in snap.get("crashes", []):
            out.append(f"  CRASH @ tick {c.get('tick')}: {c.get('error')}")
            out.append(f"    replay: {REPLAY_CMD} "
                       f"{c.get('dump')}")
        return "\n".join(out)
    n_ticks = run.get("n_ticks")
    prog = f"tick {snap['tick'] + 1}"
    if isinstance(n_ticks, int):
        prog += f" / {n_ticks}"
    elif isinstance(n_ticks, list):
        prog += f" / {max(n_ticks)}"
    hb = snap.get("hbps")
    out.append(f"  {prog}   chunks {snap['chunks']}   "
               f"hb/s {hb:.2f}" if hb else f"  {prog}   "
               f"chunks {snap['chunks']}   hb/s ?")
    df = snap.get("delivery_frac")
    line = f"  delivery {df:.4f}" if df is not None else "  delivery ?"
    if snap.get("delivery_frac_topics") and \
            len(snap["delivery_frac_topics"]) > 1:
        line += " [" + " ".join(f"{f:.3f}"
                                for f in snap["delivery_frac_topics"]) + "]"
    out.append(line + "   " + _sparkline(snap.get("trend", [])))
    def num(key, spec=""):
        # a partial or degraded row may miss columns; render "?" rather
        # than crash the one tool meant to survive degraded runs
        v = snap.get(key)
        return "?" if v is None else format(v, spec)

    deg = snap.get("mesh_deg", {})
    out.append(f"  mesh degree min/mean/max "
               f"{deg.get('min')}/{deg.get('mean'):.2f}/{deg.get('max')}"
               if deg.get("mean") is not None else "  mesh degree ?")
    out.append(f"  backoff {num('backoff_count')}   "
               f"graylist {num('graylist_count')}   "
               f"score mean/min {num('score_mean', '.3f')}/"
               f"{num('score_min', '.3f')}")
    out.append(f"  window msgs {num('published_window')}   "
               f"delivered(total) {num('delivered_total', '.0f')}   "
               f"halo_overflow {num('halo_overflow')}")
    ff = snap.get("fault_flags")
    if ff is None:
        out.append("  flags: (invariants off)")
    elif ff:
        out.append(f"  flags: 0x{ff:x} " + " ".join(
            snap.get("fault_flag_names", [])))
    else:
        out.append("  flags: clean")
    if snap.get("worst_member"):
        w = snap["worst_member"]
        out.append(f"  worst member #{w['member']}: "
                   f"delivery {w['delivery_frac']:.4f} "
                   f"flags {w['fault_flags']}")
    if snap.get("attacks"):
        live = [w for w in snap["attacks"] if w["active"]]
        sched = [w for w in snap["attacks"] if not w["active"]]
        for w in live:
            end = "∞" if w["end"] is None else w["end"]
            out.append(f"  ATTACK {w['kind']} [{w['start']}, {end}) ACTIVE")
        if sched:
            out.append("  attacks scheduled: " + ", ".join(
                f"{w['kind']}@{w['start']}" for w in sched[:6]))
    for c in snap.get("contracts", []):
        mark = {"pass": "ok", "fail": "FAIL", "pending": "…"}[
            c["status"]] if c["status"] in ("pass", "fail", "pending") \
            else c["status"]
        out.append(f"  contract {c['kind']}: {mark} — {c['detail']}")
    if any(c.get("status") == "fail" for c in snap.get("contracts", [])) \
            and not snap.get("verdict_abort"):
        out.append("  CONTRACT BREACH: a live contract FAILED — verdict "
                   "journaled at the chunk boundary (run continues under "
                   "its verdict policy)")
    if snap.get("verdict_abort"):
        va = snap["verdict_abort"]
        out.append(f"  VERDICT ABORT: contract {va.get('kind')} FAILED @ "
                   f"tick {va.get('tick')} — run tore down at the chunk "
                   "boundary; restore from the last checkpoint")
        if va.get("detail"):
            out.append(f"    {va['detail']}")
    if snap.get("checkpoints"):
        out.append("  checkpoints @ " + ", ".join(
            str(t) for t in snap["checkpoints"][-4:]))
    _render_launcher(snap, out)
    _render_mh(snap, out)
    _render_ingest(snap, out)
    for c in snap.get("crashes", []):
        out.append(f"  CRASH @ tick {c.get('tick')}: {c.get('error')}")
        out.append(f"    replay: {REPLAY_CMD} {c.get('dump')}")
    return "\n".join(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("journal", help="health.jsonl path (GRAFT_HEALTH_STREAM)")
    ap.add_argument("--once", action="store_true",
                    help="print one snapshot and exit (test/script mode)")
    ap.add_argument("--json", action="store_true",
                    help="emit the snapshot as one JSON object")
    ap.add_argument("--interval", type=float, default=2.0,
                    help="live-mode refresh seconds (default 2)")
    ap.add_argument("--wait", type=float, default=0.0,
                    help="seconds to wait for the journal to appear")
    args = ap.parse_args(argv)

    deadline = time.time() + args.wait
    while not os.path.exists(args.journal):
        if time.time() >= deadline:
            print(f"no journal at {args.journal}", file=sys.stderr)
            return 1
        time.sleep(0.2)

    if args.once:
        snap = snapshot(args.journal)
        try:
            print(json.dumps(snap) if args.json else render(snap),
                  flush=True)
        except BrokenPipeError:         # `... --once | head` is fine
            os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
        return 0
    tailer = _Tailer(args.journal)
    try:
        while True:
            tailer.poll()
            snap = _snapshot_of(tailer.journal(), args.journal)
            body = json.dumps(snap) if args.json else render(snap)
            sys.stdout.write("\x1b[2J\x1b[H" + body + "\n")
            sys.stdout.flush()
            if snap.get("done") or snap.get("crashes"):
                return 0            # run over: leave the last frame up
            time.sleep(args.interval)
    except KeyboardInterrupt:
        return 0


if __name__ == "__main__":
    sys.exit(main())
