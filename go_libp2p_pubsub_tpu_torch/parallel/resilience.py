"""The distributed resilience plane: rank liveness, a coordinated abort,
and chaos drills (port of parallel/resilience.py, which imports no JAX;
this is the port's own copy).

A rank-local retry cannot be rank-symmetric (one rank re-dispatching while
its peers sit in the original chunk's collectives would deadlock or pair
the wrong collectives), so a group recovers by relaunching every rank
and resuming from the last checkpoint. This module is the rank-side half
(``python -m go_libp2p_pubsub_tpu_torch.mh_supervisor`` owns the group):

- :class:`RankLiveness` — each rank writes an atomic heartbeat file
  ``hb_rank<r>.json`` (rank, chunk, tick, wall, pid) into a shared run
  directory; a beater thread refreshes the wall stamp every
  ``beat_interval_s`` and the supervisor's chunk loop stamps progress
  (``beat``). ``check()``, called by ``supervised_run`` before every
  dispatch, raises :class:`PeerDeadError` naming a peer whose heartbeat
  went stale. For a rank already blocked inside a collective the beater
  doubles as a watchdog: ``abort_grace_s`` after first seeing a dead peer
  it exits the process with :data:`EXIT_PEER_DEAD`.
- :class:`ChaosPlan` — the ``GRAFT_CHAOS`` fault-injection knob:
  ``kill@RANK:TICK`` (the rank SIGKILLs itself at the first chunk whose
  start tick reaches TICK), ``stall@RANK:TICK:SECS`` and
  ``verdict_kill@RANK:TICK``, comma-separated. Each spec fires once per
  run directory: a marker file lands (fsync'd) before the fault, so a
  relaunch resumes past it.

Nothing here touches torch: liveness works before the process group
forms.
"""

from __future__ import annotations

import json
import os
import signal
import threading
import time

# watchdog hard-exit code: "my peer died while I was blocked in a
# collective" — distinct from a crash (1) and from SIGKILL (-9) so the
# relaunch supervisor's journal names the abort cause
EXIT_PEER_DEAD = 43

# verdict-abort exit code: a live behavior contract FAILED under
# verdict_policy="abort" and the run tore down cleanly at a chunk
# boundary (sim/supervisor.VerdictAbort). TERMINAL for the relaunch
# supervisor: the simulated network broke its contract — relaunching
# would replay the same trajectory into the same breach
EXIT_VERDICT_ABORT = 44


class PeerDeadError(RuntimeError):
    """A peer rank's heartbeat went stale/missing: this rank must abort
    its window at the next chunk boundary (the multi-process fail-fast
    crash path) instead of entering collectives the dead peer will never
    join."""


def heartbeat_path(run_dir: str, rank: int) -> str:
    return os.path.join(run_dir, f"hb_rank{rank}.json")


class RankLiveness:
    """Per-rank heartbeat writer + dead-peer detector (module docstring).

    ``start()`` launches the beater/watchdog daemon thread; ``beat()``
    stamps progress from the supervisor loop; ``check()`` raises
    :class:`PeerDeadError` on a stale peer; ``finish()`` marks this
    rank's heartbeat done (a finished rank is never read as dead);
    ``stop()`` ends the thread. ``hard_exit`` is injectable for tests —
    the real one is ``os._exit`` (atexit/finally must NOT run: the
    process is abandoning in-flight collectives, and the relaunch
    supervisor owns cleanup)."""

    def __init__(self, run_dir: str, rank: int, num_processes: int, *,
                 peer_timeout_s: float = 30.0,
                 beat_interval_s: float = 1.0,
                 startup_grace_s: float = 120.0,
                 abort_grace_s: float = 15.0,
                 hard_exit=os._exit):
        self.run_dir = run_dir
        self.rank = int(rank)
        self.num_processes = int(num_processes)
        self.peer_timeout_s = float(peer_timeout_s)
        self.beat_interval_s = float(beat_interval_s)
        self.startup_grace_s = float(startup_grace_s)
        self.abort_grace_s = float(abort_grace_s)
        self._hard_exit = hard_exit
        self._progress = {"chunk": -1, "tick": -1}
        self._done = False
        self._born = time.monotonic()
        self._dead_since: float | None = None
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._lock = threading.Lock()
        os.makedirs(run_dir, exist_ok=True)

    @classmethod
    def from_env(cls, run_dir: str, rank: int,
                 num_processes: int) -> "RankLiveness":
        """Knobs from the ``GRAFT_MH_*`` env family the relaunch
        supervisor hands every rank (tests shrink the timeouts)."""
        def _f(name, default):
            v = os.environ.get(name)
            return float(v) if v else default
        return cls(run_dir, rank, num_processes,
                   peer_timeout_s=_f("GRAFT_MH_PEER_TIMEOUT_S", 30.0),
                   beat_interval_s=_f("GRAFT_MH_BEAT_INTERVAL_S", 1.0),
                   startup_grace_s=_f("GRAFT_MH_STARTUP_GRACE_S", 120.0),
                   abort_grace_s=_f("GRAFT_MH_ABORT_GRACE_S", 15.0))

    # ---- heartbeat writes -------------------------------------------------

    def _write(self) -> None:
        with self._lock:
            rec = {"rank": self.rank, "pid": os.getpid(),
                   "wall": time.time(), "done": self._done,
                   **self._progress}
        path = heartbeat_path(self.run_dir, self.rank)
        tmp = f"{path}.tmp{os.getpid()}"
        try:
            with open(tmp, "w") as f:
                json.dump(rec, f)
            os.replace(tmp, path)       # atomic: peers never read a torn beat
        except OSError:
            pass    # a full/slow shared fs must not kill the rank itself

    def beat(self, tick: int | None = None, chunk: int | None = None) -> None:
        """Stamp progress (supervisor chunk loop) and refresh the wall."""
        with self._lock:
            if tick is not None:
                self._progress["tick"] = int(tick)
            if chunk is not None:
                self._progress["chunk"] = int(chunk)
        self._write()

    def finish(self) -> None:
        """Mark this rank's heartbeat done: ranks exit together after the
        final gather, but a peer reading the file during teardown skew
        must never take a finished rank for a dead one."""
        with self._lock:
            self._done = True
        self._write()

    # ---- dead-peer detection ----------------------------------------------

    def dead_peers(self) -> list:
        """``[(rank, reason)]`` for every peer whose heartbeat is missing
        (past the startup grace) or stale (older than ``peer_timeout_s``
        and not marked done)."""
        now = time.time()
        up_for = time.monotonic() - self._born
        out = []
        for r in range(self.num_processes):
            if r == self.rank:
                continue
            path = heartbeat_path(self.run_dir, r)
            try:
                with open(path) as f:
                    d = json.load(f)
            except (OSError, json.JSONDecodeError):
                if up_for > self.startup_grace_s:
                    out.append((r, f"no heartbeat file after "
                                   f"{up_for:.0f}s"))
                continue
            if d.get("done"):
                continue
            age = now - float(d.get("wall", 0.0))
            if age > self.peer_timeout_s:
                out.append((r, f"heartbeat {age:.1f}s stale "
                               f"(> {self.peer_timeout_s:g}s)"))
        return out

    def check(self) -> None:
        """Raise :class:`PeerDeadError` naming dead peers — the
        supervisor's pre-dispatch safe point calls this so the abort
        happens at a chunk boundary, never inside a collective."""
        dead = self.dead_peers()
        if dead:
            names = "; ".join(f"rank {r}: {why}" for r, why in dead)
            raise PeerDeadError(
                f"peer rank(s) dead ({names}) — aborting this window at a "
                "chunk boundary so no collective blocks on a dead peer; "
                "relaunch the group from the last checkpoint "
                "(python -m go_libp2p_pubsub_tpu_torch.mh_supervisor)")

    # ---- beater / watchdog thread -----------------------------------------

    def _loop(self) -> None:
        while not self._stop.wait(self.beat_interval_s):
            self._write()
            dead = self.dead_peers()
            if not dead:
                self._dead_since = None
                continue
            if self._dead_since is None:
                self._dead_since = time.monotonic()
                continue
            if time.monotonic() - self._dead_since > self.abort_grace_s \
                    and not self._stop.is_set():
                # the main thread had abort_grace_s to reach the clean
                # chunk-boundary abort; it is blocked in a collective the
                # dead peer will never join — hard-exit so the relaunch
                # supervisor can recover the group
                try:
                    names = ", ".join(str(r) for r, _why in dead)
                    print(f"[resilience] rank {self.rank}: peer rank(s) "
                          f"{names} dead and this rank is blocked; "
                          f"hard-exiting {EXIT_PEER_DEAD}", flush=True)
                except Exception:
                    pass
                self._hard_exit(EXIT_PEER_DEAD)
                return      # injectable hard_exit (tests) returns

    def start(self) -> "RankLiveness":
        self._write()       # first beat lands before the process group forms
        if self._thread is None:
            self._thread = threading.Thread(target=self._loop, daemon=True,
                                            name=f"graft-hb-r{self.rank}")
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None


# ---------------------------------------------------------------------------
# GRAFT_CHAOS: deterministic kill/stall fault injection


class ChaosPlan:
    """Parsed ``GRAFT_CHAOS`` spec, bound to one rank and one run dir.

    Spec grammar (comma-separated)::

        kill@RANK:TICK          rank RANK SIGKILLs itself at the first
                                chunk attempt whose start tick >= TICK
        stall@RANK:TICK:SECS    rank RANK sleeps SECS inside that chunk
                                attempt (trips the chunk deadline)
        ingest_stall@TICK:SECS  the rank-0 command-plane reader pauses
                                SECS at the first boundary drain whose
                                chunk start >= TICK (the stalled-producer
                                watchdog trips → coast mode)
        ingest_kill@TICK        the reader stops for good (a SIGKILLed
                                producer that never comes back)
        verdict_kill@TICK       rank 0 SIGKILLs itself at the first chunk
                                boundary >= TICK that detected NEW
                                contract-verdict transitions — between
                                the breach and its journaled verdict
                                (the exactly-once drill: the
                                relaunch re-derives the verdict off the
                                checkpoint sidecar's monitor state and
                                journals it exactly once)

    Each spec fires ONCE per run directory: the marker file
    ``chaos_<action>_r<rank>_t<tick>.fired`` is written (fsync'd) BEFORE
    the fault, so the relaunched group resumes past the injected fault
    instead of dying to it forever. With ``run_dir=None`` the marker is
    in-memory (once per process). ``fire(info)`` is shaped as
    ``supervised_run``'s ``_chunk_hook``; the ``ingest_*`` family fires
    queue-side instead (``fire_ingest``, called by
    ``sim/commands.CommandQueue.frame_for`` — ingestion is rank 0's, so
    the specs pin to rank 0)."""

    def __init__(self, specs: list, rank: int, run_dir: str | None = None,
                 kill=None, sleep=time.sleep):
        mine = [s for s in specs if s["rank"] == int(rank)]
        self.ingest_specs = [s for s in mine
                             if s["action"].startswith("ingest_")]
        self.verdict_specs = [s for s in mine
                              if s["action"] == "verdict_kill"]
        self.specs = [s for s in mine
                      if not s["action"].startswith("ingest_")
                      and s["action"] != "verdict_kill"]
        self.rank = int(rank)
        self.run_dir = run_dir
        self._fired: set = set()
        self._kill = kill or (
            lambda: os.kill(os.getpid(), signal.SIGKILL))
        self._sleep = sleep

    @staticmethod
    def parse(text: str) -> list:
        """Parse a spec string; raises ``ValueError`` naming GRAFT_CHAOS
        on any malformed entry."""
        out = []
        for part in filter(None, (p.strip() for p in text.split(","))):
            try:
                action, rest = part.split("@", 1)
                fields = rest.split(":")
                if action == "kill" and len(fields) == 2:
                    out.append({"action": "kill", "rank": int(fields[0]),
                                "tick": int(fields[1]), "seconds": 0.0})
                    continue
                if action == "stall" and len(fields) == 3:
                    out.append({"action": "stall", "rank": int(fields[0]),
                                "tick": int(fields[1]),
                                "seconds": float(fields[2])})
                    continue
                # ingest chaos has no RANK field: the command-plane
                # reader lives on rank 0 by construction
                if action == "ingest_stall" and len(fields) == 2:
                    out.append({"action": "ingest_stall", "rank": 0,
                                "tick": int(fields[0]),
                                "seconds": float(fields[1])})
                    continue
                if action == "ingest_kill" and len(fields) == 1:
                    out.append({"action": "ingest_kill", "rank": 0,
                                "tick": int(fields[0]), "seconds": 0.0})
                    continue
                # verdict chaos pins to rank 0 like the ingest family:
                # the journaled verdict stream is rank 0's
                if action == "verdict_kill" and len(fields) == 1:
                    out.append({"action": "verdict_kill", "rank": 0,
                                "tick": int(fields[0]), "seconds": 0.0})
                    continue
            except ValueError as e:
                raise ValueError(
                    f"GRAFT_CHAOS entry {part!r}: {e} — expected "
                    "kill@RANK:TICK, stall@RANK:TICK:SECS, "
                    "ingest_stall@TICK:SECS, ingest_kill@TICK or "
                    "verdict_kill@TICK") from e
            raise ValueError(
                f"GRAFT_CHAOS entry {part!r}: expected kill@RANK:TICK, "
                "stall@RANK:TICK:SECS, ingest_stall@TICK:SECS, "
                "ingest_kill@TICK or verdict_kill@TICK")
        return out

    @classmethod
    def from_env(cls, rank: int,
                 run_dir: str | None = None) -> "ChaosPlan | None":
        text = os.environ.get("GRAFT_CHAOS", "").strip()
        if not text:
            return None
        return cls(cls.parse(text), rank, run_dir)

    def _marker(self, spec: dict) -> str:
        return (f"chaos_{spec['action']}_r{spec['rank']}"
                f"_t{spec['tick']}.fired")

    def _claim(self, spec: dict, info: dict) -> bool:
        """True iff this spec has not fired yet; the marker lands durably
        BEFORE the caller injects the fault (kill included)."""
        name = self._marker(spec)
        if name in self._fired:
            return False
        self._fired.add(name)
        if self.run_dir is None:
            return True
        path = os.path.join(self.run_dir, name)
        if os.path.exists(path):
            return False
        tmp = f"{path}.tmp{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump({"rank": self.rank, "wall": time.time(),
                       "chunk_start": info.get("chunk_start")}, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        return True

    def fire(self, info: dict) -> None:
        """The ``_chunk_hook``: inject any armed fault whose tick this
        chunk attempt reached."""
        start = info.get("chunk_start")
        if start is None:
            return
        for spec in self.specs:
            if start < spec["tick"] or not self._claim(spec, info):
                continue
            if spec["action"] == "kill":
                self._kill()
            else:
                self._sleep(spec["seconds"])

    def fire_verdict(self, tick: int) -> None:
        """The verdict-plane fire point (``sim/supervisor.py``): called
        at a chunk boundary that detected NEW contract-verdict
        transitions, AFTER the fold and BEFORE their journal notes are
        submitted — the exact window the exactly-once scheme must
        survive. Same once-per-run-dir fsync'd-marker discipline."""
        for spec in self.verdict_specs:
            if tick < spec["tick"] \
                    or not self._claim(spec, {"chunk_start": tick}):
                continue
            self._kill()

    def fire_ingest(self, chunk_start: int, queue) -> None:
        """The command-plane fire point (``CommandQueue.frame_for``):
        same once-per-run-dir fsync'd-marker discipline as ``fire``, but
        the fault lands on the ingest reader thread — pause (the
        watchdog trips and the run coasts) or permanent stop."""
        for spec in self.ingest_specs:
            if chunk_start < spec["tick"] \
                    or not self._claim(spec, {"chunk_start": chunk_start}):
                continue
            if spec["action"] == "ingest_kill":
                queue.kill_reader()
            else:
                queue.pause_reader(spec["seconds"])
