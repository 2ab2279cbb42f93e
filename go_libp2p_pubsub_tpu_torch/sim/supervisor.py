"""Supervised execution plane: chunked runs with checkpoints, a wall-clock
watchdog, retry/backoff down a degraded-mode ladder and replayable crash
dumps, run as a latency-hiding pipeline (port of sim/supervisor.py).

:func:`supervised_run` runs ``n_ticks`` engine ticks as a sequence of
chunks, each dispatched through ``parallel/compile_plan.py``'s
``engine_chunk`` (``key_schedule="host"``: a window of the ONE master
split ``engine.run`` makes) or ``engine_window`` (``"fold_in"``: the keys
fold from the master and the carried tick): a captured CUDA graph on the
card, the eager ticks on the CPU. ``invariant_mode="raise"`` chunks go
through ``engine.run_checked_keys``. The final state equals
``engine.run(state, cfg, tp, key, n_ticks)`` bit for bit, however the run
is chunked, checkpointed, resumed, retried or degraded.

- **Pipeline** (``async_chunks``, default on): chunk k+1 is dispatched
  while chunk k runs on the card; chunk k is then confirmed and folded
  in. A dispatch records a CUDA event behind its chunk and enqueues
  copies of its tick and health records into pinned host memory before
  anything later is enqueued, so confirming chunk k waits for chunk k
  alone, never for k+1. Any failure of chunk k discards k+1 unseen and
  retries from the last good state.
- **Donation.** A chunk whose output is not a boundary (checkpoint,
  window end, run end) hands it to the next chunk's donated executable,
  whose result is the graph's static state: the executable's next call
  overwrites it. Such a result is stamped (``compile_plan.live``); a
  retry that lands on an overwritten input replays the already-confirmed
  gap from the last boundary anchor with the same keys. Boundary outputs
  are copied off the graph's buffers, so the anchors, the checkpoints and
  the returned state are never a view of them.
- **Writer.** Checkpoint serialization and the journal's encode and
  fsync run on one bounded-queue thread (``writer_queue``). What they
  write is copied to the host on the main thread first, on a side stream
  behind the chunk's event, so the writer touches no device memory; a
  ``drain`` barrier at window end, failure and interrupt keeps the
  crash-atomicity guarantees.
- **Checkpoints** every ``checkpoint_every_ticks`` (default: every chunk
  boundary) through the crash-atomic ``.npz`` ``sim/checkpoint.save``; a
  re-invocation resumes from the newest checkpoint that restores cleanly,
  falling back past torn and foreign ones.
- **Watchdog.** Each chunk's dispatch runs under ``deadline_s`` on a
  daemon thread that enters the state's device, and its confirmation
  under the remainder of that budget. A first use of a shape (the
  capture, the port's compile) runs under ``compile_deadline_s``. An
  overrun abandons the attempt; the executable it may still load or
  replay is retired (``compile_plan.retire``), so the retry captures
  afresh and shares no static buffer with it.
- **Retry and ladder.** Transient failures back off exponentially and
  step down: on the CPU first the conservative formulations
  (``_CONSERVATIVE_MODES``: ``hop_mode="xla"``, ``edge_gather_mode=
  "scalar"``, ``selection_mode="sort"``, bit-identical by the mode
  parity suites), then halved chunks down to ``min_chunk_ticks``. On the
  card a failure never steps off the hand kernels, which those
  formulations route around: the ladder halves the chunk, and a failure
  that persists ends in the crash dump. ``initial_degrade`` is the
  caller's explicit request for the rungs, the mode rung included.
- **Crash dumps.** An unrecoverable failure (retries exhausted, or an
  invariant trip, which is never retried) writes the last good state,
  the failing window's keys and the decoded ``fault_flags`` to a crash
  directory and raises :class:`SupervisorCrash`;
  ``python -m go_libp2p_pubsub_tpu_torch.replay_crash`` replays it.
- **Command plane** (``commands``, a sim/commands.py ``CommandQueue``):
  each chunk dispatch drains one fixed-shape directive frame at its
  boundary and applies it (``apply_frame``) before the chunk runs; a
  retry re-applies the same cached frame to the same pre-apply input.
  The consumed stream offset rides every checkpoint sidecar
  (``stream_offset=``) and a resumed run seeks the queue there, so each
  directive applies exactly once. While a command plane or live contracts
  are attached no chunk is donated: a catch-up replays from keys alone
  and would lose the injected directives.
- **Live verdicts** (``contracts``, sim/adversary.py): each confirmed
  chunk's health rows fold into ``ContractMonitors`` on the main thread,
  every status transition is journaled (``contract_verdict``, ids that
  the journal readers deduplicate) before the boundary's checkpoint, and
  the monitor state rides the sidecar (``monitors=``). A failure answers
  under ``verdict_policy``: ``"journal"`` (a ``contract_alarm`` note),
  ``"snapshot"`` (an off-cadence checkpoint of the breach state) or
  ``"abort"`` (checkpoint, ``verdict_abort`` note, :class:`VerdictAbort`).
- **Traced lane** (``traced=True``): chunks run through
  ``sim/trace_export.run_traced`` on the run's own keys, host-stepped and
  synchronous; ``events_out``/``health_out`` collect the confirmed
  chunks' events and rows.

Env knobs (``SupervisorConfig.from_env``): ``GRAFT_CHUNK_TICKS``,
``GRAFT_DEADLINE_S``, ``GRAFT_CRASH_DIR``, ``GRAFT_CHECKPOINT_DIR``,
``GRAFT_HEALTH_STREAM``, ``GRAFT_ASYNC_CHUNKS``, ``GRAFT_WRITER_QUEUE``,
``GRAFT_MH_RUNG``, ``GRAFT_VERDICT_POLICY``.

The multi-process hooks (supervisor.py:206-287; parallel/multihost.py,
parallel/resilience.py): ``run_fn`` runs each chunk (the sharded chunk of
parallel/compile_plan.py), ``state_to_host`` gathers the whole state (a
collective, on the main thread at run start and at every checkpoint
boundary, so every rank reaches it) for rank 0's checkpoints and crash
dumps, ``state_from_host`` slices a restored whole state back to this
rank's rows (at the current process count: an elastic resume is logged
``resume_elastic``), ``liveness`` beats progress and is polled before
every dispatch (a dead peer fails this rank at a chunk boundary), and
``chaos`` fires its ``verdict_kill`` drill between a verdict and its
note. A failed chunk in a group of more than one process is never retried
on one rank alone: it crashes the rank, and the group relaunches from the
last checkpoint (``python -m go_libp2p_pubsub_tpu_torch.mh_supervisor``).
The fleet plane (sim/fleet.py) builds on the same primitives.
"""

from __future__ import annotations

import dataclasses
import json
import os
import queue
import re
import shutil
import threading
import time
from typing import Callable

import numpy as np
import torch

from .. import rng
from ..device import check_on
from . import checkpoint
from .config import SimConfig, TopicParams
from .hostio import fetch_local as _fetch_scalar
from .hostio import key_data as _key_data
from .state import SimState
from .telemetry import HealthRecord

_CKPT_RE = re.compile(r"^ckpt_t(\d+)(?:\.npz)?$")

# confirmation never gets less than this much wall clock: a finished
# device result reads in microseconds, so the floor only matters when the
# card is still running AND the host fell behind, and failing the chunk
# for HOST lateness would retry work the card already did
_CONFIRM_GRACE_S = 0.2


class SupervisorCrash(RuntimeError):
    """Unrecoverable supervised-run failure. ``dump_dir`` holds the crash
    dump (last-good checkpoint + crash.json), ``report`` the run log up to
    the failure."""

    def __init__(self, msg: str, dump_dir: str | None = None,
                 report: "SupervisorReport | None" = None):
        super().__init__(msg)
        self.dump_dir = dump_dir
        self.report = report


class ChunkDeadline(RuntimeError):
    """A chunk overran its wall-clock deadline (transient: retried)."""


class VerdictAbort(RuntimeError):
    """A live behaviour contract failed under ``verdict_policy="abort"``:
    the run stopped cleanly at the boundary that detected the breach (a
    checkpoint of the breach state written when a directory is set).
    ``event`` is the failing verdict, ``report`` the run log."""

    def __init__(self, msg: str, event: dict | None = None,
                 report: "SupervisorReport | None" = None):
        super().__init__(msg)
        self.event = event
        self.report = report


@dataclasses.dataclass
class SupervisorConfig:
    """Host-side supervision knobs (execution shape only; none of them can
    change the trajectory). Field for field the reference's
    (supervisor.py:161-295); the hooks of unported items are refused by
    :func:`supervised_run` and the fleet plane."""

    chunk_ticks: int = 64             # ticks per chunk
    deadline_s: float | None = None   # per-chunk wall-clock watchdog
    # bound for a first use of a (config, chunk shape): the capture, the
    # port's compile. None = unbounded
    compile_deadline_s: float | None = None
    checkpoint_dir: str | None = None
    checkpoint_every_ticks: int = 0   # 0 = at every chunk boundary
    keep_checkpoints: int = 2         # newest N kept; older pruned
    max_retries: int = 4              # consecutive failures before giving up
    backoff_base_s: float = 0.5
    backoff_factor: float = 2.0
    backoff_cap_s: float = 30.0
    min_chunk_ticks: int = 1          # ladder floor for chunk shrinking
    crash_dir: str | None = None      # default: $GRAFT_CRASH_DIR or ./graft_crash
    scenario: str | None = None       # stamped into crash.json and the
    scenario_kwargs: dict | None = None   # journal header
    sinks: tuple = ()                 # trace sinks hard_flush()ed on failure
    sleep: Callable[[float], None] = time.sleep
    # the latency-hiding pipeline; GRAFT_ASYNC_CHUNKS=0 disables it
    async_chunks: bool = True
    # bounded writer-queue depth: a full queue blocks the main loop
    writer_queue: int = 4
    # multi-process hooks (parallel/multihost.py): the chunk runner
    # ``run_fn(state, cfg, tp, keys) -> state | (state, HealthRecord)``,
    # the collective whole-state gather and its inverse on resume
    run_fn: Callable | None = None
    state_to_host: Callable | None = None
    state_from_host: Callable | None = None
    # False: checkpoint, journal and crash-dump writes are skipped
    write_files: bool = True
    # stop cleanly after this many successful chunks (checkpoint written
    # if a dir is set); None = run to n_ticks
    max_chunks: int | None = None
    # the telemetry lane: chunks carry their health records and every
    # successful chunk's rows stream to this fsync'd NDJSON journal
    health_path: str | None = None
    health_meta: dict | None = None   # extra keys of the journal header
    # parallel/resilience.RankLiveness (or any object with beat/check)
    liveness: object | None = None
    # the live command plane: a sim/commands.py CommandQueue drained and
    # applied at every chunk boundary
    commands: object | None = None
    # live behaviour contracts (sim/adversary.py) folded over the health
    # rows; needs the telemetry lane (health_path) or the traced lane
    contracts: tuple = ()
    # a failing contract's response: "journal", "snapshot" or "abort"
    # (GRAFT_VERDICT_POLICY)
    verdict_policy: str = "journal"
    # parallel/resilience.ChaosPlan (or any object with fire_verdict)
    chaos: object | None = None
    # rungs of the degrade ladder applied before the first chunk
    # (GRAFT_MH_RUNG); checkpoints keep stamping the base config
    initial_degrade: int = 0

    @staticmethod
    def from_env(**overrides) -> "SupervisorConfig":
        kw: dict = {}
        if os.environ.get("GRAFT_CHUNK_TICKS"):
            kw["chunk_ticks"] = int(os.environ["GRAFT_CHUNK_TICKS"])
        if os.environ.get("GRAFT_DEADLINE_S"):
            kw["deadline_s"] = float(os.environ["GRAFT_DEADLINE_S"])
        if os.environ.get("GRAFT_CRASH_DIR"):
            kw["crash_dir"] = os.environ["GRAFT_CRASH_DIR"]
        if os.environ.get("GRAFT_CHECKPOINT_DIR"):
            kw["checkpoint_dir"] = os.environ["GRAFT_CHECKPOINT_DIR"]
        if os.environ.get("GRAFT_HEALTH_STREAM"):
            kw["health_path"] = os.environ["GRAFT_HEALTH_STREAM"]
        if os.environ.get("GRAFT_ASYNC_CHUNKS"):
            kw["async_chunks"] = os.environ["GRAFT_ASYNC_CHUNKS"].lower() \
                not in ("0", "false", "no", "off")
        if os.environ.get("GRAFT_WRITER_QUEUE"):
            kw["writer_queue"] = int(os.environ["GRAFT_WRITER_QUEUE"])
        if os.environ.get("GRAFT_MH_RUNG"):
            kw["initial_degrade"] = int(os.environ["GRAFT_MH_RUNG"])
        if os.environ.get("GRAFT_VERDICT_POLICY"):
            kw["verdict_policy"] = os.environ["GRAFT_VERDICT_POLICY"]
        kw.update(overrides)
        return SupervisorConfig(**kw)


@dataclasses.dataclass
class SupervisorReport:
    """What the supervised run did: chunk counts, the retry/degrade trail,
    checkpoint/resume provenance, and the crash dump path (set only when
    :class:`SupervisorCrash` was raised; reach it via the exception's
    ``report``)."""

    chunks_run: int = 0
    ticks_run: int = 0
    retries: int = 0
    degrade_level: int = 0
    checkpoints: list = dataclasses.field(default_factory=list)
    resumed_from: str | None = None
    resumed_tick: int | None = None
    crash_dump: str | None = None
    events: list = dataclasses.field(default_factory=list)

    def log(self, event: str, **info) -> None:
        self.events.append({"event": event, **info})


def _hard_flush(sinks) -> None:
    for s in sinks:
        try:
            if hasattr(s, "hard_flush"):
                s.hard_flush()
            elif hasattr(s, "flush"):
                s.flush()
        except Exception:
            pass        # the failure path must never mask the failure


def _is_invariant_trip(err: BaseException) -> bool:
    # the message of sim/invariants.InvariantViolation, as the reference's
    # checkify message
    return "invariant violation" in str(err)


def _ckpt_path(ckpt_dir: str, tick: int) -> str:
    return os.path.join(ckpt_dir, f"ckpt_t{tick:09d}")


def list_checkpoints(ckpt_dir: str) -> list:
    """Supervisor checkpoints in ``ckpt_dir`` as ``[(path, tick)]``,
    ascending tick. ``path`` is the bare name ``checkpoint.restore``
    accepts (the ``.npz`` suffix stripped)."""
    if not os.path.isdir(ckpt_dir):
        return []
    out = {}
    for name in os.listdir(ckpt_dir):
        m = _CKPT_RE.match(name)
        if m:
            bare = name[:-4] if name.endswith(".npz") else name
            out[bare] = int(m.group(1))
    return sorted(((os.path.join(ckpt_dir, b), t) for b, t in out.items()),
                  key=lambda pt: pt[1])


def _prune_checkpoints(ckpt_dir: str, keep: int) -> None:
    for path, _tick in list_checkpoints(ckpt_dir)[:-keep or None]:
        for victim in (path, path + ".npz", path + ".fingerprint"):
            try:
                if os.path.isdir(victim):
                    shutil.rmtree(victim)
                elif os.path.lexists(victim):
                    os.remove(victim)
            except OSError:
                pass    # pruning is best-effort; never fail the run for it


def _try_resume(sup: SupervisorConfig, cfg: SimConfig, like: SimState,
                start_tick: int, n_ticks: int,
                report: SupervisorReport) -> tuple:
    """Newest checkpoint in the run's tick window that restores cleanly,
    falling back past torn/mismatched ones; (state, ticks_done)."""
    for path, tick in reversed(list_checkpoints(sup.checkpoint_dir)):
        if not (start_tick < tick <= start_tick + n_ticks):
            continue
        try:
            st = checkpoint.restore(
                path, like if sup.state_from_host is None
                else _whole_like(like, cfg), cfg=cfg)
        except ValueError as e:     # CheckpointCorrupt or mismatch
            report.log("resume_skip", path=path, error=str(e)[:200])
            continue
        if sup.state_from_host is not None:
            # the checkpoint restores whole; every rank slices its rows at
            # the CURRENT process count (elastic across process counts)
            saved_p = checkpoint.sidecar_meta(path).get("processes")
            now_p = checkpoint._process_count()
            if saved_p is not None and int(saved_p) != now_p:
                report.log("resume_elastic", saved_processes=int(saved_p),
                           processes=now_p)
            st = sup.state_from_host(st)
        done = int(_fetch_scalar(st.tick)) - start_tick
        if done != tick - start_tick:   # name/state tick disagreement
            report.log("resume_skip", path=path,
                       error=f"state tick {done + start_tick} != {tick}")
            continue
        report.resumed_from = path
        report.resumed_tick = tick
        report.log("resume", path=path, tick=tick)
        return st, done
    return like, 0


def _whole_like(like, cfg: SimConfig):
    """A host-side template of the whole state a rank's ``like`` (a
    SimState or a BucketedState) is a part of (shapes and dtypes only, for
    ``checkpoint.restore``)."""
    from .state import state_spec
    spec = state_spec(cfg)

    def rows(x, n):
        return torch.empty((n,) + tuple(x.shape[1:]), dtype=x.dtype)
    if isinstance(like, SimState):
        return SimState(**{
            f: rows(getattr(like, f), cfg.n_peers) if spec[f][2]
            else torch.empty(tuple(getattr(like, f).shape),
                             dtype=getattr(like, f).dtype)
            for f in SimState._fields})
    from .bucketed import EdgePlanes
    sizes = [int(c) for c, _ in cfg.degree_buckets]
    return like._replace(
        g=_whole_like(like.g, cfg),
        e=tuple(EdgePlanes(*(rows(x, c) for x in ep))
                for ep, c in zip(like.e, sizes)),
        rev=tuple(rows(r, c) for r, c in zip(like.rev, sizes)))


# the explicit conservative fallback per mode family: every mode name,
# known or not, maps to a formulation that runs everywhere. NOT "auto":
# auto resolves right back to the failing mode
_CONSERVATIVE_MODES = {"hop_mode": "xla", "edge_gather_mode": "scalar",
                       "selection_mode": "sort"}


def _degrade(exec_cfg: SimConfig, chunk_ticks: int, sup: SupervisorConfig,
             report: SupervisorReport, modes: bool) -> tuple:
    """One rung down the ladder: with ``modes`` the kernel modes first (any
    mode → the explicit conservative formulations, bit-identical per the
    mode parity suites), then chunk shrinking. Sticky for the rest of the
    run. A retry on the card passes ``modes=False``: a failing kernel is
    never hidden behind the formulations that route around it."""
    current = {f: getattr(exec_cfg, f) for f in _CONSERVATIVE_MODES}
    if modes and current != _CONSERVATIVE_MODES:
        exec_cfg = dataclasses.replace(exec_cfg, **_CONSERVATIVE_MODES)
        report.degrade_level = max(report.degrade_level, 1)
        report.log("degrade", **_CONSERVATIVE_MODES)
    elif chunk_ticks > sup.min_chunk_ticks:
        chunk_ticks = max(sup.min_chunk_ticks, chunk_ticks // 2)
        report.degrade_level += 1
        report.log("degrade", chunk_ticks=chunk_ticks)
    return exec_cfg, chunk_ticks


def _write_crash_dump(sup: SupervisorConfig, cfg: SimConfig,
                      last_good: SimState, keys_chunk, start_tick: int,
                      done: int, this_chunk: int, n_ticks: int,
                      err: BaseException,
                      report: SupervisorReport) -> str:
    from .invariants import FLAGS_VERSION, decode_flags

    base = sup.crash_dir or os.environ.get("GRAFT_CRASH_DIR") \
        or os.path.join(os.getcwd(), "graft_crash")
    stamp = time.strftime("%Y%m%dT%H%M%SZ", time.gmtime())
    dump = os.path.join(base, f"crash_{stamp}_p{os.getpid()}")
    os.makedirs(dump, exist_ok=True)
    checkpoint.save(os.path.join(dump, "last_good"), last_good, cfg=cfg)
    flags = int(_fetch_scalar(last_good.fault_flags, np.uint32))
    meta = {
        "error": str(err)[:2000],
        "error_type": type(err).__name__,
        "tick_start": start_tick + done,
        "tick_end": start_tick + done + this_chunk,
        "run_start_tick": start_tick,
        "n_ticks": n_ticks,
        "config_fingerprint": checkpoint.config_fingerprint(cfg),
        "invariant_mode": cfg.invariant_mode,
        "fault_flags": flags,
        # replay refuses by name to decode another bit layout
        "flags_version": FLAGS_VERSION,
        "fault_flag_names": decode_flags(flags),
        # the failing window's exact per-tick keys as uint32 words (under
        # "fold_in" re-derived with engine.window_keys), replay-ready in
        # either package
        "window_key_data": _key_data(keys_chunk).tolist(),
        "degrade_level": report.degrade_level,
        "retries": report.retries,
        "scenario": sup.scenario,
        "scenario_kwargs": sup.scenario_kwargs,
    }
    _write_crash_json(dump, meta)
    report.log("crash_dump", path=dump)
    return dump


def _write_crash_json(dump: str, meta: dict) -> None:
    """``dump/crash.json``, crash-atomically (temp file, fsync, rename)."""
    tmp = os.path.join(dump, f"crash.json.tmp{os.getpid()}")
    with open(tmp, "w") as f:
        json.dump(meta, f, indent=1)
        f.write("\n")
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, os.path.join(dump, "crash.json"))


def _with_deadline(fn, deadline_s, what: str, info: dict, device=None):
    """Run ``fn`` under a wall-clock deadline on a DAEMON thread that enters
    ``device`` (a worker thread starts on device 0). A timed-out call
    cannot be cancelled: the thread is abandoned and its result
    discarded. Daemon, so a wedged call cannot hang the process at exit."""
    def call():
        if device is not None and torch.device(device).type == "cuda":
            with torch.cuda.device(device):
                return fn()
        return fn()

    if deadline_s is None:
        return call()
    box: list = []

    def runner():
        try:
            box.append((True, call()))
        except BaseException as e:      # rethrown on the caller thread
            box.append((False, e))

    # two callers share this watchdog with different info schemas: the
    # single-run supervisor (chunk_*) and the fleet plane (window_*)
    start = info.get("chunk_start", info.get("window_start", "?"))
    ticks = info.get("chunk_ticks", info.get("window_ticks", "?"))
    t = threading.Thread(target=runner, daemon=True,
                         name=f"graft-chunk-t{start}")
    t.start()
    t.join(deadline_s)
    if t.is_alive():
        raise ChunkDeadline(
            f"{what} at tick {start} ({ticks} ticks) overran the "
            f"{deadline_s}s deadline")
    ok, val = box[0]
    if not ok:
        raise val
    return val


class _Writer:
    """The off-critical-path writer: checkpoint serialization, journal
    encode+fsync and terminal notes run as FIFO callables on ONE daemon
    thread behind a bounded queue. Tasks receive host data only.

    ``threaded=False`` (``async_chunks=False`` or ``invariant_mode=
    "raise"``) executes every task inline at submit. The queue bound is
    backpressure, not loss. ``flush`` (the journal's batched fsync) fires
    whenever the queue runs dry and at every :meth:`drain`. The first
    task error is stored and re-raised at the next submit or drain."""

    def __init__(self, maxsize: int = 4, flush=None, threaded: bool = True):
        self._flush = flush
        self._threaded = threaded
        self._err: BaseException | None = None
        self._thread = None
        if threaded:
            self._q: queue.Queue = queue.Queue(max(1, int(maxsize)))
            self._thread = threading.Thread(target=self._loop, daemon=True,
                                            name="graft-writer")
            self._thread.start()

    def _loop(self) -> None:
        while True:
            task = self._q.get()
            try:
                if task is None:
                    return
                if self._err is None:   # first error wins; skip the rest
                    task()
                    if self._q.empty() and self._flush is not None:
                        self._flush()
            except BaseException as e:
                self._err = e
            finally:
                self._q.task_done()

    def _reraise(self) -> None:
        err, self._err = self._err, None
        raise err

    def submit(self, task: Callable[[], None]) -> None:
        if self._err is not None:
            self._reraise()
        if not self._threaded:
            task()
            if self._flush is not None:
                self._flush()
            return
        while True:     # interruptible bounded put (backpressure point)
            try:
                self._q.put(task, timeout=0.2)
                return
            except queue.Full:
                if self._err is not None:
                    self._reraise()

    def drain(self, raise_errors: bool = True) -> None:
        """Barrier: every submitted task has fully executed, and the
        journal is fsync'd, when this returns."""
        if self._threaded:
            self._q.join()
        if raise_errors and self._err is not None:
            self._reraise()

    def close(self) -> None:
        """Drain and stop the thread. Errors stay stored: close runs in
        ``finally`` and must not mask the in-flight exception."""
        if not self._threaded or self._thread is None:
            return
        try:
            self._q.put(None)
            self._thread.join(timeout=30.0)
        finally:
            self._thread = None


def _pinned_copy(x: torch.Tensor) -> torch.Tensor:
    return torch.empty(x.shape, dtype=x.dtype,
                       pin_memory=True).copy_(x, non_blocking=True)


class _Fence:
    """A dispatched result's readiness without waiting on later work: an
    event recorded right behind the result's work and pinned host copies
    of its tick and records, all enqueued before anything later. On the
    CPU the result is ready already."""

    def __init__(self, tick: torch.Tensor, records):
        self.event = None
        self.tick, self.records = tick, records
        if tick.device.type == "cuda":
            self.tick = _pinned_copy(tick)
            if records is not None:
                self.records = HealthRecord(*(_pinned_copy(x)
                                              for x in records))
            self.event = torch.cuda.Event()
            self.event.record()

    def wait(self) -> np.ndarray:
        """Block until the result is on the card's side done; its tick."""
        if self.event is not None:
            self.event.synchronize()
        return _fetch_scalar(self.tick)


def _to_host(tree, event):
    """``tree``'s tensors as CPU tensors, copied on a side stream behind
    ``event`` (the work that made them), so the copy waits for that work
    and not for what was enqueued after it. Main thread only; the writer
    serializes the result."""
    leaves = list(tree)
    if event is None or leaves[0].device.type != "cuda":
        return tree
    dev = leaves[0].device
    side = torch.cuda.Stream(device=dev)
    with torch.cuda.stream(side):
        side.wait_event(event)
        host = [_pinned_copy(x) for x in leaves]
    side.synchronize()
    return type(tree)(*host)


def _owned(state: SimState, stamp) -> SimState:
    """``state``, or a copy of it when it lives in a graph's static
    buffers (``stamp``), which the executable's next call overwrites."""
    if stamp is None:
        return state
    return SimState(*(x.clone() for x in state))


@dataclasses.dataclass
class _Pending:
    """One dispatched-but-unconfirmed chunk. ``out`` exists the moment the
    dispatch returns while the card still computes; ``fence`` confirms it.
    ``out_stamp`` is set when ``out`` is a donated graph's static state
    (``compile_plan.live`` tells whether it still holds); ``src`` is the
    input state, the retry anchor while ``src_stamp`` is live."""

    out: SimState
    fence: _Fence
    events: list                # traced lane: the chunk's events
    health: list                # traced lane: its per-tick host rows
    info: dict
    ticks: int
    src: SimState
    src_stamp: object
    out_stamp: object
    dispatched_at: float        # monotonic stamp at dispatch-complete


def _dispatch_chunk(state: SimState, exec_cfg: SimConfig, tp: TopicParams,
                    keys_chunk, master_key, sup: SupervisorConfig,
                    traced: bool, hook, info: dict, *, donate: bool = False,
                    src_stamp=None) -> _Pending:
    """Dispatch one chunk attempt WITHOUT waiting for the card: build its
    executable (under the compile deadline: a capture on the card), run
    the fault-injection hook and the enqueue under the run deadline, and
    fence the result. ``keys_chunk is None`` selects the ``"fold_in"``
    window executable; ``donate=True`` the donated flavour. ``traced``
    runs the chunk through ``trace_export.run_traced`` (host-stepped)."""
    from ..parallel import compile_plan
    from .engine import run_checked_keys

    telemetry = sup.health_path is not None and not traced
    dev = state.tick.device
    exe = None
    if exec_cfg.invariant_mode != "raise" and not traced \
            and sup.run_fn is None:
        if keys_chunk is None:
            exe = _with_deadline(
                lambda: compile_plan.engine_window(
                    exec_cfg, state, tp, master_key,
                    int(info["chunk_ticks"]),
                    telemetry=telemetry, donate=donate),
                sup.compile_deadline_s, "compile", info, dev)
        else:
            exe = _with_deadline(
                lambda: compile_plan.engine_chunk(
                    exec_cfg, state, tp, keys_chunk,
                    telemetry=telemetry, donate=donate),
                sup.compile_deadline_s, "compile", info, dev)

    cancelled = threading.Event()
    events: list = []
    health: list = []

    def worker():
        if hook is not None:        # test/smoke fault-injection point
            hook(info)
        if cancelled.is_set():
            # the watchdog already abandoned this attempt: a late dispatch
            # must not touch buffers the retry may run from
            return None
        rec = None
        if traced:
            from .trace_export import run_traced
            out, evs = run_traced(state, exec_cfg, tp, None, 0,
                                  health_out=health, keys=keys_chunk,
                                  device=dev)
            events.extend(evs)
            return out, None, _Fence(out.tick, None)
        if sup.run_fn is not None:
            # the caller's chunk runner (the sharded chunk); a telemetry
            # runner returns (state, HealthRecord). The EXACT tuple check:
            # SimState is a tuple subclass
            out = sup.run_fn(state, exec_cfg, tp, keys_chunk)
            if type(out) is tuple:
                out, rec = out
            return out, None, _Fence(out.tick, rec)
        if exe is not None:
            out = exe(state, tp, master_key if keys_chunk is None
                      else keys_chunk)
        else:
            # "raise" mode: the tick's violation bits read on the host
            out = run_checked_keys(state, exec_cfg, tp, keys_chunk,
                                   telemetry=telemetry, device=dev)
        if telemetry:
            out, rec = out
        stamp = exe.stamp() if exe is not None else None
        return out, stamp, _Fence(out.tick, rec)

    try:
        res = _with_deadline(worker, sup.deadline_s, "chunk", info, dev)
    except BaseException as e:
        cancelled.set()
        if exe is not None and isinstance(e, ChunkDeadline):
            compile_plan.retire(exe)
        raise
    out, out_stamp, fence = res
    return _Pending(out=out, fence=fence, events=events, health=health,
                    info=info,
                    ticks=int(info["chunk_ticks"]), src=state,
                    src_stamp=src_stamp, out_stamp=out_stamp,
                    dispatched_at=time.monotonic())


def _confirm(pend: _Pending, sup: SupervisorConfig,
             scale: float = 1.0) -> None:
    """Block until the chunk's result is real, under the chunk's budget
    RE-ANCHORED to its dispatch-complete time (floored at
    ``_CONFIRM_GRACE_S``)."""
    deadline = None
    if sup.deadline_s is not None:
        deadline = max(_CONFIRM_GRACE_S, sup.deadline_s * scale
                       - (time.monotonic() - pend.dispatched_at))
    _with_deadline(pend.fence.wait, deadline, "chunk", pend.info,
                   pend.out.tick.device)


def supervised_run(state: SimState, cfg: SimConfig, tp: TopicParams,
                   key: torch.Tensor, n_ticks: int,
                   sup: SupervisorConfig | None = None, *,
                   traced: bool = False,
                   events_out: list | None = None,
                   health_out: list | None = None,
                   device=None, _chunk_hook=None) -> tuple:
    """Run ``n_ticks`` engine ticks under supervision (module docstring)
    on ``device`` (cuda unless the caller passes ``device="cpu"``; the
    state must lie there).

    Returns ``(final_state, report)``; the final state equals
    ``engine.run(state, cfg, tp, key, n_ticks)`` bit for bit (with a
    command plane: the same ticks with each frame applied at its
    boundary). Raises :class:`SupervisorCrash` after writing a crash dump
    when the run cannot make progress, :class:`VerdictAbort` when a live
    contract fails under ``verdict_policy="abort"``.

    ``traced=True`` routes chunks through ``trace_export.run_traced``
    (requires ``cfg.record_provenance``); confirmed chunks append their
    events and health rows to ``events_out``/``health_out`` (a failed
    attempt's are discarded, so a retried tick is never counted twice).
    ``_chunk_hook(info)`` is a fault-injection point called at the top of
    every chunk attempt."""
    from ..parallel import compile_plan

    check_on(state.tick.device, device)
    sup = sup or SupervisorConfig.from_env()
    if traced and sup.run_fn is not None:
        # the traced lane steps the whole state on the host; a custom
        # runner's chunk (a rank's rows) would be stepped as a whole
        raise ValueError("supervised_run: traced=True steps the state "
                         "itself and cannot honour a run_fn")
    report = SupervisorReport()
    start_tick = int(_fetch_scalar(state.tick))
    fold = cfg.key_schedule == "fold_in"
    key = key.to(state.tick.device)
    on_card = state.tick.device.type == "cuda"
    # "host": ONE master pre-split, run's exact discipline. "fold_in": the
    # keys fold on the card; crash dumps and "raise" chunks materialize
    # their windows through engine.window_keys
    all_keys = None if fold else rng.split(key, n_ticks)
    # traced and checkified chunks are host-blocking: synchronous, the
    # writer inline, no speculation
    pipelined = bool(sup.async_chunks) and not traced \
        and cfg.invariant_mode != "raise"

    done = 0
    if sup.checkpoint_dir:
        state, done = _try_resume(sup, cfg, state, start_tick, n_ticks,
                                  report)

    # the command plane: tail the stream from the stamped offset, the
    # exactly-once cursor a resumed run replays ingestion from
    ingest = sup.commands
    if ingest is not None:
        ing_off = 0
        if report.resumed_from:
            try:
                ing_off = int(checkpoint.sidecar_meta(report.resumed_from)
                              .get("stream_offset") or 0)
            except Exception:
                ing_off = 0
        ingest.start(ing_off)
        report.log("ingest_start", offset=ing_off)

    # live verdicts: the monitors resume from the sidecar's token, so a
    # relaunch re-derives only the verdicts not yet checkpointed
    monitors = None
    if sup.contracts:
        from .adversary import ContractMonitors
        if sup.verdict_policy not in ("journal", "snapshot", "abort"):
            raise ValueError(
                f"verdict_policy {sup.verdict_policy!r} unknown "
                "(supported: 'journal', 'snapshot', 'abort')")
        if sup.health_path is None and not traced:
            raise ValueError(
                "live contracts need the telemetry lane: set health_path "
                "(GRAFT_HEALTH_STREAM) so chunks carry the rows the "
                "monitors fold")
        monitors = ContractMonitors(tuple(sup.contracts))
        if report.resumed_from:
            tok = checkpoint.sidecar_meta(report.resumed_from) \
                .get("monitors")
            if tok:
                # a contract-set mismatch is refused (from_token), never a
                # silent verdict reset
                monitors = ContractMonitors.from_token(
                    tok, tuple(sup.contracts))
                report.log("verdict_resume",
                           statuses=list(monitors.statuses))

    journal = None
    if sup.health_path and sup.write_files:
        from .telemetry import HealthJournal
        # pipelined: ONE fsync per writer-queue drain instead of one per
        # line (the torn-tail-tolerant reader copes either way)
        journal = HealthJournal(sup.health_path,
                                sync_every_write=not pipelined)
        journal.header(cfg, scenario=sup.scenario, start_tick=start_tick,
                       n_ticks=n_ticks, resumed_tick=report.resumed_tick,
                       traced=traced, **(sup.health_meta or {}))

    writer = _Writer(maxsize=sup.writer_queue,
                     flush=journal.sync if journal is not None else None,
                     threaded=pipelined)

    exec_cfg = cfg
    chunk_ticks = max(1, int(sup.chunk_ticks))
    for _ in range(max(0, int(sup.initial_degrade))):
        exec_cfg, chunk_ticks = _degrade(exec_cfg, chunk_ticks, sup, report,
                                         modes=True)
    every = sup.checkpoint_every_ticks or chunk_ticks
    next_ckpt = done + every
    failures = 0            # consecutive; reset on every successful chunk
    # retry/dump anchor: the newest confirmed boundary state, owned (never
    # a view of a graph's buffers), and the progress offset it holds
    anchor_state, anchor_done = state, done
    # multi-process: the newest whole copy and the progress offset it was
    # gathered at, refreshed at every checkpoint-cadence boundary on the
    # main thread (state_to_host is a collective: never in the error
    # path, where one rank alone would enter it); the crash path dumps it
    last_host_state, last_host_done = None, done
    if sup.state_to_host is not None:
        last_host_state = sup.state_to_host(state)
    multiproc = sup.run_fn is not None and checkpoint._process_count() > 1

    def beat(tick: int, chunk: int) -> None:
        # liveness progress stamp: a shared-filesystem hiccup never fails
        # the run (the beater thread keeps the wall stamp fresh)
        if sup.liveness is not None:
            try:
                sup.liveness.beat(tick=tick, chunk=chunk)
            except Exception:
                pass

    beat(start_tick + done, 0)

    def chunk_keys(lo: int, hi: int):
        if all_keys is not None:
            return all_keys[lo:hi]
        from .engine import window_keys
        return window_keys(cfg, key, start_tick, lo, hi, n_ticks)

    def dispatch(src, src_stamp, c_done: int, ticks: int, info: dict,
                 donate: bool, hook=_chunk_hook) -> _Pending:
        anchor_src = src
        frame = None
        if ingest is not None and not info.get("catchup"):
            # the boundary drain (cached per chunk_start: a retry gets the
            # SAME frame), applied with the BASE cfg out of place
            frame = ingest.frame_for(start_tick + c_done, ticks)
            if frame.count:
                src = ingest.apply(src, cfg, tp, frame)
            info["directives"] = int(frame.count)
            info["ingest_frame"] = frame
        keys_chunk = None
        if not (fold and not traced and cfg.invariant_mode != "raise") \
                or sup.run_fn is not None:
            keys_chunk = chunk_keys(c_done, c_done + ticks)
        p = _dispatch_chunk(src, exec_cfg, tp, keys_chunk, key, sup,
                            traced, hook, info, donate=donate,
                            src_stamp=src_stamp)
        if frame is not None:
            # a retry resets the carry to the recorded input and
            # re-applies the cached frame: the PRE-apply state, or the
            # frame would apply twice
            p.src = anchor_src
        return p

    def handle_failure(e: Exception, info: dict, fail_done: int,
                       this_chunk: int, last_good, last_stamp,
                       good_done: int) -> None:
        """The retry/degrade/crash ladder, shared by every failure site.
        Raises :class:`SupervisorCrash` or records retry bookkeeping and
        sleeps the backoff."""
        nonlocal exec_cfg, chunk_ticks, failures
        _hard_flush(sup.sinks)
        failures += 1
        if _is_invariant_trip(e) or multiproc \
                or failures > sup.max_retries:
            # invariant trips are never retried: the trajectory itself is
            # poisoned and would trip again on the same keys. In a group
            # a retry on one rank would pair its collectives with its
            # peers' wrong ones: the rank crashes and the group relaunches
            writer.drain(raise_errors=False)    # pending checkpoints land
            dump = None
            if sup.write_files and sup.state_to_host is not None:
                if last_host_state is not None:
                    # the gathered copy may be chunks old: re-anchor the
                    # dumped window to its tick
                    w0, w1 = last_host_done, fail_done + this_chunk
                    dump = _write_crash_dump(sup, cfg, last_host_state,
                                             chunk_keys(w0, w1), start_tick,
                                             w0, w1 - w0, n_ticks, e, report)
            elif sup.write_files:
                if last_good is None or not compile_plan.live(last_stamp):
                    # the failing chunk's direct input was overwritten by
                    # a donated replay: dump the anchor and re-anchor the
                    # window to its tick
                    last_good, good_done = anchor_state, anchor_done
                w0, w1 = good_done, fail_done + this_chunk
                dump = _write_crash_dump(sup, cfg, last_good,
                                         chunk_keys(w0, w1), start_tick,
                                         w0, w1 - w0, n_ticks, e, report)
            report.crash_dump = dump
            if journal is not None:
                writer.submit(lambda: journal.note(
                    "crash", tick=start_tick + fail_done, dump=dump,
                    error=str(e)[:200]))
                writer.drain(raise_errors=False)
            raise SupervisorCrash(
                f"supervised run gave up at tick {start_tick + fail_done} "
                f"({failures} consecutive failure(s)); crash dump: "
                f"{dump}", dump_dir=dump, report=report) from e
        report.retries += 1
        report.log("chunk_failed",
                   kind="deadline" if isinstance(e, ChunkDeadline)
                   else "error", error=str(e)[:200], **info)
        exec_cfg, chunk_ticks = _degrade(exec_cfg, chunk_ticks, sup, report,
                                         modes=not on_card)
        delay = min(sup.backoff_cap_s, sup.backoff_base_s
                    * sup.backoff_factor ** (failures - 1))
        report.log("backoff", delay_s=round(delay, 3))
        sup.sleep(delay)

    # confirmed head of the carry chain; its stamp is set while it is a
    # donated graph's static state
    carry, carry_stamp, carry_done = state, None, done
    pend: _Pending | None = None
    window_end_hit = False

    def process(p: _Pending) -> None:
        """Fold a CONFIRMED chunk into the run: counters, journal rows
        (through the writer), the boundary anchor and checkpoint, window
        accounting. Main thread only."""
        nonlocal done, carry, carry_stamp, carry_done, next_ckpt, failures
        nonlocal anchor_state, anchor_done, window_end_hit
        nonlocal last_host_state, last_host_done
        done_wall = time.time()
        fr = p.info.pop("ingest_frame", None)
        failures = 0
        done += p.ticks
        carry, carry_stamp, carry_done = p.out, p.out_stamp, done
        report.chunks_run += 1
        report.ticks_run += p.ticks
        report.log("chunk_ok", **p.info)
        beat(start_tick + done, report.chunks_run)
        if events_out is not None:
            events_out.extend(p.events)
        if health_out is not None:
            health_out.extend(p.health)
        if journal is not None:
            # the SUCCESSFUL chunk's rows (a failed attempt's died with its
            # discarded output): the records already in pinned host
            # memory, or the traced lane's row dicts
            t0, tks = start_tick + done - p.ticks, p.ticks
            if p.fence.records is not None:
                writer.submit(lambda rec=p.fence.records:
                              journal.append_records(
                                  rec, tick_start=t0, ticks=tks,
                                  done_wall=done_wall))
            elif traced and p.health:
                writer.submit(lambda rows=list(p.health):
                              journal.append_dicts(
                                  rows, tick_start=t0, ticks=tks,
                                  done_wall=done_wall))
            else:
                writer.submit(lambda: journal.note(
                    "chunk", rows=0, tick_start=t0, ticks=tks,
                    done_wall=done_wall))
        if journal is not None and fr is not None:
            # ingest markers journal after the chunk that carried them
            # confirmed: a discarded attempt's journal when its retry
            # lands, never twice (the frame cache hands the retry the same
            # notes)
            for kind, meta in fr.notes:
                writer.submit(lambda k=kind, m=dict(meta):
                              journal.note(k, **m))
            writer.submit(lambda f=fr, t=start_tick + done: journal.note(
                "ingest", tick=t, directives=f.count, shed=f.shed,
                shed_total=f.shed_total, refused_total=f.refused_total,
                queue_depth=f.depth, lag_ticks=f.lag, offset=f.offset,
                coasting=f.coasting))
        # live verdicts: fold this chunk's rows (host side, main thread),
        # journal every transition BEFORE the boundary's checkpoint (a
        # checkpoint whose sidecar says "these verdicts happened" exists
        # only after their notes were journaled), arm the FAIL response
        force_ckpt = False
        abort_ev = None
        if monitors is not None:
            rows = None
            if p.fence.records is not None:
                from .telemetry import records_to_rows, rows_to_dicts
                rows = rows_to_dicts(*records_to_rows(p.fence.records))
            elif traced and p.health:
                rows = list(p.health)
            new_events = monitors.fold_rows(rows) if rows else []
            if done >= n_ticks:
                # the true run end only (a bounded window resumes later):
                # pending contracts settle
                new_events = new_events + monitors.finalize()
            if new_events and sup.chaos is not None:
                # verdict_kill@TICK drill: die between the breach and its
                # journaled verdict (parallel/resilience.ChaosPlan)
                fire = getattr(sup.chaos, "fire_verdict", None)
                if fire is not None:
                    fire(start_tick + done)
            for ev in new_events:
                report.log("contract_verdict", contract=ev["contract"],
                           kind=ev["kind"], status=ev["status"],
                           tick=ev["tick"], id=ev["id"])
                if journal is not None:
                    # the contract's kind travels as contract_kind: "kind"
                    # is the note's own type tag
                    writer.submit(lambda e=dict(ev): journal.note(
                        "contract_verdict",
                        **{("contract_kind" if k == "kind" else k): v
                           for k, v in e.items()}))
            failed = [ev for ev in new_events if ev["status"] == "fail"]
            if failed:
                # never a silent continue: every policy leaves a named
                # trail, and only "abort" stops the run
                if sup.verdict_policy == "abort":
                    abort_ev = dict(failed[0])
                    force_ckpt = True   # the breach state lands durably
                elif sup.verdict_policy == "snapshot":
                    force_ckpt = True   # off-cadence breach checkpoint
                    if not sup.checkpoint_dir and journal is not None:
                        writer.submit(lambda e=dict(failed[0]): journal.note(
                            "contract_snapshot_skipped",
                            reason="no checkpoint_dir",
                            contract=e["contract"],
                            contract_kind=e["kind"], tick=e["tick"]))
                elif journal is not None:       # "journal"
                    for ev in failed:
                        writer.submit(lambda e=dict(ev): journal.note(
                            "contract_alarm", policy="journal",
                            contract=e["contract"],
                            contract_kind=e["kind"], tick=e["tick"],
                            id=e["id"], detail=e["detail"]))
        window_end = sup.max_chunks is not None \
            and report.chunks_run >= sup.max_chunks and done < n_ticks
        # a window end is ALWAYS a boundary: "stop cleanly (checkpoint
        # written if a dir is set)"
        if done >= next_ckpt or done >= n_ticks or window_end or force_ckpt:
            pause_t0 = time.perf_counter()
            if sup.state_to_host is not None:
                # collective on EVERY rank at the checkpoint cadence, even
                # with no checkpoint_dir: the crash dump's freshness
                last_host_state = sup.state_to_host(p.out)
                last_host_done = done
            if sup.checkpoint_dir and sup.write_files:
                to_save = _to_host(p.out, p.fence.event) \
                    if sup.state_to_host is None else last_host_state
                path = _ckpt_path(sup.checkpoint_dir, start_tick + done)
                report.checkpoints.append(path)
                report.log("checkpoint", tick=start_tick + done, path=path)
                # exactly-once stamps: the consumed stream offset as of
                # this chunk's frame and the monitors after this chunk's
                # fold (a whitespace-free token: sidecar_meta splits on
                # whitespace)
                extra = {}
                if fr is not None:
                    extra["stream_offset"] = fr.offset
                if monitors is not None:
                    extra["monitors"] = monitors.state_token()

                def save(to_save=to_save, path=path, extra=extra or None):
                    os.makedirs(sup.checkpoint_dir, exist_ok=True)
                    checkpoint.save(path, to_save, cfg=cfg,
                                    extra=extra)    # crash-atomic
                    _prune_checkpoints(sup.checkpoint_dir,
                                       sup.keep_checkpoints)
                writer.submit(save)
                if journal is not None:
                    writer.submit(lambda t=start_tick + done, pth=path:
                                  journal.note("checkpoint", tick=t,
                                               path=pth))
            # the anchor, and the carry from here, own their tensors
            anchor_state, anchor_done = _owned(p.out, p.out_stamp), done
            carry, carry_stamp = anchor_state, None
            next_ckpt = done + every
            # the main-thread stall this boundary cost
            report.log("boundary", tick=start_tick + done,
                       pause_ms=round((time.perf_counter() - pause_t0)
                                      * 1e3, 3))
        if window_end:
            # the caller resumes the same (key, n_ticks) schedule later:
            # the per-tick keys are a function of both
            report.log("window_end", chunks=report.chunks_run,
                       tick=start_tick + done)
            window_end_hit = True
        if abort_ev is not None:
            # "abort": this boundary is the safe point; the breach
            # checkpoint was submitted above, the note names the failing
            # contract, and the drain makes both durable before the raise
            if journal is not None:
                writer.submit(lambda e=dict(abort_ev): journal.note(
                    "verdict_abort", policy="abort",
                    contract=e["contract"], contract_kind=e["kind"],
                    tick=e["tick"], id=e["id"], detail=e["detail"]))
            writer.drain(raise_errors=False)
            report.log("verdict_abort", contract=abort_ev["contract"],
                       kind=abort_ev["kind"], tick=abort_ev["tick"])
            raise VerdictAbort(
                f"contract {abort_ev['contract']} "
                f"({abort_ev['kind']}) FAILED at tick "
                f"{abort_ev['tick']} under verdict_policy='abort': "
                f"{abort_ev['detail']}", event=abort_ev, report=report)

    try:
        while done < n_ticks and not window_end_hit:
            # ---- refill: nothing in flight → dispatch the next chunk
            if pend is None:
                if sup.liveness is not None:
                    # dead-peer poll at the pre-dispatch safe point, the
                    # last place this rank can stop without abandoning a
                    # peer inside a collective; the multi-process branch
                    # of handle_failure dumps and raises SupervisorCrash
                    try:
                        sup.liveness.check()
                    except Exception as e:
                        info = {"chunk_start": start_tick + done,
                                "chunk_ticks": 0, "attempt": failures,
                                "liveness": True}
                        handle_failure(e, info, done, 0, carry, carry_stamp,
                                       done)
                        continue
                if not compile_plan.live(carry_stamp):
                    # a donated replay overwrote the carry before its
                    # chunk failed: fall back to the anchor
                    carry, carry_stamp, carry_done = \
                        anchor_state, None, anchor_done
                if carry_done < done:
                    # replay the already-confirmed gap with the same keys,
                    # bit-exact, with no journal/report side effects and
                    # no fault hook (not an attempt)
                    cu_info = {"chunk_start": start_tick + carry_done,
                               "chunk_ticks": done - carry_done,
                               "attempt": failures, "catchup": True,
                               "degrade_level": report.degrade_level}
                    try:
                        cu = dispatch(carry, carry_stamp, carry_done,
                                      done - carry_done, cu_info,
                                      donate=False, hook=None)
                        _confirm(cu, sup, scale=max(
                            1.0, (done - carry_done) / chunk_ticks))
                    except Exception as e:
                        handle_failure(e, cu_info, carry_done,
                                       done - carry_done, carry,
                                       carry_stamp, carry_done)
                        continue
                    report.log("catchup", **cu_info)
                    carry, carry_stamp, carry_done = \
                        cu.out, cu.out_stamp, done
                this_chunk = min(chunk_ticks, n_ticks - done)
                info = {"chunk_start": start_tick + done,
                        "chunk_ticks": this_chunk, "attempt": failures,
                        "degrade_level": report.degrade_level}
                try:
                    pend = dispatch(carry, carry_stamp, done, this_chunk,
                                    info, donate=False)
                except Exception as e:
                    handle_failure(e, info, done, this_chunk, carry,
                                   carry_stamp, done)
                    continue

            # ---- speculate: dispatch chunk k+1 while chunk k is in flight
            spec: _Pending | None = None
            spec_exc = None
            p_end = done + pend.ticks
            window_after = sup.max_chunks is not None \
                and report.chunks_run + 1 >= sup.max_chunks
            # the input of a boundary-ending chunk stays undonated
            p_boundary = p_end >= next_ckpt or p_end >= n_ticks \
                or window_after
            if pipelined and failures == 0 and p_end < n_ticks \
                    and not window_after:
                s_ticks = min(chunk_ticks, n_ticks - p_end)
                s_info = {"chunk_start": start_tick + p_end,
                          "chunk_ticks": s_ticks, "attempt": 0,
                          "degrade_level": report.degrade_level}
                # live contracts can force an off-cadence checkpoint at any
                # confirm, and a catch-up would lose applied frames: no
                # donation while either is attached
                donate = not p_boundary and sup.commands is None \
                    and not sup.contracts
                try:
                    spec = dispatch(pend.out, pend.out_stamp, p_end, s_ticks,
                                    s_info, donate=donate)
                except Exception as e:
                    spec_exc = (e, s_info, s_ticks)
                except BaseException:
                    # KeyboardInterrupt/SystemExit mid-overlap: chunk k is
                    # still good — confirm it and push its journal rows
                    # and checkpoint through the writer so a kill resumes
                    # from the last DRAINED checkpoint
                    try:
                        _confirm(pend, sup)
                        process(pend)
                        writer.drain(raise_errors=False)
                    except Exception:
                        pass
                    raise

            # ---- confirm chunk k (re-anchored deadline) and fold it in
            try:
                _confirm(pend, sup)
            except Exception as e:
                if spec is not None or spec_exc is not None:
                    # the in-flight k+1 consumed a poisoned input: its
                    # result is discarded unseen
                    report.log("spec_discarded",
                               chunk_start=start_tick + p_end)
                info, ticks = pend.info, pend.ticks
                src, src_stamp = pend.src, pend.src_stamp
                pend, spec, spec_exc = None, None, None
                handle_failure(e, info, done, ticks, src, src_stamp, done)
                # reset the carry for the retry: the direct input while it
                # holds, else the anchor (+ silent catch-up above)
                if src is not None and compile_plan.live(src_stamp):
                    carry, carry_stamp, carry_done = src, src_stamp, done
                else:
                    carry, carry_stamp, carry_done = \
                        anchor_state, None, anchor_done
                continue
            process(pend)
            pend = None
            if spec_exc is not None:
                e, s_info, s_ticks = spec_exc
                handle_failure(e, s_info, done, s_ticks, carry, carry_stamp,
                               done)
                continue
            pend = spec

        if journal is not None:
            # terminal marker: a bounded-window stop (max_chunks) is a
            # PAUSE the caller resumes; only true completion is "run_end"
            ing_meta = {}
            if ingest is not None:
                ing_meta = {
                    "commands_applied": int(
                        getattr(ingest, "applied_total", 0)),
                    "commands_shed": int(getattr(ingest, "shed_total", 0)),
                    "commands_refused": int(
                        getattr(ingest, "refused_total", 0)),
                    "ingest_offset": int(
                        getattr(ingest, "consumed_offset", 0))}
            writer.submit(lambda: journal.note(
                "window_end" if done < n_ticks else "run_end",
                tick=start_tick + done, chunks=report.chunks_run,
                retries=report.retries,
                degrade_level=report.degrade_level, **ing_meta))
        # drain barrier: every checkpoint is durable and the journal
        # fsync'd before the caller sees the final state
        writer.drain()
    finally:
        writer.close()
        if journal is not None:
            journal.close()
    return _owned(carry, carry_stamp), report
