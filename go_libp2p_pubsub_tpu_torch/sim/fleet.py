"""Fleet plane: B independent simulations advanced window by window as one
executable (port of sim/fleet.py).

A sweep is thousands of concurrent experiments, not one big run: B members
that share one ``SimConfig`` (varying seeds, score weights through their
``TopicParams`` rows, and initial states) run as ONE window executable,
``parallel/compile_plan.fleet_chunk``: on the card one CUDA graph of a
member's ticks replayed over the members, on the CPU the same ticks
eagerly.

- **bit-exact per member**: each member's keys are split ONCE with
  ``engine.run``'s discipline and every window takes a contiguous slice,
  so member i's trajectory equals ``engine.run(state_i, cfg_i, tp_i,
  key_i, n_ticks_i)`` bit for bit, plain, under faults and across
  kill/resume.
- **config grouping**: members are grouped by the config they execute
  under; each group runs its own windows. Results return in input order.
- **per-member fault isolation**: ``fault_flags`` is per member.
  ``invariant_mode="raise"`` members execute in ``"record"`` (the same
  state) and are RETIRED at the window boundary where a violation bit
  shows: the member's state freezes (``FleetResult.tripped``), its
  siblings run on.
- **compaction**: finished and retired members leave the batch at window
  boundaries; windows end exactly at member finishes (``min(chunk, the
  least remaining among the active)``), so no window splits a member's
  key stream.
- **supervision**: :func:`supervised_fleet_run` runs the windows under
  sim/supervisor.py's watchdog, retry/backoff ladder and writer, with
  crash-atomic fleet checkpoints in ``checkpoint_dir/fleet_gNN/`` whose
  fingerprint binds the fleet axis (a B=4 journal never resumes into
  B=8), resume that checks every member's tick against the schedule,
  and fleet crash dumps with per-member flags.

:func:`shard_fleet` places a stacked fleet over a list of devices
(fleet.py:150-191): members are independent, so the fleet splits into
contiguous member blocks, one per device, each stacked on its device
(a PyTorch tensor lives on one device, so the placement is a list of
parts where the reference's is one sharded array); on one device it is
the identity.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time

import numpy as np
import torch

from .. import rng
from ..device import check_on
from ..parallel import compile_plan
from . import checkpoint
from .config import SimConfig, TopicParams
from .hostio import fetch_local, key_data
from .state import SimState
from .supervisor import (_CONFIRM_GRACE_S, ChunkDeadline, SupervisorConfig,
                         SupervisorCrash, SupervisorReport, _ckpt_path,
                         _degrade, _Fence, _prune_checkpoints, _to_host,
                         _with_deadline, _write_crash_json, _Writer,
                         list_checkpoints)


@dataclasses.dataclass(frozen=True)
class FleetMember:
    """One member of a fleet: a full (cfg, tp, state, key, n_ticks) run
    spec, exactly what ``engine.run`` takes. ``name`` labels the member in
    reports and crash dumps."""

    cfg: SimConfig
    tp: TopicParams
    state: SimState
    key: torch.Tensor
    n_ticks: int
    name: str = ""


@dataclasses.dataclass
class FleetResult:
    """Per-member outcome. ``state`` is the member's final state
    (bit-identical to its sequential run); ``tripped`` marks a member
    whose ``invariant_mode="raise"`` sentinel fired, its state frozen at
    the end of the window where the trip was seen. ``health_rows``
    (``collect_health=True`` runs) is the member's per-tick telemetry row
    stream (sim/telemetry.py dict rows)."""

    name: str
    state: SimState
    ticks_run: int
    fault_flags: int
    flag_names: list
    tripped: bool
    health_rows: list | None = None


# ---------------------------------------------------------------------------
# the batched core


def fleet_run_keys(states: SimState, cfg: SimConfig, tps: TopicParams,
                   keys: torch.Tensor, telemetry: bool = False,
                   device=None):
    """Advance B stacked members one tick per row of ``keys`` (``[C, B,
    2]``, tick-major), eagerly, member after member: the plain yardstick
    of ``compile_plan.fleet_chunk``'s window. ``telemetry=True`` returns
    ``(states, HealthRecord)`` with ``[C, B]`` records."""
    check_on(states.tick.device, device)
    from .engine import _plain, check_slice
    _plain(cfg, "fleet_run_keys")
    check_slice(cfg)
    exe = compile_plan.FleetExecutable(cfg, int(keys.shape[0]), telemetry,
                                       states.tick.device)
    return exe._eager(states, tps, keys.to(states.tick.device))


def fleet_run_keys_donated(states: SimState, cfg: SimConfig,
                           tps: TopicParams, keys: torch.Tensor,
                           telemetry: bool = False, device=None):
    """:func:`fleet_run_keys` that writes the members' final states back
    into ``states``'s tensors and returns them (the donated flavour)."""
    out = fleet_run_keys(states, cfg, tps, keys, telemetry, device)
    new = out[0] if telemetry else out
    for dst, src in zip(states, new):
        dst.copy_(src)
    return (states, out[1]) if telemetry else states


def stack_states(items: list):
    """Stack member tuples (SimState or TopicParams) along a new leading
    fleet axis."""
    return type(items[0])(*(torch.stack(xs) for xs in zip(*items)))


def fleet_devices(b: int, devices: list | None = None) -> int:
    """How many devices a B-member fleet splits across: the largest count
    of ``devices`` (default: the visible CUDA devices, at least one) that
    divides B."""
    d = len(devices) if devices is not None \
        else max(1, torch.cuda.device_count())
    return max(k for k in range(1, d + 1) if b % k == 0)


def shard_fleet(states: SimState, tps: TopicParams, keys=None,
                devices: list | None = None):
    """Place a stacked fleet over ``devices``: the members split into
    :func:`fleet_devices` contiguous blocks, block i stacked on
    ``devices[i]``. Returns ``(states, tps)`` or ``(states, tps, keys)``
    (``keys``: one ``[C, B, 2]`` window, fleet axis second, or a list of
    them): on one device the inputs themselves, else each a list of the
    per-device parts in device order."""
    b = int(states.tick.shape[0])
    d = fleet_devices(b, devices)
    if d == 1:
        return (states, tps) if keys is None else (states, tps, keys)
    per = b // d
    devs = [torch.device(x) for x in devices[:d]]

    def part(tree, i, axis=0):
        sl = slice(i * per, (i + 1) * per)
        return type(tree)(*(x.narrow(axis, sl.start, per).to(devs[i])
                            for x in tree))

    out_s = [part(states, i) for i in range(d)]
    out_t = [part(tps, i) for i in range(d)]
    if keys is None:
        return out_s, out_t

    def kpart(k, i):
        return k.narrow(1, i * per, per).to(devs[i])
    if isinstance(keys, (list, tuple)):
        return out_s, out_t, [[kpart(k, i) for k in keys] for i in range(d)]
    return out_s, out_t, [kpart(keys, i) for i in range(d)]


def member_state(batched, i: int):
    """Member ``i``'s unbatched tuple out of a fleet-stacked one."""
    return type(batched)(*(x[i] for x in batched))


def _take_rows(tree, idx: torch.Tensor):
    return type(tree)(*(x.index_select(0, idx) for x in tree))


def _put_rows(full, idx: torch.Tensor, rows):
    return type(full)(*(f.index_copy(0, idx, r) for f, r in zip(full, rows)))


def _exec_cfg(cfg: SimConfig) -> SimConfig:
    """The config a member EXECUTES under: ``"raise"`` members run
    ``"record"`` (the same state: the flags land in ``fault_flags`` either
    way) and the window loop retires them at the boundary where a violation
    bit appears, so one member's trip cannot stop B-1 healthy ones."""
    if cfg.invariant_mode == "raise":
        return dataclasses.replace(cfg, invariant_mode="record")
    return cfg


# A fleet window runs split into a DISPATCH phase (hook + enqueue) and a
# CONFIRM phase (wait on the window's fence, deadline re-anchored to the
# time already in flight): while window k runs on the card, the loop
# builds and dispatches window k+1 and the writer drains window k-1's
# I/O. First-use bookkeeping lives in compile_plan.fleet_chunk.


def _dispatch_window(w, exec_cfg, sup, hook, telemetry: bool = False):
    """Enqueue one window attempt; returns a pending dict whose ``out``/
    ``merged``/``health`` leaves may still be computing. Only the hook,
    the capture of a first use and the enqueue run under the deadline
    here; the card's time is bounded by :func:`_confirm_window`."""
    exe, first_use = compile_plan.fleet_chunk(
        exec_cfg, w["sub"], w["sub_tps"], w["keys"], telemetry=telemetry,
        mark=False)
    cancelled = threading.Event()

    def worker():
        if hook is not None:            # test/smoke fault-injection point
            hook(w["info"])
        if cancelled.is_set():
            return None
        res = exe(w["sub"], w["sub_tps"], w["keys"])
        out, health = res if telemetry else (res, None)
        # the merged group state, enqueued before anything later
        merged = out if w["whole"] else _put_rows(w["base"], w["idx"], out)
        return out, health, merged, _Fence(merged.tick, health)

    # a first-use window captures AND runs: bounded by the compile
    # deadline (unbounded by default), steady-state windows by the run
    # watchdog
    deadline = sup.compile_deadline_s if first_use else sup.deadline_s
    dev = w["sub"].tick.device
    try:
        out, health, merged, fence = _with_deadline(
            worker, deadline, "fleet compile+window" if first_use
            else "fleet window", w["info"], dev)
    except BaseException as e:
        cancelled.set()
        if isinstance(e, ChunkDeadline):
            compile_plan.retire(exe)
        raise
    return {"w": w, "out": out, "health": health, "merged": merged,
            "fence": fence, "cfg": exec_cfg, "telemetry": telemetry,
            "first_use": first_use, "at": time.monotonic()}


def _confirm_window(pend, sup) -> None:
    """Block until the pending window's result lands, under the remainder
    of its deadline (floored at the grace period)."""
    budget = sup.compile_deadline_s if pend["first_use"] else sup.deadline_s
    deadline = None
    if budget is not None:
        deadline = max(_CONFIRM_GRACE_S,
                       budget - (time.monotonic() - pend["at"]))
    w = pend["w"]
    _with_deadline(pend["fence"].wait, deadline,
                   "fleet compile+window" if pend["first_use"]
                   else "fleet window", w["info"], w["sub"].tick.device)
    # mark the shape captured only now: a window that died mid-capture
    # keeps its compile-deadline budget on retry
    compile_plan.fleet_chunk(pend["cfg"], w["sub"], w["sub_tps"], w["keys"],
                             telemetry=pend["telemetry"])


# ---------------------------------------------------------------------------
# supervision plumbing (fleet flavour of the sim/supervisor.py pieces)


def _expected_ticks(starts, n_ticks, done: int) -> np.ndarray:
    return starts + np.minimum(done, np.asarray(n_ticks, np.int64))


def _try_resume_fleet(sup, ckpt_dir, group_cfg, full, starts, n_ticks,
                      escalate, report, gi):
    """Newest fleet checkpoint that restores cleanly AND whose per-member
    ticks match the window schedule at its recorded progress; tripped
    members (violation bits on a raise-mode lane) are exempt, they froze
    early by design."""
    from .invariants import VIOLATION_MASK

    for path, done in reversed(list_checkpoints(ckpt_dir)):
        try:
            st = checkpoint.restore(path, full, cfg=group_cfg)
        except ValueError as e:         # corrupt, mismatched, wrong fleet
            report.log("resume_skip", group=gi, path=path,
                       error=str(e)[:200])
            continue
        ticks = fetch_local(st.tick).astype(np.int64)
        flags = fetch_local(st.fault_flags, np.uint32)
        tripped = [bool(esc and (int(f) & VIOLATION_MASK))
                   for esc, f in zip(escalate, flags)]
        want = _expected_ticks(starts, n_ticks, done)
        if not all(t == w or tr for t, w, tr in zip(ticks, want, tripped)):
            report.log("resume_skip", group=gi, path=path,
                       error=f"member ticks {ticks.tolist()} do not match "
                             f"schedule at done={done}")
            continue
        report.resumed_from = path
        report.resumed_tick = done
        report.log("resume", group=gi, path=path, done=done)
        return st, done, tripped
    return full, 0, [False] * len(n_ticks)


def _write_fleet_crash_dump(sup, group_cfg, full, keys_win, gi, active,
                            names, idxs, done, this_win, err,
                            report) -> str:
    from .invariants import FLAGS_VERSION, decode_flags

    base = sup.crash_dir or os.environ.get("GRAFT_CRASH_DIR") \
        or os.path.join(os.getcwd(), "graft_crash")
    stamp = time.strftime("%Y%m%dT%H%M%SZ", time.gmtime())
    dump = os.path.join(base, f"crash_fleet_{stamp}_p{os.getpid()}")
    os.makedirs(dump, exist_ok=True)
    checkpoint.save(os.path.join(dump, "last_good"), full, cfg=group_cfg)
    flags = [int(f) for f in fetch_local(full.fault_flags, np.uint32)]
    meta = {
        "error": str(err)[:2000],
        "error_type": type(err).__name__,
        "fleet_group": gi,
        "fleet_size": len(names),
        "member_names": names,
        # the members' INPUT indices in group order: replay maps --member
        # (an input index) through this
        "member_ids": [int(i) for i in idxs],
        "active_members": active,
        "window_start": done,
        "window_end": done + this_win,
        "config_fingerprint": checkpoint.config_fingerprint(
            group_cfg, fleet=len(names)),
        "fault_flags": flags,
        "flags_version": FLAGS_VERSION,
        "fault_flag_names": [decode_flags(f) for f in flags],
        # [C, B_active] per-tick keys of the failing window, replay-ready
        "window_key_data": key_data(keys_win).tolist(),
        "degrade_level": report.degrade_level,
        "retries": report.retries,
    }
    _write_crash_json(dump, meta)
    report.log("crash_dump", group=gi, path=dump)
    return dump


# ---------------------------------------------------------------------------
# the window loop


def _drive_group(gi, idxs, members, sup, report, dumps, hook,
                 journal=None, collect_health=False, writer=None) -> dict:
    """Run one config group to completion; {input_index: FleetResult}."""
    from .invariants import VIOLATION_MASK, decode_flags
    from .telemetry import records_to_rows, rows_to_dicts

    group_cfg = _exec_cfg(members[idxs[0]].cfg)
    escalate = [members[i].cfg.invariant_mode == "raise" for i in idxs]
    names = [members[i].name or f"member{i}" for i in idxs]
    n_ticks = [int(members[i].n_ticks) for i in idxs]
    b = len(idxs)
    full = stack_states([members[i].state for i in idxs])
    dev = full.tick.device
    tps = stack_states([members[i].tp for i in idxs])
    # each member's per-tick keys, split ONCE with engine.run's exact
    # discipline; windows slice them, never re-split
    all_keys = [rng.split(members[i].key.to(dev), members[i].n_ticks)
                if members[i].n_ticks > 0 else None for i in idxs]
    starts = fetch_local(full.tick).astype(np.int64)

    done = 0
    tripped = [False] * b
    ckpt_dir = None
    if sup.checkpoint_dir:
        ckpt_dir = os.path.join(sup.checkpoint_dir, f"fleet_g{gi:02d}")
        full, done, tripped = _try_resume_fleet(
            sup, ckpt_dir, group_cfg, full, starts, n_ticks, escalate,
            report, gi)

    if journal is not None:
        # per-group header: the member ids bind rows back to input order
        journal.header(group_cfg, plane="fleet", group=gi,
                       member_ids=list(map(int, idxs)), member_names=names,
                       n_ticks=n_ticks, resumed_done=done,
                       **(sup.health_meta or {}))
    exec_cfg = group_cfg
    chunk_ticks = max(1, int(sup.chunk_ticks))
    every = sup.checkpoint_every_ticks or chunk_ticks
    next_ckpt = done + every
    failures = 0
    prev_active = b
    if writer is None:                  # direct callers outside _drive
        writer = _Writer(maxsize=sup.writer_queue,
                         flush=journal.sync if journal is not None else None,
                         threaded=False)
    # speculating window k+1 needs its active set to be known before
    # window k confirms, but raise-mode members retire on confirmed flags:
    # a group holding one runs the synchronous pipeline
    pipelined = bool(sup.async_chunks) and not any(escalate)
    telemetry = journal is not None or collect_health
    # input-index keyed: compaction changes lane positions, never ids. A
    # resumed run's pre-restore ticks are not re-collected
    health_rows: dict = {int(i): [] for i in idxs} if collect_health else {}

    def build_window(state_now, done_now):
        """The next window from a group state that may still be
        computing: the row takes and the key stack queue behind it."""
        act = [j for j in range(b)
               if not tripped[j] and done_now < n_ticks[j]]
        if not act:
            return None
        tw = min(chunk_ticks, min(n_ticks[j] - done_now for j in act))
        whole = len(act) == b
        idx = None if whole else torch.tensor(act, dtype=torch.int64,
                                              device=dev)
        return {
            "active": act, "this_win": tw, "whole": whole, "idx": idx,
            "done": done_now, "base": state_now,
            "sub": state_now if whole else _take_rows(state_now, idx),
            "sub_tps": tps if whole else _take_rows(tps, idx),
            "keys": torch.stack([all_keys[j][done_now:done_now + tw]
                                 for j in act], dim=1),
            "info": {"group": gi, "window_start": done_now,
                     "window_ticks": tw, "b_active": len(act),
                     "attempt": failures,
                     "degrade_level": report.degrade_level},
        }

    def note_compact(w):
        nonlocal prev_active
        if len(w["active"]) < prev_active:
            report.log("compact", group=gi, active=len(w["active"]),
                       retired=[names[j] for j in range(b)
                                if j not in w["active"]])
        prev_active = len(w["active"])

    def handle_failure(e, w):
        nonlocal exec_cfg, chunk_ticks, failures
        if not dumps:
            raise e     # plain fleet_run: no retry net, no dumps
        failures += 1
        if failures > sup.max_retries:
            # durability first: land every queued row/checkpoint before
            # dumping, so the dump describes a settled run
            writer.drain(raise_errors=False)
            dump = _write_fleet_crash_dump(
                sup, group_cfg, full, w["keys"], gi, w["active"], names,
                idxs, w["done"], w["this_win"], e, report)
            report.crash_dump = dump
            if journal is not None:
                journal.note("crash", group=gi, dump=dump,
                             error=str(e)[:200])
                journal.sync()
            raise SupervisorCrash(
                f"fleet group {gi} gave up at window start {w['done']} "
                f"({failures} consecutive failure(s)); crash dump: "
                f"{dump}", dump_dir=dump, report=report) from e
        report.retries += 1
        report.log("chunk_failed", error=str(e)[:200], **w["info"])
        exec_cfg, chunk_ticks = _degrade(exec_cfg, chunk_ticks, sup,
                                         report, modes=dev.type != "cuda")
        delay = min(sup.backoff_cap_s, sup.backoff_base_s
                    * sup.backoff_factor ** (failures - 1))
        report.log("backoff", delay_s=round(delay, 3))
        sup.sleep(delay)

    def process(p):
        """Fold a confirmed window in: merge state, advance progress, hand
        journal/checkpoint I/O (host data) to the writer thread."""
        nonlocal full, done, failures, next_ckpt
        w = p["w"]
        act, tw = w["active"], w["this_win"]
        done_wall = time.time()
        failures = 0
        full = p["merged"]
        done = w["done"] + tw
        report.chunks_run += 1
        report.ticks_run += tw * len(act)       # member-ticks
        report.log("chunk_ok", **w["info"])
        member_ids = [int(idxs[j]) for j in act]
        records = p["fence"].records
        if journal is not None and records is not None:
            # [C, B_active] records, rows bound to the members' INPUT
            # indices; a failed attempt's records never reach here
            writer.submit(
                lambda h=records, m=member_ids, t0=w["done"],
                dw=done_wall: journal.append_records(
                    h, member_ids=m, group=gi, window_start=t0,
                    ticks=tw, done_wall=dw))
        if collect_health and records is not None:
            mat, cols = records_to_rows(records, member_ids=member_ids)
            for r in rows_to_dicts(mat, cols):
                health_rows[r["member"]].append(r)
        # per-member sentinel: a raise-mode member whose violation bits
        # lit retires HERE, its siblings run on
        if any(escalate):
            flags = fetch_local(p["out"].fault_flags, np.uint32)
            for pos, j in enumerate(act):
                if escalate[j] and not tripped[j] \
                        and int(flags[pos]) & VIOLATION_MASK:
                    tripped[j] = True
                    report.log("member_tripped", group=gi, member=names[j],
                               done=done,
                               flags=decode_flags(int(flags[pos])))
        if ckpt_dir and (done >= next_ckpt
                         or not any(not tripped[j] and done < n_ticks[j]
                                    for j in range(b))):
            # "tick" in the name is the GROUP's window progress, not a
            # member's absolute tick
            path = _ckpt_path(ckpt_dir, done)
            host = _to_host(full, p["fence"].event)

            def save(full_now=host, path=path):    # fleet-axis bound
                os.makedirs(ckpt_dir, exist_ok=True)
                checkpoint.save(path, full_now, cfg=group_cfg)
                _prune_checkpoints(ckpt_dir, sup.keep_checkpoints)

            writer.submit(save)
            report.checkpoints.append(path)
            report.log("checkpoint", group=gi, done=done, path=path)
            if journal is not None:
                writer.submit(lambda d=done, pth=path: journal.note(
                    "checkpoint", group=gi, done=d, path=pth))
            next_ckpt = done + every

    pend = None
    while True:
        if pend is None:                # start, or refill after failure
            w = build_window(full, done)
            if w is None:
                break
            note_compact(w)
            try:
                pend = _dispatch_window(w, exec_cfg, sup, hook,
                                        telemetry=telemetry)
            except Exception as e:
                handle_failure(e, w)
                continue
        # speculate window k+1 against window k's in-flight result (the
        # fleet never donates, so a failed k retries from the intact
        # `full` and the speculation just drops)
        spec = None
        spec_exc = None
        if pipelined and failures == 0:
            w_p = pend["w"]
            w2 = build_window(pend["merged"], w_p["done"] + w_p["this_win"])
            if w2 is not None:
                try:
                    spec = _dispatch_window(w2, exec_cfg, sup, hook,
                                            telemetry=telemetry)
                except Exception as e:
                    spec_exc = (e, w2)  # settle pend first, then ladder
                except BaseException:
                    # KeyboardInterrupt/SystemExit mid-speculation: land
                    # the in-flight window's checkpoint/journal rows
                    # before surfacing, so resume starts from them
                    try:
                        _confirm_window(pend, sup)
                        process(pend)
                        writer.drain(raise_errors=False)
                    except Exception:
                        pass
                    raise
        try:
            _confirm_window(pend, sup)
        except Exception as e:
            if spec is not None or spec_exc is not None:
                report.log("spec_discarded", group=gi,
                           window_start=pend["w"]["done"]
                           + pend["w"]["this_win"])
            w_failed = pend["w"]
            pend = None
            handle_failure(e, w_failed)
            continue
        process(pend)
        pend = None
        if spec_exc is not None:
            e2, w2 = spec_exc
            note_compact(w2)
            handle_failure(e2, w2)
            continue
        if spec is not None:
            note_compact(spec["w"])
        pend = spec

    flags = fetch_local(full.fault_flags, np.uint32)
    ticks = fetch_local(full.tick).astype(np.int64)
    out: dict = {}
    for j, i in enumerate(idxs):
        fj = int(flags[j])
        out[i] = FleetResult(
            name=names[j], state=member_state(full, j),
            ticks_run=int(ticks[j] - starts[j]), fault_flags=fj,
            flag_names=decode_flags(fj), tripped=tripped[j],
            health_rows=health_rows.get(int(i)) if collect_health else None)
    return out


def _drive(members, sup, dumps, hook, collect_health=False, device=None):
    if not members:
        return [], SupervisorReport()
    hooks = [name for name in ("run_fn", "state_to_host", "state_from_host",
                               "liveness", "chaos")
             if getattr(sup, name) is not None]
    if hooks:
        raise NotImplementedError(
            f"{', '.join(hooks)}: the fleet plane runs no multi-process "
            "hook (the reference's fleet plane never reads them, so a "
            "fleet would ignore them silently); drive a sharded member "
            "through supervised_run")
    if sup.commands is not None:
        raise NotImplementedError(
            "commands: the fleet plane has no command plane (the "
            "reference's fleet plane never reads SupervisorConfig."
            "commands, so a fleet would drop every directive silently); "
            "drive the member through supervised_run with a CommandQueue")
    for m in members:
        if m.n_ticks < 0:
            raise ValueError(f"member {m.name!r}: n_ticks must be >= 0")
        check_on(m.state.tick.device, device)
    report = SupervisorReport()
    # group by the config each member executes under, first-seen order
    groups: dict = {}
    for i, m in enumerate(members):
        groups.setdefault(_exec_cfg(m.cfg), []).append(i)
    report.log("fleet_plan", members=len(members), groups=len(groups),
               sizes=[len(v) for v in groups.values()])
    # one journal for the whole fleet, rows [B]-batched per window and
    # bound to input indices
    pipelined = bool(sup.async_chunks)
    journal = None
    if sup.health_path and sup.write_files:
        from .telemetry import HealthJournal
        journal = HealthJournal(sup.health_path,
                                sync_every_write=not pipelined)
    # ONE off-critical-path writer for the whole fleet
    writer = _Writer(maxsize=sup.writer_queue,
                     flush=journal.sync if journal is not None else None,
                     threaded=pipelined)
    results: dict = {}
    try:
        for gi, idxs in enumerate(groups.values()):
            results.update(_drive_group(gi, idxs, members, sup, report,
                                        dumps, hook, journal=journal,
                                        collect_health=collect_health,
                                        writer=writer))
            # group-end barrier: queued I/O lands (and any deferred
            # writer error surfaces) before the next group's header
            writer.drain()
    finally:
        writer.close()
        if journal is not None:
            journal.close()
    return [results[i] for i in range(len(members))], report


def fleet_run(members: list, chunk_ticks: int | None = None,
              collect_health: bool = False, device=None) -> list:
    """Run a fleet unsupervised on ``device`` (cuda unless the caller
    passes ``device="cpu"``): no watchdog, no retries, no checkpoints;
    failures propagate. ``chunk_ticks`` bounds the window length (windows
    also end at member finishes); None runs each group's longest common
    stretch as one window. Returns ``[FleetResult]`` in input order,
    bit-exact per member against sequential ``engine.run``.
    ``collect_health=True`` runs the telemetry lane and attaches each
    member's per-tick rows (``FleetResult.health_rows``)."""
    sup = SupervisorConfig(chunk_ticks=chunk_ticks or (1 << 30),
                           max_retries=0, backoff_base_s=0.0,
                           sleep=lambda s: None)
    results, _ = _drive(members, sup, dumps=False, hook=None,
                        collect_health=collect_health, device=device)
    return results


def supervised_fleet_run(members: list, sup: SupervisorConfig | None = None,
                         *, collect_health: bool = False, device=None,
                         _chunk_hook=None) -> tuple:
    """Run a fleet under the supervised execution plane (module
    docstring): watchdog, retry/degrade ladder, crash-atomic fleet-axis
    bound checkpoints in ``sup.checkpoint_dir/fleet_gNN/``, resume and
    fleet crash dumps. Returns ``([FleetResult], SupervisorReport)``.
    ``collect_health`` as in :func:`fleet_run`."""
    sup = sup or SupervisorConfig.from_env()
    return _drive(members, sup, dumps=True, hook=_chunk_hook,
                  collect_health=collect_health, device=device)
