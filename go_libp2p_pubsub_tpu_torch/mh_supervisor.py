"""Multi-process relaunch supervisor: owns the process group and
survives its ranks (port of scripts/mh_supervisor.py).

``python -m go_libp2p_pubsub_tpu_torch.run_multihost`` runs ONE rank, and a
rank's failure there is fatal by design (a rank-local retry cannot be
rank-symmetric: sim/supervisor.py). This driver launches ALL ranks,
watches them (exit codes and heartbeat progress in the shared
``--run-dir``, parallel/resilience.py), and on any rank's death or stall
tears the whole group down and relaunches every rank from the last
checkpoint: bounded retries, exponential backoff, and a rank-symmetric
degrade rung recorded (fsync'd) in the run journal before the relaunch
and handed to every rank as ``GRAFT_MH_RUNG``.

Elastic resume rides the same loop: ``--procs 2,1`` runs the first
attempt at 2 processes and every later one at 1; a checkpoint is the
whole state (its sidecar stamps ``processes=P`` as provenance), so a
relaunch at another count slices it again.

Two ranks on one card, a chaos-killed rank relaunched:

    GRAFT_CHAOS=kill@1:8 python -m go_libp2p_pubsub_tpu_torch.mh_supervisor \
        --procs 2 --backend gloo --scenario single_topic_1k --ticks 16 \
        --chunk-ticks 8 --run-dir /tmp/mh --dump-state /tmp/mh/final

``--rendezvous file`` meets the ranks through a file in the run
directory instead of a TCP port (tests on one host). Nothing here imports
torch: the parent stays cheap and shares no state with its children.
"""

import argparse
import json
import os
import re
import shutil
import signal
import socket
import subprocess
import sys
import time

from .parallel import resilience

_CKPT_RE = re.compile(r"^ckpt_t(\d+)")

# how long a rank may linger after a sibling exited cleanly before the
# group is judged wedged (teardown skew is seconds; a collective blocked
# on the exited rank is forever)
_EXIT_LINGER_S = 30.0


def parse_procs(text: str) -> list:
    """``"8,8,4"`` → ``[8, 8, 4]``: attempt i runs schedule[min(i, last)]
    processes. Raises ``ValueError`` naming --procs on junk."""
    out = []
    for part in filter(None, (p.strip() for p in text.split(","))):
        try:
            v = int(part)
        except ValueError as e:
            raise ValueError(
                f"--procs entry {part!r} is not an integer "
                "(expected a comma schedule like 8,8,4)") from e
        if v <= 0:
            raise ValueError(f"--procs entry {part!r} must be positive")
        out.append(v)
    if not out:
        raise ValueError("--procs schedule is empty")
    return out


def _newest_ckpt_tick(ckpt_dir: str) -> int | None:
    """Newest supervisor-checkpoint tick in ``ckpt_dir`` (None when
    empty). A local copy of sim/supervisor.list_checkpoints' name scan:
    importing that module would import torch into this parent."""
    best = None
    if os.path.isdir(ckpt_dir):
        for name in os.listdir(ckpt_dir):
            m = _CKPT_RE.match(name)
            if m:
                t = int(m.group(1))
                best = t if best is None or t > best else best
    return best


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _heartbeat_ticks(run_dir: str, procs: int) -> dict:
    """``{rank: tick}`` progress from the heartbeat files (stall
    detection: a group whose every rank is alive but whose ticks stopped
    moving is wedged — the rank-side dead-PEER detector can't see that)."""
    out = {}
    for r in range(procs):
        try:
            with open(resilience.heartbeat_path(run_dir, r)) as f:
                out[r] = int(json.load(f).get("tick", -1))
        except (OSError, ValueError, json.JSONDecodeError):
            pass
    return out


class _Journal:
    """Append-only fsync'd NDJSON at ``run_dir/mh_journal.jsonl`` — the
    relaunch decisions OF RECORD. The rung line lands durably BEFORE the
    ranks it governs launch: a parent crash between the two can only
    replay the same decision, never hand different ranks different
    programs."""

    def __init__(self, path: str):
        self.path = path

    def record(self, **rec) -> None:
        rec.setdefault("wall", time.time())
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")
            f.flush()
            os.fsync(f.fileno())


def _launch_rank(args, rank: int, procs: int, coordinator: str,
                 attempt: int, rung: int, run_dir: str):
    env = dict(os.environ)
    env["GRAFT_COORDINATOR"] = coordinator
    env["GRAFT_NUM_PROCESSES"] = str(procs)
    env["GRAFT_PROCESS_ID"] = str(rank)
    env["GRAFT_MH_RUN_DIR"] = run_dir
    env["GRAFT_MH_RUNG"] = str(rung)
    env["GRAFT_MH_RELAUNCHES"] = str(attempt)
    cmd = [sys.executable, "-m", "go_libp2p_pubsub_tpu_torch.run_multihost",
           "--backend", args.backend, "--device", args.device,
           "--scenario", args.scenario, "--kwargs", args.kwargs,
           "--cfg", args.cfg, "--ticks", str(args.ticks),
           "--seed", str(args.seed),
           "--checkpoint-dir", os.path.join(run_dir, "ckpt")]
    if args.threads:
        cmd += ["--threads", str(args.threads)]
    if args.topology_file:
        cmd += ["--topology-file", args.topology_file]
    if args.chunk_ticks:
        cmd += ["--chunk-ticks", str(args.chunk_ticks)]
    if args.health:
        # --health changes what every rank runs (the telemetry gather is
        # a collective), so EVERY rank gets it; rank 0 alone writes
        cmd += ["--health", args.health]
    if rank == 0:
        if args.dump_state:
            cmd += ["--dump-state", args.dump_state]
        if args.journal:
            cmd += ["--journal", args.journal]
    log = open(os.path.join(run_dir, f"rank{rank}.attempt{attempt}.log"),
               "w")
    proc = subprocess.Popen(cmd, env=env, stdout=log, stderr=log)
    return proc, log


def _teardown(procs: list) -> None:
    for p, _log in procs:
        if p.poll() is None:
            try:
                p.terminate()
            except OSError:
                pass
    deadline = time.time() + 5.0
    for p, _log in procs:
        while p.poll() is None and time.time() < deadline:
            time.sleep(0.1)
        if p.poll() is None:
            try:
                p.kill()
                p.wait(timeout=5.0)
            except OSError:
                pass
    for _p, log in procs:
        try:
            log.close()
        except OSError:
            pass


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--procs", required=True,
                    help="comma process-count schedule: attempt i uses "
                         "entry min(i, last) — '8,8,4' relaunches twice "
                         "at 8 then elastically finishes at 4")
    ap.add_argument("--backend", required=True, choices=["gloo", "nccl"],
                    help="forwarded to every rank")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--threads", type=int, default=None)
    ap.add_argument("--scenario", default="headline")
    ap.add_argument("--kwargs", default="{}")
    ap.add_argument("--cfg", default="{}")
    ap.add_argument("--topology-file", default=None)
    ap.add_argument("--rendezvous", default="tcp", choices=["tcp", "file"],
                    help="tcp: a fresh free port per attempt; file: a "
                         "rendezvous file in the run directory")
    ap.add_argument("--ticks", type=int, default=100)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--chunk-ticks", type=int, default=None)
    ap.add_argument("--run-dir", required=True,
                    help="SHARED directory this supervisor owns: "
                         "checkpoints (ckpt/), heartbeats, chaos "
                         "markers, mh_journal.jsonl, per-rank logs")
    ap.add_argument("--base-port", type=int, default=0,
                    help="coordinator port; 0 = a fresh free port per "
                         "attempt (a TIME_WAIT corpse from the killed "
                         "group must not wedge the relaunch)")
    ap.add_argument("--max-relaunches", type=int, default=4)
    ap.add_argument("--backoff-base-s", type=float, default=1.0)
    ap.add_argument("--backoff-factor", type=float, default=2.0)
    ap.add_argument("--backoff-cap-s", type=float, default=60.0)
    ap.add_argument("--stall-timeout-s", type=float, default=600.0,
                    help="no heartbeat TICK progress for this long → the "
                         "group is wedged and torn down (covers "
                         "all-ranks-alive-but-blocked, which the "
                         "rank-side dead-peer detector can't see)")
    ap.add_argument("--fresh", action="store_true",
                    help="wipe the run-dir's checkpoints/markers/journal "
                         "first (a NEW run; default resumes)")
    ap.add_argument("--dump-state", default=None)
    ap.add_argument("--journal", default=None)
    ap.add_argument("--health", default=None)
    args = ap.parse_args()

    try:
        schedule = parse_procs(args.procs)
    except ValueError as e:
        raise SystemExit(str(e))

    run_dir = os.path.abspath(args.run_dir)
    if args.fresh and os.path.isdir(run_dir):
        shutil.rmtree(run_dir)
    os.makedirs(run_dir, exist_ok=True)
    journal = _Journal(os.path.join(run_dir, "mh_journal.jsonl"))
    # the resume command of record: the dashboard's DEAD-RANK banner
    # surfaces this line verbatim
    resume_cmd = (f"python -m go_libp2p_pubsub_tpu_torch.mh_supervisor "
                  f"--procs {args.procs} --backend {args.backend} "
                  f"--scenario {args.scenario} --ticks {args.ticks} "
                  f"--seed {args.seed} --run-dir {run_dir}")
    journal.record(kind="mh_run", argv=sys.argv[1:], resume_cmd=resume_cmd,
                   schedule=schedule)

    # this process OWNS the group: if it is itself preempted (SIGTERM from
    # a scheduler, ctrl-C) the default handler would kill it without the
    # per-attempt finally below ever running, orphaning ranks that keep
    # beating — and possibly wedged in collectives — forever. Convert the
    # signals to SystemExit so teardown always runs; the journal records
    # the interruption and the resume command above picks the run back up.
    def _on_signal(signum, frame):
        try:
            journal.record(kind="mh_signal", signum=signum)
        except OSError:
            pass
        raise SystemExit(128 + signum)
    signal.signal(signal.SIGTERM, _on_signal)
    signal.signal(signal.SIGINT, _on_signal)

    ckpt_dir = os.path.join(run_dir, "ckpt")
    rung = 0
    for attempt in range(args.max_relaunches + 1):
        procs_n = schedule[min(attempt, len(schedule) - 1)]
        if args.rendezvous == "file":
            coordinator = "file://" + os.path.join(run_dir,
                                                   f"rdv.{attempt}")
        else:
            coordinator = f"127.0.0.1:{args.base_port or _free_port()}"
        # stale heartbeat files from the previous (larger or killed)
        # group would read as instantly-dead peers
        for name in os.listdir(run_dir):
            if name.startswith("hb_rank"):
                try:
                    os.remove(os.path.join(run_dir, name))
                except OSError:
                    pass
        tick_before = _newest_ckpt_tick(ckpt_dir)
        # the rung lands fsync'd BEFORE any rank launches: every rank of
        # this attempt reads the SAME agreed rung (GRAFT_MH_RUNG) — the
        # rank-symmetric degrade ladder by construction
        journal.record(kind="mh_attempt", attempt=attempt, procs=procs_n,
                       rung=rung, coordinator=coordinator,
                       ckpt_tick=tick_before)
        print(json.dumps({"mh": "launch", "attempt": attempt,
                          "procs": procs_n, "rung": rung,
                          "ckpt_tick": tick_before}), flush=True)

        group = [_launch_rank(args, r, procs_n, coordinator, attempt,
                              rung, run_dir) for r in range(procs_n)]
        failure = None
        try:
            first_exit0: float | None = None
            last_progress = time.time()
            last_ticks = _heartbeat_ticks(run_dir, procs_n)
            verdict_abort = False
            while failure is None:
                time.sleep(0.25)
                codes = [p.poll() for p, _ in group]
                if any(c == resilience.EXIT_VERDICT_ABORT for c in codes):
                    # TERMINAL, not a crash: a live behavior contract
                    # failed under verdict_policy=abort and the group
                    # tore itself down cleanly at a chunk boundary.
                    # Relaunching would replay the same checkpointed
                    # trajectory into the same breach — don't.
                    verdict_abort = True
                    failure = "verdict_abort"
                    break
                if any(c is not None and c != 0 for c in codes):
                    failure = "rank_exit " + " ".join(
                        f"r{r}={c}" for r, c in enumerate(codes)
                        if c is not None and c != 0)
                    break
                if all(c == 0 for c in codes):
                    break                               # clean finish
                if any(c == 0 for c in codes):
                    # some ranks done, others running: normal teardown
                    # skew for a few seconds; forever = wedged collective
                    first_exit0 = first_exit0 or time.time()
                    if time.time() - first_exit0 > _EXIT_LINGER_S:
                        failure = "exit_skew"
                        break
                ticks = _heartbeat_ticks(run_dir, procs_n)
                if ticks != last_ticks and any(
                        ticks.get(r, -1) > last_ticks.get(r, -1)
                        for r in ticks):
                    last_ticks, last_progress = ticks, time.time()
                elif time.time() - last_progress > args.stall_timeout_s:
                    failure = "stall"
                    break
        finally:
            # runs on clean finishes, failures, AND SystemExit from the
            # signal handler — the group never outlives its owner
            _teardown(group)
        if failure is None:
            journal.record(kind="mh_done", attempt=attempt,
                           relaunches=attempt)
            print(json.dumps({"mh": "done", "attempts": attempt + 1,
                              "relaunches": attempt, "rung": rung}),
                  flush=True)
            return 0
        if verdict_abort:
            journal.record(kind="mh_verdict_abort", attempt=attempt,
                           exit_code=resilience.EXIT_VERDICT_ABORT)
            print(json.dumps({"mh": "verdict_abort", "attempt": attempt,
                              "exit_code":
                                  resilience.EXIT_VERDICT_ABORT}),
                  flush=True)
            return resilience.EXIT_VERDICT_ABORT

        tick_after = _newest_ckpt_tick(ckpt_dir)
        made_progress = (tick_after or -1) > (tick_before or -1)
        # rung policy: an attempt that advanced the checkpoint frontier
        # failed ENVIRONMENTALLY (preemption, chaos, a dead host) — the
        # program is fine, keep the rung. Only a zero-progress attempt
        # escalates: the program itself may not run at this rung
        if not made_progress:
            rung += 1
        journal.record(kind="mh_failure", attempt=attempt, why=failure,
                       ckpt_tick=tick_after, made_progress=made_progress,
                       next_rung=rung)
        print(json.dumps({"mh": "failure", "attempt": attempt,
                          "why": failure, "ckpt_tick": tick_after,
                          "next_rung": rung}), flush=True)
        if attempt < args.max_relaunches:
            delay = min(args.backoff_cap_s,
                        args.backoff_base_s
                        * args.backoff_factor ** attempt)
            journal.record(kind="mh_backoff", delay_s=round(delay, 3))
            time.sleep(delay)

    journal.record(kind="mh_giveup", attempts=args.max_relaunches + 1)
    print(json.dumps({"mh": "giveup",
                      "attempts": args.max_relaunches + 1}), flush=True)
    return 1


if __name__ == "__main__":
    sys.exit(main())
