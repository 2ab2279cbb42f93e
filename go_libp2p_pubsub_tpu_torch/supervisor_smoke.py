"""One-shot drill of the whole supervised ladder on a tiny config (port of
scripts/supervisor_smoke.py): deadline trip, backoff, degraded mode,
checkpoint and resume, crash dump, replay and a chaos stall, each stage
holding its trajectory bit-identical to the plain ``run``.

    python -m go_libp2p_pubsub_tpu_torch.supervisor_smoke [--device cpu|cuda]

Prints one JSON line per stage; exit 0 iff every stage behaved. The
degraded rung differs by device, as ``sim/supervisor.py`` sets it: on the
CPU a retry first steps to the conservative formulations (the mode rung),
on the card it halves the chunk and never routes around the kernels (the
chunk rung). The degraded stage checks the rung of its device and names
it in its line.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile
import time

N_TICKS = 12
CHUNK_TICKS = 4
SCENARIO = "1k_single_topic"
SCENARIO_KWARGS = dict(n_peers=128, k_slots=16, degree=6)
SEED = 11


def _states_equal(a, b) -> bool:
    import torch
    return all(torch.equal(x, y) for x, y in zip(a, b))


def _deadline(ref_s: float) -> float:
    """The watchdog's deadline from the plain run's seconds: a chunk of
    CHUNK_TICKS is about ref_s * CHUNK_TICKS / N_TICKS, given ten times
    that, and at least 0.6 s, so a fast card never trips it by accident
    and a slow host does not trip it twice."""
    return max(0.6, 10 * ref_s * CHUNK_TICKS / N_TICKS)


def run_smoke(base_dir: str | None = None, emit=print, device=None,
              finals: dict | None = None) -> int:
    """Run the stages on ``device`` (cuda unless the caller passes
    ``device="cpu"``), emitting one JSON line per stage; 0 iff every stage
    passed. ``finals``, where given, receives the final state of the plain
    run and of each stage that ends in one, by stage name."""
    from . import rng
    from .device import resolve_device
    from .parallel.resilience import ChaosPlan
    from .replay_crash import replay
    from .sim import scenarios
    from .sim.engine import run
    from .sim.supervisor import (SupervisorConfig, SupervisorCrash,
                                 supervised_run)

    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    own_tmp = None
    if base_dir is None:
        own_tmp = tempfile.TemporaryDirectory(prefix="graft_sup_smoke_")
        base_dir = own_tmp.name
    finals = finals if finals is not None else {}
    ok = True

    def stage(name, passed, **info):
        nonlocal ok
        ok = ok and passed
        emit(json.dumps({"stage": name,
                         "status": "ok" if passed else "FAIL", **info}))

    try:
        # edge_gather "sort" so the CPU's mode rung has a non-default mode
        # to fall back from (the formulations are bit-identical, which is
        # the rung's safety argument); on the card it runs the fused hop,
        # resolve and emit kernels
        cfg, tp, st = scenarios.single_topic_1k(**SCENARIO_KWARGS,
                                                device=dev)
        cfg = dataclasses.replace(cfg, edge_gather_mode="sort")
        key = rng.PRNGKey(SEED, device=dev)
        t0 = time.perf_counter()
        ref = run(st, cfg, tp, key, N_TICKS, device=dev)
        int(ref.tick)
        ref_s = time.perf_counter() - t0
        finals["plain"] = ref
        deadline = _deadline(ref_s)

        # --- stage 1: deadline trip -> backoff -> degraded mode, parity.
        # The hook sleeps past the deadline once, forcing one real trip
        def slow_first(info):
            if info["chunk_start"] == 0 and info["attempt"] == 0:
                time.sleep(deadline + 1.0)
        sup = SupervisorConfig(
            chunk_ticks=CHUNK_TICKS, deadline_s=deadline,
            checkpoint_dir=os.path.join(base_dir, "ck"),
            backoff_base_s=0.01, scenario=SCENARIO,
            scenario_kwargs=SCENARIO_KWARGS)
        out, rep = supervised_run(st, cfg, tp, key, N_TICKS, sup,
                                  device=dev, _chunk_hook=slow_first)
        finals["deadline_backoff_degrade"] = out
        evs = [e["event"] for e in rep.events]
        rungs = [{k: v for k, v in e.items() if k != "event"}
                 for e in rep.events if e["event"] == "degrade"]
        if on_card:
            # the chunk rung: halved, the formulations left as they are
            rung = "chunk"
            rung_ok = bool(rungs) and all(set(r) == {"chunk_ticks"}
                                          for r in rungs) \
                and rungs[0]["chunk_ticks"] == CHUNK_TICKS // 2
        else:
            rung = "mode"
            rung_ok = bool(rungs) and "edge_gather_mode" in rungs[0]
        stage("deadline_backoff_degrade",
              _states_equal(out, ref) and rep.retries >= 1
              and "degrade" in evs and "backoff" in evs and rung_ok,
              device=dev.type, rung=rung, deadline_s=round(deadline, 3),
              retries=rep.retries, degrade_level=rep.degrade_level,
              degrades=rungs, events=evs[:8])

        # --- stage 2: kill mid-run, resume from checkpoint, parity
        def kill_late(info):
            if info["chunk_start"] >= 8:
                raise KeyboardInterrupt("smoke: simulated preemption")
        sup2 = SupervisorConfig(
            chunk_ticks=CHUNK_TICKS,
            checkpoint_dir=os.path.join(base_dir, "ck2"))
        interrupted = False
        try:
            supervised_run(st, cfg, tp, key, N_TICKS, sup2, device=dev,
                           _chunk_hook=kill_late)
        except KeyboardInterrupt:
            interrupted = True
        out2, rep2 = supervised_run(st, cfg, tp, key, N_TICKS, sup2,
                                    device=dev)
        finals["checkpoint_resume"] = out2
        stage("checkpoint_resume",
              interrupted and rep2.resumed_tick == 8
              and _states_equal(out2, ref),
              resumed_tick=rep2.resumed_tick)

        # --- stage 3: permanent failure -> crash dump -> replay
        def boom(info):
            raise RuntimeError("smoke: injected permanent failure")
        sup3 = SupervisorConfig(
            chunk_ticks=CHUNK_TICKS, max_retries=1, backoff_base_s=0.0,
            sleep=lambda s: None, crash_dir=os.path.join(base_dir, "crash"),
            scenario=SCENARIO, scenario_kwargs=SCENARIO_KWARGS)
        dump = None
        try:
            supervised_run(st, cfg, tp, key, N_TICKS, sup3, device=dev,
                           _chunk_hook=boom)
        except SupervisorCrash as e:
            dump = e.dump_dir
        # the injected failure was on the host, so the replay comes back
        # clean (flags 0, no trip). The stamped scenario's fingerprint is
        # not the sort-mode config's, so the objects are handed over
        rep_result = None
        if dump:
            rep_result = replay(dump, like=st, cfg=cfg, tp=tp, device=dev)
        stage("crash_dump_replay",
              dump is not None and rep_result is not None
              and rep_result["tripped"] is False
              and rep_result.get("fault_flags") == 0,
              dump=dump, replay=rep_result)

        # --- stage 4: a chaos stall past the deadline -> trip -> retry,
        # fired once: the durable marker in the run directory keeps the
        # retry from firing it again (as mh_supervisor relaunches a group
        # the chaos killed without the chaos killing it again)
        chaos_dir = os.path.join(base_dir, "chaos")
        os.makedirs(chaos_dir, exist_ok=True)
        plan = ChaosPlan(ChaosPlan.parse(f"stall@0:4:{deadline + 1.0}"),
                         rank=0, run_dir=chaos_dir)
        sup4 = SupervisorConfig(
            chunk_ticks=CHUNK_TICKS, deadline_s=deadline,
            backoff_base_s=0.01, scenario=SCENARIO,
            scenario_kwargs=SCENARIO_KWARGS)
        out4, rep4 = supervised_run(st, cfg, tp, key, N_TICKS, sup4,
                                    device=dev, _chunk_hook=plan.fire)
        finals["chaos_stall_recovery"] = out4
        markers = [m for m in os.listdir(chaos_dir)
                   if m.startswith("chaos_") and m.endswith(".fired")]
        stage("chaos_stall_recovery",
              _states_equal(out4, ref) and rep4.retries >= 1
              and len(markers) == 1,
              retries=rep4.retries, markers=markers)
    finally:
        if own_tmp is not None:
            own_tmp.cleanup()
    return 0 if ok else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, choices=("cpu", "cuda"),
                    help="where the engine runs (default: cuda)")
    args = ap.parse_args(argv)
    return run_smoke(device=args.device)


if __name__ == "__main__":
    sys.exit(main())
