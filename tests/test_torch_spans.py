"""The port's own spans and counters (go_libp2p_pubsub_tpu_torch/spans.py)
on the CPU: the stage spans of ``engine._tick`` and the heartbeat under
``torch.profiler`` for the benchmark cells' three configurations at 1024
peers, the same ticks bit-equal with and without a profiler or a
recorder, ``SupervisorReport.timing`` and the supervisor's and writer's
spans, ``stage_timing`` as its own executable, and profile_step's
attribution of device time to spans. The card's half (a stage-timed
capture against the plain one) is in tests/test_torch_cuda.py."""

import dataclasses
import json
import os
import threading
import time

import pytest
import torch
from torch._C._profiler import _ExperimentalConfig

from go_libp2p_pubsub_tpu_torch import rng, spans
from go_libp2p_pubsub_tpu_torch.parallel import compile_plan
from go_libp2p_pubsub_tpu_torch.profile_step import span_device_us
from go_libp2p_pubsub_tpu_torch.sim import (build_headline, engine,
                                            scenarios, topology)
from go_libp2p_pubsub_tpu_torch.sim.supervisor import (SupervisorConfig,
                                                       SupervisorTiming,
                                                       _Writer,
                                                       supervised_run)

N = 1024
CELLS = ["gossipsub", "churn", "calm"]


@pytest.fixture(scope="module")
def topo():
    return topology.sparse_fast(N, 32, degree=12, seed=3)


def _cell(name, topo):
    """The benchmark cells' configurations at N peers: net_100k.gossipsub
    (the headline), churn_50k.churn and churn_50k.calm."""
    if name == "gossipsub":
        return build_headline(N, device="cpu", topo=topo)
    if name == "churn":
        return scenarios.churn_50k(N, device="cpu", topo=topo)
    return scenarios.churn_50k(N, disconnect_prob=0.0, device="cpu",
                               topo=topo)


def _profile(all_threads=False):
    kw = {}
    if all_threads:
        kw["experimental_config"] = _ExperimentalConfig(
            profile_all_threads=True)
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU], **kw)


def _spans(prof, tmp_path):
    """The program's spans of a finished profile, in start order:
    (name, start, end, thread)."""
    path = os.path.join(tmp_path, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    out = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]),
            e.get("tid")) for e in events
           if e.get("cat") == "user_annotation" and e["name"] in spans.NAMES]
    return sorted(out, key=lambda s: s[1])


def _same(a, b):
    for f, x, y in zip(a._fields, a, b):
        assert x.dtype == y.dtype and torch.equal(x, y), f


def _tick_names(cfg, telemetry):
    """One tick's spans in order, the heartbeat's parts in their calls'
    order (ops/heartbeat.py)."""
    hb = (["heartbeat.score"] + ["heartbeat.select"] * 8
          + ["heartbeat.exchange"] * 2 + ["heartbeat.select"] * 2
          + ["heartbeat.exchange"])
    names = ["engine.codec"]
    if cfg.fault_plan is not None:
        names.append("engine.faults")
    if cfg.sub_leave_prob > 0.0 or cfg.sub_join_prob > 0.0:
        names.append("engine.sub_churn")
    names.append("engine.publish")
    if cfg.gater_enabled:
        names.append("engine.gater")
    names += ["engine.heartbeat"] + hb + ["engine.forward"]
    if cfg.churn_disconnect_prob > 0.0:
        names.append("engine.churn")
    names += ["engine.flags", "engine.codec"]
    if telemetry:
        names.append("engine.telemetry")
    return names


@pytest.mark.parametrize("cell", CELLS)
def test_tick_spans_name_each_stage_in_order(cell, topo, tmp_path):
    """Two ticks of ``run_keys`` with the telemetry lane under the
    profiler: every stage's span in the tick's order, the churn span only
    with connection churn, the gater span only with the gater, and every
    heartbeat part inside an ``engine.heartbeat`` span."""
    cfg, tp, st = _cell(cell, topo)
    keys = rng.split(rng.PRNGKey(5, device="cpu"), 2)
    with _profile() as prof:
        engine.run_keys(st, cfg, tp, keys, telemetry=True, device="cpu")
    got = _spans(prof, tmp_path)
    assert [s[0] for s in got] == _tick_names(cfg, True) * 2
    assert ("engine.churn" in {s[0] for s in got}) == (cell == "churn")
    assert ("engine.gater" in {s[0] for s in got}) == (cell != "gossipsub")
    outer = [(a, b) for n, a, b, _ in got if n == "engine.heartbeat"]
    for n, a, b, _ in got:
        if n.startswith("heartbeat."):
            assert any(x <= a and b <= y for x, y in outer), n
        elif n != "engine.heartbeat":
            assert not any(x <= a and b <= y for x, y in outer), n


def test_fault_and_subscription_spans_open_the_tick(tmp_path):
    """A fault plan's pass and a subscription churn round run in their
    spans, ahead of publish, and the trajectory under the profiler is the
    plain one."""
    cfg, tp, st = scenarios.partition_small(start=0, heal=4, device="cpu")
    cfg = dataclasses.replace(cfg, sub_leave_prob=0.05, sub_join_prob=0.05)
    keys = rng.split(rng.PRNGKey(6, device="cpu"), 2)
    plain = engine.run_keys(st, cfg, tp, keys, device="cpu")
    with _profile() as prof:
        traced = engine.run_keys(st, cfg, tp, keys, device="cpu")
    _same(plain, traced)
    got = [s[0] for s in _spans(prof, tmp_path)]
    assert got == _tick_names(cfg, False) * 2
    assert got[1:4] == ["engine.faults", "engine.sub_churn",
                        "engine.publish"]


@pytest.mark.parametrize("cell", CELLS)
def test_spans_leave_the_trajectory_bit_equal(cell, topo):
    """The same two ticks with no profiler, under an open profiler, and
    with a span recorder installed end in the same state and records."""
    cfg, tp, st = _cell(cell, topo)
    keys = rng.split(rng.PRNGKey(9, device="cpu"), 2)
    plain, rec = engine.run_keys(st, cfg, tp, keys, telemetry=True,
                                 device="cpu")
    with _profile():
        profiled, prec = engine.run_keys(st, cfg, tp, keys, telemetry=True,
                                         device="cpu")
    timer = spans.StageTimer(event=_FakeEvent)
    with spans.timing(timer):
        timed, trec = engine.run_keys(st, cfg, tp, keys, telemetry=True,
                                      device="cpu")
    for other, orec in ((profiled, prec), (timed, trec)):
        _same(plain, other)
        _same(rec, orec)
    assert [m[0] for m in timer.marks if m[0].startswith("engine.")] == [
        n for n in _tick_names(cfg, True) * 2 if n.startswith("engine.")]


class _FakeEvent:
    """A timing event whose clock is a counter: each record takes the
    next reading."""

    clock = [0]

    def record(self):
        _FakeEvent.clock[0] += 1
        self.t = _FakeEvent.clock[0]

    def elapsed_time(self, end):
        return float(end.t - self.t)


def test_stage_timer_sums_each_name_and_nests_apart():
    """A recorder installed on one thread sees that thread's spans alone;
    ``stage_ms`` sums the spans of each name, and a nested span's time
    counts under its own name and inside its parent's."""
    timer = spans.StageTimer(event=_FakeEvent)
    seen = []

    def other_thread():
        with spans.span("engine.publish"):
            seen.append(spans._recorder.get())

    with spans.timing(timer):
        with spans.span("engine.heartbeat"):
            for _ in range(2):
                with spans.span("heartbeat.select"):
                    pass
        t = threading.Thread(target=other_thread)
        t.start()
        t.join(timeout=30)
    assert not t.is_alive() and seen == [None]
    with spans.span("engine.forward"):      # no recorder installed
        pass
    assert [m[0] for m in timer.marks] == [
        "heartbeat.select", "heartbeat.select", "engine.heartbeat"]
    assert timer.stage_ms() == {"heartbeat.select": 2.0,
                                "engine.heartbeat": 5.0}


def test_stage_timing_is_its_own_cache_entry(topo):
    """``stage_timing=True`` gives another executable than the plain one
    of the same chunk (each cached), only it holds a timer, and
    ``is_cached`` answers for each; on the CPU nothing is captured, so
    ``stage_ms`` refuses."""
    cfg, tp, st = _cell("gossipsub", topo)
    keys = rng.split(rng.PRNGKey(3, device="cpu"), 2)
    compile_plan.clear_caches()
    try:
        assert not compile_plan.is_cached(cfg, st, keys)
        plain = compile_plan.engine_chunk(cfg, st, tp, keys)
        assert compile_plan.is_cached(cfg, st, keys)
        assert not compile_plan.is_cached(cfg, st, keys, stage_timing=True)
        timed = compile_plan.engine_chunk(cfg, st, tp, keys,
                                          stage_timing=True)
        assert timed is not plain
        assert compile_plan.engine_chunk(cfg, st, tp, keys) is plain
        assert compile_plan.engine_chunk(cfg, st, tp, keys,
                                         stage_timing=True) is timed
        assert compile_plan.cache_sizes()["engine"] == 2
        assert plain._timer is None
        assert isinstance(timed._timer, spans.StageTimer)
        assert not compile_plan.is_cached(cfg, st, keys[0], 2)
        compile_plan.engine_window(cfg, st, tp, keys[0], 2)
        assert compile_plan.is_cached(cfg, st, keys[0], 2)
        _same(plain(st, tp, keys), timed(st, tp, keys))
        for exe in (plain, timed):
            with pytest.raises(ValueError, match="stage_timing"):
                exe.stage_ms()
    finally:
        compile_plan.clear_caches()


@pytest.mark.parametrize("deadline", [None, 60.0])
def test_supervisor_timing_fills_every_phase(topo, tmp_path, deadline):
    """A supervised run of 4 chunks with the journal: ``timing`` counts
    the chunks, every phase's total and maximum are non-negative, the
    totals bound their maxima, ``boundary_ms`` is the sum of the boundary
    events' ``pause_ms``, launch lies inside dispatch, and the main
    thread's dispatch, wait and process fit in the run's wall time."""
    cfg, tp, st = _cell("churn", topo)
    sup = SupervisorConfig(chunk_ticks=2, deadline_s=deadline,
                           health_path=os.path.join(tmp_path, "h.ndjson"))
    t0 = time.perf_counter()
    _, rep = supervised_run(st, cfg, tp, rng.PRNGKey(2, device="cpu"), 8,
                            sup, device="cpu")
    wall_ms = (time.perf_counter() - t0) * 1e3
    t = rep.timing
    assert t.chunks == rep.chunks_run == 4
    assert t.capture_s == 0.0                   # the CPU captures nothing
    for phase in ("launch", "dispatch", "wait", "process", "boundary",
                  "writer", "writer_blocked"):
        total = getattr(t, phase + "_ms")
        top = getattr(t, phase + "_max_ms")
        assert 0.0 <= top <= total, phase
    for phase in ("launch", "dispatch", "process", "writer"):
        assert getattr(t, phase + "_ms") > 0.0, phase
    assert t.launch_ms <= t.dispatch_ms
    assert t.dispatch_ms + t.wait_ms + t.process_ms <= wall_ms
    pauses = [e["pause_ms"] for e in rep.events if e["event"] == "boundary"]
    assert len(pauses) == 4
    assert abs(t.boundary_ms - sum(pauses)) <= 0.002 * len(pauses)
    assert set(dataclasses.asdict(rep)["timing"]) == {
        f.name for f in dataclasses.fields(SupervisorTiming)}


def test_supervisor_spans_on_every_thread(topo, tmp_path):
    """Under a profiler that sees every thread: the main thread's
    set-up, dispatch, launch (the chunk's call runs on the deadline
    thread), confirm, process, boundary and drain spans, and the writer
    thread's ``writer.task`` spans; set-up opens the run and drain ends
    it."""
    cfg, tp, st = _cell("gossipsub", topo)
    sup = SupervisorConfig(chunk_ticks=2, deadline_s=60.0,
                           health_path=os.path.join(tmp_path, "h.ndjson"))
    with _profile(all_threads=True) as prof:
        supervised_run(st, cfg, tp, rng.PRNGKey(4, device="cpu"), 4, sup,
                       device="cpu")
    got = [s for s in _spans(prof, tmp_path)
           if s[0].split(".")[0] in ("supervisor", "writer")]
    names = [s[0] for s in got]
    assert names[0] == "supervisor.setup"
    assert names[-1] == "supervisor.drain"
    for name, count in (("supervisor.dispatch", 2), ("supervisor.launch", 2),
                        ("supervisor.confirm", 2), ("supervisor.process", 2),
                        ("supervisor.boundary", 2)):
        assert names.count(name) == count, name
    assert "writer.task" in names
    main = {tid for n, _, _, tid in got if n == "supervisor.dispatch"}
    assert len(main) == 1
    for n, _, _, tid in got:
        if n in ("supervisor.launch", "writer.task"):
            assert tid not in main, n
        else:
            assert tid in main, n


def test_writer_times_its_tasks_and_a_blocked_submit():
    """A writer with a queue of one and tasks of 50 ms: the writer's busy
    time covers the tasks, and the submits that found the queue full
    count as blocked."""
    timing = SupervisorTiming()
    w = _Writer(maxsize=1, timing=timing)
    try:
        for _ in range(3):
            w.submit(lambda: time.sleep(0.05))
        w.drain()
    finally:
        w.close()
    assert timing.writer_ms >= 3 * 50 * 0.9
    assert 50 * 0.9 <= timing.writer_max_ms <= timing.writer_ms
    assert timing.writer_blocked_ms > 0.0
    assert timing.writer_blocked_max_ms <= timing.writer_blocked_ms


def test_span_device_us_attributes_launches_to_open_spans():
    """profile_step's reading of a trace: a device event belongs to every
    span of its launching thread that was open at its launch, found by
    correlation; launches outside every span, on another thread, or
    without a runtime call count nowhere."""
    def ev(cat, name, ts, dur, tid=1, corr=None):
        e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
             "tid": tid}
        if corr is not None:
            e["args"] = {"correlation": corr}
        return e

    events = [
        ev("user_annotation", "engine.heartbeat", 0, 100),
        ev("user_annotation", "heartbeat.select", 10, 20),
        ev("user_annotation", "engine.forward", 100, 50),
        ev("user_annotation", "not.a.span", 0, 200),
        ev("cuda_runtime", "cudaLaunchKernel", 15, 1, corr=1),
        ev("cuda_runtime", "cudaLaunchKernel", 50, 1, corr=2),
        ev("cuda_runtime", "cudaLaunchKernel", 120, 1, corr=3),
        ev("cuda_runtime", "cudaLaunchKernel", 120, 1, tid=2, corr=4),
        ev("cuda_runtime", "cudaLaunchKernel", 180, 1, corr=5),
        ev("kernel", "k1", 300, 7.0, tid=9, corr=1),
        ev("kernel", "k2", 310, 3.0, tid=9, corr=2),
        ev("gpu_memcpy", "m3", 320, 5.0, tid=9, corr=3),
        ev("kernel", "k4", 330, 11.0, tid=9, corr=4),
        ev("kernel", "k5", 340, 13.0, tid=9, corr=5),
        ev("kernel", "k6", 350, 17.0, tid=9, corr=6),
    ]
    assert span_device_us(events) == {"engine.heartbeat": 10.0,
                                      "heartbeat.select": 7.0,
                                      "engine.forward": 5.0}
