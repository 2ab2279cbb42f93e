"""Where one step of a network spends its time on the card.

    python -m go_libp2p_pubsub_tpu_torch.profile_step [--n 102400] [--ticks 4]
        [--out profile_step.json]
    python -m go_libp2p_pubsub_tpu_torch.profile_step --scenario churn_50k \
        [--gather pallas|mxu] [--n 51200]
    python -m go_libp2p_pubsub_tpu_torch.profile_step --scenario frontier_1m
    python -m go_libp2p_pubsub_tpu_torch.profile_step ... --captured

Builds the headline network (``build_headline(n)``, n=102400 by default),
the churn + peer-gater scenario (``scenarios.churn_50k(n)``, n=51200 by
default, run with ``hop_mode="xla"`` and ``edge_gather_mode=--gather``) or
the frontier (``scenarios.frontier(n)``, n=1048576 by default, its own
``sort`` exchanges) on cuda, warms up two ticks, then

1. runs ``--ticks`` ticks of ``step`` under ``torch.profiler`` and reads
   the engine's own spans (``spans.NAMES``: ``engine.publish``,
   ``engine.heartbeat``, ``heartbeat.select``, ...): the device time of
   the kernels launched inside each span, per tick, and each span's peak
   device memory above what was allocated when it opened
   (``max_memory_allocated`` after a reset at its entry, read on the host
   at its exit: no sync);
2. keeps a copy of the state and runs ``--ticks`` more ticks of ``step``
   as a user would (no added syncs), timed by CUDA events around the
   window and on the host clock, with ``torch.cuda.set_sync_debug_mode(
   "warn")`` on while they enqueue: each synchronization they make warns;
3. runs the same ticks again from the copy, with the same keys, under
   ``torch.profiler``, checks that they end in the same state, and prints
   the device time by kernel name (the port's CUDA kernels and the rest)
   and the window's synchronizations counted two more ways: host reads of
   device values (``aten::_local_scalar_dense``) and the profiler's
   synchronizing runtime calls (``cudaStreamSynchronize``,
   ``cudaDeviceSynchronize``, ``cudaEventSynchronize``, synchronous
   ``cudaMemcpy``; a pageable host-to-device copy is a
   ``cudaMemcpyAsync`` followed by a stream sync, so it counts), less
   those of an empty profiled window. CUPTI's "Command Buffer Full"
   records (the host waiting on a full launch queue: it ran ahead of the
   card) are counted apart, not as device time;
4. with ``--captured``: ``parallel/compile_plan.engine_chunk`` of the same
   ticks (donated; warm-up and capture timed on the host clock), replayed
   from the copy with the same keys, equal in every field to the timed
   window of 2; then replayed again, chained on its own result, timed by
   CUDA events, and once more under the profiler (busy share, sync
   calls); peak device memory of the build and replays; then the same
   chunk captured with ``stage_timing=True``, replayed from the copy,
   equal to the eager window, and its device ms per span name per tick
   (``EngineExecutable.stage_ms``).

The device-busy share is the device time of 3 over the event-timed wall
of 2: the same work, so the profiler's own host cost, which stretches its
window, does not enter it. The captured one is the profiled replay's
device time over the timed replay's wall.

Needs a CUDA device; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
import warnings
from collections import defaultdict

# the profiler's names of the runtime calls that block the host on the
# device
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMemcpy")
QUEUE_FULL = "Command Buffer Full"
# the warning torch.cuda.set_sync_debug_mode("warn") gives at each sync (its
# one-time notice that the mode is a prototype is not one)
SYNC_WARNING = "called a synchronizing CUDA operation"
OWN_KERNELS = ("edge_table_kernel", "hop_kernel", "iwant_resolve_kernel",
               "emit_kernel", "gather_words_kernel",
               "permutation_gather_kernel", "take_words_kernel")


def _device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(evt, attr, None)
        if v is not None:
            return float(v)
    return 0.0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scenario",
                    choices=("headline", "churn_50k", "frontier_1m"),
                    default="headline")
    ap.add_argument("--gather", choices=("pallas", "mxu"), default="pallas",
                    help="edge_gather_mode of the churn_50k run")
    ap.add_argument("--n", type=int, default=None,
                    help="peers (102400 headline, 51200 churn_50k, "
                    "1048576 frontier_1m)")
    ap.add_argument("--ticks", type=int, default=4)
    ap.add_argument("--out", default=None)
    ap.add_argument("--captured", action="store_true",
                    help="also time the replayed engine_chunk of the "
                    "window against the eager step")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("profile_step: no CUDA device is available", file=sys.stderr)
        return 1
    import dataclasses

    from . import rng, spans
    from .sim import build_headline, scenarios, topology
    from .sim.engine import step

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    churn = args.scenario == "churn_50k"
    frontier = args.scenario == "frontier_1m"
    n = args.n or {"churn_50k": 51200, "frontier_1m": 1 << 20}.get(
        args.scenario, 102400)
    t0 = time.perf_counter()
    topo = topology.sparse_fast(n, 32, degree=8, seed=scenarios.SEED) \
        if frontier else topology.sparse(n, 32, degree=12)
    print(f"{args.scenario}'s underlay ({n} peers): "
          f"{time.perf_counter() - t0:.1f} s on the host", flush=True)
    if frontier:
        cfg, tp, st = scenarios.frontier(n, device="cuda", topo=topo)
    elif churn:
        cfg, tp, st = scenarios.churn_50k(n_peers=n, device="cuda", topo=topo)
        cfg = dataclasses.replace(cfg, hop_mode="xla",
                                  edge_gather_mode=args.gather)
    else:
        cfg, tp, st = build_headline(n, device="cuda", topo=topo)
    print(f"{args.scenario}({n}), hop_mode={cfg.hop_mode}, "
          f"edge_gather_mode={cfg.edge_gather_mode}", flush=True)
    warm = 2
    keys = rng.split(rng.PRNGKey(0, device="cuda"), warm + 2 * args.ticks)
    for i in range(warm):
        st = step(st, cfg, tp, keys[i])
    torch.cuda.synchronize()

    # 1. the engine's spans over eager ticks: device time of the kernels
    # launched inside each, and each span's peak memory above its start
    act = [torch.profiler.ProfilerActivity.CPU,
           torch.profiler.ProfilerActivity.CUDA]
    peaks = _SpanPeaks()
    with spans.timing(peaks), torch.profiler.profile(activities=act) as prof:
        for i in range(warm, warm + args.ticks):
            st = step(st, cfg, tp, keys[i])
        torch.cuda.synchronize()
    stage_ms = {k: v / 1e3 / args.ticks
                for k, v in span_device_us(_trace_events(prof)).items()}
    print("span device ms per tick (profiler): "
          + ", ".join(f"{k} {v:.3f}" for k, v in stage_ms.items()),
          flush=True)
    print(f"span peak device memory above its start, MiB (state "
          f"{sum(x.numel() * x.element_size() for x in st) / 2 ** 20:.1f} "
          f"MiB): " + ", ".join(f"{k} {v / 2 ** 20:.1f}"
                                for k, v in peaks.peaks.items()), flush=True)

    # 2. the window as a user runs it; the kernels update some state
    # tensors in place, so each run starts from its own copy
    def copy(state):
        return type(state)(*(x.clone() for x in state))

    window = range(warm + args.ticks, warm + 2 * args.ticks)
    snapshot = copy(st)
    torch.cuda.synchronize()
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    plain = copy(snapshot)
    torch.cuda.synchronize()
    t_win = time.perf_counter()
    ev0.record()
    # the sync debug mode warns at each synchronization the ticks make
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for i in window:
                plain = step(plain, cfg, tp, keys[i])
        finally:
            torch.cuda.set_sync_debug_mode("default")
    ev1.record()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t_win) * 1e3
    wall_ms = ev0.elapsed_time(ev1)
    sync_warnings = sum(SYNC_WARNING in str(w.message) for w in caught)

    # 3. the same ticks under the profiler
    traced = copy(snapshot)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=act) as prof:
        for i in window:
            traced = step(traced, cfg, tp, keys[i])
        torch.cuda.synchronize()
    base_calls = _harness_syncs(act)
    for f, a, b in zip(plain._fields, plain, traced):
        same = (torch.allclose(a, b, rtol=1e-6, atol=0.0)
                if a.is_floating_point() else torch.equal(a, b))
        if not same:
            raise AssertionError(f"the traced window differs from the "
                                 f"timed one in {f}")
    del traced
    by_name, calls, syncs, sync_calls, queue_full = _tally(prof)
    sync_calls -= base_calls
    device_ms = sum(by_name.values()) / 1e3
    own_ms = {k: sum(v for n, v in by_name.items() if k in n) / 1e3
              for k in OWN_KERNELS}
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:15]
    print(f"window: {args.ticks} ticks in {wall_ms:.3f} ms by CUDA events "
          f"({host_ms:.3f} ms host clock) = {args.ticks / wall_ms * 1e3:.3f} "
          f"hb/s; device time of the same ticks (profiler) {device_ms:.3f} "
          f"ms = {100 * device_ms / wall_ms:.2f}% busy; synchronizations: "
          f"host reads of device values {syncs}, synchronizing runtime "
          f"calls {sync_calls}, sync debug warnings {sync_warnings}; the "
          f"launch queue full {queue_full} times (the host ran ahead)",
          flush=True)
    print("own kernels ms in window: " + ", ".join(
        f"{k} {v:.3f}" for k, v in own_ms.items()), flush=True)
    for name, us in top:
        print(f"  {us / 1e3:9.3f} ms  {calls[name]:6d} x  {name[:110]}")
    result = dict(scenario=args.scenario, n=n,
                  edge_gather_mode=cfg.edge_gather_mode, ticks=args.ticks,
                  device=smi, stage_ms=stage_ms,
                  stage_peak_mib={k: v / 2 ** 20
                                  for k, v in peaks.peaks.items()},
                  window_wall_ms=wall_ms, window_host_ms=host_ms,
                  device_kernel_ms=device_ms,
                  busy_share=device_ms / wall_ms, host_syncs=syncs,
                  sync_calls=sync_calls, sync_warnings=sync_warnings,
                  queue_full=queue_full,
                  own_kernel_ms=own_ms,
                  top=[dict(name=n, ms=us / 1e3, calls=calls[n])
                       for n, us in top])
    if args.captured:
        result["captured"] = _captured(cfg, tp, snapshot, plain,
                                       keys[window.start:window.stop],
                                       wall_ms, act, base_calls)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps({k: result[k] for k in (
        "stage_ms", "busy_share", "host_syncs", "sync_calls",
        "sync_warnings", "own_kernel_ms", "captured") if k in result}))
    return 0


class _SpanPeaks:
    """A span recorder (``spans.timing``): each span name's largest peak
    of allocated device memory above what was allocated when the span
    opened. The allocator's peak is reset at each entry; an enclosing span
    keeps the larger of its own peak and its inner spans'. Allocator
    statistics are host-side: no sync."""

    def __init__(self):
        import torch
        self._cuda = torch.cuda
        self.peaks: dict = defaultdict(int)
        self._open: list = []       # [allocated at entry, peak so far]

    def open(self):
        top = self._cuda.max_memory_allocated()
        if self._open:
            self._open[-1][1] = max(self._open[-1][1], top)
        self._cuda.reset_peak_memory_stats()
        frame = [self._cuda.memory_allocated(), 0]
        self._open.append(frame)
        return frame

    def close(self, name: str, frame) -> None:
        top = self._cuda.max_memory_allocated()
        self._open.pop()
        self.peaks[name] = max(self.peaks[name], max(frame[1], top) - frame[0])
        if self._open:
            self._open[-1][1] = max(self._open[-1][1], top)


def _trace_events(prof) -> list:
    """The complete events of a finished profile's Chrome trace."""
    import os
    import tempfile
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
    finally:
        os.remove(path)
    return [e for e in data.get("traceEvents", [])
            if e.get("ph") == "X" and "dur" in e]


def span_device_us(events) -> dict:
    """Device microseconds of the kernels, copies and sets launched inside
    each span of ``spans.NAMES``, from a Chrome trace's events: a device
    event belongs to every span of its launching thread that was open at
    its launch (found by the runtime call's correlation id), so a nested
    span's time also counts in the span around it."""
    from .spans import NAMES
    opened: dict = defaultdict(list)          # tid -> [(name, a, b)]
    for e in events:
        if e.get("cat") == "user_annotation" and e["name"] in NAMES:
            a = float(e["ts"])
            opened[e.get("tid")].append((e["name"], a, a + float(e["dur"])))
    launch = {e["args"]["correlation"]: (e.get("tid"), float(e["ts"]))
              for e in events if e.get("cat") == "cuda_runtime"
              and "correlation" in e.get("args", {})}
    out: dict = defaultdict(float)
    for e in events:
        if e.get("cat") not in ("kernel", "gpu_memcpy", "gpu_memset"):
            continue
        at = launch.get(e.get("args", {}).get("correlation"))
        if at is None:
            continue
        for name, a, b in opened.get(at[0], ()):
            if a <= at[1] < b:
                out[name] += float(e["dur"])
    return dict(out)


def _harness_syncs(act) -> int:
    """The synchronizing runtime calls of a profiled window that holds
    nothing but its closing synchronize (the profiler's own and the
    window's): subtracted from every profiled count."""
    import torch
    with torch.profiler.profile(activities=act) as prof:
        torch.cuda.synchronize()
    return _tally(prof)[3]


def _tally(prof):
    """(device us by kernel name, calls by name, host reads, synchronizing
    runtime calls, full launch queues). CUPTI's "Command Buffer Full"
    records carry the time the host waited on a full launch queue, not
    device work: they are counted apart. The spans' ranges carry their
    kernels' device time again, so they are left out."""
    from .spans import NAMES
    by_name = defaultdict(float)
    calls = defaultdict(int)
    syncs = sync_calls = queue_full = 0
    for e in prof.key_averages():
        us = _device_us(e)
        if e.key == "aten::_local_scalar_dense":
            syncs += e.count
        if e.key in SYNC_CALLS:
            sync_calls += e.count
        if e.key == QUEUE_FULL:
            queue_full += e.count
        elif us > 0 and not e.key.startswith("aten::") \
                and e.key not in NAMES:
            by_name[e.key] += us
            calls[e.key] += e.count
    return by_name, calls, syncs, sync_calls, queue_full


def _same_state(want, got, what: str) -> None:
    import torch
    for f, a, b in zip(want._fields, want, got):
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        if not torch.equal(a, b):
            raise AssertionError(f"{what} differs from the eager window "
                                 f"in {f}")


def _captured(cfg, tp, snapshot, plain, keys, eager_ms, act,
              base_calls) -> dict:
    """The window as one captured chunk (step 4 of the module docstring)."""
    import torch

    from .parallel import compile_plan
    n_ticks = keys.shape[0]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    exe = compile_plan.engine_chunk(cfg, snapshot, tp, keys, donate=True)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    got = exe(snapshot, tp, keys)
    _same_state(plain, got, "the replayed chunk")
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    ev0.record()
    got = exe(got, tp, keys)
    ev1.record()
    torch.cuda.synchronize()
    wall_ms = ev0.elapsed_time(ev1)
    with torch.profiler.profile(activities=act) as prof:
        got = exe(got, tp, keys)
        torch.cuda.synchronize()
    by_name, _, syncs, sync_calls, queue_full = _tally(prof)
    sync_calls -= base_calls
    device_ms = sum(by_name.values()) / 1e3
    peak = torch.cuda.max_memory_allocated() - base
    staged = compile_plan.engine_chunk(cfg, snapshot, tp, keys,
                                       stage_timing=True)
    _same_state(plain, staged(snapshot, tp, keys), "the stage-timed replay")
    torch.cuda.synchronize()
    graph_ms = {k: v / n_ticks for k, v in staged.stage_ms().items()}
    out = dict(build_s=build_s, wall_ms=wall_ms,
               hbs=n_ticks / wall_ms * 1e3, eager_hbs=n_ticks / eager_ms * 1e3,
               device_kernel_ms=device_ms,
               busy_share=device_ms / wall_ms if device_ms > 0 else None,
               host_syncs=syncs, sync_calls=sync_calls, queue_full=queue_full,
               peak_gib=peak / 2 ** 30,
               reserved_gib=torch.cuda.memory_reserved() / 2 ** 30,
               launches=exe.launches, graph_stage_ms=graph_ms)
    busy = (f"{100 * device_ms / wall_ms:.2f}% busy" if device_ms > 0
            else "busy share not measured (no device time in the trace)")
    print(f"captured: engine_chunk of {n_ticks} ticks built in {build_s:.3f} "
          f"s (warm-up and capture), replay equal to the eager window in "
          f"every field; a chained replay {wall_ms:.3f} ms by CUDA events "
          f"= {out['hbs']:.3f} hb/s (eager {out['eager_hbs']:.3f}); device "
          f"time {device_ms:.3f} ms, {busy}; synchronizing runtime calls "
          f"{sync_calls}, host reads {syncs}; peak {out['peak_gib']:.3f} GiB "
          f"above the start, {out['reserved_gib']:.3f} GiB reserved; "
          f"launches recorded at capture {json.dumps(exe.launches)}",
          flush=True)
    print("captured with stage timing, device ms per tick: " + ", ".join(
        f"{k} {v:.3f}" for k, v in graph_ms.items()), flush=True)
    compile_plan.clear_caches()
    return out


if __name__ == "__main__":
    sys.exit(main())
