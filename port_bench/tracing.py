"""The traced half of a ``--trace 1`` run: what the per-layer readers
read. Everything here runs after the measured window, on copies of its
end state, so nothing in it touches what the window timed.

- A short supervised stretch of the cell's own chunks under
  ``torch.profiler``: device time by kernel name, the device's busy
  union against the stretch's length, host syncs, the longest idle gaps.
- Chained replays of the same captured chunk, timed by CUDA events.
- A few eager ticks with ``record_function`` spans put around the
  engine's stage functions (module attributes of ``sim.engine``, wrapped
  from here for the length of those ticks): the device time of the
  kernels each stage launched.
- The kernel launches recorded at capture (``ops.cudalib.launch`` wrapped
  while the cell's chunk is captured): name and argument shapes, for the
  roofline files.
"""

from __future__ import annotations

import contextlib
import json
import os
import time

import torch

# the profiler's names of the runtime calls that block the host on the
# device (profile_step.py's SYNC_CALLS)
SYNC_CALLS = frozenset({"cudaStreamSynchronize", "cudaDeviceSynchronize",
                        "cudaEventSynchronize", "cudaMemcpy"})
HOST_READ = "aten::_local_scalar_dense"
DEVICE_CATS = frozenset({"kernel", "gpu_memcpy", "gpu_memset"})
HOST_CATS = frozenset({"cpu_op", "user_annotation", "cuda_runtime",
                       "cuda_driver", "python_function"})
STRETCH = "port_bench.stretch"
STAGES = {"heartbeat": ("heartbeat",), "forward": ("publish", "forward_tick"),
          "churn": ("churn_edges",)}


@contextlib.contextmanager
def record_launches(out: list):
    """Append ``(kernel, args)`` for every ``cudalib.launch`` made while a
    stream captures: tensors as ``("t", shape, itemsize)``, ints as
    ints."""
    from go_libp2p_pubsub_tpu_torch.ops import cudalib
    orig = cudalib.launch

    def launch(name, *args):
        if torch.cuda.is_current_stream_capturing():
            out.append((name, [("t", tuple(a.shape), a.element_size())
                               if isinstance(a, torch.Tensor) else int(a)
                               for a in args]))
        return orig(name, *args)

    cudalib.launch = launch
    try:
        yield out
    finally:
        cudalib.launch = orig


@contextlib.contextmanager
def stage_spans():
    """``record_function`` spans around the engine's stage functions."""
    from go_libp2p_pubsub_tpu_torch.sim import engine
    saved = {}
    for stage, fns in STAGES.items():
        for fn in fns:
            orig = getattr(engine, fn)
            saved[fn] = orig

            def wrapped(*a, _orig=orig, _label=f"port_bench.{stage}", **k):
                with torch.profiler.record_function(_label):
                    return _orig(*a, **k)

            setattr(engine, fn, wrapped)
    try:
        yield
    finally:
        for fn, orig in saved.items():
            setattr(engine, fn, orig)


def _profile():
    act = [torch.profiler.ProfilerActivity.CPU,
           torch.profiler.ProfilerActivity.CUDA]
    return torch.profiler.profile(activities=act)


def _events(prof, path: str) -> list:
    prof.export_chrome_trace(path)
    with open(path) as f:
        data = json.load(f)
    os.remove(path)
    return [e for e in data.get("traceEvents", [])
            if e.get("ph") == "X" and "dur" in e]


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _syncs(events) -> int:
    return sum(1 for e in events
               if e["name"] == HOST_READ or e["name"] in SYNC_CALLS)


def empty_window_syncs(work: str) -> int:
    """The syncs of a profiled window holding only its closing
    synchronize: subtracted from every profiled count."""
    with _profile() as prof:
        torch.cuda.synchronize()
    return _syncs(_events(prof, os.path.join(work, "empty.json")))


def supervised_stretch(run, ticks: int, work: str) -> dict:
    """Profile ``run()`` (a supervised run of ``ticks`` ticks) and read its
    trace: kernel time by name, the busy union and the length of the
    stretch, syncs, and the longest idle gaps named by what the host was
    doing."""
    base = empty_window_syncs(work)
    torch.cuda.synchronize()
    with _profile() as prof:
        with torch.profiler.record_function(STRETCH):
            run()
            torch.cuda.synchronize()
    events = _events(prof, os.path.join(work, "stretch.json"))
    span = [e for e in events if e["name"] == STRETCH
            and e.get("cat") == "user_annotation"]
    if not span:
        raise RuntimeError("the profiled stretch left no span in its trace")
    lo = float(span[0]["ts"])
    hi = lo + float(span[0]["dur"])
    dev = [e for e in events if e.get("cat") in DEVICE_CATS
           and lo <= float(e["ts"]) < hi]
    by_name: dict = {}
    for e in dev:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + float(e["dur"])
    busy = _union((float(e["ts"]), min(hi, float(e["ts"]) + float(e["dur"])))
                  for e in dev)
    busy_us = sum(b - a for a, b in busy)
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    gaps = [(edges[i + 1] - edges[i], edges[i])
            for i in range(0, len(edges) - 1, 2) if edges[i + 1] > edges[i]]
    gaps.sort(reverse=True)
    host = [e for e in events if e.get("cat") in HOST_CATS
            and e["name"] != STRETCH]
    idle = []
    for length, start in gaps[:10]:
        mid = start + length / 2
        cover = [e for e in host
                 if float(e["ts"]) <= mid < float(e["ts"]) + float(e["dur"])]
        name = min(cover, key=lambda e: float(e["dur"]))["name"] \
            if cover else "no host activity traced"
        idle.append([name, length * 1e-6])
    return {"ticks": ticks, "window_us": hi - lo, "busy_us": busy_us,
            "device_us": by_name, "syncs": _syncs(events) - base,
            "idle_gaps": idle}


def chained_replays(exe, state, tp, keys, replays: int) -> dict:
    """``replays`` chained calls of a chunk executable, by CUDA events."""
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    ev0.record()
    out = state
    for _ in range(replays):
        out = exe(out, tp, keys)
        if type(out) is tuple:          # (state, records); SimState is a
            out = out[0]                # tuple subclass
    ev1.record()
    torch.cuda.synchronize()
    return {"ticks": replays * exe.n_ticks, "ms": ev0.elapsed_time(ev1)}


def eager_stages(run, ticks: int, work: str) -> dict:
    """Profile ``run()`` (``ticks`` eager ticks) under the stage spans:
    device us of the kernels launched inside each stage's spans."""
    torch.cuda.synchronize()
    with stage_spans():
        with _profile() as prof:
            run()
            torch.cuda.synchronize()
    events = _events(prof, os.path.join(work, "stages.json"))
    spans = {stage: [(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                     for e in events if e["name"] == f"port_bench.{stage}"
                     and e.get("cat") == "user_annotation"]
             for stage in STAGES}
    launch_ts = {e["args"]["correlation"]: float(e["ts"]) for e in events
                 if e.get("cat") == "cuda_runtime"
                 and "correlation" in e.get("args", {})}
    stage_us = {stage: 0.0 for stage, iv in spans.items() if iv}
    for e in events:
        if e.get("cat") not in DEVICE_CATS:
            continue
        t = launch_ts.get(e.get("args", {}).get("correlation"))
        if t is None:
            continue
        for stage in stage_us:
            if any(a <= t < b for a, b in spans[stage]):
                stage_us[stage] += float(e["dur"])
    return {"ticks": ticks, "stage_us": stage_us}


def timed(fn):
    t = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t
