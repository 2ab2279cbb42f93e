"""One run of one cell: set-up, the measured window on the program's
supervised path, the check against the reference, and the result line.

Set-up builds (or loads) the program's kernels, makes the underlay and
the subscriptions from ``--seed``, builds the initial state with the
program's ``init_state``, and warms up: one supervised chunk captures the
cell's chunk executable, two more give the rate that sizes the window.

The window is one ``sim.supervisor.supervised_run`` of whole chunks
(``chunk_ticks`` from the traffic file) from the initial state, with the
async pipeline, the writer thread and the health journal on and no
checkpoint. Its length is the warm-up's rate times ``--seconds``, in
whole groups of four chunks.
While it runs, the chunk executables are wrapped (``compile_plan.
engine_chunk``, a module attribute) so that the inputs of three chunks
are copied to pinned host memory behind the chunk before them: the
second chunk's, one drawn from the seed, and the last one's.

After the window, with the program's state freed, the reference
(``port_bench/reference``, plain PyTorch) builds its own initial state
from the same underlay and compares it with the program's, runs the first
chunk from it and compares the state at its end and the journal's rows,
then runs the drawn chunk and the last chunk from the program's own
states at their starts and compares their rows and, for the last, the
returned state. The ticks in between are checked only as far as those
chunks carry them.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

from port_bench import judge, nojax, spec, underlay


GROUP = 4          # the window's chunks come in groups of this many


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _reader(name: str):
    path = os.path.join(spec.BENCH_DIR, "metrics", name + ".py")
    mod_spec = importlib.util.spec_from_file_location(
        "port_bench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read


class Snapshots:
    """Wraps the chunk executables the supervisor looks up, copying the
    input state of the chosen calls to host memory behind the work
    before them; ``tamper(call, state, out)`` may replace a call's output
    (the harness's own tests plant faults through it)."""

    def __init__(self, want, tamper=None):
        self.want = set(want)
        self.tamper = tamper
        self.calls = 0
        self.taken = []

    def wrap(self, exe):
        return _SnapExe(exe, self)


class _SnapExe:
    def __init__(self, exe, snaps: Snapshots):
        self._exe, self._snaps = exe, snaps

    def __call__(self, state, tp, keys):
        snaps = self._snaps
        call = snaps.calls
        snaps.calls += 1
        if call in snaps.want:
            snaps.taken.append(_host_copy(state))
        out = self._exe(state, tp, keys)
        if snaps.tamper is not None:
            out = snaps.tamper(call, state, out)
        return out

    def __getattr__(self, name):
        return getattr(self._exe, name)


def _host_copy(state):
    import torch
    if state.tick.device.type != "cuda":
        return type(state)(*(x.clone() for x in state))
    return type(state)(*(torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
                         .copy_(x, non_blocking=True) for x in state))


def _smi() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30).stdout.strip()
        return out.splitlines()[0] if out else "nvidia-smi: no output"
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def run_cell(name: str, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", overrides: dict | None = None,
             tamper=None, t_start: float | None = None) -> dict:
    """Run cell ``name`` once; the result object of the contract, with the
    compared numbers under ``checks``. ``overrides`` changes SimConfig
    values of the program's run (a smaller network in the CPU tests, the
    compact storage of the control); the reference keeps the configuration's
    precision. ``tamper`` plants a fault in the timed path."""
    t_start = time.perf_counter() if t_start is None else t_start
    import torch

    from go_libp2p_pubsub_tpu_torch import rng
    from go_libp2p_pubsub_tpu_torch.core.params import TopicScoreParams
    from go_libp2p_pubsub_tpu_torch.ops import cudalib
    from go_libp2p_pubsub_tpu_torch.ops.dispatch import resolved_formulations
    from go_libp2p_pubsub_tpu_torch.parallel import compile_plan
    from go_libp2p_pubsub_tpu_torch.sim.config import SimConfig, TopicParams
    from go_libp2p_pubsub_tpu_torch.sim.state import init_state, state_nbytes
    from go_libp2p_pubsub_tpu_torch.sim.supervisor import (SupervisorConfig,
                                                           supervised_run)
    from port_bench import tracing

    cell = spec.cell(name)
    simkw = {**cell.sim, **(overrides or {})}
    cfg = SimConfig(**simkw)
    topics = [TopicScoreParams(**t) for t in cell.topics]
    c = cell.chunk_ticks
    on_card = device == "cuda"

    marks = [("imports", time.perf_counter())]
    build = cudalib.build_all() if on_card else {}
    marks.append(("kernels", time.perf_counter()))
    topo = underlay.sparse_fast(cfg.n_peers, cfg.k_slots,
                                degree=cell.config["degree"], seed=seed)
    sub = spec.subscriptions(cfg.n_peers, cfg.n_topics,
                             cell.config["subscribe_prob"], seed)
    marks.append(("underlay", time.perf_counter()))
    tp = TopicParams.from_topic_params(topics, device=device)
    st0 = init_state(cfg, topo, subscribed=sub, device=device)
    marks.append(("state", time.perf_counter()))
    k_warm, k_win, k_trace = rng.split(rng.PRNGKey(seed, device=device), 3)
    work = tempfile.mkdtemp(prefix="port_bench_")
    launches: list = []

    def sup(tag: str) -> SupervisorConfig:
        return SupervisorConfig(chunk_ticks=c,
                                health_path=os.path.join(work, tag + ".ndjson"),
                                crash_dir=os.path.join(work, "crash"))

    try:
        # warm-up: the capture (and first use of everything), then the
        # rate that sizes the window
        if trace and on_card:
            with tracing.record_launches(launches):
                supervised_run(st0, cfg, tp, k_warm, c, sup("warm0"),
                               device=device)
        else:
            supervised_run(st0, cfg, tp, k_warm, c, sup("warm0"),
                           device=device)
        marks.append(("capture chunk", time.perf_counter()))
        _, warm_s = tracing.timed(lambda: supervised_run(
            st0, cfg, tp, k_warm, 2 * c, sup("warm1"), device=device))
        marks.append(("rate chunks", time.perf_counter()))
        st0_host = _host_copy(st0)
        # whole groups of GROUP chunks: the warm-up's rate varies by a
        # fraction of a percent from run to run, and a window that gains or
        # loses one chunk with it changes how the run's fixed start and end
        # weigh in the rate
        chunks = GROUP * max(1, round(seconds * 2 / warm_s / GROUP))
        n_ticks = chunks * c
        drawn = 1 + seed % (chunks - 2)
        snaps = Snapshots({1, drawn, chunks - 1}, tamper)
        orig_chunk = compile_plan.engine_chunk
        compile_plan.engine_chunk = \
            lambda *a, **k: snaps.wrap(orig_chunk(*a, **k))
        try:
            if on_card:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            final, report = supervised_run(st0, cfg, tp, k_win, n_ticks,
                                           sup("window"), device=device)
            t1 = time.perf_counter()
        finally:
            compile_plan.engine_chunk = orig_chunk
        prev = t_start
        steps = []
        for label, t in marks:
            steps.append(f"{label} {t - prev:.3f}")
            prev = t
        _log(f"set-up {t0 - t_start:.3f} s: " + ", ".join(steps))
        window = {"ticks": report.ticks_run, "seconds": t1 - t0,
                  "setup_s": t0 - t_start,
                  "peak_bytes": torch.cuda.max_memory_reserved()
                  if on_card else 0}
        final_host = _host_copy(final)
        rows = judge.journal_rows(os.path.join(work, "window.ndjson"))
        _log(f"window: {report.ticks_run} of {n_ticks} ticks in "
             f"{report.chunks_run} chunks of {c}, {report.retries} "
             f"retries, degrade level {report.degrade_level}; "
             f"{t1 - t0:.4f} s; warm-up rate {2 * c / warm_s:.4f} hb/s")

        trace_ctx = None
        if trace:
            trace_ctx = _traced(cfg, tp, final, k_trace, c, work, device,
                                launches, 2 * c / warm_s)
        if on_card:
            torch.cuda.synchronize()
            for x in snaps.taken:
                x.tick.numpy()      # the pinned copies have landed
        del final, st0, report
        compile_plan.clear_caches()
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
            _log(f"card: {_smi()}; {torch.cuda.get_device_name(0)}; "
                 f"formulations {json.dumps(resolved_formulations(cfg))}; "
                 f"first-run builds "
                 f"{json.dumps({k: round(v['seconds'], 3) for k, v in build.items()})}")

        t_ref = time.perf_counter()
        checks = _check(cell, simkw, topo, sub, seed, n_ticks, c, st0_host,
                        snaps.taken, final_host, rows, device)
        _log(f"reference check: {time.perf_counter() - t_ref:.3f} s")
    finally:
        shutil.rmtree(work, ignore_errors=True)

    ctx = {"window": window, "state_nbytes": state_nbytes(cfg)["total"],
           "trace": trace_ctx}
    metrics = {}
    for m in cell.metrics(trace):
        value = _reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": 1, "memory_peak_bytes": window["peak_bytes"]}
    result = {"correct": all(v <= lim for v, lim in checks.values()),
              "attempted": n_ticks, "failed": n_ticks - window["ticks"],
              "metrics": metrics, "device": dev}
    if trace_ctx is not None:
        s = trace_ctx["stretch"]
        dev["busy_s"] = s["busy_us"] * 1e-6
        dev["window_s"] = s["window_us"] * 1e-6
        top = sorted(s["device_us"].items(), key=lambda kv: -kv[1])[:10]
        result["breakdown"] = {
            "device_ops": [[k, v * 1e-6] for k, v in top],
            "idle_gaps": s["idle_gaps"]}
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    return result


def _traced(cfg, tp, state, key, c, work, device, launches, rate) -> dict:
    """The per-layer readings (port_bench/tracing.py) from the window's
    end state."""
    import torch

    from go_libp2p_pubsub_tpu_torch import rng
    from go_libp2p_pubsub_tpu_torch.parallel import compile_plan
    from go_libp2p_pubsub_tpu_torch.sim import engine
    from go_libp2p_pubsub_tpu_torch.sim.supervisor import (SupervisorConfig,
                                                           supervised_run)
    from port_bench import tracing

    if device != "cuda":
        return None
    stretch_ticks = 3 * c
    sup = SupervisorConfig(chunk_ticks=c,
                           health_path=os.path.join(work, "trace.ndjson"),
                           crash_dir=os.path.join(work, "crash"))
    stretch = tracing.supervised_stretch(
        lambda: supervised_run(state, cfg, tp, key, stretch_ticks, sup,
                               device=device), stretch_ticks, work)
    keys = rng.split(key, c)
    exe = compile_plan.engine_chunk(cfg, state, tp, keys, telemetry=True)
    replays = max(2, round(1.5 * rate / c))
    replay = tracing.chained_replays(exe, state, tp, keys, replays)
    # eager ticks: one to settle, two under the stage spans
    eager_keys = rng.split(key, 3)
    st = engine.run_keys(state, cfg, tp, eager_keys[:1], device=device)
    stages = tracing.eager_stages(
        lambda: engine.run_keys(st, cfg, tp, eager_keys[1:], device=device),
        2, work)
    del st
    torch.cuda.synchronize()
    return {"stretch": stretch, "replay": replay, "stages": stages,
            "launches": launches, "chunk_ticks": c}


def _check(cell, simkw, topo, sub, seed, n_ticks, c, st0, taken, final, rows,
           device) -> dict:
    """The compared numbers, each with its limit (module docstring)."""
    from port_bench.reference import config as rconfig
    from port_bench.reference import engine as rengine
    from port_bench.reference import params as rparams
    from port_bench.reference import rng as rrng
    from port_bench.reference import state as rstate

    lim = cell.limits
    prog_cfg = rconfig.SimConfig(**simkw)
    rcfg = rconfig.SimConfig(**{**simkw, "state_precision":
                                cell.sim["state_precision"]})
    rtp = rconfig.TopicParams.from_topic_params(
        [rparams.TopicScoreParams(**t) for t in cell.topics], device=device)
    keys = rrng.split(rrng.split(rrng.PRNGKey(seed, device=device), 3)[1],
                      n_ticks)
    t_topics = rcfg.n_topics

    def decoded(st):
        st = rstate.SimState(*(x.to(device) for x in st))
        return rstate.decode_state(st, prog_cfg)

    start = int(st0.tick)
    by_chunk = {(int(s.tick) - start) // c: s for s in taken}
    last = n_ticks // c - 1
    init = rstate.init_state(rcfg, topo, subscribed=sub, device=device)
    init_mm, init_gap, _ = judge.state_gaps(decoded(st0),
                                            rstate.decode_state(init, rcfg))
    missing = len({1, last} - set(by_chunk))
    # (chunk, its start state, the program's state at its end or None)
    plan = [(0, init, by_chunk.get(1))]
    plan += [(i, decoded(by_chunk[i]), None) for i in sorted(by_chunk)
             if 0 < i < last][-1:]
    if last in by_chunk:
        plan.append((last, decoded(by_chunk[last]), final))
    state_mm, state_gap, row_mm, row_gap = 0, init_gap, 0, 0.0
    where = []
    for i, src, want in plan:
        out, rec = rengine.run_keys(src, rcfg, rtp, keys[i * c:(i + 1) * c],
                                    telemetry=True)
        mm, gap, w = judge.row_gaps(rows, judge.record_rows(rec, t_topics))
        row_mm, row_gap = row_mm + mm, max(row_gap, gap)
        if w:
            where.append(f"chunk {i} rows: {w}")
        if want is not None:
            mm, gap, w = judge.state_gaps(decoded(want), out)
            state_mm, state_gap = state_mm + mm, max(state_gap, gap)
            if w:
                where.append(f"chunk {i} state: {w}")
        del out, rec
    if where:
        _log("first differences: " + "; ".join(where))
    return {"init_mismatch": (init_mm, lim["init_mismatch"]),
            "state_mismatch": (state_mm, lim["state_mismatch"]),
            "rows_mismatch": (row_mm, lim["rows_mismatch"]),
            "states_missing": (missing, lim["states_missing"]),
            "float_gap": (max(state_gap, row_gap), lim["float_gap"])}


def main(argv=None, t_start: float | None = None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description="Run one benchmark cell once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = spec.cell(args.workload)
    import torch

    import go_libp2p_pubsub_tpu_torch  # noqa: F401  (the system under test)
    chips = int(cell.entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        _log(f"port_bench: the cell needs {chips} CUDA device(s); "
             f"available: {torch.cuda.device_count()}")
        return 2
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), t_start=t_start)
    bad = nojax.forbidden_loaded()
    if bad:
        _log(f"port_bench: the run loaded {', '.join(bad)}")
        return 3
    for k, v in result["checks"].items():
        _log(f"check {k}: {v['value']!r} (limit {v['limit']!r})")
    print(json.dumps(result), flush=True)
    return 0
