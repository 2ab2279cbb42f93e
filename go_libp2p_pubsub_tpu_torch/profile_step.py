"""Where one step of a network spends its time on the card.

    python -m go_libp2p_pubsub_tpu_torch.profile_step [--n 102400] [--ticks 4]
        [--out profile_step.json]
    python -m go_libp2p_pubsub_tpu_torch.profile_step --scenario churn_50k \
        [--gather pallas|mxu] [--n 51200]
    python -m go_libp2p_pubsub_tpu_torch.profile_step --scenario frontier_1m

Builds the headline network (``build_headline(n)``, n=102400 by default),
the churn + peer-gater scenario (``scenarios.churn_50k(n)``, n=51200 by
default, run with ``hop_mode="xla"`` and ``edge_gather_mode=--gather``) or
the frontier (``scenarios.frontier(n)``, n=1048576 by default, its own
``sort`` exchanges) on cuda, warms up two ticks, then

1. times each stage of ``engine.step`` (publishers + publish, the gater's
   decay, heartbeat, forward_tick, connection churn, invariant flags) on
   the host clock with a device sync after each stage, over ``--ticks``
   ticks, and takes each stage's peak device memory above what was
   allocated when it began (``max_memory_allocated`` after a reset);
2. keeps a copy of the state and runs ``--ticks`` more ticks of ``step``
   as a user would (no added syncs), timed by CUDA events around the
   window and on the host clock;
3. runs the same ticks again from the copy, with the same keys, under
   ``torch.profiler``, checks that they end in the same state, and prints
   the device time by kernel name (the port's CUDA kernels and the
   rest) and the count of host reads of device values
   (``aten::_local_scalar_dense``: each one a sync).

The device-busy share is the device time of 3 over the event-timed wall
of 2: the same work, so the profiler's own host cost, which stretches its
window, does not enter it.

Needs a CUDA device; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from collections import defaultdict

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
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("profile_step: no CUDA device is available", file=sys.stderr)
        return 1
    import dataclasses

    from . import rng
    from .ops.churn import churn_edges
    from .ops.gater import gater_decay
    from .ops.heartbeat import heartbeat
    from .ops.propagate import forward_tick, publish
    from .sim import build_headline, scenarios, topology
    from .sim.engine import _iwant_answer_extras, choose_publishers, step
    from .sim.invariants import record_flags

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

    # 1. stage wall times (host clock, device sync after each stage) and
    # peak device memory above the stage's start
    stages = defaultdict(list)
    peaks = defaultdict(int)
    tick_s = []

    def timed(name, fn):
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        stages[name].append(time.perf_counter() - t)
        peaks[name] = max(peaks[name],
                          torch.cuda.max_memory_allocated() - base)
        return out

    for i in range(warm, warm + args.ticks):
        t_tick = time.perf_counter()
        # engine.step's stages, in its order
        k_pub, k_hb, k_fwd, k_churn, k_ign, _ = rng.split(keys[i], 6)
        st = timed("publish", lambda: publish(
            st, cfg, *choose_publishers(st, cfg, k_pub), k_ign))
        if cfg.gater_enabled:
            st = timed("gater_decay", lambda: gater_decay(st, cfg))
        hb = timed("heartbeat", lambda: heartbeat(
            st, cfg, tp, k_hb, extra_words=_iwant_answer_extras(st, cfg)))
        st = timed("forward_tick", lambda: forward_tick(
            hb.state, cfg, tp, hb.inc_gossip, hb.scores, k_fwd,
            fwd_send=hb.fwd_send,
            answers_k=hb.extra_routed[0] if hb.extra_routed else None))
        if cfg.churn_disconnect_prob > 0.0:
            st = timed("churn_edges", lambda: churn_edges(
                st, cfg, tp, k_churn, scores_all=hb.scores_all))
        st = timed("record_flags", lambda: record_flags(st, cfg))
        st = st._replace(tick=st.tick + 1)
        tick_s.append(time.perf_counter() - t_tick)
    stage_ms = {k: 1e3 * sum(v) / len(v) for k, v in stages.items()}
    print("stage ms per tick (host clock, synced): "
          + ", ".join(f"{k} {v:.3f}" for k, v in stage_ms.items()),
          flush=True)
    print(f"stage peak device memory above its start, MiB (state "
          f"{sum(x.numel() * x.element_size() for x in st) / 2 ** 20:.1f} "
          f"MiB): " + ", ".join(f"{k} {v / 2 ** 20:.1f}"
                                for k, v in peaks.items()), flush=True)

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
    for i in window:
        plain = step(plain, cfg, tp, keys[i])
    ev1.record()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t_win) * 1e3
    wall_ms = ev0.elapsed_time(ev1)

    # 3. the same ticks under the profiler
    act = [torch.profiler.ProfilerActivity.CPU,
           torch.profiler.ProfilerActivity.CUDA]
    traced = copy(snapshot)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=act) as prof:
        for i in window:
            traced = step(traced, cfg, tp, keys[i])
        torch.cuda.synchronize()
    for f, a, b in zip(plain._fields, plain, traced):
        same = (torch.allclose(a, b, rtol=1e-6, atol=0.0)
                if a.is_floating_point() else torch.equal(a, b))
        if not same:
            raise AssertionError(f"the traced window differs from the "
                                 f"timed one in {f}")
    by_name = defaultdict(float)
    calls = defaultdict(int)
    syncs = 0
    for e in prof.key_averages():
        us = _device_us(e)
        if e.key == "aten::_local_scalar_dense":
            syncs += e.count
        if us > 0 and not e.key.startswith("aten::"):
            by_name[e.key] += us
            calls[e.key] += e.count
    device_ms = sum(by_name.values()) / 1e3
    own_ms = {k: sum(v for n, v in by_name.items() if k in n) / 1e3
              for k in OWN_KERNELS}
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:15]
    print(f"window: {args.ticks} ticks in {wall_ms:.3f} ms by CUDA events "
          f"({host_ms:.3f} ms host clock) = {args.ticks / wall_ms * 1e3:.3f} "
          f"hb/s; device time of the same ticks (profiler) {device_ms:.3f} "
          f"ms = {100 * device_ms / wall_ms:.2f}% busy; host reads of device "
          f"values (syncs): {syncs}", flush=True)
    print("own kernels ms in window: " + ", ".join(
        f"{k} {v:.3f}" for k, v in own_ms.items()), flush=True)
    for name, us in top:
        print(f"  {us / 1e3:9.3f} ms  {calls[name]:6d} x  {name[:110]}")
    result = dict(scenario=args.scenario, n=n,
                  edge_gather_mode=cfg.edge_gather_mode, ticks=args.ticks,
                  device=smi,
                  tick_ms=[1e3 * s for s in tick_s], stage_ms=stage_ms,
                  stage_peak_mib={k: v / 2 ** 20 for k, v in peaks.items()},
                  window_wall_ms=wall_ms, window_host_ms=host_ms,
                  device_kernel_ms=device_ms,
                  busy_share=device_ms / wall_ms, host_syncs=syncs,
                  own_kernel_ms=own_ms,
                  top=[dict(name=n, ms=us / 1e3, calls=calls[n])
                       for n, us in top])
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps({k: result[k] for k in ("stage_ms", "busy_share",
                                             "host_syncs", "own_kernel_ms")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
