"""Multi-process launcher: one rank of a sharded run per process (port of
scripts/run_multihost.py).

Each rank runs one copy with the same coordinator and its own rank; the
group splits the peer axis (parallel/sharding.py), each rank builds its
rows of the scenario and advances them in supervised chunks of the
sharded chunk (parallel/compile_plan.sharded_chunk_plan). Rank 0 alone
writes checkpoints, the journal and the metric line; the gathers behind
them are collectives, so every rank reaches each boundary.

The trajectory equals the single-process ``engine.run(state, cfg, tp,
PRNGKey(seed), ticks)`` at any process count.

    GRAFT_COORDINATOR=host0:9911 GRAFT_NUM_PROCESSES=2 GRAFT_PROCESS_ID=<r>\\
    python -m go_libp2p_pubsub_tpu_torch.run_multihost --backend nccl \\
        --scenario headline --kwargs '{"n_peers": 102400}' --ticks 100 \\
        --checkpoint-dir /shared/ckpt --journal /shared/journal.jsonl

Two ranks on one card (NCCL refuses two ranks on one device; gloo takes
the card's tensors): ``--backend gloo`` on both, ``--device cuda``. On the
CPU: ``--device cpu --coordinator file:///tmp/rdv``.

``--scenario`` names ``headline`` (``sim.build_headline``), ``spec`` (a
config given field by field: ``--kwargs '{"cfg": {...}, "degree": 6,
"seed": 11}'``), an entry of ``sim.scenarios.SCENARIOS`` or a builder of
``sim.scenarios``, called
with ``--kwargs`` on the CPU (``--topology-file``: a ``.npz`` of a prebuilt
underlay, as ``topology.save``); ``--cfg`` overrides config fields after
the build (``sharded_route``, ``edge_gather_mode``, ...). Each rank keeps
its rows on ``--device``.

``--digests PATH`` runs the ticks unsupervised and writes, per tick, the
whole state's field digests (:func:`parallel.sharding.state_digests`,
equal on every rank); ``--stats PATH`` writes each rank's kernel launches,
collective elements per tick and wall time (``{rank}`` in the path is
replaced by the rank). ``--dump-state`` writes rank 0's gathered final
state as ``.npz``.

Exit codes: 0 done, ``resilience.EXIT_VERDICT_ABORT`` for a contract
abort, 1 any failure (a failed rank fails its group: the others block in
their next collective until the launcher or the liveness watchdog ends
them).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time


def _spec(cfg: dict, degree: int, seed: int = 0, topo=None):
    """A config given field by field on ``topology.sparse(n_peers,
    k_slots, degree, seed)`` with topic scoring disabled (the shape of
    the reference's sharding tests)."""
    from .sim import SimConfig, TopicParams, init_state, topology

    c = SimConfig(**cfg)
    if topo is None:
        topo = topology.sparse(c.n_peers, c.k_slots, degree=degree,
                               seed=seed)
    return c, TopicParams.disabled(c.n_topics, device="cpu"), \
        init_state(c, topo, device="cpu")


def build(scenario: str, kwargs: dict, cfg_over: dict,
          topology_file: str | None):
    """``(cfg, tp, whole CPU state)`` of a scenario name."""
    import numpy as np

    from .sim import build_headline, scenarios, topology

    kw = dict(kwargs)
    if topology_file:
        with np.load(topology_file) as z:
            kw["topo"] = topology.Topology(
                neighbors=z["neighbors"], outbound=z["outbound"],
                reverse_slot=z["reverse_slot"], degree=z["degree"])
    if scenario == "spec":
        fn = _spec
    elif scenario == "headline":
        fn = build_headline
    elif scenario in scenarios.SCENARIOS:
        fn = scenarios.SCENARIOS[scenario]
    elif callable(getattr(scenarios, scenario, None)):
        fn = getattr(scenarios, scenario)
    else:
        raise SystemExit(f"--scenario {scenario!r}: not 'headline', a "
                         "SCENARIOS entry or a sim.scenarios builder")
    cfg, tp, st = fn(**kw) if fn is _spec else fn(device="cpu", **kw)
    if cfg_over:
        cfg = dataclasses.replace(cfg, **cfg_over)
    return cfg, tp, st


_CHECKED = {"hop": "ops.hopkernel", "iwant_resolve": "ops.hopkernel",
            "emit": "ops.hopkernel", "edge_table": "ops.permgather",
            "gather_words": "ops.permgather",
            "permutation_gather": "ops.permgather"}


def _to_cpu(x):
    import torch
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().clone()
    if isinstance(x, (list, tuple)) and not hasattr(x, "_fields"):
        return type(x)(_to_cpu(v) for v in x)
    if hasattr(x, "_fields"):
        return type(x)(*(_to_cpu(v) for v in x))
    return x


def _bits_equal(a, b) -> bool:
    import torch
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        return a.shape == b.shape and a.dtype == b.dtype \
            and torch.equal(a, b)
    return all(_bits_equal(x, y) for x, y in zip(a, b))


def check_kernels(record: dict):
    """Wrap the six kernel wrappers of the sharded path (in every port
    module that holds them): each call runs as it is, on this rank's rows
    (launching its kernel on CUDA tensors), then again on CPU copies of
    the same inputs, where the wrapper takes its plain version; the
    outputs must agree bit for bit. ``record[name]`` counts the checked
    calls. Returns a function that unwraps them."""
    import importlib

    pkg = __package__ or "go_libp2p_pubsub_tpu_torch"
    originals = {n: getattr(importlib.import_module(f"{pkg}.{m}"), n)
                 for n, m in _CHECKED.items()}

    def wrap(name, real):
        def checked(*args, **kw):
            host = [_to_cpu(a) for a in args]
            out = real(*args, **kw)
            want = real(*host, **kw)
            if not _bits_equal(out, want):
                raise AssertionError(f"{name}: the kernel and its plain "
                                     "version differ on this rank's rows")
            record[name] = record.get(name, 0) + 1
            return out
        return checked

    patched = []
    for mod in [m for k, m in sys.modules.items() if k.startswith(pkg)]:
        for name, real in originals.items():
            if getattr(mod, name, None) is real:
                setattr(mod, name, wrap(name, real))
                patched.append((mod, name, real))

    def undo():
        for mod, name, real in patched:
            setattr(mod, name, real)
    return undo


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--coordinator", default=None,
                    help="host:port of rank 0 or an init URL (file://...; "
                         "or $GRAFT_COORDINATOR)")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--backend", default=None, choices=["gloo", "nccl"],
                    help="the process group's backend (or $GRAFT_BACKEND);"
                         " required")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--threads", type=int, default=None,
                    help="torch.set_num_threads for this rank")
    ap.add_argument("--scenario", default="headline")
    ap.add_argument("--kwargs", default="{}",
                    help="JSON keyword arguments of the scenario builder")
    ap.add_argument("--cfg", default="{}",
                    help="JSON SimConfig overrides applied after the build")
    ap.add_argument("--topology-file", default=None)
    ap.add_argument("--engine", default="dense",
                    choices=["dense", "bucketed"],
                    help="dense: the [N, K] sharded step; bucketed: the "
                         "degree-bucketed row-sharded step (a scenario "
                         "that builds a BucketedState: heavytail_eclipse, "
                         "powerlaw_*)")
    ap.add_argument("--topology", default="replicated",
                    choices=["replicated", "sharded"],
                    help="--engine bucketed with a powerlaw_* scenario: "
                         "'sharded' builds only this rank's bucket "
                         "windows (multihost.init_bucketed_local over "
                         "scenarios.powerlaw_mh_spec's row windows); the "
                         "whole graph never exists")
    ap.add_argument("--ticks", type=int, default=100)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--chunk-ticks", type=int, default=None)
    ap.add_argument("--max-chunks", type=int, default=None,
                    help="stop cleanly after N chunks; a later run with "
                         "the same --ticks/--seed resumes from the "
                         "checkpoint")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="shared path (all ranks read, rank 0 writes)")
    ap.add_argument("--journal", default=None,
                    help="rank-0 JSONL journal of the run's outcome")
    ap.add_argument("--health", default=None,
                    help="rank-0 health journal (sim/telemetry.py; or "
                         "$GRAFT_HEALTH_STREAM)")
    ap.add_argument("--dump-state", default=None,
                    help="rank-0 .npz of the final whole state (under "
                         "--digests/--unsupervised every rank must get "
                         "it: the gather is a collective)")
    ap.add_argument("--digests", default=None,
                    help="unsupervised run; rank 0 writes per-tick state "
                         "digests (JSON)")
    ap.add_argument("--unsupervised", action="store_true",
                    help="run the ticks as --digests does, without the "
                         "per-tick digests")
    ap.add_argument("--stats", default=None,
                    help="per-rank JSON: launches, collective elements "
                         "per tick, wall ({rank} is replaced)")
    ap.add_argument("--check-kernels", action="store_true",
                    help="after the --digests ticks, one more tick whose "
                         "every kernel call is held against its plain "
                         "version on the same rank-local inputs")
    ap.add_argument("--run-dir", default=None,
                    help="shared resilience directory (or "
                         "$GRAFT_MH_RUN_DIR): heartbeats and chaos "
                         "markers (parallel/resilience.py)")
    args = ap.parse_args(argv)

    from .parallel import multihost, resilience

    rank_hint = args.process_id if args.process_id is not None \
        else int(os.environ.get(multihost.ENV_PROCESS_ID, "0"))
    nproc_hint = args.num_processes if args.num_processes is not None \
        else int(os.environ.get(multihost.ENV_NUM_PROCESSES, "1"))
    run_dir = args.run_dir or os.environ.get("GRAFT_MH_RUN_DIR") or None
    liveness = None
    if run_dir:
        liveness = resilience.RankLiveness.from_env(
            run_dir, rank_hint, nproc_hint).start()
    chaos = resilience.ChaosPlan.from_env(rank_hint, run_dir)

    import torch
    if args.threads:
        torch.set_num_threads(args.threads)
    multihost.initialize(args.coordinator, args.num_processes,
                         args.process_id, backend=args.backend)
    import torch.distributed as dist

    from . import rng
    from .ops import cudalib
    from .parallel.compile_plan import bucketed_chunk_plan, sharded_chunk_plan
    from .parallel.sharding import (bucketed_digests, make_mesh_2d,
                                    shard_bucketed_state, shard_state,
                                    state_digests)
    from .sim import checkpoint
    from .sim.state import SimState, state_nbytes

    n_proc, rank = multihost.process_count(), multihost.process_index()
    coord = multihost.is_coordinator()
    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("--device cuda: no CUDA device")
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    else:
        dev = torch.device("cpu")

    if not dist.is_initialized():
        raise SystemExit("run_multihost: no process group (give "
                         "--coordinator or $GRAFT_COORDINATOR)")
    mesh = make_mesh_2d(n_proc)
    bucketed = args.engine == "bucketed"
    if bucketed and args.topology == "sharded":
        from .sim import scenarios
        n = int(json.loads(args.kwargs).get(
            "n_peers", scenarios.POWERLAW_NS.get(args.scenario, 0)))
        cfg, tp, topo_rows, subscribed = scenarios.powerlaw_mh_spec(
            n, device="cpu")
        cfg = dataclasses.replace(cfg, **json.loads(args.cfg))
        state = multihost.init_bucketed_local(
            cfg, topo_rows, subscribed=subscribed, device=dev)
    else:
        cfg, tp, whole = build(args.scenario, json.loads(args.kwargs),
                               json.loads(args.cfg), args.topology_file)
        if bucketed:
            state = multihost.global_bucketed_state(
                shard_bucketed_state(whole, mesh, cfg), mesh, cfg, dev)
        else:
            state = SimState(*(x.to(dev)
                               for x in shard_state(whole, mesh, cfg)))
        del whole
    tp = type(tp)(*(x.to(dev) for x in tp))
    key = rng.PRNGKey(args.seed, device=dev)
    if coord:
        print(json.dumps({
            "info": "multihost run", "scenario": args.scenario,
            "n_peers": cfg.n_peers, "processes": n_proc,
            "backend": dist.get_backend(), "device": str(dev),
            "route": cfg.sharded_route,
            "state_nbytes_per_shard": state_nbytes(cfg, n_proc)["per_shard"]}),
            flush=True)

    health = args.health or os.environ.get("GRAFT_HEALTH_STREAM") or None
    to_host = multihost.gather_state
    if bucketed:
        chunk = bucketed_chunk_plan(mesh, cfg, tp,
                                    telemetry=health is not None)
        digest = bucketed_digests

        def from_host(host):
            return multihost.global_bucketed_state(
                multihost.local_bucketed_rows_state(host, cfg), mesh, cfg,
                dev)
    else:
        chunk = sharded_chunk_plan(mesh, cfg, tp,
                                   telemetry=health is not None)
        digest = state_digests

        def from_host(host):
            return multihost.global_state(
                multihost.local_rows_state(host, cfg), mesh, cfg, dev)
    recorder: list = []
    chunk.recorder = recorder
    t0 = time.perf_counter()
    cudalib.reset_launches()
    if args.digests or args.unsupervised:
        keys = rng.split(key, args.ticks)
        digests = []
        wall = 0.0          # the ticks' own time, digests excluded
        for i in range(args.ticks):
            t1 = time.perf_counter()
            state = chunk(state, keys[i:i + 1])
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            wall += time.perf_counter() - t1
            if args.digests:
                chunk.recorder = None
                digests.append(digest(state, cfg, mesh.group))
                chunk.recorder = recorder
        launches = dict(cudalib.LAUNCHES)
        if coord and args.digests:
            with open(args.digests, "w") as f:
                json.dump(digests, f)
        if args.dump_state:
            host = to_host(state, cfg, mesh.group)
            if coord:
                checkpoint.save(args.dump_state, host, cfg=cfg)
        checked: dict = {}
        if args.check_kernels:
            undo = check_kernels(checked)
            chunk.recorder = None
            try:
                state = chunk(state, rng.split(rng.fold_in(key, 1), 1))
            finally:
                undo()
    else:
        from .sim.supervisor import SupervisorConfig, supervised_run

        def run_fn(st, exec_cfg, tp_arg, keys):
            return chunk(st, keys, tp_arg)

        def state_to_host(st):
            return to_host(st, cfg, mesh.group)

        extra = {}
        if run_dir and not os.environ.get("GRAFT_CRASH_DIR"):
            # crash dumps stay with the run the relaunch driver owns
            extra["crash_dir"] = os.path.join(run_dir, "crash")
        sup = SupervisorConfig.from_env(
            **extra, chunk_ticks=args.chunk_ticks or max(1, args.ticks),
            checkpoint_dir=args.checkpoint_dir, health_path=health,
            run_fn=run_fn, state_to_host=state_to_host,
            state_from_host=from_host, write_files=coord,
            max_chunks=args.max_chunks, liveness=liveness, chaos=chaos,
            async_chunks=False,
            health_meta={"processes": n_proc})
        try:
            state, report = supervised_run(
                state, cfg, tp, key, args.ticks, sup, device=dev.type,
                _chunk_hook=chaos.fire if chaos is not None else None)
        finally:
            if liveness is not None:
                liveness.finish()
                liveness.stop()
        wall = time.perf_counter() - t0
        launches, checked = dict(cudalib.LAUNCHES), {}
        host = to_host(state, cfg, mesh.group)
        if coord:
            line = {"metric": f"multihost_run@{args.scenario}"
                              f"[{dev.type}x{n_proc}p]",
                    "n_peers": cfg.n_peers, "ticks": args.ticks,
                    "wall_s": wall, "chunks": report.chunks_run,
                    "retries": report.retries,
                    "resumed_from": report.resumed_from,
                    "tick": int(host.tick),
                    "fault_flags": int(host.fault_flags)}
            print(json.dumps(line), flush=True)
            if args.journal:
                with open(args.journal, "a") as f:
                    f.write(json.dumps(line) + "\n")
                    f.flush()
                    os.fsync(f.fileno())
            if args.dump_state:
                checkpoint.save(args.dump_state, host, cfg=cfg)
    if args.stats:
        per_tick: dict = {}
        max_elems: dict = {}
        for op, dtype, elems in recorder:
            nbytes = elems * torch.empty(0, dtype=getattr(
                torch, dtype.split(".")[-1])).element_size()
            per_tick[op] = per_tick.get(op, 0) + nbytes
            max_elems[op] = max(max_elems.get(op, 0), elems)
        stats = {"rank": rank, "backend": dist.get_backend(),
                 "device": str(dev), "ticks": args.ticks, "wall_s": wall,
                 "hbps": args.ticks / max(wall, 1e-9),
                 "launches": launches, "checked_calls": checked,
                 "collective_bytes_per_tick": {
                     k: v / max(1, args.ticks) for k, v in per_tick.items()},
                 "collectives_per_tick": len(recorder) / max(1, args.ticks),
                 "max_result_elements": max_elems}
        with open(args.stats.replace("{rank}", str(rank)), "w") as f:
            json.dump(stats, f)
    dist.barrier()
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
