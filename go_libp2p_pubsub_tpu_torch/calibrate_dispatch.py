"""Calibrate the dispatch table (ops/dispatch.py) on the device the port
runs on (port of scripts/calibrate_dispatch.py).

    python -m go_libp2p_pubsub_tpu_torch.calibrate_dispatch [--device cpu]
        [--out PATH] [--journal PATH] [--shapes "n,k,m;n,k,m;..."]
        [--repeats R] [--quarantine-factor F]

Times every (op, formulation) pair the port's resolvers take at each
shape: the ``[W, N]`` words gather, the ``[N, K]`` payload permute, the
packed edge exchange, the masked selection, and the hop and the emit
(one full engine step per ``hop_mode``: every formulation does the same
non-hop work, so the ranking, which is all dispatch reads, is exact). A
formulation the resolver sends elsewhere at a shape is not timed under
its own label. On the card each call's device time is taken by CUDA
events (one warm call first, then the median of ``repeats``, each call
queued behind a spin kernel so that the host's enqueue time is hidden, as
it is in a captured chunk), and each kernel formulation
(``pallas``, ``mxu``, and the fused hop and emit) must raise its kernel's
count in ``ops.cudalib.LAUNCHES`` while a plain one must leave it alone;
if either fails the run fails, so a plain twin is never timed under a
kernel's label. On the CPU the wrappers run their plain versions and the
host clock times them.

Every measurement is fsync-appended to a journal as it lands (op,
formulation, shape, ms, the device's fingerprint), and a rerun skips the
measurements its journal already holds for the same fingerprint. The
output is a dispatch table that ``ops.dispatch.load_table`` validates:
the measured ms go to the entry of the platform measured (``cuda`` or
``cpu``); a formulation that fails to run is quarantined, and so is one
``--quarantine-factor`` times slower than the best at every measured
shape of its op. ``GRAFT_DISPATCH_TABLE=PATH`` makes ``"auto"`` resolve
through it. Runs on the card unless the caller passes ``--device cpu``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import time
from types import SimpleNamespace

import numpy as np
import torch

# the kernel each kernel formulation launches: (op, formulation) -> name in
# ops/cudalib.KERNELS
KERNEL_OF = {
    ("words", "pallas"): "gather_words",
    ("words", "mxu"): "take_words",
    ("edge_permute", "pallas"): "permutation_gather",
    ("edge_permute", "mxu"): "take_words",
    ("edge_packed", "pallas"): "edge_table",
    ("edge_packed", "mxu"): "take_words",
    ("hop", "pallas"): "hop",
    ("hop", "pallas-mxu"): "hop",
    ("emit", "pallas"): "emit",
    ("emit", "pallas-mxu"): "emit",
}
# the kernel an op's plain formulations must not launch
_OP_KERNELS = {
    "words": ("gather_words", "take_words"),
    "edge_permute": ("permutation_gather", "take_words"),
    "edge_packed": ("edge_table", "take_words"),
    "hop": ("hop",),
    "emit": ("emit",),
    "selection": (),
}


def _spin_cycles_per_ms() -> float:
    """The rate of the card's spin kernel (``torch.cuda._sleep``), by CUDA
    events."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    torch.cuda._sleep(10 ** 7)
    b.record()
    b.synchronize()
    return 10 ** 7 / a.elapsed_time(b)


def _time_call(fn, args, repeats: int, dev: torch.device,
               spin_rate: float | None = None) -> float:
    """Median ms of ``fn(*args)`` after one warm call. On the card: device
    time between two CUDA events around one call, queued behind a spin
    kernel long enough that the host enqueues the whole call before it
    runs (so the wrapper's host time is hidden, as in a captured chunk).
    On the CPU: the host clock."""
    fn(*args)
    samples = []
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        fn(*args)
        torch.cuda.synchronize(dev)
        host_ms = (time.perf_counter() - t0) * 1e3
        spin = int(spin_rate * (2 * host_ms + 1))
        for _ in range(repeats):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(spin)
            a.record()
            fn(*args)
            b.record()
            b.synchronize()
            samples.append(a.elapsed_time(b))
        return statistics.median(samples)
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn(*args)
        samples.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(samples)


def measurements(n: int, k: int, m: int, dev, t: int = 2, topo=None):
    """Yield ``(ops, formulation, shape, fn, args)`` for one shape point:
    ``ops`` the op names the one timing is recorded under (the hop and
    the emit share a step). ``topo`` is the underlay (an ``[n, k]``
    Topology; default ``sparse(n, k, degree=min(12, k - 1), seed=7)``)."""
    from .ops.heartbeat import edge_gather_packed
    from .ops.hopkernel import resolve_emit_mode, resolve_hop_mode
    from .ops.permgather import (edge_sort_key, gather_words,
                                 permutation_gather, resolve_edge_packed_mode,
                                 resolve_mode, resolve_words_mode)
    from .ops.selection import resolve_selection_mode, select_random
    from .rng import PRNGKey
    from .sim import SimConfig, TopicParams, init_state
    from .sim.engine import step
    from .sim.topology import sparse

    topo = topo if topo is not None else sparse(n, k, degree=min(12, k - 1),
                                                seed=7)
    nb = torch.as_tensor(np.asarray(topo.neighbors, np.int32), device=dev)
    rs = torch.as_tensor(np.asarray(topo.reverse_slot, np.int32), device=dev)
    gen = np.random.default_rng(7)
    w = (m + 31) // 32
    words = torch.as_tensor(gen.integers(-2**31, 2**31, (w, n), np.int64)
                            .astype(np.int32), device=dev)
    payload = torch.as_tensor(gen.integers(-2**31, 2**31, (n, k), np.int64)
                              .astype(np.int32), device=dev)
    nbr = nb.clamp(0, n - 1)
    rk = rs.clamp(0, k - 1)
    sk_w = edge_sort_key(nb, rs, k_major=True)
    sk_e = edge_sort_key(nb, rs, k_major=False)
    g3 = np.random.default_rng(3)
    masks = [torch.as_tensor(g3.random((n, t, k)) < 0.35, device=dev)
             for _ in range(2)]
    edges = SimpleNamespace(neighbors=nb, reverse_slot=rs)

    for form in ("scalar", "rows", "sort", "mxu", "pallas"):
        if resolve_words_mode(form, w, n, k, have_sort_key=True) != form:
            continue
        yield ("words",), form, {"w": w, "n": n, "k": k}, \
            lambda x, i, s, f=form: gather_words(x, i, f, m, sort_key=s), \
            (words, nbr, sk_w)
    for form in ("scalar", "rows", "sort", "mxu", "pallas"):
        if resolve_mode(form, torch.int32, n, k, have_sort_key=True) != form:
            continue
        yield ("edge_permute",), form, {"n": n, "k": k}, \
            lambda p, i, r, s, f=form: permutation_gather(p, i, r, f,
                                                          sort_key=s), \
            (payload, nbr, rk, sk_e)
    for form in ("scalar", "rows", "sort", "mxu", "pallas"):
        if resolve_edge_packed_mode(form, n, k, 2 * t) != form:
            continue
        yield ("edge_packed",), form, {"n": n, "k": k, "b": 2 * t}, \
            lambda m0, m1, e, f=form: edge_gather_packed([m0, m1], e, f), \
            (masks[0], masks[1], edges)

    key = PRNGKey(0, device=dev)
    mask3 = torch.as_tensor(g3.random((n, t, k)) < 0.5, device=dev)
    count = torch.as_tensor(g3.integers(0, 13, (n, t)), dtype=torch.int32,
                            device=dev)
    for form in ("iter", "sort", "ranks"):
        if resolve_selection_mode(form, k, 12) != form:
            continue
        yield ("selection",), form, {"k": k, "max_count": 12}, \
            lambda ms, c, ky, f=form: select_random(ms, c, ky, max_count=12,
                                                    mode=f), \
            (mask3, count, key)

    # the hop and the emit run inside forward_tick: one full step a
    # hop_mode ("pallas-mxu" runs the fused kernels as "pallas" does)
    cfg0 = SimConfig(n_peers=n, k_slots=k, n_topics=t, msg_window=m,
                     publishers_per_tick=4, prop_substeps=4)
    tp0 = TopicParams.disabled(t, device=dev)
    st0 = init_state(cfg0, topo, device=dev)
    key1 = PRNGKey(1, device=dev)
    for form in ("xla", "pallas", "pallas-mxu"):
        cfgf = dataclasses.replace(cfg0, hop_mode=form)
        want = "xla" if form == "xla" else "pallas"
        ops = tuple(op for op, resolved in (
            ("hop", resolve_hop_mode(cfgf)), ("emit", resolve_emit_mode(cfgf)))
            if resolved == want)
        if ops:
            yield ops, form, {"w": w, "n": n, "k": k}, \
                lambda s0, tp_, ky, c=cfgf: step(s0, c, tp_, ky, device=dev), \
                (st0, tp0, key1)


def _check_launches(ops, form: str, before: dict, after: dict) -> None:
    """On the card: a kernel formulation raised its kernel's count, a plain
    one left its op's kernels alone."""
    for op in ops:
        kernel = KERNEL_OF.get((op, form))
        if kernel is not None and after[kernel] <= before[kernel]:
            raise RuntimeError(f"calibrate_dispatch: {op}/{form} ran without "
                               f"launching its kernel {kernel}")
        if kernel is None:
            ran = [kk for kk in _OP_KERNELS[op] if after[kk] > before[kk]]
            if ran:
                raise RuntimeError(f"calibrate_dispatch: the plain {op}/"
                                   f"{form} launched {ran}")


def journal_load(path: str | None, fp: dict) -> dict:
    """{(op, form, shape items): record} of the journal's records under the
    fingerprint ``fp`` (a torn tail line's point runs again)."""
    recs = {}
    if path and os.path.exists(path):
        with open(path) as f:
            for ln in f:
                try:
                    r = json.loads(ln)
                except json.JSONDecodeError:
                    continue
                if r.get("fingerprint") == fp and "op" in r:
                    recs[(r["op"], r["form"],
                          tuple(sorted(r["shape"].items())))] = r
    return recs


def _journal_append(path: str | None, rec: dict) -> None:
    if not path:
        return
    with open(path, "a") as f:
        f.write(json.dumps(rec) + "\n")
        f.flush()
        os.fsync(f.fileno())


def merge_table(out_path: str, platform: str, fp: dict, journal: dict,
                quarantine_factor: float) -> dict:
    """Fold the journal's measurements into the dispatch table at
    ``out_path`` (seeded from that file when it exists, else from the
    shipped table; other platforms' entries are kept) and write it
    atomically."""
    from .ops.dispatch import DEFAULT_TABLE_PATH, OPS, _validate
    base_path = out_path if os.path.exists(out_path) else DEFAULT_TABLE_PATH
    with open(base_path) as f:
        table = _validate(json.load(f), base_path)
    entry = table["platforms"].setdefault(platform, json.loads(json.dumps(
        table["platforms"].get("default")
        or next(iter(table["platforms"].values())))))
    entry["fingerprint"] = fp
    buckets: dict = {}
    failed: dict = {}
    for (op, form, shape_key), rec in journal.items():
        if "ms" in rec:
            buckets.setdefault((op, shape_key), {})[form] = rec["ms"]
        else:
            failed.setdefault(op, set()).add(form)
    entry["measured"] = [
        {"op": op, "shape": dict(shape_key), "ms": ms}
        for (op, shape_key), ms in sorted(buckets.items())]
    quarantined: dict = {op: sorted(forms) for op, forms in failed.items()}
    if quarantine_factor > 0:
        for op in OPS:
            per_form: dict = {}
            for (bop, _sk), ms in buckets.items():
                if bop != op or not ms:
                    continue
                best = min(ms.values())
                for form, v in ms.items():
                    per_form.setdefault(form, []).append(
                        v >= quarantine_factor * max(best, 1e-6))
            for form, flags in per_form.items():
                if flags and all(flags):
                    quarantined[op] = sorted(set(quarantined.get(op, []))
                                             | {form})
    entry["quarantined"] = quarantined
    table["generated_by"] = "go_libp2p_pubsub_tpu_torch/calibrate_dispatch.py"
    tmp = out_path + f".tmp{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(table, f, indent=1)
        f.write("\n")
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, out_path)
    return table


def calibrate(shapes, out: str, *, journal: str | None = None,
              repeats: int = 3, quarantine_factor: float = 3.0, device=None,
              topologies=None, emit=print) -> dict:
    """Measure every ``(n, k, m)`` of ``shapes`` on ``device`` (cuda unless
    the caller passes ``"cpu"``), journal each measurement, and write the
    table to ``out`` (returned). ``topologies`` maps ``(n, k)`` to a
    prebuilt underlay. ``journal`` defaults to ``out + ".journal.jsonl"``."""
    from .device import resolve_device
    from .ops import cudalib
    from .ops.dispatch import platform_fingerprint

    dev = resolve_device(device)
    fp = platform_fingerprint(dev)
    spin_rate = _spin_cycles_per_ms() if dev.type == "cuda" else None
    journal = journal or out + ".journal.jsonl"
    done = journal_load(journal, fp)
    emit(json.dumps({"info": "calibrate_dispatch", "platform": dev.type,
                     "shapes": [list(s) for s in shapes], "out": out,
                     "journal": journal, "resumed_points": len(done)}))
    for n, k, m in shapes:
        topo = (topologies or {}).get((n, k))
        for ops, form, shape, fn, args in measurements(n, k, m, dev,
                                                       topo=topo):
            keys = [(op, form, tuple(sorted(shape.items()))) for op in ops]
            if all(kk in done for kk in keys):
                continue
            before = dict(cudalib.LAUNCHES)
            rec = {"form": form, "shape": shape, "platform": dev.type,
                   "fingerprint": fp}
            try:
                rec["ms"] = round(_time_call(fn, args, repeats, dev,
                                             spin_rate), 4)
            except Exception as e:          # the formulation cannot run
                rec["error"] = str(e)[:300]  # here: quarantined
            else:
                if dev.type == "cuda":
                    _check_launches(ops, form, before, cudalib.LAUNCHES)
            for op, kk in zip(ops, keys):
                full = {"op": op, **rec}
                emit(json.dumps(full))
                _journal_append(journal, full)
                done[kk] = full
    table = merge_table(out, dev.type, fp, done, quarantine_factor)
    entry = table["platforms"][dev.type]
    emit(json.dumps({"info": "dispatch table written", "path": out,
                     "quarantined": entry["quarantined"],
                     "measured_buckets": len(entry["measured"])}))
    return table


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="dispatch_table_measured.json")
    ap.add_argument("--journal", default="")
    ap.add_argument("--shapes", default="",
                    help='"n,k,m;n,k,m" (default: 1024,32,64;4096,32,64 on '
                         'the CPU, 10240,48,64;102400,32,64 on the card)')
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--quarantine-factor", type=float, default=3.0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    from .device import resolve_device
    dev = resolve_device(args.device)
    spec = args.shapes or ("1024,32,64;4096,32,64" if dev.type == "cpu"
                           else "10240,48,64;102400,32,64")
    shapes = [tuple(int(x) for x in s.split(",")) for s in spec.split(";")]
    calibrate(shapes, args.out, journal=args.journal or None,
              repeats=args.repeats, quarantine_factor=args.quarantine_factor,
              device=dev)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
