#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py              # the whole check, on cuda:0

Phases, each printing its own lines:

1. build: the card's name and power limit (nvidia-smi), then one nvcc per
   CUDA source of go_libp2p_pubsub_tpu_torch/csrc, all in parallel;
2. kernels: each kernel against its plain PyTorch version on the card, at
   the main path's shapes (N=102400, K=32, T=1, M=64) plus a T=3 case and
   an emit case with budget 5 < M; equality is exact (integer outputs).
   Times are CUDA-event medians over 20 launches;
3. main path: ``build_headline(102400)`` and 8 ticks of ``run``, with the
   kernels' launch counts reset just before and read just after;
4. the card's 8-tick trajectory at 1024 peers against the port's CPU run
   (plain versions): integer, bool and packed fields equal, float32 fields
   within rtol 1e-6, checked after every tick;
5. the ``kernels`` JSON line, then the device JSON line last.

Any failure exits non-zero without the last line. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import multiprocessing as mp
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3 (NVIDIA data sheet)
# H100 SXM 32-bit integer issue rate outside the tensor cores: 132 SMs x 64
# INT32 lanes x 1.98 GHz boost clock = 16.7e12 ops/s (the data sheet's 67
# TFLOP/s fp32 counts an FMA as two operations on 128 fp32 lanes per SM).
INT32_OPS_PER_S = 132 * 64 * 1.98e9
N_FULL, K, M = 102400, 32, 64
REPS = 20

# TPU kernel each port replaces (function definition, file:line)
REPLACES = {
    "edge_table": "go_libp2p_pubsub_tpu/ops/permgather.py:230",
    "iwant_resolve": "go_libp2p_pubsub_tpu/ops/hopkernel.py:255",
    "hop": "go_libp2p_pubsub_tpu/ops/hopkernel.py:363",
    "emit": "go_libp2p_pubsub_tpu/ops/hopkernel.py:174",
}
LIBRARY_NOTE = ("library_ms is null for every kernel: no single PyTorch call "
                "computes a bit-table edge exchange, a fused hop, an IWANT "
                "resolve or a budgeted IHAVE chooser")


def _build_topology(conn, n, k, degree):
    """Child process: the headline underlay (a pure-Python O(N^2) build)."""
    sys.path.insert(0, REPO)
    from go_libp2p_pubsub_tpu_torch.sim import topology
    conn.send(tuple(topology.sparse(n, k, degree=degree)))
    conn.close()


class Smoke:
    def __init__(self):
        import torch
        self.torch = torch
        self.dev = torch.device("cuda")
        self.n = N_FULL
        self.results = {}

    # ---- helpers ---------------------------------------------------------
    def sync(self):
        self.torch.cuda.synchronize()

    def time_ms(self, fn, reps=REPS):
        """Median milliseconds of ``fn()`` by CUDA events."""
        torch = self.torch
        fn()
        self.sync()
        times = []
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return statistics.median(times)

    def rand_words(self, gen, *shape, density=0.5):
        """int32 words whose bits are set with probability ``density``."""
        torch = self.torch
        bits = torch.rand(*shape, 32, generator=gen, device=self.dev) < density
        from go_libp2p_pubsub_tpu_torch.ops.bits import pack_bool
        return pack_bool(bits)[..., 0]

    def topic_bits(self, gen, t, w):
        """[T, W] disjoint per-topic message sets (a random topic or none
        per message)."""
        torch = self.torch
        from go_libp2p_pubsub_tpu_torch.ops.bits import pack_bool
        topic = torch.randint(-1, t, (w * 32,), generator=gen, device=self.dev)
        return pack_bool(topic[None, :] == torch.arange(t, device=self.dev)[:, None])

    # ---- phase 2: each kernel against its plain version -------------------
    def check_kernel(self, name, case, kernel_fn, plain_fn, inputs, nbytes,
                     ops):
        """Run the kernel and its plain version on clones of ``inputs``;
        exact equality of every output; times; bound."""
        torch = self.torch

        def clone():
            return [x.clone() if isinstance(x, torch.Tensor) else x
                    for x in inputs]

        got = kernel_fn(*clone())
        want = plain_fn(*clone())
        self.sync()
        got = list(got) if isinstance(got, (tuple, list)) else [got]
        want = list(want) if isinstance(want, (tuple, list)) else [want]
        max_err = 0
        for i, (g, w_) in enumerate(zip(got, want)):
            if g.shape != w_.shape or g.dtype != w_.dtype:
                raise AssertionError(f"{name}[{case}] output {i}: "
                                     f"{tuple(g.shape)}/{g.dtype} vs "
                                     f"{tuple(w_.shape)}/{w_.dtype}")
            diff = (g.long() - w_.long()).abs()
            err = int(diff.max()) if diff.numel() else 0
            if err:
                idx = (diff != 0).nonzero()[0].tolist()
                raise AssertionError(
                    f"{name}[{case}] output {i} differs from the plain "
                    f"version at {idx}: {int(g[tuple(idx)])} vs "
                    f"{int(w_[tuple(idx)])}")
            max_err = max(max_err, err)
        fixed = clone()
        ms = self.time_ms(lambda: kernel_fn(*fixed))
        plain_ms = self.time_ms(lambda: plain_fn(*fixed), reps=5)
        bound_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        bound_ops = ops / INT32_OPS_PER_S * 1e3
        row = dict(case=case, max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
                   bound_ms=max(bound_bytes, bound_ops),
                   bound_by="bytes" if bound_bytes >= bound_ops else "operations",
                   bytes=nbytes, ops=ops)
        print(f"kernel {name} [{case}]: equal to its plain version "
              f"(max_abs_err {max_err}); {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"bound {row['bound_ms']:.4f} ms by {row['bound_by']} "
              f"({nbytes / 1e6:.1f} MB, {ops / 1e6:.1f} M int ops)",
              flush=True)
        self.results.setdefault(name, []).append(row)

    def phase_kernels(self):
        torch = self.torch
        from go_libp2p_pubsub_tpu_torch.ops import hopkernel as hk
        from go_libp2p_pubsub_tpu_torch.ops import permgather as pg
        gen = torch.Generator(device=self.dev)
        gen.manual_seed(0)
        n, k, m = self.n, K, M
        w = (m + 31) // 32
        u8 = torch.uint8

        def nb(*xs):
            return sum(x.numel() * x.element_size() for x in xs)

        def nbr_tab():
            return torch.randint(0, n, (n, k), generator=gen, device=self.dev,
                                 dtype=torch.int32)

        def bool_u8(*shape, p=0.5):
            return (torch.rand(*shape, generator=gen, device=self.dev) < p).to(u8)

        # edge_table: the heartbeat's exchanges at B = 2 and 1 planes (T=1),
        # and B = 6 (T=3)
        for b_planes, case in ((2, "B=2,T=1"), (1, "B=1,T=1"), (6, "B=6,T=3")):
            wb = (b_planes * k + 31) // 32
            table = self.rand_words(gen, n, wb, density=0.2)
            jn = nbr_tab()
            rk = torch.randint(0, k, (n, k), generator=gen, device=self.dev,
                               dtype=torch.int32)
            groups = (b_planes + 31) // 32
            self.check_kernel(
                "edge_table", case, pg.edge_table, pg.edge_table_plain,
                [table, jn, rk, b_planes],
                nb(table, jn, rk) + groups * n * k * 4,
                n * k * b_planes * 6)

        for t in (1, 3):
            tb = self.topic_bits(gen, t, w)
            nbr = nbr_tab()
            # hop
            tabs = [self.rand_words(gen, w, n, density=d)
                    for d in (0.05, 0.3, 0.3, 0.1, 0.9, 0.05, 0.2)]
            valid_msg = self.rand_words(gen, w, 1, density=0.9)
            fwd = bool_u8(n, t, k, p=0.3)
            mesh = bool_u8(n, t, k, p=0.3)
            cnt = [torch.randint(0, 256, (t, k, n), generator=gen,
                                 device=self.dev, dtype=torch.int32).to(u8)
                   for _ in range(3)]
            hop_in = tabs + [valid_msg, nbr, fwd, mesh, tb] + cnt
            hop_bytes = nb(*hop_in) + nb(*tabs[:4]) + nb(*cnt)
            self.check_kernel("hop", f"T={t}", hk.hop, hk.hop_plain, hop_in,
                              hop_bytes, n * k * w * (16 + 8 * t))
            # iwant_resolve
            pend = torch.randint(-1, k, (n, m), generator=gen, device=self.dev,
                                 dtype=torch.int32)
            rtabs = [self.rand_words(gen, w, n, density=d)
                     for d in (0.5, 0.3, 0.9, 0.05)]
            alive = self.rand_words(gen, w, 1, density=0.9)
            data_ok = bool_u8(n, k, p=0.9)
            res_in = [pend] + rtabs + [alive, data_ok, tb, nbr]
            res_bytes = nb(*res_in) + 2 * w * n * 4 + (2 * t + 1) * k * n
            self.check_kernel("iwant_resolve", f"T={t}",
                              lambda *a: hk.iwant_resolve(*a, m),
                              lambda *a: hk.iwant_resolve_plain(*a, m),
                              res_in, res_bytes,
                              n * m * 8 + n * k * w * (20 + 6 * t))
            # emit, unbudgeted (budget = M) and budgeted (5 < M)
            window = self.rand_words(gen, w, n, density=0.3)
            have = self.rand_words(gen, w, n, density=0.5)
            gossip = bool_u8(n, t, k, p=0.2)
            emit_in = [window, have, gossip, tb, nbr]
            for budget in ((m, 5) if t == 1 else (m,)):
                self.check_kernel(
                    "emit", f"T={t},budget={budget}",
                    lambda *a, b=budget: hk.emit(*a, m, b),
                    lambda *a, b=budget: hk.emit_plain(*a, m, b),
                    emit_in, nb(*emit_in) + n * m * 4,
                    n * k * w * (8 + 2 * t) + n * m)

    # ---- phase 3: the main path at full size ------------------------------
    def phase_main(self, topo):
        torch = self.torch
        from go_libp2p_pubsub_tpu_torch import rng
        from go_libp2p_pubsub_tpu_torch.ops import cudalib
        from go_libp2p_pubsub_tpu_torch.sim import (build_headline,
                                                    delivery_fraction,
                                                    mesh_degrees, run)
        from go_libp2p_pubsub_tpu_torch.sim.invariants import (
            VIOLATION_MASK, decode_violations)
        cfg, tp, st = build_headline(self.n, device=self.dev, topo=topo)
        key = rng.PRNGKey(0, device=self.dev)
        self.sync()
        cudalib.reset_launches()
        t0 = time.perf_counter()
        out = run(st, cfg, tp, key, 8, device=self.dev)
        self.sync()
        secs = time.perf_counter() - t0
        launches = dict(cudalib.LAUNCHES)
        deg = mesh_degrees(out).float()
        flags = int(out.fault_flags) & 0xFFFFFFFF
        delivered = float(out.delivered_total)
        print(f"main path: build_headline({self.n}) x 8 ticks in {secs:.3f} s "
              f"= {8 / secs:.3f} hb/s; delivery_fraction "
              f"{float(delivery_fraction(out, cfg)):.6f} (settled, age>=2: "
              f"{float(delivery_fraction(out, cfg, min_age_ticks=2)):.6f}); "
              f"mesh degree min/mean/max {float(deg.min()):.0f}/"
              f"{float(deg.mean()):.4f}/{float(deg.max()):.0f}; "
              f"delivered_total {delivered:.0f}; fault_flags 0x{flags:08x}",
              flush=True)
        print(f"main path launches: {json.dumps(launches)}", flush=True)
        zero = [name for name, c in launches.items() if c == 0]
        if zero:
            raise AssertionError(f"kernels never launched on the main "
                                 f"path: {zero}")
        if delivered <= 0:
            raise AssertionError("the main path delivered nothing")
        if flags & VIOLATION_MASK:
            raise AssertionError(f"invariant violations: "
                                 f"{decode_violations(flags)}")
        self.main_launches = launches
        self.main_hbs = 8 / secs

    # ---- phase 4: the card's trajectory against the CPU's ------------------
    def phase_trajectory(self):
        import numpy as np
        torch = self.torch
        from go_libp2p_pubsub_tpu_torch import rng
        from go_libp2p_pubsub_tpu_torch.sim import (build_headline, step,
                                                    state_to_numpy, topology)
        n = 1024
        topo = topology.sparse(n, K, degree=12)
        devs = (self.dev, torch.device("cpu"))
        runs = [build_headline(n, device=d, topo=topo) for d in devs]
        keys = [rng.split(rng.PRNGKey(0, device=d), 8) for d in devs]
        states = [r[2] for r in runs]
        for tick in range(8):
            states = [step(s, r[0], r[1], kk[tick], device=d)
                      for s, r, kk, d in zip(states, runs, keys, devs)]
            a, b = (state_to_numpy(s) for s in states)
            for f in a:
                x, y = a[f], b[f]
                if x.dtype == np.float32:
                    same = np.allclose(x, y, rtol=1e-6, atol=0.0)
                else:
                    same = np.array_equal(x, y)
                if not same:
                    raise AssertionError(
                        f"trajectory: field {f} differs between "
                        f"{devs[0]} and cpu after tick {tick}")
        print(f"trajectory: {n} peers x 8 ticks on {devs[0]} equal to the CPU "
              f"run (integer/bool/packed exact, float32 rtol 1e-6); "
              f"delivered_total {float(states[0].delivered_total):.0f}",
              flush=True)

    def kernels_line(self):
        rows = []
        for name, cases in self.results.items():
            # the main path's case is the first (T=1, its own B / budget)
            main = cases[0]
            rows.append(dict(
                name=name, route="cuda",
                source=f"go_libp2p_pubsub_tpu_torch/csrc/{name}.cu",
                replaces=REPLACES[name],
                launches=self.main_launches.get(name, 0),
                max_abs_err=max(c["max_abs_err"] for c in cases),
                ms=main["ms"], plain_ms=main["plain_ms"],
                bound_ms=main["bound_ms"], bound_by=main["bound_by"],
                library_ms=None,
                cases=[{kk: c[kk] for kk in ("case", "ms", "plain_ms",
                                             "bound_ms", "bound_by")}
                       for c in cases]))
        return json.dumps({"kernels": rows})


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    try:
        import go_libp2p_pubsub_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port's package is missing ({e})",
              file=sys.stderr)
        return 1
    smoke = Smoke()

    # the main path's underlay builds in a child process while the kernels
    # are built and checked
    ctx = mp.get_context("spawn")
    parent, child = ctx.Pipe(duplex=False)
    topo_proc = ctx.Process(target=_build_topology,
                            args=(child, smoke.n, K, 12), daemon=True)
    topo_proc.start()
    child.close()
    try:
        t_start = time.perf_counter()
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout.strip()
        print(smi.splitlines()[0] if smi else "nvidia-smi: no output",
              flush=True)
        print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
              f"{torch.cuda.get_device_name(0)}", flush=True)
        from go_libp2p_pubsub_tpu_torch.ops import cudalib
        t0 = time.perf_counter()
        report = cudalib.build_all()
        print(f"build: {len(report)} CUDA libraries in "
              f"{time.perf_counter() - t0:.1f} s (one nvcc per source, "
              "in parallel)", flush=True)
        for name, r in sorted(report.items()):
            print(f"build {name}: {r['ptxas']}", flush=True)
        smoke.phase_kernels()
        print(LIBRARY_NOTE, flush=True)
        topo = parent.recv()
        topo_proc.join()
        from go_libp2p_pubsub_tpu_torch.sim.topology import Topology
        smoke.phase_main(Topology(*topo))
        smoke.phase_trajectory()
        print(smoke.kernels_line(), flush=True)
        print(f"chip_smoke: all phases passed in "
              f"{time.perf_counter() - t_start:.1f} s", flush=True)
    finally:
        if topo_proc.is_alive():
            topo_proc.terminate()
            topo_proc.join()
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
