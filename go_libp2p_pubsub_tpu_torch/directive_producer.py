"""External directive producer for the live command plane (port of
scripts/directive_producer.py).

Feeds a run's ``--source`` file (``sim/commands.CommandQueue``) by copying
an input directive stream line by line, fsync'ing each write: the
durability contract the exactly-once resume leans on. Every byte the
consumer's stamped ``stream_offset`` covers is on disk, so a producer
restarted with ``--from-offset`` (the offset carried by the run's
``ingest_stalled`` journal marker and the dashboard's COASTING banner)
resumes the copy without duplicating or dropping a directive.

    # fresh feed at 200 lines/s
    python -m go_libp2p_pubsub_tpu_torch.directive_producer \\
        --stream workload.ndjsonl --out /shared/live.ndjsonl --rate 200

    # restart after a crash, from the offset the run stamped
    python -m go_libp2p_pubsub_tpu_torch.directive_producer \\
        --stream workload.ndjsonl --out /shared/live.ndjsonl \\
        --from-offset 18342

``--lines N`` stops the copy after N lines and parks the process (the
resilience drills SIGKILL it: the run's stalled-producer watchdog trips,
the run coasts, and the drill restarts the producer from the stamped
offset). ``--from-offset`` is a byte offset into ``--out`` mirroring
``--stream`` byte for byte: the copy seeks the input to the same offset
and truncates any torn tail beyond it in the output.

``--scenario`` writes a canonical composed attack stream to ``--out``
through ``sim.commands.write_stream`` instead of copying one:

    # eclipse + censorship landing on one region at tick 4
    python -m go_libp2p_pubsub_tpu_torch.directive_producer \\
        --scenario eclipse_censor --out /shared/live.ndjsonl \\
        --at 4 --region 8 --attackers 8

    # publish storms hammering the gater's RED admission for 3 ticks
    python -m go_libp2p_pubsub_tpu_torch.directive_producer \\
        --scenario storm_red --out /shared/live.ndjsonl \\
        --at 4 --attackers 32 --bursts 3

The tool is host code: it imports no tensor library.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

SCENARIOS = ("eclipse_censor", "storm_red")


def scenario_directives(name: str, *, at: int, region: int,
                        attackers: int, bursts: int) -> list:
    """The canonical composed streams (sim/commands.py grammar)."""
    if name == "eclipse_censor":
        # one timed compose line: the region [0, region) loses its honest
        # edges while the cohort [region, region + attackers) turns into
        # censoring actors, both at one boundary
        return [
            {"op": "tick", "tick": at},
            {"op": "compose", "tick": at, "parts": [
                {"op": "attack", "kind": "eclipse",
                 "peers": list(range(region))},
                {"op": "attack", "kind": "censor",
                 "peers": list(range(region, region + attackers))},
            ]},
        ]
    if name == "storm_red":
        # coordinated publish storms, one burst per tick: offered load
        # beyond the run's directive slots is what the gater's RED
        # admission sheds (journaled as ingest_shed)
        out = [{"op": "tick", "tick": at}]
        for b in range(bursts):
            out.append({"op": "attack", "tick": at + b, "kind": "storm",
                        "topic": 0, "peers": list(range(attackers))})
        return out
    raise ValueError(f"--scenario {name!r} unknown (supported: "
                     f"{', '.join(SCENARIOS)})")


def copy_stream(stream: str, out: str, *, from_offset: int = 0,
                rate: float = 0.0, lines: int | None = None) -> tuple:
    """Copy ``stream`` into ``out`` from byte ``from_offset``, one fsync'd
    line at a time; returns ``(lines written, input offset reached)``.
    With ``lines``, parks forever after that many."""
    delay = 1.0 / rate if rate > 0 else 0.0
    written = 0
    with open(stream, "rb") as src:
        src.seek(from_offset)
        with open(out, "ab") as dst:
            if dst.tell() != from_offset:
                # drop a torn tail so the output offset matches the input's
                dst.truncate(from_offset)
                dst.seek(from_offset)
            for line in src:
                dst.write(line)
                dst.flush()
                os.fsync(dst.fileno())
                written += 1
                if lines is not None and written >= lines:
                    print(f"[producer] parked after {written} lines at "
                          f"offset {src.tell()}", flush=True)
                    while True:
                        time.sleep(3600)
                if delay:
                    time.sleep(delay)
        return written, src.tell()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--stream", default=None,
                    help="input NDJSON directive file to feed from "
                         "(exactly one of --stream/--scenario)")
    ap.add_argument("--scenario", default=None, choices=SCENARIOS,
                    help="write a canonical composed attack stream to "
                         "--out instead of copying --stream")
    ap.add_argument("--at", type=int, default=4,
                    help="--scenario: tick the composed attack lands at")
    ap.add_argument("--region", type=int, default=8,
                    help="--scenario eclipse_censor: eclipsed-region size")
    ap.add_argument("--attackers", type=int, default=8,
                    help="--scenario: attacker cohort size")
    ap.add_argument("--bursts", type=int, default=3,
                    help="--scenario storm_red: storm lines (one per tick)")
    ap.add_argument("--out", required=True,
                    help="the run's --source file (appended, fsync'd per "
                         "line)")
    ap.add_argument("--rate", type=float, default=0.0,
                    help="lines per second (0 = as fast as possible)")
    ap.add_argument("--from-offset", type=int, default=0,
                    help="resume the copy at this byte offset (the run's "
                         "stamped stream_offset)")
    ap.add_argument("--lines", type=int, default=None,
                    help="stop after N lines and sleep forever (chaos "
                         "drills SIGKILL the parked process)")
    args = ap.parse_args(argv)

    if (args.stream is None) == (args.scenario is None):
        ap.error("exactly one of --stream / --scenario is required")
    if args.scenario:
        from .sim.commands import write_stream
        directives = scenario_directives(
            args.scenario, at=args.at, region=args.region,
            attackers=args.attackers, bursts=args.bursts)
        write_stream(args.out, directives, end=True)
        print(f"[producer] scenario {args.scenario}: "
              f"{len(directives) + 1} lines -> {args.out}", flush=True)
        return 0
    written, end_offset = copy_stream(
        args.stream, args.out, from_offset=args.from_offset, rate=args.rate,
        lines=args.lines)
    print(f"[producer] done: {written} lines, offset {end_offset}",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
