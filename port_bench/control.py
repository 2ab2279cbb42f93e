"""Readings that set the limits of ``correct``: one cell run on several
seeds in one process, as the program is (``--precision f32``) or with
its compact storage switched on, the control (``--precision compact``),
each run printing its compared numbers as one JSON line:

    python3 port_bench/control.py --workload <cell> --seeds 1,2,3 \\
        --seconds <s> [--precision compact]

The benchmark's own runs never run this. It needs the card, as they do.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--precision", choices=("f32", "compact"), default="f32")
    args = ap.parse_args(argv)
    from port_bench import env
    env.prepare()
    import torch

    from port_bench.harness import run_cell
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        r = run_cell(args.workload, seed, args.seconds, False,
                     overrides={"state_precision": args.precision})
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "precision": args.precision,
                          "correct": r["correct"],
                          "hb_per_s": r["metrics"]["hb_per_s"]["value"],
                          "checks": {k: v["value"]
                                     for k, v in r["checks"].items()}}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
