"""Run one benchmark cell once on the card this machine holds:

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout. The last line of standard output is the
result object; the compared numbers and their limits close standard
error. Without a CUDA device, or with fewer than the cell asks for, it
exits 2 and prints no result; with a JAX module loaded at the end, 3.
"""

import os
import sys
import time

T_START = time.perf_counter()
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

if __name__ == "__main__":
    from port_bench import env
    env.prepare()
    from port_bench.harness import main
    sys.exit(main(t_start=T_START))
