"""Run one cell of the benchmark once and print its result as the last line
of standard output:

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run it from the root of a checkout on a machine with the card(s) the cell
asks for. ``--trace 0`` reports the cell's end-to-end metrics, ``--trace
1`` its per-layer metrics from a profiler capture. This file imports no
torch: spawned decode and writer processes import it again."""

import argparse
import os
import sys
import time

T0 = time.perf_counter()


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from perfbench.core import harness

    sys.exit(harness.main(parse(), T0))
