"""Readings for a cell's limits: the compared numbers of the control (the
reference in float8 put in the program's place) on some seeds, and of the
program itself on others, each run at the cell's own size, in one process.

    python3 perfbench/tools/control.py --workload i3d.finetune_b48 \\
        --control-seeds 11,12,13 --program-seeds 21,22 --seconds 3

Prints one JSON line a reading; the program's come from a full run of the
cell with a short window."""

import argparse
import json
import os
import sys
import tempfile
import time


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--program-seeds", default="")
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--precision", default="fp8", choices=("fp8", "int8"))
    args = p.parse_args()
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
    import torch

    from perfbench.core import harness

    cell, config = harness.cell_files(args.workload)
    drv = harness.driver(cell["mix"]["driver"])
    seeds = lambda s: [int(x) for x in s.split(",") if x]  # noqa: E731
    try:
        for seed in seeds(args.control_seeds):
            t = time.perf_counter()
            with tempfile.TemporaryDirectory(prefix="perfbench-") as tmp:
                ctx = harness.Context(args.workload, cell, config, seed, args.seconds, False,
                                      torch.device("cuda"), harness.SetupClock(t), tmp)
                out = drv.control(ctx, args.precision)
            print(json.dumps({"control": args.precision, "seed": seed, **out,
                              "seconds": time.perf_counter() - t}, default=str), flush=True)
            torch.cuda.empty_cache()
        for seed in seeds(args.program_seeds):
            t = time.perf_counter()
            res, out, _ = harness.run_cell(args.workload, seed, args.seconds, False, t)
            print(json.dumps({"control": False, "seed": seed,
                              **{k: c["value"] for k, c in res["checks"].items()},
                              "correct": res["correct"], "e2e": res["metrics"], "info": out.info,
                              "seconds": time.perf_counter() - t}, default=str), flush=True)
            torch.cuda.empty_cache()
    finally:
        harness.stop_children()
    return 0


if __name__ == "__main__":
    sys.exit(main())
