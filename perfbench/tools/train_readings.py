"""Readings of a training cell at its own size, several seeds in one
process: for each seed, one run of the cell with a short window, the
compared numbers of the program and of the reference in each precision
of ``--extra`` (each against the float32 reference), and every leaf's
norms of each reading written to ``--dump``.

    python3 perfbench/tools/train_readings.py --workload i3d.finetune_b48 \\
        --seeds 21,22 --seconds 3 --extra fp8,bf16_input --dump chiprun_out/look

Prints one JSON line a seed."""

import argparse
import json
import os
import sys
import tempfile
import time


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--extra", default="fp8")
    p.add_argument("--dump", default="")
    args = p.parse_args()
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
    import torch

    from perfbench.core import harness

    cell, config = harness.cell_files(args.workload)
    drv = harness.driver(cell["mix"]["driver"])
    extra = tuple(x for x in args.extra.split(",") if x)
    if args.dump:
        os.makedirs(args.dump, exist_ok=True)
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        with tempfile.TemporaryDirectory(prefix="perfbench-") as tmp:
            ctx = harness.Context(args.workload, cell, config, seed, args.seconds, False,
                                  torch.device("cuda"), harness.SetupClock(t), tmp)
            outcome, raw = drv.drive(ctx, extra)
        line = {"seed": seed, "program": drv.gaps(raw["program"], raw["fp32"])[0],
                **{x: drv.gaps(raw[x], raw["fp32"])[0] for x in extra},
                "correct": all(v <= lim for v, lim in outcome.checks.values()),
                "info": outcome.info, "seconds": time.perf_counter() - t}
        print(json.dumps(line, default=str), flush=True)
        if args.dump:
            with open(os.path.join(args.dump, f"{args.workload}.{seed}.json"), "w") as f:
                json.dump(raw, f)
        del outcome, raw
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
