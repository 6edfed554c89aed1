"""Find the knee of a serving cell once: run its driver at each of a list of
Poisson rates, one run a rate in one process, and print per rate what was
offered, completed, still queued when the window closed, and the tails.

    python3 perfbench/tools/knee.py --workload mobilenet_gru.serve_poisson \\
        --seconds 20 --rates 150,200,250,300 --seed 1

The knee is the highest rate whose queue at the window's close holds
less than ``--backlog-s`` seconds of arrivals: above it the backlog grows
over the window. Cells are then set at fixed shares of it."""

import argparse
import copy
import json
import os
import sys
import time


def main() -> int:
    t0 = time.perf_counter()
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=20.0)
    p.add_argument("--rates", required=True)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--backlog-s", type=float, default=0.5)
    args = p.parse_args()
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
    from perfbench.core import harness

    cell, _ = harness.cell_files(args.workload)
    rows = []
    try:
        for rate in (float(r) for r in args.rates.split(",")):
            c = copy.deepcopy(cell)
            c["mix"]["params"]["rate_per_s"] = rate
            res, out, _ = harness.run_cell(args.workload, args.seed, args.seconds, False,
                                           time.perf_counter(), cell=c)
            row = {"rate_per_s": rate, "correct": res["correct"],
                   "completed_per_s": out.e2e["serve_clips_per_s"],
                   "p95_ms": out.e2e["serve_p95_ms"], **out.info}
            row["sustained"] = row["queued_at_close"] < args.backlog_s * rate
            rows.append(row)
            print(json.dumps(row, default=str), flush=True)
    finally:
        harness.stop_children()
    ok = [r["rate_per_s"] for r in rows if r["sustained"]]
    print(json.dumps({"knee_per_s": max(ok) if ok else None, "seconds": time.perf_counter() - t0}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
