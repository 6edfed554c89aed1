"""Closure of a train cell's sub-layer spans: one traced run of the cell;
device time a step launched inside each named span
(``program_spans.device_ms_per_step``), the rest of the step's device
time, their sum against the device's busy time a step, and the time the
named spans overlap one another (spans of sub-layers do not nest: it
should be 0):

    python3 perfbench/tools/sublayer_closure.py --workload timesformer_hr.finetune_b8 \\
        --spans timesformer.time_attn,timesformer.space_attn --seconds 8

It also counts the program's attention calls by path
(``asltpu_torch.ops.attention``). The last line of standard output is
JSON."""

import argparse
import itertools
import json
import os
import sys
import time


def main() -> int:
    t0 = time.perf_counter()
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--spans", required=True)
    p.add_argument("--seed", type=int, default=2718281829)
    p.add_argument("--seconds", type=float, default=8.0)
    p.add_argument("--device", default=None)
    args = p.parse_args()
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
    from perfbench.core import harness, program_spans

    from asltpu_torch.ops import attention as att

    calls = (att.fused_attention.calls, att.plain_attention.calls)
    try:
        result, outcome, ctx = harness.run_cell(args.workload, args.seed, args.seconds, True, t0,
                                                device=args.device)
    finally:
        harness.stop_children()
    run, tr, steps = harness.Run(ctx, outcome), outcome.trace, outcome.counters.get("steps_in_slice")
    names = args.spans.split(",")
    per_step = {n: program_spans.device_ms_per_step(run, n) for n in names}
    device_ms = sum(e.get("dur", 0) for e in tr.device) / 1e3 / steps
    per_step["rest"] = device_ms - sum(v or 0 for v in per_step.values())
    busy = 1e3 * tr.busy_s / steps
    ranges = {n: program_spans.union((e["ts"], e["ts"] + e.get("dur", 0)) for e in tr.events
                                     if e.get("cat") == "user_annotation" and e.get("name") == n)
              for n in names}
    out = {"workload": args.workload, "correct": result["correct"], "steps_in_slice": steps,
           "ms_per_step": per_step, "device_ms_per_step": device_ms,
           "busy_ms_per_step": busy,
           "device_over_busy_pct": 100.0 * device_ms / busy if busy else None,
           "spans_overlap_us": sum(program_spans.overlap(ranges[a], ranges[b])
                                   for a, b in itertools.combinations(names, 2)),
           "span_occurrences": {n: len(r) for n, r in ranges.items()},
           # Every attention call of the run, the reference's aside (it has
           # its own): the fused backend's and the plain path's.
           "attention_calls": {"fused": att.fused_attention.calls - calls[0],
                               "plain": att.plain_attention.calls - calls[1]},
           "metrics": {k: v["value"] for k, v in result["metrics"].items()},
           "memory_peak_bytes": result["device"]["memory_peak_bytes"]}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
