"""Check the program's spans in one run of a cell, and what they cost:

    python3 perfbench/tools/span_check.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1> [--device cpu]

With ``--trace 0`` it runs the cell untraced and prints how many spans the
program kept (none is right: the recorder is on only under a capture).
With ``--trace 1`` it runs the cell traced and prints the per-layer
metrics, the spans a second by name, whether the process's trace base is
one constant, how far each span with a ``record_function`` twin in the
capture lies from it, the train step's closure (forward + backward +
optimizer + preprocess device time against the device's busy time a step)
and, in a serving cell, the share of the slice's requests whose spans
account for submit → answer within 1 ms of the client's own stamps.
``--cost`` prints the ns a ``span()`` and a ``record_span()`` take with
recording off and on (under a capture of the host and, where there is
one, the card) instead. The last line of standard output is JSON."""

import argparse
import bisect
import collections
import json
import os
import statistics
import sys
import time

MS = 1e3  # us


def span_cost(n: int = 20000) -> dict:
    """ns per call of span() and record_span(), recording off and on."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from asltpu_torch.utils import profiling

    def timed(fn) -> float:
        best = []
        for _ in range(5):
            t = time.perf_counter_ns()
            for _ in range(n):
                fn()
            best.append((time.perf_counter_ns() - t) / n)
        return min(best)

    def with_span():
        with profiling.span("cost.span", batch=1):
            pass

    def with_scope():
        with profiling.named_scope("cost.scope"):
            pass

    def stamped():
        profiling.record_span("cost.record", 1, 2, batch=1)

    out = {"named_scope_off": timed(with_scope), "span_off": timed(with_span),
           "record_span_off": timed(stamped)}
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available()
                                     else [])
    with profile(activities=acts):
        out.update(named_scope_on=timed(with_scope), span_on=timed(with_span),
                   record_span_on=timed(stamped))
    profiling.RECORDER.clear()
    return out


def base_is_constant() -> dict:
    """The base of two captures of the host and the card against the
    program's trace_base_ns()."""
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from asltpu_torch.utils import profiling

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available()
                                     else [])
    bases = []
    for _ in range(2):
        with profile(activities=acts) as prof:
            with record_function("base"):
                torch.ones(4, device="cuda" if torch.cuda.is_available() else "cpu").sum()
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                bases.append(int(json.load(f)["baseTimeNanoseconds"]))
        finally:
            os.unlink(path)
    return {"capture_bases": bases, "trace_base_ns": profiling.trace_base_ns(),
            "constant": len(set(bases + [profiling.trace_base_ns()])) == 1}


def twins(trace, spans) -> dict:
    """Per span name with user_annotation twins on the span's thread: how
    many pairs, and the largest distance of a start and of an end, in us."""
    events = collections.defaultdict(list)
    for e in trace.events:
        if e.get("cat") == "user_annotation":
            events[(e["name"], e["tid"])].append(e)
    out = {}
    for (name, tid), evs in events.items():
        mine = sorted((s for s in spans if s.name == name and s.tid == tid),
                      key=lambda s: s.start)
        if not mine:
            continue
        evs.sort(key=lambda e: e["ts"])
        starts = [e["ts"] for e in evs]
        d = []
        for s in mine:
            k = bisect.bisect_left(starts, s.start)
            near = [evs[j] for j in (k - 1, k) if 0 <= j < len(evs)]
            if near:
                e = min(near, key=lambda e: abs(e["ts"] - s.start))
                d.append(max(abs(e["ts"] - s.start), abs(e["ts"] + e["dur"] - s.end)))
        if d:
            d.sort()
            out[name] = {"pairs": len(d), "median_us": d[len(d) // 2],
                         "p99_us": d[min(len(d) - 1, int(0.99 * len(d)))], "max_us": d[-1],
                         "within_200us_pct": 100.0 * sum(x <= 200 for x in d) / len(d)}
    return out


def client_stamps():
    """Wrap PredictServer.submit to stamp each request before it is
    submitted and when its answer comes, in the order of submission."""
    from asltpu_torch import serve

    stamps = []
    orig = serve.PredictServer.submit

    def submit(self, *a, **k):
        row = [time.time_ns(), None]
        fut = orig(self, *a, **k)
        stamps.append(row)
        fut.add_done_callback(lambda _, row=row: row.__setitem__(1, time.time_ns()))
        return fut

    serve.PredictServer.submit = submit
    return stamps


def serve_closure(trace, spans, stamps, base_ns) -> dict:
    """Share of the requests taken in the slice whose queue span starts
    within 1 ms of the client's stamp before submit and whose batch's
    reply span holds the answer's stamp and ends within 1 ms of it."""
    queue = {s.ids["request"]: s for s in spans if s.name == "serve.queue"
             and trace.lo <= s.end <= trace.hi}
    reply = {s.ids["batch"]: s for s in spans if s.name == "serve.reply"}
    ok = 0
    for rid, q in queue.items():
        sent, answered = (None, None) if rid >= len(stamps) else stamps[rid]
        r = reply.get(q.ids["batch"])
        if sent is None or answered is None or r is None:
            continue
        a = (answered - base_ns) / 1e3
        if abs(q.start - (sent - base_ns) / 1e3) <= MS and r.start <= a <= r.end <= a + MS:
            ok += 1
    return {"requests": len(queue), "accounted": ok,
            "accounted_pct": 100.0 * ok / len(queue) if queue else None}


def main() -> int:
    t0 = time.perf_counter()
    p = argparse.ArgumentParser()
    p.add_argument("--workload")
    p.add_argument("--seed", type=int, default=3100000007)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--trace", type=int, choices=(0, 1), default=1)
    p.add_argument("--device", default=None)
    p.add_argument("--cost", action="store_true")
    args = p.parse_args()
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
    if args.cost:
        out = {"cost_ns": span_cost(), "base": base_is_constant()}
        print(json.dumps(out), flush=True)
        return 0
    from perfbench.core import harness, program_spans
    from asltpu_torch.utils import profiling

    stamps = client_stamps()
    try:
        result, outcome, ctx = harness.run_cell(args.workload, args.seed, args.seconds,
                                                bool(args.trace), t0, device=args.device)
    finally:
        harness.stop_children()
    raw = profiling.recorded_spans()
    out = {"workload": args.workload, "correct": result["correct"],
           "recorded": len(raw), "dropped": profiling.RECORDER.dropped}
    if args.trace and outcome.trace is not None:
        tr = outcome.trace
        base = profiling.trace_base_ns()
        spans = program_spans.recorded(base) or []
        inside = [s for s in spans if tr.lo <= s.end <= tr.hi]
        out["metrics"] = {k: v["value"] for k, v in result["metrics"].items()}
        out["window_s"] = tr.window_s
        out["busy_s"] = tr.busy_s
        out["spans_per_s"] = {k: n / tr.window_s for k, n in
                              collections.Counter(s.name for s in inside).items()}
        out["spans_per_s_all"] = len(inside) / tr.window_s
        out["twins"] = twins(tr, spans)
        run = harness.Run(ctx, outcome)
        steps = outcome.counters.get("steps_in_slice")
        if steps:
            parts = {n: program_spans.device_ms_per_step(run, f"train.{n}")
                     for n in ("preprocess", "forward", "backward", "optimizer")}
            busy = 1e3 * tr.busy_s / steps
            covered = sum(v or 0 for v in parts.values())
            out["train_closure"] = {"ms_per_step": parts, "busy_ms_per_step": busy,
                                    "covered_pct": 100.0 * covered / busy if busy else None}
        if any(s.name == "serve.queue" for s in spans):
            out["serve_closure"] = serve_closure(tr, spans, stamps, base)
            waits = [s.ms for s in inside if s.name == "serve.queue"]
            out["queue_wait_median_ms"] = statistics.median(waits) if waits else None
    print(json.dumps(out, default=str), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
