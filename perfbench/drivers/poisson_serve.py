"""Clips served one request at a time: ``asltpu_torch.serve.PredictServer``
as the ``serve`` command runs it, offered an open-loop Poisson load.

Each request is one of a set of seeded staged clips, each clip used
equally often; the gaps between arrivals are the same for every seed and
come in an order of the seed's (``stats.poisson_gaps``). One generator
thread sends each request at its scheduled time whatever the server is
doing, and each request is timed from that time. Set-up warms every
batch bucket and offers
``warm_s`` seconds of the same load; the window is the next ``--seconds``
of the schedule. After it, no more is sent and every request is waited
for (a minute at most). Where the mix sets ``max_outstanding``, a request
that comes while that many are unanswered is not sent (the client gives
up on a full server): a load above capacity keeps the server's queue full
and no longer, so the wait after the window stays short.

``serve_p95_ms`` is the 95th percentile over every request scheduled in
the window and sent (a failed one counts as missing), ``serve_clips_per_s`` the
requests completed in the window over its length. Every answer is
compared with the reference's logits of its clip."""

from __future__ import annotations

import contextlib
import statistics
import threading
import time
from typing import Optional

import numpy as np
import torch
from torch.profiler import record_function

from perfbench.core import program, stats, trace
from perfbench.core.harness import Context, Outcome

DRAIN_S = 60.0


def snapshot(server):
    s = server.stats
    return s.requests, s.batches, s.padded_slots


def offer(server, clips: np.ndarray, picks, sched, sent, done, futures, stop: threading.Event,
          slots: Optional[threading.Semaphore], shed):
    """Send request ``i`` (clip ``picks[i]``) at ``sched[i]``, recording when
    it went and when its answer came; with ``slots``, only while one of
    them is free, marking it ``shed`` otherwise."""
    def answered(_, i):
        done[i] = time.perf_counter()
        if slots is not None:
            slots.release()

    for i, (clip, due) in enumerate(zip(picks, sched)):
        wait = due - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        if stop.is_set():
            return
        if slots is not None and not slots.acquire(blocking=False):
            shed[i] = True
            continue
        sent[i] = time.perf_counter()
        with record_function("PredictServer.submit"):
            fut = server.submit(clips[clip])
        fut.add_done_callback(lambda f, i=i: answered(f, i))
        futures[i] = fut


def run(ctx: Context) -> Outcome:
    from asltpu_torch.serve import PredictServer

    p, config, dev = ctx.params, ctx.config, ctx.device
    ref = program.reference(config)
    with ctx.setup.part("weights"):
        params = program.params_for(config, ctx.seed, dev)
    with ctx.setup.part("clips"):
        clips_dev = program.smooth_clips(p["clips"], config, ctx.seed, dev)
        clips = clips_dev.cpu().numpy()
    with ctx.setup.part("build"):
        model = program.inference_model(config, params, dev)
        server = PredictServer(model, max_batch=p["max_batch"], max_delay_ms=p["max_delay_ms"],
                               batch_buckets=tuple(p["batch_buckets"]))
    with ctx.setup.part("warm"):
        server.warm()
    rate = p["rate_per_s"]
    n = int(np.ceil(rate * (p["warm_s"] + ctx.seconds)))
    gaps = stats.poisson_gaps(rate, n, ctx.seed)
    picks = stats.balanced_choice(p["clips"], n, ctx.seed)
    start = time.perf_counter() + 0.05
    sched = stats.schedule(start, gaps)
    lo = start + p["warm_s"]
    hi = lo + ctx.seconds
    sent, done, futures, shed = [None] * n, [None] * n, [None] * n, [False] * n
    stop = threading.Event()
    cap = p.get("max_outstanding")
    slots = threading.Semaphore(cap) if cap else None
    gen = threading.Thread(target=offer, args=(server, clips, picks, sched, sent, done,
                                               futures, stop, slots, shed),
                           name="perfbench-offer")
    holder: dict = {}
    with ctx.setup.part("warm_traffic"):
        gen.start()
        time.sleep(max(0.0, lo - time.perf_counter()))
    ctx.setup.start_window()
    # A traced run captures trace_s seconds at the window's end (from a
    # second before, for the profiler's start) and reads its counters over
    # the part before, which the profiler does not slow.
    mid = hi - p["trace_s"] - 1.0 if ctx.trace else hi
    try:
        before = snapshot(server)
        time.sleep(max(0.0, mid - time.perf_counter()))
        after = snapshot(server)
        if ctx.trace:
            with trace.capture(holder, dev):
                in_slice = snapshot(server)
                time.sleep(p["trace_s"])
            in_slice = [b - a for a, b in zip(in_slice, snapshot(server))]
        gen.join(timeout=hi - time.perf_counter() + DRAIN_S)
        deadline = time.perf_counter() + DRAIN_S
        for f in futures:
            if f is not None:
                with contextlib.suppress(Exception):
                    f.exception(timeout=max(0.0, deadline - time.perf_counter()))
    finally:
        stop.set()
        gen.join(timeout=DRAIN_S)
        server.shutdown()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    scheduled = [i for i in range(n) if lo <= sched[i] < hi]
    in_win = [i for i in scheduled if not shed[i]]
    ok = [f is not None and f.done() and f.exception() is None for f in futures]
    finished = [done[i] if ok[i] else None for i in range(n)]
    lat = stats.latencies([sched[i] for i in in_win], [finished[i] for i in in_win])
    failed = sum(1 for i in in_win if not ok[i])
    completed = stats.in_window(finished, lo, hi)
    late_med, late_max = stats.lateness([sched[i] for i in range(n) if sent[i] is not None],
                                        [s for s in sent if s is not None])
    p95 = 1e3 * stats.percentile(lat, 95)
    d_req, d_batch, d_pad = (a - b for a, b in zip(after, before))
    measured = [i for i in in_win if sched[i] < mid]
    counters = {"clips": stats.in_window(finished, lo, mid), "window_s": mid - lo,
                "requests": d_req, "batches": d_batch, "padded_slots": d_pad,
                "p95_ms": 1e3 * stats.percentile(
                    stats.latencies([sched[i] for i in measured],
                                    [finished[i] for i in measured]), 95),
                "flops_per_clip": program.flops_per_clip(ref, config)}
    if ctx.trace:
        # The batches run in the slice, one preprocess launch each.
        counters.update(slice_launches=in_slice[1], slice_frames=(in_slice[0] + in_slice[2])
                        * config["preprocess"]["num_frames"])
    del model, server
    # The comparison: every answer against the reference's logits of its clip.
    answered = [i for i in range(n) if ok[i]]
    ref_logits = ref.logits_in_blocks(clips_dev, params, config).cpu()
    got = torch.from_numpy(np.stack([futures[i].result()[1] for i in answered]))
    gap = program.logit_gap(got, ref_logits[[picks[i] for i in answered]])
    fin = [x for x in lat if x != float("inf")]
    return Outcome(
        e2e={"serve_p95_ms": p95, "serve_clips_per_s": stats.rate(completed, ctx.seconds)},
        attempted=len(in_win), failed=failed,
        checks={"logit_gap": (gap, ctx.limit("logit_gap"))},
        counters=counters, memory_peak_bytes=peak, trace=trace.read(holder),
        info={"offered_per_s": rate, "requests_in_window": len(in_win),
              "p50_ms": 1e3 * statistics.median(fin) if fin else None,
              "p99_ms": 1e3 * stats.percentile(lat, 99),
              "late_median_ms": 1e3 * late_med, "late_max_ms": 1e3 * late_max,
              "shed_in_window": len(scheduled) - len(in_win),
              "queued_at_close": sum(1 for i in range(n) if sent[i] is not None
                                     and (done[i] is None or done[i] > hi)),
              "avg_batch": d_req / d_batch if d_batch else None,
              "answers_compared": len(answered), "ref_logit_std": float(ref_logits.std())})


def control(ctx: Context, precision: str = "fp8") -> dict:
    """The compared number of the reference in ``precision`` put in the
    program's place, over the clips and weights a run of this seed makes."""
    config, p, dev = ctx.config, ctx.params, ctx.device
    ref = program.reference(config)
    params = program.params_for(config, ctx.seed, dev)
    clips = program.smooth_clips(p["clips"], config, ctx.seed, dev)
    exact = ref.logits_in_blocks(clips, params, config)
    return {"logit_gap": program.logit_gap(ref.logits_in_blocks(clips, params, config, precision),
                                           exact)}
