"""Offline recognition of video files: ``asltpu_torch.api.stream_predict``
over a list of mp4 paths that cycles through a seeded corpus, with the
stream's own defaults for the decode backend and workers.

Set-up writes the corpus (spawned writers, beside the weights' making),
warms the predict at the stream's batch and runs the stream's first
batches. The
window then runs from the end of a batch to the end of the first batch
that completes ``--seconds`` later: ``mp4_clips_per_s`` is the clips
whose logits reached the host in it over its length.

Once it has closed, every answer the stream gave is compared with the
reference's logits for its file (cv2 decode and staging, float32
network)."""

from __future__ import annotations

import contextlib
import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
from torch.profiler import record_function

from perfbench.core import program, stats, trace, video
from perfbench.core.harness import Context, Outcome
from perfbench.reference import decode as ref_decode


def reference_clips(paths, config, threads: int = 8) -> np.ndarray:
    pp = config["preprocess"]
    with ThreadPoolExecutor(threads) as ex:
        return np.stack(list(ex.map(
            lambda p: ref_decode.load_clip(p, pp["num_frames"], tuple(pp["staging_size"])),
            paths)))


def decode_rate(config: dict, paths, batch: int, clips: int) -> float:
    """Decode-only clips/s of a pool made as ``stream_predict`` makes its
    default one, started and warmed before the clock."""
    from asltpu_torch.data.decode import make_decode_pool
    from asltpu_torch.config import PreprocessConfig

    pp = config["preprocess"]
    cfg = PreprocessConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in pp.items()})
    pool = make_decode_pool(cfg)
    try:
        for _ in pool.map_batches(paths[:2 * batch], batch):
            pass
        items = [paths[i % len(paths)] for i in range(clips)]
        t0 = time.perf_counter()
        n = sum(len(kept) for _, kept in pool.map_batches(items, batch))
        return n / (time.perf_counter() - t0)
    finally:
        pool.shutdown()


def run(ctx: Context) -> Outcome:
    from asltpu_torch import api

    p, config, dev = ctx.params, ctx.config, ctx.device
    pp, batch = config["preprocess"], p["batch"]
    ref = program.reference(config)
    with ctx.setup.part("corpus_start"):
        writers, paths, futures = video.start_corpus(
            os.path.join(ctx.tmp, "corpus"), p["corpus_clips"], tuple(p["source_hw"]),
            p["source_frames"], p["writers"])
    with ctx.setup.part("weights"):
        params = program.params_for(config, ctx.seed, dev)
    with ctx.setup.part("corpus"):
        try:
            for f in futures:
                f.result()
        finally:
            writers.shutdown()
    with ctx.setup.part("build"):
        model = program.inference_model(config, params, dev)
    with ctx.setup.part("warm"):
        fn = model.predict_fn()
        zeros = torch.zeros((batch, pp["num_frames"], *pp["staging_size"], 3),
                            dtype=torch.uint8, device=dev)
        fn(zeros).cpu()
    order = stats.balanced_choice(len(paths), len(paths) * p["passes"], ctx.seed)
    items = [paths[i] for i in order]
    stream = api.stream_predict(model, items, batch_size=batch)
    answers = []  # (path, logits)
    done = []  # host time at which each batch's logits were all out
    t_window = t_end = None
    holder: dict = {}
    with contextlib.ExitStack() as stack:
        with ctx.setup.part("pool_and_fill"):
            for path, _, logits in stream:
                answers.append((path, logits))
                if len(answers) % batch == 0:
                    done.append(time.perf_counter())
                    if len(done) == p["fill_batches"]:
                        break
        if ctx.trace:
            stack.enter_context(trace.capture(holder, dev))
        t_window = ctx.setup.start_window()
        n_fill = len(answers)
        while True:
            with record_function("stream_predict.next"):
                item = next(stream, None)
            if item is None:
                break
            path, _, logits = item
            answers.append((path, logits))
            if len(answers) % batch == 0:
                now = time.perf_counter()
                done.append(now)
                if now >= t_window + ctx.seconds:
                    t_end = now
                    break
    if t_end is None:
        raise RuntimeError("the stream ran out before the window closed: raise 'passes'")
    stream.close()
    clips = len(answers) - n_fill
    window_s = t_end - t_window
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    # The window is the traced slice: one preprocess launch a batch.
    counters = {"clips": clips, "window_s": window_s, "slice_launches": clips // batch,
                "slice_frames": clips * pp["num_frames"],
                "flops_per_clip": program.flops_per_clip(ref, config)}
    if ctx.trace:
        counters["decode_clips_per_s"] = decode_rate(config, paths, batch, p["decode_clips"])
    del model, fn, stream
    # The comparison: every answer against the reference's logits of its file.
    index = {path: i for i, path in enumerate(paths)}
    ref_logits = ref.logits_in_blocks(torch.from_numpy(reference_clips(paths, config)).to(dev),
                                      params, config)
    got = torch.from_numpy(np.stack([lg for _, lg in answers]))
    want = ref_logits.cpu()[[index[path] for path, _ in answers]]
    gap = program.logit_gap(got, want)
    gaps = [float(x) for x in (ref_logits.cpu()[:, None] - ref_logits.cpu()[None]).abs()
            .amax(-1).flatten()]
    return Outcome(
        e2e={"mp4_clips_per_s": stats.rate(clips, window_s)},
        attempted=clips, failed=0,
        checks={"logit_gap": (gap, ctx.limit("logit_gap"))},
        counters=counters, memory_peak_bytes=peak, trace=trace.read(holder),
        info={"window_s": window_s, "fill_clips": n_fill, "answers": len(answers),
              "batches_in_window": clips // batch,
              "ref_logit_std": float(ref_logits.std()),
              "closest_two_files": min(g for g in gaps if g > 0) / float(ref_logits.std())})



def control(ctx: Context, precision: str = "fp8") -> dict:
    """The compared number of the reference in ``precision`` put in the
    program's place, over the corpus and weights a run of this seed makes."""
    config, p, dev = ctx.config, ctx.params, ctx.device
    ref = program.reference(config)
    params = program.params_for(config, ctx.seed, dev)
    writers, paths, futures = video.start_corpus(
        os.path.join(ctx.tmp, "corpus"), p["corpus_clips"], tuple(p["source_hw"]),
        p["source_frames"], p["writers"])
    try:
        for f in futures:
            f.result()
    finally:
        writers.shutdown()
    clips = torch.from_numpy(reference_clips(paths, config)).to(dev)
    exact = ref.logits_in_blocks(clips, params, config)
    return {"logit_gap": program.logit_gap(ref.logits_in_blocks(clips, params, config, precision),
                                           exact)}
