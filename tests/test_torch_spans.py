"""The program's spans (``asltpu_torch.utils.profiling``): recorded only while
a ``torch.profiler`` capture is open, from every thread; each served request
has one ``serve.queue`` span tied to the batch that answered it, and the
batch's spans account for submit → reply; ``stream_predict`` and the train
step mark their layers once a batch or a step; a span converted to the
capture's clock lands on its ``record_function`` twin; ``trace()`` writes
the spans into its capture; ``ServerStats`` keeps the batcher's sums with
no capture open."""

import collections
import json
import os
import tempfile
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from asltpu_torch import api as tapi
from asltpu_torch.config import TrainConfig
from asltpu_torch.data import decode as tdecode
from asltpu_torch.data.synthetic import write_video
from asltpu_torch.serve import PredictServer
from asltpu_torch.train.loop import create_train_state, make_train_step
from asltpu_torch.utils import profiling

TINY = dict(num_classes=5, gru_hidden=16, width_mult=0.35, compute_dtype="float32",
            preprocess={"num_frames": 2, "staging_size": (40, 40), "resize_short": 40,
                        "crop": 32, "out_dtype": "float32"})
TRAIN_STEP = ("train.preprocess", "train.forward", "train.backward", "train.optimizer")


@pytest.fixture(autouse=True)
def empty_recorder():
    profiling.RECORDER.clear()
    yield
    profiling.RECORDER.clear()


@pytest.fixture(scope="module")
def model():
    return tapi.load_model("mobilenet_gru", device="cpu", **TINY)


@pytest.fixture(scope="module")
def videos(tmp_path_factory):
    root = tmp_path_factory.mktemp("span_videos")
    paths = [str(root / f"c{i}.mp4") for i in range(5)]
    for i, p in enumerate(paths):
        write_video(p, num_frames=8, size=(48, 64), seed=i)
    return paths


def _frames(cfg, n, seed=0):
    pp = cfg.preprocess
    return np.random.default_rng(seed).integers(
        0, 256, (n, pp.num_frames, *pp.staging_size, 3), dtype=np.uint8)


def _train(n_steps):
    m = tapi.build_trainable("mobilenet_gru", device="cpu", **TINY)
    cfg = TrainConfig(batch_size=2, num_steps=10, warmup_steps=1)
    state = create_train_state(m.module, cfg)
    step = make_train_step(cfg, m.cfg.preprocess)
    x, y = torch.from_numpy(_frames(m.cfg, 2)), torch.tensor([0, 3])
    for _ in range(n_steps):
        state, _ = step(state, x, y)


def _chrome(prof):
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)
    finally:
        os.unlink(path)


def test_recording_follows_an_open_capture_on_every_thread():
    seen = {}

    def probe(key):
        seen[key] = profiling.recording()

    assert hasattr(torch.autograd.profiler, "_is_profiler_enabled")
    probe("before")
    with profile(activities=[ProfilerActivity.CPU]):
        probe("inside")
        t = threading.Thread(target=probe, args=("other thread",))
        t.start()
        t.join(timeout=10)
        assert not t.is_alive()
    probe("after")
    assert seen == {"before": False, "inside": True, "other thread": True, "after": False}


def test_nothing_is_recorded_without_a_capture(model, videos):
    server = PredictServer(model, max_batch=4, max_delay_ms=5, batch_buckets=(1, 4))
    try:
        for f in [server.submit(x) for x in _frames(model.cfg, 5)]:
            f.result(timeout=60)
    finally:
        server.shutdown()
    list(tapi.stream_predict(model, videos, batch_size=2, num_decode_workers=2,
                             decode_backend="thread"))
    _train(1)
    assert profiling.recorded_spans() == [] and profiling.RECORDER.dropped == 0
    st = server.stats
    assert st.requests == 5 and st.batches >= 2
    assert st.avg_queue_wait_ms > 0 and st.avg_assemble_ms > 0 and st.avg_copy_ms > 0


def test_every_answered_request_has_one_queue_span_tied_to_its_batch(model):
    server = PredictServer(model, max_batch=4, max_delay_ms=5, batch_buckets=(1, 4))
    submitted, answered = {}, {}
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            futures = []
            for i, x in enumerate(_frames(model.cfg, 7, seed=1)):
                before = time.time_ns()
                fut = server.submit(x)
                submitted[i] = (before, time.time_ns())
                fut.add_done_callback(lambda _, i=i: answered.__setitem__(i, time.time_ns()))
                futures.append(fut)
                time.sleep(0.002 * (i % 3))
            for f in futures:
                f.result(timeout=60)
    finally:
        server.shutdown()
    spans = profiling.recorded_spans()
    by_id = {s.id: s for s in spans}
    queue = {s.ids["request"]: s for s in spans if s.name == "serve.queue"}
    assert sorted(queue) == list(range(7))
    assert sum(s.name == "serve.queue" for s in spans) == 7
    for i, q in queue.items():
        batch = by_id[q.parent]
        assert batch.name == "serve.batch" and batch.ids["batch"] == q.ids["batch"]
        kids = sorted((s for s in spans if s.parent == batch.id and s.name != "serve.queue"),
                      key=lambda s: s.start_ns)
        assert [s.name for s in kids] == ["serve.collect", "serve.assemble", "serve.copy",
                                          "serve.predict", "serve.reply"]
        # submit → queue → collect … reply, contiguous: the queue span starts
        # inside the submit call, and the answer comes inside the reply span
        assert submitted[i][0] <= q.start_ns <= submitted[i][1]
        assert kids[0].start_ns <= q.end_ns <= kids[0].end_ns
        assert all(a.end_ns == b.start_ns for a, b in zip(kids, kids[1:]))
        assert kids[-1].start_ns <= answered[i] <= kids[-1].end_ns
        assert batch.start_ns == kids[0].start_ns and batch.end_ns == kids[-1].end_ns


def test_stream_predict_marks_each_batch(model, videos):
    frames, t0, t1, pid, tid = tdecode._timed_decode(videos[0], model.cfg.preprocess)
    assert frames.shape == (2, *model.cfg.preprocess.staged_frame_shape)
    assert t0 <= t1 and pid == os.getpid() and tid == threading.get_native_id()
    with profile(activities=[ProfilerActivity.CPU]):
        out = list(tapi.stream_predict(model, videos, batch_size=2, num_decode_workers=2,
                                       decode_backend="thread"))
    assert len(out) == 5
    per_batch = collections.defaultdict(collections.Counter)
    for s in profiling.recorded_spans():
        per_batch[s.ids["batch"]][s.name] += 1
    assert sorted(per_batch) == [0, 1, 2, 3]  # the consumer's last wait is for the end
    for b in range(3):
        clips = 1 if b == 2 else 2
        assert per_batch[b] == {"decode.clip": clips, "decode.wait": 1, "decode.stack": 1,
                                "prefetch.pin": 1, "prefetch.put_wait": 1, "stream.wait": 1,
                                "stream.predict": 1}
    assert per_batch[3] == {"stream.wait": 1}


def test_train_step_spans_in_order_and_on_their_twins():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _train(2)
    doc = _chrome(prof)
    twins = sorted((e for e in doc["traceEvents"] if e.get("cat") == "user_annotation"
                    and e.get("name", "").startswith("train.")), key=lambda e: e["ts"])
    assert [e["name"] for e in twins] == list(TRAIN_STEP) * 2
    spans = sorted(profiling.recorded_spans(), key=lambda s: s.start_ns)
    assert [s.name for s in spans] == list(TRAIN_STEP) * 2
    base = profiling.trace_base_ns()
    assert base == int(doc["baseTimeNanoseconds"])
    # A span is stamped inside its twin: converted, it lies within the twin
    # widened by 1 ms (a pause of the thread can only move it inwards).
    for s, e in zip(spans, twins):
        lo, hi = e["ts"] - 1e3, e["ts"] + e["dur"] + 1e3
        assert lo <= profiling.to_capture_us(s.start_ns, base) \
            <= profiling.to_capture_us(s.end_ns, base) <= hi


def test_trace_writes_every_threads_spans_into_its_capture(tmp_path):
    tids = []

    def work():
        tids.append(threading.get_native_id())
        with profiling.span("worker.part", batch=3):
            time.sleep(0.002)

    with profiling.trace(str(tmp_path)):
        t = threading.Thread(target=work)
        t.start()
        t.join(timeout=10)
        assert not t.is_alive()
    (path,) = [os.path.join(tmp_path, f) for f in os.listdir(tmp_path)]
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    (ev,) = [e for e in events if e.get("cat") == profiling.SPAN_CAT]
    assert ev["name"] == "worker.part" and ev["tid"] == tids[0] and ev["args"]["batch"] == 3
    assert ev["pid"] == os.getpid() and 1e3 <= ev["dur"] < 1e6


def test_the_recorder_keeps_its_newest_records_and_counts_the_drops():
    rec = profiling.SpanRecorder(cap=3)
    for i in range(5):
        rec.add(profiling.Span(f"s{i}", 1, 1, i, i + 1, i, None, {}))
    assert [s.name for s in rec.spans()] == ["s2", "s3", "s4"] and rec.dropped == 2
    rec.clear()
    assert rec.spans() == [] and rec.dropped == 0
