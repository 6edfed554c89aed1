"""The HTTP front end (``asltpu_torch.serve_http``) against the JAX
package's (``asltpu.serve_http``) on the CPU: one server of each package
per model (RGB, pose, fusion) from the same weights
(``test_torch_serve.model_pair``), the same request bodies sent to both
over real sockets. Every endpoint answers with the same status code and
error text; predictions have the same gloss and top-5 glosses with top-5
logits within 1e-3; ``/predict_windows`` gives equal segments (their
mean probabilities within the wire's rounding step of 1e-4); a
keep-alive connection stays in sync after a refused request."""

import http.client
import io
import json

import numpy as np
import pytest

from asltpu.serve_http import serve as jserve
from asltpu_torch import api as tapi
from asltpu_torch import windows as twin
from asltpu_torch.data.synthetic import synthetic_landmarks, write_video
from asltpu_torch.serve_http import serve as tserve
from test_torch_serve import (FUSION, LOGIT_ATOL, POSE, RGB, WIRE_PROB_ATOL,
                              assert_segments_equal, model_pair)

NAMES = [f"g{i}" for i in range(7)]


def _start(model, serve, **kw):
    httpd, predictor = serve(model, host="127.0.0.1", port=0, max_batch=4,
                             max_delay_ms=5, block=False, batch_buckets=(1, 4), **kw)
    return httpd, predictor


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    """{kind: (JAX port number, port port number, JAX model, port model)}
    for the RGB (with gloss names), pose and fusion models, and the
    written videos."""
    out, started = {}, []
    for kind, family, over, seed in (("rgb", "mobilenet_gru", RGB, 31),
                                     ("pose", "pose_bilstm", POSE, 32),
                                     ("fusion", "two_stream", FUSION, 33)):
        jm, tm = model_pair(family, over, seed=seed)
        names = NAMES if kind == "rgb" else None
        pair = [_start(jm, jserve, gloss_names=names), _start(tm, tserve, gloss_names=names)]
        started += pair
        out[kind] = (pair[0][0].server_address[1], pair[1][0].server_address[1], jm, tm)
    d = tmp_path_factory.mktemp("http")
    videos = {}
    for name, frames, size, seed in (("clip", 12, (72, 96), 3), ("session", 40, (72, 96), 7),
                                     ("fusion", 20, (48, 64), 8)):
        videos[name] = str(d / f"{name}.mp4")
        write_video(videos[name], num_frames=frames, size=size, seed=seed)
    yield out, videos
    for httpd, predictor in started:
        httpd.shutdown()
        httpd.server_close()
        predictor.shutdown()
        assert not predictor._thread.is_alive()


def _request(port, method, path, body=None, conn=None):
    """(status, JSON body) of one request (on ``conn`` when given, so a
    keep-alive connection can be reused)."""
    own = conn is None
    conn = conn or http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request(method, path, body=body)
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        if own:
            conn.close()


def _both(servers, kind, method, path, body=None):
    jport, tport = servers[kind][:2]
    return _request(jport, method, path, body), _request(tport, method, path, body)


def _npy(a) -> bytes:
    buf = io.BytesIO()
    np.save(buf, np.asarray(a))
    return buf.getvalue()


def _read(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _assert_same_prediction(got, want):
    assert got[0] == want[0] == 200
    got, want = got[1], want[1]
    assert got["gloss"] == want["gloss"]
    assert [e["gloss"] for e in got["top5"]] == [e["gloss"] for e in want["top5"]]
    np.testing.assert_allclose([e["logit"] for e in got["top5"]],
                               [e["logit"] for e in want["top5"]], rtol=0, atol=LOGIT_ATOL)


@pytest.mark.parametrize("path", ["/healthz", "/stats", "/nope"])
def test_get_endpoints_answer_as_jax(servers, path):
    servers, _ = servers
    want, got = _both(servers, "rgb", "GET", path)
    assert got[0] == want[0]
    if path == "/stats":
        assert set(want[1]) == {
            "requests", "batches", "avg_batch_size", "avg_latency_ms", "padded_slots"}
        # The port's batcher also reports its means of queue wait, assembly and copy.
        assert set(got[1]) == set(want[1]) | {
            "avg_queue_wait_ms", "avg_assemble_ms", "avg_copy_ms"}
    else:
        assert got == want


def test_predict_matches_jax_and_the_library(servers):
    servers, videos = servers
    want, got = _both(servers, "rgb", "POST", "/predict", _read(videos["clip"]))
    _assert_same_prediction(got, want)
    tm = servers["rgb"][3]
    gloss, logits = tapi.predict(tm, tapi.load_clip(videos["clip"], tm.cfg.preprocess),
                                 gloss_names=NAMES)
    assert got[1]["gloss"] == gloss
    np.testing.assert_allclose([e["logit"] for e in got[1]["top5"]],
                               np.sort(logits)[::-1][:5], rtol=0, atol=1e-4)


# (server, path, body) of refused requests; "{clip}" and "{lm}" stand for
# the video's and a landmark array's bytes.
REFUSALS = {
    "empty_body": ("rgb", "/predict", b""),
    "not_a_video": ("rgb", "/predict", b"not a video at all"),
    "rgb_gets_landmarks": ("rgb", "/predict_landmarks", "{lm}"),
    "rgb_gets_fusion": ("rgb", "/predict_fusion", "{clip}"),
    "rgb_gets_landmark_windows": ("rgb", "/predict_windows_landmarks?window_s=1", "{lm}"),
    "windows_without_window": ("rgb", "/predict_windows", "{clip}"),
    "windows_bad_window": ("rgb", "/predict_windows?window_s=nope", "{clip}"),
    "windows_zero_stride": ("rgb", "/predict_windows?window_s=1.0&stride_s=0", "{clip}"),
    "unknown_post": ("rgb", "/nope", b"x"),
    "pose_gets_video": ("pose", "/predict", "{clip}"),
    "pose_gets_video_windows": ("pose", "/predict_windows?window_s=1", "{clip}"),
    "pose_bad_landmarks": ("pose", "/predict_landmarks", "{bad_lm}"),
    "pose_zero_fps": ("pose", "/predict_windows_landmarks?window_s=1&fps=0", "{lm}"),
    "pose_window_bad_landmarks": ("pose", "/predict_windows_landmarks?window_s=1", "{bad_lm}"),
    "fusion_gets_video": ("fusion", "/predict", "{clip}"),
    "fusion_gets_landmarks": ("fusion", "/predict_landmarks", "{lm}"),
    "fusion_short_body": ("fusion", "/predict_fusion", b"\x00" * 8),
    "fusion_bad_prefix": ("fusion", "/predict_fusion", (10 ** 6).to_bytes(8, "big") + b"xy"),
    "fusion_zero_prefix": ("fusion", "/predict_fusion", bytes(8) + b"xy"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_refusals_answer_as_jax(servers, case):
    """400 for a request the server refuses, 404 for an unknown path, 500
    for a body that does not decode (its text names the temporary file,
    so only the error's type is compared there)."""
    servers, videos = servers
    kind, path, body = REFUSALS[case]
    if isinstance(body, str):
        body = {"{clip}": _read(videos["clip"]),
                "{lm}": _npy(synthetic_landmarks(1, 6, seed=40)[0]),
                "{bad_lm}": _npy(np.zeros((6, 21, 3), np.float32))}[body]
    want, got = _both(servers, kind, "POST", path, body)
    assert got[0] == want[0] and got[0] in (400, 404, 500)
    if got[0] == 500:
        assert got[1]["error"].split(":")[0] == want[1]["error"].split(":")[0]
    else:
        assert got[1] == want[1]


def test_predict_windows_matches_jax_and_the_library(servers):
    servers, videos = servers
    path = "/predict_windows?window_s=0.64&min_prob=0.3"
    want, got = _both(servers, "rgb", "POST", path, _read(videos["session"]))
    assert got[0] == want[0] == 200
    got, want = got[1], want[1]
    assert got["num_windows"] == want["num_windows"] == 4
    assert_segments_equal(got["segments"], want["segments"])
    assert [w["gloss"] for w in got["windows"]] == [w["gloss"] for w in want["windows"]]
    for key in ("start_s", "end_s"):
        assert [w[key] for w in got["windows"]] == [w[key] for w in want["windows"]]
    np.testing.assert_allclose([w["prob"] for w in got["windows"]],
                               [w["prob"] for w in want["windows"]], rtol=0,
                               atol=WIRE_PROB_ATOL)
    # The served windows are the library's (40 frames at 25 fps: 16-frame
    # windows, a half-window stride).
    wins = twin.predict_windows(servers["rgb"][3], videos["session"], window_frames=16,
                                stride_frames=8, batch_size=4, gloss_names=NAMES,
                                decode_backend="thread")
    assert [w["gloss"] for w in got["windows"]] == [w.gloss for w in wins]
    np.testing.assert_allclose([w["prob"] for w in got["windows"]], [w.prob for w in wins],
                               rtol=0, atol=WIRE_PROB_ATOL)


def test_keep_alive_stays_in_sync_after_a_refusal(servers):
    """On one connection: a refused request whose body the handler never
    reads, an unknown path with a body, then a prediction — the same
    answers from both servers, the prediction equal to one on a fresh
    connection."""
    servers, videos = servers
    clip = _read(videos["clip"])
    answers = []
    for port in servers["rgb"][:2]:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
        try:
            seq = [_request(port, "POST", "/predict_landmarks", clip, conn),
                   _request(port, "POST", "/nope", clip, conn),
                   _request(port, "POST", "/predict", clip, conn),
                   _request(port, "GET", "/healthz", None, conn)]
        finally:
            conn.close()
        assert [code for code, _ in seq] == [400, 404, 200, 200]
        assert seq[2] == _request(port, "POST", "/predict", clip)
        answers.append(seq)
    want, got = answers
    assert [g for i, g in enumerate(got) if i != 2] == [w for i, w in enumerate(want) if i != 2]
    _assert_same_prediction(got[2], want[2])


def test_pose_endpoints_match_jax(servers):
    """/predict_landmarks with a T other than the model's (resampled to
    it) and /predict_windows_landmarks with its own fps."""
    servers, _ = servers
    lm = synthetic_landmarks(1, 9, seed=41)[0]
    want, got = _both(servers, "pose", "POST", "/predict_landmarks", _npy(lm))
    _assert_same_prediction(got, want)
    stream = synthetic_landmarks(1, 30, seed=42)[0]
    path = "/predict_windows_landmarks?window_s=0.5&stride_s=0.2&fps=20"
    want, got = _both(servers, "pose", "POST", path, _npy(stream))
    assert got[0] == want[0] == 200
    assert got[1]["num_windows"] == want[1]["num_windows"] == 6
    assert_segments_equal(got[1]["segments"], want[1]["segments"])
    np.testing.assert_allclose([w["prob"] for w in got[1]["windows"]],
                               [w["prob"] for w in want[1]["windows"]], rtol=0,
                               atol=WIRE_PROB_ATOL)


def test_fusion_endpoint_matches_jax(servers):
    servers, videos = servers
    video = _read(videos["fusion"])
    lm = synthetic_landmarks(1, 12, seed=43)[0]  # resampled to the clip's 8 frames
    body = len(video).to_bytes(8, "big") + video + _npy(lm)
    want, got = _both(servers, "fusion", "POST", "/predict_fusion", body)
    _assert_same_prediction(got, want)


def test_stats_count_the_served_requests(servers):
    servers, videos = servers
    tport = servers["rgb"][1]
    before = _request(tport, "GET", "/stats")[1]
    _request(tport, "POST", "/predict", _read(videos["clip"]))
    after = _request(tport, "GET", "/stats")[1]
    assert after["requests"] == before["requests"] + 1
    assert after["batches"] == before["batches"] + 1
    assert after["avg_batch_size"] >= 1.0 and after["avg_latency_ms"] > 0


def test_logging_writes_what_the_jax_package_writes(tmp_path):
    """The handler logs through ``get_logger`` (one stderr handler, set up
    once, not propagated); ``MetricsWriter`` writes the JAX package's CSV
    files, one per metric schema, with the same rows (wall time apart)."""
    import csv
    import os

    from asltpu.utils import logging as jlog
    from asltpu_torch.utils import logging as tlog

    log = tlog.get_logger("asltpu_torch.test")
    assert tlog.get_logger("asltpu_torch.test") is log
    assert len(log.handlers) == 1 and not log.propagate and log.level == 20
    rows = [(1, {"loss": 2.5, "lr": 0.1}), (2, {"eval_top1": 0.5, "eval_top5": 1.0}),
            (3, {"loss": 1.5, "lr": 0.05}), (4, {"grad_norm": 3.0})]
    out = {}
    for name, mod in (("jax", jlog), ("port", tlog)):
        d = tmp_path / name
        writer = mod.MetricsWriter(str(d), name="train")
        for step, metrics in rows:
            writer(step, metrics)
        out[name] = {}
        for f in sorted(os.listdir(d)):
            with open(d / f, newline="") as fh:
                out[name][f] = [{k: v for k, v in r.items() if k != "wall_time"}
                                for r in csv.DictReader(fh)]
    assert out["port"] == out["jax"] and len(out["port"]) == 3
