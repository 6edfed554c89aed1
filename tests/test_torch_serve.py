"""The dynamic-batching server (``asltpu_torch.serve.PredictServer``)
against the JAX package's (``asltpu.serve.PredictServer``) on the CPU: the
same staged requests give the same ids and logits (fp32, 1e-3) through both
servers with ``max_batch`` 4 and ``batch_buckets=(1, 4)``, from concurrent
submitters too, for the RGB, pose and fusion models; the same
``ValueError`` texts for bad requests, the same bucket padding for a
sequential pattern, and ``RuntimeError`` after shutdown with no future
left pending; the port's batches are filled in place into buffers kept
per bucket, each padding row the last real row. The JAX variables are drawn from ``jax.eval_shape``
(``draw_train_variables``: random kernels, recurrent weights and
BatchNorm statistics) and carried into the port through
``state_dict_from_jax``."""

import os
import sys
import tempfile
import threading
import time

import jax
import numpy as np
import pytest
import torch

from asltpu import api as japi
from asltpu import ckpt as jckpt
from asltpu import config as jconfig
from asltpu.serve import PredictServer as JServer
from asltpu_torch import api as tapi
from asltpu_torch.ckpt import state_dict_from_jax
from asltpu_torch.data.synthetic import synthetic_landmarks
from asltpu_torch.ops import preprocess_kernels
from asltpu_torch.ops.preprocess import preprocess_clip
from asltpu_torch.serve import PredictServer as TServer
from test_torch_train_video import draw_train_variables

LOGIT_ATOL = 1e-3  # fp32 end to end (tests/test_torch_api.py)
# Small fp32 configs of the three input kinds: staged RGB with a resize and
# a crop (preprocessed to fp32: a bf16 rounding an ulp apart in the two
# packages would be amplified by the calibrated BatchNorms), landmarks, and
# both (the clip's num_frames overridden to 8, as
# tests/unit/test_serve.py's fusion case).
RGB = dict(num_classes=7, gru_hidden=32, width_mult=0.35, compute_dtype="float32",
           preprocess={"num_frames": 3, "staging_size": (64, 80), "resize_short": 56,
                       "crop": 48, "out_dtype": "float32"})
POSE = dict(num_classes=7, hidden_size=16, num_layers=2, num_frames=5)
FUSION = dict(num_classes=7, width_mult=0.35, compute_dtype="float32", d_model=32,
              num_heads=2, num_fusion_layers=1,
              preprocess={"num_frames": 8, "staging_size": (40, 48), "resize_short": 36,
                          "crop": 32})
SERVER = dict(max_batch=4, batch_buckets=(1, 4))
# The wire (segments_json, the server's windows) rounds probabilities to
# 1e-4: two values within 1e-6 of each other round at most one step apart.
WIRE_PROB_ATOL = 1e-4 + 1e-12


def _init_inputs(cfg):
    """Zero inputs of one clip in the JAX module's own form (preprocessed
    frames and/or landmarks), for ``jax.eval_shape``."""
    lm = np.zeros((1, getattr(cfg, "num_frames", 0), 543, 3), np.float32)
    if isinstance(cfg, jconfig.PoseBiLSTMConfig):
        return (lm,)
    pp = cfg.preprocess
    clip = np.zeros((1, pp.num_frames, pp.crop, pp.crop, 3), np.float32)
    return (clip, lm) if isinstance(cfg, jconfig.TwoStreamFusionConfig) else (clip,)


def model_pair(family, overrides, seed=0):
    """(JAX Model, port Model on the CPU) of ``family`` with the same fp32
    weights (``draw_train_variables``: BatchNorm statistics and recurrent
    weights random too); ``mobilenet_gru``'s BatchNorm statistics are then
    calibrated on a seeded batch (``calibrate``)."""
    jcfg = jconfig.get_config(family, **overrides)
    module = japi.build_module(jcfg)
    v = draw_train_variables(module, *_init_inputs(jcfg), seed=seed)
    tm = tapi.load_model(family, device="cpu", **overrides)
    tm.module.load_state_dict(state_dict_from_jax(tm.cfg, v))
    if family == "mobilenet_gru":
        v = calibrate(tm, v, jcfg, seed)
    return japi.Model(cfg=jcfg, module=module, variables=v), tm


def calibrate(tm, v, jcfg, seed):
    """Set every BatchNorm's statistics of the port model ``tm`` to those
    of a seeded batch (a train-mode pass through the backbone with
    momentum 1) and carry them into the JAX variables ``v`` through the
    JAX package's torch import. With drawn statistics the differences
    between clips fade layer by layer, and the logits of distinct clips
    come out nearly equal."""
    bns = [m for m in tm.module.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    for m in bns:
        m.momentum = 1.0
    clip = preprocess_clip(torch.from_numpy(staged_frames(tm.cfg, 8, seed + 100)),
                           tm.cfg.preprocess)
    with torch.no_grad():
        tm.module.backbone(clip, train=True)
    for m in bns:
        m.momentum = 0.1
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "calibrated.pt")
        torch.save(tm.module.state_dict(), path)
        return jax.device_get(jckpt.load_torch_checkpoint(path, v, jcfg))


def assert_segments_equal(got, want):
    """``segments_json`` lists equal, each ``mean_prob`` within one rounding
    step of the wire."""
    strip = [{k: v for k, v in s.items() if k != "mean_prob"} for s in want]
    assert [{k: v for k, v in s.items() if k != "mean_prob"} for s in got] == strip
    np.testing.assert_allclose([s["mean_prob"] for s in got], [s["mean_prob"] for s in want],
                               rtol=0, atol=WIRE_PROB_ATOL)


def staged_frames(cfg, n, seed):
    """``n`` seeded staged RGB uint8 clips [n, T, Hs, Ws, 3] for ``cfg``:
    smooth moving patterns with a phase, frequency, direction, brightness
    and contrast of their own (i.i.d. noise would pool to nearly the same
    features for every clip)."""
    pp = cfg.preprocess
    h, w = pp.staging_size
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    t = np.arange(pp.num_frames, dtype=np.float32)[:, None, None, None]
    out = np.empty((n, pp.num_frames, h, w, 3), np.uint8)
    for i in range(n):
        theta = rng.uniform(0, np.pi)
        ramp = (np.cos(theta) * xx + np.sin(theta) * yy)[None, :, :, None]
        img = rng.uniform(70, 185) + rng.uniform(30, 70) * np.sin(
            rng.uniform(0.05, 0.3, 3) * ramp + rng.uniform(0, 2 * np.pi, 3) + 0.3 * t)
        out[i] = np.clip(img, 0, 255)
    return out


@pytest.fixture(scope="module")
def rgb():
    """The RGB pair and a warmed server of each package over it."""
    jm, tm = model_pair("mobilenet_gru", RGB, seed=1)
    js, ts = JServer(jm, max_delay_ms=5, **SERVER), TServer(tm, max_delay_ms=5, **SERVER)
    js.warm()
    ts.warm()
    yield jm, tm, js, ts
    js.shutdown()
    ts.shutdown()


def _results(server, requests):
    """Submit every request (a tuple of submit's arguments) before reading
    any result; returns the (gloss, logits) pairs in order."""
    futs = [server.submit(*args) for args in requests]
    return [f.result(timeout=120) for f in futs]


def _assert_same(got, want):
    assert [g for g, _ in got] == [w for w, _ in want]
    for (_, g), (_, w) in zip(got, want):
        assert g.shape == w.shape and g.dtype == np.float32
        np.testing.assert_allclose(g, w, rtol=0, atol=LOGIT_ATOL)


def test_server_matches_jax_server(rgb):
    jm, tm, js, ts = rgb
    frames = staged_frames(tm.cfg, 6, seed=2)
    before = (ts.stats.requests, preprocess_kernels.preprocess_rgb.launches)
    want = _results(js, [(f,) for f in frames])
    got = _results(ts, [(f,) for f in frames])
    _assert_same(got, want)
    assert all(isinstance(g, int) for g, _ in got)  # json-serialisable ids
    # The logits vary from clip to clip well beyond the bound, so a result
    # delivered to the wrong request fails.
    logits = np.stack([lg for _, lg in want])
    assert np.abs(logits - logits.mean(0)).max() > 10 * LOGIT_ATOL
    _, one = tapi.predict(tm, frames)
    np.testing.assert_allclose(np.stack([lg for _, lg in got]), one, rtol=0, atol=1e-5)
    assert ts.stats.requests == before[0] + 6
    # CPU tensors take the plain preprocess: no kernel launched.
    assert preprocess_kernels.preprocess_rgb.launches == before[1]


def test_concurrent_submitters_match_jax(rgb):
    """More submitting threads than cores, each with several requests, the
    interpreter switching threads every microsecond: every request gets
    its own logits, and none is lost or counted twice."""
    jm, tm, js, ts = rgb
    frames = staged_frames(tm.cfg, 48, seed=3)
    want = _results(js, [(f,) for f in frames])
    server = TServer(tm, max_delay_ms=20, **SERVER)
    got, errors = {}, []

    def client(i):
        try:
            for k in range(i, len(frames), 16):
                got[k] = server.submit(frames[k]).result(timeout=120)
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=client, args=(i,)) for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(switch)
        server.shutdown()
    assert not errors and sorted(got) == list(range(len(frames)))
    _assert_same([got[k] for k in range(len(frames))], want)
    assert server.stats.requests == len(frames)
    assert server.stats.avg_batch_size > 1.0


def test_pose_server_matches_jax():
    jm, tm = model_pair("pose_bilstm", POSE, seed=4)
    lm = synthetic_landmarks(5, 5, seed=5)
    lm[0, 1] = 0.0  # nothing detected in one frame
    js, ts = JServer(jm, **SERVER), TServer(tm, **SERVER)
    try:
        ts.warm()  # the pose model runs on the landmarks alone
        _assert_same(_results(ts, [(None, x) for x in lm]),
                     _results(js, [(None, x) for x in lm]))
    finally:
        js.shutdown()
        ts.shutdown()


def test_fusion_server_with_overridden_num_frames():
    """The fusion model built with only a preprocess num_frames override:
    the clip's T (8) is the landmark T that submit accepts, in both
    packages; T = 16 landmarks are refused with the same text."""
    jm, tm = model_pair("two_stream", FUSION, seed=6)
    assert tm.cfg.num_frames == jm.cfg.num_frames == 8
    frames = staged_frames(tm.cfg, 2, seed=7)
    lm = synthetic_landmarks(2, 8, seed=8)
    js, ts = JServer(jm, **SERVER), TServer(tm, **SERVER)
    try:
        _assert_same(_results(ts, list(zip(frames, lm))), _results(js, list(zip(frames, lm))))
        bad = synthetic_landmarks(1, 16, seed=9)[0]
        with pytest.raises(ValueError, match="landmarks shape") as want:
            js.submit(frames[0], bad)
        with pytest.raises(ValueError, match="landmarks shape") as got:
            ts.submit(frames[0], bad)
        assert str(got.value) == str(want.value)
    finally:
        js.shutdown()
        ts.shutdown()


BAD_REQUESTS = {
    "no_frames": lambda f, lm: (None, lm),
    "narrow_frames": lambda f, lm: (f[:, :32],),
    "batch_axis": lambda f, lm: (f[None],),
    "one_frame_short": lambda f, lm: (f[1:],),
}


@pytest.mark.parametrize("case", sorted(BAD_REQUESTS))
def test_bad_requests_raise_the_same_value_error(rgb, case):
    jm, tm, js, ts = rgb
    args = BAD_REQUESTS[case](staged_frames(tm.cfg, 1, seed=10)[0],
                              synthetic_landmarks(1, 3, seed=11)[0])
    with pytest.raises(ValueError) as want:
        js.submit(*args)
    with pytest.raises(ValueError) as got:
        ts.submit(*args)
    assert str(got.value) == str(want.value)


def test_pose_server_refuses_what_the_jax_one_refuses():
    jm, tm = model_pair("pose_bilstm", POSE, seed=12)
    js, ts = JServer(jm, **SERVER), TServer(tm, **SERVER)
    try:
        for args in ((None, None), (None, synthetic_landmarks(1, 7, seed=13)[0])):
            with pytest.raises(ValueError) as want:
                js.submit(*args)
            with pytest.raises(ValueError) as got:
                ts.submit(*args)
            assert str(got.value) == str(want.value)
    finally:
        js.shutdown()
        ts.shutdown()


def test_buckets_pad_as_the_jax_server(rgb):
    """Groups of 1, 2, 3, 4 and 1 requests, each submitted at once and read
    before the next (a delay long enough that each group is one batch):
    both servers batch and pad alike (buckets 1, 2, 4, 4, 1: one padded
    slot)."""
    jm, tm, js, ts = rgb
    frames = staged_frames(tm.cfg, 11, seed=14)
    stats = []
    for cls, model in ((JServer, jm), (TServer, tm)):
        server = cls(model, max_batch=8, max_delay_ms=150, batch_buckets=(4, 1, 2))
        try:
            assert server.batch_buckets == (1, 2, 4, 8)
            assert [server._bucket_for(n) for n in (1, 2, 3, 5, 99)] == [1, 2, 4, 8, 8]
            i = 0
            for n in (1, 2, 3, 4, 1):
                _results(server, [(f,) for f in frames[i:i + n]])
                i += n
        finally:
            server.shutdown()
        stats.append((server.stats.requests, server.stats.batches,
                      server.stats.padded_slots))
    assert stats[1] == stats[0] == (11, 5, 1)


@pytest.mark.parametrize("buckets", [(0, 4), (-1,)])
def test_bucket_validation_as_jax(rgb, buckets):
    jm, tm, js, ts = rgb
    with pytest.raises(ValueError) as want:
        JServer(jm, max_batch=4, batch_buckets=buckets)
    with pytest.raises(ValueError) as got:
        TServer(tm, max_batch=4, batch_buckets=buckets)
    assert str(got.value) == str(want.value)


def test_shutdown_refuses_and_leaves_no_future_pending(rgb):
    """Submitters race the shutdown: every future they were handed ends
    (a result, or the shutdown's RuntimeError), the batcher thread ends,
    and a later submit raises as the JAX server's does."""
    jm, tm, js, ts = rgb
    frame = staged_frames(tm.cfg, 1, seed=15)[0]
    server = TServer(tm, max_delay_ms=1, **SERVER)
    futures, refused = [], []

    def client():
        while True:
            try:
                futures.append(server.submit(frame))
            except RuntimeError as e:
                refused.append(str(e))
                return
            time.sleep(0.002)

    threads = [threading.Thread(target=client) for _ in range(8)]
    for t in threads:
        t.start()
    deadline = time.monotonic() + 60
    while len(futures) < 32 and time.monotonic() < deadline:
        time.sleep(0.001)
    server.shutdown()
    for t in threads:
        t.join(timeout=60)
    assert not server._thread.is_alive() and not any(t.is_alive() for t in threads)
    assert refused == ["server is shut down"] * 8 and futures
    for f in futures:
        assert f.done()
        if f.exception() is not None:
            assert str(f.exception()) == "server is shut down"
    served = sum(f.exception() is None for f in futures)
    assert server.stats.requests == served
    jserver = JServer(jm, **SERVER)
    jserver.shutdown()
    with pytest.raises(RuntimeError) as want:
        jserver.submit(frame)
    with pytest.raises(RuntimeError) as got:
        server.submit(frame)
    assert str(got.value) == str(want.value)


def test_a_failing_batch_fails_its_futures_and_serving_goes_on(rgb, monkeypatch):
    jm, tm, js, ts = rgb
    frames = staged_frames(tm.cfg, 2, seed=16)
    server = TServer(tm, max_delay_ms=1, **SERVER)
    try:
        real = server._fn
        monkeypatch.setattr(server, "_fn", lambda *xs: (_ for _ in ()).throw(
            RuntimeError("device fault")))
        with pytest.raises(RuntimeError, match="device fault"):
            server.submit(frames[0]).result(timeout=60)
        monkeypatch.setattr(server, "_fn", real)
        _, logits = server.submit(frames[1]).result(timeout=60)
        np.testing.assert_allclose(logits, tapi.predict(tm, frames[1])[1], rtol=0, atol=1e-5)
    finally:
        server.shutdown()


STAGED_GROUPS = (1, 4, 3, 6)  # 3 after 4: a short batch in a bucket a full one used


def _staged_case(case, rgb):
    """(JAX server, port model, requests) of a staging case; landmarks go
    in as float64, which both servers cast to fp32."""
    if case == "rgb":
        jm, tm, js, _ = rgb
        frames = staged_frames(tm.cfg, sum(STAGED_GROUPS), seed=17)
        return js, None, tm, [(f,) for f in frames]
    family, overrides = ("pose_bilstm", POSE) if case == "pose" else ("two_stream", FUSION)
    jm, tm = model_pair(family, overrides, seed=18)
    lm = synthetic_landmarks(sum(STAGED_GROUPS), tm.cfg.num_frames, seed=19).astype(np.float64)
    if case == "pose":
        return JServer(jm, **SERVER), jm, tm, [(None, x) for x in lm]
    frames = staged_frames(tm.cfg, len(lm), seed=20)
    return JServer(jm, **SERVER), jm, tm, list(zip(frames, lm))


@pytest.mark.parametrize("case", ["rgb", "pose", "fusion"])
def test_batches_are_staged_in_place_per_bucket(rgb, case):
    """Groups of 1, 4, 3 and 6 requests, each one batch, under buckets
    (1, 4, 8): the JAX server's logits; the model sees each bucket's own
    buffer (the same memory from batch to batch, on the CPU the host rows
    themselves) with every padding row equal to the last real row, so the
    batch of 3 carries nothing of the batch of 4 before it; landmarks
    reach it as fp32."""
    js, own, tm, requests = _staged_case(case, rgb)
    server = TServer(tm, max_batch=8, max_delay_ms=300, batch_buckets=(1, 4, 8))
    seen = []
    real = server._fn

    def spy(*xs):
        seen.append([(x.data_ptr(), x.clone()) for x in xs])
        return real(*xs)

    server._fn = spy
    try:
        want = _results(js, requests)
        got, i = [], 0
        for n in STAGED_GROUPS:
            got += _results(server, requests[i:i + n])
            i += n
    finally:
        server.shutdown()
        if own is not None:
            js.shutdown()
    _assert_same(got, want)
    st = server.stats
    assert (st.requests, st.batches, st.padded_slots, st.staged_batches) == (14, 4, 3, 0)
    # The inputs by their place in submit's arguments: frames 0, landmarks 1.
    slots = [k for k, a in enumerate(requests[0]) if a is not None]
    i = 0
    for n, bucket, xs in zip(STAGED_GROUPS, (1, 4, 4, 8), seen):
        assert len(xs) == len(slots)
        for slot, (ptr, x) in zip(slots, xs):
            rows = np.stack([r[slot] for r in requests[i:i + n]])
            dtype = np.dtype(np.float32) if slot else rows.dtype
            stage = server._staging[(bucket, rows.shape[1:], dtype)]
            assert ptr == stage.host.ctypes.data == stage.batch.data_ptr()
            assert x.shape == (bucket, *rows.shape[1:]) and x.numpy().dtype == dtype
            np.testing.assert_array_equal(x[:n].numpy(), rows.astype(dtype))
            for pad in x[n:]:
                assert torch.equal(pad, x[n - 1])
        i += n
    # Bucket 4 served twice from one buffer per input.
    assert seen[1][0][0] == seen[2][0][0]
