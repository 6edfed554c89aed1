"""pose_bilstm beside its JAX counterpart: the LSTM layers, the landmark
normalisation, the model through both weight paths, landmark-only
``predict`` and the pose-only ``stream_predict``, and the landmark
providers."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asltpu import api as japi
from asltpu import ckpt as jckpt
from asltpu.data import landmarks as jlandmarks
from asltpu.data import synthetic as jsynthetic
from asltpu.models import bilstm as jbilstm
from asltpu.ops import recurrent as jrec
from asltpu_torch import api as tapi
from asltpu_torch.ckpt import state_dict_from_jax
from asltpu_torch.data import landmarks as tlandmarks
from asltpu_torch.data import synthetic as tsynthetic
from asltpu_torch.models import bilstm as tbilstm
from asltpu_torch.ops import recurrent as trec

ATOL = 2e-4  # the reference's fp32 parity bound (tests/unit/test_parity.py)
SMALL = dict(num_classes=7, hidden_size=16, num_layers=2, num_frames=5)


def _lstm_params(rng, f, h):
    def u(*shape):
        return rng.uniform(-0.5, 0.5, shape).astype(np.float32)

    return {"wi": u(f, 4 * h), "wh": u(h, 4 * h), "b": u(4 * h)}


def _torch_lstm(p):
    """JAX {wi [F,4H], wh [H,4H], b} → the port's (w_ih, w_hh, b)."""
    return (torch.from_numpy(p["wi"].T.copy()), torch.from_numpy(p["wh"].T.copy()),
            torch.from_numpy(p["b"]))


@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reverse"])
def test_lstm_layer_matches_jax(reverse):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 6, 5)).astype(np.float32)
    p = _lstm_params(rng, 5, 8)
    h0 = rng.standard_normal((3, 8)).astype(np.float32)
    c0 = rng.standard_normal((3, 8)).astype(np.float32)
    want, (wh, wc) = jrec.lstm_layer(jnp.asarray(x), p, reverse=reverse,
                                     init=(jnp.asarray(h0), jnp.asarray(c0)))
    got, (gh, gc) = trec.lstm_layer(torch.from_numpy(x), *_torch_lstm(p), reverse=reverse,
                                    init=(torch.from_numpy(h0), torch.from_numpy(c0)))
    assert got.shape == (3, 6, 8) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    np.testing.assert_allclose(gh.numpy(), np.asarray(wh), atol=ATOL)
    np.testing.assert_allclose(gc.numpy(), np.asarray(wc), atol=ATOL)


def test_bilstm_matches_jax_and_torch_lstm():
    """The plain bidirectional layer against JAX, and ``torch.nn.LSTM`` (the
    module's recurrence) against the plain layer with the same weights."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 6)).astype(np.float32)
    fwd, bwd = _lstm_params(rng, 6, 4), _lstm_params(rng, 6, 4)
    want = np.asarray(jrec.bilstm(jnp.asarray(x), fwd, bwd))
    got = trec.bilstm(torch.from_numpy(x), _torch_lstm(fwd), _torch_lstm(bwd))
    assert got.shape == (2, 7, 8)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    lstm = torch.nn.LSTM(6, 4, batch_first=True, bidirectional=True)
    with torch.no_grad():
        for sfx, p in (("", fwd), ("_reverse", bwd)):
            w_ih, w_hh, b = _torch_lstm(p)
            getattr(lstm, f"weight_ih_l0{sfx}").copy_(w_ih)
            getattr(lstm, f"weight_hh_l0{sfx}").copy_(w_hh)
            getattr(lstm, f"bias_ih_l0{sfx}").copy_(b)
            getattr(lstm, f"bias_hh_l0{sfx}").zero_()
        out, _ = lstm(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), got.numpy(), atol=1e-5)


def test_normalize_landmarks_matches_jax():
    """Missing rows stay zero, a frame without a usable pose (shoulders
    co-located) becomes all zero, a near-zero width clamps at 1e-4."""
    lm = tsynthetic.synthetic_landmarks(2, 6, seed=3)
    lm[0, 1, 40:60] = 0.0                      # missing face rows
    lm[0, 2, 12] = lm[0, 2, 11]                # no usable pose in this frame
    lm[1, 3, 12] = lm[1, 3, 11] + [2e-3, 0, 0]  # narrow but usable
    lm[1, 4] = 0.0                             # nothing detected
    want = np.asarray(jbilstm.normalize_landmarks(jnp.asarray(lm)))
    got = tbilstm.normalize_landmarks(torch.from_numpy(lm)).numpy()
    assert got.dtype == np.float32 and got.shape == lm.shape
    assert not got[0, 2].any() and not got[1, 4].any() and not got[0, 1, 40:60].any()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)


def _pair(seed=0, **overrides):
    cfg = dict(SMALL, **overrides)
    jm = japi.load_model("pose_bilstm", seed=seed, **cfg)
    tm = tapi.load_model("pose_bilstm", device="cpu", **cfg)
    tm.module.load_state_dict(state_dict_from_jax(tm.cfg, jax.device_get(jm.variables)))
    return jm, tm


def _landmarks(b, t, seed):
    lm = tsynthetic.synthetic_landmarks(b, t, seed=seed)
    lm[0, 0] = 0.0  # one frame with nothing detected
    return lm


def test_pose_bilstm_matches_jax_via_state_dict():
    jm, tm = _pair(seed=4)
    assert all(p.dtype == torch.float32 for p in tm.module.parameters())
    names = set(tm.module.state_dict())
    assert {"lstm.weight_ih_l0", "lstm.weight_hh_l1_reverse", "lstm.bias_ih_l1",
            "fc.weight", "fc.bias"} <= names
    lm = _landmarks(3, 5, seed=5)
    want = np.asarray(jm.module.apply(jm.variables, jnp.asarray(lm)))
    with torch.inference_mode():
        got = tm.module(torch.from_numpy(lm)).numpy()
    assert got.shape == (3, 7)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_pose_bilstm_pt_round_trip_into_jax(tmp_path):
    """The port's state_dict saved as .pt loads into the JAX model with
    ``asltpu.ckpt.load_torch_checkpoint`` (it sums bias_ih + bias_hh), and
    back into a fresh port model with the port's loader."""
    from asltpu_torch import ckpt as tckpt

    tm = tapi.load_model("pose_bilstm", device="cpu", seed=6, **SMALL)
    with torch.no_grad():  # nonzero hidden biases, so the sum is exercised
        for name, p in tm.module.lstm.named_parameters():
            if name.startswith("bias_hh"):
                p.uniform_(-0.3, 0.3)
    path = str(tmp_path / "pose.pt")
    torch.save(tm.module.state_dict(), path)
    jm = japi.load_model("pose_bilstm", seed=7, **SMALL)
    jm.variables = jckpt.load_torch_checkpoint(path, jm.variables, jm.cfg)
    lm = _landmarks(2, 5, seed=8)
    want = np.asarray(jm.module.apply(jm.variables, jnp.asarray(lm)))
    with torch.inference_mode():
        got = tm.module(torch.from_numpy(lm)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)
    back = tapi.load_model("pose_bilstm", device="cpu", seed=9, checkpoint=path, **SMALL)
    with torch.inference_mode():
        np.testing.assert_array_equal(back.module(torch.from_numpy(lm)).numpy(), got)


def test_predict_takes_landmarks_like_jax():
    jm, tm = _pair(seed=10)
    assert not tm.takes_rgb and tm.takes_landmarks
    lm = _landmarks(4, 5, seed=11)
    want_ids, want = japi.predict(jm, lm)
    got_ids, got = tapi.predict(tm, lm)
    assert got.shape == (4, 7) and got.dtype == np.float32
    np.testing.assert_array_equal(got_ids, want_ids)
    np.testing.assert_allclose(got, want, atol=1e-3)
    one_id, one = tapi.predict(tm, lm[2], gloss_names=list("abcdefg"))
    assert one.shape == (7,) and one_id == "abcdefg"[want_ids[2]]
    np.testing.assert_allclose(one, got[2], atol=1e-5)


def _store(tmp_path, n, t_raw, seed):
    """A LandmarkStore of ``n`` clips with ``t_raw`` frames each, written
    by both packages' stores to one directory; returns (paths, store dir)."""
    d = str(tmp_path / "lm")
    store = tlandmarks.LandmarkStore(d)
    lms = tsynthetic.synthetic_landmarks(n, t_raw, seed=seed)
    paths = []
    for i in range(n):
        store.put(f"v{i:03d}", lms[i])
        paths.append(f"/videos/v{i:03d}.mp4")
    return paths, d


def test_pose_stream_predict_matches_jax(tmp_path):
    jm, tm = _pair(seed=12)
    paths, d = _store(tmp_path, 5, 9, seed=13)
    want = list(japi.stream_predict(
        jm, paths, batch_size=2, landmarks_for=jlandmarks.LandmarkStore(d).for_path(5)))
    got = list(tapi.stream_predict(
        tm, paths, batch_size=2, landmarks_for=tlandmarks.LandmarkStore(d).for_path(5)))
    assert [p for p, _, _ in got] == [p for p, _, _ in want] == paths
    for (_, gid, glog), (_, wid, wlog) in zip(got, want):
        assert gid == wid
        np.testing.assert_allclose(glog, wlog, atol=1e-3)
    store = tlandmarks.LandmarkStore(d)
    _, batch = tapi.predict(tm, np.stack([store.get(f"v{i:03d}", 5) for i in range(5)]))
    np.testing.assert_allclose(np.stack([lg for _, _, lg in got]), batch, atol=1e-5)


def test_pose_stream_predict_needs_landmarks_for_like_jax():
    jm, tm = _pair()
    with pytest.raises(ValueError, match="landmarks_for") as want:
        next(iter(japi.stream_predict(jm, ["a.mp4"])))
    with pytest.raises(ValueError, match="landmarks_for") as got:
        next(iter(tapi.stream_predict(tm, ["a.mp4"])))
    assert str(got.value) == str(want.value)


def test_pose_stream_records_skip_errors_and_yield_items(tmp_path):
    """``takes_record`` hands the item to ``landmarks_for``; ``yield_items``
    yields it back; ``skip_errors`` drops an item whose landmarks do not
    load, without it the stream raises."""
    from asltpu_torch.data.wlasl import ClipRecord

    _, tm = _pair(seed=14)
    paths, d = _store(tmp_path, 3, 5, seed=15)
    store = tlandmarks.LandmarkStore(d)
    recs = [ClipRecord(f"v{i:03d}", "g", 0, "test", p, frame_start=1 + i)
            for i, p in enumerate(paths)]
    recs.insert(1, ClipRecord("gone", "g", 0, "test", "/videos/gone.mp4"))

    def by_record(rec):
        return store.get(rec.video_id, 5)

    by_record.takes_record = True
    out = list(tapi.stream_predict(tm, recs, batch_size=2, landmarks_for=by_record,
                                   skip_errors=True, yield_items=True))
    assert [r for r, _, _ in out] == [recs[0], recs[2], recs[3]]
    _, want = tapi.predict(tm, np.stack([store.get(r.video_id, 5) for r in recs if r.video_id != "gone"]))
    np.testing.assert_allclose(np.stack([lg for _, _, lg in out]), want, atol=1e-5)
    with pytest.raises(FileNotFoundError):
        list(tapi.stream_predict(tm, recs, batch_size=2, landmarks_for=by_record))


def test_landmark_providers_match_jax(tmp_path):
    for b, t, seed in ((2, 7, 0), (1, 33, 5)):
        np.testing.assert_array_equal(tsynthetic.synthetic_landmarks(b, t, seed),
                                      jsynthetic.synthetic_landmarks(b, t, seed))
    paths, d = _store(tmp_path, 2, 11, seed=16)
    for t in (4, 11, 16):
        np.testing.assert_array_equal(tlandmarks.LandmarkStore(d).for_path(t)(paths[1]),
                                      jlandmarks.LandmarkStore(d).for_path(t)(paths[1]))
    frames = np.zeros((6, 8, 8, 3), np.uint8)
    np.testing.assert_array_equal(tlandmarks.SyntheticExtractor(6, seed=2).extract(frames),
                                  jlandmarks.SyntheticExtractor(6, seed=2).extract(frames))
    np.save(os.path.join(d, "bad.npy"), np.zeros((3, 10, 3), np.float32))
    with pytest.raises(ValueError, match="expected"):
        tlandmarks.LandmarkStore(d).get("bad")
    with pytest.raises(RuntimeError, match="mediapipe"):
        tlandmarks.MediaPipeExtractor()


def test_precompute_landmarks_honours_the_segment(tiny_wlasl, tmp_path):
    from asltpu_torch.data.wlasl import WLASLIndex

    index, videos = tiny_wlasl
    recs = WLASLIndex(index, videos, subset=6).split("train")[:2]
    store = tlandmarks.LandmarkStore(str(tmp_path / "pre"))
    n = tlandmarks.precompute_landmarks(recs, store, tlandmarks.SyntheticExtractor(64))
    assert n == 2 and all(store.has(r.video_id) for r in recs)
    assert store.get(recs[0].video_id).shape == (64, 543, 3)
    assert tlandmarks.precompute_landmarks(recs, store, tlandmarks.SyntheticExtractor(64)) == 0
