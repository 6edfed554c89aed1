"""Continuous-video windows (``asltpu_torch.windows``) and the CLI's
``predict`` (``asltpu_torch.cli``) against the JAX package on the CPU.

The window plan, the merge into gloss segments and their JSON are held to
``asltpu.windows``'s over a grid of cases (short videos, a clamped tail, a
stride longer than the window, invalid arguments); then, from the same
weights (``test_torch_serve.model_pair``) on one written video,
``predict_windows`` and ``predict_windows_landmarks`` give the JAX
package's spans and ids, probabilities within 1e-4 and equal segments
(mean probabilities within the wire's rounding step),
the fusion model with a landmark stream too. The CLI's JSON lines equal
the port's library calls, and its checks before the model loads fail as
the JAX CLI's do."""

import dataclasses
import importlib
import json

import numpy as np
import pytest

from asltpu import windows as jwin
from asltpu_torch import api as tapi
from asltpu_torch import windows as twin
from asltpu_torch.data.synthetic import synthetic_landmarks, write_video
from asltpu_torch.eval.metrics import topk_entries
from test_torch_serve import FUSION, POSE, RGB, assert_segments_equal, model_pair

# The CLI modules (each package's ``cli`` re-exports the function ``main``
# under the module's name).
jcli = importlib.import_module("asltpu.cli.main")
tcli = importlib.import_module("asltpu_torch.cli.main")
PROB_ATOL = 1e-4  # a window's softmax probability (fp32 logits, float64 softmax)
FPS = 25


@pytest.mark.parametrize("total,window,stride", [
    (0, 5, 2), (1, 5, 2), (4, 5, 2), (5, 5, 2), (10, 5, 2), (10, 5, 5), (11, 5, 3),
    (10, 3, 7), (10, 10, 1), (100, 16, 8), (10, 0, 2), (10, 5, 0), (10, -1, 1),
])
def test_enumerate_windows_matches_jax(total, window, stride):
    """Short videos (one window over all), a tail moved back to end at the
    last frame, a stride longer than the window, and invalid sizes."""
    try:
        want = jwin.enumerate_windows(total, window, stride)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            twin.enumerate_windows(total, window, stride)
        assert str(got.value) == str(e)
        return
    assert twin.enumerate_windows(total, window, stride) == want


@pytest.mark.parametrize("args", [
    (250, 25.0, 2.0, None, 1.0, None), (250, 25.0, 2.0, None, None, None),
    (40, 25.0, None, 16, None, 8), (40, 30.0, 0.01, None, None, None),
    (10, 25.0, 1.0, None, None, None), (97, 29.97, 0.5, None, None, 3),
    (40, 25.0, None, 16, 2.5, None),
    (40, 25.0, 1.0, 16, None, None), (40, 25.0, None, None, None, None),
    (40, 25.0, 1.0, None, 0.5, 4),
])
def test_resolve_plan_matches_jax(args):
    try:
        want = jwin._resolve_plan(*args)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            twin._resolve_plan(*args)
        assert str(got.value) == str(e)
        return
    assert twin._resolve_plan(*args) == want


def _windows(labels_probs, names=None):
    """The same window predictions in both packages' dataclasses: window i
    spans frames 8i+1 .. 8i+16 at 25 fps."""
    rows = [(i, 8 * i + 1, 8 * i + 16, 8 * i / FPS, (8 * i + 16) / FPS, gid,
             names[gid] if names else gid, p)
            for i, (gid, p) in enumerate(labels_probs)]
    return [jwin.WindowPrediction(*r) for r in rows], [twin.WindowPrediction(*r) for r in rows]


MERGE_CASES = {
    "empty": ([], 0.0),
    "one_gloss": ([(3, 0.9)] * 4, 0.0),
    "alternating": ([(1, 0.5), (2, 0.6), (1, 0.7), (1, 0.8)], 0.0),
    "uncertain_pooled": ([(1, 0.9), (2, 0.2), (3, 0.25), (1, 0.9)], 0.3),
    "uncertain_edges": ([(4, 0.1), (4, 0.95), (4, 0.2)], 0.5),
    "all_uncertain": ([(0, 0.1), (5, 0.1)], 0.5),
}


@pytest.mark.parametrize("case", sorted(MERGE_CASES))
@pytest.mark.parametrize("names", [None, [f"g{i}" for i in range(6)]])
def test_merge_windows_and_segments_json_match_jax(case, names):
    labels_probs, min_prob = MERGE_CASES[case]
    jw, tw = _windows(labels_probs, names)
    want = jwin.merge_windows(jw, min_prob=min_prob)
    got = twin.merge_windows(tw, min_prob=min_prob)
    assert [dataclasses.asdict(s) for s in got] == [dataclasses.asdict(s) for s in want]
    assert twin.segments_json(got) == jwin.segments_json(want)
    assert sum(s.num_windows for s in got) == len(tw)


@pytest.fixture(scope="module")
def session(tmp_path_factory):
    """A written 'session' of 60 frames at 25 fps and the RGB pair."""
    path = str(tmp_path_factory.mktemp("windows") / "session.mp4")
    write_video(path, num_frames=60, size=(72, 96), fps=FPS, seed=7)
    return path, model_pair("mobilenet_gru", RGB, seed=21)


def _assert_windows_equal(got, want):
    assert [(w.index, w.start_frame, w.end_frame, w.start_s, w.end_s) for w in got] == [
        (w.index, w.start_frame, w.end_frame, w.start_s, w.end_s) for w in want]
    assert [w.gloss_id for w in got] == [w.gloss_id for w in want]
    assert [w.gloss for w in got] == [w.gloss for w in want]
    np.testing.assert_allclose([w.prob for w in got], [w.prob for w in want],
                               rtol=0, atol=PROB_ATOL)


@pytest.mark.parametrize("plan", [
    dict(window_frames=16, stride_frames=8),
    dict(window_seconds=0.64, stride_seconds=0.36),
    dict(window_seconds=1.0),
])
def test_predict_windows_matches_jax(session, plan):
    path, (jm, tm) = session
    names = [f"g{i}" for i in range(7)]
    kw = dict(plan, batch_size=4, gloss_names=names, decode_backend="thread",
              num_decode_workers=2)
    want = jwin.predict_windows(jm, path, **kw)
    got = twin.predict_windows(tm, path, **kw)
    _assert_windows_equal(got, want)
    # The windows' probabilities differ well beyond the bound, so windows
    # delivered out of order fail.
    probs = [w.prob for w in want]
    assert len(probs) > 1 and max(probs) - min(probs) > 10 * PROB_ATOL
    for min_prob in (0.0, 0.3):
        assert_segments_equal(twin.segments_json(twin.merge_windows(got, min_prob=min_prob)),
                              jwin.segments_json(jwin.merge_windows(want, min_prob=min_prob)))


def test_predict_windows_landmarks_matches_jax():
    jm, tm = model_pair("pose_bilstm", POSE, seed=22)
    stream = synthetic_landmarks(1, 50, seed=23)[0]
    kw = dict(window_frames=12, stride_frames=5, batch_size=4)
    want = jwin.predict_windows_landmarks(jm, stream, 10.0, **kw)
    got = twin.predict_windows_landmarks(tm, stream, 10.0, **kw)
    assert len(got) == 9
    _assert_windows_equal(got, want)
    assert_segments_equal(twin.segments_json(twin.merge_windows(got)),
                          jwin.segments_json(jwin.merge_windows(want)))


@pytest.fixture(scope="module")
def fusion(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("fusion") / "session.mp4")
    write_video(path, num_frames=40, size=(48, 64), fps=FPS, seed=24)
    return path, synthetic_landmarks(1, 40, seed=25)[0], model_pair("two_stream", FUSION,
                                                                    seed=26)


def test_fusion_windows_with_a_landmark_stream_match_jax(fusion):
    path, stream, (jm, tm) = fusion
    kw = dict(window_frames=16, stride_frames=8, batch_size=4, decode_backend="thread",
              num_decode_workers=2, landmark_stream=stream)
    want = jwin.predict_windows(jm, path, **kw)
    got = twin.predict_windows(tm, path, **kw)
    assert len(got) == 4
    _assert_windows_equal(got, want)


FUSION_REFUSALS = {
    "no_stream": lambda s: None,
    "wrong_shape": lambda s: s[:, :100],
    "short_stream": lambda s: s[:30],
}


@pytest.mark.parametrize("case", sorted(FUSION_REFUSALS))
def test_fusion_windows_refuse_as_jax(fusion, case):
    path, stream, (jm, tm) = fusion
    bad = FUSION_REFUSALS[case](stream)
    with pytest.raises(ValueError) as want:
        jwin.predict_windows(jm, path, window_frames=16, landmark_stream=bad)
    with pytest.raises(ValueError) as got:
        twin.predict_windows(tm, path, window_frames=16, landmark_stream=bad)
    assert str(got.value) == str(want.value)


def test_lanes_refuse_the_other_family_as_jax(session):
    path, (jm, tm) = session
    pj, pt = model_pair("pose_bilstm", POSE, seed=27)
    stream = synthetic_landmarks(1, 20, seed=28)[0]
    cases = [
        (lambda m: jwin.predict_windows(m, path, window_frames=8), pj,
         lambda m: twin.predict_windows(m, path, window_frames=8), pt),
        (lambda m: jwin.predict_windows_landmarks(m, stream, 25.0, window_frames=8), jm,
         lambda m: twin.predict_windows_landmarks(m, stream, 25.0, window_frames=8), tm),
        (lambda m: jwin.predict_windows_landmarks(m, stream, 0.0, window_frames=8), pj,
         lambda m: twin.predict_windows_landmarks(m, stream, 0.0, window_frames=8), pt),
        (lambda m: jwin.predict_windows_landmarks(m, stream[None], 25.0, window_frames=8), pj,
         lambda m: twin.predict_windows_landmarks(m, stream[None], 25.0, window_frames=8), pt),
    ]
    for jcall, jmodel, tcall, tmodel in cases:
        with pytest.raises(ValueError) as want:
            jcall(jmodel)
        with pytest.raises(ValueError) as got:
            tcall(tmodel)
        assert str(got.value) == str(want.value)


# The CLI: a small model from --set overrides, on the CPU.
CLI_MODEL = ["--num-classes", "7", "--set", "gru_hidden=32", "--set", "width_mult=0.35",
             "--set", "compute_dtype=float32", "--set", "preprocess.num_frames=3",
             "--set", "preprocess.staging_size=(64, 80)", "--set", "preprocess.resize_short=56",
             "--set", "preprocess.crop=48"]
CLI_OVERRIDES = dict(num_classes=7, gru_hidden=32, width_mult=0.35, compute_dtype="float32",
                     preprocess={"num_frames": 3, "staging_size": (64, 80),
                                 "resize_short": 56, "crop": 48})


def _cli_lines(capsys, argv):
    assert tcli.main(argv) == 0
    return [json.loads(line) for line in capsys.readouterr().out.splitlines()]


def test_cli_predict_prints_what_the_library_gives(session, tmp_path, capsys):
    path, _ = session
    other = str(tmp_path / "other.mp4")
    write_video(other, num_frames=20, size=(72, 96), seed=30)
    got = _cli_lines(capsys, ["predict", path, other, "--device", "cpu", "--batch", "2",
                              "--decode-backend", "thread"] + CLI_MODEL)
    model = tapi.load_model("mobilenet_gru", device="cpu", **CLI_OVERRIDES)
    want = [{"clip": p, "gloss": g, "top5": topk_entries(lg)} for p, g, lg in
            tapi.stream_predict(model, [path, other], batch_size=2, decode_backend="thread")]
    assert got == want and len(got) == 2


def test_cli_predict_windows_prints_what_the_library_gives(session, capsys):
    path, _ = session
    got = _cli_lines(capsys, ["predict", path, "--device", "cpu", "--windows", "0.64",
                              "--window-stride", "0.32", "--min-prob", "0.3", "--batch", "4",
                              "--decode-backend", "thread"] + CLI_MODEL)
    model = tapi.load_model("mobilenet_gru", device="cpu", **CLI_OVERRIDES)
    wins = twin.predict_windows(model, path, window_seconds=0.64, stride_seconds=0.32,
                                batch_size=4, decode_backend="thread")
    assert got == [{
        "clip": path,
        "segments": twin.segments_json(twin.merge_windows(wins, min_prob=0.3)),
        "windows": [{"start_s": round(w.start_s, 3), "end_s": round(w.end_s, 3),
                     "gloss": w.gloss, "prob": round(w.prob, 4)} for w in wins],
    }]


# Argument sets refused before the model loads, in both CLIs (the JAX
# one's message names its own module and server command, and its model
# list lacks the port's own ``timesformer``, ``video_swin`` and ``mvit_v2``).
CLI_REFUSALS = {
    "missing_clip": ["predict", "{missing}"],
    "fast_needs_av": ["predict", "{clip}", "--decode-fast", "--decode-backend", "process"],
    "windows_not_positive": ["predict", "{clip}", "--windows", "0"],
    "pose_windows": ["predict", "{clip}", "--windows", "1", "--model", "pose_bilstm"],
    "fusion_windows_no_stream": ["predict", "{clip}", "--windows", "1", "--model", "two_stream"],
    "fusion_windows_two_clips": ["predict", "{clip}", "{clip}", "--windows", "1", "--model",
                                 "two_stream", "--landmarks-stream", "lm.npy"],
    "unknown_model": ["predict", "{clip}", "--model", "c3d"],
    "bad_override": ["predict", "{clip}", "--set", "gru_hidden"],
}


@pytest.mark.parametrize("case", sorted(CLI_REFUSALS))
def test_cli_checks_before_loading_fail_as_jax(session, tmp_path, case):
    path, _ = session
    argv = [a.format(clip=path, missing=str(tmp_path / "none.mp4")) for a in CLI_REFUSALS[case]]
    with pytest.raises(SystemExit) as want:
        jcli.main(argv)
    with pytest.raises(SystemExit) as got:
        tcli.main(argv + ["--device", "cpu"])
    expected = (str(want.value).replace("asltpu.windows", "asltpu_torch.windows")
                .replace("on asl serve", "on the server")
                .replace("mobilenet_gru, pose_bilstm", "mobilenet_gru, mvit_v2, pose_bilstm")
                .replace("resnet_transformer, two_stream",
                         "resnet_transformer, timesformer, two_stream, video_swin"))
    assert str(got.value) == expected and expected.startswith("error: ")


def test_cli_takes_predict_and_serve_and_defaults_to_the_card(session, monkeypatch):
    """The JAX CLI's subcommands are listed; ``serve`` parses its buckets
    and warms when they are given; without ``--device`` the model goes to
    the card, and without a card that raises."""
    import torch

    from asltpu_torch import serve_http

    choices = next(a for a in tcli.build_parser()._actions
                   if a.dest == "cmd").choices
    assert set(choices) == {"predict", "serve", "train", "eval", "export", "landmarks",
                            "bench"}
    with pytest.raises(SystemExit):
        tcli.main(["train"])  # --index and --videos are required
    calls = []
    monkeypatch.setattr(serve_http, "serve", lambda model, **kw: calls.append((model, kw)))
    assert tcli.main(["serve", "--device", "cpu", "--port", "0", "--batch-buckets", "1,4,8",
                      "--max-batch", "8"] + CLI_MODEL) == 0
    (model, kw), = calls
    assert model.device.type == "cpu" and model.cfg.num_classes == 7
    assert kw["batch_buckets"] == (1, 4, 8) and kw["warm"] is True and kw["max_batch"] == 8
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tcli.main(["predict", session[0]] + CLI_MODEL)
