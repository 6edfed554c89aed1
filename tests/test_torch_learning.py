"""The learning proofs of the port on the card, with the JAX package's
thresholds (``tests/integration/test_learning.py``,
``tests/integration/test_continuous.py``): a model trained through the
whole CLI path (WLASL index → decode → augmented train step → periodic
eval with pad rows left out) goes from chance to high held-out top-1 on
the separable synthetic tasks, where a subtly wrong gradient, label or
augment path still lets the loss fall. ``chip_smoke.py`` runs the
``mobilenet_gru``, ``pose_bilstm`` and ``two_stream`` proofs; these are the
longer ones. Each needs a CUDA device (marked ``cuda`` and ``slow``); run
them on the card with

    python -m pytest tests/test_torch_learning.py -m cuda --noconftest -q

This file imports no JAX."""

import csv
import os

import numpy as np
import pytest
import torch

pytestmark = [pytest.mark.cuda, pytest.mark.slow]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _eval_rows(log_dir):
    with open(os.path.join(log_dir, "train_metrics_eval.csv")) as f:
        return list(csv.DictReader(f))


def _train(tmp_path, index, videos, model, num_classes, overrides, extra):
    from asltpu_torch.cli.main import main

    argv = ["train", "--model", model, "--num-classes", str(num_classes)]
    for ov in overrides:
        argv += ["--set", ov]
    log_dir = str(tmp_path / "logs")
    assert main([*argv, "--index", index, "--videos", videos, "--lr", "2e-3",
                 "--eval-split", "val", "--ckpt-dir", str(tmp_path / "ck"),
                 "--log-dir", log_dir, *extra]) == 0
    rows = _eval_rows(log_dir)
    print(model, [(r["step"], r["eval_top1"]) for r in rows])
    return [(int(float(r["step"])), float(r["eval_top1"])) for r in rows], rows


def _run_cli_learning(tmp_path, model, overrides, frames):
    """The JAX proof's CLI run: 6 glosses, 8 train and 4 val clips each,
    300 steps of batch 8 with augmentation on, eval every 75 steps; the
    final held-out top-1 must reach 0.8 (chance 1/6), every eval scoring
    all 24 val clips."""
    from asltpu_torch.data.synthetic import make_separable_wlasl

    index, videos = make_separable_wlasl(str(tmp_path / "data"), num_glosses=6,
                                         train_per_gloss=8, val_per_gloss=4, num_frames=24,
                                         size=(96, 96))
    traj, rows = _train(tmp_path, index, videos, model, 6, overrides, [
        "--batch", "8", "--steps", "300", "--warmup", "10", "--log-every", "50",
        "--eval-every", "75", "--ckpt-every", "300", "--frames", str(frames),
        "--crop", "32"])
    assert traj[-1][0] == 300
    assert traj[-1][1] >= 0.8, f"{model} failed to learn: top-1 {traj}"
    assert all(float(r["eval_clips"]) == 24.0 for r in rows)
    return traj


def test_i3d_train_path_learns(card, tmp_path):
    """Full-width I3D (s2d stem, remat, fp32 BatchNorm statistics under
    bf16) at 8 frames, the fewest its pools take; dropout lowered to 0.1
    as in the JAX proof."""
    _run_cli_learning(tmp_path, "i3d", ("dropout=0.1",), frames=8)


def test_resnet_transformer_train_path_learns(card, tmp_path):
    """The full ResNet-18 backbone with the head shrunk (d_model 64, one
    layer), as in the JAX proof."""
    _run_cli_learning(tmp_path, "resnet_transformer",
                      ("d_model=64", "num_tx_layers=1", "num_heads=2", "dropout=0.1"),
                      frames=4)


def test_52class_grid_anchor(card, tmp_path):
    """52 classes = 13 hues × 4 hue-rotation rates (the hard nuisance tier),
    through the CLI at batch 32 for 400 steps; ≥ 0.9 on the 208 held-out
    clips. The rate makes the task temporal: a model that pools frames
    without order confuses the ±rate pairs."""
    from asltpu_torch.data.synthetic import make_separable_wlasl_grid

    index, videos = make_separable_wlasl_grid(str(tmp_path / "data"))
    traj, rows = _train(tmp_path, index, videos, "mobilenet_gru", 52, (), [
        "--batch", "32", "--steps", "400", "--warmup", "50", "--log-every", "100",
        "--eval-every", "100", "--ckpt-every", "400", "--frames", "16", "--crop", "64",
        "--loader", "grain", "--loader-workers", "4"])
    assert traj[-1][0] == 400
    assert all(float(r["eval_clips"]) == 208.0 for r in rows)
    assert traj[-1][1] >= 0.9, f"52-class anchor failed to learn: {traj}"


def test_windows_recover_sign_sequence(card, tmp_path):
    """A model trained through the CLI on separate clips, run over one
    continuous session of six signs (``write_separable_session``) by
    ``predict_windows``: the windows inside each sign vote its gloss, in
    signing order, and ``merge_windows`` tiles the video with the confident
    runs in that order."""
    from asltpu_torch import api
    from asltpu_torch.cli.main import main
    from asltpu_torch.data.synthetic import make_separable_wlasl, write_separable_session
    from asltpu_torch.windows import merge_windows, predict_windows

    num_glosses = 6
    index, videos = make_separable_wlasl(str(tmp_path / "data"), num_glosses=num_glosses,
                                         train_per_gloss=8, val_per_gloss=4, num_frames=24,
                                         size=(96, 96))
    ckpt_dir = str(tmp_path / "ck")
    assert main([
        "train", "--model", "mobilenet_gru", "--num-classes", str(num_glosses),
        "--set", "width_mult=0.5", "--set", "gru_hidden=32",
        "--index", index, "--videos", videos,
        "--batch", "8", "--steps", "300", "--lr", "2e-3", "--warmup", "10",
        "--log-every", "100", "--ckpt-dir", ckpt_dir, "--ckpt-every", "300",
        "--frames", "4", "--crop", "32",
    ]) == 0

    # Nuisance seeds apart from the train (g·1000 + c) and val draws.
    sequence = [2, 0, 4, 1, 5, 3]
    session = str(tmp_path / "session.mp4")
    timeline = write_separable_session(session, sequence, num_glosses=num_glosses,
                                       frames_per_sign=24, size=(96, 96), seed=777)
    assert [g for g, _, _ in timeline] == sequence
    model = api.load_model(
        "mobilenet_gru", checkpoint=ckpt_dir, num_classes=num_glosses, width_mult=0.5,
        gru_hidden=32, preprocess=dict(num_frames=4, crop=32, resize_short=37,
                                       staging_size=(37, 37)))
    wins = predict_windows(model, session, window_frames=12, stride_frames=6, batch_size=8)

    # The majority of the windows wholly inside each sign (three at window
    # 12 / stride 6 / span 24; the windows across a boundary see two signs).
    votes = []
    for gloss_id, start, end in timeline:
        inside = [w for w in wins if w.start_frame >= start and w.end_frame <= end]
        assert len(inside) == 3, [(w.start_frame, w.end_frame) for w in inside]
        ids, counts = np.unique([w.gloss_id for w in inside], return_counts=True)
        votes.append(int(ids[np.argmax(counts)]))
    assert votes == sequence, (
        f"timeline vote {votes} != signed sequence {sequence}; windows: "
        f"{[(w.start_frame, w.end_frame, w.gloss_id, round(w.prob, 2)) for w in wins]}")

    segs = merge_windows(wins, min_prob=0.5)
    assert segs[0].start_frame == 1 and segs[-1].end_frame == timeline[-1][2]
    confident = [s.gloss_id for s in segs if s.gloss_id >= 0]
    deduped = [g for i, g in enumerate(confident) if i == 0 or g != confident[i - 1]]
    it = iter(deduped)
    assert all(any(g == want for g in it) for want in sequence), (
        f"confident segment order {deduped} does not contain {sequence}")
