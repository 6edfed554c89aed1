"""The port's CLI (``asltpu_torch.cli``) driven with real argv on the CPU,
as ``tests/unit/test_cli.py`` drives the JAX package's: landmarks → predict
→ eval → train on synthetic WLASL data from the port's own
``make_synthetic_wlasl``, and the checks that fail before a model is built.
Beside them: ``eval`` prints the JAX CLI's metrics on the same data and
carried weights, ``bench`` forwards its arguments, and ``train --loader
grain --loader-workers 2`` cut by a fault resumes into the uninterrupted
stream; ``train --model-parallel`` checks the config's shapes before any
data is read, and trains tensor-parallel under ``torch.distributed.run``."""

import csv
import importlib
import json
import os
import subprocess
import sys

import pytest
import torch

from asltpu_torch.cli.main import main

cli_main = importlib.import_module("asltpu_torch.cli.main")


def _run(capsys, argv):
    rc = main(argv)
    out = capsys.readouterr().out
    return rc, [json.loads(line) for line in out.splitlines() if line.strip()]


@pytest.fixture(scope="module")
def tiny_wlasl_module(tmp_path_factory):
    from asltpu_torch.data.synthetic import make_synthetic_wlasl

    # 3 clips a gloss: 12 train records, enough for the batch-8 train test.
    return make_synthetic_wlasl(str(tmp_path_factory.mktemp("wlasl")), num_glosses=6,
                                clips_per_gloss=3, num_frames=12, size=(64, 64),
                                splits=["train", "test"])


@pytest.fixture(scope="module")
def landmark_store(tmp_path_factory, tiny_wlasl_module):
    index, videos = tiny_wlasl_module
    out = str(tmp_path_factory.mktemp("lm"))
    assert main(["landmarks", "--index", index, "--videos", videos, "--out", out,
                 "--num-classes", "6", "--extractor", "synthetic"]) == 0
    return out


def _records(tiny_wlasl_module, n):
    from asltpu_torch.data.wlasl import WLASLIndex

    index, videos = tiny_wlasl_module
    return WLASLIndex(index, videos, subset=6).split("train")[:n]


def test_cli_landmarks_then_predict_pose(capsys, landmark_store, tiny_wlasl_module):
    index, _ = tiny_wlasl_module
    recs = _records(tiny_wlasl_module, 2)
    rc, rows = _run(capsys, [
        "predict", recs[0].path, recs[1].path, "--device", "cpu",
        "--model", "pose_bilstm", "--num-classes", "6", "--batch", "2",
        "--index", index, "--landmarks-dir", landmark_store,
    ])
    assert rc == 0 and len(rows) == 2
    for row in rows:
        assert isinstance(row["gloss"], str)
        assert len(row["top5"]) == 5


def test_cli_eval_pose(capsys, landmark_store, tiny_wlasl_module):
    index, videos = tiny_wlasl_module
    rc, rows = _run(capsys, [
        "eval", "--device", "cpu", "--model", "pose_bilstm", "--num-classes", "6",
        "--index", index, "--videos", videos, "--split", "test", "--batch", "2",
        "--landmarks-dir", landmark_store, "--per-class",
    ])
    assert rc == 0
    (metrics,) = rows
    assert {"top1", "top5", "num_clips", "macro_top1", "per_class"} <= set(metrics)
    assert metrics["num_clips"] > 0
    # Per-gloss rows carry the index's names, and their supports sum to the
    # clips evaluated.
    assert all(isinstance(r["gloss"], str) for r in metrics["per_class"])
    assert sum(r["n"] for r in metrics["per_class"]) == metrics["num_clips"]


def test_cli_predict_validates_inputs(tiny_wlasl_module):
    index, _ = tiny_wlasl_module
    with pytest.raises(SystemExit):
        main(["predict", "/nope/missing.mp4"])
    with pytest.raises(SystemExit):
        main(["predict", index, "--model", "not_a_model"])
    for cmd in (["train", "--index", index, "--videos", "v"],
                ["eval", "--index", index, "--videos", "v"],
                ["export", "--out", "o"]):
        with pytest.raises(SystemExit, match="unknown model"):
            main([*cmd, "--model", "not_a_model"])


def test_cli_train_records_loader(tmp_path, tiny_wlasl_module):
    """Two train steps through the whole CLI stack (decode pool → augment →
    train step → checkpoint) at tiny shapes."""
    index, videos = tiny_wlasl_module
    rc = main([
        "train", "--device", "cpu", "--model", "mobilenet_gru", "--num-classes", "6",
        "--set", "gru_hidden=16", "--set", "width_mult=0.35",
        "--index", index, "--videos", videos,
        "--batch", "8", "--steps", "2", "--log-every", "1",
        "--ckpt-dir", str(tmp_path / "ck"), "--ckpt-every", "2",
        "--frames", "2", "--crop", "32", "--no-augment",
    ])
    assert rc == 0
    assert os.path.isdir(str(tmp_path / "ck" / "2"))


def test_cli_train_refuses_landmark_models(tmp_path, tiny_wlasl_module):
    index, videos = tiny_wlasl_module
    for model in ("pose_bilstm", "two_stream"):
        with pytest.raises(SystemExit, match="RGB clips only"):
            main(["train", "--device", "cpu", "--model", model, "--index", index,
                  "--videos", videos, "--ckpt-dir", str(tmp_path / "ck")])


def test_cli_train_fails_fast_when_underfull(tmp_path, tiny_wlasl_module):
    """Fewer train records than one batch must exit, not spin forever."""
    index, videos = tiny_wlasl_module
    with pytest.raises(SystemExit):
        main([
            "train", "--device", "cpu", "--model", "mobilenet_gru", "--num-classes", "6",
            "--index", index, "--videos", videos, "--batch", "64", "--steps", "1",
            "--ckpt-dir", str(tmp_path / "ck"), "--frames", "2", "--crop", "32",
            "--no-augment",
        ])


def _eval_rows(path):
    with open(path) as f:
        return list(csv.DictReader(f))


def test_cli_train_grain_loader_workers_resume(tmp_path, tiny_wlasl_module):
    """``--loader grain --loader-workers 2``: a run cut by a fault at step 3
    (after its step-2 checkpoint) and run again resumes at step 2 with the
    loader's position; its eval rows (``train_metrics_eval.csv``, the JAX
    CLI's columns) are the uninterrupted run's. ``--debug-nans`` turns
    autograd's anomaly detection on."""
    from asltpu_torch.train.loop import FaultInjected

    index, videos = tiny_wlasl_module

    def argv(name, *extra):
        return ["train", "--device", "cpu", "--model", "mobilenet_gru", "--num-classes", "6",
                "--set", "gru_hidden=8", "--set", "width_mult=0.35", "--set", "dropout=0.0",
                "--index", index, "--videos", videos, "--batch", "4", "--steps", "4",
                "--lr", "1e-2", "--warmup", "1", "--log-every", "1", "--eval-split", "test",
                "--eval-every", "2", "--ckpt-dir", str(tmp_path / name / "ck"),
                "--ckpt-every", "2", "--frames", "2", "--crop", "32", "--no-augment",
                "--log-dir", str(tmp_path / name / "logs"), "--loader", "grain",
                "--loader-workers", "2", *extra]

    torch.manual_seed(0)
    assert main(argv("whole")) == 0
    with pytest.raises(FaultInjected):
        main(argv("cut", "--fault-inject-step", "3"))
    try:
        assert main(argv("cut", "--debug-nans")) == 0
        assert torch.is_anomaly_enabled()
    finally:
        torch.autograd.set_detect_anomaly(False)
    whole = _eval_rows(tmp_path / "whole" / "logs" / "train_metrics_eval.csv")
    cut = _eval_rows(tmp_path / "cut" / "logs" / "train_metrics_eval.csv")
    assert list(whole[0]) == ["step", "wall_time", "eval_clips", "eval_top1", "eval_top5"]
    assert [r["step"] for r in whole] == ["2", "4"] == [r["step"] for r in cut]
    assert all(float(r["eval_clips"]) == 6.0 for r in whole + cut)
    key = ("eval_top1", "eval_top5")
    assert [[r[k] for k in key] for r in cut] == [[r[k] for k in key] for r in whole]
    train_whole = _eval_rows(tmp_path / "whole" / "logs" / "train_metrics.csv")
    train_cut = _eval_rows(tmp_path / "cut" / "logs" / "train_metrics.csv")
    # Step 3 ran before the fault and again after the resume from step 2.
    assert [r["step"] for r in train_cut] == ["1", "2", "3", "3", "4"]
    loss = {r["step"]: float(r["loss"]) for r in train_whole}
    for r in train_cut:
        assert abs(float(r["loss"]) - loss[r["step"]]) <= 1e-5 * loss[r["step"]]


def test_cli_predict_decode_fast(capsys, tiny_wlasl_module):
    """``predict --decode-backend av --decode-fast``; with the default
    (auto) backend ``--decode-fast`` implies av, with any other it exits
    before a model is built."""
    from asltpu_torch import native

    if not native.av_available():
        pytest.skip(f"native av decode: {native.av_unavailable_reason()}")
    recs = _records(tiny_wlasl_module, 2)
    small = ["--device", "cpu", "--model", "mobilenet_gru", "--num-classes", "6",
             "--set", "gru_hidden=16", "--set", "width_mult=0.35",
             "--set", "preprocess.num_frames=2",
             "--set", "preprocess.staging_size=(48,48)",
             "--set", "preprocess.resize_short=40", "--set", "preprocess.crop=32"]
    rc, rows = _run(capsys, ["predict", recs[0].path, recs[1].path, "--batch", "2",
                             "--decode-backend", "av", "--decode-fast", *small])
    assert rc == 0 and len(rows) == 2
    rc, rows = _run(capsys, ["predict", recs[0].path, "--decode-fast", *small])
    assert rc == 0 and len(rows) == 1
    with pytest.raises(SystemExit, match="decode-fast"):
        main(["predict", recs[0].path, "--decode-backend", "native", "--decode-fast",
              *small])


def test_cli_av_backend_unavailable_fails_before_compile(monkeypatch, tiny_wlasl_module):
    """An av backend that cannot load exits while the arguments are checked,
    before a model is built."""
    from asltpu_torch import native

    monkeypatch.setattr(native, "av_available", lambda: False)
    monkeypatch.setattr(native, "av_unavailable_reason", lambda: "forced off for the test")

    def _boom(args):  # pragma: no cover - only on regression
        raise AssertionError("a model was built although av is unavailable")

    monkeypatch.setattr(cli_main, "_load", _boom)
    rec = _records(tiny_wlasl_module, 1)[0]
    for extra in (["--decode-fast"], ["--decode-backend", "av"]):
        with pytest.raises(SystemExit, match="unavailable"):
            main(["predict", rec.path, "--model", "mobilenet_gru", "--num-classes", "6",
                  *extra])


def test_cli_bench_forwards_its_arguments(monkeypatch):
    import asltpu_torch.benchmark as benchmark

    seen = []
    monkeypatch.setattr(benchmark, "main", lambda argv=None: seen.append(argv) or 0)
    rest = ["--device", "cpu", "--batch", "2", "--cells", "mobilenet_gru:rgb"]
    assert main(["bench", *rest]) == 0
    assert seen == [rest]


def test_cli_eval_matches_the_jax_cli(capsys, tmp_path, tiny_wlasl_module):
    """``eval`` of the port and of the JAX package on the same split with
    the same weights (a ``.pt`` of the port model, BatchNorm calibrated so
    the clips' logits differ, read by both packages' torch import): the
    same top-1, top-5 and clip count."""
    from asltpu.cli.main import main as jmain
    from test_torch_serve import RGB, model_pair

    index, videos = tiny_wlasl_module
    _, tm = model_pair("mobilenet_gru", RGB)
    weights = str(tmp_path / "w.pt")
    torch.save(tm.module.state_dict(), weights)
    pp = RGB["preprocess"]
    argv = ["eval", "--model", "mobilenet_gru", "--ckpt", weights, "--index", index,
            "--videos", videos, "--split", "test", "--batch", "4",
            *[a for k, v in RGB.items() if k != "preprocess" for a in ("--set", f"{k}={v}")],
            *[a for k, v in pp.items() for a in ("--set", f"preprocess.{k}={v!r}".replace(" ", ""))]]
    assert jmain(argv) == 0
    (want,) = [json.loads(ln) for ln in capsys.readouterr().out.splitlines() if ln.strip()]
    rc, (got,) = _run(capsys, [*argv, "--device", "cpu"])
    assert rc == 0
    assert want["num_clips"] == got["num_clips"] == 6.0
    assert {k: got[k] for k in ("top1", "top5", "num_clips", "num_skipped")} == \
        {k: want[k] for k in ("top1", "top5", "num_clips", "num_skipped")}


def test_cli_train_model_parallel_is_checked_before_any_data(tmp_path, monkeypatch):
    """``--model-parallel 3`` on the contract head (8 heads) exits with the
    JAX CLI's message before the index is read or a model built; so does a
    model axis that one process cannot hold."""
    from asltpu_torch import api

    def no_build(*a, **k):
        raise AssertionError("the model was built")

    monkeypatch.setattr(api, "build_trainable", no_build)
    missing = str(tmp_path / "no_such_index.json")
    argv = ["train", "--device", "cpu", "--index", missing, "--videos", str(tmp_path)]
    with pytest.raises(SystemExit, match="error: --model-parallel: num_heads=8 not "
                                         "divisible by model_parallel=3"):
        main(argv + ["--model", "resnet_transformer", "--model-parallel", "3"])
    with pytest.raises(SystemExit, match="error: --model-parallel: 1 devices not "
                                         "divisible by model_parallel=2"):
        main(argv + ["--model", "resnet_transformer", "--model-parallel", "2"])


def test_cli_model_parallel_guard_reads_the_fields_each_config_has(tmp_path):
    """The two_stream config has heads and no ``mlp_ratio`` (its MLPs stay
    whole): the guard checks its heads and reads no ``mlp_ratio``, which the
    JAX CLI's guard does (``asltpu/cli/main.py:342-344``). The port's own
    transformers have heads and no ``d_model`` and no placement: each is
    refused by name, not with an ``AttributeError``."""
    import asltpu.config as jconfig

    assert not hasattr(jconfig.TwoStreamFusionConfig(), "mlp_ratio")
    argv = ["train", "--device", "cpu", "--model", "two_stream", "--index",
            str(tmp_path / "none.json"), "--videos", str(tmp_path)]
    with pytest.raises(SystemExit, match="RGB clips only"):
        main(argv + ["--model-parallel", "2"])
    with pytest.raises(SystemExit, match="num_heads=8 not divisible by model_parallel=3"):
        main(argv + ["--model-parallel", "3"])
    for name in ("timesformer", "video_swin", "mvit_v2"):
        argv[argv.index("--model") + 1] = name
        with pytest.raises(SystemExit, match=f"error: --model-parallel: tensor parallelism "
                                             f"does not shard {name}:"):
            main(argv + ["--model-parallel", "2"])


def test_cli_train_model_parallel_under_torchrun(tmp_path, tiny_wlasl_module):
    """``python -m torch.distributed.run --nproc-per-node 2 -m
    asltpu_torch.cli train --model resnet_transformer --model-parallel 2
    --dist-backend gloo`` at tiny shapes: a fault at step 3, then the rerun
    resumes from the step-2 checkpoint rank 0 wrote (whole tensors, the
    single-device layout) and ends at step 4."""
    index, videos = tiny_wlasl_module
    ck = tmp_path / "ck"
    argv = [sys.executable, "-m", "torch.distributed.run", "--standalone",
            "--nproc-per-node", "2", "-m", "asltpu_torch.cli", "train", "--device", "cpu",
            "--model", "resnet_transformer", "--num-classes", "6",
            "--set", "d_model=32", "--set", "num_heads=4", "--set", "num_tx_layers=1",
            "--model-parallel", "2", "--dist-backend", "gloo",
            "--index", index, "--videos", videos, "--batch", "4", "--steps", "4",
            "--warmup", "1", "--log-every", "1", "--ckpt-dir", str(ck), "--ckpt-every", "2",
            "--frames", "2", "--crop", "32", "--no-augment"]
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    cut = subprocess.run(argv + ["--fault-inject-step", "3"], env=env, capture_output=True,
                         text=True, timeout=120)
    assert cut.returncode != 0 and "FaultInjected" in cut.stderr, cut.stderr[-3000:]
    assert sorted(os.listdir(ck)) == ["2"]
    done = subprocess.run(argv, env=env, capture_output=True, text=True, timeout=120)
    assert done.returncode == 0, done.stderr[-3000:]
    assert sorted(d for d in os.listdir(ck) if d.isdigit()) == ["2", "4"]
    from asltpu_torch import ckpt

    sd = ckpt.load_trained_state_dict(str(ck))
    assert sd["head.layers.0.mlp1.weight"].shape == (128, 32)
    assert sd["head.layers.0.attn.in_proj_weight"].shape == (96, 32)
