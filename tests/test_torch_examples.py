"""The port's examples (``examples/torch_*.py``) stay runnable, as
``tests/unit/test_examples.py`` holds the JAX package's: each runs on the
CPU (``ASLTPU_EXAMPLE_FORCE_CPU``) at toy shapes (``ASLTPU_EXAMPLE_TINY``);
the two distributed ones start their own two gloo ranks."""

import os
import runpy

import pytest

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "examples")


def _run(name, monkeypatch, capsys):
    monkeypatch.setenv("ASLTPU_EXAMPLE_FORCE_CPU", "1")
    monkeypatch.setenv("ASLTPU_EXAMPLE_TINY", "1")
    runpy.run_path(os.path.join(EXAMPLES, name), run_name="__main__")
    return capsys.readouterr().out


def test_quickstart_predict(monkeypatch, capsys):
    out = _run("torch_quickstart_predict.py", monkeypatch, capsys)
    assert "predict: gloss id" in out
    assert out.count("stream:") == 4


@pytest.mark.slow
def test_train_resume(monkeypatch, capsys):
    out = _run("torch_train_resume.py", monkeypatch, capsys)
    assert "crashed at step 6" in out
    assert "finished at step 10" in out


def test_export_deploy(monkeypatch, capsys):
    out = _run("torch_export_deploy.py", monkeypatch, capsys)
    assert "artifact predict: gloss id" in out
    assert "matches live model: True" in out


def test_continuous_recognition(monkeypatch, capsys):
    out = _run("torch_continuous_recognition.py", monkeypatch, capsys)
    assert "windows: 9" in out  # 120 frames, 25-frame window, 12-frame stride
    assert "segments:" in out


def test_tensor_parallel(monkeypatch, capsys):
    out = _run("torch_tensor_parallel.py", monkeypatch, capsys)
    assert "TP logits equal replicated: True" in out
    assert "TP train step: loss" in out


def test_sharded_inference(monkeypatch, capsys):
    out = _run("torch_sharded_inference.py", monkeypatch, capsys)
    assert "mesh: 2 ranks" in out
    assert "logits (16, 100)" in out
    assert "sharded logits equal one process's: True" in out
