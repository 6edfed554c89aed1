"""The cell ``video_swin_b.finetune_b8`` at a tiny size on the CPU (8
frames of 32² staged at 40², width 32, heads of 16, depths (2, 2), window
4×4×4, 10 classes, float32, stochastic depth 0.5): a sound run is correct,
the float8 control fails a limit, and so does each planted training
fault."""

import copy
import time

import pytest
import torch

from perfbench.core import harness
from perfbench.tools import faults

NAME = "video_swin_b.finetune_b8"


def tiny():
    cell, config = (copy.deepcopy(x) for x in harness.cell_files(NAME))
    cell["mix"]["params"].update(batch=2, trace_s=0.5)
    config.update(num_classes=10, num_frames=8, embed_dim=32, depths=[2, 2], num_heads=[2, 4],
                  window_size=[4, 4, 4], drop_path_rate=0.5, compute_dtype="float32")
    config["preprocess"].update(num_frames=8, staging_size=[40, 40], resize_short=40, crop=32,
                                out_dtype="float32")
    return cell, config


def run(seed=7):
    cell, config = tiny()
    try:
        res, _, _ = harness.run_cell(NAME, seed, 1.0, False, time.perf_counter(),
                                     device="cpu", cell=cell, config=config)
    finally:
        harness.stop_children()
    return res


def test_a_sound_run_is_correct():
    assert run()["correct"]


def test_the_control_fails_a_limit(tmp_path):
    cell, config = tiny()
    ctx = harness.Context(NAME, cell, config, 5, 1.0, False, torch.device("cpu"),
                          harness.SetupClock(0.0), str(tmp_path))
    numbers = harness.driver("finetune").control(ctx, "fp8")
    assert any(numbers[k] > limit for k, limit in cell["limits"].items()), numbers


@pytest.mark.parametrize("fault", faults.TRAINING)
def test_a_planted_fault_is_not_correct(fault):
    with faults.planted("finetune", fault):
        res = run()
    assert not res["correct"]
    assert any(c["value"] > c["limit"] for c in res["checks"].values())
