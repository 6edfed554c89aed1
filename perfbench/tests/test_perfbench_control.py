"""The control of each cell — the reference in float8 put in the program's
place — comes out as not correct: at a tiny size on the CPU, one of the
cell's compared numbers lies above its limit (the readings at the cells'
own sizes on the card are in PERF.md)."""

import pytest
import torch

from perfbench.core import harness
from perfbench.tests.sizes import tiny

CELLS = ["mobilenet_gru.mp4_480p", "mobilenet_gru.serve_poisson", "i3d.finetune_b48"]


@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_a_limit(tmp_path, name):
    cell, config = tiny(name)
    ctx = harness.Context(name, cell, config, 5, 1.0, False, torch.device("cpu"),
                          harness.SetupClock(0.0), str(tmp_path))
    try:
        numbers = harness.driver(cell["mix"]["driver"]).control(ctx, "fp8")
    finally:
        harness.stop_children()
    assert any(numbers[k] > limit for k, limit in cell["limits"].items()), numbers
