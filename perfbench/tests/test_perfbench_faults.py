"""A run whose timed path is broken underneath comes out not correct: the
harness's look for a card is skipped and the rest of a run is driven at a
tiny size on the CPU, once for each fault a cell can have
(``perfbench/tools/faults.py``; one card, so no exchange between cards to
leave out). The sound run beside them comes out correct."""

import time

import pytest

from perfbench.core import harness
from perfbench.tests.sizes import tiny
from perfbench.tools import faults


def run(name, seed=7):
    cell, config = tiny(name)
    try:
        res, _, _ = harness.run_cell(name, seed, 1.0, False, time.perf_counter(),
                                     device="cpu", cell=cell, config=config)
    finally:
        harness.stop_children()
    return res


CELLS = ["mobilenet_gru.mp4_480p", "mobilenet_gru.serve_poisson", "i3d.finetune_b48"]


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(name):
    assert run(name)["correct"]


@pytest.mark.parametrize("name,fault",
                         [(n, f) for n in CELLS[:2] for f in faults.INFERENCE]
                         + [(CELLS[2], f) for f in faults.TRAINING])
def test_a_planted_fault_is_not_correct(name, fault):
    cell, _ = harness.cell_files(name)
    with faults.planted(cell["mix"]["driver"], fault):
        res = run(name)
    assert not res["correct"]
    assert any(c["value"] > c["limit"] for c in res["checks"].values())
