"""The cell ``mvit_v2_b.finetune_b8``: its reference against the program's
leaves and its operation count at the published size, its readers without
spans, and the cell at a tiny size on the CPU (4 frames of 32² staged at
40², widths 16 and 32 with heads of 16, 3 blocks with a q-strided
transition, k/v at the adaptive stride (1, 2, 2), 10 classes, float32,
stochastic depth 0.5): a sound run is correct, the float8 control fails a
limit, and so does each planted training fault."""

import copy
import time
import types

import pytest
import torch

from perfbench.core import harness
from perfbench.core import trace as tr
from perfbench.reference import mvit as ref
from perfbench.tools import faults

NAME = "mvit_v2_b.finetune_b8"
READERS = ("pool_attn_ms.mvit", "pool_ms.mvit", "rel_pos_ms.mvit", "pool_attn_roofline.mvit")


def tiny():
    cell, config = (copy.deepcopy(x) for x in harness.cell_files(NAME))
    cell["mix"]["params"].update(batch=2, trace_s=0.5)
    config.update(num_classes=10, num_frames=4, embed_dim=16, depth=3, dim_mul=[[1, 2.0]],
                  head_mul=[[1, 2.0]], pool_q_stride=[[0, 1, 1, 1], [1, 1, 2, 2], [2, 1, 1, 1]],
                  pool_kv_stride_adaptive=[1, 2, 2], drop_path_rate=0.5, compute_dtype="float32")
    config["preprocess"].update(num_frames=4, staging_size=[40, 40], resize_short=40, crop=32,
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


def test_the_reference_names_the_programs_leaves():
    """``param_specs`` at the configuration's own size lists the program's
    ``state_dict``, key for key and shape for shape, in its order."""
    from asltpu_torch import api
    from perfbench.core import weights

    _, config = harness.cell_files(NAME)
    with torch.device("meta"):
        model = api.build_module(api.get_config(config["model"],
                                                **weights.port_overrides(config["model"], config)))
    state = model.state_dict()
    specs = ref.param_specs(config)
    assert list(state) == [n for n, *_ in specs]
    assert all(tuple(state[n].shape) == tuple(s) for n, s, *_ in specs)


def test_the_counted_operations_are_a_hand_count_at_the_published_size():
    """``pool_attn_flops`` at batch 8 against the sum written out block by
    block from the published geometry (q and k/v grids, heads of 96)."""
    _, config = harness.cell_files(NAME)
    # (dim, dim_out, heads, input grid side, q side, k/v side) a block;
    # every grid is 16 frames deep.
    shapes = ([(96, 96, 1, 56, 56, 7)] * 2 + [(96, 192, 2, 56, 28, 14)]
              + [(192, 192, 2, 28, 28, 7)] * 2 + [(192, 384, 4, 28, 14, 14)]
              + [(384, 384, 4, 14, 14, 7)] * 15 + [(384, 768, 8, 14, 7, 14)]
              + [(768, 768, 8, 7, 7, 7)] * 2)
    total = 0
    for dim, dim_out, heads, n, q, kv in shapes:
        l_in, lq, lk = 1 + 16 * n * n, 1 + 16 * q * q, 1 + 16 * kv * kv
        macs = (8 * l_in * dim * 3 * dim_out                  # qkv
                + 8 * (lq - 1 + 2 * (lk - 1)) * dim_out * 27   # the three pools
                + 2 * 8 * lq * lk * dim_out                    # q·kᵀ and the weighted sum
                + 8 * (lq - 1) * (16 + 2 * kv) * dim_out       # the three rel-pos products
                + 8 * lq * dim_out * dim_out                   # proj
                + (8 * l_in * dim * dim_out if dim != dim_out else 0))
        total += 3 * 2 * macs
    assert ref.pool_attn_flops(config, 8) == total
    assert 6.0e12 < total < 7.0e12


def test_the_readers_read_nothing_without_the_spans():
    """A traced slice with kernels but no ``mvit.*`` range: every new reader
    returns None."""
    cell, config = harness.cell_files(NAME)
    scope = {"ph": "X", "cat": "user_annotation", "name": tr.SLICE, "ts": 1000, "dur": 10000,
             "pid": 1, "tid": 1, "args": {}}
    launch = {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 2000,
              "dur": 3, "pid": 1, "tid": 1, "args": {"correlation": 1}}
    kernel = {"ph": "X", "cat": "kernel", "name": "k", "ts": 2010, "dur": 1000, "pid": 1,
              "tid": 7, "args": {"correlation": 1}}
    ctx = types.SimpleNamespace(config=config, params=cell["mix"]["params"])
    run_ = harness.Run(ctx=ctx, outcome=harness.Outcome(
        e2e={}, attempted=0, failed=0, checks={}, counters={"steps_in_slice": 1},
        memory_peak_bytes=0, trace=tr.Trace([scope, launch, kernel])))
    metrics = [m for m in harness.manifest()["per_layer"] if m["name"] in READERS]
    assert len(metrics) == len(READERS)
    assert harness.read_per_layer(run_, metrics) == {}


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
