"""The port bench's end-to-end discipline on the CPU, against the JAX
bench's where both compute the same thing: ``poisoned_sample`` on the JAX
unit tests' cases and a seeded table, the decode-fast gate on the same
files and weights; ``make_corpus`` at (H, W); the 640×480 block at 48×64
on both ``mobilenet_gru`` lanes (a narrow model, ``--device cpu``); the
retry of a poisoned stream; ``--trace``; ``--decode-fast`` without libav;
the CLI's flags. Toolchains are looked up inside the tests."""

import concurrent.futures
import contextlib
import glob
import os

import cv2
import numpy as np
import pytest
import torch

from asltpu import benchmark as jbench
from asltpu_torch import api, benchmark, native
from asltpu_torch.data.decode import make_decode_pool

# tests/unit/test_benchmark.py:11-56: (windows, median, reference rates).
UNIT_CASES = [
    ([90.0, 100.0, 95.0], 95.0, {"decode_sel_av_clips_per_sec": 110.0}),
    ([5.3, 5.7, 118.9], 5.7, {}),
    ([3.6, 4.3], 3.95, {"decode_sel_av_clips_per_sec": 100.0}),
    ([3.6, 4.3], 3.95, {}),
    ([3.6, 4.3], 3.95, {"decode_sel_av_clips_per_sec": None,
                        "decode_sel_native_clips_per_sec": 100.0}),
    ([], 0.0, {"decode_sel_av_clips_per_sec": 100.0}),
    ([40.0, 45.0, 42.0], 42.0, {"decode_sel_av_clips_per_sec": 100.0}),
]


def _seeded_cases(n=24, seed=0):
    """Random windows, medians and reference rates (some None, some
    missing) from a seed."""
    rng = np.random.default_rng(seed)
    cases = []
    for i in range(n):
        win = [float(x) for x in rng.uniform(1, 150, int(rng.integers(0, 5)))]
        e2e = float(np.median(win)) if win and i % 2 else float(rng.uniform(0, 150))
        sel = {f"r{j}": None if rng.random() < 0.25 else float(rng.uniform(0, 400))
               for j in range(int(rng.integers(0, 4)))}
        cases.append((win, e2e, sel))
    return cases


CASES = UNIT_CASES + _seeded_cases()
WINDOWS, BATCH, WORKERS = 2, 2, 1
REALISTIC = ["--device", "cpu", "--batch", str(BATCH), "--frames", "2", "--staging", "40",
             "--crop", "32", "--clip-size", "48", "--clip-frames", "8",
             "--stream-batches", "2", "--windows", str(WINDOWS),
             "--decode-workers", str(WORKERS), "--corpus-clips", "3", "--mp4-batches", "2",
             "--no-serve", "--realistic-size", "48x64"]
NARROW = dict(width_mult=0.35, gru_hidden=8)
REALISTIC_KEYS = {"ran", "clip", "workers", "decode_only", "scaling", "decode_fast_gate",
                  "mp4_stream", "mp4_stream_fast", "seconds"}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the narrow models gain nothing from more, and
    a parallel test run shares the host's cores between its workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("win,e2e,sel", CASES)
def test_poisoned_sample_matches_jax(win, e2e, sel):
    assert benchmark.poisoned_sample(win, e2e, sel) == jbench.poisoned_sample(win, e2e, sel)


def test_poisoned_cases_reach_every_verdict():
    assert {jbench.poisoned_sample(*c) for c in CASES} == {
        None, "bimodal_windows", "uniform_starvation"}


def test_make_corpus_writes_h_by_w(tmp_path):
    with concurrent.futures.ThreadPoolExecutor(2) as writers:
        paths = benchmark.make_corpus(writers, str(tmp_path), "c", 3, 7, (48, 64), 8)
        corpus = benchmark.Corpus(writers, str(tmp_path), 8, seed=5)
        corpus("a", 2, (48, 64))
        corpus("b", 1, (32, 32))
    assert corpus.seed == 8  # each file a seed of its own
    for p in paths:
        cap = cv2.VideoCapture(p)
        assert (cap.get(cv2.CAP_PROP_FRAME_HEIGHT), cap.get(cv2.CAP_PROP_FRAME_WIDTH),
                cap.get(cv2.CAP_PROP_FRAME_COUNT)) == (48, 64, 8)
        cap.release()
    assert len({open(p, "rb").read() for p in paths}) == 3


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The realistic block on both lanes in one run with ``--trace``: rgb
    with every toolchain of this host, yuv420 with libav's taken away. The
    corpus writers are threads: files this small need no processes."""
    trace = str(tmp_path_factory.mktemp("trace"))
    real_load, real_cell, real_missing = api.load_model, benchmark.bench_cell, \
        native.toolchain_missing
    lane_now = []

    def bench_cell(family, lane, *args, **kw):
        lane_now[:] = [lane]
        return real_cell(family, lane, *args, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(benchmark.api, "load_model",
                   lambda name, **kw: real_load(name, **NARROW, **kw))
        mp.setattr(concurrent.futures, "ProcessPoolExecutor",
                   lambda n, mp_context=None: concurrent.futures.ThreadPoolExecutor(n))
        mp.setattr(benchmark, "bench_cell", bench_cell)
        mp.setattr(native, "toolchain_missing",
                   lambda lib: "header not found: /x.h" if lib == "av" and lane_now == ["yuv420"]
                   else real_missing(lib))
        cells = benchmark.run(REALISTIC + ["--trace", trace, "--cells",
                                           "mobilenet_gru:rgb,mobilenet_gru:yuv420"])["cells"]
    return {c["lane"]: (c, trace) for c in cells}


@pytest.mark.parametrize("lane", ["rgb", "yuv420"])
def test_realistic_block_keys(runs, lane):
    cell, _ = runs[lane]
    real = cell["realistic"]
    assert set(real) == REALISTIC_KEYS and real["ran"] is True
    assert real["clip"] == {"size": [48, 64], "frames": 8} and real["workers"] == WORKERS
    decode = real["decode_only"]
    assert decode["clips"] == benchmark.REALISTIC_DECODE_CLIPS
    assert set(decode["process"]["clips_per_s_by_workers"]) == {str(WORKERS)}
    assert decode["native"]["ran"] is True and decode["native"]["clips_per_s"] > 0
    scaling = real["scaling"]
    assert scaling["clips"] == benchmark.SCALING_CLIPS and scaling["backend"] == "process"
    assert scaling["device_rate_clips_per_s"] == cell["device_only"]["clips_per_s"]
    assert scaling["fit"] == "min(workers * r1, device_rate)"


@pytest.mark.parametrize("lane", ["rgb", "yuv420"])
def test_realistic_stream_gives_predicts_top1(runs, lane):
    stream = runs[lane][0]["realistic"]["mp4_stream"]
    assert stream["top1_equal_predict"] is True and stream["backend"] == "native"
    # The fill batch and one batch a window: 1 + --windows predicts.
    assert stream["predict_calls"] == 1 + WINDOWS and stream["windowed_batches"] == WINDOWS
    assert stream["clips"] == (1 + WINDOWS) * BATCH and stream["fill_clips"] == BATCH
    assert stream["kernel"] == benchmark.KERNELS[lane]
    assert stream["kernel_launches"] == 0  # CPU tensors take the plain path
    assert "retry_trigger" not in stream  # no reference rate on the CPU, 2 windows


@pytest.mark.parametrize("windows,batch,workers", [(2, 2, 1), (3, 32, 4), (5, 8, 2)])
def test_realistic_corpus_holds_the_fill_and_the_windows(windows, batch, workers):
    opts = benchmark.parse_args(["--windows", str(windows), "--decode-workers",
                                 f"1,{workers}", "--realistic-size", "48x64"])
    plan = benchmark._plan_corpora("mobilenet_gru", "rgb", batch, opts, realistic=True)
    assert plan["r_mp4"] == ((1 + windows) * batch, (48, 64))
    assert plan["r_decode_w" + str(workers)][0] == benchmark.REALISTIC_DECODE_CLIPS
    assert plan["r_scaling_w1"][0] == benchmark.SCALING_CLIPS
    assert plan["warm"] == (workers, (opts.clip_size,) * 2)
    assert not any(k.startswith("r_") for k in benchmark._plan_corpora(
        "mobilenet_gru", "rgb", batch, opts, realistic=False))


def test_rows_not_run_where_libav_is_missing(runs):
    cell, _ = runs["yuv420"]
    real = cell["realistic"]
    why = {"ran": False, "why": "header not found: /x.h"}
    assert real["decode_only"]["av"] == real["decode_only"]["av_fast"] == why
    assert real["mp4_stream_fast"] == real["decode_fast_gate"] == why
    assert cell["mp4_stream"]["av"] == why and cell["decode"]["av"] == why


def test_gate_and_fast_stream_where_libav_builds(runs):
    cell, _ = runs["rgb"]
    gate = cell["realistic"]["decode_fast_gate"]
    assert gate["ran"] is True and gate["clips"] == benchmark.GATE_CLIPS
    assert gate["promoted"] == (gate["verdict"] == "promoted")
    assert 0 <= gate["top1_match"] <= 1 and gate["rel_logit_delta"] >= 0
    # A promoted gate puts the cell's av stream on FAST_ALL.
    av = cell["mp4_stream"]["av"]
    assert av["backend"] == "av"
    assert av["fast_flags"] == (native.FAST_ALL if gate["promoted"] else 0)
    fast = cell["realistic"]["mp4_stream_fast"]
    assert fast["backend"] == "av" and fast["fast_flags"] == native.FAST_ALL
    assert fast["max_logit_err_vs_predict"] >= 0  # against the exact decode


@pytest.mark.parametrize("lane,rows", [
    ("rgb", {"mp4_auto", "mp4_process", "mp4_av", "realistic_mp4", "realistic_mp4_fast"}),
    ("yuv420", {"mp4_auto", "mp4_process", "realistic_mp4"}),
])
def test_trace_captures_each_timed_stream_once(runs, lane, rows):
    cell, trace = runs[lane]
    trace = os.path.join(trace, f"mobilenet_gru_{lane}")
    files = glob.glob(os.path.join(trace, "**", "*.pt.trace.json"), recursive=True)
    # One capture per timed stream, none of the pools' warm-up.
    assert sorted(os.path.relpath(os.path.dirname(f), trace) for f in files) == sorted(
        os.path.join(row, "attempt1") for row in rows)
    streams = [r for r in cell["mp4_stream"].values() if isinstance(r, dict) and r.get("ran", 1)]
    streams += [r for k, r in cell["realistic"].items()
                if k.startswith("mp4_stream") and r.get("ran", 1)]
    assert sorted(r["trace"]["file"] for r in streams) == sorted(files)
    for r in streams:
        assert r["trace"]["span_ms"] > 0 and r["trace"]["busy_share"] is None  # no card


def test_scaling_fit_arithmetic():
    fit = benchmark.scaling_fit({"1": 10.0, "2": 18.0, "4": 30.0}, 35.0)
    assert fit["r1_clips_per_s_per_worker"] == 10.0 and fit["r1_from_workers"] == 1
    assert fit["fit_clips_per_s_by_workers"] == {"1": 10.0, "2": 20.0, "4": 35.0}
    assert fit["projected_workers_for_device_rate"] == 4
    fit = benchmark.scaling_fit({"4": 30.0, "2": 18.0}, 1500.0)
    assert fit["r1_clips_per_s_per_worker"] == 9.0 and fit["r1_from_workers"] == 2
    assert fit["projected_workers_for_device_rate"] == 167


@pytest.mark.parametrize("trigger,windows,sel", [
    ("bimodal_windows", [1.0, 1.0, 100.0], {}),
    ("uniform_starvation", [5.0, 5.0, 5.0], {"process_4": 1e6, "native": None}),
])
def test_poisoned_stream_retries_once_on_a_fresh_corpus(tmp_path, monkeypatch, trigger,
                                                        windows, sel):
    """The first attempt's windows forced poisoned: one more stream on a
    fresh corpus of the same size (after the host probe for starvation),
    whose result stands, both attempts reported and captured."""
    model = api.load_model("mobilenet_gru", device="cpu", **NARROW,
                           preprocess={"num_frames": 2, "staging_size": (40, 40),
                                       "resize_short": 32, "crop": 32})
    real_windows = benchmark._windows
    streams = []

    def forced(*args, **kw):
        out = real_windows(*args, **kw)
        if not streams[1:]:
            out.update(window_clips_per_s=windows, clips_per_s=float(np.median(windows)))
        return out

    real_stream = api.stream_predict

    def recorded(m, paths, **kw):
        streams.append(list(paths))
        return real_stream(m, paths, **kw)

    monkeypatch.setattr(benchmark, "_windows", forced)
    monkeypatch.setattr(api, "stream_predict", recorded)
    monkeypatch.setattr(benchmark, "RECOVERY_PROBE_S", 1.0)
    monkeypatch.setattr(benchmark, "RECOVERY_SLEEP_S", 0.0)
    trace = str(tmp_path / "trace")
    with concurrent.futures.ThreadPoolExecutor(2) as writers:
        corpus = benchmark.Corpus(writers, str(tmp_path), 8)
        paths = corpus("s_", 3 * 2, (48, 64))
        pool = make_decode_pool(model.cfg.preprocess, num_workers=1, backend="native")
        try:
            row = benchmark.mp4_row(model, pool, paths, 2, 3, sel, corpus, "s_", (48, 64),
                                    trace)
        finally:
            pool.shutdown()
    assert row["retry_trigger"] == trigger and row["first_attempt_windows"] == windows
    assert len(streams) == 2 and streams[0] == paths
    assert len(streams[1]) == 6 and not set(streams[1]) & set(paths)
    assert all(os.path.basename(p).startswith("s_retry_") for p in streams[1])
    assert row["window_clips_per_s"] != windows and row["top1_equal_predict"] is True
    assert ("retry_host_probe_clips_per_s" in row) == (trigger == "uniform_starvation")
    assert sorted(os.listdir(trace)) == ["attempt1", "attempt2"]


def test_decode_fast_without_libav_fails_before_measuring(monkeypatch):
    def no_model(*a, **k):
        raise AssertionError("measured before refusing --decode-fast")

    monkeypatch.setattr(native, "av_available", lambda: False)
    monkeypatch.setattr(native, "av_unavailable_reason", lambda: "header not found: /x.h")
    monkeypatch.setattr(benchmark.api, "load_model", no_model)
    with pytest.raises(SystemExit) as e:
        benchmark.main(["--device", "cpu", "--decode-fast", "--cells", "mobilenet_gru:rgb"])
    assert e.value.code == 2


def test_decode_fast_gate_matches_jax(tmp_path):
    """The same tiny files and fp32 weights through both gates: the same
    verdict, top-1 match and clip count, relative logit gaps within 1e-2."""
    from asltpu import native as jnative
    from test_torch_serve import RGB, model_pair

    if not (native.av_available() and jnative.av_available()):
        pytest.skip(f"libav does not build here: {native.av_unavailable_reason()}")
    jm, tm = model_pair("mobilenet_gru", RGB)
    with concurrent.futures.ThreadPoolExecutor(2) as writers:
        paths = benchmark.make_corpus(writers, str(tmp_path), "g", 8, 40, (96, 128), 12)
    with contextlib.closing(benchmark.CellPools(tm.cfg.preprocess, paths[6:])) as pools:
        port = benchmark.decode_fast_gate(tm, pools, paths[:6], 4, 2)
    paths = paths[:6]
    want = jbench._decode_fast_stability_gate(jm.cfg.preprocess, jm.predict_fn(),
                                              jm.variables, paths, 4, 2, jnative.FAST_ALL)
    assert port["promoted"] == (want["decode_fast_gate"] == "promoted")
    assert port["top1_match"] == want["decode_fast_gate_top1_match"]
    assert port["clips"] == want["decode_fast_gate_clips"] == 6
    assert port["rel_logit_delta"] == pytest.approx(want["decode_fast_gate_rel_logit_delta"],
                                                    abs=1e-2)


def test_cli_bench_passes_the_new_flags(monkeypatch, capsys):
    from asltpu_torch.cli.main import main

    seen = []
    monkeypatch.setattr(benchmark, "run", lambda argv=None: seen.append(argv) or {})
    args = ["--no-realistic-corpus", "--realistic-size", "48x64", "--trace", "/t"]
    assert main(["bench", *args]) == 0
    opts = benchmark.parse_args(seen[0])
    assert (opts.realistic, opts.realistic_size, opts.trace) == (False, (48, 64), "/t")
    assert benchmark.parse_args([]).realistic is True
    assert benchmark.parse_args([]).realistic_size == (480, 640)
