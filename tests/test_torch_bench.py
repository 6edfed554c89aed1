"""The port's bench at tiny shapes on the CPU: every cell's keys, the mp4
parts where OpenCV is present (it is here), what it reports without
OpenCV, and that it refuses to run without a card unless asked."""

import json

import pytest
import torch

from asltpu_torch import benchmark, native

TINY = ["--device", "cpu", "--batch", "2", "--frames", "2", "--staging", "40",
        "--crop", "32", "--clip-size", "48", "--clip-frames", "8",
        "--stream-batches", "4", "--windows", "2", "--decode-workers", "1",
        "--corpus-clips", "3", "--mp4-batches", "2", "--no-realistic-corpus"]
BOTH = ["--cells", "mobilenet_gru:yuv420,resnet_transformer:rgb"]
CELL_KEYS = {"family", "lane", "batch", "input", "compute_dtype", "preprocess",
             "device", "device_only", "gflops_per_clip", "stream", "corpus_s", "decode",
             "mp4_stream", "seconds"}
DEVICE_ONLY_KEYS = {"clips_per_s", "ms_per_batch", "plain_clips_per_s",
                    "plain_ms_per_batch", "kernel", "kernel_launches_per_predict",
                    "max_logit_err_vs_plain", "stage_ms", "peak_mem_gb", "timer"}
STREAM_KEYS = {"clips_per_s", "window_clips_per_s", "fill_s", "fill_clips",
               "overall_clips_per_s", "windowed_batches", "clips"}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the tiny shapes gain nothing from more, and a
    parallel test run shares the host's cores between its workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_bench_on_cpu_both_families(capsys):
    assert benchmark.main(TINY + BOTH) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["card"]["platform"] == "cpu"
    cells = {(c["family"], c["lane"]): c for c in line["cells"]}
    assert set(cells) == {("mobilenet_gru", "yuv420"), ("resnet_transformer", "rgb")}
    for (family, lane), cell in cells.items():
        assert set(cell) == CELL_KEYS, family  # no mfu off the card
        only = cell["device_only"]
        assert set(only) == DEVICE_ONLY_KEYS
        assert only["kernel"] == benchmark.KERNELS[lane]
        assert only["kernel_launches_per_predict"] == 0  # CPU tensors take the plain path
        assert only["timer"] == "host clock (cpu)" and only["peak_mem_gb"] is None
        assert set(only["stage_ms"]) == {"preprocess", "backbone", "head"}
        assert only["clips_per_s"] > 0 and only["max_logit_err_vs_plain"] < 1e-2
        assert cell["gflops_per_clip"] > 0
        assert STREAM_KEYS <= set(cell["stream"]) and cell["stream"]["clips"] == 8
        assert cell["stream"]["top1_equal_predict"] is True
        decode = cell["decode"]
        assert decode["ran"] is True
        assert set(decode["process"]["clips_per_s_by_workers"]) == {"1"}
        for row in ("native", "av", "av_fast"):  # the toolchains are here
            assert decode[row]["ran"] is True and decode[row]["clips_per_s"] > 0
        assert decode["av_fast"]["fast_flags"] == native.FAST_ALL
        mp4 = cell["mp4_stream"]
        assert mp4["ran"] is True and mp4["workers"] == 1
        for backend, chosen in (("auto", "native"), ("process", "process")):
            assert mp4[backend]["backend"] == chosen
            assert mp4[backend]["top1_equal_predict"] is True
            assert mp4[backend]["clips"] == 4 and mp4[backend]["fill_clips"] == 2
    # ResNet-18 does more work per clip than MobileNetV2 at the same shapes.
    assert (cells[("resnet_transformer", "rgb")]["gflops_per_clip"]
            > cells[("mobilenet_gru", "yuv420")]["gflops_per_clip"])


def test_bench_i3d_and_two_stream_cells_on_cpu(capsys):
    """The two new video cells at 8 frames (I3D's pools need T ≥ 5): the
    stages split as I3D's backbone and pooled head and as the fusion
    model's RGB backbone and fusion head; the fusion cell carries seeded
    landmarks through every part, mp4 → logits included."""
    args = TINY + ["--frames", "8", "--cells", "i3d:rgb,two_stream:rgb",
                   "--decode-workers", "1"]
    assert benchmark.main(args) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    cells = {c["family"]: c for c in line["cells"]}
    assert set(cells) == {"i3d", "two_stream"}
    assert set(cells["i3d"]) == CELL_KEYS
    assert set(cells["two_stream"]) == CELL_KEYS | {"landmarks_input"}
    assert cells["two_stream"]["landmarks_input"] == [2, 8, 543, 3]
    for family, cell in cells.items():
        assert cell["input"] == [2, 8, 40, 40, 3]
        only = cell["device_only"]
        assert set(only) == DEVICE_ONLY_KEYS and only["kernel"] == "preprocess_rgb"
        assert set(only["stage_ms"]) == {"preprocess", "backbone", "head"}
        assert only["kernel_launches_per_predict"] == 0 and only["clips_per_s"] > 0
        assert cell["stream"]["clips"] == 8 and cell["stream"]["top1_equal_predict"]
        for backend in ("auto", "process"):
            assert cell["mp4_stream"][backend]["top1_equal_predict"] is True
            assert cell["mp4_stream"][backend]["clips"] == 4
    # I3D's 3D convs do more work per clip than MobileNetV2 over the frames.
    assert cells["i3d"]["gflops_per_clip"] > cells["two_stream"]["gflops_per_clip"] > 0


def test_bench_pose_cell_on_cpu(capsys):
    """The pose cell: no preprocess kernel, device-only and host-staged
    stream clips/s, its FLOPs counted from the shapes."""
    assert benchmark.main(["--device", "cpu", "--batch", "4", "--frames", "3",
                           "--stream-batches", "3", "--windows", "2",
                           "--cells", "pose_bilstm:landmarks"]) == 0
    (cell,) = json.loads(capsys.readouterr().out.strip().splitlines()[-1])["cells"]
    assert set(cell) == {"family", "lane", "batch", "input", "compute_dtype", "device",
                         "device_only", "gflops_per_clip", "stream", "seconds"}
    assert cell["input"] == [4, 3, 543, 3] and cell["compute_dtype"] == "float32"
    only = cell["device_only"]
    assert only["kernel"] is None and only["kernel_launches_per_predict"] == 0
    assert only["clips_per_s"] > 0 and only["timer"] == "host clock (cpu)"
    assert STREAM_KEYS <= set(cell["stream"]) and cell["stream"]["clips"] == 12
    assert cell["stream"]["top1_equal_predict"] is True
    # 2 layers × 2 directions × 3 steps × 4·256·(F + 256), F = 1629 then 512,
    # plus the 512 × 100 classifier, two operations per multiply-add.
    macs = 2 * 3 * 1024 * ((1629 + 256) + (512 + 256)) + 512 * 100
    assert cell["gflops_per_clip"] == pytest.approx(2 * macs / 1e9)


def test_bench_native_row_without_its_toolchain(monkeypatch, capsys):
    """A native library whose toolchain is missing is reported as not run,
    naming what is missing; the other backends still run."""
    monkeypatch.setattr(native, "toolchain_missing",
                        lambda lib: "header not found: /x.h" if lib == "av" else None)
    line = benchmark.run(TINY + ["--cells", "mobilenet_gru:rgb", "--mp4-batches", "2"])
    (cell,) = line["cells"]
    assert cell["decode"]["av"] == cell["decode"]["av_fast"] == {
        "ran": False, "why": "header not found: /x.h"}
    assert cell["decode"]["native"]["ran"] is True


def test_bench_without_opencv_reports_the_mp4_parts_not_run(monkeypatch):
    monkeypatch.setattr(benchmark, "_cv2_missing", lambda: "no cv2 in this test")
    line = benchmark.run(TINY + ["--cells", "mobilenet_gru:rgb", "--stream-batches", "2"])
    (cell,) = line["cells"]
    assert cell["decode"] == cell["mp4_stream"] == {"ran": False,
                                                    "why": "no cv2 in this test"}
    assert cell["stream"]["clips"] == 4


def test_bench_needs_a_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        benchmark.main(["--cells", "mobilenet_gru:rgb"])


def test_stream_windows():
    """Windows split the batches after the fill; the median window rate is
    the stream's."""
    events = [(2.0, 4), (3.0, 4), (5.0, 4), (6.0, 4)]
    out = benchmark._windows(0.0, 1.0, events, 2, fill_clips=4)
    assert out["window_clips_per_s"] == [4.0, 8 / 3]
    assert out["clips_per_s"] == pytest.approx((4.0 + 8 / 3) / 2)
    assert out["fill_s"] == 1.0 and out["clips"] == 20
    assert out["overall_clips_per_s"] == pytest.approx(20 / 6)


def test_bench_i3d_train_cell_on_cpu(capsys):
    """The train cell's two configurations (the JAX bench's, remat off, and
    the default, remat on) at 8 frames on the CPU: each its own result, the
    same forward + backward FLOPs per clip, the recompute counted apart (the
    Inception blocks' forward, so less than a third of the step), no kernel
    launch on CPU tensors, no MFU off the card."""
    args = ["--device", "cpu", "--batch", "2", "--frames", "8", "--staging", "40",
            "--crop", "32", "--cells", "i3d:train"]
    assert benchmark.main(args) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    cells = line["cells"]
    assert [(c["config"], c["remat"]) for c in cells] == [("jax_bench", False),
                                                          ("default", True)]
    for cell in cells:
        assert cell["family"] == "i3d" and cell["lane"] == "train" and "mfu" not in cell
        assert cell["input"] == [2, 8, 40, 40, 3] and cell["compute_dtype"] == "bfloat16"
        assert cell["kernel_launches_per_step"] == 0 and cell["timer"] == "host clock (cpu)"
        assert cell["steps_per_s"] > 0 and cell["clips_per_s"] == 2 * cell["steps_per_s"]
        assert 0 < cell["recompute_gflops_per_clip"] < cell["gflops_per_clip"] / 3
    assert cells[0]["gflops_per_clip"] == cells[1]["gflops_per_clip"]


def test_train_gflops_counts_a_grouped_conv_weight_gradient_per_group():
    """A depthwise conv's backward does twice its forward's operations
    (input and weight gradients); torch's own formula counts the weight
    gradient as a dense conv's, ``groups`` times too many."""
    from torch.utils.flop_counter import FlopCounterMode

    conv = torch.nn.Conv2d(8, 8, 3, padding=1, groups=8, bias=False)
    x = torch.randn(2, 8, 6, 6, requires_grad=True)
    with FlopCounterMode(display=False) as fwd:
        conv(x)

    def step(state, batch_in, labels):
        conv(batch_in).sum().backward()

    assert benchmark.train_gflops(None, step, x, None) * 1e9 == 3 * fwd.get_total_flops()
    with FlopCounterMode(display=False) as torch_count:
        step(None, x, None)
    assert torch_count.get_total_flops() == (2 + 8) * fwd.get_total_flops()


def test_serve_points_on_cpu():
    """The serving part of the mobilenet_gru/rgb cell on a tiny model: three
    closed-loop points with their keys, each client's rounds all timed,
    one request a batch at concurrency 1; ``--no-serve`` turns it off."""
    import numpy as np

    from asltpu_torch import api

    model = api.load_model("mobilenet_gru", device="cpu", num_classes=5, gru_hidden=8,
                           width_mult=0.35, preprocess={"num_frames": 2,
                                                        "staging_size": (40, 40),
                                                        "resize_short": 32, "crop": 32})
    clip = np.random.default_rng(0).integers(0, 256, (2, 40, 40, 3), np.uint8)
    out = benchmark.serve_curve(model, clip, batch=8)
    assert out["batch_buckets"] == [1, 4, 8] and out["max_batch"] == 8
    for prefix, clients, rounds in (("serve_c1_", 1, 8), ("serve_c4_", 4, 8),
                                    ("serve_", 8, 4)):
        assert {prefix + k for k in ("clips_per_sec", "p50_ms", "p99_ms", "avg_batch",
                                     "requests", "concurrency", "max_delay_ms")} <= set(out)
        assert out[prefix + "requests"] == clients * rounds
        assert out[prefix + "concurrency"] == clients
        assert 0 < out[prefix + "p50_ms"] <= out[prefix + "p99_ms"]
        assert out[prefix + "clips_per_sec"] > 0 and out[prefix + "avg_batch"] >= 1.0
    assert out["serve_c1_avg_batch"] == 1.0
    assert benchmark.parse_args(["--no-serve"]).serve is False
    assert benchmark.parse_args([]).serve is True
