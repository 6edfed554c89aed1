"""Performance-regression gates of the port, the counterpart of
``tests/bench/test_regression.py``: a decode-only floor on any platform,
and device-only and mp4 → logits floors on the card (``cuda``-marked; they
skip without one). Run the card's with

    python -m pytest tests/test_torch_cuda.py tests/test_torch_bench_regression.py \\
        -m cuda --noconftest -q

The card's floors allow the JAX gates' 30% headroom below the port's own
measurements on an NVIDIA H100 80GB HBM3 at 700.00 W (``nvidia-smi
--query-gpu=name,power.limit``), printed by these tests (``-s``). This
file imports no JAX.
"""

import concurrent.futures
import tempfile
import time

import numpy as np
import pytest
import torch

from asltpu_torch import api
from asltpu_torch.config import PreprocessConfig
from asltpu_torch.data.decode import make_decode_pool
from asltpu_torch.data.synthetic import write_video

# The JAX gate's decode-only floor on fresh 256² files (any platform): far
# below a healthy rate, so that it catches a serialized pool, not noise.
DECODE_CLIPS_PER_SEC_FLOOR = 20.0
DECODE_ATTEMPTS, DECODE_SLEEP_S = 3, 20
HEADROOM = 0.7  # the JAX gates' 30%
# Measured on an NVIDIA H100 80GB HBM3, 700.00 W: mobilenet_gru at batch 32,
# 16 × 256² staged RGB, back-to-back predicts (device-only), and the
# yuv420 lane's stream_predict over 32 fresh 256² mp4s at batch 8 on a
# started pool of 4 decode workers (mp4 → logits).
DEVICE_CLIPS_PER_SEC = 1509.30
E2E_CLIPS_PER_SEC = 114.67
YUV420 = {"staging_size": (224, 224), "resize_short": 224, "host_resize_short": 256,
          "staging_format": "yuv420"}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _corpus(root, prefix, n, seed0):
    """``n`` fresh 50-frame 256² mp4s, written by 4 threads."""
    paths = [f"{root}/{prefix}{i:03d}.mp4" for i in range(n)]
    with concurrent.futures.ThreadPoolExecutor(4) as writers:
        list(writers.map(lambda i: write_video(paths[i], num_frames=50, size=(256, 256),
                                               seed=seed0 + i), range(n)))
    return paths


def test_decode_only_floor(tmp_path):
    """The JAX gate's: the default pool (4 workers) on 16 fresh 256² files
    of the yuv420 lane, batches of 8; three attempts on fresh corpora, the
    first above the floor passes (a busy host passes on a later one, a
    structural regression fails all three)."""
    pp = PreprocessConfig(num_frames=16, **YUV420)
    rates = []
    for attempt in range(DECODE_ATTEMPTS):
        if attempt:
            time.sleep(DECODE_SLEEP_S)  # let a busy spell pass
        paths = _corpus(tmp_path, f"c{attempt}_", 16, attempt * 100)
        pool = make_decode_pool(pp, num_workers=4)
        try:
            t0 = time.perf_counter()
            n = sum(len(kept) for _, kept in pool.map_batches(paths, 8))
            rates.append(n / (time.perf_counter() - t0))
        finally:
            pool.shutdown()
        if rates[-1] > DECODE_CLIPS_PER_SEC_FLOOR:
            return
    raise AssertionError(f"decode path regressed across {DECODE_ATTEMPTS} attempts: "
                         f"{[round(r, 1) for r in rates]} clips/s")


@pytest.mark.cuda
def test_device_throughput_floor(card):
    model = api.load_model("mobilenet_gru", seed=0)
    fn = model.predict_fn()
    x = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (32, 16, 256, 256, 3), np.uint8)).to(card)
    fn(x)
    torch.cuda.synchronize()
    iters = 15
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(x)
    torch.cuda.synchronize()
    cps = iters * 32 / (time.perf_counter() - t0)
    print(f"device-only clips/s: {cps}")
    floor = HEADROOM * DEVICE_CLIPS_PER_SEC
    assert cps > floor, f"device path regressed: {cps:.0f} clips/s (floor {floor:.0f})"


@pytest.mark.cuda
def test_e2e_pipeline_floor(card):
    """mp4 → logits on the yuv420 lane: a pool of 4 workers started on 8
    clips of its own, then ``stream_predict`` over 32 fresh files at batch
    8, timed to the last logits on the host; three attempts on fresh
    corpora as the decode floor."""
    model = api.load_model("mobilenet_gru", seed=0, preprocess=YUV420)
    floor = HEADROOM * E2E_CLIPS_PER_SEC
    rates = []
    with tempfile.TemporaryDirectory() as root:
        for attempt in range(3):
            if attempt:
                time.sleep(DECODE_SLEEP_S)
            paths = _corpus(root, f"a{attempt}_", 40, 1000 * attempt)
            pool = make_decode_pool(model.cfg.preprocess, num_workers=4)
            try:
                for _ in pool.map_batches(paths[:8], 8):
                    pass
                t0 = time.perf_counter()
                n = sum(1 for _ in api.stream_predict(model, paths[8:], batch_size=8,
                                                      decode_pool=pool))
                rates.append(n / (time.perf_counter() - t0))
            finally:
                pool.shutdown()
            print(f"mp4 -> logits clips/s: {rates[-1]}")
            if rates[-1] > floor:
                return
    raise AssertionError(f"mp4 -> logits regressed across 3 attempts: "
                         f"{[round(r, 1) for r in rates]} clips/s (floor {floor:.0f})")
