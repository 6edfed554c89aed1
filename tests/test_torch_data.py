"""asltpu_torch.data beside its JAX counterparts: the synthetic videos are
the JAX package's, frame for frame and byte for byte; the prefetcher goes
to the card unless the caller asks for the CPU; a decode pool leaves no
worker behind once it is shut down."""

import multiprocessing
import os
import threading

import numpy as np
import pytest
import torch

from asltpu.data import synthetic as jsynthetic
from asltpu_torch.config import PreprocessConfig
from asltpu_torch.data import synthetic as tsynthetic
from asltpu_torch.data.decode import make_decode_pool
from asltpu_torch.data.prefetch import Prefetcher


@pytest.mark.parametrize("size,frames,seed", [((72, 96), 20, 0), ((48, 48), 7, 3)])
def test_write_video_matches_jax(tmp_path, size, frames, seed):
    want_path, got_path = str(tmp_path / "jax.mp4"), str(tmp_path / "port.mp4")
    want = jsynthetic.write_video(want_path, num_frames=frames, size=size, seed=seed)
    got = tsynthetic.write_video(got_path, num_frames=frames, size=size, seed=seed)
    assert got.dtype == np.uint8 and got.shape == (frames, *size, 3)
    np.testing.assert_array_equal(got, want)
    with open(want_path, "rb") as a, open(got_path, "rb") as b:
        assert a.read() == b.read()
    assert os.path.getsize(got_path) > 0


def test_prefetcher_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Prefetcher(iter([]))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Prefetcher(iter([]), device="cuda")
    with Prefetcher(iter([(np.zeros(2, np.uint8),)]), device="cpu") as pf:
        (x,), = list(pf)
    assert x.device.type == "cpu"


@pytest.mark.parametrize("backend", ["process", "thread"])
def test_decode_pool_shutdown_leaves_no_worker(tmp_path, backend):
    """``shutdown`` waits for the pool's workers: no decode process or
    thread outlives the pool (nor the program that started it)."""
    path = str(tmp_path / "clip.mp4")
    tsynthetic.write_video(path, num_frames=8, size=(48, 64), seed=0)
    cfg = PreprocessConfig(num_frames=2, staging_size=(48, 48), resize_short=48, crop=32)

    def workers():
        if backend == "process":
            return set(multiprocessing.active_children())
        return {t for t in threading.enumerate() if t.name.startswith("asltpu-torch-decode")}

    before = workers()
    pool = make_decode_pool(cfg, num_workers=2, backend=backend)
    clips = [f.result() for f in [pool.submit(path) for _ in range(4)]]
    assert all(c.shape == (2, 48, 48, 3) for c in clips)
    started = workers() - before
    assert started
    pool.shutdown()
    assert not [w for w in started if w.is_alive()]
