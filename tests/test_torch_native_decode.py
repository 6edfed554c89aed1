"""The port's native decode libraries (asltpu_torch.native) beside the cv2
path and the JAX package: the OpenCV library is byte-identical to both, the
libav one within the JAX package's bounds; the decode pools' contract, the
backend factory, and decode workers that never import torch.

Each native test skips where the port reports its library unavailable, with
the reason it gives."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

from asltpu.data import decode as jdecode
from asltpu_torch import _buildcache, native
from asltpu_torch.config import PreprocessConfig
from asltpu_torch.data import decode as tdecode
from asltpu_torch.data.decode import DecodePool, NativeDecodePool, make_decode_pool
from asltpu_torch.data.wlasl import WLASLIndex

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PP_RGB = PreprocessConfig(num_frames=4, staging_size=(64, 64))
PP_YUV = PreprocessConfig(num_frames=4, staging_size=(64, 64),
                          host_resize_short=72, staging_format="yuv420")
# host_resize_short equal to the fixture videos' short side (96): the av
# library's direct plane crop, with no resample.
PP_YUV_NOOP = PreprocessConfig(num_frames=4, staging_size=(64, 64),
                               host_resize_short=96, staging_format="yuv420")
LANES = {"rgb": PP_RGB, "yuv420": PP_YUV}
AV_MAD = 3.0        # the JAX package's bounds (tests/unit/test_decode_av.py)
AV_FAST_MAD = 8.0


@pytest.fixture
def opencv_lib():
    if not native.available():
        pytest.skip(f"native decode: {native.unavailable_reason()}")


@pytest.fixture
def av_lib():
    if not native.av_available():
        pytest.skip(f"native av decode: {native.av_unavailable_reason()}")


def _records(tiny_wlasl, n=4):
    index, videos = tiny_wlasl
    return WLASLIndex(index, videos, subset=6).split("train")[:n]


def _cv2(rec, pp, module=tdecode):
    """The Python cv2 path of ``module`` (the port's or the JAX package's)
    on one record."""
    return module.decode_sampled_frames(
        rec.path, pp.num_frames, pp.staging_size, pp.host_resize_short,
        frame_start=rec.frame_start, frame_end=rec.frame_end, bbox=rec.bbox,
        staging_format=pp.staging_format)


def _mad(a, b):
    return float(np.mean(np.abs(a.astype(np.int32) - b.astype(np.int32))))


@pytest.mark.parametrize("lane", sorted(LANES))
def test_native_pool_is_byte_identical(opencv_lib, tiny_wlasl, lane):
    """A batch of records through NativeDecodePool equals the port's cv2 path
    and the JAX package's, byte for byte."""
    pp = LANES[lane]
    recs = _records(tiny_wlasl)
    want = np.stack([_cv2(r, pp, jdecode) for r in recs])
    np.testing.assert_array_equal(np.stack([_cv2(r, pp) for r in recs]), want)
    pool = NativeDecodePool(pp, num_workers=2)
    try:
        (frames, kept), = list(pool.map_batches(recs, 4))
    finally:
        pool.shutdown()
    assert kept == [0, 1, 2, 3] and frames.dtype == np.uint8
    np.testing.assert_array_equal(frames, want)


@pytest.mark.parametrize("lane", sorted(LANES))
def test_native_segment_and_bbox(opencv_lib, tiny_wlasl, lane):
    """A record with a segment and a signer box: decode_record, the batch
    call and the JAX package's cv2 path give the same bytes."""
    pp = LANES[lane]
    rec = dataclasses.replace(_records(tiny_wlasl, 1)[0], frame_start=3, frame_end=10,
                              bbox=(5, 5, 60, 60))
    want = _cv2(rec, pp, jdecode)
    np.testing.assert_array_equal(tdecode.decode_record(rec, pp), want)
    frames, ok = native.decode_batch_native(
        [rec], pp.num_frames, pp.staging_size, pp.host_resize_short,
        yuv420=pp.staging_format == "yuv420")
    assert ok.tolist() == [0]
    np.testing.assert_array_equal(frames[0], want)


def test_native_skip_errors(opencv_lib, tiny_wlasl, tmp_path):
    """A missing clip raises by default; on_error='skip' drops it and pads
    the batch, as DecodePool does."""
    paths = [r.path for r in _records(tiny_wlasl, 3)] + [str(tmp_path / "missing.mp4")]
    pool = NativeDecodePool(PP_RGB, num_workers=2)
    try:
        with pytest.raises(IOError, match="missing.mp4"):
            list(pool.map_batches(paths, 4))
        (frames, kept), = list(pool.map_batches(paths, 4, on_error="skip"))
    finally:
        pool.shutdown()
    assert kept == [0, 1, 2] and frames.shape[0] == 4
    np.testing.assert_array_equal(frames[3], frames[2])
    with pytest.raises(IOError, match="cannot open video"):
        tdecode.decode_clip(paths[-1], PP_RGB)


def test_native_pipelined_chunks_match_serial(opencv_lib, tiny_wlasl, tmp_path):
    """Two chunks in flight (the default) give the batches, order and kept
    indices of one at a time, with a failing clip mid-corpus skipped while
    the next chunk is already decoding."""
    paths = [r.path for r in _records(tiny_wlasl, 6)]
    paths.insert(3, str(tmp_path / "missing.mp4"))

    def run(depth):
        pool = NativeDecodePool(PP_RGB, num_workers=2)
        pool.decode_ahead = depth
        try:
            return list(pool.map_batches(paths, 2, on_error="skip"))
        finally:
            pool.shutdown()

    serial, piped = run(1), run(2)
    assert len(serial) == len(piped) == 4
    for (fs, ks), (fp, kp) in zip(serial, piped):
        assert ks == kp
        np.testing.assert_array_equal(fs, fp)
    assert [i for _, k in piped for i in k] == [0, 1, 2, 4, 5, 6]


def test_native_rejects_zero_frames(opencv_lib, av_lib, tiny_wlasl):
    rec = _records(tiny_wlasl, 1)[0]
    with pytest.raises(IOError):
        native.decode_clip_native(rec.path, 0, (64, 64))
    with pytest.raises(IOError):
        native.decode_clip_av(rec.path, 0, (64, 64))
    with pytest.raises(ValueError, match="out must be"):
        native.decode_batch_native([rec.path], 4, (64, 64),
                                   out=np.empty((1, 4, 64, 64), np.uint8))


def test_auto_picks_native_never_av(opencv_lib, av_lib):
    pools = [make_decode_pool(PP_RGB), make_decode_pool(PP_RGB, backend="native"),
             make_decode_pool(PP_RGB, backend="av")]
    try:
        assert [type(p).__name__ for p in pools] == ["NativeDecodePool"] * 3
        assert [p.lib for p in pools] == ["opencv", "opencv", "av"]
        assert [p.backend for p in pools] == ["native", "native", "av"]
    finally:
        for p in pools:
            p.shutdown()
    with pytest.raises(ValueError, match="fast_flags"):
        make_decode_pool(PP_RGB, backend="auto", fast_flags=native.FAST_ALL)
    with pytest.raises(ValueError, match="fast_flags"):
        NativeDecodePool(PP_RGB, fast_flags=native.FAST_LOWRES)


def test_libraries_build_into_the_ports_build_dir(opencv_lib, av_lib):
    for lib in ("opencv", "av"):
        path = native.library_path(lib)
        assert path.parent == _buildcache.BUILD_DIR and path.exists()
        assert native.toolchain_missing(lib) is None
        assert os.path.basename(os.path.dirname(path)) == "_build"
    assert "asltpu_torch" in str(_buildcache.BUILD_DIR)


@pytest.mark.parametrize("pp", [PP_RGB, PP_YUV, PP_YUV_NOOP],
                         ids=["rgb", "yuv420", "yuv420_noop"])
def test_av_close_to_cv2(av_lib, tiny_wlasl, pp):
    for rec in _records(tiny_wlasl):
        want = _cv2(rec, pp)
        got = native.decode_clip_av(
            rec.path, pp.num_frames, pp.staging_size, pp.host_resize_short,
            frame_start=rec.frame_start, frame_end=rec.frame_end, bbox=rec.bbox,
            yuv420=pp.staging_format == "yuv420")
        assert got.shape == want.shape and got.dtype == np.uint8
        assert _mad(got, want) <= AV_MAD


def test_av_fast_all_close_to_exact(av_lib, tiny_wlasl):
    for rec in _records(tiny_wlasl, 2):
        exact = native.decode_clip_av(rec.path, 4, (64, 64))
        fast = native.decode_clip_av(rec.path, 4, (64, 64), fast_flags=native.FAST_ALL)
        assert fast.shape == exact.shape
        assert _mad(fast, exact) <= AV_FAST_MAD
        assert _mad(fast, _cv2(rec, PP_RGB)) <= AV_FAST_MAD


def test_av_bframe_clips(av_lib, tmp_path):
    """Clips with B-frames from the fixture encoder: the exact av decode is
    within the bound of cv2, also for a segment deep enough to seek; with
    FAST_ALL every output frame is still staged."""
    plain, bframes = str(tmp_path / "b0.mp4"), str(tmp_path / "b3.mp4")
    assert native.encode_synthetic_av(plain, 40, (64, 64), max_b_frames=0) == 0
    assert native.encode_synthetic_av(bframes, 60, (64, 64), max_b_frames=3, seed=5) > 0
    want = tdecode.decode_sampled_frames(bframes, 8, (48, 48))
    assert _mad(native.decode_clip_av(bframes, 8, (48, 48)), want) <= AV_MAD
    want = tdecode.decode_sampled_frames(bframes, 6, (48, 48), frame_start=25, frame_end=55)
    got = native.decode_clip_av(bframes, 6, (48, 48), frame_start=25, frame_end=55)
    assert _mad(got, want) <= AV_MAD
    exact = native.decode_clip_av(bframes, 8, (48, 48))
    out = np.full((1, 8, 48, 48, 3), 255, np.uint8)
    frames, ok = native.decode_batch_av([bframes], 8, (48, 48),
                                        fast_flags=native.FAST_ALL, out=out)
    assert ok.tolist() == [0]
    assert max(_mad(frames[0, t], exact[t]) for t in range(8)) <= 30.0


def test_av_pool_contract(av_lib, tiny_wlasl, tmp_path):
    paths = [r.path for r in _records(tiny_wlasl, 3)] + [str(tmp_path / "missing.mp4")]
    pool = NativeDecodePool(PP_RGB, num_workers=2, lib="av")
    try:
        with pytest.raises(IOError):
            list(pool.map_batches(paths, 4))
        (frames, kept), = list(pool.map_batches(paths, 4, on_error="skip"))
    finally:
        pool.shutdown()
    assert kept == [0, 1, 2] and frames.shape[0] == 4
    np.testing.assert_array_equal(frames[3], frames[2])


def test_stream_predict_decode_fast(av_lib, tiny_wlasl):
    """decode_fast through the public stream: logits within 0.1 of the exact
    av stream; refused with any backend but av."""
    from asltpu_torch import api

    paths = [r.path for r in _records(tiny_wlasl, 3)]
    model = api.load_model("mobilenet_gru", device="cpu", num_classes=6, gru_hidden=32,
                           width_mult=0.35, preprocess={"num_frames": 4,
                                                        "staging_size": (64, 64),
                                                        "resize_short": 56, "crop": 48})
    exact = {p: lg for p, _, lg in api.stream_predict(
        model, paths, batch_size=2, decode_backend="av")}
    fast = {p: lg for p, _, lg in api.stream_predict(
        model, paths, batch_size=2, decode_backend="av", decode_fast=True)}
    assert set(fast) == set(exact) == set(paths)
    for p in paths:
        np.testing.assert_allclose(fast[p], exact[p], atol=0.1)
    with pytest.raises(ValueError, match="decode_fast"):
        next(iter(api.stream_predict(model, paths, batch_size=2, decode_fast=True)))


@pytest.mark.parametrize("backend", ["thread", "process"])
def test_python_pools_take_records(tiny_wlasl, backend):
    """DecodePool.submit honours a record's segment and box, as the native
    pool and the JAX package's cv2 path do."""
    rec = dataclasses.replace(_records(tiny_wlasl, 1)[0], frame_start=2, frame_end=15,
                              bbox=(4, 8, 90, 80))
    pool = DecodePool(PP_RGB, num_workers=1, use_processes=backend == "process")
    try:
        (frames, kept), = list(pool.map_batches([rec, rec.path], 2))
    finally:
        pool.shutdown()
    assert kept == [0, 1]
    np.testing.assert_array_equal(frames[0], _cv2(rec, PP_RGB, jdecode))
    np.testing.assert_array_equal(
        frames[1], jdecode.decode_sampled_frames(rec.path, 4, (64, 64)))


def test_probe_video_matches_jax(tiny_wlasl):
    rec = _records(tiny_wlasl, 1)[0]
    assert tdecode.probe_video(rec.path) == jdecode.probe_video(rec.path) == (20, 25.0)
    with pytest.raises(IOError, match="cannot open video"):
        tdecode.probe_video(rec.path + ".missing")


_WORKER = """
import sys
from asltpu_torch.config import PreprocessConfig
from asltpu_torch.data.decode import decode_clip


def decode_and_list(path):
    clip = decode_clip(path, PreprocessConfig(num_frames=2, staging_size=(48, 48)))
    return clip.shape, sorted(m for m in sys.modules if m.split(".")[0] == "torch")


if __name__ == "__main__":
    from asltpu_torch.data.decode import DecodePool

    pool = DecodePool(PreprocessConfig(), num_workers=1, use_processes=True)
    try:
        print(pool._pool.submit(decode_and_list, sys.argv[1]).result())
    finally:
        pool.shutdown()
    print("parent torch:", "torch" in sys.modules)
"""


def test_process_worker_runs_without_torch(tiny_wlasl, tmp_path):
    """A spawned decode worker decodes a clip and has imported no torch:
    decode, staging, the native binding and the config are torch-free."""
    script = tmp_path / "worker_probe.py"
    script.write_text(_WORKER)
    proc = subprocess.run([sys.executable, str(script), _records(tiny_wlasl, 1)[0].path],
                          cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.splitlines() == ["((2, 48, 48, 3), [])", "parent torch: False"]


def test_unbuildable_library_names_what_is_missing(monkeypatch, tmp_path):
    """Without the compiler or the headers a library is unavailable with a
    reason naming them, and the native and av backends raise with it
    instead of falling back; "auto" then takes the process pool."""
    spec = dataclasses.replace(native.AV, include_dirs=(str(tmp_path),))
    monkeypatch.setitem(native.SPECS, "av", spec)
    monkeypatch.setattr(_buildcache, "BUILD_DIR", tmp_path / "_build")
    missing = native.toolchain_missing("av")
    assert missing == f"header not found: {tmp_path / 'libavcodec' / 'avcodec.h'}"
    with pytest.raises(RuntimeError, match="header not found"):
        native.build("av")
    monkeypatch.setenv("PATH", str(tmp_path))
    assert native.toolchain_missing("opencv") == "g++ not found on PATH"
    monkeypatch.setenv("ASLTPU_TORCH_NATIVE_DISABLE", "")
    monkeypatch.setitem(native._LIBS, "opencv", native._Library("opencv"))
    monkeypatch.setitem(native._LIBS, "av", native._Library("av"))
    assert not native.available() and not native.av_available()
    assert "g++ not found on PATH" in native.unavailable_reason()
    assert os.environ["ASLTPU_TORCH_NATIVE_DISABLE"] == "1"  # for spawned workers
    with pytest.raises(RuntimeError, match="g\\+\\+ not found on PATH"):
        make_decode_pool(PP_RGB, backend="native")
    with pytest.raises(RuntimeError, match="native av decode unavailable"):
        make_decode_pool(PP_RGB, backend="av")
    pool = make_decode_pool(PP_RGB, num_workers=1)
    try:
        assert isinstance(pool, DecodePool) and pool.backend == "process"
    finally:
        pool.shutdown()
