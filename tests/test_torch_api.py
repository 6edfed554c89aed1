"""The slice end to end: asltpu.api and asltpu_torch.api share weights and
take the same staged uint8 batch through ``predict`` on both wire lanes;
host decode gives the same bytes; load_clip → predict and stream_predict
run on the CPU."""

import numpy as np
import pytest
import torch

from asltpu import api as japi
from asltpu.data import decode as jdecode
from asltpu.data.synthetic import write_video
from asltpu_torch import api as tapi
from asltpu_torch.ckpt import state_dict_from_jax
from asltpu_torch.data import decode as tdecode
from asltpu_torch.data.prefetch import Prefetcher
from test_torch_models import randomize_bn

SMALL = dict(num_classes=7, gru_hidden=32, width_mult=0.35)
# rgb at a non-identity staging (resize + crop), so the rgb kernel's plain
# version runs; yuv420 at an identity staging, as the bench's thin lane.
LANES = {
    "rgb": {"num_frames": 3, "staging_size": (64, 80), "resize_short": 56,
            "crop": 48},
    "yuv420": {"num_frames": 3, "staging_size": (48, 48), "resize_short": 48,
               "crop": 48, "host_resize_short": 56, "staging_format": "yuv420"},
}
LOGIT_ATOL = 1e-3  # fp32 end to end
BF16_LOGIT_ATOL = 5e-2  # bf16 rounds at other places in the two frameworks


def _pair(lane, compute_dtype, seed):
    pp = LANES[lane]
    jm = japi.load_model("mobilenet_gru", compute_dtype=compute_dtype,
                         preprocess=dict(pp), **SMALL)
    jm.variables = randomize_bn(jm.variables, seed)
    tm = tapi.load_model("mobilenet_gru", device="cpu", compute_dtype=compute_dtype,
                         preprocess=dict(pp), **SMALL)
    tm.module.load_state_dict(state_dict_from_jax(tm.cfg, jm.variables))
    return jm, tm


def _batch(cfg, seed, b=2):
    shape = (b, cfg.preprocess.num_frames, *cfg.preprocess.staged_frame_shape)
    return np.random.default_rng(seed).integers(0, 256, shape, np.uint8)


@pytest.mark.parametrize("lane", sorted(LANES))
def test_predict_matches_jax_fp32(lane):
    jm, tm = _pair(lane, "float32", seed=10)
    frames = _batch(tm.cfg, seed=11)
    want_ids, want = japi.predict(jm, frames)
    got_ids, got = tapi.predict(tm, frames)
    assert got.shape == want.shape == (2, 7) and got.dtype == np.float32
    np.testing.assert_array_equal(got_ids, want_ids)
    np.testing.assert_allclose(got, want, atol=LOGIT_ATOL)


def test_predict_matches_jax_bf16():
    jm, tm = _pair("rgb", "bfloat16", seed=12)
    assert tm.module.features[0][0].weight.dtype == torch.bfloat16
    assert tm.module.fc.weight.dtype == torch.float32
    frames = _batch(tm.cfg, seed=13)
    want_ids, want = japi.predict(jm, frames)
    got_ids, got = tapi.predict(tm, frames)
    np.testing.assert_array_equal(got_ids, want_ids)
    np.testing.assert_allclose(got, want, atol=BF16_LOGIT_ATOL)


def test_predict_unbatched_and_gloss_names():
    tm = tapi.load_model("mobilenet_gru", device="cpu", preprocess=dict(LANES["rgb"]),
                         **SMALL)
    frames = _batch(tm.cfg, seed=14)
    ids, logits = tapi.predict(tm, frames)
    one_id, one = tapi.predict(tm, frames[1])
    assert one.shape == (7,) and one_id == ids[1]
    np.testing.assert_allclose(one, logits[1], atol=1e-5)
    names, _ = tapi.predict(tm, frames, gloss_names=["a", "b"])
    assert all(n in ("a", "b") or isinstance(n, int) for n in names)


@pytest.fixture(scope="module")
def videos(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_videos")
    paths = []
    for i, size in enumerate([(72, 96), (96, 72), (64, 64)]):
        p = str(root / f"clip{i}.mp4")
        write_video(p, num_frames=20, size=size, seed=i)
        paths.append(p)
    return paths


@pytest.mark.parametrize("lane", sorted(LANES))
def test_decode_is_byte_identical(videos, lane):
    cfg = tapi.get_config("mobilenet_gru", preprocess=dict(LANES[lane])).preprocess
    for p in videos:
        want = jdecode.decode_sampled_frames(
            p, cfg.num_frames, cfg.staging_size, cfg.host_resize_short,
            staging_format=cfg.staging_format)
        got = tdecode.decode_clip(p, cfg)
        assert got.dtype == np.uint8 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    want = jdecode.decode_sampled_frames(
        videos[0], 5, (48, 48), frame_start=4, frame_end=15, bbox=(8, 4, 80, 70),
        staging_format=cfg.staging_format)
    got = tdecode.decode_sampled_frames(
        videos[0], 5, (48, 48), frame_start=4, frame_end=15, bbox=(8, 4, 80, 70),
        staging_format=cfg.staging_format)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("lane", sorted(LANES))
def test_load_clip_predict_and_stream_on_cpu(videos, lane):
    tm = tapi.load_model("mobilenet_gru", device="cpu", preprocess=dict(LANES[lane]),
                         **SMALL)
    singles = {}
    for p in videos:
        clip = tapi.load_clip(p, tm.cfg.preprocess)
        assert clip.shape == (3, *tm.cfg.preprocess.staged_frame_shape)
        gloss, logits = tapi.predict(tm, clip)
        assert logits.shape == (7,) and np.isfinite(logits).all()
        singles[p] = (gloss, logits)
    out = list(tapi.stream_predict(tm, videos + ["/nonexistent.mp4"], batch_size=2,
                                   num_decode_workers=2, decode_backend="thread",
                                   skip_errors=True))
    assert [p for p, _, _ in out] == videos
    for p, gloss, logits in out:
        assert gloss == singles[p][0]
        np.testing.assert_allclose(logits, singles[p][1], atol=1e-5)
    with pytest.raises(IOError, match="cannot open video"):
        list(tapi.stream_predict(tm, ["/nonexistent.mp4"], decode_backend="thread"))


def test_stream_predict_default_pool_is_processes(videos):
    """decode_backend="process" decodes in spawned worker processes (the
    default "auto" picks the native library where it is built, else them)."""
    tm = tapi.load_model("mobilenet_gru", device="cpu", preprocess=dict(LANES["rgb"]),
                         **SMALL)
    out = list(tapi.stream_predict(tm, videos[:2], batch_size=2,
                                   num_decode_workers=1, decode_backend="process"))
    assert [p for p, _, _ in out] == videos[:2]
    for p, _, logits in out:
        _, want = tapi.predict(tm, tapi.load_clip(p, tm.cfg.preprocess))
        np.testing.assert_allclose(logits, want, atol=1e-5)


def test_prefetcher_on_cpu():
    batches = [(np.full((2, 3), i, np.uint8), [i]) for i in range(5)]
    with Prefetcher(iter(batches), depth=2, device="cpu") as pf:
        got = list(pf)
    assert [k for _, k in got] == [[i] for i in range(5)]
    assert all(isinstance(x, torch.Tensor) and int(x[0, 0]) == k[0] for x, k in got)

    def failing():
        yield (np.zeros(1), [])
        raise ValueError("decode failed")

    with pytest.raises(ValueError, match="decode failed"):
        with Prefetcher(failing(), device="cpu") as pf:
            list(pf)
