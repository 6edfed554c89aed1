"""The CUDA kernels of asltpu_torch on the card, against their plain
PyTorch versions on the same inputs, and the slice's predict on the card
against the CPU. Every test here needs an NVIDIA GPU and nvcc and skips
without them; run them on the card with

    python -m pytest tests/test_torch_cuda.py -m cuda

This file imports no JAX, so it runs where only PyTorch is installed."""

import numpy as np
import pytest
import torch

from asltpu_torch import api
from asltpu_torch.config import PreprocessConfig
from asltpu_torch.ops import preprocess_kernels as k

pytestmark = pytest.mark.cuda

F32_ATOL = 1e-4
BF16_ATOL = {"rgb": 2e-2, "yuv420": 4e-2}  # one bf16 ulp at |x|≈2.6 / ≈4


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    # fp32 comparisons: cuDNN would otherwise run fp32 convolutions in TF32.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def _frames(seed, shape, device):
    x = np.random.default_rng(seed).integers(0, 256, shape, np.uint8)
    return torch.from_numpy(x).to(device)


@pytest.mark.parametrize("staging,short,crop", [
    ((64, 64), 56, 48), ((64, 80), 56, 48), ((48, 64), 56, 48),
    ((256, 256), 256, 224), ((240, 320), 256, 224), ((60, 44), 40, 40),
])
@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_rgb_kernel_matches_plain(card, staging, short, crop, out_dtype):
    cfg = PreprocessConfig(num_frames=3, staging_size=staging, resize_short=short,
                           crop=crop, out_dtype=out_dtype)
    frames = _frames(0, (2, 3, *staging, 3), card)
    before = k.preprocess_rgb.launches
    got = k.preprocess_rgb(frames, cfg)
    torch.cuda.synchronize()
    assert k.preprocess_rgb.launches == before + 1
    want = k.preprocess_rgb_plain(frames, cfg)
    assert got.shape == want.shape == (2, 3, crop, crop, 3)
    assert got.dtype == want.dtype == cfg.out_torch_dtype
    atol = F32_ATOL if out_dtype == "float32" else BF16_ATOL["rgb"]
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=0)


@pytest.mark.parametrize("size", [48, 64, 224])
@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_yuv420_kernel_matches_plain(card, size, out_dtype):
    cfg = PreprocessConfig(num_frames=3, staging_size=(size, size),
                           resize_short=size, crop=size, out_dtype=out_dtype,
                           staging_format="yuv420")
    planes = _frames(1, (2, 3, size * 3 // 2, size), card)
    before = k.preprocess_yuv420.launches
    got = k.preprocess_yuv420(planes, cfg)
    torch.cuda.synchronize()
    assert k.preprocess_yuv420.launches == before + 1
    want = k.preprocess_yuv420_plain(planes, cfg)
    assert got.shape == want.shape == (2, 3, size, size, 3)
    atol = F32_ATOL if out_dtype == "float32" else BF16_ATOL["yuv420"]
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=0)


def test_wrappers_refuse_what_the_kernels_do_not_take(card):
    rgb_cfg = PreprocessConfig(num_frames=2, staging_size=(64, 64),
                               resize_short=56, crop=48)
    frames = _frames(2, (1, 2, 64, 64, 3), card)
    with pytest.raises(ValueError, match="uint8"):
        k.preprocess_rgb(frames.float(), rgb_cfg)
    with pytest.raises(ValueError, match="contiguous"):
        k.preprocess_rgb(frames.transpose(2, 3), rgb_cfg)
    with pytest.raises(ValueError, match="exceeds resized dims"):
        k.preprocess_rgb(frames, PreprocessConfig(resize_short=40, crop=48))
    with pytest.raises(ValueError, match="out_dtype"):
        k.preprocess_rgb(frames, PreprocessConfig(
            staging_size=(64, 64), resize_short=56, crop=48, out_dtype="float16"))
    planes = _frames(3, (1, 2, 96, 64), card)
    with pytest.raises(ValueError, match="identity-resize"):
        k.preprocess_yuv420(planes, PreprocessConfig(
            staging_size=(64, 64), resize_short=56, crop=48,
            staging_format="yuv420"))


@pytest.mark.parametrize("lane,pp", [
    ("rgb", {"num_frames": 3, "staging_size": (64, 80), "resize_short": 56,
             "crop": 48}),
    ("yuv420", {"num_frames": 3, "staging_size": (48, 48), "resize_short": 48,
                "crop": 48, "staging_format": "yuv420"}),
])
def test_predict_on_the_card_matches_the_cpu(card, lane, pp):
    kw = dict(num_classes=7, gru_hidden=32, width_mult=0.35,
              compute_dtype="float32", preprocess=dict(pp, out_dtype="float32"))
    on_card = api.load_model("mobilenet_gru", seed=3, **kw)
    on_cpu = api.load_model("mobilenet_gru", seed=3, device="cpu", **kw)
    shape = (2, 3, *on_card.cfg.preprocess.staged_frame_shape)
    frames = np.random.default_rng(4).integers(0, 256, shape, np.uint8)
    counter = k.preprocess_rgb if lane == "rgb" else k.preprocess_yuv420
    before = counter.launches
    ids, logits = api.predict(on_card, frames)
    assert counter.launches == before + 1
    want_ids, want = api.predict(on_cpu, frames)
    np.testing.assert_array_equal(ids, want_ids)
    np.testing.assert_allclose(logits, want, atol=1e-3)
