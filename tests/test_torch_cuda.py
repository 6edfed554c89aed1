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
from asltpu_torch.models.mobilenet_fused import fused_backbone_apply, fused_layers
from asltpu_torch.ops import mbconv_kernels as mb
from asltpu_torch.ops import preprocess_kernels as k

pytestmark = pytest.mark.cuda

F32_ATOL = 1e-4
BF16_ATOL = {"rgb": 2e-2, "yuv420": 4e-2}  # one bf16 ulp at |x|≈2.6 / ≈4
# fp32 MBConv: the kernel and the plain version sum in other orders.
MBCONV_F32_RTOL = 1e-4
# A fused layer against the module's bf16 layer: other rounding points (BN
# folded before the bf16 conv), as in tests/test_torch_mbconv.py.
FEATURE_RTOL = 2 ** -5


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
    ((64, 58), 56, 50), ((60, 44), 50, 50),
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


@pytest.mark.parametrize("size", [48, 64, 224, 52, 200])
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


@pytest.mark.parametrize("staging,short,crop", [
    ((256, 256), 256, 224), ((240, 320), 256, 224), ((64, 58), 56, 50),
    ((60, 44), 50, 50), ((480, 640), 96, 80),
])
@pytest.mark.parametrize("out_bytes", [2, 4])
def test_rgb_band_plan_counts_the_kernels_shared_memory(card, staging, short, crop,
                                                       out_bytes):
    """The plan chooses its bands by its own count of the shared memory the
    C side lays out; the two must agree."""
    plan = k.rgb_band_plan(staging, short, crop, out_bytes)
    assert k._lib().asl_preprocess_rgb_smem_bytes(
        crop, plan.stage_rows, plan.pitch, int(out_bytes == 2)) == plan.smem_bytes


def test_rgb_kernel_is_bit_exact_at_the_main_shape(card):
    cfg = PreprocessConfig(num_frames=4)
    frames = _frames(4, (2, 4, 256, 256, 3), card)
    got = k.preprocess_rgb(frames, cfg)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, k.preprocess_rgb_plain(frames, cfg))


def _unaligned(x: torch.Tensor, offset: int) -> torch.Tensor:
    """A contiguous copy of ``x`` whose data_ptr() is ``offset`` bytes past
    a 256-byte boundary."""
    flat = torch.empty(x.numel() + offset, dtype=x.dtype, device=x.device)
    view = flat[offset:].view(x.shape)
    view.copy_(x)
    assert view.is_contiguous() and view.data_ptr() % 16 == offset % 16
    return view


@pytest.mark.parametrize("lane,offset", [("rgb", 3), ("rgb", 8), ("yuv420", 1),
                                         ("yuv420", 4)])
@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_kernels_take_unaligned_inputs(card, lane, offset, out_dtype):
    if lane == "rgb":
        cfg = PreprocessConfig(num_frames=3, staging_size=(256, 256), out_dtype=out_dtype)
        x = _frames(5, (2, 3, 256, 256, 3), card)
        kernel, plain, atol = k.preprocess_rgb, k.preprocess_rgb_plain, BF16_ATOL["rgb"]
    else:
        cfg = PreprocessConfig(num_frames=3, staging_size=(224, 224), resize_short=224,
                               out_dtype=out_dtype, staging_format="yuv420")
        x = _frames(6, (2, 3, 336, 224), card)
        kernel, plain = k.preprocess_yuv420, k.preprocess_yuv420_plain
        atol = BF16_ATOL["yuv420"]
    x = _unaligned(x, offset)
    got = kernel(x, cfg)
    torch.cuda.synchronize()
    atol = F32_ATOL if out_dtype == "float32" else atol
    torch.testing.assert_close(got.float(), plain(x, cfg).float(), atol=atol, rtol=0)


def test_kernels_take_more_than_65535_frames(card):
    """The grids are persistent and 1-D: frames are not bounded by a grid
    dimension."""
    n = 65_600
    rgb = PreprocessConfig(num_frames=n, staging_size=(8, 8), resize_short=8,
                           crop=8, out_dtype="float32")
    frames = _frames(7, (1, n, 8, 8, 3), card)
    torch.testing.assert_close(k.preprocess_rgb(frames, rgb),
                               k.preprocess_rgb_plain(frames, rgb),
                               atol=F32_ATOL, rtol=0)
    yuv = PreprocessConfig(num_frames=n, staging_size=(8, 8), resize_short=8,
                           crop=8, out_dtype="float32", staging_format="yuv420")
    planes = _frames(8, (1, n, 12, 8), card)
    torch.testing.assert_close(k.preprocess_yuv420(planes, yuv),
                               k.preprocess_yuv420_plain(planes, yuv),
                               atol=F32_ATOL, rtol=0)


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
    # The tap tables of a 7300-pixel crop alone exceed a block's shared memory.
    big = torch.zeros((1, 1, 7300, 7300, 3), dtype=torch.uint8, device=card)
    before = k.preprocess_rgb.launches
    with pytest.raises(ValueError, match="shared memory"):
        k.preprocess_rgb(big, PreprocessConfig(staging_size=(7300, 7300),
                                               resize_short=7300, crop=7300))
    assert k.preprocess_rgb.launches == before
    del big
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


def _bf16_ulp(m: float) -> float:
    return 2.0 ** (np.floor(np.log2(m)) - 7)


def _mbconv_args(n, h, w, cin, ce, cout, seed, device):
    """x [n, h, w, cin] and folded fp32 weights at the scales of a trained
    block: fan-in normal weights, biases N(0, 0.1)."""
    rng = np.random.default_rng(seed)

    def t(shape, std):
        return torch.from_numpy(
            (rng.standard_normal(shape) * std).astype(np.float32)).to(device)

    return (t((n, h, w, cin), 1.0), t((cin, ce), (2 / cin) ** 0.5), t((ce,), 0.1),
            t((3, 3, ce), (2 / 9) ** 0.5), t((ce,), 0.1),
            t((ce, cout), (1 / ce) ** 0.5), t((cout,), 0.1))


# The seven main-path shapes (H = W, Cin, Ce, Cout), a ragged one (H≠W, Ce
# not a multiple of the kernels' 16-channel chunk, rows not a multiple of
# the fp32 kernel's tile), padded ones (Cin and Cout not multiples of 8: the
# TF32 kernel's K and N padding and its channel-by-channel x loads), with
# and without the residual, and one whose Ce and Cout are not multiples of
# 4 (the TF32 kernel's float-by-float weight loads).
MBCONV_SHAPES = [
    (56, 56, 24, 144, 24), (28, 28, 32, 192, 32), (14, 14, 64, 384, 64),
    (14, 14, 64, 384, 96), (14, 14, 96, 576, 96), (7, 7, 160, 960, 160),
    (7, 7, 160, 960, 320), (13, 11, 16, 100, 16), (9, 9, 12, 72, 20),
    (9, 9, 12, 72, 12), (6, 10, 8, 50, 18),
]


@pytest.mark.parametrize("h,w,cin,ce,cout", MBCONV_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mbconv_kernel_matches_plain(card, h, w, cin, ce, cout, dtype):
    """bf16 x runs the TF32 tensor-core kernel (one bf16 ulp of the largest
    output), fp32 x the CUDA-core kernel (1e-4 relative); each call is one
    launch."""
    x, *weights = _mbconv_args(3, h, w, cin, ce, cout, 7, card)
    x = x.to(dtype)
    before = mb.fused_mbconv_s1.launches
    got = mb.fused_mbconv_s1(x, *weights)
    torch.cuda.synchronize()
    assert mb.fused_mbconv_s1.launches == before + 1
    want = mb.fused_mbconv_s1_plain(x, *weights)
    assert got.shape == want.shape == (3, h, w, cout) and got.dtype == dtype
    peak = float(want.float().abs().max())
    atol = peak * MBCONV_F32_RTOL if dtype == torch.float32 else _bf16_ulp(peak)
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=0)


def test_mbconv_wrapper_refuses_what_the_kernel_does_not_take(card):
    x, *weights = _mbconv_args(1, 8, 8, 16, 96, 16, 8, card)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        mb.fused_mbconv_s1(x.half(), *weights)
    with pytest.raises(ValueError, match="float32"):
        mb.fused_mbconv_s1(x, weights[0].bfloat16(), *weights[1:])
    with pytest.raises(ValueError, match="contiguous"):
        mb.fused_mbconv_s1(x.transpose(1, 2), *weights)
    with pytest.raises(ValueError, match="shape"):
        mb.fused_mbconv_s1(x[..., :8].contiguous(), *weights)
    for dtype in (torch.float32, torch.bfloat16):
        big, *big_weights = _mbconv_args(1, 8, 8, 8192, 16, 16, 8, card)
        with pytest.raises(ValueError, match="shared memory"):
            mb.fused_mbconv_s1(big.to(dtype), *big_weights)
    # The TF32 kernel keeps all of Cout in its warps' fragments.
    wide, *wide_weights = _mbconv_args(1, 2, 64, 16, 96, 4096, 8, card)
    with pytest.raises(ValueError, match="accumulators"):
        mb.fused_mbconv_s1(wide.bfloat16(), *wide_weights)
    before = mb.fused_mbconv_s1.launches
    with pytest.raises(ValueError, match="shape"):
        mb.fused_mbconv_s1(x[..., :8].contiguous().bfloat16(), *weights)
    assert mb.fused_mbconv_s1.launches == before


def test_fused_backbone_matches_module_on_the_card(card):
    """Layer by layer, with BN statistics calibrated on a seeded batch (a
    train-mode pass with momentum 1): at the seeded init the features
    vanish, and end to end the calibrated random net amplifies rounding
    chaotically, so each fused layer is held to the module's own layer on
    the same input."""
    model = api.load_model("mobilenet_gru", seed=3, num_classes=7, gru_hidden=32)
    frames, calib = (torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (4, 64, 48, 3)).astype(np.float32)).to(card) for seed in (9, 10))
    features = model.module.features
    for m in features.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.momentum = 1.0
    with torch.no_grad():
        features(calib.permute(0, 3, 1, 2).to(torch.bfloat16), train=True)
    before = mb.fused_mbconv_s1.launches
    got = fused_backbone_apply(features, frames)
    torch.cuda.synchronize()
    assert mb.fused_mbconv_s1.launches == before + 12
    assert got.shape == (4, 1280) and got.dtype == torch.bfloat16
    with torch.inference_mode():
        y = frames.to(torch.bfloat16)
        for i, layer in enumerate(fused_layers(features)):
            want = features[i](y.permute(0, 3, 1, 2)).permute(0, 2, 3, 1).float()
            y = layer(y)
            peak = float(want.abs().max())
            assert peak > 0.1, i
            torch.testing.assert_close(y.float(), want, rtol=0,
                                       atol=FEATURE_RTOL * peak, msg=f"layer {i}")


def test_pose_bilstm_on_the_card_is_fp32_with_tf32_allowed():
    """pose_bilstm keeps cuDNN's LSTM in fp32 itself: with PyTorch's default
    (cuDNN may use TF32) its logits on the card are within 1e-5 of the
    CPU's. With TF32 on inside the LSTM they are not: the bound sees it."""
    from asltpu_torch.data.synthetic import synthetic_landmarks

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        kw = dict(seed=5, hidden_size=64, num_frames=8, num_classes=9)
        lm = synthetic_landmarks(16, 8, seed=6)
        model = api.load_model("pose_bilstm", **kw)
        ids, logits = api.predict(model, lm)
        model.module.lstm_tf32 = True
        _, tf32_logits = api.predict(model, lm)
        want_ids, want = api.predict(api.load_model("pose_bilstm", device="cpu", **kw), lm)
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    np.testing.assert_array_equal(ids, want_ids)
    np.testing.assert_allclose(logits, want, atol=1e-5)
    errs = (float(np.abs(logits - want).max()), float(np.abs(tf32_logits - want).max()))
    assert errs[1] > 1e-5, f"fp32 and TF32 LSTM max logit errors vs the CPU: {errs}"


@pytest.mark.parametrize("family,kw", [
    ("i3d", dict(num_classes=7)),
    ("two_stream", dict(num_classes=7, width_mult=0.35, d_model=64, num_heads=4)),
])
def test_i3d_and_two_stream_on_the_card_match_the_cpu(card, family, kw):
    """fp32 (TF32 off), 16 frames of 32² staged at 40×48: the rgb kernel
    launches once per predict, the logits are the CPU's within 1e-5 of the
    largest (at least 1e-3: the seeded I3D's logits reach ~1300, where
    fp32 sums in another order differ by 2.3e-3, 1.8e-6 relative, on an
    NVIDIA H100 80GB HBM3), and the fusion model takes its landmarks to the
    card."""
    from asltpu_torch.data.synthetic import synthetic_landmarks

    pp = {"num_frames": 16, "staging_size": (40, 48), "resize_short": 36, "crop": 32,
          "out_dtype": "float32"}
    kw = dict(kw, compute_dtype="float32", preprocess=pp)
    on_card = api.load_model(family, seed=3, **kw)
    on_cpu = api.load_model(family, seed=3, device="cpu", **kw)
    frames = np.random.default_rng(4).integers(0, 256, (2, 16, 40, 48, 3), np.uint8)
    lm = synthetic_landmarks(2, 16, seed=5) if family == "two_stream" else None
    before = k.preprocess_rgb.launches
    ids, logits = api.predict(on_card, frames, lm)
    assert k.preprocess_rgb.launches == before + 1
    want_ids, want = api.predict(on_cpu, frames, lm)
    np.testing.assert_array_equal(ids, want_ids)
    np.testing.assert_allclose(logits, want, rtol=0,
                               atol=1e-5 * max(float(np.abs(want).max()), 100.0))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stem_forms_agree_on_the_card(card, dtype):
    """The space-to-depth stem and the plain strided conv on the card: fp32
    (TF32 off) within 1e-5 of the largest output, bf16 within one bf16 ulp
    of it; an odd axis takes only the plain form."""
    from asltpu_torch.ops import stem_s2d as st

    gen = torch.Generator(card).manual_seed(6)
    x = torch.randn((2, 16, 48, 40, 3), generator=gen, device=card).to(dtype)
    x = x.permute(0, 4, 1, 2, 3)
    w = (torch.randn((64, 3, 7, 7, 7), generator=gen, device=card) / 32).to(dtype)
    plain, s2d = st.stem_conv3d_plain(x, w), st.stem_conv3d_s2d(x, w)
    assert plain.shape == s2d.shape == (2, 64, 8, 24, 20)
    peak = float(plain.float().abs().max())
    atol = 1e-5 * peak if dtype == torch.float32 else _bf16_ulp(peak)
    torch.testing.assert_close(s2d.float(), plain.float(), rtol=0, atol=atol)
    assert not st.s2d_applies(x[:, :, :15])


def test_batchnorm3d_keeps_bf16_input_in_fp32_on_the_card(card):
    """BatchNorm3d with bf16 input and fp32 parameters (as ``load_model``
    keeps I3D's) on the card: within one bf16 ulp of each value of the fp32
    normalisation rounded once."""
    bn = torch.nn.BatchNorm3d(16, eps=1e-3).eval().to(card)
    gen = torch.Generator(card).manual_seed(7)
    with torch.no_grad():
        bn.running_mean.normal_(0, 4, generator=gen)
        bn.running_var.uniform_(0.05, 8, generator=gen)
        x = (torch.randn((2, 16, 3, 5, 4), generator=gen, device=card) * 4).bfloat16()
        x = x.contiguous(memory_format=torch.channels_last_3d)
        got = bn(x)
        ref = torch.nn.functional.batch_norm(x.float(), bn.running_mean, bn.running_var,
                                             bn.weight, bn.bias, False, 0.0, bn.eps)
    assert got.dtype == torch.bfloat16
    ulp = torch.exp2(torch.floor(torch.log2(ref.abs().clamp_min(1e-30))) - 7)
    assert bool(((got.float() - ref).abs() <= ulp).all())


def test_i3d_train_and_eval_steps_on_the_card(card):
    """The I3D train step at the CPU test's size (16 frames of 40×48, crop
    32 in fp32, 7 classes, batch 8, fp32 compute, TF32 off, dropout 0: the
    card's generator draws other masks) on the card against the CPU, from
    the same weights and batch, as the first step of a warmup (lr 0): the
    loss, the parameters and the running statistics within 1e-4 relative
    (global norm); the card's gradient (Adam's first moment) no farther
    from the CPU's fp64 gradient than twice the CPU's fp32 one, and 1e-3
    (at this size rounding is amplified; ``chip_smoke.py``, phase train,
    says by how much); the rgb kernel launches once in the train step and once in the
    eval step, and BatchNorm in training keeps bf16 input in fp32 with
    flax's biased variance."""
    from asltpu_torch.config import TrainConfig
    from asltpu_torch.models.common import batch_norm
    from asltpu_torch.train import loop

    pp = {"num_frames": 16, "staging_size": (40, 48), "resize_short": 36, "crop": 32,
          "out_dtype": "float32"}
    tcfg = TrainConfig(batch_size=8, warmup_steps=1, num_steps=10, grad_clip_norm=1e30)
    rng = np.random.default_rng(8)
    frames = rng.integers(0, 256, (8, 16, 40, 48, 3), np.uint8)
    labels = rng.integers(0, 7, 8).astype(np.int32)
    out = {}
    for dev in (card, torch.device("cpu")):
        model = api.build_trainable("i3d", seed=3, device=dev, num_classes=7, dropout=0.0,
                                    compute_dtype="float32", preprocess=pp)
        state = loop.create_train_state(model.module, tcfg, seed=3)
        before = k.preprocess_rgb.launches
        state, metrics = loop.make_train_step(tcfg, model.cfg.preprocess)(state, frames, labels)
        loop.make_eval_step(model.cfg.preprocess)(state, frames, labels)
        if dev.type == "cuda":
            assert k.preprocess_rgb.launches - before == 2
        grads = {n: state.optimizer.state[p]["exp_avg"].cpu()
                 for n, p in model.module.named_parameters()}
        out[dev.type] = (float(metrics["loss"]), {key: t.cpu() for key, t in
                                                  model.module.state_dict().items()}, grads)

    def rel(a, b, keep=lambda key: True):
        keys = [key for key, t in b.items() if t.is_floating_point() and keep(key)]
        num = sum(float(((a[key].double() - b[key].double()) ** 2).sum()) for key in keys)
        return (num / sum(float((b[key].double() ** 2).sum()) for key in keys)) ** 0.5

    (loss, sd, grads), (want_loss, want_sd, want_grads) = out["cuda"], out["cpu"]
    assert loss == pytest.approx(want_loss, rel=1e-4)
    assert rel(sd, want_sd, lambda key: "running" not in key) < 1e-4
    assert rel(sd, want_sd, lambda key: "running" in key) < 1e-4
    m64 = api.build_trainable("i3d", seed=3, device="cpu", num_classes=7, dropout=0.0,
                              compute_dtype="float64", preprocess=pp)
    from asltpu_torch.ops.preprocess import preprocess_clip

    clip = preprocess_clip(torch.from_numpy(frames), m64.cfg.preprocess).double()
    module = m64.module.double()
    loss64 = loop.softmax_ce(module(clip, train=True), torch.from_numpy(labels),
                             tcfg.label_smoothing)
    g64 = {n: 0.1 * g for (n, _), g in zip(module.named_parameters(), torch.autograd.grad(
        loss64, list(module.parameters())))}
    assert rel(grads, g64) <= 2 * rel(want_grads, g64) + 1e-3

    bn = torch.nn.BatchNorm3d(16, eps=1e-3).to(card)
    gen = torch.Generator(card).manual_seed(9)
    x = (torch.randn((2, 16, 3, 5, 4), generator=gen, device=card) * 4 + 1).bfloat16()
    with torch.no_grad():
        got = batch_norm(bn, x.contiguous(memory_format=torch.channels_last_3d), True)
    x32 = x.float()
    mean, var = x32.mean((0, 2, 3, 4)), x32.var((0, 2, 3, 4), unbiased=False)
    ref = (x32 - mean.view(1, -1, 1, 1, 1)) / torch.sqrt(var.view(1, -1, 1, 1, 1) + 1e-3)
    # One bf16 ulp of each value, and 1e-5 for values near 0 (the reference
    # divides by the square root where the kernel multiplies by rsqrt).
    ulp = torch.exp2(torch.floor(torch.log2(ref.abs().clamp_min(1e-30))) - 7) + 1e-5
    assert got.dtype == torch.bfloat16 and bool(((got.float() - ref).abs() <= ulp).all())
    torch.testing.assert_close(bn.running_var, 0.9 + 0.1 * var, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(bn.running_mean, 0.1 * mean, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("lane,pp", [
    ("rgb", {"num_frames": 3, "staging_size": (64, 80), "resize_short": 56,
             "crop": 48}),
    ("yuv420", {"num_frames": 3, "staging_size": (48, 48), "resize_short": 48,
                "crop": 48, "staging_format": "yuv420"}),
])
def test_server_on_the_card_matches_predict(card, lane, pp):
    """``PredictServer`` on the card: six concurrent requests batched into
    buckets of 1 and 4 give ``predict``'s logits on the card (fp32, TF32
    off; other batch sizes may take other cuDNN algorithms), the lane's
    kernel launches once per batch, and the batcher thread ends on
    shutdown."""
    from asltpu_torch.serve import PredictServer

    model = api.load_model("mobilenet_gru", seed=5, num_classes=7, gru_hidden=32,
                           width_mult=0.35, compute_dtype="float32",
                           preprocess=dict(pp, out_dtype="float32"))
    shape = (6, 3, *model.cfg.preprocess.staged_frame_shape)
    frames = np.random.default_rng(6).integers(0, 256, shape, np.uint8)
    counter = k.preprocess_rgb if lane == "rgb" else k.preprocess_yuv420
    server = PredictServer(model, max_batch=4, max_delay_ms=20, batch_buckets=(1, 4))
    try:
        server.warm()
        before = counter.launches
        futures = [server.submit(f) for f in frames]
        got = np.stack([f.result(timeout=120)[1] for f in futures])
        assert counter.launches == before + server.stats.batches
    finally:
        server.shutdown()
    assert not server._thread.is_alive()
    _, want = api.predict(model, frames)
    np.testing.assert_allclose(got, want, rtol=0, atol=F32_ATOL)


@pytest.mark.parametrize("lane,pp", [
    ("rgb", dict(num_frames=3, staging_size=(64, 80), resize_short=56, crop=48)),
    ("yuv420", dict(num_frames=3, staging_size=(48, 48), resize_short=48, crop=48,
                    staging_format="yuv420")),
])
def test_export_on_the_card_launches_the_kernel_inside_the_program(card, lane, pp, tmp_path):
    """Exported on the card, the program calls the kernel's custom op: run
    from the artifact it launches the kernel once a batch, and its logits
    equal the live ``predict_fn``'s (fp32, TF32 off)."""
    from asltpu_torch.export import export_model, load_exported

    model = api.load_model("mobilenet_gru", seed=3, num_classes=7, gru_hidden=32,
                           width_mult=0.35, compute_dtype="float32",
                           preprocess=dict(pp, out_dtype="float32"))
    meta = export_model(model, str(tmp_path / "a"), batch_size=2)
    assert meta["preprocess"] == f"asltpu_torch::preprocess_{lane}"
    assert meta["platforms"] == ["cuda"]
    em = load_exported(str(tmp_path / "a"))
    frames = np.random.default_rng(5).integers(
        0, 256, (2, 3, *model.cfg.preprocess.staged_frame_shape), np.uint8)
    counter = k.preprocess_rgb if lane == "rgb" else k.preprocess_yuv420
    before = counter.launches
    got = em.predict_batch(frames=frames)
    assert counter.launches == before + 1
    want = model.predict_fn()(torch.from_numpy(frames).to(card)).cpu().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=F32_ATOL)


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_fake_implementations_agree_with_the_kernels(card, out_dtype):
    """Each custom op's fake implementation (what ``torch.export`` traces
    with) gives the shape, dtype and device of the kernel's output."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    cases = [
        (k.preprocess_rgb, _frames(6, (2, 3, 64, 80, 3), card),
         PreprocessConfig(num_frames=3, staging_size=(64, 80), resize_short=56, crop=48,
                          out_dtype=out_dtype)),
        (k.preprocess_yuv420, _frames(7, (2, 3, 72, 48), card),
         PreprocessConfig(num_frames=3, staging_size=(48, 48), resize_short=48, crop=48,
                          staging_format="yuv420", out_dtype=out_dtype)),
    ]
    for wrapper, x, cfg in cases:
        real = wrapper(x, cfg)
        with FakeTensorMode() as mode:
            fake = wrapper(mode.from_tensor(x), cfg)
        assert (fake.shape, fake.dtype, fake.device) == (real.shape, real.dtype, real.device)
