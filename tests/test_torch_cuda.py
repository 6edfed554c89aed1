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


SERVER_LANES = [
    ("rgb", {"num_frames": 3, "staging_size": (64, 80), "resize_short": 56,
             "crop": 48}),
    ("yuv420", {"num_frames": 3, "staging_size": (48, 48), "resize_short": 48,
                "crop": 48, "staging_format": "yuv420"}),
]


def _served_model(pp):
    return api.load_model("mobilenet_gru", seed=5, num_classes=7, gru_hidden=32,
                          width_mult=0.35, compute_dtype="float32",
                          preprocess=dict(pp, out_dtype="float32"))


@pytest.mark.parametrize("lane,pp", SERVER_LANES)
def test_server_on_the_card_matches_predict(card, lane, pp):
    """``PredictServer`` on the card: six concurrent requests batched into
    buckets of 1 and 4 give ``predict``'s logits on the card (fp32, TF32
    off; other batch sizes may take other cuDNN algorithms), the lane's
    kernel launches once per batch, and the batcher thread ends on
    shutdown."""
    from asltpu_torch.serve import PredictServer

    model = _served_model(pp)
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


@pytest.mark.parametrize("lane,pp", SERVER_LANES)
def test_server_stages_batches_in_page_locked_buffers(card, lane, pp):
    """Twelve requests in flight at once, batched into buckets of 1 and 4
    over several batches: every batch is filled into page-locked host rows
    kept per bucket (``staged_batches`` counts each), only the real rows
    cross to the card and the padding is written there, and the answers
    are ``predict``'s logits on the card."""
    from asltpu_torch.serve import PredictServer

    model = _served_model(pp)
    shape = (12, 3, *model.cfg.preprocess.staged_frame_shape)
    frames = np.random.default_rng(7).integers(0, 256, shape, np.uint8)
    server = PredictServer(model, max_batch=4, max_delay_ms=20, batch_buckets=(1, 4))
    try:
        server.warm()
        futures = [server.submit(f) for f in frames]
        got = np.stack([f.result(timeout=120)[1] for f in futures])
    finally:
        server.shutdown()
    assert not server._thread.is_alive()
    st = server.stats
    assert st.requests == 12 and st.batches >= 3
    assert st.staged_batches == st.batches
    stages = list(server._staging.values())
    assert {k[0] for k in server._staging} == {1, 4}
    assert all(torch.from_numpy(s.host).is_pinned() and s.batch.is_cuda for s in stages)
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


@pytest.mark.parametrize("shape,kernel,stride,pad", [
    ((2, 64, 6, 15, 14), (1, 3, 3), (1, 2, 2), (0, 0, 1, 1, 0, 1)),
    ((2, 192, 6, 9, 9), (3, 3, 3), (1, 1, 1), (1, 1, 1, 1, 1, 1)),
    ((2, 132, 7, 9, 8), (3, 3, 3), (2, 2, 2), (1, 1, 0, 1, 0, 1)),
    ((2, 24, 6, 9, 8), (2, 2, 2), (2, 2, 2), (0, 0, 0, 0, 0, 0)),
    ((1, 12, 5, 7, 7), (3, 3, 3), (1, 1, 1), (1, 1, 1, 1, 1, 1)),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pool3d_kernels_match_aten(card, shape, kernel, stride, pad, dtype):
    """The max-pool kernels against the plain version: the forward's bits
    (ties and a NaN included) and offsets exactly, the input gradient
    within one ulp of aten's taken in fp32 and rounded once; one launch
    each way, and a fake output laid out as the kernel's."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from asltpu_torch.ops import pool3d_kernels as pk

    gen = torch.Generator(card).manual_seed(8)
    x = torch.randint(0, 5, shape, generator=gen, device=card).to(dtype)
    x[0, :, 1, 1, 1] = float("nan")
    x = x.contiguous(memory_format=torch.channels_last_3d).requires_grad_()
    before = (pk.max_pool3d_same.launches, pk.max_pool3d_same_backward.launches)
    out, off = torch.ops.asltpu_torch.max_pool3d_same.default(x, kernel, stride, pad)
    want, want_off = pk.max_pool3d_plain(x.detach(), kernel, stride, pad)
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    assert torch.equal(out.view(bits), want.view(bits)) and torch.equal(off, want_off)
    g = torch.randn(out.shape, generator=gen, device=card).to(dtype)
    (got,) = torch.autograd.grad(out, x, g)
    exact = pk.max_pool3d_backward_plain(g.float(), want_off, shape[2:], kernel, stride, pad)
    assert (pk.max_pool3d_same.launches, pk.max_pool3d_same_backward.launches) == (
        before[0] + 1, before[1] + 1)
    # fp32 sums in another order: a rounding of the largest sum; bf16: one
    # ulp of the larger of the two (both are fp32 sums rounded once), with
    # fp32's rounding as the floor where a sum cancels to near 0.
    err = (got.float() - exact.to(dtype).float()).abs()
    floor = 1e-6 * float(exact.abs().max())
    if dtype == torch.bfloat16:
        m = torch.maximum(got.float().abs(), exact.abs())
        tol = torch.exp2(torch.floor(torch.log2(m.clamp_min(1e-30))) - 7).clamp_min(floor)
    else:
        tol = torch.full_like(err, floor)
    assert bool((err <= tol).all()), float((err / tol).max())
    xd = x.detach()
    with FakeTensorMode() as mode:
        fake, _ = torch.ops.asltpu_torch.max_pool3d_same.default(
            mode.from_tensor(xd), kernel, stride, pad)
    assert (fake.shape, fake.dtype, fake.stride()) == (out.shape, out.dtype, out.stride())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pool3d_kernels_refuse_what_no_width_fits(card, dtype):
    """C = 3, and a view one value off alignment: the op raises on the card
    and launches nothing (no fallback)."""
    from asltpu_torch.ops import pool3d_kernels as pk

    narrow = torch.zeros(1, 3, 5, 7, 7, dtype=dtype, device=card).contiguous(
        memory_format=torch.channels_last_3d)
    flat = torch.zeros(1 + 8 * 5 * 7 * 7, dtype=dtype, device=card)
    unaligned = flat[1:].view(1, 5, 7, 7, 8).permute(0, 4, 1, 2, 3)
    before = pk.max_pool3d_same.launches
    for x in (narrow, unaligned):
        with pytest.raises(ValueError, match="multiple of 4"):
            torch.ops.asltpu_torch.max_pool3d_same.default(x, [3, 3, 3], [1, 1, 1], [1] * 6)
    assert pk.max_pool3d_same.launches == before


@pytest.mark.parametrize("length,n", [(785, 16), (16, 784)])
def test_fused_attention_matches_the_plain_math(card, length, n):
    """TimeSformer's two attentions, bf16 heads of 64 (12 heads; spatial: 16
    sequences of 785 tokens, temporal: 784 of 16), q/k/v strided views of
    one packed projection as the model makes them: the fused backend
    against the plain math in fp32 on the same bf16 inputs, forward and the
    three gradients. The fused kernels round the softmax weights to bf16
    before the weighted sum and the result once (2^-8 relative each), so
    each value lies within 2^-6 of the largest of its tensor; a wrong
    layout or scale misses by the tensor's own size."""
    from asltpu_torch.ops import attention as att

    gen = torch.Generator(card).manual_seed(11)
    qkv = torch.randn((n, length, 3, 12, 64), generator=gen, device=card).bfloat16()
    q, k_, v = (qkv[:, :, i].transpose(1, 2).requires_grad_() for i in range(3))
    before = att.fused_attention.calls
    out = att.fused_attention(q, k_, v)
    assert att.fused_attention.calls == before + 1 and out.dtype == torch.bfloat16
    grad = torch.randn(out.shape, generator=gen, device=card).bfloat16()
    got = (out, *torch.autograd.grad(out, (q, k_, v), grad))
    q32, k32, v32 = (t.detach().float().requires_grad_() for t in (q, k_, v))
    want = att.plain_attention(q32, k32, v32)
    want = (want, *torch.autograd.grad(want, (q32, k32, v32), grad.float()))
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert float((g.float() - w).abs().max()) <= 2 ** -6 * float(w.abs().max())


def test_fused_attention_raises_where_no_fused_backend_applies(card):
    """float64 heads, which no fused backend takes: the call raises on the
    card rather than running the math backend, and counts nothing."""
    from asltpu_torch.ops import attention as att

    q = torch.randn((2, 4, 33, 64), dtype=torch.float64, device=card)
    before = att.fused_attention.calls
    with pytest.raises(RuntimeError):
        att.fused_attention(q, q, q)
    assert att.fused_attention.calls == before


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_rgb_kernel_matches_plain_at_timesformer_size(card, out_dtype):
    """TimeSformer-HR's preprocess: 512² staged frames, short side 512,
    centre crop 448 (two clips of 16 frames)."""
    cfg = PreprocessConfig(num_frames=16, staging_size=(512, 512), resize_short=512,
                           crop=448, out_dtype=out_dtype)
    frames = _frames(12, (2, 16, 512, 512, 3), card)
    before = k.preprocess_rgb.launches
    got = k.preprocess_rgb(frames, cfg)
    torch.cuda.synchronize()
    assert k.preprocess_rgb.launches == before + 1
    want = k.preprocess_rgb_plain(frames, cfg)
    assert got.shape == want.shape == (2, 16, 448, 448, 3)
    atol = F32_ATOL if out_dtype == "float32" else BF16_ATOL["rgb"]
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=0)


def _timesformer_step_and_predict(card, **overrides):
    """A small TimeSformer (2 blocks of d 128, 4 frames of 96²) through
    ``build_trainable`` → ``make_train_step`` and ``load_model`` →
    ``predict``, with the config's ``overrides``: asserts the loss and
    logits finite and returns what the step and the predict added to
    (``fused_attention.calls``, ``plain_attention.calls``,
    ``short_attention.launches``, ``short_attention_backward.launches``)."""
    from asltpu_torch.config import TrainConfig
    from asltpu_torch.ops import attention as att
    from asltpu_torch.ops import short_attention_kernels as sa
    from asltpu_torch.train import loop

    kw = dict(num_classes=7, num_frames=4, embed_dim=128, depth=2,
              preprocess={"num_frames": 4, "staging_size": (112, 112), "resize_short": 112,
                          "crop": 96}, **overrides)
    frames = np.random.default_rng(13).integers(0, 256, (2, 4, 112, 112, 3), np.uint8)
    model = api.build_trainable("timesformer", seed=3, device=card, **kw)
    tcfg = TrainConfig(batch_size=2)
    state = loop.create_train_state(model.module, tcfg, seed=3)

    def counts():
        return (att.fused_attention.calls, att.plain_attention.calls,
                sa.short_attention.launches, sa.short_attention_backward.launches)

    before = counts()
    state, metrics = loop.make_train_step(tcfg, model.cfg.preprocess)(
        state, frames, np.array([1, 2], np.int32))
    assert bool(torch.isfinite(metrics["loss"]))
    ids, logits = api.predict(api.load_model("timesformer", seed=3, **kw), frames)
    assert np.isfinite(logits).all() and logits.shape == (2, 7)
    return tuple(a - b for a, b in zip(counts(), before))


def test_timesformer_on_the_card_trains_and_predicts(card):
    """The small TimeSformer in 2 heads of 64, bf16: each temporal attention
    (4 tokens) takes the short-sequence kernel, forward and backward, and
    each spatial one (37 tokens) the fused backend (2 fused calls and 2 + 2
    launches a step, 2 and 2 + 0 a predict); the loss and logits are
    finite."""
    assert _timesformer_step_and_predict(card, num_heads=2) == (4, 0, 4, 2)


@pytest.mark.parametrize("overrides", [
    {"num_heads": 2, "compute_dtype": "float32"},
    {"num_heads": 4},
], ids=["fp32_heads_of_64", "bf16_heads_of_32"])
def test_timesformer_runs_on_the_card_where_the_short_kernel_does_not(card, overrides):
    """fp32, and bf16 heads of 32, which the short-sequence kernels refuse:
    ``attention`` sends the temporal sub-layer too to the fused backend (4
    fused calls a step, 4 a predict) and launches no short kernel; the loss
    and logits are finite."""
    assert _timesformer_step_and_predict(card, **overrides) == (8, 0, 0, 0)


# TimeSformer-HR's temporal attention at batch 8: 8 · 784 sequences of 16
# tokens, 12 heads of 64.
SHORT_N, SHORT_HEADS = 6272, 12


def _short_case(card, n, length, heads, seed):
    gen = torch.Generator(card).manual_seed(seed)
    qkv = torch.randn((n, length, 3 * heads * 64), generator=gen, device=card).bfloat16()
    grad = torch.randn((n, length, heads * 64), generator=gen, device=card).bfloat16()
    return qkv, grad


@pytest.mark.parametrize("n,length", [(SHORT_N, 16), (333, 1), (517, 7), (129, 32),
                                      (64, 17)])
def test_short_attention_kernels_match_plain(card, n, length):
    """The short-sequence kernels against their plain version in fp32 on the
    same bf16 inputs, at the cell's per-layer shape and at lengths that mask
    keys and rows (1, 7, 17, 32): the output and the gradient of ``qkv``.
    The kernels round the softmax weights to bf16 before the weighted sum,
    dS before dq and dk, and each result once (2^-8 relative each), so each
    value lies within 2^-6 of its tensor's largest; a wrong layout, mask or
    scale misses by the tensor's own size. One launch each way, inside the
    span's range."""
    from asltpu_torch.ops import short_attention_kernels as sa

    qkv, grad = _short_case(card, n, length, SHORT_HEADS, 21)
    qkv.requires_grad_()
    before = (sa.short_attention.launches, sa.short_attention_backward.launches)
    out = sa.short_attention(qkv, SHORT_HEADS)
    (got,) = torch.autograd.grad(out, qkv, grad)
    torch.cuda.synchronize()
    assert (sa.short_attention.launches, sa.short_attention_backward.launches) == (
        before[0] + 1, before[1] + 1)
    q32 = qkv.detach().float()
    want = sa.short_attention_plain(q32, SHORT_HEADS)
    want_grad = sa.short_attention_backward_plain(grad.float(), q32, SHORT_HEADS)
    for g, w in ((out, want), (got, want_grad)):
        assert g.shape == w.shape and g.dtype == torch.bfloat16 and g.is_contiguous()
        assert bool(torch.isfinite(g).all())
        assert float((g.float() - w).abs().max()) <= 2 ** -6 * float(w.abs().max())


def test_short_attention_backward_is_deterministic(card):
    """No atomics: two backward launches on the same inputs give the same
    bits."""
    from asltpu_torch.ops import short_attention_kernels as sa

    qkv, grad = _short_case(card, SHORT_N, 16, SHORT_HEADS, 22)
    first = sa.short_attention_backward(grad, qkv, SHORT_HEADS)
    second = sa.short_attention_backward(grad, qkv, SHORT_HEADS)
    assert torch.equal(first.view(torch.int16), second.view(torch.int16))


def test_short_attention_refuses_on_the_card(card):
    """fp32, heads of 32, 33 tokens and a strided projection: the op raises
    ``ValueError`` on the card and launches nothing (no fallback)."""
    from asltpu_torch.ops import short_attention_kernels as sa

    qkv, _ = _short_case(card, 8, 16, 2, 23)
    cases = [(qkv.float(), 2), (qkv, 4), (_short_case(card, 8, 33, 2, 23)[0], 2),
             (qkv.transpose(0, 1), 2)]
    before = (sa.short_attention.launches, sa.short_attention_backward.launches)
    for x, heads in cases:
        with pytest.raises(ValueError):
            sa.short_attention(x, heads)
        with pytest.raises(ValueError):
            sa.short_attention_backward(x[..., :x.shape[-1] // 3].contiguous(), x, heads)
    assert (sa.short_attention.launches, sa.short_attention_backward.launches) == before


def _swin_block(card, stage, shifted, seed=14):
    """One block of Video Swin-B's ``stage`` at its published width, fp32
    masters with seeded weights (linears std √(1/fan_in), the bias table
    N(0, 0.02²)), on the card; an fp32 input of the stage's tokens at
    batch 1 (16 × 56 / 2^stage square); and the stage's geometry in a
    dtype (the block computes in its input's dtype)."""
    from perfbench.core import weights
    from perfbench.reference import video_swin as ref

    from asltpu_torch.models import video_swin as vs

    cfg = {k: v for k, v in api.get_config("video_swin").__dict__.items() if k != "preprocess"}
    j = 1 if shifted else 0
    prefix = f"layers.{stage}.blocks.{j}."
    specs = [(n[len(prefix):], *rest) for n, *rest in ref.param_specs(cfg) if n.startswith(prefix)]
    dim, heads = 128 * 2 ** stage, (4, 8, 16, 32)[stage]
    blk = vs.SwinTransformerBlock3D(dim, heads, (8, 7, 7), 4, 0.0).to(card)
    weights.load_into(blk, weights.make_params(specs, seed, card))
    side = 56 // 2 ** stage
    gen = torch.Generator(card).manual_seed(seed)
    x = torch.randn((1, 16, side, side, dim), generator=gen, device=card)
    # Only the window of a model decides its geometry.
    shape = vs.VideoSwin(embed_dim=8, depths=(1,), num_heads=(1,), num_classes=1)

    def geometry(dtype):
        return shape.geometry((16, side, side), torch.device(card), dtype)[j]

    return blk, x, geometry


@pytest.mark.parametrize("stage", [0, 3])
@pytest.mark.parametrize("shifted", [False, True], ids=["window", "shifted"])
def test_a_full_width_swin_block_in_bf16_follows_fp32(card, stage, shifted):
    """Video Swin-B's first and last stage at their widths (128, heads 4;
    1024, heads 32; windows of 8×7×7, the last stage's shift temporal
    only), one block of each kind: bf16 on the card (the window attention
    kernel, reading the table by index and the shift regions) against the
    same block in fp32 on the CPU's plain path, on the same input. The
    branch (output − input) rounds its operands to bf16 at each of its ~6
    products (2^-8 relative each), so it lies within 2^-5 of its own
    largest value; a wrong bias, mask or window order misses by the
    branch's size."""
    from asltpu_torch.ops import attention as att
    from asltpu_torch.ops import window_attention_kernels as wk

    blk, x, geometry = _swin_block(card, stage, shifted)
    assert (geometry(torch.bfloat16).mask is not None) == shifted
    before = (wk.window_attention_kernel.launches, att.biased_attention.calls)
    with torch.no_grad():
        got = (blk(x.bfloat16(), geometry(torch.bfloat16)).float() - x.bfloat16().float()).cpu()
        assert (wk.window_attention_kernel.launches, att.biased_attention.calls) == (
            before[0] + 1, before[1])
        x = x.cpu()
        want = blk.cpu()(x, _on_cpu(geometry(torch.float32))) - x
    assert float((got - want).abs().max()) <= 2 ** -5 * float(want.abs().max())


def test_biased_attention_raises_where_its_kernel_does_not_apply(card):
    """float64 heads with a bias, which the memory-efficient kernel does
    not take: the call raises on the card rather than running the math
    backend, and counts nothing."""
    from asltpu_torch.ops import attention as att

    q = torch.randn((2, 4, 33, 32), dtype=torch.float64, device=card)
    bias = torch.zeros((1, 4, 33, 33), dtype=torch.float64, device=card)
    before = (att.biased_attention.calls, att.plain_attention.calls)
    with pytest.raises(RuntimeError):
        att.biased_attention(q, q, q, att.per_sequence(bias, 2))
    assert (att.biased_attention.calls, att.plain_attention.calls) == before


def _on_cpu(geo):
    from asltpu_torch.models import video_swin as vs

    return vs.Geometry(geo.window, geo.shift, geo.index.cpu(),
                       None if geo.mask is None else geo.mask.cpu(),
                       None if geo.regions is None else geo.regions.cpu())


@pytest.mark.parametrize("shifted", [False, True], ids=["window", "shifted"])
def test_the_bias_table_gets_the_plain_paths_gradient(card, shifted):
    """Video Swin-B's third stage (512 wide, 16 heads of 32, 16 × 14² tokens,
    8 windows of 392): the window sub-layer's gradient of the
    relative-position table, and of its input, in bf16 on the card's
    window kernels (the table's gradient summed over the windows and the
    clips inside the backward) against the same module in fp32 on the CPU's
    plain path. bf16 rounds the operands, P and dS (2^-8 relative each):
    within 2^-5 of each gradient's largest value; a gradient that missed
    the mask, the windows' sum or the gather misses by its own size."""
    from asltpu_torch.models import video_swin as vs
    from asltpu_torch.ops import attention as att
    from asltpu_torch.ops import window_attention_kernels as wk

    blk, x, geometry = _swin_block(card, 2, shifted)
    grad = torch.randn(x.shape, generator=torch.Generator(card).manual_seed(15), device=card)

    def grads(module, x, geo, g):
        x = x.detach().requires_grad_()
        y = vs.window_attention(module.attn, x, geo)
        table = module.attn.relative_position_bias_table
        return torch.autograd.grad(y, (table, x), g)

    launches = lambda: (wk.window_attention_kernel.launches,  # noqa: E731
                        wk.window_attention_kernel_backward.launches, att.biased_attention.calls)
    before = launches()
    got = grads(blk, x.bfloat16(), geometry(torch.bfloat16), grad.bfloat16())
    assert launches() == (before[0] + 1, before[1] + 1, before[2])
    want = grads(blk.cpu(), x.cpu(), _on_cpu(geometry(torch.float32)), grad.cpu())
    for g, w in zip(got, want):
        assert float(w.abs().max()) > 0
        assert float((g.float().cpu() - w).abs().max()) <= 2 ** -5 * float(w.abs().max())


def test_swin_trains_and_predicts_on_the_card_with_its_geometry_built_once(card):
    """A small Video Swin (width 64, heads of 32, depths (2, 2), window
    4×7×7 over 8 frames of 112²), bf16, through ``build_trainable`` →
    ``make_train_step`` for three steps and ``load_model`` → ``predict``:
    each step launches the window kernel once a block forward and once
    backward, and makes no biased, fused or plain call;
    the shift mask is built on the first step only; loss and logits are
    finite, and one clip alone (a clip's windows, the whole batch, in the
    shifted blocks' bias) predicts what it does in the batch."""
    from asltpu_torch.config import TrainConfig
    from asltpu_torch.models import video_swin as vs
    from asltpu_torch.ops import attention as att
    from asltpu_torch.ops import window_attention_kernels as wk
    from asltpu_torch.train import loop

    kw = dict(num_classes=7, num_frames=8, embed_dim=64, depths=(2, 2), num_heads=(2, 4),
              window_size=(4, 7, 7), preprocess={"num_frames": 8, "staging_size": (128, 128),
                                                 "resize_short": 128, "crop": 112})
    frames = np.random.default_rng(16).integers(0, 256, (2, 8, 128, 128, 3), np.uint8)
    model = api.build_trainable("video_swin", seed=3, device=card, **kw)
    tcfg = TrainConfig(batch_size=2)
    state = loop.create_train_state(model.module, tcfg, seed=3)
    step = loop.make_train_step(tcfg, model.cfg.preprocess)

    def counts():
        return (wk.window_attention_kernel.launches, wk.window_attention_kernel_backward.launches,
                att.biased_attention.calls, att.fused_attention.calls,
                att.plain_attention.calls, vs.shift_mask.builds)

    seen = [counts()]
    for _ in range(3):
        state, metrics = step(state, frames, np.array([1, 2], np.int32))
        assert bool(torch.isfinite(metrics["loss"]))
        seen.append(counts())
    # Stage 1 (4 × 28²: shifted by (2, 3, 3)) builds one mask; stage 2
    # (4 × 14², shifted too) another; none after.
    assert [tuple(b - a for a, b in zip(seen[k], seen[k + 1])) for k in range(3)] == [
        (4, 4, 0, 0, 0, 2), (4, 4, 0, 0, 0, 0), (4, 4, 0, 0, 0, 0)]
    served = api.load_model("video_swin", seed=3, **kw)
    _, logits = api.predict(served, frames)
    assert np.isfinite(logits).all() and logits.shape == (2, 7)
    _, one = api.predict(served, frames[1])
    # bf16: another batch size may tile the products otherwise.
    np.testing.assert_allclose(one, logits[1], rtol=0, atol=0.05 * float(np.abs(logits).max()))


def _window_case(card, stage, shifted, batch, seed=30):
    """Video Swin-B's ``stage`` at batch ``batch``: the packed projection of
    its windows of 8×7×7 (bf16), a bias table of the stage's heads (fp32,
    N(0, 1), as large as the scores so that a wrong gather shows), the
    stage's shift regions where ``shifted``, and an output gradient."""
    from asltpu_torch.models import video_swin as vs

    heads, side = (4, 8, 16, 32)[stage], 56 >> stage
    size = (16, side, side)
    window, shift = vs.clip_window(size, (8, 7, 7), (4, 3, 3))
    regions = vs.shift_regions(size, window, shift, card) if shifted else None
    n = batch * 2 * (side // 7) ** 2
    gen = torch.Generator(card).manual_seed(seed + stage)
    qkv = torch.randn((n, 392, 3 * 32 * heads), generator=gen, device=card).bfloat16()
    table = torch.randn((2535, heads), generator=gen, device=card)
    grad = torch.randn((n, 392, 32 * heads), generator=gen, device=card).bfloat16()
    return qkv, heads, table, regions, grad


@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("shifted", [False, True], ids=["window", "shifted"])
@pytest.mark.parametrize("stage", [0, 1, 2, 3])
def test_window_attention_kernels_match_plain(card, stage, shifted, batch):
    """The window kernels at each of Video Swin-B's stages (heads 4, 8, 16,
    32 of 32; 392 tokens; the last stage shifted in time only) against
    their plain version in fp32 on the same bf16 inputs: the output and its
    log-sum-exp; then the backward against the plain backward given the
    kernel's output and log-sum-exp, ``qkv``'s gradient and the table's.
    The kernels carry P and dS into their products as bf16 pairs (16
    bits) and round each result once to bf16 (2^-9 relative), so the
    output and ``qkv``'s gradient lie within 2^-8 of their largest value,
    and the output plus its rest within 2^-12; the table's gradient sums
    fp32 dS, in an order the atomics change from run to run, and is within
    2^-8 of its largest. A wrong index, mask, window order or sum misses by
    the tensor's own size. One launch each way."""
    from asltpu_torch.ops import window_attention_kernels as wk

    qkv, heads, table, regions, grad = _window_case(card, stage, shifted, batch)
    leaf, table_leaf = qkv.clone().requires_grad_(), table.clone().requires_grad_()
    before = (wk.window_attention_kernel.launches, wk.window_attention_kernel_backward.launches)
    out, rest, lse = torch.ops.asltpu_torch.window_attention(leaf, heads, table_leaf,
                                                             [8, 7, 7], regions)
    got_qkv, got_table = torch.autograd.grad(out, (leaf, table_leaf), grad)
    torch.cuda.synchronize()
    assert (wk.window_attention_kernel.launches,
            wk.window_attention_kernel_backward.launches) == (before[0] + 1, before[1] + 1)
    q32 = qkv.float()
    want, want_rest, want_lse = wk.window_attention_plain(q32, heads, table, (8, 7, 7), regions)
    assert float((lse - want_lse).abs().max()) <= 1e-3
    want_qkv, want_table = wk.window_attention_backward_plain(
        grad.float(), q32, out.detach().float(), rest.detach().float(), lse.detach(), heads,
        table, (8, 7, 7), regions)
    for g, w, tol in ((out.float() + rest.float(), want, 2 ** -12), (out, want, 2 ** -8),
                      (got_qkv, want_qkv, 2 ** -8), (got_table, want_table, 2 ** -8)):
        assert g.shape == w.shape and g.is_contiguous() and bool(torch.isfinite(g).all())
        assert float(w.abs().max()) > 0
        assert float((g.float() - w).abs().max()) <= tol * float(w.abs().max())
    assert out.dtype == got_qkv.dtype == torch.bfloat16 and got_table.dtype == torch.float32


def test_window_attention_backward_writes_qkv_gradient_deterministically(card):
    """Two backward launches on the same inputs: the same bits of ``qkv``'s
    gradient (no atomics there); the table's, summed with fp32 atomics,
    within 2^-16 of its largest value."""
    from asltpu_torch.ops import window_attention_kernels as wk

    qkv, heads, table, regions, grad = _window_case(card, 2, True, 2)
    out, rest, lse = torch.ops.asltpu_torch.window_attention(qkv, heads, table, [8, 7, 7],
                                                             regions)
    first, second = (wk.window_attention_kernel_backward(grad, qkv, out, rest, lse, heads, table,
                                                         (8, 7, 7), regions) for _ in range(2))
    assert torch.equal(first[0].view(torch.int16), second[0].view(torch.int16))
    assert float((first[1] - second[1]).abs().max()) <= 2 ** -16 * float(first[1].abs().max())


def test_window_attention_refuses_on_the_card(card):
    """Windows of 449 tokens, heads of 64, fp32 and a projection off a
    16-byte boundary: each direction of the op raises ``ValueError`` on the
    card before any launch (no fallback), and the counters do not move."""
    from asltpu_torch.ops import window_attention_kernels as wk

    qkv, heads, table, _, _ = _window_case(card, 3, False, 1)
    long = torch.zeros((2, 449, 3 * 32 * heads), dtype=torch.bfloat16, device=card)
    flat = torch.zeros(qkv.numel() + 8, dtype=torch.bfloat16, device=card)
    cases = [
        (long, heads, torch.zeros((15 ** 3, heads), device=card), (8, 8, 8)),
        (qkv, heads // 2, torch.zeros((2535, heads // 2), device=card), (8, 7, 7)),
        (qkv.float(), heads, table, (8, 7, 7)),
        (flat[1:qkv.numel() + 1].view(qkv.shape), heads, table, (8, 7, 7)),
    ]
    before = (wk.window_attention_kernel.launches, wk.window_attention_kernel_backward.launches)
    for x, h, t, window in cases:
        n, length, width = x.shape
        with pytest.raises(ValueError):
            wk.window_attention_kernel(x, h, t, window)
        out = torch.zeros((n, length, width // 3), dtype=torch.bfloat16, device=card)
        lse = torch.zeros((n, h, length), device=card)
        with pytest.raises(ValueError):
            wk.window_attention_kernel_backward(out, x, out, out, lse, h, t, window)
    assert (wk.window_attention_kernel.launches,
            wk.window_attention_kernel_backward.launches) == before


@pytest.mark.parametrize("length,n", [(785, 16), (16, 784)])
def test_attention_without_a_bias_is_the_unbiased_path_bit_for_bit(card, length, n):
    """TimeSformer's two attentions through ``attention(qkv, heads)`` with no
    bias: the short-sequence op on the packed projection (16 tokens) or
    ``fused_attention`` on its q/k/v views (785), the output bit for bit
    and the packed gradient too, but where the backward adds its tiles'
    dQ in a run's own order (cuDNN's at 785: each value within one bf16
    rounding, 2^-7 of the largest); the biased kernel never called."""
    from asltpu_torch.ops import attention as att
    from asltpu_torch.ops import short_attention_kernels as sa

    gen = torch.Generator(card).manual_seed(17)
    qkv = torch.randn((n, length, 3 * 768), generator=gen, device=card).bfloat16()
    grad = torch.randn((n, length, 768), generator=gen, device=card).bfloat16()

    def run(fn):
        x = qkv.clone().requires_grad_()
        out = fn(x)
        return out, torch.autograd.grad(out, x, grad)[0]

    def unbiased(x):
        if length <= sa.MAX_LEN:
            return sa.short_attention(x, 12)
        q, k_, v = (x.view(n, length, 3, 12, 64)[:, :, i].transpose(1, 2) for i in range(3))
        return att.fused_attention(q, k_, v).transpose(1, 2).reshape(n, length, 768)

    before = att.biased_attention.calls
    got, want = run(lambda x: att.attention(x, 12)), run(unbiased)
    assert att.biased_attention.calls == before
    assert torch.equal(got[0], want[0])
    if length <= sa.MAX_LEN:
        assert torch.equal(got[1], want[1])
    else:
        assert float((got[1] - want[1]).abs().max()) <= 2 ** -7 * float(want[1].abs().max())


# A small MViTv2 (widths 16 and 32, heads of 16, a q-strided transition, k/v
# at the adaptive stride (1, 2, 2)) over 4 frames of 32² staged at 40².
MVIT_SMALL = dict(num_classes=10, num_frames=4, embed_dim=16, depth=3, dim_mul=((1, 2.0),),
                  head_mul=((1, 2.0),), pool_q_stride=((0, 1, 1, 1), (1, 1, 2, 2), (2, 1, 1, 1)),
                  pool_kv_stride_adaptive=(1, 2, 2), drop_path_rate=0.0, dropout=0.0)


def _mvit_small(dtype):
    pp = dict(num_frames=4, staging_size=(40, 40), resize_short=40, crop=32, out_dtype=dtype)
    return dict(MVIT_SMALL, compute_dtype=dtype, preprocess=pp)


def test_a_small_mvit_step_on_the_card_follows_the_reference(card):
    """One ``make_train_step`` step of the small MViTv2 in fp32 on the card
    (the memory-efficient kernel with the bias and its gradient) against
    the reference's step in fp32 on the card from the same weights: the
    loss within 1e-4 and every leaf's gradient within 1e-3 of its norm
    (other summation orders in the kernel; norm_k's bias, whose exact
    gradient is 0, left out), the tables' and pools' among them; and the
    same step in bf16 lands within bf16's reach of the loss."""
    from asltpu_torch.config import TrainConfig
    from asltpu_torch.train import loop
    from perfbench.core import weights
    from perfbench.reference import mvit as ref

    kw = _mvit_small("float32")
    cfg = dict(MVIT_SMALL, patch_kernel=(3, 7, 7), patch_stride=(2, 4, 4),
               patch_padding=(1, 3, 3), num_heads=1, pool_kvq_kernel=(3, 3, 3), mlp_ratio=4,
               preprocess=dict(kw["preprocess"], staging_size=[40, 40], mean=[0.485, 0.456, 0.406],
                               std=[0.229, 0.224, 0.225]))
    p = weights.make_params(ref.param_specs(cfg), 17, card)
    x = _frames(18, (4, 4, 40, 40, 3), card)
    labels = torch.tensor([1, 7, 3, 3], device=card)
    train = dict(learning_rate=1e-3, warmup_steps=1, num_steps=10, weight_decay=1e-4,
                 label_smoothing=0.1, grad_clip_norm=1.0)
    trainer = ref.Trainer(p, cfg, train, 19)
    want_loss, want_grads = trainer.step(x, labels)
    losses = {}
    for dtype in ("float32", "bfloat16"):
        model = api.build_trainable("mvit_v2", device=card, **_mvit_small(dtype))
        weights.load_into(model.module, p)
        tcfg = TrainConfig(batch_size=4, **train)
        state = loop.create_train_state(model.module, tcfg, seed=19)
        _, metrics = loop.make_train_step(tcfg, model.cfg.preprocess)(state, x, labels)
        losses[dtype] = float(metrics["loss"])
        if dtype == "float32":
            named = dict(model.module.named_parameters())
            for name, g in want_grads.items():
                if name.endswith("norm_k.bias"):
                    continue
                err = float((named[name].grad - g).norm())
                assert err <= 1e-3 * float(g.norm()) + 1e-7, name
    assert losses["float32"] == pytest.approx(want_loss, rel=1e-4)
    assert losses["bfloat16"] == pytest.approx(want_loss, rel=2e-2)


def test_mvit_counts_its_calls_and_bias_on_the_card(card):
    """A bf16 forward of the small MViTv2 through ``load_model`` →
    ``predict``: one biased call a block and no fused or plain one, three
    pools a block, the bias's storage with its rows padded to 16 keys
    (bf16 [B, h, Lq, Lk]: [2, 1, 129, 33 → 48], [2, 2, 33, 129 → 144],
    [2, 2, 33, 33 → 48]); and a bias laid out otherwise is refused
    rather than copied."""
    from asltpu_torch.models import mvit
    from asltpu_torch.ops import attention as att

    model = api.load_model("mvit_v2", seed=5, device=card, **_mvit_small("bfloat16"))

    def counts():
        return (att.biased_attention.calls, att.fused_attention.calls, att.plain_attention.calls,
                mvit.mvit_pool.calls, mvit.rel_pos_bias.bytes)

    before = counts()
    _, logits = api.predict(model, _frames(20, (2, 4, 40, 40, 3), "cpu").numpy())
    assert np.isfinite(logits).all()
    got = tuple(b - a for a, b in zip(before, counts()))
    assert got == (3, 0, 0, 9, 2 * (2 * 129 * 48 + 4 * 33 * 144 + 4 * 33 * 48))
    q = torch.randn((2, 1, 20, 16), device=card, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="bias_storage"):
        att.pooled_attention(q, q[:, :, :7], q[:, :, :7],
                             torch.zeros((2, 1, 20, 7), device=card, dtype=torch.bfloat16))
