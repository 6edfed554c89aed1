"""asltpu_torch.ops preprocess against asltpu.ops preprocess on the same
uint8 input, and the kernels' plain versions (and the arithmetic the CUDA
kernels do, emulated in numpy) against the Pallas kernels in interpret
mode."""

import numpy as np
import pytest
import torch

from asltpu.config import PreprocessConfig as JCfg
from asltpu.ops import preprocess as jpp
from asltpu.ops import resize_mm as jrm
from asltpu.ops.preprocess_pallas import (
    preprocess_clip_pallas,
    preprocess_clip_yuv420_pallas,
)
from asltpu_torch.config import PreprocessConfig as TCfg
from asltpu_torch.ops import preprocess as tpp
from asltpu_torch.ops import preprocess_kernels as tk
from asltpu_torch.ops import resize_mm as trm

F32_ATOL = 1e-4
BF16_ATOL = 2e-2  # one bf16 ulp at |x|≈2.6 is 0.0156

# (staging, resize_short, crop): downscale square, downscale non-square,
# upscale non-square, identity resize + crop.
RGB_CASES = [((64, 64), 56, 48), ((64, 80), 56, 48), ((48, 64), 56, 48),
             ((56, 56), 56, 48)]


def _cfgs(**kw):
    return JCfg(**kw), TCfg(**kw)


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      dtype=np.float32)


def _frames(seed, shape):
    return np.random.default_rng(seed).integers(0, 256, shape, np.uint8)


def test_uniform_sample_indices_equal():
    for raw in (1, 4, 15, 16, 17, 100, 333):
        for out in (1, 8, 16, 64):
            np.testing.assert_array_equal(
                tpp.uniform_sample_indices(raw, out),
                jpp.uniform_sample_indices(raw, out))
    with pytest.raises(ValueError):
        tpp.uniform_sample_indices(0, 4)


@pytest.mark.parametrize("hw,short", [
    ((240, 320), 256), ((320, 240), 256), ((4, 6), 3), ((6, 4), 3),
    ((4, 10), 3), ((8, 20), 5), ((100, 100), 7), ((480, 854), 256),
])
def test_resize_plan_equal(hw, short):
    assert tpp.resize_plan(hw, short) == jpp.resize_plan(hw, short)


def test_resize_plan_rounds_half_to_even():
    assert tpp.resize_plan((4, 6), 3) == (3, 4)   # 4.5 → 4
    assert tpp.resize_plan((4, 10), 3) == (3, 8)  # 7.5 → 8


@pytest.mark.parametrize("staging,short,crop", RGB_CASES + [((240, 320), 256, 224)])
def test_sampling_matrices_bit_equal(staging, short, crop):
    got = trm.resize_crop_matrices(staging, short, crop)
    want = jrm.resize_crop_matrices(staging, short, crop)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.float32
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("staging,short,crop", RGB_CASES + [((240, 320), 256, 224)])
def test_tap_tables_encode_the_matrices(staging, short, crop):
    """The rgb kernel's tables scatter back to the sampling matrices: where
    the clamp makes lo == hi both weights land in one column."""
    idx, w = trm.resize_crop_taps(staging, short, crop)
    rh, rw = trm.resize_crop_matrices(staging, short, crop)
    for mat, (lo, hi, wlo, whi) in ((rh, (idx[0], idx[1], w[0], w[1])),
                                    (rw, (idx[2], idx[3], w[2], w[3]))):
        back = np.zeros_like(mat)
        rows = np.arange(crop)
        back[rows, lo] += wlo
        back[rows, hi] += whi
        np.testing.assert_array_equal(back, mat)
    assert (idx[1] >= idx[0]).all() and (idx[1] - idx[0] <= 1).all()


def test_crop_that_does_not_fit_raises():
    with pytest.raises(ValueError, match="exceeds resized dims"):
        trm.resize_crop_taps((64, 64), 40, 48)


@pytest.mark.parametrize("staging,short,crop", RGB_CASES)
@pytest.mark.parametrize("out_dtype,atol", [("float32", F32_ATOL),
                                            ("bfloat16", BF16_ATOL)])
@pytest.mark.parametrize("fn", ["interp", "mm", "dispatch"])
def test_rgb_functions_match_jax(staging, short, crop, out_dtype, atol, fn):
    jc, tc = _cfgs(num_frames=2, staging_size=staging, resize_short=short,
                   crop=crop, out_dtype=out_dtype)
    frames = _frames(1, (2, 2, *staging, 3))
    jfn, tfn = {
        "interp": (jpp.preprocess_clip_jnp, tpp.preprocess_clip_interp),
        "mm": (jpp.preprocess_clip_mm, tpp.preprocess_clip_mm),
        "dispatch": (jpp.preprocess_clip, tpp.preprocess_clip),
    }[fn]
    want = jfn(frames, jc)
    got = tfn(torch.from_numpy(frames), tc)
    assert tuple(got.shape) == want.shape == (2, 2, crop, crop, 3)
    assert str(got.dtype) == f"torch.{out_dtype}"
    np.testing.assert_allclose(_np(got), _np(want), atol=atol)


@pytest.mark.parametrize("size,short,crop", [(48, 48, 48), (64, 64, 64),
                                             (64, 56, 48), (48, 56, 48)])
@pytest.mark.parametrize("out_dtype,atol", [("float32", F32_ATOL),
                                            ("bfloat16", BF16_ATOL)])
def test_yuv420_functions_match_jax(size, short, crop, out_dtype, atol):
    jc, tc = _cfgs(num_frames=2, staging_size=(size, size), resize_short=short,
                   crop=crop, out_dtype=out_dtype, staging_format="yuv420")
    planes = _frames(2, (2, 2, size * 3 // 2, size))
    rgb_want = jpp.yuv420_planes_to_rgb(planes, size, size)
    rgb_got = tpp.yuv420_planes_to_rgb(torch.from_numpy(planes), size, size)
    np.testing.assert_allclose(_np(rgb_got), _np(rgb_want), atol=1e-3)
    for jfn, tfn in ((jpp.preprocess_clip_yuv420, tpp.preprocess_clip_yuv420),
                     (jpp.preprocess_clip, tpp.preprocess_clip)):
        want = jfn(planes, jc)
        got = tfn(torch.from_numpy(planes), tc)
        assert tuple(got.shape) == want.shape == (2, 2, crop, crop, 3)
        np.testing.assert_allclose(_np(got), _np(want), atol=atol)


@pytest.mark.parametrize("out_dtype,atol", [("float32", F32_ATOL),
                                            ("bfloat16", BF16_ATOL)])
def test_normalize_only_matches_jax(out_dtype, atol):
    jc, tc = _cfgs(num_frames=2, staging_size=(48, 48), resize_short=48,
                   crop=48, host_resize_short=56, out_dtype=out_dtype)
    assert tpp._thin_mode_identity(tc) and jpp._thin_mode_identity(jc)
    frames = _frames(3, (2, 2, 48, 48, 3))
    for jfn, tfn in ((jpp.preprocess_clip_normalize_only,
                      tpp.preprocess_clip_normalize_only),
                     (jpp.preprocess_clip, tpp.preprocess_clip)):
        np.testing.assert_allclose(
            _np(tfn(torch.from_numpy(frames), tc)), _np(jfn(frames, jc)),
            atol=atol)
    assert not tpp._thin_mode_identity(TCfg())


# ---------------------------------------------------------------------------
# The kernels' plain versions against the Pallas kernels (interpret mode),
# with the parameter sets of tests/unit/test_preprocess_pallas.py.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("staging,short,crop",
                         [((64, 64), 56, 48), ((64, 80), 56, 48), ((56, 56), 56, 48)])
def test_rgb_plain_matches_pallas(staging, short, crop):
    jc, tc = _cfgs(num_frames=2, staging_size=staging, resize_short=short,
                   crop=crop, out_dtype="float32")
    frames = _frames(4, (2, 2, *staging, 3))
    pallas = _np(preprocess_clip_pallas(frames, jc, interpret=True))
    plain = _np(tk.preprocess_rgb(torch.from_numpy(frames), tc))
    np.testing.assert_allclose(plain, pallas, atol=F32_ATOL)
    # The repo's own bound against the gather-based jnp reference.
    np.testing.assert_allclose(
        plain, _np(jpp.preprocess_clip_jnp(frames, jc)), atol=2e-2)


def test_rgb_plain_bf16_matches_pallas():
    jc, tc = _cfgs(num_frames=1, staging_size=(56, 56), resize_short=56,
                   crop=48, out_dtype="bfloat16")
    frames = _frames(5, (1, 1, 56, 56, 3))
    pallas = preprocess_clip_pallas(frames, jc, interpret=True)
    plain = tk.preprocess_rgb(torch.from_numpy(frames), tc)
    assert plain.dtype == torch.bfloat16 and str(pallas.dtype) == "bfloat16"
    np.testing.assert_allclose(_np(plain), _np(pallas), atol=BF16_ATOL)


@pytest.mark.parametrize("size", [48, 64])
def test_yuv420_plain_matches_pallas(size):
    jc, tc = _cfgs(num_frames=2, staging_size=(size, size), resize_short=size,
                   crop=size, out_dtype="float32", staging_format="yuv420")
    planes = _frames(6, (2, 2, size * 3 // 2, size))
    pallas = _np(preprocess_clip_yuv420_pallas(planes, jc, interpret=True))
    plain = _np(tk.preprocess_yuv420(torch.from_numpy(planes), tc))
    np.testing.assert_allclose(plain, pallas, atol=F32_ATOL)


def test_yuv420_plain_bf16_matches_pallas():
    jc, tc = _cfgs(num_frames=1, staging_size=(48, 48), resize_short=48,
                   crop=48, out_dtype="bfloat16", staging_format="yuv420")
    planes = _frames(7, (1, 1, 72, 48))
    pallas = preprocess_clip_yuv420_pallas(planes, jc, interpret=True)
    plain = tk.preprocess_yuv420(torch.from_numpy(planes), tc)
    # bf16 cast at the end: 1 ulp at |x|≈4 is 0.03.
    np.testing.assert_allclose(_np(plain), _np(pallas), atol=4e-2)


# ---------------------------------------------------------------------------
# The CUDA kernels' arithmetic, emulated in numpy from the very constants the
# wrappers hand to the card, against the plain versions.
# ---------------------------------------------------------------------------


def _emulate_rgb_kernel(frames, cfg):
    b, t, hs, ws, _ = frames.shape
    idx, w = trm.resize_crop_taps((hs, ws), cfg.resize_short, cfg.crop)
    _, _, consts = tk._rgb_constants(torch.device("cpu"), (hs, ws),
                                     cfg.resize_short, cfg.crop, cfg.mean, cfg.std)
    k = consts.numpy()
    x = frames.astype(np.float32)
    r0, r1 = x[:, :, idx[0]], x[:, :, idx[1]]  # [B, T, crop, Ws, 3]
    wy = [w[0][:, None, None], w[1][:, None, None]]
    col_lo = wy[0] * r0[:, :, :, idx[2]] + wy[1] * r1[:, :, :, idx[2]]
    col_hi = wy[0] * r0[:, :, :, idx[3]] + wy[1] * r1[:, :, :, idx[3]]
    v = w[2][:, None] * col_lo + w[3][:, None] * col_hi
    return (v * k[:3] + k[3:]).astype(np.float32)


def _emulate_yuv_kernel(planes, cfg):
    b, t, hp, ws = planes.shape
    hs = hp * 2 // 3
    k = tk._yuv_constants(torch.device("cpu"), cfg.mean, cfg.std).numpy()
    flat = planes.reshape(b, t, -1).astype(np.float32)
    yy, xx = np.mgrid[0:hs, 0:ws]
    chroma = (yy // 2) * (ws // 2) + xx // 2
    m = np.maximum(flat[..., yy * ws + xx] - 16.0, 0.0)[..., None]
    u = (flat[..., hs * ws + chroma] - 128.0)[..., None]
    v = (flat[..., hs * ws + (hs // 2) * (ws // 2) + chroma] - 128.0)[..., None]
    acc = m * k[0:3] + u * k[3:6] + v * k[6:9] + k[9:12]
    return np.clip(acc, k[9:12], k[12:15]).astype(np.float32)


@pytest.mark.parametrize("staging,short,crop", RGB_CASES + [((60, 44), 40, 40)])
def test_rgb_kernel_arithmetic_matches_plain(staging, short, crop):
    cfg = TCfg(num_frames=2, staging_size=staging, resize_short=short,
               crop=crop, out_dtype="float32")
    frames = _frames(8, (1, 2, *staging, 3))
    plain = _np(tk.preprocess_rgb_plain(torch.from_numpy(frames), cfg))
    np.testing.assert_allclose(_emulate_rgb_kernel(frames, cfg), plain,
                               atol=F32_ATOL)


@pytest.mark.parametrize("size", [48, 64, 224])
def test_yuv420_kernel_arithmetic_matches_plain(size):
    cfg = TCfg(num_frames=1, staging_size=(size, size), resize_short=size,
               crop=size, out_dtype="float32", staging_format="yuv420")
    planes = _frames(9, (1, 1, size * 3 // 2, size))
    # The kernel's clamp-after-normalize equals the plain clip-then-normalize,
    # also where the clip bites (sub-black and saturated luma rows).
    planes[..., :4, :] = 0
    planes[..., 4:8, :] = 255
    plain = _np(tk.preprocess_yuv420_plain(torch.from_numpy(planes), cfg))
    np.testing.assert_allclose(_emulate_yuv_kernel(planes, cfg), plain,
                               atol=F32_ATOL)
