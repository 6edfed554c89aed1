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


def _emulate_rgb_kernel(frames, cfg, base=0):
    """The rgb kernel tile by tile: each band's input rows staged into a
    buffer of ``stage_rows × pitch`` bytes at the offsets the kernel uses
    (the span's start modulo 16, for an input whose first byte sits at
    ``base`` modulo 16), then every output value from 4 taps read there with
    band-relative rows, in fp32 (where the kernel fuses a product into a
    sum it rounds once less, within F32_ATOL)."""
    b, t, hs, ws, _ = frames.shape
    crop = cfg.crop
    out_bytes = cfg.out_torch_dtype.itemsize
    plan = tk.rgb_band_plan((hs, ws), cfg.resize_short, crop, out_bytes)
    tables = tk._rgb_tables((hs, ws), cfg.resize_short, crop, plan)
    _, k = tk._rgb_constants(torch.device("cpu"), (hs, ws), cfg.resize_short,
                             crop, out_bytes, cfg.mean, cfg.std)
    rows = tables[:4 * crop].reshape(crop, 4)
    cols = tables[4 * crop:8 * crop].reshape(crop, 4)
    wy, wx = rows[:, 2:].view(np.float32), cols[:, 2:].view(np.float32)
    rb = 3 * ws
    flat = frames.reshape(b * t, hs * rb)
    out = np.empty((b * t, crop, crop, 3), np.float32)
    ch = np.arange(3)
    for f in range(b * t):
        for band, (y0, ny) in enumerate(plan.bands):
            buf = np.zeros(plan.stage_rows * plan.pitch, np.uint8)
            offs = []
            for s in range(ny):
                src = (y0 + s) * rb + 3 * plan.col0
                off = (base + f * hs * rb + src) % 16
                assert off + plan.span <= plan.pitch
                buf[s * plan.pitch + off:s * plan.pitch + off + plan.span] = (
                    flat[f, src:src + plan.span])
                offs.append(s * plan.pitch + off)
            for oy in range(band * plan.rows, min((band + 1) * plan.rows, crop)):
                rl, rh = offs[rows[oy, 0] - y0], offs[rows[oy, 1] - y0]
                taps = [buf[r + cols[:, i, None] + ch].astype(np.float32)
                        for r in (rl, rh) for i in (0, 1)]  # p00 p01 p10 p11
                col_lo = wy[oy, 0] * taps[0] + wy[oy, 1] * taps[2]
                col_hi = wy[oy, 0] * taps[1] + wy[oy, 1] * taps[3]
                v = wx[:, 0, None] * col_lo + wx[:, 1, None] * col_hi
                out[f, oy] = v * k[:3] + k[3:]
    return out.reshape(b, t, crop, crop, 3)


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


@pytest.mark.parametrize("staging,short,crop,base", [
    ((60, 44), 40, 40, 3), ((64, 58), 56, 50, 0), ((64, 58), 56, 50, 9),
    ((240, 320), 256, 224, 5),
])
def test_rgb_kernel_staging_at_any_alignment(staging, short, crop, base):
    """Unaligned inputs and rows (132 B and 174 B rows, frames at odd
    offsets) and a crop whose output rows are not 16-byte multiples."""
    cfg = TCfg(num_frames=2, staging_size=staging, resize_short=short,
               crop=crop, out_dtype="float32")
    frames = _frames(10, (1, 2, *staging, 3))
    plain = _np(tk.preprocess_rgb_plain(torch.from_numpy(frames), cfg))
    np.testing.assert_allclose(_emulate_rgb_kernel(frames, cfg, base), plain,
                               atol=F32_ATOL)


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_rgb_kernel_arithmetic_is_exact_at_the_main_shape(out_dtype):
    """At the main path's identity resize every tap sum is exact, so the
    kernel's arithmetic gives the plain version's bits."""
    cfg = TCfg(num_frames=1, out_dtype=out_dtype)
    frames = _frames(11, (1, 1, 256, 256, 3))
    plain = tk.preprocess_rgb_plain(torch.from_numpy(frames), cfg)
    got = torch.from_numpy(_emulate_rgb_kernel(frames, cfg)).to(plain.dtype)
    assert torch.equal(got, plain)


# (staging, resize_short, crop): the main path, chip_smoke.py's ragged case,
# every RGB_CASES shape, two crop-50 shapes and a 5x downscale.
PLAN_CASES = [((256, 256), 256, 224), ((240, 320), 256, 224), *RGB_CASES,
              ((64, 58), 56, 50), ((60, 44), 50, 50), ((480, 640), 96, 80)]


@pytest.mark.parametrize("staging,short,crop", PLAN_CASES)
def test_rgb_band_plan_covers_every_tap(staging, short, crop):
    plan = tk.rgb_band_plan(staging, short, crop)
    idx, w = tk.rgb_taps(staging, short, crop)
    assert plan.pitch % 16 == 0 and plan.pitch >= plan.span + 15
    assert plan.smem_bytes == (4 * tk.rgb_smem_table_words(crop) + 256 * 24 * 2
                               + 2 * plan.stage_rows * plan.pitch)
    fp32 = tk.rgb_band_plan(staging, short, crop, 4)
    assert fp32.smem_bytes - plan.smem_bytes == 256 * 24 * 2 and fp32.bands == plan.bands
    assert plan.smem_bytes <= 227 * 1024
    assert len(plan.bands) == -(-crop // plan.rows)
    for band, (y0, ny) in enumerate(plan.bands):
        assert 1 <= ny <= plan.stage_rows
        for oy in range(band * plan.rows, min((band + 1) * plan.rows, crop)):
            assert y0 <= idx[0, oy] <= idx[1, oy] < y0 + ny
    assert 3 * (idx[2:4].max() - plan.col0 + 1) == plan.span
    assert idx[2:4].min() == plan.col0
    # Only taps that weigh nothing were moved.
    ref_idx, ref_w = trm.resize_crop_taps(staging, short, crop)
    np.testing.assert_array_equal(w, ref_w)
    np.testing.assert_array_equal(idx[w != 0], ref_idx[ref_w != 0])


def test_rgb_band_plan_at_the_main_shape():
    """The main path stages 16 rows of the 672-byte centre per band, 14
    bands a frame, and every group of 8 columns is unit taps."""
    plan = tk.rgb_band_plan((256, 256), 256, 224)
    assert (plan.rows, plan.stage_rows, plan.col0, plan.span, plan.pitch) == (
        16, 16, 16, 672, 688)
    assert plan.bands == tuple((16 + 16 * i, 16) for i in range(14))
    tables = tk._rgb_tables((256, 256), 256, 224, plan)
    assert (tables[8 * 224:8 * 224 + 28] == 1).all()


def test_rgb_band_plan_refuses_what_no_band_fits():
    with pytest.raises(ValueError, match="shared memory"):
        tk.rgb_band_plan((7300, 7300), 7300, 7300)


@pytest.mark.parametrize("size", [48, 64, 224, 52])
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
