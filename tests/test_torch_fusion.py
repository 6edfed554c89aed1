"""two_stream in the port against the JAX package on the CPU (MobileNetV2
width 0.35, d_model 64, 4 heads, 2 fusion layers, T = 4): the
cross-attention block and the whole model at fp32 and bf16, ``predict``
through both packages, its landmark checks, and ``stream_predict`` with
``landmarks_for``. Weights carry across through ``state_dict_from_jax``
with BN statistics, LayerNorm scales and biases randomised."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asltpu import api as japi
from asltpu import config as jconfig
from asltpu.data.synthetic import write_video
from asltpu.models import fusion as jfusion
from asltpu_torch import api as tapi
from asltpu_torch import ckpt as tckpt
from asltpu_torch.data.synthetic import synthetic_landmarks
from asltpu_torch.models import fusion as tfusion
from asltpu_torch.models.common import cast_for_compute
from test_torch_models import draw_variables

ATOL = 3e-4  # fp32 (tests/unit/test_parity_fusion.py:14)
LOGIT_ATOL = 1e-3  # fp32 end to end (tests/test_torch_api.py)
TINY = dict(num_classes=7, width_mult=0.35, d_model=64, num_heads=4, num_fusion_layers=2)
PP = {"num_frames": 4, "staging_size": (40, 48), "resize_short": 36, "crop": 32}


def _bf16_ulp(m: float) -> float:
    return 2.0 ** (np.floor(np.log2(m)) - 7)


def _tokens(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_attention_block_matches_flax(dtype):
    """Two token streams of different lengths (5 and 3). bf16: both
    outputs within two bf16 ulps of their largest value (measured on the
    CPU: within one)."""
    a, b = _tokens(0, (2, 5, 64)), _tokens(1, (2, 3, 64))
    jm = jfusion.CrossAttentionBlock(64, 4, dtype=getattr(jnp, dtype))
    v = draw_variables(jm, a, b, seed=2)
    tm = tfusion.CrossAttentionBlock(64, 4).eval()
    tm.load_state_dict(tckpt.cross_attention_state_dict(v["params"]), strict=True)
    cast_for_compute(tm, getattr(torch, dtype))
    with torch.no_grad():
        got = tm(torch.from_numpy(a).to(getattr(torch, dtype)),
                 torch.from_numpy(b).to(getattr(torch, dtype)))
    want = jax.jit(jm.apply)(v, jnp.asarray(a, getattr(jnp, dtype)),
                             jnp.asarray(b, getattr(jnp, dtype)))
    for g, w in zip(got, want):
        w = np.asarray(w.astype(jnp.float32))
        assert g.dtype == getattr(torch, dtype) and g.shape == w.shape
        atol = ATOL if dtype == "float32" else 2 * _bf16_ulp(np.abs(w).max())
        np.testing.assert_allclose(g.float().numpy(), w, rtol=0, atol=atol)


@pytest.fixture(scope="module")
def jax_fusion():
    clip = np.random.default_rng(3).uniform(-2, 2, (2, 4, 32, 32, 3)).astype(np.float32)
    lm = synthetic_landmarks(2, 4, seed=4)
    v = draw_variables(jfusion.TwoStreamFusion(dtype=jnp.float32, **TINY), clip, lm, seed=5)
    return v, clip, lm


def _port(v, dtype):
    tm = tfusion.TwoStreamFusion(num_frames=4, **TINY).eval()
    result = tm.load_state_dict(tckpt.state_dict_from_jax(
        tapi.get_config("two_stream", preprocess={"num_frames": 4}, **TINY), v), strict=True)
    assert not result.missing_keys and not result.unexpected_keys
    cast_for_compute(tm, getattr(torch, dtype), keep_fp32=(tm.fc,))
    return tapi.to_channels_last(tm)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_two_stream_matches_flax(jax_fusion, dtype):
    """fp32 at the reference's 3e-4. bf16 within 3% of the largest logit
    (measured on the CPU: 0.42%; the MobileNetV2 backbone's convs and the
    attention accumulate in other orders before their bf16 roundings)."""
    v, clip, lm = jax_fusion
    jm = jfusion.TwoStreamFusion(dtype=getattr(jnp, dtype), **TINY)
    want = np.asarray(jax.jit(jm.apply)(v, clip, lm))
    tm = _port(v, dtype)
    with torch.no_grad():
        got = tm(torch.from_numpy(clip), torch.from_numpy(lm)).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape == (2, 7)
    atol = ATOL if dtype == "float32" else 0.03 * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


def test_landmarks_must_match_the_clip(jax_fusion):
    """As the JAX model: landmarks whose [B, T] differs from the clip's
    raise ``ValueError``, also where a reshape would have succeeded."""
    v, clip, lm = jax_fusion
    tm = _port(v, "float32")
    jm = jfusion.TwoStreamFusion(dtype=jnp.float32, **TINY)
    short = np.concatenate([lm, lm], axis=1)[:, :2]  # T 2: 2·1629 divides by 4
    for bad in (short, lm[:1]):
        with pytest.raises(ValueError, match="must match") as got:
            tm(torch.from_numpy(clip), torch.from_numpy(bad))
        with pytest.raises(ValueError, match="must match") as want:
            jm.apply(v, clip, bad)
        assert str(got.value) == str(want.value)


def _pair(compute_dtype, v):
    overrides = dict(TINY, compute_dtype=compute_dtype, preprocess=dict(PP))
    tm = tapi.load_model("two_stream", device="cpu", **overrides)
    tm.module.load_state_dict(tckpt.state_dict_from_jax(tm.cfg, v))
    jcfg = jconfig.get_config("two_stream", **overrides)
    return japi.Model(cfg=jcfg, module=japi.build_module(jcfg), variables=v), tm


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_predict_matches_jax(jax_fusion, compute_dtype):
    """``predict`` of both packages on the same uint8 frames (staged 40×48:
    resize and crop) and landmarks: same top-1; logits within 1e-3 in fp32
    and 3% of the largest in bf16 (measured on the CPU: 0.83%). One clip
    without the batch axis takes landmarks without it too; no landmarks
    raise, as in the JAX package."""
    jm, tm = _pair(compute_dtype, jax_fusion[0])
    assert tm.takes_rgb and tm.takes_landmarks
    frames = np.random.default_rng(6).integers(
        0, 256, (3, 4, *tm.cfg.preprocess.staged_frame_shape), np.uint8)
    lm = synthetic_landmarks(3, 4, seed=7)
    want_ids, want = japi.predict(jm, frames, landmarks=lm)
    got_ids, got = tapi.predict(tm, frames, landmarks=lm)
    assert got.shape == want.shape == (3, 7) and got.dtype == np.float32
    np.testing.assert_array_equal(got_ids, want_ids)
    atol = LOGIT_ATOL if compute_dtype == "float32" else 0.03 * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)
    one_id, one = tapi.predict(tm, frames[2], landmarks=lm[2])
    assert one.shape == (7,) and one_id == got_ids[2]
    np.testing.assert_allclose(one, got[2], atol=1e-5)
    for pkg, model in ((tapi, tm), (japi, jm)):
        with pytest.raises(ValueError, match="requires landmarks"):
            pkg.predict(model, frames)
    with pytest.raises(ValueError, match="must match"):
        tapi.predict(tm, frames, landmarks=synthetic_landmarks(3, 5, seed=7))


@pytest.fixture(scope="module")
def videos(tmp_path_factory):
    root = tmp_path_factory.mktemp("fusion_videos")
    paths = []
    for i, size in enumerate([(72, 96), (96, 72), (64, 64), (80, 60)]):
        paths.append(str(root / f"clip{i}.mp4"))
        write_video(paths[-1], num_frames=12, size=size, seed=20 + i)
    return paths


def test_stream_predict_with_landmarks_matches_predict(jax_fusion, videos):
    """``stream_predict`` of the fusion model: frames decoded per clip,
    landmarks from ``landmarks_for`` (by path; by record with
    ``takes_record``), logits as ``predict`` gives them on the same staged
    clips. Under ``skip_errors`` a clip whose landmarks do not load is
    dropped from its batch (and the batch re-padded); without it the
    stream raises. No ``landmarks_for`` raises up front."""
    from asltpu_torch.data.wlasl import ClipRecord

    _, tm = _pair("float32", jax_fusion[0])
    lms = dict(zip(videos, synthetic_landmarks(len(videos), 4, seed=8)))

    def by_path(path):
        return lms[path]

    clips = np.stack([tapi.load_clip(p, tm.cfg.preprocess) for p in videos])
    _, want = tapi.predict(tm, clips, landmarks=np.stack([lms[p] for p in videos]))
    out = list(tapi.stream_predict(tm, videos, batch_size=3, num_decode_workers=2,
                                   decode_backend="thread", landmarks_for=by_path))
    assert [p for p, _, _ in out] == videos
    np.testing.assert_allclose(np.stack([lg for _, _, lg in out]), want, atol=1e-5)
    for (_, gloss, _), w in zip(out, want):
        assert gloss == w.argmax()

    recs = [ClipRecord(f"v{i}", "g", 0, "test", p) for i, p in enumerate(videos)]

    def by_record(rec):
        if rec.video_id == "v1":
            raise FileNotFoundError("no landmarks for v1")
        return lms[rec.path]

    by_record.takes_record = True
    out = list(tapi.stream_predict(tm, recs, batch_size=3, num_decode_workers=2,
                                   decode_backend="thread", landmarks_for=by_record,
                                   skip_errors=True, yield_items=True))
    assert [r for r, _, _ in out] == [recs[0], recs[2], recs[3]]
    np.testing.assert_allclose(np.stack([lg for _, _, lg in out]), want[[0, 2, 3]],
                               atol=1e-5)
    with pytest.raises(FileNotFoundError, match="v1"):
        list(tapi.stream_predict(tm, recs, batch_size=3, decode_backend="thread",
                                 landmarks_for=by_record))
    with pytest.raises(ValueError, match="landmarks_for"):
        next(iter(tapi.stream_predict(tm, videos, decode_backend="thread")))
