"""Train-time augmentation in the port against ``asltpu.ops.augment`` on the
CPU: the sampling matrices (flip included), the transform on the same
seven per-clip scalars (drawn with ``jax.random`` by replaying the JAX
function's split), and the properties ``tests/unit/test_augment.py``
holds: the identity setting is the eval path, the flip is a mirror, one
transform holds across a clip's frames."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asltpu import config as jconfig
from asltpu.ops import augment as jaug
from asltpu_torch.config import PreprocessConfig
from asltpu_torch.ops import augment as taug
from asltpu_torch.ops.preprocess import preprocess_clip_mm

PP = dict(num_frames=2, staging_size=(56, 56), resize_short=56, crop=48, out_dtype="float32")
IDENTITY = dict(min_area=1.0, max_area=1.0, min_aspect=1.0, max_aspect=1.0, hflip_prob=0.0,
                brightness=0.0, contrast=0.0)
# fp32 einsums that sum in other orders: a sum of up to 56 products of
# 0–255 pixels has an ulp of 2^-10, 1.7e-5 after /255 and /std (measured
# on the CPU: 4.1e-5).
ATOL = 1e-4


def _frames(seed, b=3, t=2, size=(56, 56)):
    return np.random.default_rng(seed).integers(0, 256, (b, t, *size, 3), np.uint8)


@pytest.mark.parametrize("n_in,n_out,start,size,flip", [
    (56, 48, 0.0, 56.0, 0.0), (56, 48, 3.7, 40.2, 1.0), (64, 32, 10.5, 20.25, 0.0),
    (40, 48, 0.0, 40.0, 1.0), (50, 50, 12.3, 31.9, 1.0),
])
def test_sampling_matrices_match_jax(n_in, n_out, start, size, flip):
    want = np.asarray(jaug._device_sampling_matrix(
        n_in, n_out, jnp.float32(start), jnp.float32(size), jnp.float32(flip)))
    got = taug.sampling_matrices(n_in, n_out, torch.tensor([start, 1.0]),
                                 torch.tensor([size, 7.0]), torch.tensor([flip, 0.0]))
    assert got.shape == (2, n_out, n_in)
    np.testing.assert_allclose(got[0].numpy(), want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.sum(-1).numpy(), 1.0, atol=1e-6)


def _jax_draws(key, b, hs, ws, aug):
    """The seven per-clip scalars as ``augment_preprocess_clip`` draws them
    from ``key`` (its ``jax.random.split(rng, 7)``), in the port's form."""
    k_area, k_aspect, k_y, k_x, k_flip, k_bri, k_con = jax.random.split(key, 7)
    draws = {
        "area": jax.random.uniform(k_area, (b,), minval=aug.min_area, maxval=aug.max_area),
        "log_aspect": jax.random.uniform(k_aspect, (b,), minval=jnp.log(aug.min_aspect),
                                         maxval=jnp.log(aug.max_aspect)),
        "y": jax.random.uniform(k_y, (b,)),
        "x": jax.random.uniform(k_x, (b,)),
        "flip": jax.random.uniform(k_flip, (b,)),
        "brightness": jax.random.uniform(k_bri, (b, 1, 1, 1, 1), minval=-aug.brightness,
                                         maxval=aug.brightness).reshape(b),
        "contrast": jax.random.uniform(k_con, (b, 1, 1, 1, 1), minval=1.0 - aug.contrast,
                                       maxval=1.0 + aug.contrast).reshape(b),
    }
    return {k: torch.from_numpy(np.array(v, np.float32)) for k, v in draws.items()}


@pytest.mark.parametrize("seed,size,over", [
    (0, (56, 56), {}),
    (1, (64, 80), {"hflip_prob": 1.0}),
    (2, (56, 56), {"brightness": 0.0, "contrast": 0.4, "min_area": 0.2}),
])
def test_transform_matches_jax_on_the_same_draws(seed, size, over):
    aug = jaug.AugmentConfig(**over)
    pp = dict(PP, staging_size=size)
    frames = _frames(seed, size=size)
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jaug.augment_preprocess_clip(key, frames, jconfig.PreprocessConfig(**pp),
                                                   aug))
    draws = _jax_draws(key, frames.shape[0], *size, aug)
    got = taug.augment_clip(torch.from_numpy(frames), draws, PreprocessConfig(**pp),
                            taug.AugmentConfig(**over))
    assert got.shape == want.shape == (3, 2, 48, 48, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


def test_draws_come_from_the_generator():
    aug = taug.AugmentConfig()
    frames = torch.from_numpy(_frames(3))
    pp = PreprocessConfig(**PP)
    a = taug.augment_preprocess_clip(torch.Generator().manual_seed(0), frames, pp, aug)
    b = taug.augment_preprocess_clip(torch.Generator().manual_seed(0), frames, pp, aug)
    c = taug.augment_preprocess_clip(torch.Generator().manual_seed(1), frames, pp, aug)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.allclose(a, c)
    d = taug.draw_augment(torch.Generator().manual_seed(2), 1000, aug, torch.device("cpu"))
    for k, lo, hi in (("area", 0.5, 1.0), ("contrast", 0.85, 1.15),
                      ("brightness", -0.15, 0.15)):
        assert lo <= float(d[k].min()) and float(d[k].max()) <= hi, k
    assert 0.4 < float((d["flip"] < aug.hflip_prob).float().mean()) < 0.6


def test_identity_setting_is_the_eval_path():
    """Area 1, aspect 1, no flip or jitter: a full-frame resize to crop²,
    which the eval preprocess gives with ``resize_short = crop``."""
    frames = torch.from_numpy(_frames(4, b=2))
    pp = PreprocessConfig(**PP)
    got = taug.augment_preprocess_clip(None, frames, pp, taug.AugmentConfig(**IDENTITY))
    want = preprocess_clip_mm(frames, dataclasses.replace(pp, resize_short=48))
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-4)


def test_flip_is_a_mirror():
    frames = torch.from_numpy(_frames(5, b=1))
    pp = PreprocessConfig(**PP)
    base = taug.augment_preprocess_clip(None, frames, pp, taug.AugmentConfig(**IDENTITY))
    flip = taug.augment_preprocess_clip(None, frames, pp,
                                        taug.AugmentConfig(**dict(IDENTITY, hflip_prob=1.0)))
    np.testing.assert_allclose(base.numpy(), flip.flip(3).numpy(), atol=1e-4)


def test_one_transform_holds_across_the_frames():
    frame = _frames(6, b=1, t=1)
    clip = torch.from_numpy(np.repeat(frame, 2, axis=1))
    out = taug.augment_preprocess_clip(torch.Generator().manual_seed(3), clip,
                                       PreprocessConfig(**PP))
    np.testing.assert_allclose(out[:, 0].numpy(), out[:, 1].numpy(), atol=1e-5)


def test_augmented_train_step_runs_on_the_generator():
    """The train step with augment draws from the state's generator: two
    states seeded alike take the same step and leave their generators
    alike."""
    from asltpu_torch import api as tapi
    from asltpu_torch.config import TrainConfig
    from asltpu_torch.train import loop as tloop

    pp = {"num_frames": 6, "staging_size": (40, 48), "resize_short": 36, "crop": 32}
    frames = _frames(7, b=2, t=6, size=(40, 48))
    labels = np.array([1, 2], np.int32)
    out = []
    for _ in range(2):
        model = tapi.build_trainable("i3d", device="cpu", num_classes=5, compute_dtype="float32",
                                     preprocess=pp)
        state = tloop.create_train_state(model.module, TrainConfig(warmup_steps=0), seed=4)
        step = tloop.make_train_step(TrainConfig(warmup_steps=0), model.cfg.preprocess,
                                     taug.AugmentConfig())
        state, metrics = step(state, frames, labels)
        out.append((float(metrics["loss"]), state.generator.get_state()))
    assert out[0][0] == out[1][0] and torch.equal(out[0][1], out[1][1])
