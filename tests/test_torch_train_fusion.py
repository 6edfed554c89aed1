"""The ``two_stream`` train step in the port against the JAX package's on the
CPU, at ``tests/test_torch_fusion.py``'s size (MobileNetV2 ×0.35, d_model
64, 4 heads, 2 fusion layers, T = 4, 7 classes), batch 8, dropout 0, on
tuple batches (clip, landmarks): the port's step preprocesses the uint8
clip, the JAX step takes the port's preprocessed clip (the reason is in
``tests/test_torch_train_video.py``); both take the same seeded landmarks.
Then ``train()`` with eval on ``((clip, landmarks), labels)`` batches, its
checkpoint through ``load_model``, eval on a module in train mode, and
dropout from the step's generator."""

import jax.numpy as jnp
import numpy as np
import pytest

from asltpu_torch.data.synthetic import synthetic_landmarks
from test_torch_train_video import (
    BATCH,
    check_bf16_step,
    check_checkpoint_loads_and_predicts,
    check_dropout_draws_from_the_generator,
    check_eval_drops_nothing,
    check_fp32_step,
    frames_and_labels,
    jax_steps,
    one_torch_thread,  # noqa: F401 (autouse fixture)
    port_clip,
)

NAME = "two_stream"
OVER = dict(num_classes=7, width_mult=0.35, d_model=64, num_heads=4, num_fusion_layers=2,
            preprocess={"num_frames": 4, "staging_size": (40, 48), "resize_short": 36,
                        "crop": 32})
# fp32: (the port's gradient against its fp64 one, JAX's against the same,
# |grad_norm| against JAX's, relative). Measured on the CPU, the port's
# over 1 to 8 intra-op threads: 3.8e-5 to 1.07e-2, 1.38%, 0.25% to 0.39%.
# The JAX model's float64 step lies 6.2e-8 (loss) and 8.1e-8 (gradient)
# from the port's fp64 one (bound ``FP64_RTOL``).
GRAD_BOUNDS = (0.03, 0.05, 1e-2)
# bf16 compute with fp32 masters: the loss against JAX's and every running
# statistic against JAX's as a share of its tensor's largest entry.
# Measured: 3.72% (JAX's bf16 loss lies 3.06% from its fp32 one, the port's
# 0.55%) and 5.15% (``features.17``'s expand BN, which sees 32 values a
# channel).
BF16_BOUNDS = (0.08, 0.1)


def tuple_batch(seed=0, batch=BATCH):
    """((uint8 frames, landmarks [B, 4, 543, 3]), labels), seeded."""
    frames, labels = frames_and_labels(OVER, seed, batch)
    return (frames, synthetic_landmarks(batch, 4, seed=seed + 4)), labels


@pytest.fixture(scope="module")
def steps():
    (frames, lm), labels = tuple_batch()
    clip = port_clip(OVER, frames)
    v, out = jax_steps(NAME, OVER, (jnp.asarray(clip, jnp.bfloat16), jnp.asarray(lm)), labels,
                       (np.zeros_like(clip[:1]), np.zeros_like(lm[:1])), seed=8)
    return (frames, lm), labels, v, out


def test_fp32_step_matches_jax(steps):
    batch_in, labels, v, out = steps
    check_fp32_step(NAME, OVER, v, out, batch_in, labels, GRAD_BOUNDS)


def test_bf16_step_matches_jax(steps):
    batch_in, labels, v, out = steps
    check_bf16_step(NAME, OVER, v, out, batch_in, labels, BF16_BOUNDS)


def test_train_and_eval_on_tuple_batches_then_load_checkpoint(tmp_path):
    """``train()`` on ``((clip, landmarks), labels)`` batches with its eval
    on two such batches (one padded with label −1), keep-best, and the
    checkpoint read back by ``load_model``."""
    batch_in, labels = tuple_batch(seed=1, batch=4)
    evals = [tuple_batch(seed=5, batch=4), tuple_batch(seed=6, batch=4)]
    evals[1][1][3] = -1
    logged = []
    check_checkpoint_loads_and_predicts(NAME, OVER, batch_in, labels, str(tmp_path),
                                        eval_batches=lambda: logged.append(1) or evals)
    assert logged == [1]
    from asltpu_torch import ckpt as tckpt

    best = tckpt.load_best_metric(str(tmp_path))
    assert best is not None and best["step"] == 2


def test_eval_step_on_a_module_in_train_mode_drops_nothing():
    check_eval_drops_nothing(NAME, OVER, *tuple_batch(seed=2, batch=4))


def test_dropout_draws_from_the_generator():
    check_dropout_draws_from_the_generator(NAME, OVER, tuple_batch(seed=3, batch=2)[0])
