"""The port at the JAX package's golden specs for mobilenet_gru and
resnet_transformer (tests/integration/test_goldens.py): full backbone
width, the seed-0 JAX weights carried across, the fixed clip, the stored
golden logits."""

import os

import numpy as np

from asltpu import api as japi
from asltpu_torch import api as tapi
from asltpu_torch.ckpt import state_dict_from_jax

GOLDEN = os.path.join(os.path.dirname(__file__), "integration", "goldens",
                      "mobilenet_gru.npy")
SPEC = dict(num_classes=6, gru_hidden=32, compute_dtype="float32",
            preprocess={"num_frames": 4, "staging_size": (64, 64),
                        "resize_short": 56, "crop": 48})
RESNET_GOLDEN = os.path.join(os.path.dirname(GOLDEN), "resnet_transformer.npy")
RESNET_SPEC = dict(num_classes=6, d_model=512, compute_dtype="float32",
                   preprocess={"num_frames": 3, "staging_size": (64, 64),
                               "resize_short": 56, "crop": 48})


def test_mobilenet_gru_golden_logits():
    jm = japi.load_model("mobilenet_gru", seed=0, **SPEC)
    tm = tapi.load_model("mobilenet_gru", device="cpu", **SPEC)
    assert tm.cfg.width_mult == 1.0 and tm.module.features.out_features == 1280
    tm.module.load_state_dict(state_dict_from_jax(tm.cfg, jm.variables))
    pp = tm.cfg.preprocess
    clip = np.random.default_rng(1234).integers(
        0, 256, size=(pp.num_frames, *pp.staging_size, 3), dtype=np.uint8)
    _, got = tapi.predict(tm, clip)
    _, want = japi.predict(jm, clip)
    np.testing.assert_allclose(got, want, atol=1e-3)
    # The golden test's own tolerance against the stored logits.
    np.testing.assert_allclose(got, np.load(GOLDEN), atol=5e-3)


def test_resnet_transformer_golden_logits():
    jm = japi.load_model("resnet_transformer", seed=0, **RESNET_SPEC)
    tm = tapi.load_model("resnet_transformer", device="cpu", **RESNET_SPEC)
    assert tm.module.head.in_proj is None and tm.module.head.pos.shape == (1, 4, 512)
    tm.module.load_state_dict(state_dict_from_jax(tm.cfg, jm.variables))
    pp = tm.cfg.preprocess
    clip = np.random.default_rng(1234).integers(
        0, 256, size=(pp.num_frames, *pp.staging_size, 3), dtype=np.uint8)
    _, got = tapi.predict(tm, clip)
    _, want = japi.predict(jm, clip)
    np.testing.assert_allclose(got, want, atol=1e-3)
    np.testing.assert_allclose(got, np.load(RESNET_GOLDEN), atol=5e-3)
