"""The port at the JAX package's golden spec for mobilenet_gru
(tests/integration/test_goldens.py): full backbone width, the seed-0 JAX
weights carried across, the fixed clip, the stored golden logits."""

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
