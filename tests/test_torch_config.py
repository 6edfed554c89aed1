"""asltpu_torch.config against asltpu.config, field by field."""

import dataclasses

import pytest
import torch

from asltpu import config as jcfg
from asltpu_torch import config as tcfg


def _fields(cfg):
    return type(cfg).__name__, dataclasses.asdict(cfg)


@pytest.mark.parametrize("name", sorted(jcfg.CONFIG_REGISTRY))
@pytest.mark.parametrize("overrides", [
    {},
    {"num_classes": 7, "preprocess": {"num_frames": 3, "crop": 48}},
    {"compute_dtype": "float32",
     "preprocess": {"staging_size": (224, 224), "resize_short": 224,
                    "host_resize_short": 256, "staging_format": "yuv420"}},
])
def test_configs_match_field_by_field(name, overrides):
    if name == "pose_bilstm" and "preprocess" in overrides:
        overrides = {k: v for k, v in overrides.items() if k != "preprocess"}
    want = jcfg.get_config(name, **dict(overrides))
    got = tcfg.get_config(name, **dict(overrides))
    assert _fields(got) == _fields(want)


def test_registry_and_train_config_match():
    """Every JAX family is the port's too; the port has three of its own,
    ``timesformer``, ``video_swin`` and ``mvit_v2``, which the JAX package
    does not."""
    assert set(jcfg.CONFIG_REGISTRY) <= set(tcfg.CONFIG_REGISTRY)
    assert set(tcfg.CONFIG_REGISTRY) - set(jcfg.CONFIG_REGISTRY) == {"timesformer", "video_swin",
                                                                      "mvit_v2"}
    assert dataclasses.asdict(tcfg.TrainConfig()) == dataclasses.asdict(
        jcfg.TrainConfig())
    assert (tcfg.IMAGENET_MEAN, tcfg.IMAGENET_STD) == (
        jcfg.IMAGENET_MEAN, jcfg.IMAGENET_STD)


@pytest.mark.parametrize("overrides", [
    {"num_frames": 32},
    {"preprocess": {"num_frames": 24}},
    {"num_frames": 8, "preprocess": {"num_frames": 8}},
])
def test_two_stream_num_frames_sync(overrides):
    got = tcfg.get_config("two_stream", **dict(overrides))
    want = jcfg.get_config("two_stream", **dict(overrides))
    assert _fields(got) == _fields(want)
    assert got.num_frames == got.preprocess.num_frames


def test_two_stream_contradiction_raises():
    for mod in (jcfg, tcfg):
        with pytest.raises(ValueError, match="contradicts"):
            mod.get_config("two_stream", num_frames=8,
                           preprocess={"num_frames": 16})


@pytest.mark.parametrize("staging", [(226, 224), (224, 223), (222, 224)])
def test_staged_frame_shape_errors(staging):
    for mod in (jcfg, tcfg):
        cfg = mod.PreprocessConfig(staging_size=staging, staging_format="yuv420")
        with pytest.raises(ValueError, match="yuv420 staging"):
            cfg.staged_frame_shape


@pytest.mark.parametrize("fmt", ["rgb", "yuv420"])
def test_staged_frame_shape_matches(fmt):
    kw = dict(staging_size=(224, 160), staging_format=fmt)
    assert (tcfg.PreprocessConfig(**kw).staged_frame_shape
            == jcfg.PreprocessConfig(**kw).staged_frame_shape)


def test_num_frames_guard_and_torch_dtypes():
    with pytest.raises(ValueError, match="num_frames"):
        tcfg.PreprocessConfig(num_frames=0)
    cfg = tcfg.get_config("mobilenet_gru")
    assert cfg.compute_torch_dtype is torch.bfloat16
    assert cfg.preprocess.out_torch_dtype is torch.bfloat16
