"""asltpu_torch.models and ops.recurrent against their flax/JAX twins at
fp32, with weights carried across by asltpu_torch.ckpt and randomized BN
parameters and statistics (default statistics hide layout bugs)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from asltpu import ckpt as jckpt
from asltpu import config as jconfig
from asltpu.models import common as jcommon
from asltpu.models import mobilenetv2 as jmnv2
from asltpu.models import temporal as jtemporal
from asltpu.models import video as jvideo
from asltpu.ops import recurrent as jrec
from asltpu_torch import ckpt as tckpt
from asltpu_torch.config import get_config
from asltpu_torch.models import common as tcommon
from asltpu_torch.models import mobilenetv2 as tmnv2
from asltpu_torch.models import temporal as ttemporal
from asltpu_torch.models import video as tvideo
from asltpu_torch.ops import recurrent as trec

ATOL = 2e-4  # fp32: accumulation-order differences only (tests/unit/test_parity.py)


def randomize_bn(variables, seed=0):
    """The variables as a numpy tree, with every BN scale/bias/mean/var
    drawn at random."""
    variables = jax.tree.map(np.asarray, jax.device_get(variables))
    rng = np.random.default_rng(seed)

    def walk(node, in_bn):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, k == "bn")
            elif in_bn and k in ("scale", "var"):
                node[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
            elif in_bn and k in ("bias", "mean"):
                node[k] = rng.normal(0.0, 0.1, v.shape).astype(np.float32)

    walk(variables, False)
    return variables


def draw_variables(module, *inputs, seed=0):
    """Variables of ``module`` without compiling its init (a large JAX
    model's ``init`` compiles for seconds): the shapes from
    ``jax.eval_shape``, kernels from N(0, 1/fan_in), biases from N(0, 0.1),
    LayerNorm scales from U(0.5, 1.5), positions from N(0, 0.02), then
    ``randomize_bn``'s BN draws. A numpy tree."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *inputs)
    rng = np.random.default_rng(seed)

    def draw(path, s):
        keys = [p.key for p in path]
        if keys[-1] == "kernel":
            qkv = len(keys) > 1 and keys[-2] in ("query", "key", "value")
            fan_in = s.shape[0] if qkv else int(np.prod(s.shape[:-1]))
            return (rng.standard_normal(s.shape) / np.sqrt(fan_in)).astype(np.float32)
        if keys[-1] == "bias":
            return rng.normal(0.0, 0.1, s.shape).astype(np.float32)
        if keys[-1] == "scale":
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        if keys[-1] == "pos":
            return rng.normal(0.0, 0.02, s.shape).astype(np.float32)
        return np.ones(s.shape, np.float32) if keys[-1] == "var" else np.zeros(
            s.shape, np.float32)

    return randomize_bn(jax.tree_util.tree_map_with_path(draw, shapes), seed)


def _init(module, *inputs, seed=0):
    """flax init with randomized BN, as numpy."""
    return randomize_bn(module.init(jax.random.PRNGKey(seed), *inputs), seed)


def _nhwc(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _port_nhwc(module, x):
    with torch.no_grad():
        y = module(torch.from_numpy(x).permute(0, 3, 1, 2))
    return y.permute(0, 2, 3, 1).numpy() if y.dim() == 4 else y.numpy()


@pytest.mark.parametrize("kernel,stride,groups", [
    (3, 2, 1), (1, 1, 1), (3, 1, 8), (3, 2, 8),
])
def test_convbn(kernel, stride, groups):
    out_ch = 8 if groups > 1 else 16
    jm = jcommon.ConvBN(out_ch, kernel=kernel, strides=stride, groups=groups,
                        act=jcommon.relu6, dtype=jnp.float32)
    x = _nhwc(0, (2, 17, 17, 8))
    v = _init(jm, x)
    tm = tcommon.ConvBN(8, out_ch, kernel, stride, groups).eval()
    tm.load_state_dict(tckpt.convbn_state_dict(v["params"], v["batch_stats"]))
    np.testing.assert_allclose(_port_nhwc(tm, x), np.asarray(jm.apply(v, x)),
                               atol=ATOL)


@pytest.mark.parametrize("in_ch,out_ch,stride,expand", [
    (8, 16, 1, 1),   # expand_ratio 1 (torchvision features.1)
    (8, 16, 2, 6),   # stride 2
    (16, 16, 1, 6),  # residual
])
def test_inverted_residual(in_ch, out_ch, stride, expand):
    jm = jmnv2.InvertedResidual(out_ch, stride, expand, dtype=jnp.float32)
    x = _nhwc(1, (2, 15, 15, in_ch))
    v = _init(jm, x, seed=1)
    tm = tmnv2.InvertedResidual(in_ch, out_ch, stride, expand).eval()
    tm.load_state_dict(
        tckpt.inverted_residual_state_dict(v["params"], v["batch_stats"]))
    assert tm.use_res == (stride == 1 and in_ch == out_ch)
    np.testing.assert_allclose(_port_nhwc(tm, x), np.asarray(jm.apply(v, x)),
                               atol=ATOL)


def test_mobilenetv2_backbone():
    jm = jmnv2.MobileNetV2(0.35, dtype=jnp.float32)
    x = _nhwc(2, (2, 32, 32, 3))
    v = _init(jm, x, seed=2)
    tm = tmnv2.MobileNetV2(0.35).eval()
    tm.load_state_dict(
        tckpt.mobilenetv2_state_dict(v["params"], v["batch_stats"], prefix=""))
    got = _port_nhwc(tm.to(memory_format=torch.channels_last), x)
    assert got.shape == (2, 1280)
    np.testing.assert_allclose(got, np.asarray(jm.apply(v, x)), atol=ATOL)
    assert len(tm) == 19 and tmnv2._make_divisible(32 * 0.35) == 16


@pytest.mark.parametrize("reverse", [False, True])
def test_gru_layer(reverse):
    rng = np.random.default_rng(3)
    f, h = 24, 16
    x = rng.standard_normal((3, 5, f)).astype(np.float32)
    p = {k: rng.uniform(-0.3, 0.3, s).astype(np.float32) for k, s in
         (("wi", (f, 3 * h)), ("wh", (h, 3 * h)), ("bi", (3 * h,)), ("bh", (3 * h,)))}
    want_seq, want_h = jrec.gru_layer(jnp.asarray(x), p, reverse=reverse)
    t = {k: torch.from_numpy(v) for k, v in p.items()}
    got_seq, got_h = trec.gru_layer(torch.from_numpy(x), t["wi"].T, t["wh"].T,
                                    t["bi"], t["bh"], reverse=reverse)
    np.testing.assert_allclose(got_seq.numpy(), np.asarray(want_seq), atol=ATOL)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), atol=ATOL)


def test_gru_module_is_torch_gru():
    """Same names and the same function as torch.nn.GRU (eval mode)."""
    torch.manual_seed(0)
    ref = nn.GRU(12, 8, num_layers=2, batch_first=True).eval()
    port = trec.GRU(12, 8, num_layers=2).eval()
    port.load_state_dict(ref.state_dict())
    x = torch.randn(2, 6, 12)
    with torch.no_grad():
        want_seq, want_h = ref(x)
        got_seq, got_h = port(x)
    torch.testing.assert_close(got_seq, want_seq, atol=ATOL, rtol=0)
    torch.testing.assert_close(got_h, want_h, atol=ATOL, rtol=0)


@pytest.mark.parametrize("layers", [1, 2])
def test_gru_head(layers):
    jm = jtemporal.GRUHead(7, hidden=16, num_layers=layers, dropout=0.2)
    feats = _nhwc(4, (3, 5, 24)).reshape(3, 5, 24)
    v = _init(jm, feats, seed=4)
    tm = ttemporal.GRUHead(7, 24, 16, layers, 0.2).eval()
    tm.load_state_dict(tckpt.gru_head_state_dict(v["params"], layers))
    with torch.no_grad():
        got = tm(torch.from_numpy(feats)).numpy()
    np.testing.assert_allclose(got, np.asarray(jm.apply(v, feats, False)),
                               atol=ATOL)


@pytest.fixture(scope="module")
def small_jax_model():
    cfg = get_config("mobilenet_gru", num_classes=7, gru_hidden=32,
                     width_mult=0.35, compute_dtype="float32")
    jm = jvideo.MobileNetV2GRU(7, 0.35, 32, 1, 0.2, dtype=jnp.float32)
    clip = _nhwc(5, (2, 3, 32, 32, 3)).reshape(2, 3, 32, 32, 3)
    return cfg, jm, _init(jm, clip, seed=5), clip


def test_mobilenet_gru_module(small_jax_model):
    cfg, jm, v, clip = small_jax_model
    tm = tvideo.MobileNetV2GRU(7, 0.35, 32, 1, 0.2).eval()
    sd = tckpt.state_dict_from_jax(cfg, v)
    result = tm.load_state_dict(sd, strict=True)
    assert not result.missing_keys and not result.unexpected_keys
    tm.to(memory_format=torch.channels_last)
    with torch.no_grad():
        got = tm(torch.from_numpy(clip)).numpy()
    np.testing.assert_allclose(got, np.asarray(jm.apply(v, clip, False)),
                               atol=ATOL)


def test_state_dict_round_trips_through_jax_importer(small_jax_model, tmp_path):
    """The port's state_dict is a torchvision-layout checkpoint: the JAX
    package's importer reads it back to the same variables, and the port's
    load_model reads it too."""
    from asltpu_torch import api

    cfg, jm, v, clip = small_jax_model
    sd = tckpt.state_dict_from_jax(cfg, v)
    pt = str(tmp_path / "port.pt")
    torch.save(sd, pt)
    jax_cfg = jconfig.get_config("mobilenet_gru", num_classes=7, gru_hidden=32,
                                 width_mult=0.35, compute_dtype="float32")
    back = jckpt._load_torch_host(pt, v, jax_cfg)
    for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(back),
                                 jax.tree_util.tree_leaves_with_path(v)):
        np.testing.assert_array_equal(np.asarray(a), b, err_msg=str(path))
    model = api.load_model("mobilenet_gru", checkpoint=pt, device="cpu",
                           num_classes=7, gru_hidden=32, width_mult=0.35,
                           compute_dtype="float32")
    for k, t in model.module.state_dict().items():
        torch.testing.assert_close(t, sd[k], rtol=0, atol=0)
    os.remove(pt)
    torch.save({k: t for k, t in sd.items() if not k.startswith("features.0.")}, pt)
    with pytest.raises(KeyError, match="missing"):
        api.load_model("mobilenet_gru", checkpoint=pt, device="cpu",
                       num_classes=7, gru_hidden=32, width_mult=0.35)


def test_state_dict_from_jax_refuses_unported_configs():
    """Every config of the registry has its layout now (I3D and two-stream
    are held in tests/test_torch_i3d.py and test_torch_fusion.py); a config
    without one raises before it reads the variables."""
    from asltpu_torch.config import ModelConfig

    with pytest.raises(ValueError, match="no weight layout"):
        tckpt.state_dict_from_jax(ModelConfig(), {"params": {}})
