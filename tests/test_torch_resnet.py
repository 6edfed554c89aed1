"""resnet_transformer in the port against the JAX package: the ResNet-18
blocks and backbone, the transformer head (fp32, bf16, with and without
``in_proj``), the whole model, weights carried both ways, and ``predict``
through both packages from the port's own ``.pt``. BN statistics, norm
parameters and biases are randomized (default values hide layout bugs)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asltpu import api as japi
from asltpu import ckpt as jckpt
from asltpu import config as jconfig
from asltpu.models import resnet as jresnet
from asltpu.models import temporal as jtemporal
from asltpu.models import video as jvideo
from asltpu_torch import api as tapi
from asltpu_torch import ckpt as tckpt
from asltpu_torch.config import get_config
from asltpu_torch.models import resnet as tresnet
from asltpu_torch.models import temporal as ttemporal
from asltpu_torch.models import video as tvideo
from asltpu_torch.models.common import cast_for_compute
from test_torch_models import ATOL, randomize_bn

HEAD_ATOL = 3e-4  # the transformer head at fp32 (tests/unit/test_parity_more.py:14)
LOGIT_ATOL = 1e-3  # fp32 end to end (tests/test_torch_api.py)
BF16_LOGIT_ATOL = 0.1  # a composed bf16 predict (tests/integration/test_parity_e2e.py:47)
TINY = dict(num_classes=7, d_model=32, num_heads=4, num_tx_layers=2)
TINY_PP = {"num_frames": 3, "staging_size": (64, 80), "resize_short": 56, "crop": 48}


def randomize_head(variables, seed=0):
    """The variables as a numpy tree with every bias drawn from N(0, 0.1)
    and every LayerNorm scale from U(0.5, 1.5), besides ``randomize_bn``'s
    BN draws (flax initialises biases to 0 and scales to 1)."""
    variables = randomize_bn(variables, seed)
    rng = np.random.default_rng(seed + 100)

    def walk(node, path):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
            elif "bn" in path:
                continue
            elif k == "bias":
                node[k] = rng.normal(0.0, 0.1, v.shape).astype(np.float32)
            elif k == "scale":
                node[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)

    walk(variables, ())
    return variables


def _nhwc(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _port_nhwc(module, x):
    with torch.no_grad():
        return module(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()


@pytest.mark.parametrize("in_ch,out_ch,stride", [
    (16, 16, 1),  # identity shortcut
    (8, 16, 2),   # stride 2: downsample
    (8, 16, 1),   # width change at stride 1: downsample
])
def test_basic_block(in_ch, out_ch, stride):
    jm = jresnet.BasicBlock(out_ch, stride=stride, dtype=jnp.float32)
    x = _nhwc(0, (2, 9, 9, in_ch))
    v = randomize_bn(jm.init(jax.random.PRNGKey(0), x), seed=stride)
    tm = tresnet.BasicBlock(in_ch, out_ch, stride).eval()
    tm.load_state_dict(tckpt.basic_block_state_dict(v["params"], v["batch_stats"]),
                       strict=True)
    assert (tm.downsample is None) == (stride == 1 and in_ch == out_ch)
    got = _port_nhwc(tm, x).transpose(0, 2, 3, 1)
    np.testing.assert_allclose(got, np.asarray(jm.apply(v, x)), atol=ATOL)


def test_resnet18_backbone():
    jm = jresnet.ResNet18(dtype=jnp.float32)
    x = _nhwc(1, (2, 32, 32, 3))
    v = randomize_bn(jax.jit(jm.init)(jax.random.PRNGKey(1), x), seed=1)
    tm = tresnet.ResNet18().eval().to(memory_format=torch.channels_last)
    tm.load_state_dict(tckpt.resnet18_state_dict(v["params"], v["batch_stats"]),
                       strict=True)
    got = _port_nhwc(tm, x)
    assert got.shape == (2, 512)
    np.testing.assert_allclose(got, np.asarray(jax.jit(jm.apply)(v, x)), atol=ATOL)


def _bf16_ulp(m: float) -> float:
    return 2.0 ** (np.floor(np.log2(m)) - 7)


@pytest.mark.parametrize("feature_dim", [32, 24])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_transformer_head(feature_dim, dtype):
    """d 32, 4 heads, 2 layers, T 5; feature width 24 adds ``in_proj``. In
    bf16 the head rounds where flax's does (projections, then biases,
    softmax and the erfc GELU op by op, LayerNorm once from fp32): within
    two bf16 ulps of the largest logit (measured on the CPU: 3.6e-7 and
    2.4e-7, the fp32 ``fc``'s own noise)."""
    feats = _nhwc(2, (3, 5, feature_dim))
    jm = jtemporal.TransformerHead(7, d_model=32, num_heads=4, num_layers=2,
                                   dtype=getattr(jnp, dtype))
    v = randomize_head(jm.init(jax.random.PRNGKey(2), feats), seed=2)
    tm = ttemporal.TransformerHead(7, feature_dim, 5, 32, 4, 2).eval()
    tm.load_state_dict(tckpt.transformer_head_state_dict(v["params"]), strict=True)
    assert (tm.in_proj is None) == (feature_dim == 32)
    cast_for_compute(tm, getattr(torch, dtype), keep_fp32=(tm.fc,))
    with torch.no_grad():
        got = tm(torch.from_numpy(feats)).numpy()
    want = np.asarray(jm.apply(v, feats))
    assert got.dtype == np.float32 and got.shape == want.shape == (3, 7)
    atol = HEAD_ATOL if dtype == "float32" else 2 * _bf16_ulp(np.abs(want).max())
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)


@pytest.fixture(scope="module")
def tiny_jax_model():
    cfg = get_config("resnet_transformer", compute_dtype="float32", **TINY)
    jm = jvideo.ResNet18Transformer(7, d_model=32, num_heads=4, num_tx_layers=2,
                                    dtype=jnp.float32)
    clip = _nhwc(3, (2, 3, 32, 32, 3)).reshape(2, 3, 32, 32, 3)
    v = randomize_head(jax.jit(jm.init)(jax.random.PRNGKey(3), clip), seed=3)
    return cfg, jm, v, clip


def test_resnet_transformer_module(tiny_jax_model):
    cfg, jm, v, clip = tiny_jax_model
    tm = tvideo.ResNet18Transformer(7, num_frames=3, d_model=32, num_heads=4,
                                    num_tx_layers=2).eval()
    result = tm.load_state_dict(tckpt.state_dict_from_jax(cfg, v), strict=True)
    assert not result.missing_keys and not result.unexpected_keys
    tm.to(memory_format=torch.channels_last)
    with torch.no_grad():
        got = tm(torch.from_numpy(clip)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax.jit(jm.apply)(v, clip)),
                               atol=HEAD_ATOL)


def test_state_dict_round_trips_through_jax_importer(tiny_jax_model, tmp_path):
    """The port's names are the ones ``asltpu.ckpt`` imports: the JAX
    importer reads the converted variables back unchanged, and the port's
    ``load_model`` reads the file; a file without ``head.*`` keeps the
    module's own head, as the JAX importer does."""
    cfg, _, v, _ = tiny_jax_model
    sd = tckpt.state_dict_from_jax(cfg, v)
    assert "head.in_proj.weight" in sd and "layer2.0.downsample.1.running_var" in sd
    pt = str(tmp_path / "port.pt")
    torch.save(sd, pt)
    overrides = dict(TINY, compute_dtype="float32", preprocess=dict(TINY_PP))
    back = jckpt._load_torch_host(
        pt, v, jconfig.get_config("resnet_transformer", **overrides))
    for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(back),
                                 jax.tree_util.tree_leaves_with_path(v)):
        np.testing.assert_array_equal(np.asarray(a), b, err_msg=str(path))
    model = tapi.load_model("resnet_transformer", checkpoint=pt, device="cpu", **overrides)
    for k, t in model.module.state_dict().items():
        torch.testing.assert_close(t, sd[k], rtol=0, atol=0)
    os.remove(pt)
    torch.save({k: t for k, t in sd.items() if not k.startswith("head.")}, pt)
    kept = tapi.load_model("resnet_transformer", checkpoint=pt, device="cpu", seed=4,
                           **overrides).module.state_dict()
    own = tapi.load_model("resnet_transformer", device="cpu", seed=4,
                          **overrides).module.state_dict()
    for k, t in kept.items():
        want = own[k] if k.startswith("head.") else sd[k]
        torch.testing.assert_close(t, want, rtol=0, atol=0, msg=k)
    torch.save({k: t for k, t in sd.items() if k != "conv1.weight"}, pt)
    with pytest.raises(KeyError, match="missing"):
        tapi.load_model("resnet_transformer", checkpoint=pt, device="cpu", **overrides)


def test_load_model_seed_is_deterministic():
    """``init_weights`` draws every parameter from the seed's generator,
    the CLS token, the positions and the packed q/k/v projection too."""
    a, b, c = (tapi.load_model("resnet_transformer", device="cpu", seed=s,
                               preprocess=dict(TINY_PP), **TINY).module.state_dict()
               for s in (5, 5, 6))
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0, msg=k)
    for k in ("head.cls", "head.pos", "head.layers.0.attn.in_proj_weight", "conv1.weight"):
        assert not torch.equal(a[k].float(), c[k].float()), k
    pos = a["head.pos"].float()
    assert float(pos.abs().max()) <= 0.04 and 0.01 < float(pos.std()) < 0.03


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_predict_matches_jax_from_port_checkpoint(compute_dtype, tmp_path):
    """The port's ``state_dict()`` saved as a ``.pt`` and loaded by the JAX
    package's ``load_model``; both packages ``predict`` the same seeded
    uint8 batch (rgb lane, resize and crop). Same top-1; logits within
    1e-3 in fp32 and 0.1 in bf16. The JAX reader goes through numpy, which
    has no bf16, so the bf16 model's tensors are saved widened to fp32
    (exact)."""
    overrides = dict(TINY, compute_dtype=compute_dtype, preprocess=dict(TINY_PP))
    tm = tapi.load_model("resnet_transformer", device="cpu", seed=7, **overrides)
    jv = randomize_head(jax.jit(jvideo.ResNet18Transformer(
        7, d_model=32, num_heads=4, num_tx_layers=2, dtype=jnp.float32).init)(
        jax.random.PRNGKey(7), np.zeros((1, 3, 48, 48, 3), np.float32)), seed=7)
    tm.module.load_state_dict(tckpt.state_dict_from_jax(tm.cfg, jv))
    pt = str(tmp_path / "port.pt")
    torch.save({k: t.float() if t.is_floating_point() else t
                for k, t in tm.module.state_dict().items()}, pt)
    jm = japi.load_model("resnet_transformer", checkpoint=pt, **overrides)
    frames = np.random.default_rng(8).integers(
        0, 256, (2, 3, *tm.cfg.preprocess.staged_frame_shape), np.uint8)
    want_ids, want = japi.predict(jm, frames)
    got_ids, got = tapi.predict(tm, frames)
    assert got.shape == want.shape == (2, 7) and got.dtype == np.float32
    np.testing.assert_array_equal(got_ids, want_ids)
    atol = LOGIT_ATOL if compute_dtype == "float32" else BF16_LOGIT_ATOL
    np.testing.assert_allclose(got, want, atol=atol)
