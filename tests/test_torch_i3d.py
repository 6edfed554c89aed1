"""I3D in the port against the JAX package on the CPU: the SAME pads, the
stem's two forms, ``Unit3D``, ``InceptionBlock``, the head, the whole
network (fp32 and bf16), ``predict`` through both packages and a
pytorch-i3d ``.pt``. Weights carry across through ``state_dict_from_jax``
with BN statistics and biases randomised; the JAX variables are drawn from
``jax.eval_shape`` (the JAX I3D's ``init`` compiles for seconds)."""

import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from asltpu import api as japi
from asltpu import ckpt as jckpt
from asltpu import config as jconfig
from asltpu.models import i3d as ji3d
from asltpu.ops import stem_s2d as jstem
from asltpu_torch import api as tapi
from asltpu_torch import ckpt as tckpt
from asltpu_torch.models import i3d as ti3d
from asltpu_torch.models.common import cast_for_compute, init_weights, pad_same, same_pads
from asltpu_torch.ops import stem_s2d as tstem
from test_torch_models import ATOL, draw_variables, randomize_bn

LOGIT_ATOL = 1e-3  # fp32 end to end (tests/test_torch_api.py)
PP = {"num_frames": 16, "staging_size": (40, 48), "resize_short": 36, "crop": 32}
CLIP = (1, 16, 32, 32, 3)  # T' = 2 after Mixed_5c: the pair average runs


def _bf16_ulp(m: float) -> float:
    return 2.0 ** (np.floor(np.log2(m)) - 7)


def _ndhwc(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _ncdhw(x):
    """NDHWC numpy → NCDHW torch in channels_last_3d memory (a view)."""
    return torch.from_numpy(x).permute(0, 4, 1, 2, 3)


def _ndhwc_np(y):
    return y.permute(0, 2, 3, 4, 1).float().numpy()


@pytest.mark.parametrize("length,kernel,stride", [
    (7, 3, 2), (8, 3, 2), (8, 7, 2), (9, 7, 2), (5, 3, 1), (4, 1, 1), (6, 2, 2), (1, 3, 2),
])
def test_same_pads_match_flax(length, kernel, stride):
    """The SAME pads against flax's SAME conv (zero fill) and max-pool
    (−inf fill, so negative inputs show a wrong pad) at odd and even
    lengths."""
    assert same_pads([length], [kernel], [stride])[0] == jax.lax.padtype_to_pads(
        (length,), (kernel,), (stride,), "SAME")[0]
    x = _ndhwc(length, (2, length, length, 1, 3)) - 3.0
    conv = fnn.Conv(4, (kernel, kernel, 1), (stride, stride, 1), padding="SAME",
                    dtype=jnp.float32)
    v = conv.init(jax.random.PRNGKey(0), x)
    w = torch.from_numpy(np.asarray(v["params"]["kernel"]).transpose(4, 3, 0, 1, 2).copy())
    k3, s3 = (kernel, kernel, 1), (stride, stride, 1)
    padded, padding = pad_same(_ncdhw(x), k3, s3)
    assert padded.shape[2] - length == sum(same_pads([length], [kernel], [stride])[0]) - 2 * padding[0]
    got = F.conv3d(padded, w, torch.from_numpy(np.asarray(v["params"]["bias"])), s3, padding)
    np.testing.assert_allclose(_ndhwc_np(got), np.asarray(conv.apply(v, x)), atol=ATOL)
    pooled = ti3d.max_pool_same(_ncdhw(x), k3, s3)
    want = fnn.max_pool(jnp.asarray(x), k3, strides=s3, padding="SAME")
    np.testing.assert_array_equal(_ndhwc_np(pooled), np.asarray(want))


def test_space_to_depth_is_parity_pack_over_t_h_w():
    x = _ndhwc(1, (2, 4, 6, 8, 3))
    want = jnp.asarray(x)
    for axis in (1, 2, 3):
        want = jstem.parity_pack(want, axis)
    got = tstem.space_to_depth(_ncdhw(x))
    assert got.is_contiguous(memory_format=torch.channels_last_3d)
    np.testing.assert_array_equal(_ndhwc_np(got), np.asarray(want))


@pytest.mark.parametrize("shape", [(2, 8, 10, 12, 3), (1, 4, 14, 6, 3), (1, 5, 10, 12, 3),
                                   (1, 8, 9, 7, 3)])
def test_stem_forms_match_each_other_and_jax(shape):
    """fp32: the space-to-depth form, the plain form, the JAX package's
    ``stem_conv3d_s2d`` and its plain SAME conv agree within 1e-5; an odd
    axis takes the plain form only (the rewrite refuses it)."""
    x = _ndhwc(2, shape)
    w = _ndhwc(3, (7, 7, 7, 3, 16)) * 0.1  # DHWIO
    wt = torch.from_numpy(w.transpose(4, 3, 0, 1, 2).copy())
    plain = _ndhwc_np(tstem.stem_conv3d_plain(_ncdhw(x), wt))
    dn = jax.lax.conv_dimension_numbers(x.shape, w.shape, ("NDHWC", "DHWIO", "NDHWC"))
    want = np.asarray(jax.lax.conv_general_dilated(x, w, (2, 2, 2), "SAME",
                                                   dimension_numbers=dn))
    np.testing.assert_allclose(plain, want, atol=1e-5)
    even = all(n % 2 == 0 for n in shape[1:4])
    assert tstem.s2d_applies(_ncdhw(x)) == even
    if not even:
        with pytest.raises(ValueError, match="even"):
            tstem.stem_conv3d_s2d(_ncdhw(x), wt)
        return
    s2d = tstem.stem_conv3d_s2d(_ncdhw(x), wt)
    assert s2d.is_contiguous(memory_format=torch.channels_last_3d)
    np.testing.assert_allclose(_ndhwc_np(s2d), plain, atol=1e-5)
    np.testing.assert_allclose(_ndhwc_np(s2d), np.asarray(jstem.stem_conv3d_s2d(x, w)),
                               atol=1e-5)
    np.testing.assert_array_equal(
        tstem.s2d_kernel7(wt).permute(2, 3, 4, 1, 0).numpy(), np.asarray(jstem.s2d_kernel7(w)))


@pytest.mark.parametrize("kernel,stride,shape", [
    ((1, 1, 1), (1, 1, 1), (2, 3, 5, 4, 6)),
    ((3, 3, 3), (1, 1, 1), (2, 3, 5, 4, 6)),
    ((3, 3, 3), (2, 2, 2), (1, 5, 6, 7, 6)),
    ((7, 7, 7), (2, 2, 2), (1, 6, 8, 10, 3)),  # the stem, s2d in the JAX package
    ((7, 7, 7), (2, 2, 2), (1, 5, 8, 9, 3)),   # the stem on odd axes: the plain conv
])
def test_unit3d_matches_flax(kernel, stride, shape):
    jm = ji3d.Unit3D(8, kernel, strides=stride, dtype=jnp.float32)
    x = _ndhwc(4, shape)
    v = randomize_bn(jm.init(jax.random.PRNGKey(1), x), seed=1)
    tm = ti3d.Unit3D(shape[-1], 8, kernel, stride).eval()
    tm.load_state_dict(tckpt.convbn_state_dict(
        v["params"]["unit"], v["batch_stats"]["unit"], "conv3d", "bn"))
    with torch.no_grad():
        got = _ndhwc_np(tm(_ncdhw(x)))
    np.testing.assert_allclose(got, np.asarray(jm.apply(v, x)), atol=ATOL)


def test_inception_block_matches_flax():
    ch = (4, 3, 5, 2, 3, 6)
    jm = ji3d.InceptionBlock(ch, dtype=jnp.float32)
    x = _ndhwc(5, (2, 3, 6, 5, 8))
    v = randomize_bn(jm.init(jax.random.PRNGKey(2), x), seed=2)
    tm = ti3d.InceptionBlock(8, ch).eval()
    tm.load_state_dict({f"{br}.{k}": t for br in v["params"] for k, t in
                        tckpt.convbn_state_dict(v["params"][br]["unit"],
                                                v["batch_stats"][br]["unit"],
                                                "conv3d", "bn").items()})
    assert tm.out_channels == 4 + 5 + 3 + 6
    with torch.no_grad():
        got = _ndhwc_np(tm(_ncdhw(x)))
    np.testing.assert_allclose(got, np.asarray(jm.apply(v, x)), atol=ATOL)


@pytest.fixture(scope="module")
def jax_i3d():
    """The JAX I3D (7 classes) at fp32 and bf16 on one seeded clip, its
    variables, its logits and its ``Mixed_5c`` output."""
    clip = np.random.default_rng(6).uniform(-2, 2, CLIP).astype(np.float32)
    v = draw_variables(ji3d.I3D(num_classes=7, dtype=jnp.float32), clip, seed=6)
    out = {}
    for dtype in ("float32", "bfloat16"):
        jm = ji3d.I3D(num_classes=7, dtype=getattr(jnp, dtype))
        logits, state = jax.jit(lambda v, x: jm.apply(
            v, x, capture_intermediates=lambda m, _: m.name == "Mixed_5c"))(v, clip)
        mixed = state["intermediates"]["Mixed_5c"]["__call__"][0]
        out[dtype] = (np.asarray(logits), np.asarray(mixed.astype(jnp.float32)))
    return v, clip, out


def _port_i3d(v, dtype):
    tm = ti3d.I3D(num_classes=7).eval()
    result = tm.load_state_dict(tckpt.state_dict_from_jax(
        tapi.get_config("i3d", num_classes=7), v), strict=True)
    assert not result.missing_keys and not result.unexpected_keys
    return tapi.to_channels_last(cast_for_compute(tm, getattr(torch, dtype),
                                                  keep_fp32=(tm.logits,)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_i3d_matches_jax(jax_i3d, dtype):
    """The whole I3D at [1, 16, 32², 3] (T' = 2: the pair average runs):
    the backbone's output (``Mixed_5c``) and the logits; then the head alone
    on the JAX backbone's output. fp32 at the reference's 2e-4. bf16: the
    features within 2 bf16 ulps of the largest (measured on the CPU: half
    an ulp, the convs accumulate in other orders), the logits within 2% of
    the largest (measured 0.20%); the head alone on the same features
    within 1e-5 of the largest logit (measured 1.8e-7: the fp32
    ``logits`` sums in another order)."""
    v, clip, out = jax_i3d
    want_logits, want_mixed = out[dtype]
    tm = _port_i3d(v, dtype)
    with torch.no_grad():
        feats = tm.backbone(torch.from_numpy(clip))
        assert feats.dtype == getattr(torch, dtype) and feats.shape == (1, 1024, 2, 1, 1)
        got = tm.classify(feats).numpy()
        head = tm.classify(_ncdhw(want_mixed).to(feats.dtype)).numpy()
    assert got.dtype == np.float32 and got.shape == want_logits.shape == (1, 7)
    peak = np.abs(want_logits).max()
    if dtype == "float32":
        np.testing.assert_allclose(_ndhwc_np(feats), want_mixed, atol=ATOL)
        np.testing.assert_allclose(got, want_logits, atol=ATOL)
    else:
        np.testing.assert_allclose(_ndhwc_np(feats), want_mixed, rtol=0,
                                   atol=2 * _bf16_ulp(np.abs(want_mixed).max()))
        np.testing.assert_allclose(got, want_logits, rtol=0, atol=0.02 * peak)
    np.testing.assert_allclose(head, want_logits, rtol=0, atol=1e-5 * max(peak, 1.0))


def test_i3d_head_keeps_one_step_without_pair_average():
    """T' = 1: no pair average, the logits of the one step."""
    tm = ti3d.I3D(num_classes=5).eval()
    feats = torch.from_numpy(_ndhwc(7, (2, 1, 3, 3, 1024))).permute(0, 4, 1, 2, 3)
    with torch.no_grad():
        got = tm.classify(feats)
        want = tm.logits(feats.mean(dim=(3, 4)).transpose(1, 2))[:, 0]
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("num_classes", [6, 2000])
def test_seeded_logits_init_is_a_dense_layer(num_classes):
    """The seeded init draws I3D's 1×1×1 logits as a dense layer over its
    1024 inputs, the scale of the JAX package's ``Dense`` (lecun-normal,
    std 1/32), whatever the class count: a conv's fan-out init gave std
    √(2/6) ≈ 0.58 at 6 classes, and the learning proof's clipped
    gradients went to the classifier."""
    module = tapi.build_module(tapi.get_config("i3d", num_classes=num_classes))
    init_weights(module, torch.Generator().manual_seed(0))
    w, b = module.logits.conv3d.weight, module.logits.conv3d.bias
    bound = 1024 ** -0.5
    assert float(w.abs().max()) <= bound and float(b.abs().max()) <= bound
    assert abs(float(w.std()) - bound / 3 ** 0.5) < 0.1 * bound
    # The other convs keep their fan-out init.
    stem = module.Conv3d_1a_7x7.conv3d.weight
    assert abs(float(stem.std()) - (2 / (64 * 7 ** 3)) ** 0.5) < 1e-3


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_predict_matches_jax(jax_i3d, compute_dtype):
    """``load_model("i3d", device="cpu")`` at 16 frames of 32² (staged
    40×48: resize and crop) with the JAX variables, against
    ``asltpu.api.predict`` with the same variables on the same uint8
    batch: same top-1; logits within 1e-3 in fp32 and 2% of the largest in
    bf16 (measured on the CPU: 0.25%)."""
    v = jax_i3d[0]
    overrides = dict(num_classes=7, compute_dtype=compute_dtype, preprocess=dict(PP))
    tm = tapi.load_model("i3d", device="cpu", **overrides)
    tm.module.load_state_dict(tckpt.state_dict_from_jax(tm.cfg, v))
    assert tm.takes_rgb and not tm.takes_landmarks
    jcfg = jconfig.get_config("i3d", **overrides)
    jm = japi.Model(cfg=jcfg, module=japi.build_module(jcfg), variables=v)
    frames = np.random.default_rng(8).integers(
        0, 256, (2, 16, *tm.cfg.preprocess.staged_frame_shape), np.uint8)
    want_ids, want = japi.predict(jm, frames)
    got_ids, got = tapi.predict(tm, frames)
    assert got.shape == want.shape == (2, 7) and got.dtype == np.float32
    np.testing.assert_array_equal(got_ids, want_ids)
    atol = LOGIT_ATOL if compute_dtype == "float32" else 0.02 * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)
    one_id, one = tapi.predict(tm, frames[1])
    assert one.shape == (7,) and one_id == got_ids[1]


def test_pytorch_i3d_checkpoint_loads(jax_i3d, tmp_path):
    """The port's names are pytorch-i3d's: the JAX importer reads the file
    back to the same variables, and ``load_model`` reads it; a file without
    ``logits.*`` keeps the module's own classifier, as ``import_i3d`` does;
    any other missing key raises."""
    v = jax_i3d[0]
    overrides = dict(num_classes=7, compute_dtype="float32", preprocess=dict(PP))
    sd = tckpt.state_dict_from_jax(tapi.get_config("i3d", **overrides), v)
    assert sd["logits.conv3d.weight"].shape == (7, 1024, 1, 1, 1)
    assert sd["Conv3d_1a_7x7.conv3d.weight"].shape == (64, 3, 7, 7, 7)
    assert "Mixed_5c.b3b.bn.running_var" in sd
    pt = str(tmp_path / "i3d.pt")
    torch.save(sd, pt)
    back = jckpt._load_torch_host(pt, v, jconfig.get_config("i3d", **overrides))
    for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(back),
                                 jax.tree_util.tree_leaves_with_path(v)):
        np.testing.assert_array_equal(np.asarray(a), b, err_msg=str(path))
    loaded = tapi.load_model("i3d", checkpoint=pt, device="cpu", **overrides)
    for k, t in loaded.module.state_dict().items():
        torch.testing.assert_close(t, sd[k], rtol=0, atol=0, msg=k)
    os.remove(pt)
    torch.save({k: t for k, t in sd.items() if not k.startswith("logits.")}, pt)
    kept = tapi.load_model("i3d", checkpoint=pt, device="cpu", seed=3,
                           **overrides).module.state_dict()
    own = tapi.load_model("i3d", device="cpu", seed=3, **overrides).module.state_dict()
    for k, t in kept.items():
        torch.testing.assert_close(t, own[k] if k.startswith("logits.") else sd[k],
                                   rtol=0, atol=0, msg=k)
    torch.save({k: t for k, t in sd.items() if k != "Mixed_4c.b1b.bn.weight"}, pt)
    with pytest.raises(KeyError, match="missing"):
        tapi.load_model("i3d", checkpoint=pt, device="cpu", **overrides)


def test_batchnorm3d_normalises_bf16_in_fp32():
    """BatchNorm3d with bf16 input and fp32 parameters (as ``load_model``
    keeps them) normalises in fp32 and rounds once: every value within one
    bf16 ulp of the fp32 normalisation of the same input rounded once, and
    nearer to it than BN computed all in bf16."""
    bn = torch.nn.BatchNorm3d(16, eps=1e-3).eval()
    rng = np.random.default_rng(9)
    with torch.no_grad():
        bn.running_mean.copy_(torch.from_numpy(rng.normal(0, 4, 16).astype(np.float32)))
        bn.running_var.copy_(torch.from_numpy(rng.uniform(0.05, 8, 16).astype(np.float32)))
        bn.weight.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, 16).astype(np.float32)))
        x = _ncdhw(_ndhwc(10, (2, 3, 5, 4, 16)) * 4).bfloat16()
        got = bn(x)
        ref = F.batch_norm(x.float(), bn.running_mean, bn.running_var, bn.weight,
                           bn.bias, False, 0.0, bn.eps)
        all_bf16 = F.batch_norm(x, *(t.bfloat16() for t in (
            bn.running_mean, bn.running_var, bn.weight, bn.bias)), False, 0.0, bn.eps)
    assert got.dtype == torch.bfloat16 and bn.weight.dtype == torch.float32
    ulp = torch.from_numpy(_bf16_ulp(np.maximum(ref.abs().numpy(), 1e-30)))
    assert bool(((got.float() - ref).abs() <= ulp).all())
    assert float((got.float() - ref).abs().sum()) < float((all_bf16.float() - ref).abs().sum())
