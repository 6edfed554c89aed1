"""The fused MBConv slice against the JAX package on the CPU:
``asltpu_torch.ops.mbconv_kernels`` (``fold_bn``, the plain version of the
fused block, the wrapper on CPU tensors, the two kernels' tile plans, the
TF32 kernel's operand roundings emulated on the plain version) and
``asltpu_torch.models.mobilenet_fused.fused_backbone_apply`` composed with
the GRU head. The JAX side runs its Pallas kernel in interpret mode, as
``tests/unit/test_mbconv_pallas.py`` does; inputs are made with numpy and
handed to both packages."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from asltpu import ckpt as jckpt
from asltpu.models import mobilenet_fused as jfused
from asltpu.models import mobilenetv2 as jmnv2
from asltpu.models import temporal as jtemporal
from asltpu.ops import mbconv_pallas as jmb
from asltpu_torch import ckpt as tckpt
from asltpu_torch.models import mobilenet_fused as tfused
from asltpu_torch.models.common import cast_for_compute
from asltpu_torch.models import mobilenetv2 as tmnv2
from asltpu_torch.models import temporal as ttemporal
from asltpu_torch.ops import mbconv_kernels as k
from test_torch_models import randomize_bn

ATOL = 2e-4  # fp32: accumulation order only (tests/unit/test_mbconv_pallas.py)
LOGIT_ATOL = 5e-2  # the bf16 slice bound of tests/test_torch_api.py
# The seven stride-1 expanded block shapes of MobileNetV2 at width 1.0 and
# 224² input, (H, Cin, Ce, Cout), and their counts in one backbone.
MAIN_SHAPES = [
    (56, 24, 144, 24), (28, 32, 192, 32), (14, 64, 384, 64),
    (14, 64, 384, 96), (14, 96, 576, 96), (7, 160, 960, 160),
    (7, 160, 960, 320),
]


def _bf16_ulp(m: float) -> float:
    """One bf16 ulp (8 significant bits) at magnitude ``m``."""
    return 2.0 ** (np.floor(np.log2(m)) - 7)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32)))


def _block(cin, cout, seed):
    """A JAX stride-1 t=6 InvertedResidual with randomized BN, as numpy
    variables, and an input [2, 16, 12, cin] (non-square, so an H/W mix-up
    fails)."""
    block = jmnv2.InvertedResidual(cout, stride=1, expand_ratio=6,
                                   dtype=jnp.float32)
    x = np.random.default_rng(seed).standard_normal((2, 16, 12, cin)).astype(np.float32)
    return block, randomize_bn(block.init(jax.random.PRNGKey(seed), x), seed), x


def _jax_folded(v):
    p, s = v["params"], v["batch_stats"]

    def fold(name, kernel):
        return jmb.fold_bn(kernel, p[name]["bn"]["scale"], p[name]["bn"]["bias"],
                           s[name]["bn"]["mean"], s[name]["bn"]["var"])

    w1, b1 = fold("expand", p["expand"]["conv"]["kernel"][0, 0])
    dw, b2 = fold("depthwise", p["depthwise"]["conv"]["kernel"][:, :, 0, :])
    w2, b3 = fold("project", p["project"]["conv"]["kernel"][0, 0])
    return [np.asarray(a) for a in (w1, b1, dw, b2, w2, b3)]


@pytest.mark.parametrize("shape", [(3, 3, 1, 24), (24, 48), (1, 1, 16, 96)])
def test_fold_bn_matches_jax(shape):
    rng = np.random.default_rng(1)
    cout = shape[-1]
    w = rng.standard_normal(shape).astype(np.float32)
    scale, var = (rng.uniform(0.5, 1.5, cout).astype(np.float32) for _ in range(2))
    bias, mean = (rng.normal(0.0, 0.1, cout).astype(np.float32) for _ in range(2))
    want = jmb.fold_bn(w, scale, bias, mean, var)
    got = k.fold_bn(*map(_t, (w, scale, bias, mean, var)))
    for g, wv in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wv), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("cin,cout,res,dtype", [
    (16, 16, True, "float32"),
    (16, 24, False, "float32"),
    (16, 16, True, "bfloat16"),
])
def test_plain_matches_jax_kernel(cin, cout, res, dtype):
    _, v, x = _block(cin, cout, seed=2)
    args = _jax_folded(v)
    want = np.asarray(jmb.fused_mbconv_s1(
        jnp.asarray(x, dtype), *args, use_res=res, row_tile=8, interpret=True
    ).astype(jnp.float32))
    xt = _t(x).to(getattr(torch, dtype))
    got = k.fused_mbconv_s1_plain(xt, *map(_t, args), use_res=res)
    assert got.dtype == xt.dtype and got.shape == (2, 16, 12, cout)
    # bf16: both compute in fp32 and round once, so they may differ by one
    # bf16 ulp where the fp32 sums straddle a rounding boundary.
    atol = ATOL if dtype == "float32" else _bf16_ulp(np.abs(want).max())
    np.testing.assert_allclose(got.float().numpy(), want, atol=atol, rtol=0)


@pytest.mark.parametrize("cin,cout", [(16, 16), (16, 24)])
def test_plain_matches_port_inverted_residual(cin, cout):
    """The folding and the torch → JAX layouts of ``fused_block_args``
    (expand [Ce,Cin,1,1] → [Cin,Ce], depthwise [Ce,1,3,3] → [3,3,Ce],
    project [Cout,Ce,1,1] → [Ce,Cout]) against the port's own block in eval
    and against the JAX package's folding."""
    _, v, x = _block(cin, cout, seed=3)
    tm = tmnv2.InvertedResidual(cin, cout, 1, 6).eval()
    tm.load_state_dict(
        tckpt.inverted_residual_state_dict(v["params"], v["batch_stats"]))
    args = tfused.fused_block_args(tm)
    for got, want in zip(args, _jax_folded(v)):
        assert got.is_contiguous()
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-6)
    with torch.no_grad():
        want = tm(_t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        got = k.fused_mbconv_s1_plain(_t(x), *args, use_res=tm.use_res)
    torch.testing.assert_close(got, want, atol=ATOL, rtol=0)


def test_wrapper_on_cpu_is_the_plain_version():
    _, v, x = _block(16, 16, seed=4)
    args = list(map(_t, _jax_folded(v)))
    before = k.fused_mbconv_s1.launches
    for xt in (_t(x), _t(x).bfloat16()):
        got = k.fused_mbconv_s1(xt, *args)
        torch.testing.assert_close(got, k.fused_mbconv_s1_plain(xt, *args),
                                   rtol=0, atol=0)
    assert k.fused_mbconv_s1.launches == before == 0


@pytest.mark.parametrize("h,cin,ce,cout", MAIN_SHAPES)
def test_tile_plan_fits_the_kernel(h, cin, ce, cout):
    """The fp32 kernel's plan, within the limits mbconv.cu checks before it
    launches: every output of a tile has an accumulator, and two blocks
    share an SM's memory."""
    tr, cot = k.tile_plan(h, h, cin, cout)
    assert 1 <= tr <= h and 1 <= cot <= cout
    assert tr * h * cot <= k._THREADS * k._MAX_ACC
    assert k.smem_bytes(tr, h, cin, cot) <= k._SMEM_BUDGET
    assert tr == -(-h // -(-h // tr))  # rows spread evenly over the tiles
    with pytest.raises(ValueError, match="shared memory"):
        k.tile_plan(h, h, 8192, cout)


# The main-path shapes as (H, W, Cin, Cout), then ragged ones: H ≠ W, and
# Cin and Cout not multiples of 8 (the K and N padding of the TF32 tiles).
PLAN_SHAPES = [(h, h, cin, cout) for h, cin, _, cout in MAIN_SHAPES] + [
    (13, 11, 16, 16), (9, 9, 12, 20), (5, 7, 3, 40)]


@pytest.mark.parametrize("h,w,cin,cout", PLAN_SHAPES)
def test_tf32_tile_plan_fits_the_kernel(h, w, cin, cout):
    """The TF32 kernel's plan, within the limits mbconv.cu checks before it
    launches (fragments a warp, shared memory), with every wmma pointer on
    a multiple of 8 floats and every leading dimension a multiple of 4."""
    plan = k.tf32_tile_plan(h, w, cin, cout)
    lay = k.tf32_layout(plan.rows, w, cin, cout)
    assert 1 <= plan.rows <= h
    assert plan.frags_per_warp == -(-lay["frags"] // k._WARPS) <= k._MAX_FRAG
    assert plan.smem_bytes == 4 * lay["total"]
    budget = {2: k._SMEM_BUDGET, 1: k._SMEM_ONE_BLOCK}[plan.blocks_per_sm]
    assert plan.smem_bytes <= budget
    offsets = [lay[key] for key in
               ("es", "ds", "w1", "w2", "dw", "b1", "b2", "mask", "col", "total")]
    assert all(o % 8 == 0 for o in offsets) and offsets == sorted(offsets)
    assert all(lay[key] % 4 == 0
               for key in ("ld_x", "ld_e", "ld_w1", "ld_w2", "ld_stage"))
    assert lay["ld_x"] >= cin and lay["ld_w2"] >= cout
    assert lay["cout_covered"] >= cout  # Cout is never split
    assert plan.rows == -(-h // -(-h // plan.rows))  # rows spread evenly
    if (h, cin, cout) in {(s[0], s[1], s[3]) for s in MAIN_SHAPES}:
        assert plan.blocks_per_sm == 2
    with pytest.raises(ValueError, match="shared memory"):
        k.tf32_tile_plan(h, w, 8192, cout)
    with pytest.raises(ValueError, match="accumulators"):
        k.tf32_tile_plan(h, 64, cin, 4096)


def _tf32(t: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32``: round fp32 to 10 mantissa bits, ties away from
    zero (add half of the dropped 13 bits' range, clear them)."""
    bits = t.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.bfloat16().float()


def _plain_tf32(x, w1, b1, dw, b2, w2, b3, use_res=True, rnd=_tf32):
    """``fused_mbconv_s1_plain`` in fp32 with the TF32 kernel's operand
    roundings ``rnd``: ``w1``, ``w2`` and the depthwise output (the
    project's A)."""
    n, h, w, cin = x.shape
    ce, cout = w1.shape[1], w2.shape[1]
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))
    e = torch.clamp(xp @ rnd(w1) + b1, 0.0, 6.0)
    ring = torch.zeros((h + 2, w + 2, 1))
    ring[1:-1, 1:-1] = 1.0
    e = e * ring
    taps = dw.reshape(9, ce)
    acc = torch.zeros((n, h, w, ce))
    for dr in range(3):
        for dc in range(3):
            acc = acc + e[:, dr:dr + h, dc:dc + w, :] * taps[dr * 3 + dc]
    out = rnd(torch.clamp(acc + b2, 0.0, 6.0)) @ rnd(w2) + b3
    return out + x.float() if use_res and cin == cout else out


def _scaled_args(n, h, cin, ce, cout, seed):
    """x [n, h, h, cin] bf16 and folded fp32 weights at ``chip_smoke.py``'s
    scales: fan-in normal weights, biases N(0, 0.1)."""
    rng = np.random.default_rng(seed)

    def t(shape, std):
        return torch.from_numpy((rng.standard_normal(shape) * std).astype(np.float32))

    return (t((n, h, h, cin), 1.0).bfloat16(), t((cin, ce), (2 / cin) ** 0.5),
            t((ce,), 0.1), t((3, 3, ce), (2 / 9) ** 0.5), t((ce,), 0.1),
            t((ce, cout), (1 / ce) ** 0.5), t((cout,), 0.1))


@pytest.mark.parametrize("h,cin,ce,cout", MAIN_SHAPES)
def test_tf32_operands_keep_the_bf16_check(h, cin, ce, cout):
    """The TF32 kernel's arithmetic, emulated: its operand roundings move the
    fp32 result by under a quarter of one bf16 ulp of the largest output, so
    after the one rounding to bf16 it stays within one ulp of the plain
    version and of the JAX kernel (interpret mode), the check the kernel
    is held to on the card."""
    x, *wts = _scaled_args(2, h, cin, ce, cout, seed=10 + h + cout)
    want32 = k.fused_mbconv_s1_plain(x.float(), *wts)
    got32 = _plain_tf32(x, *wts)
    ulp = _bf16_ulp(float(want32.abs().max()))
    assert float((got32 - want32).abs().max()) < ulp / 4
    got = got32.bfloat16().float()
    plain = k.fused_mbconv_s1_plain(x, *wts).float()
    jax_out = np.asarray(jmb.fused_mbconv_s1(
        jnp.asarray(x.float().numpy(), jnp.bfloat16), *(w.numpy() for w in wts),
        row_tile=h, interpret=True).astype(jnp.float32))
    assert float((got - plain).abs().max()) <= ulp
    np.testing.assert_allclose(got.numpy(), jax_out, atol=ulp, rtol=0)


@pytest.mark.parametrize("h,cin,ce,cout", MAIN_SHAPES)
def test_bf16_operands_would_move_the_result_more(h, cin, ce, cout):
    """Why the kernel's products are TF32 and not bf16: with bf16 operands
    the same emulation moves the fp32 result by over a quarter of one bf16
    ulp of the largest output (0.36–0.62 at these shapes), too close to the
    one-ulp check once the final rounding adds its own half ulp."""
    x, *wts = _scaled_args(2, h, cin, ce, cout, seed=10 + h + cout)
    want32 = k.fused_mbconv_s1_plain(x.float(), *wts)
    ulp = _bf16_ulp(float(want32.abs().max()))
    moved = float((_plain_tf32(x, *wts, rnd=_bf16) - want32).abs().max())
    assert moved > ulp / 4


@pytest.fixture(scope="module")
def width1_backbones():
    """The JAX MobileNetV2 at width 1.0 with randomized BN, the port's
    backbone holding the same parameters and statistics (fp32), and two
    32² frames; the JAX fused backbone's features (Pallas in interpret
    mode) and the port's."""
    frames = np.random.default_rng(5).standard_normal((2, 32, 32, 3)).astype(np.float32)
    jm = jmnv2.MobileNetV2(1.0, dtype=jnp.float32)
    v = randomize_bn(jm.init(jax.random.PRNGKey(5), frames), seed=5)
    tm = tmnv2.MobileNetV2(1.0).eval()
    tm.load_state_dict(
        tckpt.mobilenetv2_state_dict(v["params"], v["batch_stats"], prefix=""))
    want = np.asarray(jfused.fused_backbone_apply(
        v, jnp.asarray(frames), interpret=True).astype(jnp.float32))
    got = tfused.fused_backbone_apply(tm, torch.from_numpy(frames))
    return tm, frames, want, got, v


# Both packages fold in fp32 from the same values and round at the same
# places (bf16 conv, bf16 bias add, fused blocks in fp32 rounded once), but
# their bf16 convolutions sum in other orders; one-ulp differences carried
# through 17 blocks stay within a few bf16 ulps of the largest feature.
FEATURE_RTOL = 2 ** -5


def test_fused_backbone_matches_jax(width1_backbones):
    _, _, want, got, _ = width1_backbones
    assert got.shape == want.shape == (2, 1280) and got.dtype == torch.bfloat16
    assert np.isfinite(want).all()
    np.testing.assert_allclose(got.float().numpy(), want,
                               atol=FEATURE_RTOL * np.abs(want).max(), rtol=0)


def test_fused_backbone_matches_port_backbone(width1_backbones):
    """The fused backbone against the port's own bf16 backbone (BN unfolded
    and fp32, as ``predict`` runs it): the comparison ``chip_smoke.py``
    makes on the card."""
    tm, frames, _, got, _ = width1_backbones
    plain = tmnv2.MobileNetV2(1.0).eval()
    plain.load_state_dict(tm.state_dict())
    cast_for_compute(plain, torch.bfloat16)
    with torch.no_grad():
        want = plain(torch.from_numpy(frames).permute(0, 3, 1, 2).bfloat16())
    want = want.float().numpy()
    np.testing.assert_allclose(got.float().numpy(), want,
                               atol=FEATURE_RTOL * np.abs(want).max(), rtol=0)


def test_fused_layers_match_port_layers(width1_backbones):
    """Each of the 19 layers of the fused path against the port's own bf16
    layer on the same input; the dispatch is the JAX function's."""
    tm, frames, _, _, _ = width1_backbones
    plain = tmnv2.MobileNetV2(1.0).eval()
    plain.load_state_dict(tm.state_dict())
    cast_for_compute(plain, torch.bfloat16)
    layers = tfused.fused_layers(tm)
    fused = [getattr(f, "func", None) is tfused._fused_block for f in layers]
    assert len(layers) == len(plain) == 19 and sum(fused) == 12
    y = torch.from_numpy(frames).bfloat16()
    with torch.no_grad():
        for i, layer in enumerate(layers):
            want = plain[i](y.permute(0, 3, 1, 2)).permute(0, 2, 3, 1).float()
            y = layer(y)
            assert y.dtype == torch.bfloat16 and y.shape == want.shape
            np.testing.assert_allclose(y.float().numpy(), want.numpy(), rtol=0,
                                       atol=FEATURE_RTOL * float(want.abs().max()),
                                       err_msg=f"layer {i}")


def _jax_layers(v):
    """The JAX fused backbone's layers in order, as its own functions, with
    the dispatch of ``asltpu.models.mobilenet_fused.fused_backbone_apply``."""
    p, s = v["params"], v["batch_stats"]
    layers = [lambda x: jfused._conv_bn(x, p["stem"], s["stem"], stride=2)]
    idx = 0
    for t, _, n, st in jmnv2._INVERTED_RESIDUAL_SCHEDULE:
        for i in range(n):
            stride = st if i == 0 else 1
            bp, bs = p[f"block{idx}"], s[f"block{idx}"]
            if stride == 1 and t != 1:
                layers.append(lambda x, bp=bp, bs=bs: jfused._fused_block(
                    x, bp, bs, jfused._row_tile_for(x.shape[1]), interpret=True))
            else:
                layers.append(lambda x, bp=bp, bs=bs, stride=stride, t=t:
                              jfused._plain_block(x, bp, bs, stride, t))
            idx += 1
    layers.append(lambda x: jfused._conv_bn(x, p["head"], s["head"]))
    return layers


# One layer of the two packages on the same bf16 input: the same folding in
# fp32 and the same rounding points; only the sums' order differs.
LAYER_RTOL = 2 ** -6


def test_fused_layers_match_jax_layers(width1_backbones):
    """Layer by layer against the JAX package, with BN statistics
    calibrated on a seeded batch (a train-mode pass with momentum 1) so
    that every layer's output is of order 1 and depends on its input; the
    randomized statistics of the fixture carry little of the input to the
    features (the two frames' features differ by 2.5% of the largest).
    Each layer takes the port's previous output, so rounding differences
    do not compound."""
    tm, frames, _, _, v = width1_backbones
    cal = tmnv2.MobileNetV2(1.0)
    cal.load_state_dict(tm.state_dict())
    for m in cal.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.momentum = 1.0
    calib = np.random.default_rng(7).standard_normal((8, 32, 32, 3)).astype(np.float32)
    with torch.no_grad():
        cal(torch.from_numpy(calib).permute(0, 3, 1, 2), train=True)
    sd = {f"features.{key}": t.numpy() for key, t in cal.state_dict().items()}
    jv = jckpt.import_mobilenetv2(sd, v, prefix="")
    y = torch.from_numpy(frames).bfloat16()
    for i, (layer, jlayer) in enumerate(zip(tfused.fused_layers(cal), _jax_layers(jv))):
        with torch.no_grad():
            got = layer(y)
        want = np.asarray(jlayer(jnp.asarray(y.float().numpy(), jnp.bfloat16)).astype(
            jnp.float32))
        assert got.shape == want.shape and np.abs(want).max() > 0.1, i
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                                   atol=LAYER_RTOL * np.abs(want).max(),
                                   err_msg=f"layer {i}")
        y = got


def test_fused_backbone_then_gru_head_matches_jax(width1_backbones):
    _, _, want_feats, got_feats, _ = width1_backbones
    feats = want_feats.reshape(2, 1, 1280)
    jh = jtemporal.GRUHead(7, hidden=32, num_layers=1, dropout=0.2)
    v = randomize_bn(jh.init(jax.random.PRNGKey(6), feats), seed=6)
    th = ttemporal.GRUHead(7, 1280, 32, 1, 0.2).eval()
    th.load_state_dict(tckpt.gru_head_state_dict(v["params"], 1))
    want = np.asarray(jh.apply(v, feats, False))
    with torch.no_grad():
        got = th(got_feats.reshape(2, 1, 1280)).numpy()
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    np.testing.assert_allclose(got, want, atol=LOGIT_ATOL)
