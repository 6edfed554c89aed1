"""BatchNorm and LayerNorm keep fp32 parameters and statistics under a bf16
compute dtype, as the reference's ``param_dtype=float32`` does: the norm
takes the bf16 input, normalises in fp32 and rounds once."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asltpu.models import mobilenetv2 as jmnv2
from asltpu_torch import api as tapi
from asltpu_torch import ckpt as tckpt
from asltpu_torch.models import mobilenetv2 as tmnv2
from asltpu_torch.models.common import NORMS, cast_for_compute
from test_torch_models import randomize_bn

_LAYERS = ["stem"] + [f"block{i}" for i in range(17)] + ["head"]


def _bf16_ulp(m: float) -> float:
    return 2.0 ** (np.floor(np.log2(m)) - 7)


def test_bf16_layers_match_jax_with_fp32_bn():
    """MobileNetV2 (width 0.35, 2 × 32²) in bf16, layer by layer: each of
    the 19 port layers takes the JAX layer's input (the JAX model run op by
    op, so each op rounds where the module says). BN statistics are far
    from 0 and 1 — means from N(0, 4²), variances from U(0.05, 8.05) —
    where rounding them to bf16 moves the output. Bound: half a bf16 ulp
    of each layer's largest output.

    Measured on the CPU (torch 2.13.0+cpu, jax 0.9.0), in ulps of each
    layer's largest output: with the BNs fp32 (this tree) 0 at all 19
    layers; with every BN cast to bf16 (the parent's ``.to(bfloat16)`` of
    the backbone) 0.5 to 2.0, above half an ulp at 17 of the 19."""
    x = np.random.default_rng(0).standard_normal((2, 32, 32, 3)).astype(np.float32)
    jm = jmnv2.MobileNetV2(0.35, dtype=jnp.bfloat16)
    rng = np.random.default_rng(0)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), x)
    v = jax.tree.map(lambda s: (rng.standard_normal(s.shape) * (
        2.0 / np.prod(s.shape[:-1])) ** 0.5).astype(np.float32), shapes)
    v = randomize_bn(v, 0)

    def far_from_unit(node, in_bn):
        for k, a in node.items():
            if isinstance(a, dict):
                far_from_unit(a, k == "bn")
            elif in_bn and k == "mean":
                node[k] = rng.normal(0.0, 4.0, a.shape).astype(np.float32)
            elif in_bn and k == "var":
                node[k] = rng.uniform(0.05, 8.05, a.shape).astype(np.float32)

    far_from_unit(v, False)
    _, state = jm.apply(v, x, capture_intermediates=lambda mdl, _: mdl.name in _LAYERS)
    outs = [np.asarray(state["intermediates"][n]["__call__"][0].astype(jnp.float32))
            for n in _LAYERS]
    ins = [np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))] + outs[:-1]
    port = tmnv2.MobileNetV2(0.35).eval()
    port.load_state_dict(tckpt.mobilenetv2_state_dict(v["params"], v["batch_stats"],
                                                      prefix=""))
    cast_for_compute(port, torch.bfloat16)
    assert port[0][1].running_mean.dtype == torch.float32
    with torch.no_grad():
        for i, (inp, want) in enumerate(zip(ins, outs)):
            got = port[i](torch.from_numpy(inp).bfloat16().permute(0, 3, 1, 2))
            got = got.permute(0, 2, 3, 1).float().numpy()
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=0.5 * _bf16_ulp(np.abs(want).max()),
                                       err_msg=f"layer {i}")


SMALL = {
    "mobilenet_gru": dict(num_classes=7, gru_hidden=16, width_mult=0.35),
    "resnet_transformer": dict(num_classes=7, d_model=32, num_heads=4, num_tx_layers=2),
    "i3d": dict(num_classes=7),
    "two_stream": dict(num_classes=7, width_mult=0.35, d_model=32, num_heads=4),
}
PP = {"num_frames": 2, "staging_size": (40, 40), "resize_short": 36, "crop": 32}


def _check_dtypes(module, keep_fp32):
    """Every norm's parameters and buffers and every parameter of the
    ``keep_fp32`` submodules fp32, every other parameter (convs, linears,
    attention, CLS, positions) bf16. Returns the kinds of layer checked."""
    keep = {m for k in keep_fp32 for m in k.modules()}
    kinds = set()
    for name, m in module.named_modules():
        norm = isinstance(m, NORMS)
        tensors = list(m.parameters(recurse=False)) + (
            list(m.buffers(recurse=False)) if norm else [])
        want = torch.float32 if norm or m in keep else torch.bfloat16
        for t in tensors:
            if t.is_floating_point():
                assert t.dtype == want, (name, t.dtype)
                kinds.add(type(m).__name__)
    return kinds


@pytest.mark.parametrize("family", sorted(SMALL))
def test_load_model_keeps_norms_fp32(family):
    """bf16 ``load_model``: every BatchNorm/LayerNorm parameter and buffer
    fp32, every conv bf16, the heads' fp32 parts (``fp32_modules``) fp32
    and the rest bf16 — and the same after ``load_state_dict`` of an fp32
    twin's state, whose values the norms then hold exactly."""
    model = tapi.load_model(family, device="cpu", preprocess=dict(PP), **SMALL[family])
    keep = tapi.fp32_modules(model.module)
    kinds = _check_dtypes(model.module, keep)
    assert ({"Conv3d", "BatchNorm3d"} if family == "i3d"
            else {"Conv2d", "BatchNorm2d"}) <= kinds
    if family in ("resnet_transformer", "two_stream"):
        assert {"LayerNorm", "MultiheadAttention", "Linear"} <= kinds
    twin = tapi.load_model(family, device="cpu", seed=1, compute_dtype="float32",
                           preprocess=dict(PP), **SMALL[family])
    assert all(p.dtype == torch.float32 for p in twin.module.parameters())
    model.module.load_state_dict(twin.module.state_dict())
    assert _check_dtypes(model.module, keep) == kinds
    for m, t in zip(model.module.modules(), twin.module.modules()):
        if isinstance(m, NORMS):
            for a, b in zip(list(m.parameters()) + list(m.buffers()),
                            list(t.parameters()) + list(t.buffers())):
                torch.testing.assert_close(a, b, rtol=0, atol=0)
