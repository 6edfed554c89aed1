"""TimeSformer (``timesformer``, the port's own family: the JAX package has
none) on the CPU at a tiny size — 4 frames of 32² staged at 40², patch 16,
d 64, 4 heads, 2 blocks, 10 classes, fp32 — against the plain reference
``perfbench/reference/timesformer.py``, which follows the original
``vit.py`` and shares no code with the port: the logits, one train step
with stochastic depth, where each attention's gradient may reach, the
public entry points, the attention counters and the spans."""

import json
import os

import numpy as np
import pytest
import torch

from asltpu_torch import api
from asltpu_torch.config import TrainConfig
from asltpu_torch.ops import attention as att
from asltpu_torch.train import loop
from perfbench.core import weights
from perfbench.reference import timesformer as ref

T, SIDE, STAGE = 4, 32, 40
SIZES = dict(num_classes=10, num_frames=T, patch_size=16, embed_dim=64, depth=2, num_heads=4,
             mlp_ratio=4)
PP = dict(num_frames=T, staging_size=(STAGE, STAGE), resize_short=STAGE, crop=SIDE,
          out_dtype="float32")
TRAIN = dict(learning_rate=1e-3, warmup_steps=1, num_steps=10, weight_decay=1e-4,
             label_smoothing=0.1, grad_clip_norm=1.0)
# fp32 on both sides; the port and the reference sum in other orders
# (F.linear over [B, N, d] against the reference's reshaped products, the
# CLS token apart from the patches, the spatial copy laid out otherwise),
# a few ulps of the largest value: 1e-5 of it leaves room for ~80 ulps.
REL = 1e-5


def ref_config(drop_path_rate: float = 0.1) -> dict:
    pp = dict(PP, mean=[0.485, 0.456, 0.406], std=[0.229, 0.224, 0.225])
    return dict(SIZES, drop_path_rate=drop_path_rate, preprocess=pp)


def port_kwargs(drop_path_rate: float = 0.1) -> dict:
    return dict(SIZES, drop_path_rate=drop_path_rate, compute_dtype="float32", preprocess=PP)


def params(seed: int, drop_path_rate: float = 0.1) -> dict:
    return weights.make_params(ref.param_specs(ref_config(drop_path_rate)), seed,
                               torch.device("cpu"))


def clips(seed: int, n: int = 2) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, 256, (n, T, STAGE, STAGE, 3), np.uint8))


def test_fp32_logits_match_the_reference():
    p = params(1)
    model = api.load_model("timesformer", device="cpu", **port_kwargs())
    weights.load_into(model.module, p)
    x = clips(2)
    got = model.predict_fn()(x)
    want = ref.forward(x, p, ref_config())
    assert got.shape == want.shape == (2, 10) and got.dtype == torch.float32
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= REL * scale
    # The two clips' logits differ far beyond the agreement.
    assert float((want[0] - want[1]).abs().max()) > 1e3 * REL * scale


def test_a_train_step_with_stochastic_depth_matches_the_reference():
    """Rate 0.5 (each block past the first draws masks that drop), batch 4:
    the loss and every leaf's clipped gradient of one ``make_train_step``
    step against ``Trainer.step`` from the same weights and generator seed;
    afterwards both generators stand at the same place."""
    rate, seed = 0.5, 21
    p = params(3, rate)
    masks = ref.draws(ref_config(rate), 4, torch.Generator().manual_seed(seed), "cpu")
    assert any(not bool(m.all()) for blk in masks for m in blk if m is not None)
    model = api.build_trainable("timesformer", device="cpu", **port_kwargs(rate))
    weights.load_into(model.module, p)
    tcfg = TrainConfig(batch_size=4, **TRAIN)
    state = loop.create_train_state(model.module, tcfg, seed=seed)
    x, labels = clips(4, n=4), torch.tensor([1, 7, 3, 3])
    state, metrics = loop.make_train_step(tcfg, model.cfg.preprocess)(state, x, labels)
    trainer = ref.Trainer(p, ref_config(rate), TRAIN, seed)
    want_loss, want_grads = trainer.step(x, labels)
    assert float(metrics["loss"]) == pytest.approx(want_loss, rel=REL)
    named = dict(model.module.named_parameters())
    assert sorted(named) == sorted(want_grads)
    for name, g in want_grads.items():
        err = float((named[name].grad - g).norm())
        assert err <= REL * float(g.norm()) + 1e-9, name
    assert torch.equal(torch.rand(8, generator=state.generator),
                       torch.rand(8, generator=trainer.gen))


def _reached(grad: torch.Tensor) -> set:
    return set(torch.nonzero(grad.abs().sum(-1)[0]).flatten().tolist())


def test_each_attention_reaches_only_its_own_tokens():
    """Inside one block: an output token's gradient reaches, through
    temporal attention, only the tokens of its patch position (every
    frame); through spatial attention only its own frame's tokens and the
    CLS token. Token k of [B, (h w t), d] is position k // T, frame k % T."""
    model = api.build_module(api.get_config("timesformer", **port_kwargs()))
    weights.load_into(model, params(5))
    blk = model.blocks[1]
    hw, d = (SIDE // 16) ** 2, SIZES["embed_dim"]
    gen = torch.Generator().manual_seed(6)
    x = torch.randn((1, hw * T, d), generator=gen).requires_grad_()
    cls = torch.randn((1, 1, d), generator=gen).requires_grad_()
    pos, frame = 2, 1
    token = pos * T + frame
    (g,) = torch.autograd.grad(blk.temporal(x, T)[0, token].sum(), x)
    assert _reached(g) == {pos * T + f for f in range(T)}
    new_cls, new_x = blk.spatial(cls, x, T)
    g, g_cls = torch.autograd.grad(new_x[0, token].sum(), (x, cls), retain_graph=True)
    assert _reached(g) == {q * T + frame for q in range(hw)}
    assert float(g_cls.abs().sum()) > 0
    # The CLS token's output averages over every frame.
    (g,) = torch.autograd.grad(new_cls.sum(), x)
    assert _reached(g) == set(range(hw * T))


def test_predict_and_stream_predict(tmp_path):
    from perfbench.core import video

    """``load_clip`` → ``predict`` (a batch and one clip) and
    ``stream_predict`` (batches of 2, the last padded) give the same logits:
    fp32, where a product's other batch size changes its sums by ulps."""
    model = api.load_model("timesformer", device="cpu", seed=4, **port_kwargs())
    assert model.takes_rgb and not model.takes_landmarks
    paths = [str(tmp_path / f"{k}.mp4") for k in range(3)]
    for k, path in enumerate(paths):
        video.write_video(path, num_frames=8, size=(48, 64), seed=k)
    staged = np.stack([api.load_clip(path, model.cfg.preprocess) for path in paths])
    assert staged.shape == (3, T, STAGE, STAGE, 3)
    ids, logits = api.predict(model, staged)
    one_id, one = api.predict(model, staged[1])
    assert logits.shape == (3, 10) and one_id == ids[1]
    np.testing.assert_allclose(one, logits[1], rtol=0, atol=1e-5)
    got = list(api.stream_predict(model, paths, batch_size=2, num_decode_workers=1))
    assert [g[0] for g in got] == paths
    np.testing.assert_allclose(np.stack([g[2] for g in got]), logits, rtol=0, atol=1e-5)


def test_the_cpu_takes_the_plain_path_and_the_counters_say_so():
    """A forward on the CPU makes 2 attention calls a block, all plain: at
    this size both sub-layers' sequences (4 frames; 4 patches and the CLS
    token) are short, so both go to the short-sequence op, whose CPU
    implementation is its plain version and launches nothing; the fused
    call itself (SDPA held to the fused backends, which have a CPU kernel
    too) counts in ``fused_attention.calls`` and agrees with the plain math
    to fp32 rounding."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from asltpu_torch.ops import short_attention_kernels as sa

    class Ops(TorchDispatchMode):
        calls = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Ops.calls += str(func) == "asltpu_torch.short_attention.default"
            return func(*args, **(kwargs or {}))

    model = api.load_model("timesformer", device="cpu", **port_kwargs())
    before = (att.fused_attention.calls, att.plain_attention.calls,
              sa.short_attention.launches)
    with Ops():
        model.predict_fn()(clips(7))
    assert (att.fused_attention.calls, att.plain_attention.calls,
            sa.short_attention.launches) == before
    assert Ops.calls == 2 * SIZES["depth"]
    gen = torch.Generator().manual_seed(8)
    q, k, v = (torch.randn((2, 4, 17, 16), generator=gen) for _ in range(3))
    got = att.fused_attention(q, k, v)
    assert att.fused_attention.calls == before[0] + 1
    torch.testing.assert_close(got, att.plain_attention(q, k, v), rtol=0, atol=1e-6)


def test_the_spans_hold_both_directions(tmp_path):
    """A traced train step: one ``timesformer.time_attn`` and one
    ``timesformer.space_attn`` range a block in the forward and one a
    block in the backward, the backward ones inside ``train.backward``;
    the recorder keeps them too."""
    from asltpu_torch.utils import profiling

    model = api.build_trainable("timesformer", device="cpu", **port_kwargs(0.5))
    tcfg = TrainConfig(batch_size=2, **TRAIN)
    state = loop.create_train_state(model.module, tcfg, seed=1)
    step = loop.make_train_step(tcfg, model.cfg.preprocess)
    profiling.RECORDER.clear()
    with profiling.trace(str(tmp_path)):
        step(state, clips(9), torch.tensor([0, 1]))
    (path,) = [os.path.join(tmp_path, f) for f in os.listdir(tmp_path)]
    events = [e for e in json.load(open(path))["traceEvents"]
              if e.get("cat") == "user_annotation"]
    (bwd,) = [e for e in events if e["name"] == "train.backward"]
    depth = SIZES["depth"]
    for name in ("timesformer.time_attn", "timesformer.space_attn"):
        ranges = [e for e in events if e["name"] == name]
        inside = [e for e in ranges if bwd["ts"] <= e["ts"] <= bwd["ts"] + bwd["dur"]]
        assert len(ranges) == 2 * depth and len(inside) == depth, name
        assert sum(s.name == name for s in profiling.recorded_spans()) == 2 * depth
    profiling.RECORDER.clear()


def test_the_counted_spatial_flops_are_the_references():
    """``space_attn_flops`` against torch's count of the reference's
    spatial attention sub-layer, forward and backward, on the meta
    device, times the blocks."""
    from torch.utils.flop_counter import FlopCounterMode

    cfg, batch = ref_config(), 3
    d, length = SIZES["embed_dim"], (SIDE // 16) ** 2 + 1
    p = {n: torch.zeros(s, device="meta", requires_grad=True)
         for n, s, *_ in ref.param_specs(cfg)}
    x = torch.zeros((batch * T, length, d), device="meta", requires_grad=True)
    counter = FlopCounterMode(display=False)
    with counter:
        y = ref.attention(x, p, "blocks.0.attn", SIZES["num_heads"], "fp32")
        torch.autograd.grad(y.sum(), [x] + [p[f"blocks.0.attn.{n}"] for n in
                                            ("qkv.weight", "qkv.bias", "proj.weight",
                                             "proj.bias")])
    assert ref.space_attn_flops(cfg, batch) == counter.get_total_flops() * SIZES["depth"]


def test_the_init_draws_once():
    """``init_weights`` leaves TimeSformer to its ``reset_parameters``, one
    draw from the generator, so the two give the same tensors from one
    seed: the linears, CLS token and positions within ±2 std (0.04) of
    N(0, 0.02²), ``temporal_fc`` 0 past block 0."""
    from asltpu_torch.models.common import init_weights

    module = api.build_module(api.get_config("timesformer", **port_kwargs()))
    init_weights(module, torch.Generator().manual_seed(0))
    twin = api.build_module(api.get_config("timesformer", **port_kwargs()))
    twin.reset_parameters(torch.Generator().manual_seed(0))
    twin_state = twin.state_dict()
    for name, t in module.state_dict().items():
        assert torch.equal(t, twin_state[name]), name
    for t in (module.blocks[0].attn.qkv.weight, module.head.weight, module.pos_embed):
        assert 0 < float(t.abs().max()) <= 0.04
    assert not module.blocks[1].temporal_fc.weight.any()
