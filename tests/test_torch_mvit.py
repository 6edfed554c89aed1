"""MViTv2 (``mvit_v2``, the port's own family: the JAX package has none) on
the CPU at a small size — two stages (width 16 with one head, then 32 with
two: heads of 16), a q-strided transition, k/v pooled at the adaptive
stride (1, 2, 2), 4 × 32² clips (a 2 × 8 × 8 token grid), 10 classes, fp32
— against the plain reference ``perfbench/reference/mvit.py``, which
follows SlowFast's ``MViT`` and shares no code with the port: the logits,
one train step with stochastic depth and dropout (every leaf's gradient,
the relative-position tables and the pools included), the decomposed bias
against one built from each token's (t, h, w), the unbiased cls row and
column, the published geometry and parameter count, the counters, the
spans and the refusals."""

import json
import math
import os

import numpy as np
import pytest
import torch

from asltpu_torch import api
from asltpu_torch.config import TrainConfig
from asltpu_torch.models import mvit as mv
from asltpu_torch.ops import attention as att
from asltpu_torch.train import loop
from perfbench.core import weights
from perfbench.reference import mvit as ref
from perfbench.reference import ops as ref_ops

# Block 0: q 2×8×8 over k/v 2×4×4 (Lq > Lk); block 1, the transition: q
# strided to 2×4×4 over k/v 2×8×8 (Lk > Lq), width and heads doubled; block
# 2: q and k/v 2×4×4.
SIZES = dict(num_classes=10, num_frames=4, patch_kernel=(3, 7, 7), patch_stride=(2, 4, 4),
             patch_padding=(1, 3, 3), embed_dim=16, depth=3, num_heads=1, dim_mul=((1, 2.0),),
             head_mul=((1, 2.0),), pool_q_stride=((0, 1, 1, 1), (1, 1, 2, 2), (2, 1, 1, 1)),
             pool_kvq_kernel=(3, 3, 3), pool_kv_stride_adaptive=(1, 2, 2), mlp_ratio=4)
STAGED, CROP = 40, 32
TRAIN = dict(learning_rate=1e-3, warmup_steps=1, num_steps=10, weight_decay=1e-4,
             label_smoothing=0.1, grad_clip_norm=1.0)
# fp32 on both sides; the port and the reference sum in other orders (the
# bias added inside the scaled product against after it, the three terms
# summed before the scores against into them, the pools' layouts), a few
# ulps of the largest value: 1e-5 of it leaves room for ~80 ulps.
REL = 1e-5


def ref_config(drop_path_rate: float = 0.1, dropout: float = 0.5) -> dict:
    pp = dict(num_frames=4, staging_size=[STAGED] * 2, resize_short=STAGED, crop=CROP,
              mean=[0.485, 0.456, 0.406], std=[0.229, 0.224, 0.225])
    return dict(SIZES, drop_path_rate=drop_path_rate, dropout=dropout, preprocess=pp)


def port_kwargs(drop_path_rate: float = 0.1, dropout: float = 0.5) -> dict:
    pp = dict(num_frames=4, staging_size=(STAGED, STAGED), resize_short=STAGED, crop=CROP,
              out_dtype="float32")
    return dict(SIZES, drop_path_rate=drop_path_rate, dropout=dropout, compute_dtype="float32",
                preprocess=pp)


def published() -> dict:
    """The reference's configuration at the published sizes."""
    cfg = api.get_config("mvit_v2")
    keys = {k: getattr(cfg, k) for k in ref_config() if k != "preprocess"}
    return dict(keys, drop_path_rate=0.3, dropout=0.5, preprocess=dict(crop=cfg.preprocess.crop))


def params(seed: int, cfg: dict) -> dict:
    return weights.make_params(ref.param_specs(cfg), seed, torch.device("cpu"))


def clips(seed: int, n: int = 2) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, 256, (n, 4, STAGED, STAGED, 3), np.uint8))


def test_fp32_logits_match_the_reference():
    cfg = ref_config()
    p = params(1, cfg)
    model = api.load_model("mvit_v2", device="cpu", **port_kwargs())
    weights.load_into(model.module, p)
    x = clips(2)
    got = model.predict_fn()(x)
    want = ref.forward(x, p, cfg)
    assert got.shape == want.shape == (2, 10) and got.dtype == torch.float32
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= REL * scale
    # The two clips' logits differ far beyond the agreement.
    assert float((want[0] - want[1]).abs().max()) > 1e3 * REL * scale


def test_a_train_step_with_stochastic_depth_matches_the_reference():
    """Rate 0.5 (each block past the first draws masks that drop) and the
    head's dropout 0.5, batch 4: the loss, every leaf's clipped gradient
    (the relative-position tables and the pools' convs among them) and
    every leaf's change of one ``make_train_step`` step against
    ``Trainer.step`` from the same weights and generator seed; afterwards
    both generators stand at the same place."""
    rate, seed = 0.5, 21
    cfg = ref_config(rate)
    p = params(3, cfg)
    masks = ref.draws(cfg, 4, torch.Generator().manual_seed(seed), "cpu")
    assert any(not bool(m.all()) for blk in masks for m in blk if m is not None)
    model = api.build_trainable("mvit_v2", device="cpu", **port_kwargs(rate))
    weights.load_into(model.module, p)
    tcfg = TrainConfig(batch_size=4, **TRAIN)
    state = loop.create_train_state(model.module, tcfg, seed=seed)
    x, labels = clips(4, n=4), torch.tensor([1, 7, 3, 3])
    state, metrics = loop.make_train_step(tcfg, model.cfg.preprocess)(state, x, labels)
    trainer = ref.Trainer(p, cfg, TRAIN, seed)
    want_loss, want_grads = trainer.step(x, labels)
    assert float(metrics["loss"]) == pytest.approx(want_loss, rel=REL)
    named = dict(model.module.named_parameters())
    assert sorted(named) == sorted(want_grads)
    # The last block's pooled queries reach no logit (the head reads the cls
    # token, whose query is not pooled): its pool_q alone takes no gradient.
    for name in ("blocks.1.attn.rel_pos_t", "blocks.1.attn.rel_pos_h",
                 "blocks.1.attn.pool_q.weight", "blocks.2.attn.pool_k.weight", "cls_token"):
        assert float(want_grads[name].norm()) > 0, name
    assert float(want_grads["blocks.2.attn.pool_q.weight"].norm()) == 0
    # A shift of every key moves a query's scores alike, which the softmax
    # ignores: norm_k's bias takes no gradient but rounding's, under 1e-8 of
    # the largest leaf's; AdamW turns that noise into a step of about the
    # learning rate either way, so those leaves are left out.
    norms = {n: float(g.norm()) for n, g in want_grads.items()}
    noise = {n for n, v in norms.items() if 0 < v < 1e-8 * max(norms.values())}
    assert noise == {f"blocks.{i}.attn.norm_k.bias" for i in range(3)}
    for name, g in want_grads.items():
        if name in noise:
            continue
        err = float((named[name].grad - g).norm())
        assert err <= REL * float(g.norm()) + 1e-9, name
        # AdamW's first step moves every leaf by about the learning rate:
        # the same rounding of the gradient, relative to the change.
        change = named[name].detach() - p[name]
        want_change = trainer.params[name].detach() - p[name]
        assert float((change - want_change).norm()) <= 1e-4 * float(want_change.norm()) + 1e-9, \
            name
    assert torch.equal(torch.rand(8, generator=state.generator),
                       torch.rand(8, generator=trainer.gen))


def brute_force_bias(q: torch.Tensor, tables: dict, geo: mv.Geometry) -> torch.Tensor:
    """The bias [B, h, Lq, Lk] term by term: each token's (t, h, w) from its
    flat position, each axis's row from SlowFast's distance with the sides
    scaled to the longer, q times the sum of the three rows; 0 in the cls
    row and column."""
    b, h, lq, c = q.shape
    bias = torch.zeros((b, h, lq, geo.lk), dtype=q.dtype)

    def coords(i, thw):
        return (i // (thw[1] * thw[2]), i // thw[2] % thw[1], i % thw[2])

    def row(axis, a, k_pos):
        nq, nk = geo.q_thw[axis], geo.kv_thw[axis]
        d = a * max(nk / nq, 1.0) - k_pos * max(nq / nk, 1.0) + (nk - 1) * max(nq / nk, 1.0)
        return tables["thw"[axis]][int(d)]

    for i in range(lq - 1):
        qi = coords(i, geo.q_thw)
        for j in range(geo.lk - 1):
            kj = coords(j, geo.kv_thw)
            r = sum(row(axis, qi[axis], kj[axis]) for axis in range(3))
            bias[:, :, 1 + i, 1 + j] = q[:, :, 1 + i] @ r
    return bias


@pytest.mark.parametrize("block", [0, 1, 2])
def test_the_bias_is_the_sum_over_each_tokens_position(block):
    """``rel_pos_bias`` against :func:`brute_force_bias` for each block of
    the small model (Lq > Lk, Lk > Lq, equal), on a seeded q and tables;
    the cls row and column are 0; each row starts at a multiple of 16
    elements in storage."""
    model = api.build_module(api.get_config("mvit_v2", **port_kwargs()))
    geo = model.geometry(model.patch_dims, torch.device("cpu"))[block]
    attn = model.blocks[block].attn
    gen = torch.Generator().manual_seed(30 + block)
    heads, c = attn.num_heads, attn.rel_pos_t.shape[1]
    q = torch.randn((2, heads, geo.lq, c), generator=gen, dtype=torch.float64)
    tables = {a: torch.randn(getattr(attn, f"rel_pos_{a}").shape, generator=gen,
                             dtype=torch.float64) for a in "thw"}
    got = mv.rel_pos_bias(q, tables["h"], tables["w"], tables["t"], geo)
    want = brute_force_bias(q, tables, geo)
    assert got.shape == want.shape == (2, heads, geo.lq, geo.lk)
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)
    assert not got[:, :, 0].any() and not got[:, :, :, 0].any()
    assert got.stride(-1) == 1 and all(s % att.BIAS_ALIGN == 0 for s in got.stride()[:-1])


def test_the_bias_gradient_is_the_plain_sums():
    """The gradient of q and of the three tables through ``rel_pos_bias``
    (its own backward: the bias's gradient summed over the other key axes)
    equals autograd's through the brute-force bias, whose cls row and
    column take none."""
    model = api.build_module(api.get_config("mvit_v2", **port_kwargs()))
    geo = model.geometry(model.patch_dims, torch.device("cpu"))[1]
    gen = torch.Generator().manual_seed(40)
    q = torch.randn((2, 2, geo.lq, 16), generator=gen, dtype=torch.float64, requires_grad=True)
    tables = {a: torch.randn(getattr(model.blocks[1].attn, f"rel_pos_{a}").shape, generator=gen,
                             dtype=torch.float64, requires_grad=True) for a in "thw"}
    weight = torch.randn((2, 2, geo.lq, geo.lk), generator=gen, dtype=torch.float64)
    leaves = [q, tables["t"], tables["h"], tables["w"]]
    got = torch.autograd.grad((mv.rel_pos_bias(q, tables["h"], tables["w"], tables["t"], geo)
                               * weight).sum(), leaves)
    want = torch.autograd.grad((brute_force_bias(q, tables, geo) * weight).sum(), leaves)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-10, atol=1e-10)


def test_the_published_geometry():
    """MViTv2-B at 32 × 224², on the meta device: q lengths 50,177 /
    12,545 / 3,137 / 785 by stage, k/v 785 in every block but the three
    transitions (3,137 in blocks 2, 5 and 21), heads of 96 throughout,
    relative-position rows 111 (stage 1), 55 (block 2, stage 2), 27 (block 5
    to block 21), 13 (blocks 22, 23) and 31 in time."""
    with torch.device("meta"):
        model = api.build_module(api.get_config("mvit_v2"))
    geo = model.geometry(model.patch_dims, torch.device("meta"))
    assert model.patch_dims == (16, 56, 56)
    assert [g.lq for g in geo] == [50177] * 2 + [12545] * 3 + [3137] * 16 + [785] * 3
    assert [g.lk for g in geo] == [3137 if i in (2, 5, 21) else 785 for i in range(24)]
    assert [b.dim_out // b.heads for b in model.plan] == [96] * 24
    assert [b.heads for b in model.plan] == [1] * 2 + [2] * 3 + [4] * 16 + [8] * 3
    rows = [blk.attn.rel_pos_h.shape[0] for blk in model.blocks]
    assert rows == [111] * 2 + [55] * 3 + [27] * 17 + [13] * 2
    assert {blk.attn.rel_pos_t.shape[0] for blk in model.blocks} == {31}
    assert [b.stride_kv for b in model.plan[:6]] == [(1, 8, 8)] * 2 + [(1, 4, 4)] * 3 + [(1, 2, 2)]


def test_the_parameter_count_is_the_published_one():
    """51.2 M published with 400 classes, plus the 2000-class head's 1600 ×
    768 + 1600 more: within 1%; and the reference's parameters are the
    module's, name for name and shape for shape, with no buffer."""
    with torch.device("meta"):
        module = api.build_module(api.get_config("mvit_v2"))
    state = module.state_dict()
    n = sum(t.numel() for t in state.values())
    assert abs(n - (51.2e6 + 1600 * 769)) <= 0.01 * (51.2e6 + 1600 * 769)
    assert n == 52_460_528
    specs = {name: shape for name, shape, *_ in ref.param_specs(published())}
    assert list(state) == list(specs)
    assert all(tuple(state[k].shape) == specs[k] for k in specs)
    assert not list(module.buffers())


def test_the_cpu_takes_the_plain_path_and_the_counters_say_so():
    """A forward on the CPU: one plain attention call a block with its
    bias, none fused or biased on the card's kernel; three pools a block;
    the bias's storage counted with its rows padded to 16 keys."""
    model = api.load_model("mvit_v2", device="cpu", **port_kwargs())
    counts = lambda: (att.fused_attention.calls, att.biased_attention.calls,  # noqa: E731
                      att.plain_attention.calls, mv.mvit_pool.calls, mv.rel_pos_bias.bytes)
    before = counts()
    model.predict_fn()(clips(8))
    got = [a - b for a, b in zip(counts(), before)]
    # fp32 [B, h, Lq, Lk padded]: [2, 1, 129, 48], [2, 2, 33, 144], [2, 2, 33, 48].
    padded = 4 * (2 * 129 * 48 + 4 * 33 * 144 + 4 * 33 * 48)
    assert got == [0, 0, 3, 9, padded]


def test_pooled_attention_takes_q_and_kv_of_other_lengths():
    """``pooled_attention`` of q [N, H, 20, D] over k, v [N, H, 7, D] with a
    bias in ``bias_storage`` equals the math written out; ``attention`` of
    a packed projection gives what ``pooled_attention`` gives its views."""
    gen = torch.Generator().manual_seed(12)
    q = torch.randn((2, 3, 20, 8), generator=gen)
    k, v = (torch.randn((2, 3, 7, 8), generator=gen) for _ in range(2))
    bias = att.bias_storage(2, 3, 20, 7, torch.float32, "cpu")
    bias.copy_(torch.randn((2, 3, 20, 7), generator=gen))
    assert bias.stride()[:-1] == (3 * 20 * 16, 20 * 16, 16)
    scores = q @ k.transpose(-2, -1) / math.sqrt(8) + bias
    torch.testing.assert_close(att.pooled_attention(q, k, v, bias), scores.softmax(-1) @ v,
                               rtol=0, atol=1e-6)
    qkv = torch.randn((2, 5, 3 * 16), generator=gen)
    packed = qkv.view(2, 5, 3, 2, 8)
    views = [packed[:, :, i].transpose(1, 2) for i in range(3)]
    want = att.pooled_attention(*views).transpose(1, 2).reshape(2, 5, 16)
    torch.testing.assert_close(att.attention(qkv, 2), want, rtol=0, atol=0)


def test_predict_takes_a_clip_and_a_batch_and_refuses_another_size():
    """``predict`` of a batch and of one of its clips give the same logits;
    a clip whose token grid is not the one the tables were sized for is
    refused."""
    model = api.load_model("mvit_v2", device="cpu", seed=4, **port_kwargs())
    assert model.takes_rgb and not model.takes_landmarks
    staged = clips(11, n=3).numpy()
    ids, logits = api.predict(model, staged)
    one_id, one = api.predict(model, staged[1])
    assert logits.shape == (3, 10) and one_id == ids[1]
    np.testing.assert_allclose(one, logits[1], rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="token grid"):
        model.module(torch.zeros((1, 4, 48, 48, 3)))


def test_the_spans_hold_both_directions(tmp_path):
    """A traced train step: ``mvit.attn`` for each of the 3 attention
    sub-layers and, inside each, ``mvit.pool`` and ``mvit.rel_pos``, once
    in the forward and once in the backward, the backward ones inside
    ``train.backward``; the recorder keeps them too."""
    from asltpu_torch.utils import profiling

    model = api.build_trainable("mvit_v2", device="cpu", **port_kwargs(drop_path_rate=0.5))
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
    outer = [e for e in events if e["name"] == mv.ATTN_SPAN]
    for name in (mv.ATTN_SPAN, mv.POOL_SPAN, mv.REL_POS_SPAN):
        ranges = [e for e in events if e["name"] == name]
        inside = [e for e in ranges if bwd["ts"] <= e["ts"] <= bwd["ts"] + bwd["dur"]]
        assert len(ranges) == 6 and len(inside) == 3, name
        assert all(any(o["ts"] <= e["ts"] and e["ts"] + e["dur"] <= o["ts"] + o["dur"]
                       for o in outer) for e in ranges), name
        assert sum(s.name == name for s in profiling.recorded_spans()) == 6
    profiling.RECORDER.clear()


def test_the_init_draws_once():
    """``init_weights`` leaves MViT to its ``reset_parameters``, one draw
    from the generator, so the two give the same tensors from one seed:
    linears, pools, tables and the cls token within ±2 std (0.04) of
    N(0, 0.02²), linear and LayerNorm shifts 0.02."""
    from asltpu_torch.models.common import init_weights

    module = api.build_module(api.get_config("mvit_v2", **port_kwargs()))
    init_weights(module, torch.Generator().manual_seed(0))
    twin = api.build_module(api.get_config("mvit_v2", **port_kwargs()))
    twin.reset_parameters(torch.Generator().manual_seed(0))
    twin_state = twin.state_dict()
    for name, t in module.state_dict().items():
        assert torch.equal(t, twin_state[name]), name
    attn = module.blocks[1].attn
    for t in (attn.qkv.weight, attn.pool_q.weight, attn.rel_pos_h, module.cls_token):
        assert 0 < float(t.abs().max()) <= 0.04
    assert float(attn.qkv.bias[0]) == float(attn.norm_q.bias[0]) == pytest.approx(0.02)


def test_the_reference_is_plain_fp32():
    """The reference turns TF32 off for its products and imports nothing of
    the program."""
    import ast

    with ref_ops.exact_fp32():
        assert not torch.backends.cuda.matmul.allow_tf32
        assert not torch.backends.cudnn.allow_tf32
    tree = ast.parse(open(ref.__file__).read())
    names = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
    names |= {n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)}
    assert not any(m.split(".")[0] in ("asltpu_torch", "asltpu", "jax") for m in names)
