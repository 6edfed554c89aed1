"""Video Swin (``video_swin``, the port's own family: the JAX package has
none) on the CPU at a small size — width 32, heads of 16, depths (2, 2)
over two stages, window 4×4×4 shifted by 2, patch 2×4×4, 10 classes,
fp32 — against the plain reference ``perfbench/reference/video_swin.py``,
which follows the published ``swin_transformer.py`` and shares no code
with the port: the logits at three clip sizes (whole windows; a stage
clipped in time and padded in space; odd sizes that pad the patch
embedding and the merging), one train step with stochastic depth and
dropout, the shift mask and the relative-position index, patch merging,
a clipped window, the weights by name, the counted matmul operations, the
counters and the spans."""

import json
import os

import numpy as np
import pytest
import torch

from asltpu_torch import api
from asltpu_torch.config import TrainConfig
from asltpu_torch.models import video_swin as vs
from asltpu_torch.ops import attention as att
from asltpu_torch.train import loop
from perfbench.core import weights
from perfbench.reference import ops as ref_ops
from perfbench.reference import video_swin as ref

SIZES = dict(num_classes=10, patch_size=(2, 4, 4), embed_dim=32, depths=(2, 2),
             num_heads=(2, 4), window_size=(4, 4, 4), mlp_ratio=4)
# Clip sizes (frames, crop): stage sizes (D, H, W) in the comments.
CLIPS = {
    # (4, 8, 8) then (4, 4, 4): whole windows; stage 2 clipped to itself.
    "whole": (8, 32),
    # (2, 10, 10) then (2, 5, 5): the window clipped to 2 frames (N = 32,
    # the index sliced), unshifted in time; space padded to 12, then to 8.
    "clipped": (4, 40),
    # (3, 5, 5) then (3, 3, 3): a frame padded in the patch embedding, the
    # merging padded to 6; stage 2 clipped to itself.
    "odd": (5, 20),
}
TRAIN = dict(learning_rate=1e-3, warmup_steps=1, num_steps=10, weight_decay=1e-4,
             label_smoothing=0.1, grad_clip_norm=1.0)
# fp32 on both sides; the port and the reference sum in other orders
# (F.linear over the windows against the reference's reshaped products, the
# bias added inside the scaled product against after it, the LayerNorm of
# a copy laid out otherwise), a few ulps of the largest value: 1e-5 of it
# leaves room for ~80 ulps.
REL = 1e-5


def ref_config(clip: str = "whole", drop_path_rate: float = 0.1,
               dropout: float = 0.5) -> dict:
    frames, crop = CLIPS[clip]
    pp = dict(num_frames=frames, staging_size=[crop + 8] * 2, resize_short=crop + 8, crop=crop,
              mean=[0.485, 0.456, 0.406], std=[0.229, 0.224, 0.225])
    return dict(SIZES, num_frames=frames, drop_path_rate=drop_path_rate, dropout=dropout,
                preprocess=pp)


def port_kwargs(clip: str = "whole", drop_path_rate: float = 0.1, dropout: float = 0.5) -> dict:
    frames, crop = CLIPS[clip]
    pp = dict(num_frames=frames, staging_size=(crop + 8, crop + 8), resize_short=crop + 8,
              crop=crop, out_dtype="float32")
    return dict(SIZES, num_frames=frames, drop_path_rate=drop_path_rate, dropout=dropout,
                compute_dtype="float32", preprocess=pp)


def params(seed: int, cfg: dict) -> dict:
    return weights.make_params(ref.param_specs(cfg), seed, torch.device("cpu"))


def clips(seed: int, clip: str = "whole", n: int = 2) -> torch.Tensor:
    frames, crop = CLIPS[clip]
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, 256, (n, frames, crop + 8, crop + 8, 3), np.uint8))


@pytest.mark.parametrize("clip", sorted(CLIPS))
def test_fp32_logits_match_the_reference(clip):
    cfg = ref_config(clip)
    p = params(1, cfg)
    model = api.load_model("video_swin", device="cpu", **port_kwargs(clip))
    weights.load_into(model.module, p)
    x = clips(2, clip)
    got = model.predict_fn()(x)
    want = ref.forward(x, p, cfg)
    assert got.shape == want.shape == (2, 10) and got.dtype == torch.float32
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= REL * scale
    # The two clips' logits differ far beyond the agreement.
    assert float((want[0] - want[1]).abs().max()) > 1e3 * REL * scale


def test_a_train_step_with_stochastic_depth_matches_the_reference():
    """Rate 0.5 (each block past the first draws masks that drop) and the
    head's dropout 0.5, batch 4, the clipped clip size: the loss, every
    leaf's clipped gradient and every leaf's change of one
    ``make_train_step`` step against ``Trainer.step`` from the same weights
    and generator seed; afterwards both generators stand at the same
    place."""
    rate, seed, clip = 0.5, 21, "clipped"
    cfg = ref_config(clip, rate)
    p = params(3, cfg)
    masks = ref.draws(cfg, 4, torch.Generator().manual_seed(seed), "cpu")
    assert any(not bool(m.all()) for blk in masks for m in blk if m is not None)
    model = api.build_trainable("video_swin", device="cpu", **port_kwargs(clip, rate))
    weights.load_into(model.module, p)
    tcfg = TrainConfig(batch_size=4, **TRAIN)
    state = loop.create_train_state(model.module, tcfg, seed=seed)
    x, labels = clips(4, clip, n=4), torch.tensor([1, 7, 3, 3])
    state, metrics = loop.make_train_step(tcfg, model.cfg.preprocess)(state, x, labels)
    trainer = ref.Trainer(p, cfg, TRAIN, seed)
    want_loss, want_grads = trainer.step(x, labels)
    assert float(metrics["loss"]) == pytest.approx(want_loss, rel=REL)
    named = dict(model.module.named_parameters())
    assert sorted(named) == sorted(want_grads)
    for name, g in want_grads.items():
        err = float((named[name].grad - g).norm())
        assert err <= REL * float(g.norm()) + 1e-9, name
        # AdamW's first step moves every leaf by about the learning rate:
        # the same rounding of the gradient, relative to the change.
        change, want_change = named[name].detach() - p[name], trainer.params[name].detach() - p[name]
        assert float((change - want_change).norm()) <= 1e-4 * float(want_change.norm()) + 1e-9, name
    assert torch.equal(torch.rand(8, generator=state.generator),
                       torch.rand(8, generator=trainer.gen))


@pytest.mark.parametrize("size,window,shift", [
    ((8, 8, 8), (4, 4, 4), (2, 2, 2)),
    ((16, 56, 56), (8, 7, 7), (4, 3, 3)),
    ((16, 7, 7), (8, 7, 7), (4, 0, 0)),  # the cell's last stage
    ((2, 12, 12), (2, 4, 4), (0, 2, 2)),
])
def test_the_shift_mask_is_the_published_construction(size, window, shift):
    got = vs.shift_mask(size, window, shift, "cpu", torch.float32)
    want = ref.compute_mask(*size, window, shift, "cpu")
    assert got.shape == want.shape and torch.equal(got, want)


@pytest.mark.parametrize("window", [(4, 4, 4), (8, 7, 7), (2, 3, 5)])
def test_the_relative_position_index_is_the_published_construction(window):
    got = vs.relative_position_index(window, "cpu")
    assert torch.equal(got, ref.relative_position_index(window, "cpu"))
    assert int(got.min()) == 0 and int(got.max()) == ref.table_rows(window) - 1


def test_patch_merging_takes_the_neighbours_in_the_published_order():
    """An odd side (padded) and the order (0, 0), (1, 0), (0, 1), (1, 1) of
    the published ``PatchMerging``: equal to the reference's, where the
    (1, 0) and (0, 1) neighbours swapped would differ by the output's own
    size."""
    cfg = ref_config()
    p = params(4, cfg)
    module = vs.PatchMerging(SIZES["embed_dim"])
    weights.load_into(module, {k[len("layers.0.downsample."):]: v for k, v in p.items()
                               if k.startswith("layers.0.downsample.")})
    x = torch.randn((2, 3, 5, 6, SIZES["embed_dim"]), generator=torch.Generator().manual_seed(5))
    got = module(x)
    want = ref.patch_merging(x, p, "layers.0.downsample", "fp32")
    assert got.shape == want.shape == (2, 3, 3, 3, 2 * SIZES["embed_dim"])
    torch.testing.assert_close(got, want, rtol=0, atol=REL * float(want.abs().max()))
    x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, 1))
    parts = [x[:, :, 0::2, 0::2], x[:, :, 0::2, 1::2], x[:, :, 1::2, 0::2], x[:, :, 1::2, 1::2]]
    swapped = vs.linear(vs.layer_norm(torch.cat(parts, -1), module.norm), module.reduction)
    assert float((swapped - want).abs().max()) > 0.1 * float(want.abs().max())


def test_a_clipped_window_takes_the_first_positions_of_the_index():
    """A stage of (2, 5, 5) under a 4×4×4 window: the window is clipped to
    2 frames (N = 32) and unshifted in time, the index is the full
    window's sliced [:32, :32], as the published code slices it; one
    shifted block's window sub-layer (norm, pad, roll, mask, attention)
    equals the reference's ``forward_part1``."""
    cfg = ref_config("clipped")
    p = params(6, cfg)
    model = api.build_module(api.get_config("video_swin", **port_kwargs("clipped")))
    weights.load_into(model, p)
    plain, shifted = model.geometry((2, 5, 5), torch.device("cpu"), torch.float32)
    assert plain.window == shifted.window == (2, 4, 4) and shifted.shift == (0, 2, 2)
    assert plain.mask is None and shifted.mask.shape == (2 * 2, 32, 32)
    full = ref.relative_position_index((4, 4, 4), "cpu")
    assert torch.equal(shifted.index, full[:32, :32].reshape(-1))
    blk, dim = model.layers[1].blocks[1], 2 * SIZES["embed_dim"]
    x = torch.randn((2, 2, 5, 5, dim), generator=torch.Generator().manual_seed(7))
    got = vs.window_attention(blk.attn, vs.layer_norm(x, blk.norm1), shifted)
    mask = ref.compute_mask(2, 8, 8, (2, 4, 4), (0, 2, 2), "cpu")
    want = ref.forward_part1(x, mask, p, "layers.1.blocks.1", 4, (4, 4, 4), (2, 2, 2), "fp32")
    torch.testing.assert_close(got, want, rtol=0, atol=REL * float(want.abs().max()))


def test_the_weights_load_by_the_references_names():
    """The module's leaves are the reference's parameters, name for name
    and shape for shape, in the published names, with no buffer: the
    index and the masks are not state."""
    cfg = dict(ref_config(), **{k: v for k, v in api.get_config("video_swin").__dict__.items()
                                if k in ("depths", "num_heads", "window_size", "embed_dim",
                                         "patch_size", "num_classes")})
    module = api.build_module(api.get_config("video_swin"))
    specs = {n: s for n, s, *_ in ref.param_specs(cfg)}
    state = module.state_dict()
    assert list(state) == list(specs)
    assert all(tuple(state[n].shape) == specs[n] for n in specs)
    assert not list(module.buffers())
    assert state["layers.2.blocks.17.attn.relative_position_bias_table"].shape == (2535, 16)
    assert "layers.3.downsample.reduction.weight" not in state
    assert state["layers.0.downsample.reduction.weight"].shape == (256, 512)
    assert sum(t.numel() for t in state.values()) == 89_688_984


def test_the_counted_window_flops_are_the_references():
    """``window_attn_flops`` against torch's count of the reference's window
    sub-layers (``forward_part1``: q/k/v, q·kᵀ, P·v, proj), forward and
    backward, on the meta device, every block of every stage, at the
    clipped and padded size."""
    from torch.utils.flop_counter import FlopCounterMode

    cfg, batch = ref_config("clipped"), 3
    p = {n: torch.zeros(s, device="meta", requires_grad=True)
         for n, s, *_ in ref.param_specs(cfg)}
    counter = FlopCounterMode(display=False)
    window = tuple(cfg["window_size"])
    with counter:
        for i, ((dim, depth, heads), size) in enumerate(zip(ref.stages(cfg),
                                                            ref.stage_sizes(cfg))):
            for j in range(depth):
                shift = (0, 0, 0) if j % 2 == 0 else tuple(k // 2 for k in window)
                clipped, clipped_shift = ref.get_window_size(size, window, shift)
                padded = [-(-s // k) * k for s, k in zip(size, clipped)]
                mask = ref.compute_mask(*padded, clipped, clipped_shift, "meta")
                x = torch.zeros((batch, *size, dim), device="meta", requires_grad=True)
                y = ref.forward_part1(x, mask, p, f"layers.{i}.blocks.{j}", heads, window, shift,
                                      "fp32")
                name = f"layers.{i}.blocks.{j}.attn"
                torch.autograd.grad(y.sum(), [x] + [p[f"{name}.{n}"] for n in
                                                    ("qkv.weight", "qkv.bias", "proj.weight",
                                                     "proj.bias")])
    assert ref.window_attn_flops(cfg, batch) == counter.get_total_flops()


def test_the_cpu_takes_the_plain_path_and_the_counters_say_so():
    """A forward on the CPU: one plain attention call a block with its bias,
    none fused, none biased on the card's kernel; the windows attended
    counted (stage 1: 2 clips × 4 windows, 2 blocks; stage 2: 2 × 1, 2
    blocks); the one shift mask built on the first forward and none on
    the second."""
    model = api.load_model("video_swin", device="cpu", **port_kwargs())
    counts = lambda: (att.fused_attention.calls, att.biased_attention.calls,  # noqa: E731
                      att.plain_attention.calls, vs.window_attention.windows,
                      vs.shift_mask.builds)
    before = counts()
    model.predict_fn()(clips(8))
    first = counts()
    model.predict_fn()(clips(9))
    second = counts()
    assert [a - b for a, b in zip(first, before)] == [0, 0, 4, 2 * 4 * 2 + 2 * 1 * 2, 1]
    assert [a - b for a, b in zip(second, first)] == [0, 0, 4, 20, 0]


@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("windows", [1, 3])
def test_a_bias_broadcasts_over_the_groups_and_keeps_its_rows_aligned(windows, groups):
    """``attention`` with a bias [W, H, L, L] over N = G·W group-major
    sequences equals the plain math with each sequence's window bias; the
    laid-out bias holds each sequence's window bias, its last axis
    contiguous and each row at a multiple of 16 elements, as the card's
    kernel reads it, though the bias given has its heads innermost (as the
    model's gathered bias plus the mask has them) and one group makes the
    repeat a view."""
    gen = torch.Generator().manual_seed(10)
    n, length, heads, hd = groups * windows, 20, 2, 8
    qkv = torch.randn((n, length, 3 * heads * hd), generator=gen)
    bias = torch.randn((windows, length, length, heads), generator=gen).permute(0, 3, 1, 2)
    got = att.attention(qkv, heads, bias)
    packed = qkv.view(n, length, 3, heads, hd)
    for s in range(n):
        q, k, v = (packed[s:s + 1, :, i].transpose(1, 2) for i in range(3))
        scores = (q @ k.transpose(-2, -1)) / hd ** 0.5 + bias[s % windows]
        want = (scores.softmax(-1) @ v).transpose(1, 2).reshape(1, length, heads * hd)
        torch.testing.assert_close(got[s:s + 1], want, rtol=0, atol=1e-5)
    laid = att.per_sequence(bias, n)
    assert torch.equal(laid, bias.repeat(groups, 1, 1, 1))
    assert laid.stride(-1) == 1 and all(st % 16 == 0 for st in laid.stride()[:-1])


def test_predict_takes_a_clip_and_a_batch():
    """``predict`` of a batch and of one of its clips give the same logits:
    fp32, where a product's other batch size changes its sums by ulps."""
    model = api.load_model("video_swin", device="cpu", seed=4, **port_kwargs("odd"))
    assert model.takes_rgb and not model.takes_landmarks
    staged = clips(11, "odd", n=3).numpy()
    ids, logits = api.predict(model, staged)
    one_id, one = api.predict(model, staged[1])
    assert logits.shape == (3, 10) and one_id == ids[1]
    np.testing.assert_allclose(one, logits[1], rtol=0, atol=1e-5)


def test_the_spans_hold_both_directions(tmp_path):
    """A traced train step at the whole size: ``swin.window_attn`` for the
    3 unshifted sub-layers (stage 2's shifted block is clipped to no
    shift), ``swin.shifted_attn`` for the 1 shifted one and ``swin.merge``
    for the merging, each once in the forward and once in the backward,
    the backward ones inside ``train.backward``; the recorder keeps them
    too."""
    from asltpu_torch.utils import profiling

    model = api.build_trainable("video_swin", device="cpu", **port_kwargs(drop_path_rate=0.5))
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
    for name, per_pass in ((vs.WINDOW_SPAN, 3), (vs.SHIFTED_SPAN, 1), (vs.MERGE_SPAN, 1)):
        ranges = [e for e in events if e["name"] == name]
        inside = [e for e in ranges if bwd["ts"] <= e["ts"] <= bwd["ts"] + bwd["dur"]]
        assert len(ranges) == 2 * per_pass and len(inside) == per_pass, name
        assert sum(s.name == name for s in profiling.recorded_spans()) == 2 * per_pass
    profiling.RECORDER.clear()


def test_the_init_draws_once():
    """``init_weights`` leaves Video Swin to its ``reset_parameters``, one
    draw from the generator, so the two give the same tensors from one
    seed: linears and bias tables within ±2 std (0.04) of N(0, 0.02²)."""
    from asltpu_torch.models.common import init_weights

    module = api.build_module(api.get_config("video_swin", **port_kwargs()))
    init_weights(module, torch.Generator().manual_seed(0))
    twin = api.build_module(api.get_config("video_swin", **port_kwargs()))
    twin.reset_parameters(torch.Generator().manual_seed(0))
    twin_state = twin.state_dict()
    for name, t in module.state_dict().items():
        assert torch.equal(t, twin_state[name]), name
    blk = module.layers[0].blocks[0]
    for t in (blk.attn.qkv.weight, blk.attn.relative_position_bias_table):
        assert 0 < float(t.abs().max()) <= 0.04


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
