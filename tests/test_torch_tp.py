"""Tensor parallelism in the port (``asltpu_torch.dist.tp``) on the CPU:
gloo ranks against the replicated head, and against the JAX package's
``make_mesh(model_parallel=2)`` step (``tests/unit/test_tp.py``'s
guarantees): the head's logits and two train steps equal the replicated
ones in fp32, the AdamW moments of sharded parameters are sharded, the
contract head in bf16 at model_parallel 4 stays within 0.05 with the
argmax-margin rule, eval counts equal, a TP checkpoint resumes bit for bit
and loads on one device. The placements (the fusion ``*_attn`` sharded,
its ``*_fc1``/``*_fc2`` whole, an ``mlp1`` outside an ``EncoderBlock``
whole) and the divisibility errors run in this process.

One launch of 2 ranks and one of 4 (``torch_dist_ranks.launch``) serve the
whole file."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

import torch_dist_ranks as R
from asltpu.config import TrainConfig as JTrainConfig
from asltpu.dist.mesh import make_mesh as jmake_mesh
from asltpu.dist.tp import tp_shard_variables
from asltpu.models.temporal import TransformerHead as JHead
from asltpu.train import loop as jloop
from asltpu_torch import ckpt as tckpt
from asltpu_torch.config import TrainConfig, get_config
from asltpu_torch.dist import make_mesh, tp_placements, tp_shard_module
from asltpu_torch.dist.mesh import Mesh
from asltpu_torch.dist.tp import validate_config_tp, validate_tp_divisibility
from asltpu_torch.train import loop
from test_torch_models import draw_variables
from test_torch_train_video import one_torch_thread  # noqa: F401  (autouse fixture)

# tests/unit/test_tp.py: logits (:47-49), the train step (:146-152), the
# contract head (:181-189).
LOGIT_ATOL, LOGIT_RTOL = 2e-5, 1e-5
STEP_RTOL = 1e-5
PARAM_ATOL, PARAM_RTOL = 2e-5, 1e-4
BF16_ATOL, MARGIN = 0.05, 0.1
LABELS = (np.arange(8) % 8).astype(np.int64)


@pytest.fixture(scope="module")
def jax_head():
    """The JAX head of the TP train step and variables drawn for it."""
    module = JHead(num_classes=8, d_model=64, num_heads=4, num_layers=2, mlp_ratio=4,
                   dropout=0.0, dtype=jnp.float32)
    return module, draw_variables(module, jnp.zeros((1, 5, 64)), seed=3)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, jax_head):
    out = str(tmp_path_factory.mktemp("tp"))
    torch.save({"head_sd": tckpt.transformer_head_state_dict(jax_head[1]["params"])},
               os.path.join(out, "inputs.pt"))
    return out, R.launch("tp", 2, out)


@pytest.fixture(scope="module")
def ranks4(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("tp4"))
    return out, R.launch("tp4", 4, out)


def result(ranks, name, rank=0):
    out, failure = ranks
    assert failure is None, failure
    return R.load(out, name, rank)


def assert_params_close(got, want):
    """Every parameter but the attention key bias, whose gradient is
    analytically zero (a constant shift of every key leaves the softmax as
    it is), so Adam normalises summation noise there (tests/unit/test_tp.py
    skips it too)."""
    for k, v in want.items():
        g = got[k]
        if k.endswith("in_proj_bias"):
            d = v.shape[0] // 3
            g, v = torch.cat([g[:d], g[2 * d:]]), torch.cat([v[:d], v[2 * d:]])
        torch.testing.assert_close(g, v, atol=PARAM_ATOL, rtol=PARAM_RTOL, msg=k)


def replicated_steps(head_sd, steps=2):
    head = R.build_head(R.HEAD)
    head.load_state_dict(head_sd)
    return R.step_result(*R.run_steps(head, TrainConfig(**R.TP_TCFG), R.head_feats(), LABELS,
                                      steps))


def test_tp_head_matches_replicated(ranks):
    head = R.build_head(dict(R.HEAD, num_classes=16))
    with torch.no_grad():
        want = head(torch.from_numpy(R.head_feats()))
    for rank in (0, 1):
        torch.testing.assert_close(result(ranks, "tp_head", rank)["logits"], want,
                                   atol=LOGIT_ATOL, rtol=LOGIT_RTOL)


def test_tp_train_steps_match_replicated_with_sharded_moments(ranks):
    """Two TP train steps (lr 1e-3 from the first, clip 1.0, label
    smoothing) walk the replicated trajectory; the moments of ``mlp1`` and
    the attention projections are each rank's half."""
    out = ranks[0]
    want = replicated_steps(torch.load(os.path.join(out, "inputs.pt"))["head_sd"])
    for rank in (0, 1):
        got = result(ranks, "tp_train", rank)
        for key in ("loss", "grad_norm"):
            assert got["metrics"][key] == pytest.approx(want["metrics"][key], rel=STEP_RTOL)
        assert_params_close(got["state"], want["state"])
        for moment in ("exp_avg", "exp_avg_sq"):
            assert_params_close(got[moment], want[moment])
        shapes = got["local_exp_avg_shapes"]
        assert shapes["layers.0.mlp1.weight"] == (128, 64)
        assert shapes["layers.0.mlp1.bias"] == (128,)
        assert shapes["layers.0.mlp2.weight"] == (64, 128)
        assert shapes["layers.0.mlp2.bias"] == (64,)
        assert shapes["layers.1.attn.in_proj_weight"] == (96, 64)
        assert shapes["layers.1.attn.out_proj.weight"] == (64, 32)
        assert shapes["fc.weight"] == (8, 64)
        assert got["local_shapes"] == shapes


def test_tp_train_steps_match_the_jax_tp_step(ranks, jax_head):
    """The port's TP step against ``asltpu``'s on ``make_mesh(model_parallel=2)``
    (4 data × 2 model virtual devices) from the same variables."""
    module, v = jax_head
    cfg = JTrainConfig(**R.TP_TCFG)
    params = jax.tree.map(jnp.asarray, v["params"])
    state = jloop.TrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats={},
                             opt_state=jloop.make_optimizer(cfg).init(params),
                             rng=jax.random.PRNGKey(0))
    mesh = jmake_mesh(model_parallel=2)
    state = tp_shard_variables(state, mesh)
    step = jloop.make_train_step(module, cfg, mesh=mesh, state_template=state)
    for _ in range(2):
        state, metrics = step(state, R.head_feats(), LABELS.astype(np.int32))
    want = tckpt.transformer_head_state_dict(jax.tree.map(np.asarray, state.params))
    got = result(ranks, "tp_train", 1)
    for key in ("loss", "grad_norm"):
        assert got["metrics"][key] == pytest.approx(float(metrics[key]), rel=STEP_RTOL)
    assert_params_close(got["state"], want)


def test_tp_contract_head_bf16_at_model_parallel_4(ranks4):
    """tests/unit/test_tp.py::test_tp_contract_head_bf16: d_model 512, 8
    heads, 4 layers, ff 2048, bf16, 4 ranks; then the same head on a
    (2 data, 2 model) mesh with the batch split and gathered."""
    head = R.build_head(R.CONTRACT)
    with torch.no_grad():
        want = head(torch.from_numpy(R.head_feats((8, 16, 512)))).float().numpy()
    got = result(ranks4, "tp_contract", 2)
    assert got["mesh"] == {"data": 2, "model": 2}
    for logits in (got["mp4"].numpy(), got["dp_tp"].numpy()):
        np.testing.assert_allclose(logits, want, atol=BF16_ATOL)
        for row in range(want.shape[0]):
            if logits[row].argmax() != want[row].argmax():
                top2 = np.sort(want[row])[-2:]
                assert top2[1] - top2[0] < MARGIN, row


def test_tp_eval_matches_replicated(ranks):
    head = R.build_head(dict(R.HEAD, num_layers=1))
    state = loop.create_train_state(head, TrainConfig(**R.TP_TCFG))
    t1, t5 = loop.make_eval_step()(state, R.head_feats(), R.EVAL_LABELS)
    for rank in (0, 1):
        got = result(ranks, "tp_eval", rank)
        assert (got["top1"], got["top5"]) == (int(t1), int(t5))
        assert got["top5"] <= 6


def test_tp_checkpoint_resumes_bit_for_bit_and_loads_on_one_device(ranks):
    """tests/unit/test_tp.py::test_tp_state_checkpoint_roundtrip: a TP run
    cut after its step-1 checkpoint and resumed equals the uninterrupted
    TP run bit for bit; the checkpoint holds the single-device layout, and
    one device resumes from it onto the TP trajectory (fp32 tolerance)."""
    out = ranks[0]
    for rank in (0, 1):
        got = result(ranks, "tp_ckpt", rank)
        assert got["steps"] == (2, 2)
        for part in ("state", "exp_avg", "exp_avg_sq"):
            for k, v in got["ref"][part].items():
                assert torch.equal(got["resumed"][part][k], v), (part, k)
    ck = os.path.join(out, "tp_ck")
    assert tckpt.load_trained_state_dict(ck)["layers.0.mlp1.weight"].shape == (256, 64)
    tcfg = TrainConfig(**{**R.TP_TCFG, "ckpt_dir": ck})
    state = tckpt.try_restore_train_state(
        ck, loop.create_train_state(R.build_head(dict(R.HEAD, num_layers=1)), tcfg))
    assert state.step == 1
    state, _ = loop.make_train_step(tcfg)(state, R.head_feats(), LABELS)
    assert_params_close(state.module.state_dict(),
                        result(ranks, "tp_ckpt", 0)["ref"]["state"])


def test_fusion_cross_attention_shards_by_heads_and_keeps_its_mlp_whole(ranks):
    """The fusion block's ``*_attn`` shard (q, k, v rows of this rank's
    heads; ``out_proj`` columns), its ``*_fc1``/``*_fc2`` stay whole, and
    the sharded block computes the whole block's outputs and input
    gradients."""
    from asltpu_torch.models.common import init_weights
    from asltpu_torch.models.fusion import CrossAttentionBlock

    placed = tp_placements(R.build("two_stream", R.FUSION).module)
    for name in ("a_from_b_attn", "b_from_a_attn"):
        assert placed[f"fusion.0.{name}.in_proj_weight"] == 0
        assert placed[f"fusion.0.{name}.in_proj_bias"] == 0
        assert placed[f"fusion.0.{name}.out_proj.weight"] == 1
        assert placed[f"fusion.0.{name}.out_proj.bias"] is None
    assert {k for k, d in placed.items() if d is not None} == {
        f"fusion.0.{n}_attn.{p}" for n in ("a_from_b", "b_from_a")
        for p in ("in_proj_weight", "in_proj_bias", "out_proj.weight")}
    assert all(placed[f"fusion.0.{s}_mlp_{fc}.{w}"] is None for s in "ab"
               for fc in ("fc1", "fc2") for w in ("weight", "bias"))

    block = CrossAttentionBlock(32, 4, dropout=0.0)
    init_weights(block, torch.Generator().manual_seed(0))
    a = torch.from_numpy(R.head_feats((2, 4, 32), 5)).requires_grad_()
    b = torch.from_numpy(R.head_feats((2, 3, 32), 6)).requires_grad_()
    ya, yb = block(a, b)
    (ya.square().sum() + yb.sum()).backward()
    got = result(ranks, "tp_fusion", 1)
    assert got["shapes"]["a_from_b_attn.in_proj_weight"] == (48, 32)
    assert got["shapes"]["a_mlp_fc1.weight"] == (128, 32)
    for g, w in zip(got["out"] + got["grads"], (ya, yb, a.grad, b.grad)):
        torch.testing.assert_close(g, w.detach(), atol=LOGIT_ATOL, rtol=LOGIT_RTOL)


def test_an_mlp_outside_an_encoder_block_stays_whole():
    """The placements match an encoder block's ``mlp1``/``mlp2``, not any
    submodule of that name (``asltpu/dist/tp.py:78`` matches by name
    alone)."""
    class Other(nn.Module):
        def __init__(self):
            super().__init__()
            self.mlp1 = nn.Linear(8, 32)
            self.mlp2 = nn.Linear(32, 8)
            self.attn = nn.MultiheadAttention(8, 2, batch_first=True)

    head = R.build_head(dict(R.HEAD, num_layers=1))
    head.extra = Other()
    placed = tp_placements(head)
    assert placed["layers.0.mlp1.weight"] == 0 and placed["layers.0.mlp2.weight"] == 1
    assert all(d is None for k, d in placed.items() if k.startswith("extra."))


def test_divisibility_errors():
    """tests/unit/test_tp.py::test_tp_divisibility_validation, the messages
    of ``asltpu/dist/tp.py:290-304`` and ``asltpu/dist/mesh.py:62-66``."""
    validate_tp_divisibility(8, 512, 4, 4)
    with pytest.raises(ValueError, match="num_heads=6 not divisible by model_parallel=4"):
        validate_tp_divisibility(6, 512, 4, 4)
    with pytest.raises(ValueError, match="mlp width 30 not divisible by model_parallel=4"):
        validate_tp_divisibility(4, 10, 3, 4)
    with pytest.raises(ValueError, match="devices not divisible by model_parallel=3"):
        make_mesh(model_parallel=3)
    with pytest.raises(ValueError, match="num_heads=4 not divisible by model_parallel=8"):
        tp_shard_module(R.build_head(R.HEAD), Mesh(model_size=8))
    validate_config_tp(get_config("resnet_transformer"), 4)
    with pytest.raises(ValueError, match="num_heads=8 not divisible by model_parallel=3"):
        validate_config_tp(get_config("resnet_transformer"), 3)
    validate_config_tp(get_config("mobilenet_gru"), 3)  # nothing to shard


def test_one_rank_mesh_is_the_identity():
    from asltpu_torch.dist import gather_batch, replicate, shard_batch

    mesh = make_mesh()
    assert mesh.shape == {"data": 1, "model": 1}
    x = torch.arange(6.0).reshape(3, 2)
    assert shard_batch(mesh, x) is x and gather_batch(mesh, x) is x
    head = R.build_head(R.HEAD)
    assert tp_shard_module(head, mesh) is head and replicate(head, mesh) is head
    assert head.layers[0].mlp1.weight.shape == (256, 64)
