"""Data parallelism in the port (``asltpu_torch.dist``, the ``mesh``
argument of ``asltpu_torch.train.loop``) on the CPU: two gloo ranks
against the single-process step, and against the JAX package's DP step on
the 8-device virtual mesh (``tests/conftest.py``).

The two rank processes are launched once for the whole file
(``torch_dist_ranks.launch``, 120 s at most); each scenario's result comes
back through a file. The guarantees are the JAX package's
(``tests/unit/test_train.py``): a DP step is the single-device step, the
BatchNorm statistics of the global batch included; so are a tuple batch,
dropout and augmentation (drawn for the global batch), the eval counts of
a padded batch and a checkpointed run."""

import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_ranks as R
from asltpu import ckpt as jckpt
from asltpu import config as jconfig
from asltpu.api import build_module as jbuild
from asltpu.dist.mesh import make_mesh as jmake_mesh
from asltpu.dist.mesh import replicated_sharding, shard_batch as jshard_batch
from asltpu.train import loop as jloop
from asltpu_torch import ckpt as tckpt
from asltpu_torch.ops.augment import AugmentConfig
from asltpu_torch.ops.preprocess import preprocess_clip
from test_torch_models import draw_variables
from test_torch_train_video import one_torch_thread  # noqa: F401  (autouse fixture)

STEP_RTOL = 1e-5  # tests/unit/test_train.py:52: the DP loss, fp32
PARAM_ATOL = 1e-5  # :55
BN_ATOL = 1e-4  # :93-95: running statistics; per-rank ones are O(0.1) off
PER_RANK_MIN = 1e-2  # what per-rank statistics must miss the global ones by
# The gradient (Adam's first moment over 0.1) of a DP step against the
# single step: the same sums in another order, in fp32. Only where no
# training BatchNorm amplifies rounding: at these sizes the deepest ones see
# 16 values a channel, and the fp32 gradient of the BatchNorm case lies 3.8%
# from its fp64 one (single process) and 3.3% (DP): no fp32 bound between
# the two holds a fault apart from rounding. Their losses are held instead,
# the BatchNorm case's to the fp64 loss (the single fp32 step lies 7.8e-6
# from it, relative; the DP step 2.2e-6).
GRAD_REL = 1e-5


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("dp"))
    return out, R.launch("dp", 2, out)


def result(ranks, name, rank=0):
    out, failure = ranks
    assert failure is None, failure
    return R.load(out, name, rank)


def single(name, over, batch_in, labels, steps, pp=True, augment=None, tcfg=None):
    m = R.build(name, over)
    return R.step_result(*R.run_steps(m.module, tcfg or R.train_config(), batch_in, labels,
                                      steps, m.cfg.preprocess if pp else None,
                                      augment=augment))


def global_rel(a, b) -> float:
    num = sum(float(((a[k].double() - b[k].double()) ** 2).sum()) for k in b)
    return (num / sum(float((b[k].double() ** 2).sum()) for k in b)) ** 0.5


def assert_same_step(got, want, grads=True):
    assert got["metrics"]["loss"] == pytest.approx(want["metrics"]["loss"], rel=STEP_RTOL)
    assert got["metrics"]["top1"] == want["metrics"]["top1"]
    if grads:
        assert global_rel(got["exp_avg"], want["exp_avg"]) < GRAD_REL


def fp64_loss(name, over, batch_in, labels) -> float:
    """The single-process training forward's loss in fp64 throughout (the
    preprocessed clip as the fp32 step sees it, widened)."""
    from asltpu_torch.train import loop

    m = R.build(name, dict(over, compute_dtype="float64"))
    m.module.double()
    clip = preprocess_clip(torch.from_numpy(batch_in), m.cfg.preprocess).double()
    with torch.no_grad():
        logits = m.module(clip, train=True)
    return float(loop.softmax_ce(logits, torch.from_numpy(labels),
                                 R.train_config().label_smoothing))


def test_dp_pose_step_equals_single(ranks):
    """tests/unit/test_train.py::test_dp_matches_single_device: loss, every
    parameter, and the gradient behind them."""
    want = single("pose_bilstm", R.POSE, *R.pose_batch(), 1, pp=False)
    for rank in (0, 1):
        got = result(ranks, "dp_pose", rank)
        assert_same_step(got, want)
        for k, v in want["state"].items():
            torch.testing.assert_close(got["state"][k], v, rtol=0, atol=PARAM_ATOL, msg=k)


def test_dp_batchnorm_statistics_are_the_global_batchs(ranks):
    """tests/unit/test_train.py::test_dp_matches_single_device_with_batchnorm,
    and the control: the same step on each rank's own rows with their own
    statistics misses the single step's running statistics by over 1e-2."""
    frames, labels = R.bn_batch()
    want = single("mobilenet_gru", R.BN, frames, labels, 1)
    loss64 = fp64_loss("mobilenet_gru", R.BN, frames, labels)
    stats = [k for k in want["state"] if k.endswith(("running_mean", "running_var"))]
    assert len(stats) == 2 * 52
    for rank in (0, 1):
        got = result(ranks, "dp_bn", rank)
        assert got["metrics"]["loss"] == pytest.approx(loss64, rel=STEP_RTOL)
        assert got["metrics"]["top1"] == want["metrics"]["top1"]
        for k in stats:
            torch.testing.assert_close(got["state"][k], want["state"][k], rtol=0, atol=BN_ATOL,
                                       msg=k)
        miss = max(float((got["per_rank_state"][k] - want["state"][k]).abs().max())
                   for k in stats)
        assert miss > PER_RANK_MIN, miss


def test_dp_tuple_batch_two_stream(ranks):
    """tests/unit/test_train.py::test_multi_input_dp_matches_single_device:
    2 steps of ``two_stream`` on ``((clip, landmarks), labels)``; loss rtol
    1e-4, every parameter within the sign-flip bound (2·lr) and under 0.5%
    of them past 1e-4."""
    want = single("two_stream", R.FUSION, *R.fusion_batch(), 2, pp=False)
    got = result(ranks, "dp_fusion", 1)
    assert got["metrics"]["loss"] == pytest.approx(want["metrics"]["loss"], rel=1e-4)
    bound = 2.0 * R.train_config().learning_rate
    total = drifted = 0
    for k, v in want["state"].items():
        if not v.is_floating_point():
            continue
        delta = (got["state"][k] - v).abs()
        assert float(delta.max()) <= bound, k
        total += delta.numel()
        drifted += int((delta > 1e-4).sum())
    assert drifted / total < 0.005, (drifted, total)


def test_dp_dropout_and_augment_equal_single(ranks):
    """Dropout 0.1 and augmentation under DP: every rank draws the global
    batch's masks and crops and keeps its rows, so two steps equal the
    single process's (its loss with dropout moves by far more than 1e-5 when
    a mask differs)."""
    frames, labels = R.bn_batch(R.DROPOUT)
    want = single("mobilenet_gru", R.DROPOUT, frames, labels, 2, augment=AugmentConfig())
    for rank in (0, 1):
        assert_same_step(result(ranks, "dp_dropout", rank), want, grads=False)
    other = single("mobilenet_gru", R.DROPOUT, frames, labels, 2,
                   augment=AugmentConfig(), tcfg=R.train_config(seed=1))
    assert abs(other["metrics"]["loss"] - want["metrics"]["loss"]) > 1e-3


def test_dp_eval_counts_a_padded_batch_as_one_device(ranks):
    """The eval step under DP on a batch whose last two rows are pads
    (label −1): the single process's counts on every rank, and train()'s
    eval reports them on rank 0 alone (rank 0 writes the metrics)."""
    from asltpu_torch.train import loop

    m = R.build("pose_bilstm", R.POSE)
    state = loop.create_train_state(m.module, R.train_config())
    lm, _ = R.pose_batch()
    t1, t5 = loop.make_eval_step()(state, lm, R.EVAL_LABELS)
    for rank in (0, 1):
        got = result(ranks, "dp_eval", rank)
        assert (got["top1"], got["top5"]) == (int(t1), int(t5))
        assert got["top5"] <= 6
    evals = result(ranks, "dp_eval", 0)["train_evals"]
    assert len(evals) == 1 and evals[0]["eval_clips"] == 6.0
    assert result(ranks, "dp_eval", 1)["train_evals"] == []


def test_dp_checkpoint_resume_is_the_uninterrupted_run(ranks):
    """train() in the default mesh from rank-dependent weights (so rank 0's
    must be broadcast): 4 steps with dropout, against a run cut at step 3
    and resumed from the step-2 checkpoint that rank 0 wrote: bit for bit,
    on both ranks, which hold the same weights."""
    out = ranks[0]
    got = [result(ranks, "dp_ckpt", r) for r in (0, 1)]
    for g in got:
        assert g["steps"] == (4, 4)
        assert torch.equal(*g["generator"])
        for k, v in g["whole"].items():
            assert torch.equal(g["cut"][k], v), k
            assert torch.equal(got[0]["whole"][k], v), k
    assert sorted(os.listdir(os.path.join(out, "dp_cut"))) == ["2", "4"]
    assert tckpt.load_trained_state_dict(os.path.join(out, "dp_cut")).keys() == (
        got[0]["whole"].keys())


def _jax_dp(name, over, port_module, batch_in, labels, dummy):
    """The JAX package's DP step (8 virtual devices, batch sharded over
    ``data``) from the port module's weights (its ``state_dict`` through
    ``asltpu.ckpt.load_torch_checkpoint``)."""
    jcfg = jconfig.get_config(name, **over)
    module = jbuild(jcfg)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "port.pt")
        torch.save(port_module.state_dict(), path)
        v = jckpt.load_torch_checkpoint(path, draw_variables(module, *dummy), jcfg)
    tcfg = jconfig.TrainConfig(**R.TCFG)
    state = jloop.TrainState(step=jnp.zeros((), jnp.int32), params=v["params"],
                             batch_stats=v.get("batch_stats", {}),
                             opt_state=jloop.make_optimizer(tcfg).init(v["params"]),
                             rng=jax.random.PRNGKey(0))
    mesh = jmake_mesh()
    state = jax.device_put(state, replicated_sharding(mesh))
    b, y = jshard_batch(mesh, (batch_in, labels.astype(np.int32)))
    state, metrics = jloop.make_train_step(module, tcfg, mesh=mesh)(state, b, y)
    sd = tckpt.state_dict_from_jax(R.build(name, over).cfg, jax.tree.map(
        np.asarray, {"params": state.params, "batch_stats": state.batch_stats}))
    return {k: float(x) for k, x in metrics.items()}, sd


def test_dp_pose_matches_the_jax_dp_step(ranks):
    """The port's 2-rank DP step against the JAX package's DP step on 8
    virtual devices, from the same weights: loss and grad_norm, and the
    parameters."""
    got = result(ranks, "dp_pose", 0)
    lm, labels = R.pose_batch()
    metrics, sd = _jax_dp("pose_bilstm", R.POSE, R.build("pose_bilstm", R.POSE).module,
                          lm, labels, (jnp.zeros((1, 6, 543, 3)),))
    assert got["metrics"]["loss"] == pytest.approx(metrics["loss"], rel=STEP_RTOL)
    assert got["metrics"]["grad_norm"] == pytest.approx(metrics["grad_norm"], rel=STEP_RTOL)
    for k, v in sd.items():
        if k.startswith("lstm.bias"):
            continue  # one bias per gate in JAX, the sum of the port's two
        torch.testing.assert_close(got["state"][k], v, rtol=0, atol=PARAM_ATOL, msg=k)


def test_dp_batchnorm_matches_the_jax_dp_step(ranks):
    """The BatchNorm case against the JAX DP step, JAX fed the port's
    preprocessed clip (the packages' preprocess agree to one bf16 ulp,
    which training BatchNorm amplifies): loss and every running statistic."""
    got = result(ranks, "dp_bn", 0)
    frames, labels = R.bn_batch()
    m = R.build("mobilenet_gru", R.BN)
    clip = preprocess_clip(torch.from_numpy(frames), m.cfg.preprocess).float().numpy()
    metrics, sd = _jax_dp("mobilenet_gru", R.BN, m.module, clip, labels,
                          (jnp.zeros((1, 2, 32, 32, 3)),))
    assert got["metrics"]["loss"] == pytest.approx(metrics["loss"], rel=STEP_RTOL)
    stats = [k for k in sd if k.endswith(("running_mean", "running_var"))]
    assert len(stats) == 2 * 52
    for k in stats:
        torch.testing.assert_close(got["state"][k], sd[k], rtol=0, atol=BN_ATOL, msg=k)
