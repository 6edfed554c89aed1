"""The I3D train step in the port against the JAX package's on the CPU, at
the size of ``tests/test_torch_i3d.py`` (16 frames of 40×48 staged, crop
32, 7 classes), batch 8 (``TrainConfig``'s), dropout 0, remat on, through
preprocess, from the same variables (``draw_variables``) and the same
uint8 batch; then BatchNorm's training semantics, remat and dropout.

The step is the first of a warmup, so its lr is 0: the parameters must
come out unchanged (weight decay is scaled by the lr), while the running
statistics and the Adam moments (0.1 × the gradient) move. At this size
the deepest BatchNorms see 16 values a channel (8 clips × 2 steps × 1²),
where rounding is amplified: XLA:CPU's fp32 gradient lies 4.2% (global
norm) from the port's fp64 gradient, the port's fp32 one 0.63%, so the
gradients are held to the fp64 one and to JAX's at that distance. The
port's fp32 gradient moves with torch's intra-op thread count (0.63% to
3.1% from the fp64 one over 1–8 threads), so the port runs with one
thread (``one_torch_thread``)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from asltpu import config as jconfig
from asltpu.api import build_module as jbuild
from asltpu.train import loop as jloop
from asltpu_torch import api as tapi
from asltpu_torch import ckpt as tckpt
from asltpu_torch.config import TrainConfig
from asltpu_torch.models import common
from asltpu_torch.ops.preprocess import preprocess_clip
from asltpu_torch.train import loop as tloop
from test_torch_models import ATOL, draw_variables
from test_torch_train_video import one_torch_thread  # noqa: F401 (autouse fixture)

PP = {"num_frames": 16, "staging_size": (40, 48), "resize_short": 36, "crop": 32}
BATCH = 8
TCFG = dict(batch_size=BATCH, num_steps=10, warmup_steps=1, grad_clip_norm=1e4)
# Global relative distance of the fp32 gradients (measured on the CPU at
# this size: port vs JAX 4.2%, JAX vs fp64 4.2%, port vs fp64 0.63%).
GRAD_VS_JAX, GRAD_VS_FP64 = 0.1, 0.02
# bf16 compute with fp32 masters: the loss within 3% of JAX's (measured
# 1.4%; JAX's bf16 loss lies 1.8% from its fp32 one, the port's 3.2%),
# every running statistic within 5% of its tensor's largest entry
# (measured 2.9%). The bf16 gradient at
# this size is rounding noise (85% from the fp64 one in JAX, 93% in the
# port), so it is not compared.
BF16_LOSS_RTOL, BF16_STATS_RTOL = 0.03, 0.05


def _frames():
    rng = np.random.default_rng(0)
    return (rng.integers(0, 256, (BATCH, 16, 40, 48, 3), np.uint8),
            (np.arange(BATCH) * 3 % 7).astype(np.int32))


def _numpy(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_steps():
    """The JAX I3D's variables, and one train step of it at fp32 and bf16:
    (metrics, updated variables, Adam's first moment) per dtype."""
    frames, labels = _frames()
    base = jconfig.get_config("i3d", num_classes=7, dropout=0.0, compute_dtype="float32",
                              preprocess=PP)
    v = draw_variables(jbuild(base), np.zeros((1, 16, 32, 32, 3), np.float32), seed=6)
    tcfg = jconfig.TrainConfig(**TCFG)
    out = {}
    for dtype in ("float32", "bfloat16"):
        cfg = jconfig.get_config("i3d", num_classes=7, dropout=0.0, compute_dtype=dtype,
                                 preprocess=PP)
        module = jbuild(cfg)
        params = jax.tree.map(jnp.asarray, v["params"])
        state = jloop.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                                 batch_stats=jax.tree.map(jnp.asarray, v["batch_stats"]),
                                 opt_state=jloop.make_optimizer(tcfg).init(params),
                                 rng=jax.random.PRNGKey(0))
        step = jloop.make_train_step(module, tcfg, pp_cfg=cfg.preprocess)
        state, metrics = step(state, frames, labels)
        out[dtype] = ({k: float(x) for k, x in metrics.items()},
                      _numpy({"params": state.params, "batch_stats": state.batch_stats}),
                      _numpy({"params": state.opt_state[1][0].mu,
                              "batch_stats": state.batch_stats}))
    return v, out


def _port_step(v=None, dtype="float32", **over):
    """One train step of the port's I3D from the JAX variables ``v`` (or
    its own seeded weights): (model, metrics, gradients)."""
    model = tapi.build_trainable("i3d", device="cpu", seed=1, num_classes=7, dropout=0.0,
                                 compute_dtype=dtype, preprocess=PP, **over)
    if v is not None:
        model.module.load_state_dict(tckpt.state_dict_from_jax(model.cfg, v))
    state = tloop.create_train_state(model.module, TrainConfig(**TCFG))
    frames, labels = _frames()
    state, metrics = tloop.make_train_step(TrainConfig(**TCFG), model.cfg.preprocess)(
        state, frames, labels)
    grads = {n: state.optimizer.state[p]["exp_avg"] / 0.1
             for n, p in model.module.named_parameters()}
    return model, {k: float(x) for k, x in metrics.items()}, grads


def _global_rel(a, b) -> float:
    num = sum(float(((a[k].double() - b[k].double()) ** 2).sum()) for k in b)
    return (num / sum(float((b[k].double() ** 2).sum()) for k in b)) ** 0.5


def _stats_and_params(model):
    return {k: t for k, t in model.module.state_dict().items()
            if not k.endswith("num_batches_tracked")}


def test_i3d_fp32_step_matches_jax(jax_steps):
    """fp32: loss, the (unchanged) parameters and the updated running
    statistics within the reference's 2e-4 (measured 1.4e-4, 0 and
    9.6e-5); the gradient within 10% of JAX's and 2% of the port's fp64
    gradient (global norm)."""
    v, out = jax_steps
    want_metrics, want_vars, want_mu = out["float32"]
    model, metrics, grads = _port_step(v, "float32")
    assert abs(metrics["loss"] - want_metrics["loss"]) <= ATOL
    want = tckpt.state_dict_from_jax(model.cfg, want_vars)
    for k, t in _stats_and_params(model).items():
        np.testing.assert_allclose(t.numpy(), want[k].numpy(), rtol=0, atol=ATOL, err_msg=k)
    jax_grads = {k: t / 0.1 for k, t in tckpt.state_dict_from_jax(model.cfg, want_mu).items()
                 if k in grads}
    assert _global_rel(grads, jax_grads) < GRAD_VS_JAX

    m64 = tapi.build_trainable("i3d", device="cpu", num_classes=7, dropout=0.0,
                               compute_dtype="float64", preprocess=PP).module
    m64.load_state_dict(tckpt.state_dict_from_jax(model.cfg, v))
    frames, labels = _frames()
    clip = preprocess_clip(torch.from_numpy(frames), model.cfg.preprocess)
    loss = tloop.softmax_ce(m64.double()(clip.double(), train=True), torch.from_numpy(labels),
                            TrainConfig().label_smoothing)
    g64 = dict(zip([n for n, _ in m64.named_parameters()],
                   torch.autograd.grad(loss, list(m64.parameters()))))
    assert _global_rel(grads, g64) < GRAD_VS_FP64
    assert metrics["grad_norm"] == pytest.approx(want_metrics["grad_norm"], rel=GRAD_VS_JAX)


def test_i3d_bf16_step_matches_jax(jax_steps):
    """bf16 compute with fp32 masters: the loss within 3% of JAX's, the
    running statistics within 5% of each tensor's largest entry, the
    parameters unchanged and still fp32."""
    v, out = jax_steps
    want_metrics, want_vars, _ = out["bfloat16"]
    model, metrics, _ = _port_step(v, "bfloat16")
    assert metrics["loss"] == pytest.approx(want_metrics["loss"], rel=BF16_LOSS_RTOL)
    want = tckpt.state_dict_from_jax(model.cfg, want_vars)
    for k, t in _stats_and_params(model).items():
        assert t.dtype == torch.float32, k
        if "running" in k:
            err = float((t - want[k]).abs().max())
            assert err <= BF16_STATS_RTOL * float(want[k].abs().max()), (k, err)
        else:
            torch.testing.assert_close(t, want[k], rtol=0, atol=0, msg=k)


@pytest.mark.parametrize("shape", [(4, 3, 2, 3, 2), (2, 5, 1, 1, 2)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batch_norm_trains_as_flax(shape, dtype):
    """``common.batch_norm`` in training against flax's ``BatchNorm`` (bf16
    input, fp32 parameters): the output within one bf16 ulp (fp32: 1e-6),
    the running mean and the biased variance as flax updates them (1e-6);
    torch's own update, with the unbiased variance, is n/(n − 1) off, which
    the bound sees."""
    import flax.linen as fnn

    rng = np.random.default_rng(3)
    x = (rng.standard_normal(shape) * 3 + 1).astype(np.float32)
    jdtype = getattr(jnp, dtype)
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-3,
                       dtype=jdtype, param_dtype=jnp.float32)
    c = shape[-1]
    variables = {"params": {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
                            "bias": rng.normal(0, 0.1, c).astype(np.float32)},
                 "batch_stats": {"mean": rng.normal(0, 1, c).astype(np.float32),
                                 "var": rng.uniform(0.5, 2, c).astype(np.float32)}}
    want, upd = bn.apply(variables, jnp.asarray(x, jdtype), mutable=["batch_stats"])
    tbn = torch.nn.BatchNorm3d(c, eps=1e-3, momentum=0.1)
    with torch.no_grad():
        for name, key in (("weight", "scale"), ("bias", "bias")):
            getattr(tbn, name).copy_(torch.from_numpy(variables["params"][key]))
        tbn.running_mean.copy_(torch.from_numpy(variables["batch_stats"]["mean"]))
        tbn.running_var.copy_(torch.from_numpy(variables["batch_stats"]["var"]))
    xt = torch.from_numpy(x).to(getattr(torch, dtype)).permute(0, 4, 1, 2, 3)
    with torch.no_grad():
        got = common.batch_norm(tbn, xt, train=True).permute(0, 2, 3, 4, 1).float().numpy()
    want = np.asarray(want.astype(jnp.float32))
    tol = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7) if dtype == "bfloat16" else 1e-6
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    for stat, key in (("running_mean", "mean"), ("running_var", "var")):
        np.testing.assert_allclose(getattr(tbn, stat).numpy(),
                                   np.asarray(upd["batch_stats"][key]), rtol=1e-6, atol=1e-6)
    ref = torch.nn.BatchNorm3d(c, eps=1e-3, momentum=0.1).train()
    ref.running_var.copy_(torch.from_numpy(variables["batch_stats"]["var"]))
    ref(xt.float())
    assert not np.allclose(ref.running_var.numpy(), np.asarray(upd["batch_stats"]["var"]),
                           rtol=1e-6, atol=1e-6)


def test_remat_equals_no_remat_and_updates_stats_once(monkeypatch):
    """Remat on and off: the same loss, gradients and running statistics,
    bit for bit on the CPU. Without the freeze of the recompute (the
    control) each rematerialised BatchNorm updates its statistics twice,
    and they differ."""
    (model, metrics, grads), (plain, want_metrics, want_grads) = (
        _port_step(remat=True), _port_step(remat=False))
    assert metrics["loss"] == want_metrics["loss"]
    without = plain.module.state_dict()
    for a, b in ((model.module.state_dict(), without), (grads, want_grads)):
        for k in b:
            torch.testing.assert_close(a[k], b[k], rtol=0, atol=0, msg=k)
    import contextlib

    import asltpu_torch.models.i3d as ti3d

    monkeypatch.setattr(ti3d, "frozen_running_stats", contextlib.nullcontext)
    twice = _port_step(remat=True)[0].module.state_dict()
    key = "Mixed_4c.b0.bn.running_var"
    assert not torch.equal(twice[key], without[key])
    torch.testing.assert_close(twice["Conv3d_1a_7x7.bn.running_var"],
                               without["Conv3d_1a_7x7.bn.running_var"], rtol=0, atol=0)


def test_dropout_draws_from_the_generator():
    """I3D's dropout in training: the same generator state gives the same
    logits, another seed others; the global RNG is not drawn from; in
    inference dropout is the identity."""
    model = tapi.build_trainable("i3d", device="cpu", num_classes=7, dropout=0.5,
                                 compute_dtype="float32", preprocess=PP)
    clip = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 16, 32, 32, 3)).astype(np.float32))
    feats = model.module.backbone(clip).detach()
    torch.manual_seed(0)
    before = torch.random.get_rng_state()

    def logits(seed, train=True):
        return model.module.classify(feats, train, torch.Generator().manual_seed(seed))

    assert torch.equal(logits(3), logits(3))
    assert not torch.equal(logits(3), logits(4))
    assert torch.equal(torch.random.get_rng_state(), before)
    torch.testing.assert_close(logits(3, train=False), model.module.classify(feats),
                               rtol=0, atol=0)
