"""The ``mobilenet_gru`` and ``resnet_transformer`` train steps in the port
against the JAX package's on the CPU, at the inference tests' sizes
(MobileNetV2 ×0.35 with a GRU of 32, ``tests/test_torch_models.py``;
ResNet-18 with a 2-layer head of width 32, ``tests/test_torch_resnet.py``),
batch 8 (``TrainConfig``'s), dropout 0, through preprocess, from the same
variables and the same uint8 batch; then a short ``train()`` whose
checkpoint ``load_model`` reads back, eval on a module in train mode, and
attention dropout as flax draws it.

The step is the first of a warmup, so its lr is 0: the parameters must
come out unchanged (weight decay is scaled by the lr), while the running
statistics and the Adam moments (0.1 × the gradient) move. The port's step
takes the uint8 batch through its preprocess; the JAX step takes the
port's preprocessed clip (``pp_cfg=None``). The two preprocesses agree to
one bf16 ulp, and at these sizes the training BatchNorms (32 values a
channel at the deepest) turn such input differences into gradients a few
percent apart (4.1% for mobilenet_gru), which would hide a fault of the
size held here. On the same clip the JAX model's step in float64
(``jax.enable_x64``) is held to the port's fp64 one at 1e-5. In fp32 the
gradient is rounding amplified: XLA:CPU's lies 2.1% from the fp64 one
(mobilenet_gru), the port's between 4.6e-5 and 2.7e-3 depending only on
the number of intra-op threads (which sets the order of its sums), so the
fp32 gradients are held to the fp64 one at bounds that cover 1 to 8
threads. The tests run the port with one thread (``one_torch_thread``)."""

import re

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
from asltpu_torch.models import temporal as ttemporal
from asltpu_torch.ops.preprocess import preprocess_clip
from asltpu_torch.train import loop as tloop
from test_torch_models import ATOL, draw_variables

BATCH = 8
TCFG = dict(batch_size=BATCH, num_steps=10, warmup_steps=1, grad_clip_norm=1e4)
FAMILIES = {
    "mobilenet_gru": dict(num_classes=7, width_mult=0.35, gru_hidden=32, preprocess={
        "num_frames": 4, "staging_size": (40, 48), "resize_short": 36, "crop": 32}),
    "resnet_transformer": dict(num_classes=7, d_model=32, num_heads=4, num_tx_layers=2,
                               preprocess={"num_frames": 3, "staging_size": (64, 80),
                                           "resize_short": 56, "crop": 48}),
}
# The JAX model's float64 step against the port's fp64 one: loss and
# gradient (global relative distance). The JAX GRU runs fp32 and both
# first moments are stored fp32. Measured on the CPU: mobilenet_gru 5.5e-7,
# resnet_transformer 1.3e-7.
FP64_RTOL = 1e-5
# fp32 bounds per family: (the port's gradient against its fp64 one, JAX's
# against the same, |grad_norm| against JAX's, relative). Measured on the
# CPU, the port's over 1, 2, 3, 4, 6 and 8 intra-op threads: mobilenet_gru
# 4.6e-5 to 2.7e-3, 2.07%, 0.13% to 0.15%; resnet_transformer 5e-6 to
# 4.9e-3, 0.48%, 4e-6 to 2.3e-5.
GRAD_BOUNDS = {"mobilenet_gru": (0.01, 0.05, 1e-2), "resnet_transformer": (0.02, 0.05, 1e-3)}
# bf16 compute with fp32 masters: (the loss against JAX's, every running
# statistic against JAX's as a share of its tensor's largest entry).
# Measured: mobilenet_gru 2.84% (JAX's bf16 loss lies 1.17% from its fp32
# one, the port's 1.70%) and 4.08% (``features.17``'s expand BN, which sees
# 32 values a channel); resnet_transformer 0.12% and 0.22%. The bf16
# gradient is not compared: both packages round it at other places.
BF16_BOUNDS = {"mobilenet_gru": (0.06, 0.08), "resnet_transformer": (0.01, 0.01)}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's side of these tests runs at toy sizes, where one
    intra-op thread is as fast as many and leaves the cores to the other
    test processes (whose threads would otherwise contend with ours)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def frames_and_labels(over, seed=0, batch=BATCH):
    """A seeded staged uint8 batch for the config ``over`` and its labels."""
    pp = over["preprocess"]
    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 256, (batch, pp["num_frames"], *pp["staging_size"], 3),
                          np.uint8)
    return frames, (np.arange(batch) * 3 % over["num_classes"]).astype(np.int32)


def draw_train_variables(module, *inputs, seed=0):
    """``draw_variables`` with the parameters it leaves at 0 drawn too: the
    GRU's and the BiLSTM's (U(−1/√H, 1/√H), as torch initialises them) and
    the CLS token (N(0, 0.02)). A numpy tree."""
    v = draw_variables(module, *inputs, seed=seed)
    rng = np.random.default_rng(seed + 1)

    def fill(node):
        for k, a in node.items():
            if isinstance(a, dict):
                fill(a)
            elif m := re.fullmatch(r"l\d+_(?:(fwd|bwd)_)?(wi|wh|bi|bh|b)", k):
                bound = (a.shape[-1] // (4 if m.group(1) else 3)) ** -0.5
                node[k] = rng.uniform(-bound, bound, a.shape).astype(np.float32)
            elif k == "cls":
                node[k] = rng.normal(0.0, 0.02, a.shape).astype(np.float32)

    fill(v["params"])
    return v


def _numpy(tree):
    return jax.tree.map(np.asarray, tree)


def jax_steps(name, over, batch_in, labels, dummy_inputs, seed):
    """The JAX model's variables, and one train step of it in fp32 and in
    float64 (``jax.enable_x64``), on ``batch_in`` (the model's input: a
    preprocessed clip, or a tuple of it and the landmarks): (metrics,
    updated variables, Adam's first moment) per dtype. In bf16 only the
    step's forward (its loss and updated statistics; at lr 0 the
    parameters stay as they were), which compiles in a fifth of the
    time."""
    base = jconfig.get_config(name, compute_dtype="float32", dropout=0.0, **over)
    v = draw_train_variables(jbuild(base), *dummy_inputs, seed=seed)
    tcfg = jconfig.TrainConfig(**TCFG)
    inputs = batch_in if isinstance(batch_in, tuple) else (batch_in,)
    out = {}
    for dtype in ("float32", "float64"):
        # float64 computes with the fp32 parameters widened inside each layer
        # (the GRU keeps fp32, as its module casts to it).
        with jax.enable_x64(dtype == "float64"):
            cfg = jconfig.get_config(name, compute_dtype=dtype, dropout=0.0, **over)
            params = jax.tree.map(jnp.asarray, v["params"])
            state = jloop.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                                     batch_stats=jax.tree.map(jnp.asarray, v["batch_stats"]),
                                     opt_state=jloop.make_optimizer(tcfg).init(params),
                                     rng=jax.random.PRNGKey(0))
            state, metrics = jloop.make_train_step(jbuild(cfg), tcfg)(state, batch_in, labels)
            out[dtype] = ({k: float(x) for k, x in metrics.items()},
                          _numpy({"params": state.params, "batch_stats": state.batch_stats}),
                          _numpy({"params": state.opt_state[1][0].mu,
                                  "batch_stats": state.batch_stats}))
    module = jbuild(jconfig.get_config(name, compute_dtype="bfloat16", dropout=0.0, **over))

    @jax.jit
    def forward(variables):
        logits, new = module.apply(variables, *inputs, True, mutable=["batch_stats"])
        return jloop.softmax_ce(logits, labels, tcfg.label_smoothing), new["batch_stats"]

    loss, stats = forward(jax.tree.map(jnp.asarray, v))
    out["bfloat16"] = ({"loss": float(loss)},
                       _numpy({"params": v["params"], "batch_stats": stats}), None)
    return v, out


def port_step(name, over, v, dtype, batch_in, labels):
    """One train step of the port's model from the JAX variables ``v``:
    (model, metrics, gradients)."""
    model = tapi.build_trainable(name, device="cpu", seed=1, compute_dtype=dtype,
                                 dropout=0.0, **over)
    model.module.load_state_dict(tckpt.state_dict_from_jax(model.cfg, v))
    state = tloop.create_train_state(model.module, TrainConfig(**TCFG))
    state, metrics = tloop.make_train_step(TrainConfig(**TCFG), model.cfg.preprocess)(
        state, batch_in, labels)
    grads = {n: state.optimizer.state[p]["exp_avg"] / 0.1
             for n, p in model.module.named_parameters() if p.requires_grad}
    return model, {k: float(x) for k, x in metrics.items()}, grads


def port_clip(over, frames) -> np.ndarray:
    """The port's preprocess of the uint8 ``frames`` (bf16), as fp32."""
    pp = tapi.get_config("mobilenet_gru", preprocess=over["preprocess"]).preprocess
    return preprocess_clip(torch.from_numpy(frames), pp).float().numpy()


def fp64_grads(name, over, v, batch_in, labels):
    """The port's loss and gradient in fp64 throughout (the preprocessed
    clip as the fp32 step sees it, widened)."""
    model = tapi.build_trainable(name, device="cpu", compute_dtype="float64", dropout=0.0,
                                 **over)
    m64 = model.module
    m64.load_state_dict(tckpt.state_dict_from_jax(model.cfg, v))
    m64.double()
    frames, *extras = batch_in if isinstance(batch_in, tuple) else (batch_in,)
    clip = torch.from_numpy(port_clip(over, frames)).double()
    logits = m64(clip, *(torch.from_numpy(x).double() for x in extras), train=True)
    loss = tloop.softmax_ce(logits, torch.from_numpy(labels), TrainConfig().label_smoothing)
    names = [n for n, p in m64.named_parameters() if p.requires_grad]
    return float(loss), dict(zip(names, torch.autograd.grad(
        loss, [p for p in m64.parameters() if p.requires_grad])))


def global_rel(a, b) -> float:
    num = sum(float(((a[k].double() - b[k].double()) ** 2).sum()) for k in b)
    return (num / sum(float((b[k].double() ** 2).sum()) for k in b)) ** 0.5


def stats_and_params(model):
    return {k: t for k, t in model.module.state_dict().items()
            if not k.endswith("num_batches_tracked")}


def check_fp32_step(name, over, v, out, batch_in, labels, bounds):
    """fp32: the loss, the (unchanged) parameters and the updated running
    statistics within the reference's 2e-4; the gradient against the
    port's fp64 one, JAX's against the same and ``grad_norm`` against
    JAX's, at ``bounds``. float64: the JAX model's loss and gradient
    against the port's fp64 ones within :data:`FP64_RTOL`."""
    want_metrics, want_vars, want_mu = out["float32"]
    model, metrics, grads = port_step(name, over, v, "float32", batch_in, labels)
    assert abs(metrics["loss"] - want_metrics["loss"]) <= ATOL
    want = tckpt.state_dict_from_jax(model.cfg, want_vars)
    for k, t in stats_and_params(model).items():
        np.testing.assert_allclose(t.numpy(), want[k].numpy(), rtol=0, atol=ATOL, err_msg=k)
    loss64, g64 = fp64_grads(name, over, v, batch_in, labels)

    def jax_grads(dtype):
        mu = tckpt.state_dict_from_jax(model.cfg, out[dtype][2])
        return {k: t.double() / 0.1 for k, t in mu.items() if k in grads}

    measured = (global_rel(grads, g64), global_rel(jax_grads("float32"), g64),
                abs(metrics["grad_norm"] / want_metrics["grad_norm"] - 1))
    assert all(m < b for m, b in zip(measured, bounds)), (measured, bounds)
    assert out["float64"][0]["loss"] == pytest.approx(loss64, rel=FP64_RTOL)
    assert global_rel(jax_grads("float64"), g64) < FP64_RTOL


def check_bf16_step(name, over, v, out, batch_in, labels, bounds):
    """bf16 compute with fp32 masters: the loss and the running statistics
    at ``bounds``, the parameters unchanged and still fp32."""
    want_metrics, want_vars, _ = out["bfloat16"]
    model, metrics, _ = port_step(name, over, v, "bfloat16", batch_in, labels)
    loss_rtol, stats_rtol = bounds
    assert metrics["loss"] == pytest.approx(want_metrics["loss"], rel=loss_rtol)
    want = tckpt.state_dict_from_jax(model.cfg, want_vars)
    for k, t in stats_and_params(model).items():
        assert t.dtype == torch.float32, k
        if "running" in k:
            err = float((t - want[k]).abs().max())
            assert err <= stats_rtol * float(want[k].abs().max()), (k, err)
        else:
            torch.testing.assert_close(t, want[k], rtol=0, atol=0, msg=k)


def check_eval_drops_nothing(name, over, batch_in, labels):
    """``make_eval_step`` on a module left in ``.train()`` with dropout 0.5:
    no generator or global RNG is drawn from, no running statistic moves,
    and its hits are those of ``module(..., train=False)``, which a second
    call repeats exactly."""
    model = tapi.build_trainable(name, device="cpu", **dict(over, dropout=0.5))
    assert model.module.training
    state = tloop.create_train_state(model.module, TrainConfig())
    before = {k: t.clone() for k, t in model.module.state_dict().items()}
    gen_state, rng_state = state.generator.get_state(), torch.random.get_rng_state()
    top1, top5 = tloop.make_eval_step(model.cfg.preprocess)(state, batch_in, labels)
    assert torch.equal(state.generator.get_state(), gen_state)
    assert torch.equal(torch.random.get_rng_state(), rng_state)
    for k, t in model.module.state_dict().items():
        assert torch.equal(t, before[k]), k
    frames, *extras = batch_in if isinstance(batch_in, tuple) else (batch_in,)
    inputs = (preprocess_clip(torch.from_numpy(frames), model.cfg.preprocess),
              *map(torch.from_numpy, extras))
    with torch.no_grad():
        logits = model.module(*inputs, train=False)
        assert torch.equal(logits, model.module(*inputs, train=False))
    labels = torch.from_numpy(labels)
    assert int(top1) == int((logits.argmax(-1) == labels).sum())
    assert int(top5) == int((logits.topk(5, dim=-1).indices == labels[:, None]).any(-1).sum())


def check_dropout_draws_from_the_generator(name, over, batch_in):
    """With dropout 0.5 in training: the same generator state gives the
    same logits and another seed others, the global RNG is not drawn from,
    and in inference dropout is the identity. BatchNorm's momentum is 0,
    so no call moves the running statistics the next one reads."""
    model = tapi.build_trainable(name, device="cpu", compute_dtype="float32",
                                 **dict(over, dropout=0.5))
    frames, *extras = batch_in if isinstance(batch_in, tuple) else (batch_in,)
    inputs = (preprocess_clip(torch.from_numpy(frames), model.cfg.preprocess),
              *map(torch.from_numpy, extras))
    torch.manual_seed(0)
    rng_state = torch.random.get_rng_state()
    for m in model.module.modules():
        if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
            m.momentum = 0.0

    def logits(seed, train=True):
        with torch.no_grad():
            return model.module(*inputs, train=train, generator=torch.Generator().manual_seed(seed))

    assert torch.equal(logits(3), logits(3))
    assert not torch.equal(logits(3), logits(4))
    assert torch.equal(torch.random.get_rng_state(), rng_state)
    assert torch.equal(logits(3, train=False), logits(4, train=False))


def check_checkpoint_loads_and_predicts(name, over, batch_in, labels, ckdir, eval_batches=None):
    """``train()`` for 2 steps with a checkpoint (and eval, keep-best),
    then ``load_model(name, checkpoint=<dir>)``: the same logits and top-1
    as the trained module in inference, at the config's bf16. Returns the
    final state."""
    model = tapi.build_trainable(name, device="cpu", **over)
    tcfg = TrainConfig(batch_size=len(labels), num_steps=2, warmup_steps=1, log_every=1,
                       ckpt_every=2, eval_every=2, ckpt_dir=ckdir)
    state = tloop.train(model.module, tcfg, [(batch_in, labels)] * 2,
                        pp_cfg=model.cfg.preprocess, eval_batches=eval_batches)
    assert state.step == 2
    frames, *extras = batch_in if isinstance(batch_in, tuple) else (batch_in,)
    with torch.no_grad():
        want = state.module(preprocess_clip(torch.from_numpy(frames), model.cfg.preprocess),
                            *map(torch.from_numpy, extras))
    loaded = tapi.load_model(name, checkpoint=ckdir, device="cpu", **over)
    ids, logits = tapi.predict(loaded, frames, *extras)
    np.testing.assert_array_equal(ids, want.argmax(-1).numpy())
    np.testing.assert_allclose(logits, want.numpy(), rtol=0, atol=1e-6)
    return state


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def family_steps(request):
    name = request.param
    over = FAMILIES[name]
    frames, labels = frames_and_labels(over)
    clip = port_clip(over, frames)
    v, out = jax_steps(name, over, jnp.asarray(clip, jnp.bfloat16), labels,
                       (np.zeros_like(clip[:1]),), seed=7)
    return name, over, frames, labels, v, out


def test_fp32_step_matches_jax(family_steps):
    name, over, frames, labels, v, out = family_steps
    check_fp32_step(name, over, v, out, frames, labels, GRAD_BOUNDS[name])


def test_bf16_step_matches_jax(family_steps):
    name, over, frames, labels, v, out = family_steps
    check_bf16_step(name, over, v, out, frames, labels, BF16_BOUNDS[name])


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_train_checkpoint_loads_and_predicts(name, tmp_path):
    over = FAMILIES[name]
    frames, labels = frames_and_labels(over, seed=1, batch=4)
    check_checkpoint_loads_and_predicts(name, over, frames, labels, str(tmp_path))


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_eval_step_on_a_module_in_train_mode_drops_nothing(name):
    over = FAMILIES[name]
    check_eval_drops_nothing(name, over, *frames_and_labels(over, seed=2, batch=4))


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_dropout_draws_from_the_generator(name):
    over = FAMILIES[name]
    check_dropout_draws_from_the_generator(name, over, frames_and_labels(over, seed=3,
                                                                          batch=2)[0])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_dropout_is_flax_shaped(dtype):
    """Attention-weight dropout against flax's
    ``dot_product_attention_weights`` (``broadcast_dropout=True``): one
    [1, 1, q, k] mask, drawn from the generator passed and shared by every
    batch row and head, and kept weights multiplied by flax's factor
    ``keep / (1 − p)`` computed in the compute dtype (bit for bit where both
    keep a weight; under bf16 that factor is bf16(1 / bf16(0.9)), not
    1 / 0.9). Identity in inference; the global RNG is not drawn from."""
    from flax.linen.attention import dot_product_attention_weights

    jdtype, tdtype = getattr(jnp, dtype), getattr(torch, dtype)
    rng = np.random.default_rng(0)
    q, k = (jnp.asarray(rng.standard_normal((3, n, 4, 8)), jdtype) for n in (5, 6))
    kw = dict(dropout_rate=0.1, dtype=jdtype)
    det = dot_product_attention_weights(q, k, deterministic=True, **kw)
    dropped = np.asarray(dot_product_attention_weights(
        q, k, dropout_rng=jax.random.PRNGKey(1), deterministic=False, **kw).astype(jnp.float32))
    weights = torch.from_numpy(np.asarray(det.astype(jnp.float32))).to(tdtype)
    rng_state = torch.random.get_rng_state()
    got = common.attention_dropout(weights, 0.1, True, torch.Generator().manual_seed(3))
    assert torch.equal(torch.random.get_rng_state(), rng_state)
    keep = torch.rand((1, 1, 5, 6), generator=torch.Generator().manual_seed(3)) >= 0.1
    assert torch.equal(got != 0, keep.expand(3, 4, 5, 6))
    flax_keep = dropped != 0
    assert (flax_keep == flax_keep[:1, :1]).all()  # flax's mask: one for batch and heads
    both = keep.expand(3, 4, 5, 6).numpy() & flax_keep
    assert both.any()
    np.testing.assert_array_equal(got.float().numpy()[both], dropped[both])
    assert torch.equal(common.attention_dropout(weights, 0.1, False), weights)


def test_attention_takes_train_and_the_generator(monkeypatch):
    """The transformer head's attention dropout sees every block's [B, H,
    T + 1, T + 1] weights with ``train`` and the step's generator."""
    seen = []
    real = ttemporal.attention_dropout

    def spy(weights, p, train, generator=None):
        seen.append((tuple(weights.shape), p, train, generator))
        return real(weights, p, train, generator)

    monkeypatch.setattr(ttemporal, "attention_dropout", spy)
    head = ttemporal.TransformerHead(7, 16, 5, 32, 4, 2, dropout=0.2)
    gen = torch.Generator().manual_seed(0)
    a = head(torch.ones(2, 5, 16), train=True, generator=gen)
    b = head(torch.ones(2, 5, 16), train=True, generator=gen)
    assert not torch.equal(a, b)
    assert seen == [((2, 4, 6, 6), 0.2, True, gen)] * 4
    seen.clear()
    head(torch.ones(2, 5, 16))
    assert [s[2] for s in seen] == [False, False]
