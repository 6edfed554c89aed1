"""Training in the port against the JAX package on the CPU: the optimizer
against optax, the loss, one ``pose_bilstm`` train step against
``asltpu.train.loop.make_train_step``, the eval step, the loop (loss falls,
periodic eval, keep-best, fault injection and a bit-identical resume),
checkpoints (pruning, best, ``load_model`` from a checkpoint directory)
and the metrics. Weights carry across through ``state_dict_from_jax``;
the Adam moments through the same mapping, since they have the parameters'
shapes."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from asltpu import config as jconfig
from asltpu.api import build_module as jbuild
from asltpu.data.synthetic import synthetic_landmarks
from asltpu.eval import metrics as jmetrics
from asltpu.train import loop as jloop
from asltpu_torch import api as tapi
from asltpu_torch import ckpt as tckpt
from asltpu_torch.config import TrainConfig
from asltpu_torch.eval import metrics as tmetrics
from asltpu_torch.train import loop as tloop

POSE = dict(num_classes=8, hidden_size=16, num_frames=6, dropout=0.0)
TCFG = dict(batch_size=8, num_steps=4, warmup_steps=1, log_every=1, ckpt_every=100,
            grad_clip_norm=10.0)
DUMMY = (jnp.zeros((1, 6, 543, 3)),)
STEP_RTOL = 1e-5  # the pose step: fp32, sums in other orders
# Parameters: also 1e-7 absolute (a 1e-4 share of the lr). ``fc.bias``
# starts at 0 and after its first Adam update sits within one lr of it,
# where an element whose two gradients nearly cancel carries their 1e-7
# relative difference up to 1.02e-8.
PARAM_ATOL = 1e-7


def _batch(seed=0):
    return synthetic_landmarks(8, 6, seed=seed), np.arange(8, dtype=np.int32) % 8


def _max_rel(got, want) -> float:
    """Largest difference over the largest magnitude of ``want``."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _pose_model(seed=0, **over):
    return tapi.build_trainable("pose_bilstm", seed=seed, device="cpu", **dict(POSE, **over))


def test_optimizer_matches_optax():
    """12 updates across a 3-step warmup and the cosine (decay over 10
    steps, then lr 0), with seeded gradients whose global norm is above the
    clip (1.0) at some steps and below it at others: parameters, both
    moments and the lr within 1e-6 of optax's (relative to each tensor's
    largest entry); the first update has lr 0 and moves only the moments."""
    cfg = TrainConfig(num_steps=10, warmup_steps=3, learning_rate=1e-2, weight_decay=1e-2,
                      grad_clip_norm=1.0)
    jcfg = jconfig.TrainConfig(num_steps=10, warmup_steps=3, learning_rate=1e-2,
                               weight_decay=1e-2, grad_clip_norm=1.0)
    rng = np.random.default_rng(0)
    shapes = [(5, 3), (7,), (2, 2, 3)]
    init = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    jparams = [jnp.asarray(p) for p in init]
    tx = jloop.make_optimizer(jcfg)
    jstate = tx.init(jparams)
    tparams = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in init]
    opt, schedule = tloop.make_optimizer(tparams, cfg)
    lr_of = optax.warmup_cosine_decay_schedule(0.0, 1e-2, 3, 10)
    clipped = 0
    for k in range(12):
        scale = 0.05 if k % 3 == 1 else 2.0
        grads = [(rng.standard_normal(s) * scale).astype(np.float32) for s in shapes]
        norm = float(np.sqrt(sum((g.astype(np.float64) ** 2).sum() for g in grads)))
        clipped += norm >= 1.0
        assert schedule.get_last_lr()[0] == pytest.approx(float(lr_of(k)), rel=1e-6, abs=1e-12)
        updates, jstate = tx.update([jnp.asarray(g) for g in grads], jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for p, g in zip(tparams, grads):
            p.grad = torch.from_numpy(g.copy())
        got_norm = tloop.clip_by_global_norm([p.grad for p in tparams], cfg.grad_clip_norm)
        assert float(got_norm) == pytest.approx(norm, rel=1e-6)
        opt.step()
        schedule.step()
        adam = jstate[1][0]
        for i, p in enumerate(tparams):
            st = opt.state[p]
            assert _max_rel(p.detach(), jparams[i]) < 1e-6, (k, i)
            assert _max_rel(st["exp_avg"], adam.mu[i]) < 1e-6, (k, i)
            assert _max_rel(st["exp_avg_sq"], adam.nu[i]) < 1e-6, (k, i)
        if k == 0:
            for p, p0 in zip(tparams, init):
                np.testing.assert_array_equal(p.detach().numpy(), p0)
    assert 0 < clipped < 12


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_softmax_ce_matches_jax(smoothing):
    rng = np.random.default_rng(1)
    logits = (rng.standard_normal((6, 11)) * 4).astype(np.float32)
    labels = rng.integers(0, 11, 6).astype(np.int32)
    want = float(jloop.softmax_ce(jnp.asarray(logits), jnp.asarray(labels), smoothing))
    got = float(tloop.softmax_ce(torch.from_numpy(logits), torch.from_numpy(labels),
                                 smoothing))
    assert got == pytest.approx(want, rel=1e-6)
    bf16 = torch.from_numpy(logits).bfloat16()
    assert float(tloop.softmax_ce(bf16, torch.from_numpy(labels), smoothing)) == pytest.approx(
        float(jloop.softmax_ce(jnp.asarray(logits, jnp.bfloat16), jnp.asarray(labels),
                               smoothing)), rel=1e-6)


def _jax_pose_state():
    cfg = jconfig.PoseBiLSTMConfig(**POSE)
    module = jbuild(cfg)
    return module, jloop.create_train_state(module, jconfig.TrainConfig(**TCFG), DUMMY, seed=0)


def test_pose_train_steps_match_jax():
    """Three steps of ``pose_bilstm`` (fp32, dropout 0) from the JAX
    variables on seeded batches: the first with lr 0 (warmup), then the
    cosine. Per step the loss, ``grad_norm`` and top-1; after each step
    every parameter within 1e-5 relative (and 1e-7 absolute) and both Adam
    moments within 1e-5 of the JAX step's largest entry of the tensor. The
    port's ``bias_hh`` stay 0 and out of the optimizer: JAX has one bias
    per gate."""
    jmodule, jstate = _jax_pose_state()
    variables = {"params": jax.tree.map(np.asarray, jstate.params)}
    model = _pose_model()
    model.module.load_state_dict(tckpt.state_dict_from_jax(model.cfg, variables))
    state = tloop.create_train_state(model.module, TrainConfig(**TCFG))
    jstep = jloop.make_train_step(jmodule, jconfig.TrainConfig(**TCFG))
    tstep = tloop.make_train_step(TrainConfig(**TCFG))
    for k in range(3):
        lm, labels = _batch(seed=10 + k)
        jstate, jm = jstep(jstate, jnp.asarray(lm), jnp.asarray(labels))
        state, tm = tstep(state, lm, labels)
        for key in ("loss", "grad_norm", "top1"):
            assert float(tm[key]) == pytest.approx(float(jm[key]), rel=STEP_RTOL), (k, key)
        adam = jstate.opt_state[1][0]
        trees = {name: tckpt.state_dict_from_jax(model.cfg, {"params": jax.tree.map(
            np.asarray, tree)}) for name, tree in (("param", jstate.params),
                                                   ("exp_avg", adam.mu),
                                                   ("exp_avg_sq", adam.nu))}
        for name, p in model.module.named_parameters():
            if not p.requires_grad:
                assert name.startswith("lstm.bias_hh") and not p.detach().any()
                continue
            np.testing.assert_allclose(p.detach().numpy(), trees["param"][name].numpy(),
                                       rtol=STEP_RTOL, atol=PARAM_ATOL, err_msg=f"{k} {name}")
            for moment in ("exp_avg", "exp_avg_sq"):
                assert _max_rel(state.optimizer.state[p][moment], trees[moment][name]) < (
                    STEP_RTOL), (k, name, moment)
    assert state.step == 3 and int(jstate.step) == 3


def test_eval_step_matches_jax():
    """Top-1 and top-5 hits of the eval step against ``make_eval_step`` on
    the same weights; pad rows with label −1 add no hit."""
    jmodule, jstate = _jax_pose_state()
    model = _pose_model()
    model.module.load_state_dict(tckpt.state_dict_from_jax(
        model.cfg, {"params": jax.tree.map(np.asarray, jstate.params)}))
    state = tloop.create_train_state(model.module, TrainConfig(**TCFG))
    lm, labels = _batch(seed=3)
    labels[-2:] = -1
    want = jloop.make_eval_step(jmodule)(jstate, jnp.asarray(lm), jnp.asarray(labels))
    got = tloop.make_eval_step()(state, lm, labels)
    assert [int(x) for x in got] == [int(x) for x in want]
    assert 0 <= int(got[0]) <= int(got[1]) <= 6


def test_train_loss_decreases(tmp_path):
    losses = []
    fixed = _batch(seed=1)
    cfg = TrainConfig(batch_size=8, num_steps=20, warmup_steps=2, learning_rate=3e-3,
                      log_every=1, ckpt_every=10_000, ckpt_dir=str(tmp_path / "ck"))
    state = tloop.train(_pose_model().module, cfg, (fixed for _ in range(20)),
                        metric_writer=lambda s, m: losses.append(m["loss"]))
    assert state.step == 20 and len(losses) == 20
    assert losses[-1] < losses[0] * 0.9  # memorises a fixed batch


def test_train_with_periodic_eval_and_best(tmp_path):
    """Eval at steps 3 and 6 (no second eval at the end), 16 clips each;
    ``best/`` holds the best eval_top1 at its step, a worse or equal metric
    leaves it and a better one replaces it with one step dir."""
    ckdir = str(tmp_path / "ck")
    cfg = TrainConfig(batch_size=8, num_steps=6, warmup_steps=1, learning_rate=3e-3,
                      log_every=100, eval_every=3, ckpt_every=10_000, ckpt_dir=ckdir)
    fixed = _batch(seed=2)
    evals = []

    def writer(step, metrics):
        if "eval_top1" in metrics:
            evals.append((step, metrics))

    state = tloop.train(_pose_model().module, cfg, (fixed for _ in range(6)),
                        metric_writer=writer, eval_batches=lambda: [fixed, _batch(seed=3)])
    assert state.step == 6 and [s for s, _ in evals] == [3, 6]
    for _, m in evals:
        assert m["eval_clips"] == 16.0
        assert 0.0 <= m["eval_top1"] <= m["eval_top5"] <= 1.0
    best = tckpt.load_best_metric(ckdir)
    want_step, want = max(((s, m["eval_top1"]) for s, m in evals), key=lambda e: (e[1], -e[0]))
    assert best["metric_name"] == "eval_top1"
    assert (best["step"], best["metric"]) == (want_step, want)
    state.step = 99
    assert not tckpt.save_best_state(ckdir, state, best["metric"] - 0.1)
    assert not tckpt.save_best_state(ckdir, state, best["metric"])
    assert tckpt.load_best_metric(ckdir)["step"] == want_step
    assert tckpt.save_best_state(ckdir, state, best["metric"] + 0.1)
    assert tckpt.load_best_metric(ckdir)["step"] == 99
    assert [d for d in os.listdir(os.path.join(ckdir, "best")) if d.isdigit()] == ["99"]


def _stream(start):
    """Seeded batches by step, from step ``start``."""
    k = start
    while True:
        yield _batch(seed=100 + k)
        k += 1


def test_fault_inject_and_resume_is_bit_identical(tmp_path):
    """Dropout 0.3 (the generator draws every step): a run cut by
    ``FaultInjected`` at step 5 and resumed from its step-4 checkpoint ends
    with the parameters, Adam moments, generator state and lr of an
    uninterrupted run, bit for bit, on the CPU."""
    def cfg(ckdir, fault):
        return TrainConfig(batch_size=8, num_steps=7, warmup_steps=1, learning_rate=3e-3,
                           log_every=100, ckpt_every=2, ckpt_dir=str(tmp_path / ckdir),
                           fault_inject_step=fault)

    whole = tloop.train(_pose_model(dropout=0.3).module, cfg("a", -1), _stream(0))
    with pytest.raises(tloop.FaultInjected):
        tloop.train(_pose_model(dropout=0.3).module, cfg("b", 5), _stream(0))
    assert sorted(os.listdir(tmp_path / "b")) == ["2", "4"]
    module = _pose_model(dropout=0.3, seed=5).module  # other weights: the resume loads
    resumed = tloop.train(module, cfg("b", -1), _stream(4))
    assert resumed.step == whole.step == 7
    want = whole.module.state_dict()
    for k, t in resumed.module.state_dict().items():
        torch.testing.assert_close(t, want[k], rtol=0, atol=0, msg=k)
    for p, q in zip(resumed.module.parameters(), whole.module.parameters()):
        if p.requires_grad:
            for moment in ("exp_avg", "exp_avg_sq"):
                torch.testing.assert_close(resumed.optimizer.state[p][moment],
                                           whole.optimizer.state[q][moment], rtol=0, atol=0)
    assert torch.equal(resumed.generator.get_state(), whole.generator.get_state())
    assert resumed.schedule.get_last_lr() == whole.schedule.get_last_lr()


def test_checkpoints_prune_and_load_for_inference(tmp_path):
    """``ckpt_keep`` newest step dirs stay, each written whole (no partial
    dir left); ``load_model`` reads a ``ckpt_dir`` (newest step), a step
    dir and ``best/``, giving the trained module's logits; a directory
    without a port checkpoint (an orbax one) is refused by name."""
    ckdir = str(tmp_path / "ck")
    cfg = TrainConfig(batch_size=8, num_steps=8, warmup_steps=1, learning_rate=3e-3,
                      log_every=100, ckpt_every=2, ckpt_keep=2, eval_every=3, ckpt_dir=ckdir)
    fixed = _batch(seed=4)
    state = tloop.train(_pose_model().module, cfg, (fixed for _ in range(8)),
                        eval_batches=lambda: [fixed])
    assert sorted(os.listdir(ckdir)) == ["6", "8", "best"]
    assert not tckpt.load_data_state(ckdir)
    lm = fixed[0]
    with torch.no_grad():
        want = state.module(torch.from_numpy(lm)).numpy()
    for path in (ckdir, os.path.join(ckdir, "8")):
        loaded = tapi.load_model("pose_bilstm", checkpoint=path, device="cpu", **POSE)
        np.testing.assert_array_equal(tapi.predict(loaded, lm)[1], want)
    best = tapi.load_model("pose_bilstm", checkpoint=os.path.join(ckdir, "best"),
                           device="cpu", **POSE)
    assert tapi.predict(best, lm)[1].shape == (8, 8)
    orbax_like = tmp_path / "orbax" / "3"
    orbax_like.mkdir(parents=True)
    (orbax_like / "_CHECKPOINT_METADATA").write_text("{}")
    with pytest.raises(FileNotFoundError, match="orbax"):
        tapi.load_model("pose_bilstm", checkpoint=str(orbax_like.parent), device="cpu", **POSE)
    tckpt.save_data_state(ckdir, 8, b"position")
    assert tckpt.load_data_state(ckdir) == b"position"


def test_only_trainable_families_build_and_masters_are_fp32():
    """Every family builds to train: fp32 masters, computing in its
    config's dtype (bf16 for the video families, fp32 for pose_bilstm)."""
    model = tapi.build_trainable("i3d", device="cpu", num_classes=5)
    assert model.module.training and model.module.remat
    assert model.module.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in model.module.parameters())
    small = {"mobilenet_gru": dict(width_mult=0.35, gru_hidden=16),
             "resnet_transformer": dict(d_model=32, num_heads=4, num_tx_layers=1),
             "two_stream": dict(width_mult=0.35, d_model=32, num_heads=4), "pose_bilstm": POSE,
             "timesformer": dict(num_frames=4, embed_dim=32, depth=1, num_heads=4,
                                 preprocess={"num_frames": 4, "crop": 32}),
             "video_swin": dict(num_frames=4, embed_dim=32, depths=(2, 2), num_heads=(2, 4),
                                window_size=(2, 4, 4), preprocess={"num_frames": 4, "crop": 32}),
             "mvit_v2": dict(num_frames=4, embed_dim=16, depth=2, dim_mul=((1, 2.0),),
                             head_mul=((1, 2.0),), pool_q_stride=((0, 1, 1, 1), (1, 1, 2, 2)),
                             pool_kv_stride_adaptive=(1, 2, 2),
                             preprocess={"num_frames": 4, "crop": 32})}
    built = {"i3d"}
    for name, over in small.items():
        m = tapi.build_trainable(name, device="cpu", **{"num_classes": 5, **over})
        assert isinstance(m.cfg, tapi.TRAINABLE), name
        assert all(p.dtype == torch.float32 for p in m.module.parameters()), name
        want = torch.float32 if name == "pose_bilstm" else torch.bfloat16
        assert m.cfg.compute_torch_dtype == want, name
        assert getattr(m.module, "dtype", torch.float32) == want, name
        built.add(name)
    assert built == {"i3d", "pose_bilstm", "mobilenet_gru", "resnet_transformer", "two_stream",
                     "timesformer", "video_swin", "mvit_v2"} and len(tapi.TRAINABLE) == 8
    cast = tapi.load_model("pose_bilstm", device="cpu", **POSE)
    tloop.create_train_state(cast.module, TrainConfig())  # pose stays fp32
    bf16 = tapi.load_model("i3d", device="cpu", num_classes=5)
    with pytest.raises(ValueError, match="fp32 master"):
        tloop.create_train_state(bf16.module, TrainConfig())


def test_yuv420_with_augment_is_refused():
    from asltpu_torch.config import PreprocessConfig
    from asltpu_torch.ops.augment import AugmentConfig

    with pytest.raises(ValueError, match="yuv420"):
        tloop.make_step_fn(TrainConfig(), PreprocessConfig(staging_format="yuv420"),
                           AugmentConfig())


def test_metrics_match_jax():
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((40, 9)).astype(np.float32)
    labels = rng.integers(0, 9, 40)
    labels[:3] = 4
    names = [f"g{i}" for i in range(6)]
    assert tmetrics.topk_accuracy(logits, labels) == jmetrics.topk_accuracy(logits, labels)
    np.testing.assert_array_equal(tmetrics.confusion_matrix(logits, labels),
                                  jmetrics.confusion_matrix(logits, labels))
    np.testing.assert_array_equal(tmetrics.confusion_matrix(logits.argmax(-1), labels),
                                  jmetrics.confusion_matrix(logits.argmax(-1), labels))
    assert tmetrics.per_class_metrics(logits, labels, names) == jmetrics.per_class_metrics(
        logits, labels, names)
    assert tmetrics.topk_entries(logits[0], names) == jmetrics.topk_entries(logits[0], names)
