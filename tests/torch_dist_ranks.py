"""The rank processes of the port's distributed tests
(``tests/test_torch_dist.py``, ``test_torch_tp.py``,
``test_torch_multihost.py``), and the cases they share with them.

``launch(kind, world, out_dir)`` starts ``world`` fresh interpreters
(``python -m torch_dist_ranks``; torch and ``asltpu_torch`` only, no JAX),
each joining one gloo group at a free localhost port with a 60 s
collective timeout, running every scenario of ``kind`` in order and saving
each scenario's result as ``<out_dir>/<scenario>_<rank>.pt``. The launch
waits at most 120 s for them all; past that it kills them and reports the
failure, so a collective that never completes fails its tests instead of
hanging them. A test file launches once, from a module-scoped fixture.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import time
import traceback

import numpy as np
import torch

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
GROUP_TIMEOUT_S = 60.0
JOIN_TIMEOUT_S = 120.0

# ---------------------------------------------------------------------------
# cases shared by the ranks and the single-process references
# ---------------------------------------------------------------------------

# tests/unit/test_train.py's: pose_bilstm (:21-23) and the BatchNorm case
# (:64-71), mobilenet_gru at width 1.0 over 32² frames.
TCFG = dict(batch_size=8, num_steps=4, warmup_steps=1, log_every=1, ckpt_every=100,
            grad_clip_norm=10.0)
POSE = dict(num_classes=8, hidden_size=16, num_frames=6, dropout=0.0)
BN = dict(num_classes=4, gru_hidden=16, dropout=0.0, compute_dtype="float32",
          preprocess=dict(num_frames=2, staging_size=(32, 32), resize_short=32, crop=32))
# tests/unit/test_train.py::_fusion_setup's two_stream (:220-227).
FUSION = dict(num_classes=4, num_frames=4, d_model=32, num_heads=2, num_fusion_layers=1,
              dropout=0.0, width_mult=0.5, compute_dtype="float32",
              preprocess=dict(num_frames=4))
# Dropout and augmentation drawn for the global batch.
DROPOUT = dict(num_classes=4, width_mult=0.35, gru_hidden=16, dropout=0.1,
               compute_dtype="float32",
               preprocess=dict(num_frames=2, staging_size=(40, 40), resize_short=36, crop=32))
# tests/unit/test_tp.py's heads: the TP train step (:98-105) and the
# contract head (:162-165).
HEAD = dict(num_classes=8, feature_dim=64, num_frames=5, d_model=64, num_heads=4,
            num_layers=2, mlp_ratio=4, dropout=0.0, dtype=torch.float32)
TP_TCFG = dict(batch_size=8, num_steps=4, learning_rate=1e-3, warmup_steps=0,
               weight_decay=1e-4, label_smoothing=0.1, grad_clip_norm=1.0, seed=0)
CONTRACT = dict(num_classes=100, feature_dim=512, num_frames=16, d_model=512, num_heads=8,
                num_layers=4, mlp_ratio=4, dropout=0.0, dtype=torch.bfloat16)
# tests/unit/test_tp.py::test_tp_eval_step_matches_replicated's labels.
EVAL_LABELS = np.asarray([0, 1, 2, 3, 4, 5, -1, -1], np.int64)


def pose_batch():
    from asltpu_torch.data.synthetic import synthetic_landmarks

    return synthetic_landmarks(8, 6, seed=0), (np.arange(8) % 8).astype(np.int64)


def bn_batch(over=BN, seed=0):
    pp = over["preprocess"]
    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 256, (8, pp["num_frames"], *pp["staging_size"], 3), np.uint8)
    return frames, (np.arange(8) % over["num_classes"]).astype(np.int64)


def fusion_batch():
    from asltpu_torch.data.synthetic import synthetic_landmarks

    rng = np.random.default_rng(3)
    clips = rng.standard_normal((8, 4, 32, 32, 3)).astype(np.float32)
    return (clips, synthetic_landmarks(8, 4, seed=3)), (np.arange(8) % 4).astype(np.int64)


def head_feats(shape=(8, 5, 64), seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def build(name, over, seed=0):
    """The trainable module of ``name`` on the CPU from ``seed``."""
    from asltpu_torch import api

    return api.build_trainable(name, seed=seed, device="cpu", **over)


def build_head(over, seed=0):
    """A bare transformer head from ``seed`` (``init_weights``)."""
    from asltpu_torch.models.common import init_weights
    from asltpu_torch.models.temporal import TransformerHead

    head = TransformerHead(**over)
    init_weights(head, torch.Generator().manual_seed(seed))
    return head


def train_config(**over):
    from asltpu_torch.config import TrainConfig

    return TrainConfig(**{**TCFG, **over})


def step_result(state, metrics):
    """What a comparison reads of a state after its steps: the metrics,
    the whole state dict, Adam's moments by parameter name (each rank's
    own slice, and gathered), in the single-device layout."""
    from asltpu_torch.dist.tp import tp_gather_optimizer_state, tp_gather_state_dict

    names = [n for n, _ in state.module.named_parameters()]
    local = {names[i]: s["exp_avg"].clone() for i, s in state.optimizer.state_dict()["state"].items()
             if "exp_avg" in s}
    opt = tp_gather_optimizer_state(state.module, state.optimizer, state.mesh)
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "state": tp_gather_state_dict(state.module, state.mesh),
            "exp_avg": {names[i]: s["exp_avg"] for i, s in opt["state"].items()
                        if "exp_avg" in s},
            "exp_avg_sq": {names[i]: s["exp_avg_sq"] for i, s in opt["state"].items()
                           if "exp_avg_sq" in s},
            "local_exp_avg_shapes": {k: tuple(v.shape) for k, v in local.items()}}


def run_steps(module, tcfg, batch_in, labels, steps, pp=None, mesh=None, augment=None):
    """``steps`` train steps of ``module`` on one global batch: the
    single-process step without ``mesh``, the rank's with it."""
    from asltpu_torch.train import loop

    state = loop.create_train_state(module, tcfg, tcfg.seed, mesh=mesh)
    step = loop.make_train_step(tcfg, pp, augment, mesh=mesh)
    for _ in range(steps):
        state, metrics = step(state, batch_in, labels)
    return state, metrics


# ---------------------------------------------------------------------------
# data-parallel scenarios (2 ranks)
# ---------------------------------------------------------------------------


def dp_pose(ctx):
    from asltpu_torch.dist import make_mesh, replicate

    mesh = make_mesh()
    m = build("pose_bilstm", POSE)
    replicate(m.module, mesh)
    return step_result(*run_steps(m.module, train_config(), *pose_batch(), 1, mesh=mesh))


def dp_bn(ctx):
    """The BatchNorm case, and the same step with each rank's own batch
    statistics (the fault the global statistics repair)."""
    from asltpu_torch.dist import make_mesh, shard_batch
    from asltpu_torch.train import loop

    mesh = make_mesh()
    m = build("mobilenet_gru", BN)
    out = step_result(*run_steps(m.module, train_config(), *bn_batch(), 1, m.cfg.preprocess,
                                 mesh=mesh))
    per_rank = build("mobilenet_gru", BN)
    frames, labels = bn_batch()
    state = loop.create_train_state(per_rank.module, train_config())
    loop.make_train_step(train_config(), per_rank.cfg.preprocess)(
        state, shard_batch(mesh, frames), shard_batch(mesh, labels))
    out["per_rank_state"] = per_rank.module.state_dict()
    return out


def dp_fusion(ctx):
    from asltpu_torch.dist import make_mesh

    m = build("two_stream", FUSION)
    return step_result(*run_steps(m.module, train_config(), *fusion_batch(), 2,
                                  mesh=make_mesh()))


def dp_dropout(ctx):
    from asltpu_torch.dist import make_mesh
    from asltpu_torch.ops.augment import AugmentConfig

    m = build("mobilenet_gru", DROPOUT)
    return step_result(*run_steps(m.module, train_config(), *bn_batch(DROPOUT), 2,
                                  m.cfg.preprocess, mesh=make_mesh(),
                                  augment=AugmentConfig()))


def dp_eval(ctx):
    """Hits on a padded last batch, through ``make_eval_step`` and through
    ``train``'s eval."""
    from asltpu_torch.dist import make_mesh
    from asltpu_torch.train import loop

    mesh = make_mesh()
    m = build("pose_bilstm", POSE)
    state = loop.create_train_state(m.module, train_config(), mesh=mesh)
    lm, _ = pose_batch()
    t1, t5 = loop.make_eval_step(None, mesh)(state, lm, EVAL_LABELS)
    evals = []
    loop.train(m.module, train_config(num_steps=1, ckpt_dir=ctx["out"] + "/eval_ck",
                                      keep_best=False),
               iter([pose_batch()]), eval_batches=lambda: [(lm, EVAL_LABELS)],
               metric_writer=lambda s, mt: evals.append(mt) if "eval_top1" in mt else None)
    return {"top1": int(t1), "top5": int(t5), "train_evals": evals}


def _resumed_run(module_fn, ckpt_dir, fault):
    from asltpu_torch.train import loop

    tcfg = train_config(num_steps=4, ckpt_every=2, ckpt_dir=ckpt_dir, fault_inject_step=fault,
                        warmup_steps=1)
    batches = [pose_batch() for _ in range(4)]
    m = module_fn()
    try:
        return loop.train(m.module, tcfg, iter(batches))
    except loop.FaultInjected:
        pass
    m = module_fn()
    tcfg = train_config(num_steps=4, ckpt_every=2, ckpt_dir=ckpt_dir, warmup_steps=1)
    return loop.train(m.module, tcfg, iter(batches[2:]))


def dp_ckpt(ctx):
    """train() in the default mesh (the world): 4 steps, and a run cut at
    step 3 resumed from its step-2 checkpoint (rank 0 writes it)."""
    import torch.distributed as dist

    def fresh():
        return build("pose_bilstm", dict(POSE, dropout=0.1), seed=dist.get_rank())

    whole = _resumed_run(fresh, ctx["out"] + "/dp_whole", fault=-1)
    cut = _resumed_run(fresh, ctx["out"] + "/dp_cut", fault=3)
    return {"whole": whole.module.state_dict(), "cut": cut.module.state_dict(),
            "steps": (whole.step, cut.step),
            "generator": (whole.generator.get_state(), cut.generator.get_state())}


# ---------------------------------------------------------------------------
# tensor-parallel scenarios
# ---------------------------------------------------------------------------


def _tp_head(over, mp, sd=None, seed=0, mesh=None):
    from asltpu_torch.dist import make_mesh, tp_shard_module

    mesh = mesh or make_mesh(model_parallel=mp)
    head = build_head(over, seed)
    if sd is not None:
        head.load_state_dict(sd)
    return tp_shard_module(head, mesh), mesh


def tp_head(ctx):
    head, _ = _tp_head(dict(HEAD, num_classes=16), 2)
    with torch.no_grad():
        return {"logits": head(torch.from_numpy(head_feats()))}


def tp_train(ctx):
    """Two TP train steps of the head from the JAX package's variables
    (``ctx['head_sd']``, made by the test)."""
    from asltpu_torch.config import TrainConfig

    head, mesh = _tp_head(HEAD, 2, ctx["inputs"]["head_sd"])
    out = step_result(*run_steps(head, TrainConfig(**TP_TCFG), head_feats(),
                                 (np.arange(8) % 8).astype(np.int64), 2, mesh=mesh))
    out["local_shapes"] = {n: tuple(p.shape) for n, p in head.named_parameters()}
    return out


def tp_eval(ctx):
    from asltpu_torch.config import TrainConfig
    from asltpu_torch.train import loop

    head, mesh = _tp_head(dict(HEAD, num_layers=1), 2)
    state = loop.create_train_state(head, TrainConfig(**TP_TCFG), mesh=mesh)
    t1, t5 = loop.make_eval_step(None, mesh)(state, head_feats(), EVAL_LABELS)
    return {"top1": int(t1), "top5": int(t5)}


def tp_ckpt(ctx):
    """A TP run of 2 steps, and one cut after its step-1 checkpoint and
    resumed (its state rebuilt, then restored and re-sliced)."""
    from asltpu_torch import ckpt
    from asltpu_torch.config import TrainConfig
    from asltpu_torch.dist import make_mesh
    from asltpu_torch.train import loop

    over = dict(HEAD, num_layers=1)
    feats, labels = head_feats(), (np.arange(8) % 8).astype(np.int64)
    tcfg = TrainConfig(**{**TP_TCFG, "ckpt_dir": ctx["out"] + "/tp_ck"})

    mesh = make_mesh(model_parallel=2)

    def fresh():
        return loop.create_train_state(_tp_head(over, 2, mesh=mesh)[0], tcfg, mesh=mesh)

    step = loop.make_train_step(tcfg, mesh=mesh)
    ref = fresh()
    for _ in range(2):
        ref, _ = step(ref, feats, labels)
    state, _ = step(fresh(), feats, labels)
    ckpt.save_train_state(tcfg.ckpt_dir, state)
    restored = ckpt.try_restore_train_state(tcfg.ckpt_dir, fresh())
    restored, _ = step(restored, feats, labels)
    return {"ref": step_result(ref, {}), "resumed": step_result(restored, {}),
            "steps": (ref.step, restored.step)}


def tp_fusion(ctx):
    """A fusion cross-attention block sharded over 2 ranks against whole,
    forward and the inputs' gradients."""
    from asltpu_torch.dist import make_mesh, tp_shard_module
    from asltpu_torch.models.common import init_weights
    from asltpu_torch.models.fusion import CrossAttentionBlock

    block = CrossAttentionBlock(32, 4, dropout=0.0)
    init_weights(block, torch.Generator().manual_seed(0))
    tp_shard_module(block, make_mesh(model_parallel=2))
    a = torch.from_numpy(head_feats((2, 4, 32), 5)).requires_grad_()
    b = torch.from_numpy(head_feats((2, 3, 32), 6)).requires_grad_()
    ya, yb = block(a, b)
    (ya.square().sum() + yb.sum()).backward()
    return {"out": (ya.detach(), yb.detach()), "grads": (a.grad, b.grad),
            "shapes": {n: tuple(p.shape) for n, p in block.named_parameters()}}


def tp_contract(ctx):
    """The contract head in bf16 at model_parallel 4 (4 ranks), then the
    same head on a (2 data, 2 model) mesh with the batch split over data
    and its logits gathered."""
    from asltpu_torch.dist import gather_batch, shard_batch

    feats = torch.from_numpy(head_feats((8, 16, 512)))
    head, _ = _tp_head(CONTRACT, 4)
    with torch.no_grad():
        mp4 = head(feats).float()
    head, mesh = _tp_head(CONTRACT, 2)
    with torch.no_grad():
        dp_tp = gather_batch(mesh, head(shard_batch(mesh, feats)).float())
    return {"mp4": mp4, "dp_tp": dp_tp, "mesh": mesh.shape}


# ---------------------------------------------------------------------------
# bring-up (test_torch_multihost.py): no group before the scenario
# ---------------------------------------------------------------------------


def bringup(ctx):
    """Join by explicit address, then by torchrun's environment."""
    import torch.distributed as dist

    from asltpu_torch.dist import (assemble_global_batch, gather_batch, init_distributed,
                                   local_batch_size, make_mesh, shard_batch)

    rank, world = ctx["rank"], ctx["world"]
    out = {}
    got = init_distributed(f"127.0.0.1:{ctx['port']}", world, rank, backend="gloo",
                           timeout_s=GROUP_TIMEOUT_S)
    out["tcp"] = (got, dist.get_world_size(), dist.get_backend())
    out["again"] = init_distributed()
    out["local_batch"] = local_batch_size(8)
    try:
        local_batch_size(7)
        out["odd_batch"] = None
    except ValueError as e:
        out["odd_batch"] = str(e)
    mesh = make_mesh()
    x = np.arange(8 * 3, dtype=np.float32).reshape(8, 3) * 10.0
    rows = assemble_global_batch(mesh, shard_batch(mesh, x), device="cpu")
    out["rows"] = rows
    out["sum"] = float(gather_batch(mesh, rows).sum())
    t = torch.tensor([float(rank + 1)])
    dist.all_reduce(t)
    out["all_reduce"] = float(t)
    dist.destroy_process_group()
    env = {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(ctx["port2"]),
           "RANK": str(rank), "WORLD_SIZE": str(world)}
    os.environ.update(env)
    got = init_distributed(backend="gloo", timeout_s=GROUP_TIMEOUT_S)
    t = torch.tensor([float(rank + 1)])
    dist.all_reduce(t)
    out["env"] = (got, dist.get_world_size(), float(t))
    return out


SCENARIOS = {
    "dp": [dp_pose, dp_bn, dp_fusion, dp_dropout, dp_eval, dp_ckpt],
    "tp": [tp_head, tp_train, tp_eval, tp_ckpt, tp_fusion],
    "tp4": [tp_contract],
    "multihost": [bringup],
}


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(kind: str, world: int, out_dir: str, timeout: float = JOIN_TIMEOUT_S):
    """Run ``kind``'s scenarios in ``world`` rank processes; None when every
    rank exited 0, else what went wrong with each rank's log. ``out_dir``
    may hold ``inputs.pt`` (the parent's inputs, read by every rank)."""
    port, port2 = free_port(), free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([REPO, TESTS, os.environ.get("PYTHONPATH", "")]))
    logs = [os.path.join(out_dir, f"{kind}_rank{r}.log") for r in range(world)]
    procs = []
    for r in range(world):
        with open(logs[r], "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "torch_dist_ranks", kind, str(r), str(world),
                 str(port), str(port2), out_dir],
                cwd=TESTS, env=env, stdout=log, stderr=subprocess.STDOUT))
    deadline = time.monotonic() + timeout
    timed_out = False
    try:
        for p in procs:
            p.wait(timeout=max(0.1, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        timed_out = True
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if not timed_out and all(p.returncode == 0 for p in procs):
        return None
    why = [f"{kind}: timed out after {timeout} s"] if timed_out else []
    for r, (p, log) in enumerate(zip(procs, logs)):
        with open(log) as f:
            why.append(f"rank {r} exit {p.returncode}:\n{f.read()[-4000:]}")
    return "\n".join(why)


def load(out_dir: str, name: str, rank: int):
    return torch.load(os.path.join(out_dir, f"{name}_{rank}.pt"), weights_only=False)


def main(argv) -> int:
    kind, rank, world, port, port2, out = argv
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    inputs = os.path.join(out, "inputs.pt")
    ctx = {"rank": rank, "world": world, "port": int(port), "port2": int(port2), "out": out,
           "inputs": torch.load(inputs, weights_only=False) if os.path.exists(inputs) else {}}
    import torch.distributed as dist

    from asltpu_torch.dist import init_distributed

    try:
        if kind != "multihost":
            init_distributed(f"127.0.0.1:{port}", world, rank, backend="gloo",
                             timeout_s=GROUP_TIMEOUT_S)
        for fn in SCENARIOS[kind]:
            torch.save(fn(ctx), os.path.join(out, f"{fn.__name__}_{rank}.pt"))
        if dist.is_initialized():
            dist.barrier()
            dist.destroy_process_group()
    except BaseException:
        traceback.print_exc()
        sys.stdout.flush()
        os._exit(1)  # a peer left waiting in a collective times out on its own
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
