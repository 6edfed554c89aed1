"""The training loop: one train step (preprocess → forward → label-smoothed
cross-entropy → backward → global-norm clip → AdamW with warmup-cosine)
and the host loop around it (checkpoints with pruning, resume with the
data stream's position, fault injection, periodic eval, keep-best).
Counterpart of ``asltpu/train/loop.py``.

With a ``mesh`` (:func:`asltpu_torch.dist.mesh.make_mesh`) the step is
the JAX step under GSPMD: every rank takes the same global batch and keeps
its rows; BatchNorm takes the global batch's statistics and dropout and
augmentation draw for the global batch
(:func:`asltpu_torch.models.common.data_parallel`); the gradients are
averaged over the data group by one all-reduce before the clip, which
counts each sharded parameter's slices once over the model group; the
metrics are the global batch's. A module sharded over the model axis
(:func:`asltpu_torch.dist.tp.tp_shard_module`) runs its own collectives.
Rank 0 alone writes checkpoints and metrics.

The train state owns the module (fp32 parameters and BN buffers, on its
device), the optimizer with its schedule, and the ``torch.Generator`` that
dropout and augmentation draw from; a checkpoint saves all four, so a
resumed run continues the one that was cut. The step mutates the state in
place and returns it with its metrics, as 0-d tensors on the device (the
loop reads them only when it logs).

On a CUDA batch with ``pp_cfg.use_pallas`` the step's preprocess launches
the hand-written rgb kernel (``asltpu_torch.ops.preprocess_kernels``) on the
uint8 batch before the autograd graph begins: its output needs no
gradient.

A model with more than one input (``two_stream``: clip and landmarks)
takes its batch as a tuple: element 0 is the RGB input, preprocessed (or
augmented) as above, and the others go to the module as they are, as the
JAX step takes them.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from asltpu_torch.config import PreprocessConfig, TrainConfig
from asltpu_torch.dist.mesh import (
    Mesh,
    all_reduce_data,
    average_gradients,
    make_mesh,
    replicate,
    shard_batch,
)
from asltpu_torch.dist.multihost import is_main_process, process_count
from asltpu_torch.dist.tp import is_tp_sharded, tp_placements, tp_shard_module
from asltpu_torch.models.common import data_parallel
from asltpu_torch.ops.preprocess import preprocess_clip
from asltpu_torch.utils.profiling import span

Metrics = Dict[str, torch.Tensor]
Batch = Union[torch.Tensor, Tuple[torch.Tensor, ...]]


@dataclasses.dataclass
class TrainState:
    step: int
    module: nn.Module
    optimizer: torch.optim.AdamW
    schedule: torch.optim.lr_scheduler.LambdaLR
    generator: torch.Generator
    # The layout the module is trained in (None: one process); a checkpoint
    # gathers its tensor-parallel shards.
    mesh: Optional[Mesh] = None

    @property
    def device(self) -> torch.device:
        return next(self.module.parameters()).device


class FaultInjected(RuntimeError):
    """Raised by the train loop at ``TrainConfig.fault_inject_step`` to test
    checkpoint-resume."""


def lr_factor(cfg: TrainConfig) -> Callable[[int], float]:
    """optax's ``warmup_cosine_decay_schedule(init_value=0, peak_value=lr,
    warmup_steps, decay_steps=max(num_steps, warmup_steps + 1))`` over the
    peak: linear from 0 over the warmup, then a cosine to 0 at
    ``decay_steps``; read at the count of updates made before this one, so
    the first update has lr 0."""
    warm = cfg.warmup_steps
    cosine_steps = max(cfg.num_steps, warm + 1) - warm

    def factor(count: int) -> float:
        if count < warm:
            return count / warm
        c = min(count - warm, cosine_steps)
        return 0.5 * (1.0 + math.cos(math.pi * c / cosine_steps))

    return factor


def make_optimizer(params: Iterable[torch.Tensor], cfg: TrainConfig
                   ) -> Tuple[torch.optim.AdamW, torch.optim.lr_scheduler.LambdaLR]:
    """AdamW (b1 0.9, b2 0.999, eps 1e-8, decoupled weight decay on every
    parameter, BN scale and bias included, as optax's ``adamw`` with no
    mask) under :func:`lr_factor`. The global-norm clip that optax chains
    before it is :func:`clip_by_global_norm`, applied by the step."""
    opt = torch.optim.AdamW(params, lr=cfg.learning_rate, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=cfg.weight_decay)
    return opt, torch.optim.lr_scheduler.LambdaLR(opt, lr_factor(cfg))


def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float,
                        sharded: Optional[List[bool]] = None,
                        mesh: Optional[Mesh] = None) -> torch.Tensor:
    """optax's ``clip_by_global_norm``, in place: every gradient scaled by
    ``max_norm / ‖g‖`` where the global norm ``‖g‖ ≥ max_norm``, untouched
    below it (no epsilon in the denominator, unlike
    ``torch.nn.utils.clip_grad_norm_``). Returns ‖g‖ before the clip, as a
    0-d tensor, without waiting for the device.

    Under tensor parallelism ``sharded`` marks the gradients that are this
    rank's slice of a parameter: their squared norms are summed over the
    model group of ``mesh``, the others (whole on every rank) counted
    once, so ‖g‖ is the whole model's."""
    norms = torch.stack(torch._foreach_norm(grads))
    if sharded is None or not any(sharded):
        norm = torch.linalg.vector_norm(norms)
    else:
        import torch.distributed as dist

        mask = torch.tensor(sharded, device=norms.device)
        sq = norms * norms
        part = sq[mask].sum()
        dist.all_reduce(part, group=mesh.model_group)
        norm = torch.sqrt(sq[~mask].sum() + part)
    torch._foreach_mul_(grads, torch.clamp(max_norm / norm, max=1.0))
    return norm


def create_train_state(module: nn.Module, cfg: TrainConfig, seed: int = 0,
                       mesh: Optional[Mesh] = None) -> TrainState:
    """The initial state of ``module`` (fp32 parameters on their device, as
    ``asltpu_torch.api.build_trainable`` makes it): step 0, fresh optimizer
    and schedule, and a generator on the module's device seeded with
    ``seed`` (the same on every rank). A module to train tensor-parallel is
    sharded (``tp_shard_module``) before this, so the AdamW moments are
    built sharded; ``mesh`` is the layout it trains in."""
    params = list(module.parameters())
    bad = sorted({str(p.dtype) for p in params if p.dtype != torch.float32})
    if bad:
        raise ValueError(f"training needs fp32 master parameters, found {bad}: build the "
                         "module with asltpu_torch.api.build_trainable, not load_model")
    opt, schedule = make_optimizer(params, cfg)
    gen = torch.Generator(params[0].device).manual_seed(seed)
    return TrainState(step=0, module=module, optimizer=opt, schedule=schedule, generator=gen,
                      mesh=mesh)


def softmax_ce(logits: torch.Tensor, labels: torch.Tensor, smoothing: float) -> torch.Tensor:
    """Mean cross-entropy in fp32 on the logits, against one-hot labels
    smoothed to ``(1 − s)·onehot + s/C`` (a label −1 is a zero row, as
    ``jax.nn.one_hot`` makes it)."""
    num_classes = logits.shape[-1]
    onehot = (labels.long()[:, None] == torch.arange(num_classes, device=logits.device)).float()
    if smoothing > 0:
        onehot = onehot * (1.0 - smoothing) + smoothing / num_classes
    logp = F.log_softmax(logits.float(), dim=-1)
    return -(onehot * logp).sum(dim=-1).mean()


def _check_augment(pp_cfg: Optional[PreprocessConfig], augment) -> bool:
    """Whether the step augments; yuv420 staging with augment raises."""
    enabled = augment is not None and getattr(augment, "enabled", False)
    if pp_cfg is not None and pp_cfg.staging_format == "yuv420" and enabled:
        raise ValueError(
            "yuv420 staging is an inference/serving wire optimization; "
            "train-time augmentation needs RGB staged frames (and spatial "
            "slack) — use staging_format='rgb' for training with augment"
        )
    return enabled


def _split(batch_in: Batch) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """A batch → (its RGB input, the module's other inputs): a tuple's
    element 0 and the rest, or a tensor and nothing."""
    if isinstance(batch_in, (tuple, list)):
        return batch_in[0], tuple(batch_in[1:])
    return batch_in, ()


def _sharded_mask(module: nn.Module) -> List[bool]:
    """Per parameter of ``module`` (in ``parameters()`` order): whether it
    is a tensor-parallel slice."""
    if not is_tp_sharded(module):
        return [False] * len(list(module.parameters()))
    return [d is not None for d in tp_placements(module).values()]


def make_step_fn(train_cfg: TrainConfig, pp_cfg: Optional[PreprocessConfig] = None,
                 augment=None, mesh: Optional[Mesh] = None
                 ) -> Callable[[TrainState, Batch, torch.Tensor], Tuple[TrainState, Metrics]]:
    """The train step ``(state, batch_in, labels) → (state, metrics)`` on
    tensors already on the state's device. With ``pp_cfg`` it takes staged
    uint8 frames and preprocesses them (the augmented variant,
    :mod:`asltpu_torch.ops.augment`, when ``augment`` is an enabled
    ``AugmentConfig``), else it takes the model's input as is. A tuple
    ``batch_in`` is (RGB input, other inputs...): only element 0 is
    preprocessed or augmented (a flip or crop is not mirrored into
    landmarks). Metrics: ``loss``, ``top1`` (share of the batch) and
    ``grad_norm`` (before the clip).

    With ``mesh`` the batch is this rank's rows of the global batch
    (:func:`make_train_step` cuts them), and the step and its metrics are
    the global batch's (module docstring).

    Spans, in order: ``train.preprocess``, ``train.forward`` (module and
    loss), ``train.backward`` (``zero_grad`` and backward),
    ``train.optimizer`` (gradient averaging, clip, AdamW, schedule,
    metrics)."""
    augmenting = _check_augment(pp_cfg, augment)

    def step_fn(state: TrainState, batch_in: Batch, labels: torch.Tensor):
        module, gen = state.module, state.generator
        batch_in, extras = _split(batch_in)
        with data_parallel(mesh):
            with span("train.preprocess"), torch.no_grad():
                if pp_cfg is None:
                    clip = batch_in
                elif augmenting:
                    from asltpu_torch.ops.augment import augment_preprocess_clip

                    clip = augment_preprocess_clip(gen, batch_in, pp_cfg, augment)
                else:
                    clip = preprocess_clip(batch_in, pp_cfg)
            with span("train.forward"):
                logits = module(clip, *extras, train=True, generator=gen)
                loss = softmax_ce(logits, labels, train_cfg.label_smoothing)
            with span("train.backward"):
                state.optimizer.zero_grad(set_to_none=True)
                loss.backward()
        with span("train.optimizer"):
            params = list(module.parameters())
            grads = [p.grad for p in params if p.grad is not None]
            sharded = None
            if mesh is not None:
                average_gradients(grads, mesh)
                if mesh.model_size > 1:
                    sharded = [m for p, m in zip(params, _sharded_mask(module))
                               if p.grad is not None]
            grad_norm = clip_by_global_norm(grads, train_cfg.grad_clip_norm, sharded, mesh)
            state.optimizer.step()
            state.schedule.step()
            state.step += 1
            with torch.no_grad():
                top1 = (logits.argmax(-1) == labels).float().mean()
                loss = loss.detach()
                if mesh is not None and mesh.data_group is not None:
                    loss, top1 = all_reduce_data(mesh, torch.stack([loss, top1])) / mesh.data_size
        return state, {"loss": loss, "top1": top1, "grad_norm": grad_norm.detach()}

    return step_fn


def to_device(device: torch.device, x) -> Batch:
    """A host array or a tensor (or a tuple of them) → a tensor (tuple) on
    ``device``."""
    if isinstance(x, (tuple, list)):
        return tuple(to_device(device, a) for a in x)
    t = torch.from_numpy(np.ascontiguousarray(x)) if isinstance(x, np.ndarray) else x
    return t.to(device, non_blocking=True)


def make_train_step(train_cfg: TrainConfig, pp_cfg: Optional[PreprocessConfig] = None,
                    augment=None, mesh: Optional[Mesh] = None):
    """:func:`make_step_fn`'s step for batches from anywhere: numpy arrays
    or tensors on another device are moved to the state's device first.
    With ``mesh`` it takes the GLOBAL batch, as the JAX step does, and
    keeps this rank's rows (:func:`asltpu_torch.dist.mesh.shard_batch`)."""
    step_fn = make_step_fn(train_cfg, pp_cfg, augment, mesh)

    def train_step(state: TrainState, batch_in, labels):
        dev = state.device
        if mesh is not None:
            batch_in, labels = shard_batch(mesh, batch_in), shard_batch(mesh, labels)
        return step_fn(state, to_device(dev, batch_in), to_device(dev, labels))

    return train_step


def make_eval_step(pp_cfg: Optional[PreprocessConfig] = None, mesh: Optional[Mesh] = None):
    """``(state, batch_in, labels) → (top-1 hits, top-5 hits)`` as 0-d int
    tensors: the module in inference (running statistics, no dropout,
    whatever its ``training`` flag) on the preprocessed batch (a tuple as
    the train step takes it). A pad row with label −1 matches no class, so
    it adds no hit. With ``mesh`` it takes the global batch, scores this
    rank's rows and sums the hits over the data group: the global batch's
    counts on every rank."""
    def eval_fn(state: TrainState, batch_in, labels) -> Tuple[torch.Tensor, torch.Tensor]:
        dev = state.device
        if mesh is not None:
            batch_in, labels = shard_batch(mesh, batch_in), shard_batch(mesh, labels)
        (batch_in, extras), labels = _split(to_device(dev, batch_in)), to_device(dev, labels).long()
        with torch.no_grad():
            clip = preprocess_clip(batch_in, pp_cfg) if pp_cfg is not None else batch_in
            logits = state.module(clip, *extras, train=False)
            top1 = (logits.argmax(-1) == labels).sum()
            k = min(5, logits.shape[-1])
            top5 = (logits.topk(k, dim=-1).indices == labels[:, None]).any(-1).sum()
            if mesh is not None and mesh.data_group is not None:
                top1, top5 = all_reduce_data(mesh, torch.stack([top1, top5]))
        return top1, top5

    return eval_fn


def train(
    module: nn.Module,
    train_cfg: TrainConfig,
    batches: Iterable[Tuple[Any, Any]],
    pp_cfg: Optional[PreprocessConfig] = None,
    state: Optional[TrainState] = None,
    metric_writer: Optional[Callable[[int, Dict[str, float]], None]] = None,
    augment=None,
    eval_batches: Optional[Callable[[], Iterable[Tuple[Any, Any]]]] = None,
    resumable_iter=None,
    mesh: Optional[Mesh] = None,
) -> TrainState:
    """Run the training loop over an iterable of ``(batch_in, labels)``
    (numpy arrays or tensors; ``batch_in`` a tuple ``(clip, landmarks)``
    for ``two_stream``).

    Without ``state`` it starts from ``module`` with
    :func:`create_train_state` (``train_cfg.seed``) and resumes from the
    latest checkpoint under ``train_cfg.ckpt_dir`` where there is one. Every
    ``ckpt_every`` steps it saves the state (pruned to ``ckpt_keep``) and,
    with ``resumable_iter`` (the
    :class:`~asltpu_torch.data.loader.ResumableIterator` under
    ``batches``), the data stream's position, so a resumed run continues the
    stream. ``eval_batches`` (a zero-argument callable yielding batches)
    runs every ``eval_every`` steps and at the end, and with ``keep_best``
    keeps ``ckpt_dir/best/``. At ``fault_inject_step`` it raises
    :class:`FaultInjected`. ``batches.close()``, where it has one, runs on
    every exit.

    In a world of more than one rank (``asltpu_torch.dist.init_distributed``)
    ``mesh`` defaults to :func:`~asltpu_torch.dist.mesh.make_mesh` over all
    of it (data parallelism), as the JAX loop builds its mesh over all
    devices. Every rank runs this with the same ``batches`` (global
    batches) and ``train_cfg``; a fresh state starts from rank 0's weights
    (``replicate``), sharded over the model axis where it has more than
    one rank (``tp_shard_module``), and a resume re-shards the single-device
    checkpoint. Rank 0 alone writes checkpoints and calls
    ``metric_writer``.
    """
    from asltpu_torch import ckpt

    if state is None:
        if mesh is None and process_count() > 1:
            mesh = make_mesh()
        if mesh is not None and not is_tp_sharded(module):
            replicate(module, mesh)
            tp_shard_module(module, mesh)
        state = create_train_state(module, train_cfg, train_cfg.seed, mesh=mesh)
        state = ckpt.try_restore_train_state(train_cfg.ckpt_dir, state)
    elif state.module is not module:
        raise ValueError("state holds another module than the one given")
    elif mesh is None:
        mesh = state.mesh
    if not is_main_process():
        metric_writer = None
    step_fn = make_train_step(train_cfg, pp_cfg, augment, mesh)
    eval_fn = make_eval_step(pp_cfg, mesh) if eval_batches is not None else None

    def run_eval(step: int) -> Dict[str, float]:
        n = top1 = top5 = 0
        for batch_in, labels in eval_batches():
            t1, t5 = eval_fn(state, batch_in, labels)
            top1 += int(t1)
            top5 += int(t5)
            # Only real rows count: pad rows carry label -1. Every rank sees
            # the global batch, so n is the global count.
            n += int((torch.as_tensor(labels) >= 0).sum())
        metrics = {"eval_top1": top1 / max(n, 1), "eval_top5": top5 / max(n, 1),
                   "eval_clips": float(n)}
        if train_cfg.keep_best and train_cfg.ckpt_dir:
            ckpt.save_best_state(train_cfg.ckpt_dir, state, metrics["eval_top1"])
        if metric_writer:
            metric_writer(step, metrics)
        return metrics

    start = state.step
    last_eval_step = -1
    t0 = time.perf_counter()
    try:
        for i, (batch_in, labels) in enumerate(batches):
            step = start + i
            if step >= train_cfg.num_steps:
                break
            if step == train_cfg.fault_inject_step:
                raise FaultInjected(f"injected fault at step {step}")
            state, metrics = step_fn(state, batch_in, labels)
            if (step + 1) % train_cfg.log_every == 0:
                m = {k: float(v) for k, v in metrics.items()}
                m["steps_per_sec"] = train_cfg.log_every / (time.perf_counter() - t0)
                t0 = time.perf_counter()
                if metric_writer:
                    metric_writer(step + 1, m)
            if eval_fn is not None and (step + 1) % train_cfg.eval_every == 0:
                run_eval(step + 1)
                last_eval_step = step + 1
            if (step + 1) % train_cfg.ckpt_every == 0:
                # i + 1 batches consumed since this call began.
                data_state = (resumable_iter.state_for(i + 1)
                              if resumable_iter is not None else None)
                ckpt.save_train_state(train_cfg.ckpt_dir, state, keep=train_cfg.ckpt_keep,
                                      data_state=data_state)
    finally:
        # An early exit must stop a Prefetcher's thread, or it stays blocked
        # holding host and device batches for the life of the process.
        close = getattr(batches, "close", None)
        if callable(close):
            close()
    # The final eval, unless the periodic one just ran at this step.
    if eval_fn is not None and state.step != last_eval_step:
        run_eval(state.step)
    return state
