"""The (data, model) layout of the ranks of a ``torch.distributed`` world,
and the data-parallel helpers. Counterpart of ``asltpu/dist/mesh.py``.

Where the JAX package lays a ``jax.sharding.Mesh`` over devices and lets
GSPMD insert the collectives, the port runs one process per rank and
places them itself: a :class:`Mesh` holds this rank's data group (the
ranks that hold the same parameters and split the batch) and its model
group (the ranks that split the transformer head's parameters, see
:mod:`asltpu_torch.dist.tp`). Rank ``r`` sits at data index ``r // M`` and
model index ``r % M`` of a world of ``D · M`` ranks, as the JAX mesh
reshapes its device list to ``(-1, model_parallel)``.

With no initialised process group, :func:`make_mesh` gives the one-rank
mesh, and every function here is the identity.
"""

from __future__ import annotations

import dataclasses
import datetime
from typing import Any, Optional

import torch
import torch.distributed as dist
from torch import nn

DATA_AXIS = "data"
MODEL_AXIS = "model"

# Every process group the port makes waits at most this long in a
# collective, so a missing peer raises instead of hanging.
DEFAULT_TIMEOUT_S = 300.0


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """This rank's place in a (data, model) layout: the sizes of both axes,
    its index on each, and the process group of each. A group is None where
    its axis has size 1 (:func:`make_mesh` makes none) or where there is no
    process group at all; the data-parallel collectives run wherever the
    data group is set, so a mesh built by hand over a one-rank group (the
    smoke run's one-rank NCCL check) runs them too."""

    data_size: int = 1
    model_size: int = 1
    data_rank: int = 0
    model_rank: int = 0
    data_group: Optional[Any] = None
    model_group: Optional[Any] = None

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.data_size, MODEL_AXIS: self.model_size}

    def __deepcopy__(self, memo) -> "Mesh":
        # Process groups are handles of the process, not data: a deep copy of
        # a module sharded over this mesh stays on it.
        return self


def make_mesh(model_parallel: int = 1, timeout_s: float = DEFAULT_TIMEOUT_S) -> Mesh:
    """The (data, model) mesh over the initialised world, ``model_parallel``
    ranks along ``model`` (1: pure data parallelism). Every rank of the
    world must call it, in the same order as any other group it makes.
    Raises ``ValueError`` unless ``model_parallel`` divides the world."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if model_parallel < 1 or world % model_parallel:
        raise ValueError(f"{world} devices not divisible by model_parallel={model_parallel}")
    if world == 1:
        return Mesh()
    rank, m = dist.get_rank(), model_parallel
    d = world // m
    timeout = datetime.timedelta(seconds=timeout_s)
    data_group = model_group = None
    if d > 1:
        if m == 1:
            data_group = dist.new_group(list(range(world)), timeout=timeout)
        else:
            for j in range(m):  # every rank makes every group, in one order
                g = dist.new_group([i * m + j for i in range(d)], timeout=timeout)
                if rank % m == j:
                    data_group = g
    if m > 1:
        for i in range(d):
            g = dist.new_group([i * m + j for j in range(m)], timeout=timeout)
            if rank // m == i:
                model_group = g
    return Mesh(data_size=d, model_size=m, data_rank=rank // m, model_rank=rank % m,
                data_group=data_group, model_group=model_group)


def shard_batch(mesh: Mesh, batch):
    """This rank's rows of a global batch (a tensor, a numpy array, or a
    tuple of them, as ``two_stream`` trains on ``(clip, landmarks)``): the
    ``data_rank``-th of ``data_size`` equal blocks of the leading axis."""
    if isinstance(batch, (tuple, list)):
        return tuple(shard_batch(mesh, b) for b in batch)
    if mesh.data_size == 1:
        return batch
    n = batch.shape[0]
    if n % mesh.data_size:
        raise ValueError(f"global batch {n} not divisible by the data axis "
                         f"({mesh.data_size} ranks)")
    k = n // mesh.data_size
    return batch[mesh.data_rank * k:(mesh.data_rank + 1) * k]


def gather_batch(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """The global batch of ``x`` (each rank's rows in rank order along the
    leading axis), gathered over the data group: sharded inference's
    logits. Not differentiable."""
    if mesh.data_size == 1:
        return x
    parts = [torch.empty_like(x) for _ in range(mesh.data_size)]
    dist.all_gather(parts, x.contiguous(), group=mesh.data_group)
    return torch.cat(parts)


def replicate(module: nn.Module, mesh: Mesh) -> nn.Module:
    """Broadcast rank 0's parameters and buffers to every rank of the
    world, in place, so the replicas start equal. Call it before
    :func:`asltpu_torch.dist.tp.tp_shard_module`: a sharded module's shards
    differ from rank to rank."""
    from asltpu_torch.dist.tp import is_tp_sharded

    if mesh.data_size * mesh.model_size == 1:
        return module
    if is_tp_sharded(module):
        raise ValueError("replicate a module before tp_shard_module, not after")
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, src=0)
    return module


class _AllReduceSum(torch.autograd.Function):
    """The sum over ``group`` of every rank's ``x``; the gradient of each
    rank's ``x`` is the sum of every rank's gradient of the result."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        g = grad.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Autograd-aware sum of ``x`` over ``group`` (BatchNorm's statistics
    of the global batch)."""
    return _AllReduceSum.apply(x, group)


def average_gradients(grads, mesh: Mesh) -> None:
    """Average the gradients over the data group, in place, with one
    all-reduce of their flattened concatenation."""
    if mesh.data_group is None or not grads:
        return
    flat = torch._utils._flatten_dense_tensors(grads)
    dist.all_reduce(flat, group=mesh.data_group)
    flat.div_(mesh.data_size)
    for g, f in zip(grads, torch._utils._unflatten_dense_tensors(flat, grads)):
        g.copy_(f)


def all_reduce_data(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the data group (a new tensor; ``x`` itself
    where there is no data group)."""
    if mesh.data_group is None:
        return x
    y = x.clone()
    dist.all_reduce(y, group=mesh.data_group)
    return y
