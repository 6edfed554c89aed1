"""Multi-process bring-up and each rank's share of the batch. Counterpart
of ``asltpu/dist/multihost.py``.

A ``torch.distributed`` world is one process per rank, on one host or
many: :func:`init_distributed` joins it (by an explicit address, or from
the environment ``torchrun`` sets), and :func:`asltpu_torch.dist.mesh.make_mesh`
lays the ranks out. Each rank feeds its own rows of the global batch.
"""

from __future__ import annotations

import datetime
import os
from typing import Any, Optional, Union

import torch
import torch.distributed as dist

from asltpu_torch.dist.mesh import DEFAULT_TIMEOUT_S, Mesh

_TORCHRUN_ENV = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> int:
    """Join the process group and return this process's rank.

    - Explicit arguments: a ``tcp://`` rendezvous at ``coordinator_address``
      (``host:port``; rank 0 listens there) of ``num_processes`` ranks, this
      one ``process_id``.
    - No arguments, ``torchrun``'s environment (``MASTER_ADDR``,
      ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``): an ``env://`` rendezvous.
    - Neither: one process; nothing is initialised and it returns 0.
    - Already initialised: the rank, and nothing else is done.

    ``backend`` defaults to ``nccl`` where a CUDA device is visible and
    ``gloo`` elsewhere; it never changes on its own (two ranks on one GPU
    must ask for ``gloo``: NCCL puts no two ranks of a communicator on one
    device). With ``nccl`` each rank takes the device ``LOCAL_RANK`` (else
    its rank) modulo the device count. Collectives of the default group
    wait at most ``timeout_s``, so a missing peer raises.

    Bring-up failures propagate: a rank that went on alone would train a
    replica of its own with wrong gradients.
    """
    if dist.is_initialized():
        return dist.get_rank()
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    timeout = datetime.timedelta(seconds=timeout_s)
    if coordinator_address or num_processes:
        if not coordinator_address or num_processes is None or process_id is None:
            raise ValueError("an explicit bring-up needs coordinator_address, "
                             "num_processes and process_id")
        url = (coordinator_address if "://" in coordinator_address
               else f"tcp://{coordinator_address}")
        kw = dict(init_method=url, world_size=num_processes, rank=process_id)
        rank = process_id
    elif all(os.environ.get(k) for k in _TORCHRUN_ENV):
        kw = dict(init_method="env://")
        rank = int(os.environ["RANK"])
    else:
        return 0
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank))
                              % torch.cuda.device_count())
    dist.init_process_group(backend, timeout=timeout, **kw)
    return dist.get_rank()


def process_count() -> int:
    """The number of ranks in the world (1 without a process group)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def is_main_process() -> bool:
    """Whether this process is rank 0 (or the only one): the rank that
    writes checkpoints and metrics."""
    return not dist.is_initialized() or dist.get_rank() == 0


def barrier() -> None:
    """Wait for every rank of the world (nothing without a process group)."""
    if dist.is_initialized():
        dist.barrier()


def local_batch_size(global_batch: int) -> int:
    """Per-process share of a global batch (must divide evenly)."""
    n = process_count()
    if global_batch % n:
        raise ValueError(
            f"global batch {global_batch} not divisible by process count {n}"
        )
    return global_batch // n


def assemble_global_batch(mesh: Mesh, local_batch: Any,
                          device: Union[None, str, torch.device] = None):
    """This rank's LOCAL batch (a tensor, a numpy array, or a tuple of
    them), moved to ``device`` (the card by default).

    Under JAX one array spans every process's rows; a torch
    data-parallel rank never holds the global batch: it computes on its
    own rows, and the collectives (BatchNorm's statistics, the gradient
    all-reduce) join the ranks. So assembling is placing the rows. The
    leading axis is ``global_batch / data_size`` on every rank."""
    from asltpu_torch.data.prefetch import resolve_device
    from asltpu_torch.train.loop import _on

    del mesh  # the rows are already this rank's
    return _on(resolve_device(device), local_batch)
