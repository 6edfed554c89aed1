"""asltpu_torch.dist — data and tensor parallelism over
``torch.distributed`` process groups. Counterpart of ``asltpu/dist/``.

One process per rank (``torchrun``, or :func:`init_distributed` with an
address); :func:`make_mesh` lays the ranks out as (data, model). The
train loop (``asltpu_torch.train.loop``, its ``mesh`` argument) splits
each global batch over ``data`` and averages gradients over it, with
BatchNorm's statistics taken over the global batch
(``asltpu_torch.models.common.batch_norm``); :mod:`asltpu_torch.dist.tp`
shards the transformer head and the fusion cross-attention over
``model``. Importing it starts nothing.
"""

from asltpu_torch.dist.mesh import (  # noqa: F401
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    gather_batch,
    make_mesh,
    replicate,
    shard_batch,
)
from asltpu_torch.dist.multihost import (  # noqa: F401
    assemble_global_batch,
    init_distributed,
    local_batch_size,
)
from asltpu_torch.dist.tp import (  # noqa: F401
    tp_gather_state_dict,
    tp_placements,
    tp_shard_module,
    validate_tp_divisibility,
)
