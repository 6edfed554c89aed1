"""Tensor parallelism over the mesh's ``model`` axis: Megatron placements
for the transformer head's blocks and the fusion model's cross-attention.
Counterpart of ``asltpu/dist/tp.py``.

The JAX package annotates the parameters and lets GSPMD insert the
collectives; here each rank holds its slice of the sharded parameters
(:func:`tp_shard_module` slices them in place), and the sharded modules
reach the model group through Megatron's pair of autograd functions:

  - :func:`copy_to_model_parallel` at the input of a region: the identity
    forward, a sum of every rank's gradient backward;
  - :func:`reduce_from_model_parallel` at its output: a sum of every rank's
    partial result forward (in fp32, rounded once to the input's dtype),
    the identity backward; the whole bias is added once after it.

Placements, matched by module, never by a name alone:

  - the attention of an ``EncoderBlock`` (``attn``) and each fusion
    ``CrossAttentionBlock``'s ``a_from_b_attn`` / ``b_from_a_attn``:
    ``in_proj_weight`` / ``in_proj_bias`` keep this rank's heads' rows of
    each of the q, k and v thirds (the fused ``[3d, d]`` matrix is q;k;v);
    ``out_proj.weight`` keeps this rank's input columns (the same heads),
    ``out_proj.bias`` is whole;
  - an ``EncoderBlock``'s ``mlp1`` keeps its output rows and their bias,
    its ``mlp2`` its input columns, with the whole bias;
  - everything else is whole on every rank, the fusion blocks' ``*_fc1``
    / ``*_fc2`` and any ``mlp1`` / ``mlp2`` outside an ``EncoderBlock``
    included.

The AdamW moments of a sharded parameter are as sharded as it is (the
optimizer is built on the sliced parameters); a checkpoint gathers
parameters and moments to the single-device layout
(:func:`tp_gather_state_dict`, :func:`tp_gather_optimizer_state`) and a
restore slices them again, so a checkpoint moves between layouts.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

from asltpu_torch.dist.mesh import Mesh

# Sharded dim of each parameter, per kind of site.
_RULES = {
    "attn": {"in_proj_weight": 0, "in_proj_bias": 0, "out_proj.weight": 1,
             "out_proj.bias": None},
    "mlp1": {"weight": 0, "bias": 0},
    "mlp2": {"weight": 1, "bias": None},
}
_QKV = ("in_proj_weight", "in_proj_bias")


def tp_mesh(module: nn.Module) -> Optional[Mesh]:
    """The mesh a module was sharded over by :func:`tp_shard_module`, or
    None where it holds its whole parameters."""
    return getattr(module, "tp_mesh", None)


def is_tp_sharded(module: nn.Module) -> bool:
    return any(tp_mesh(m) is not None for m in module.modules())


def _join(prefix: str, name: str) -> str:
    return f"{prefix}.{name}" if prefix else name


def _sites(module: nn.Module) -> Iterator[Tuple[str, str, nn.Module]]:
    """(path, kind, submodule) of every submodule the placements shard."""
    # The model modules import this one.
    from asltpu_torch.models.fusion import CrossAttentionBlock
    from asltpu_torch.models.temporal import EncoderBlock

    for path, m in module.named_modules():
        if isinstance(m, EncoderBlock):
            yield _join(path, "attn"), "attn", m.attn
            yield _join(path, "mlp1"), "mlp1", m.mlp1
            yield _join(path, "mlp2"), "mlp2", m.mlp2
        elif isinstance(m, CrossAttentionBlock):
            for name, child in m.named_children():
                if name.endswith("_attn") and isinstance(child, nn.MultiheadAttention):
                    yield _join(path, name), "attn", child


def tp_placements(module: nn.Module) -> Dict[str, Optional[int]]:
    """``{parameter name: the dim sharded over the model axis, or None}``
    for every parameter of ``module``: the counterpart of
    ``tp_variable_shardings``. A module without transformer or
    cross-attention blocks comes out all None (replicated)."""
    out: Dict[str, Optional[int]] = {n: None for n, _ in module.named_parameters()}
    for path, kind, _ in _sites(module):
        for name, dim in _RULES[kind].items():
            out[_join(path, name)] = dim
    return out


def validate_tp_divisibility(num_heads: int, d_model: int, mlp_ratio: int,
                             model_parallel: int) -> None:
    """Raise ValueError unless the head's shapes divide the model axis."""
    if model_parallel <= 1:
        return
    if num_heads % model_parallel:
        raise ValueError(
            f"num_heads={num_heads} not divisible by "
            f"model_parallel={model_parallel}"
        )
    if (d_model * mlp_ratio) % model_parallel:
        raise ValueError(
            f"mlp width {d_model * mlp_ratio} not divisible by "
            f"model_parallel={model_parallel}"
        )


# The families whose attention :func:`tp_shard_module` places.
SHARDED = ("resnet_transformer", "two_stream")


def validate_config_tp(cfg, model_parallel: int) -> None:
    """:func:`validate_tp_divisibility` for a model config, by the fields it
    has: the heads where it has attention, the MLP width where its MLP is
    sharded (``mlp_ratio``: the transformer head; the fusion blocks' MLPs
    stay whole). A config without attention has nothing to shard; one with
    attention that no placement shards (:data:`SHARDED` lists those that
    have them) is refused by name."""
    heads = getattr(cfg, "num_heads", None)
    if heads is None or model_parallel <= 1:
        return
    if cfg.name not in SHARDED:
        raise ValueError(f"tensor parallelism does not shard {cfg.name}: only "
                         f"{', '.join(SHARDED)} have placements")
    validate_tp_divisibility(heads, cfg.d_model, getattr(cfg, "mlp_ratio", 1), model_parallel)


def _local(t: torch.Tensor, name: str, dim: int, mesh: Mesh) -> torch.Tensor:
    """This rank's slice of the whole tensor ``t`` (a fused q;k;v tensor:
    its rows of each third), as a tensor of its own."""
    r, n = mesh.model_rank, mesh.model_size
    if name.endswith(_QKV):
        return torch.cat([third.chunk(n)[r] for third in t.chunk(3)])
    return t.chunk(n, dim=dim)[r].clone(memory_format=torch.contiguous_format)


def _whole(parts: List[torch.Tensor], name: str, dim: int) -> torch.Tensor:
    """The whole tensor from every rank's slice (rank order)."""
    if name.endswith(_QKV):
        thirds = [p.chunk(3) for p in parts]
        return torch.cat([torch.cat([th[i] for th in thirds]) for i in range(3)])
    return torch.cat(parts, dim=dim)


def _gather(t: torch.Tensor, name: str, dim: int, mesh: Mesh) -> torch.Tensor:
    parts = [torch.empty_like(t) for _ in range(mesh.model_size)]
    dist.all_gather(parts, t.contiguous(), group=mesh.model_group)
    return _whole(parts, name, dim)


def _sharded(module: nn.Module, mesh: Optional[Mesh]) -> Dict[str, int]:
    if mesh is None or mesh.model_size == 1 or not is_tp_sharded(module):
        return {}
    return {n: d for n, d in tp_placements(module).items() if d is not None}


def tp_shard_module(module: nn.Module, mesh: Mesh) -> nn.Module:
    """Slice ``module``'s sharded parameters to this rank's part, in place,
    and bind its sharded submodules to ``mesh``'s model group. Build the
    optimizer after this. Raises ValueError where the heads or the MLP
    width do not divide the model axis."""
    if mesh.model_size == 1:
        return module
    if is_tp_sharded(module):
        raise ValueError("module is already tensor-parallel")
    sites = list(_sites(module))
    for _, kind, m in sites:
        if kind == "attn":
            validate_tp_divisibility(m.num_heads, m.embed_dim, 1, mesh.model_size)
        elif kind == "mlp1" and m.out_features % mesh.model_size:
            raise ValueError(f"mlp width {m.out_features} not divisible by "
                             f"model_parallel={mesh.model_size}")
    params = dict(module.named_parameters())
    with torch.no_grad():
        for name, dim in tp_placements(module).items():
            if dim is not None:
                params[name].data = _local(params[name].data, name, dim, mesh)
    for _, _, m in sites:
        m.tp_mesh = mesh
    return module


def tp_gather_state_dict(module: nn.Module, mesh: Mesh) -> Dict[str, torch.Tensor]:
    """``module.state_dict()`` in the single-device layout: each sharded
    parameter gathered over the model group (a collective: every rank of
    the group calls it)."""
    sd = module.state_dict()
    for name, dim in _sharded(module, mesh).items():
        sd[name] = _gather(sd[name], name, dim, mesh)
    return sd


def tp_shard_state_dict(module: nn.Module, sd: Dict[str, torch.Tensor],
                        mesh: Mesh) -> Dict[str, torch.Tensor]:
    """A single-device state dict cut to this rank's slices of ``module``'s
    sharded parameters, for ``module.load_state_dict``."""
    sd = dict(sd)
    for name, dim in _sharded(module, mesh).items():
        sd[name] = _local(sd[name], name, dim, mesh)
    return sd


_MOMENTS = ("exp_avg", "exp_avg_sq")


def _optimizer_names(module: nn.Module, optimizer: torch.optim.Optimizer) -> List[str]:
    """The parameter name at each index of ``optimizer.state_dict()``."""
    name_of = {id(p): n for n, p in module.named_parameters()}
    return [name_of[id(p)] for g in optimizer.param_groups for p in g["params"]]


def _map_moments(module, optimizer, sd, mesh, fn):
    sharded = _sharded(module, mesh)
    if not sharded:
        return sd
    names = _optimizer_names(module, optimizer)
    state = {}
    for i, st in sd["state"].items():
        st = dict(st)
        name = names[i]
        if name in sharded:
            for k in _MOMENTS:
                if k in st:
                    st[k] = fn(st[k], name, sharded[name], mesh)
        state[i] = st
    return {**sd, "state": state}


def tp_gather_optimizer_state(module: nn.Module, optimizer: torch.optim.Optimizer,
                              mesh: Mesh) -> dict:
    """``optimizer.state_dict()`` with the AdamW moments of sharded
    parameters gathered to the single-device layout (a collective)."""
    return _map_moments(module, optimizer, optimizer.state_dict(), mesh, _gather)


def tp_shard_optimizer_state(module: nn.Module, optimizer: torch.optim.Optimizer,
                             sd: dict, mesh: Mesh) -> dict:
    """A single-device optimizer state dict cut to this rank's slices."""
    return _map_moments(module, optimizer, sd, mesh, _local)


def _sum_fp32(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of every rank's ``x`` over ``group``, accumulated in fp32
    and rounded once to ``x``'s dtype."""
    y = x.to(torch.float32, copy=True)
    dist.all_reduce(y, group=group)
    return y.to(x.dtype)


class _CopyToModelParallel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return _sum_fp32(grad, ctx.group), None


class _ReduceFromModelParallel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        return _sum_fp32(x, group)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return grad, None


def copy_to_model_parallel(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The input of a tensor-parallel region: ``x`` forward, the sum over
    the model group of its gradient backward."""
    return _CopyToModelParallel.apply(x, mesh.model_group)


def reduce_from_model_parallel(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The output of a tensor-parallel region: the sum over the model group
    of every rank's partial ``x`` forward, the gradient as it is backward."""
    return _ReduceFromModelParallel.apply(x, mesh.model_group)
