"""Weights and BatchNorm statistics made by the harness from the seed, on
the device, and handed to the program and to the reference alike."""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Sequence, Tuple

import torch
from torch import nn

Spec = Tuple[str, Tuple[int, ...], str, float]


def sub_seed(seed: int, stream: int) -> int:
    """An independent seed for one stream of a run's draws."""
    return (seed * 1_000_003 + stream * 7_919) % (2**63 - 1)


def make_params(specs: Sequence[Spec], seed: int, device) -> Dict[str, torch.Tensor]:
    """float32 tensors on ``device`` for ``specs`` (name, shape, init,
    scale): "normal" leaves from one ``randn`` call, "uniform" ones (in
    ±scale) from one ``rand`` call, both of a generator on the device
    seeded with ``seed``; "ones" and "zeros" as named, "const" at scale."""
    g = torch.Generator(device).manual_seed(seed)
    out: Dict[str, torch.Tensor] = {}
    for kind, draw in (("normal", torch.randn), ("uniform", torch.rand)):
        group = [s for s in specs if s[2] == kind]
        total = sum(math.prod(s[1]) for s in group)
        flat = draw(total, generator=g, device=device)
        if kind == "uniform":
            flat.mul_(2.0).sub_(1.0)
        views, offset = [], 0
        for name, shape, _, _ in group:
            n = math.prod(shape)
            views.append(flat[offset:offset + n].view(shape))
            offset += n
        torch._foreach_mul_(views, [s[3] for s in group])
        out.update({s[0]: v for s, v in zip(group, views)})
    for name, shape, kind, value in specs:
        if kind in ("ones", "zeros", "const"):
            out[name] = torch.full(shape, {"ones": 1.0, "zeros": 0.0}.get(kind, value),
                                   device=device)
    return out


def load_into(module: nn.Module, params: Dict[str, torch.Tensor]) -> None:
    """Copy ``params`` into ``module``'s parameters and buffers of the same
    names, each in its own dtype. Every leaf of the module (but BN's step
    counters) must be given, and every given tensor must land."""
    own = {k: v for k, v in module.state_dict(keep_vars=True).items()
           if not k.endswith("num_batches_tracked")}
    missing, extra = sorted(set(own) - set(params)), sorted(set(params) - set(own))
    if missing or extra:
        raise ValueError(f"the program's leaves differ from the reference's: "
                         f"missing {missing[:5]}, unknown {extra[:5]}")
    with torch.no_grad():
        for k, t in own.items():
            if tuple(t.shape) != tuple(params[k].shape):
                raise ValueError(f"{k}: program {tuple(t.shape)}, reference "
                                 f"{tuple(params[k].shape)}")
            t.copy_(params[k])


def port_overrides(name: str, config: dict) -> dict:
    """The keys of a configuration file that are fields of the program's
    config class, as ``get_config`` takes them (lists made tuples)."""
    from asltpu_torch.config import CONFIG_REGISTRY

    fields = {f.name for f in dataclasses.fields(CONFIG_REGISTRY[name])} - {"name"}

    def tuples(v):
        if isinstance(v, list):
            return tuple(tuples(x) for x in v)
        if isinstance(v, dict):
            return {k: tuples(x) for k, x in v.items()}
        return v

    return {k: tuples(v) for k, v in config.items() if k in fields}


def leaf_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    names = list(tensors)
    norms = torch.stack(torch._foreach_norm([tensors[n].float() for n in names]))
    return dict(zip(names, norms.tolist()))

