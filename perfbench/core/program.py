"""The program under test as the drivers build it (through its public
entry points), with the harness's weights, and the reference that
stands beside it."""

from __future__ import annotations

import importlib
from typing import Dict

import torch

from perfbench.core import weights


def reference(config: dict):
    """The plain reference module of the configuration's family."""
    return importlib.import_module(f"perfbench.reference.{config['reference']}")


def params_for(config: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    return weights.make_params(reference(config).param_specs(config),
                               weights.sub_seed(seed, 1), device)


def inference_model(config: dict, params: Dict[str, torch.Tensor], device):
    """``asltpu_torch.api.load_model`` of the configuration as the file
    states it, then the harness's weights copied in."""
    from asltpu_torch import api

    model = api.load_model(config["model"], device=device,
                           **weights.port_overrides(config["model"], config))
    weights.load_into(model.module, params)
    return model


def smooth_clips(n: int, config: dict, seed: int, device) -> torch.Tensor:
    """``n`` staged uint8 clips [n, T, Hs, Ws, 3] on ``device``: seeded noise
    at an eighth of the resolution, upsampled bilinearly so that frames
    have the structure of images rather than of noise, under a colour and
    a contrast of each clip's own, so that clips differ as scenes do."""
    pp = config["preprocess"]
    t, (hs, ws) = pp["num_frames"], pp["staging_size"]
    g = torch.Generator(device).manual_seed(weights.sub_seed(seed, 2))
    low = torch.rand((n, t * 3, max(hs // 8, 2), max(ws // 8, 2)), generator=g, device=device)
    up = torch.nn.functional.interpolate(low, size=(hs, ws), mode="bilinear",
                                         align_corners=False).view(n, t, 3, hs, ws)
    base = 0.2 + 0.6 * torch.rand((n, 1, 3, 1, 1), generator=g, device=device)
    contrast = 0.2 + 0.8 * torch.rand((n, 1, 1, 1, 1), generator=g, device=device)
    x = (base + contrast * (up - 0.5)).clamp(0.0, 1.0)
    return (x * 255).round().to(torch.uint8).permute(0, 1, 3, 4, 2).contiguous()


def logit_gap(program: torch.Tensor, ref: torch.Tensor) -> float:
    """The largest |program − reference| over every answer and class, as a
    share of the spread (standard deviation) of the reference's logits."""
    return float((program.float() - ref.float()).abs().max() / ref.float().std())


def flops_per_clip(ref, config: dict) -> float:
    """The reference's operations for one clip's forward, counted on the
    meta device."""
    from perfbench.core.arith import flops_of

    pp = config["preprocess"]
    x = torch.zeros((1, pp["num_frames"], *pp["staging_size"], 3), dtype=torch.uint8,
                    device="meta")
    params = {n: torch.zeros(s, device="meta") for n, s, *_ in ref.param_specs(config)}
    return float(flops_of(ref.forward, x, params, config))
