#!/usr/bin/env python3
"""What keeping BatchNorm fp32 under a bf16 compute dtype costs on the card.

    python3 tools/bn_dtype_ab.py

For each of the bench's cells of a 2D family (``mobilenet_gru``,
``resnet_transformer``), ``load_model`` (every BatchNorm fp32: bf16
input, fp32 parameters and statistics, one rounding) against the same
weights with every BatchNorm cast to bf16 (how the port ran before BN was
kept fp32), in one process on one card: device-only ``predict`` and
backbone times by CUDA events, in turns (fp32 BN, bf16 BN, bf16 BN, fp32
BN), each the median of 10 runs of 5 back-to-back calls after 5 warm-up
calls. Then one backbone call of each under ``torch.profiler``: the device
time of its BatchNorm kernels and their names, which show whether the
mixed-dtype BN takes another kernel than the bf16 one. Prints one JSON line
per cell, then the card's ``nvidia-smi`` line. Needs a CUDA device.
"""

from __future__ import annotations

import copy
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from asltpu_torch import api  # noqa: E402
from asltpu_torch import benchmark  # noqa: E402


def _bf16_bn(model: api.Model) -> api.Model:
    twin = copy.deepcopy(model)
    for m in twin.module.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.to(torch.bfloat16)
    return twin


def _bn_kernels(backbone, clip) -> dict:
    """Device time (ms) and launches of the device kernels of one backbone
    call whose names mention batch norm, by name."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        backbone(clip)
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        name = e.key.lower()
        if "CUDA" not in str(getattr(e, "device_type", "")):
            continue  # an operator on the host, not a kernel
        if "bn" in name or "batch_norm" in name or "batchnorm" in name:
            out[e.key[:120]] = {"ms": e.device_time_total / 1e3, "calls": e.count}
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("bn_dtype_ab: needs a CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda")
    clock = benchmark.Clock(device, reps=5, samples=10, warmup=5)
    for family, lane, batch in benchmark.CELLS:
        if family not in ("mobilenet_gru", "resnet_transformer"):
            continue
        model = api.load_model(family, seed=0, preprocess=dict(benchmark.LANES[lane]))
        twin = _bf16_bn(model)
        pp = model.cfg.preprocess
        x = torch.from_numpy(np.random.default_rng(1).integers(
            0, 256, (batch, pp.num_frames, *pp.staged_frame_shape), np.uint8)).to(device)
        runs = {"fp32_bn": [], "bf16_bn": []}
        backbone_runs = {"fp32_bn": [], "bf16_bn": []}
        stages = {"fp32_bn": benchmark.stage_fns(model, x),
                  "bf16_bn": benchmark.stage_fns(twin, x)}
        fns = {"fp32_bn": model.predict_fn(), "bf16_bn": twin.predict_fn()}
        with torch.inference_mode():
            for key in ("fp32_bn", "bf16_bn", "bf16_bn", "fp32_bn"):
                runs[key].append(clock.ms(lambda: fns[key](x)))
                backbone_runs[key].append(clock.ms(stages[key]["backbone"]))
            logits = {k: f(x).float() for k, f in fns.items()}
            kernels = {}
            for key, m in (("fp32_bn", model), ("bf16_bn", twin)):
                backbone, _ = benchmark.backbone_and_head(m.module)
                clip = torch.zeros(batch, pp.num_frames, pp.crop, pp.crop, 3,
                                   device=device, dtype=pp.out_torch_dtype)
                kernels[key] = _bn_kernels(backbone, clip)
        print(json.dumps({
            "cell": f"{family}/{lane}", "batch": batch,
            "predict_ms_runs": runs, "backbone_ms_runs": backbone_runs,
            "clips_per_s": {k: batch / min(v) * 1e3 for k, v in runs.items()},
            "max_logit_diff": float((logits["fp32_bn"] - logits["bf16_bn"]).abs().max()),
            "bn_kernels": kernels, "timer": clock.source,
        }), flush=True)
        del model, twin, x, fns, stages
        torch.cuda.empty_cache()
    print(benchmark.card_identity()["nvidia_smi"], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
