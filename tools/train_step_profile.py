#!/usr/bin/env python3
"""Where a train step's time goes, per family of the per-frame 2D models.

    python3 tools/train_step_profile.py                     # on the card
    python3 tools/train_step_profile.py --device cpu --small  # plumbing only

For each of ``mobilenet_gru``, ``resnet_transformer`` and ``two_stream``
(``--families``), ``build_trainable`` at full width (``--small``: the CPU
tests' sizes) and ``TrainConfig``'s batch of 8 from 256² RGB staged (with
seeded landmarks for ``two_stream``), the train step's parts in the order
``asltpu_torch.train.loop.make_step_fn`` runs them, each ended by a mark
on the stream (a CUDA event; on the CPU the host clock after a sync) and
by the host's clock when the host has enqueued it: preprocess (the rgb
kernel), the backbone's forward, the head's forward, the loss, the head's
backward (up to the hook on the backbone's output gradient), the
backbone's backward, and the clip + AdamW update. Each part's median over
``--steps`` steps after 3 warm-up steps (the host waits for each step's
end, so the device idles while the next step's first ops are enqueued);
where a part's device time is close to its host time, the host's enqueue
bounds it. Then, on the card, the step as ``make_step_fn`` runs it
back to back (CUDA events around ``--steps`` steps, after 3), and the same
steps under ``torch.profiler``: the device's busy share of a step (its
kernels' summed device time, user annotations apart, over the back-to-back
step's time) and the 12 kernels with the most device time. Prints one JSON
line per family, then the card's ``nvidia-smi`` line.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import statistics
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from asltpu_torch import api  # noqa: E402
from asltpu_torch.benchmark import card_identity  # noqa: E402
from asltpu_torch.config import TrainConfig  # noqa: E402
from asltpu_torch.data.synthetic import synthetic_landmarks  # noqa: E402
from asltpu_torch.models.temporal import GRUHead  # noqa: E402
from asltpu_torch.ops.preprocess import preprocess_clip  # noqa: E402
from asltpu_torch.train import loop  # noqa: E402

PARTS = ("preprocess", "backbone_fwd", "head_fwd", "loss", "head_bwd", "backbone_bwd",
         "clip_adamw")
SMALL = {  # the CPU tests' sizes (tests/test_torch_train_video.py, _fusion.py)
    "mobilenet_gru": {"num_classes": 7, "width_mult": 0.35, "gru_hidden": 32},
    "resnet_transformer": {"num_classes": 7, "d_model": 32, "num_heads": 4,
                           "num_tx_layers": 2},
    "two_stream": {"num_classes": 7, "width_mult": 0.35, "d_model": 64, "num_heads": 4},
}
SMALL_PP = {"num_frames": 4, "staging_size": (40, 48), "resize_short": 36, "crop": 32}


def _head(module, name):
    """The model's head as ``fn(feats, *extras, train, generator)``."""
    if name == "mobilenet_gru":
        return functools.partial(GRUHead.forward, module)
    if name == "two_stream":
        return module.fuse
    return module.head


class Marks:
    """Points on the device's stream (CUDA events on the card, the host
    clock after a sync on the CPU) and on the host's clock."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.points, self.host = [], []

    def mark(self) -> None:
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.points.append(ev)
        else:
            self.points.append(time.perf_counter())
        self.host.append(time.perf_counter())

    def ms(self):
        """The times between consecutive marks, ms: (device, host)."""
        host = [(b - a) * 1e3 for a, b in zip(self.host, self.host[1:])]
        if self.cuda:
            self.points[-1].synchronize()
            return [a.elapsed_time(b) for a, b in zip(self.points, self.points[1:])], host
        return [(b - a) * 1e3 for a, b in zip(self.points, self.points[1:])], host


def step_parts(state, name, pp, batch_in, labels, tcfg, marks: Marks) -> None:
    """One train step as ``make_step_fn``'s, with a mark after each part."""
    module, gen = state.module, state.generator
    frames, *extras = batch_in
    marks.mark()
    with torch.no_grad():
        clip = preprocess_clip(frames, pp)
    marks.mark()
    feats = module.backbone(clip, True)
    marks.mark()
    logits = _head(module, name)(feats, *extras, True, gen)
    marks.mark()
    loss = loop.softmax_ce(logits, labels, tcfg.label_smoothing)
    marks.mark()
    state.optimizer.zero_grad(set_to_none=True)
    feats.register_hook(lambda g: marks.mark())
    loss.backward()
    marks.mark()
    grads = [p.grad for p in module.parameters() if p.grad is not None]
    loop.clip_by_global_norm(grads, tcfg.grad_clip_norm)
    state.optimizer.step()
    state.schedule.step()
    state.step += 1
    marks.mark()


def profile_family(name, device, steps, small):
    over = dict(SMALL[name], preprocess=SMALL_PP) if small else {}
    model = api.build_trainable(name, seed=0, device=device, **over)
    cfg = model.cfg
    tcfg = TrainConfig()
    state = loop.create_train_state(model.module, tcfg, 0)
    t = cfg.preprocess.num_frames
    gen = torch.Generator(device).manual_seed(1)
    frames = torch.randint(0, 256, (8, t, *cfg.preprocess.staged_frame_shape),
                           dtype=torch.uint8, device=device, generator=gen)
    extras = ((torch.from_numpy(synthetic_landmarks(8, t, seed=2)).to(device),)
              if name == "two_stream" else ())
    labels = torch.arange(8, device=device) % cfg.num_classes
    parts = {p: [] for p in PARTS}
    host = {p: [] for p in PARTS}
    whole = []
    for i in range(3 + steps):
        marks = Marks(device)
        step_parts(state, name, cfg.preprocess, (frames, *extras), labels, tcfg, marks)
        if i >= 3:
            ms, host_ms = marks.ms()
            for p, x, h in zip(PARTS, ms, host_ms):
                parts[p].append(x)
                host[p].append(h)
            whole.append(sum(ms))
    out = {"family": name, "device": str(device), "small": small,
           "input": list(frames.shape), "steps": steps,
           "ms": {p: statistics.median(x) for p, x in parts.items()},
           "host_ms": {p: statistics.median(x) for p, x in host.items()},
           "parts_step_ms": statistics.median(whole)}
    if device.type == "cuda":
        out.update(_profile(state, cfg, (frames, *extras), labels, tcfg, steps))
    return out


def _profile(state, cfg, batch_in, labels, tcfg, steps):
    """The whole step back to back (CUDA events around ``steps`` steps,
    after 3), then ``steps`` steps under ``torch.profiler``: the kernels'
    device time a step and the top kernels."""
    from torch.profiler import ProfilerActivity, profile

    step_fn = loop.make_step_fn(tcfg, cfg.preprocess)
    batch_in = batch_in if len(batch_in) > 1 else batch_in[0]

    def run():
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(steps):
            step_fn(state, batch_in, labels)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / steps

    for _ in range(3):
        step_fn(state, batch_in, labels)
    step_ms = run()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        profiled_ms = run()
    kernels = [e for e in prof.key_averages() if e.device_type.name == "CUDA"
               and not e.is_user_annotation and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / steps
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    return {"step_ms": step_ms, "profiled_step_ms": profiled_ms,
            "device_busy_ms": busy_ms if kernels else None,
            "device_busy_share": busy_ms / step_ms if kernels else None,
            "kernels_per_step": sum(e.count for e in kernels) / steps,
            "top_kernels": [{"name": e.key[:90], "ms_per_step":
                             e.self_device_time_total / 1e3 / steps, "calls_per_step":
                             e.count / steps} for e in kernels[:12]]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--families", default="mobilenet_gru,resnet_transformer,two_stream")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--small", action="store_true")
    opts = ap.parse_args(argv)
    device = torch.device(opts.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            print("train_step_profile: no CUDA device", file=sys.stderr)
            return 1
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    for name in opts.families.split(","):
        print(json.dumps(profile_family(name, device, opts.steps, opts.small)), flush=True)
        if device.type == "cuda":
            torch.cuda.empty_cache()
    if device.type == "cuda":
        print(card_identity()["nvidia_smi"], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
