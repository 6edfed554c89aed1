"""MViTv2's counters at a configuration's own size, on the card: the
program's ``load_model`` → ``predict`` on seeded staged clips, then
``build_trainable`` → ``make_train_step`` for a few steps on them, each
with what it added to ``biased_attention.calls``, ``fused_attention.calls``,
``plain_attention.calls``, ``mvit_pool.calls`` and ``rel_pos_bias.bytes``,
and its peak memory:

    python3 perfbench/tools/mvit_check.py --workload mvit_v2_b.finetune_b8 --steps 3

A forward of MViTv2-B makes 24 biased calls and no other, and 72 pools.
Prints one JSON line a phase."""

import argparse
import json
import os
import sys
import time


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, default=2500000003)
    p.add_argument("--steps", type=int, default=3)
    args = p.parse_args()
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
    import torch

    from asltpu_torch import api
    from asltpu_torch.config import TrainConfig
    from asltpu_torch.models import mvit
    from asltpu_torch.ops import attention as att
    from asltpu_torch.train.loop import create_train_state, make_train_step
    from perfbench.core import harness, program, weights

    cell, config = harness.cell_files(args.workload)
    dev = torch.device("cuda")
    batch = cell["mix"]["params"]["batch"]
    clips = program.smooth_clips(batch, config, args.seed, dev)
    labels = torch.arange(batch, device=dev) % config["num_classes"]
    names = ("biased_attention.calls", "fused_attention.calls", "plain_attention.calls",
             "mvit_pool.calls", "rel_pos_bias.bytes")

    def read():
        return (att.biased_attention.calls, att.fused_attention.calls,
                att.plain_attention.calls, mvit.mvit_pool.calls, mvit.rel_pos_bias.bytes)

    def counted(fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = read()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return {**{n: a - b for n, a, b in zip(names, read(), before)},
                "seconds": time.perf_counter() - t,
                "memory_peak_bytes": torch.cuda.max_memory_allocated(dev)}

    model = program.inference_model(config, program.params_for(config, args.seed, dev), dev)
    np_clips = clips.cpu().numpy()
    for k in range(2):
        print(json.dumps({"phase": f"predict.{k}", "device": torch.cuda.get_device_name(dev),
                          **counted(lambda: api.predict(model, np_clips))}), flush=True)
    del model
    torch.cuda.empty_cache()
    model = api.build_trainable(config["model"], device=dev,
                                **weights.port_overrides(config["model"], config))
    tcfg = TrainConfig(batch_size=batch, **cell["mix"]["params"]["train"])
    state = create_train_state(model.module, tcfg, seed=args.seed)
    step = make_train_step(tcfg, model.cfg.preprocess)
    for k in range(args.steps):
        print(json.dumps({"phase": f"train.{k}", **counted(lambda: step(state, clips, labels))}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
