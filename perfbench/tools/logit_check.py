"""An inference check of a training cell's configuration at its own size:
the program's ``load_model`` → ``predict`` on staged clips against the
plain reference's ``forward`` (float32, TF32 off) from the harness's
weights, and the reference in float8 put in the program's place as the
control; then ``load_clip`` → ``stream_predict`` over mp4 files against
``predict`` on the clips ``load_clip`` gives. The predict's attention
calls are counted by path (``asltpu_torch.ops.attention``).

    python3 perfbench/tools/logit_check.py --workload timesformer_hr.finetune_b8 \\
        --seeds 1,2,3 --clips 8

``logit_gap`` is the largest |program − reference| over every clip and
class as a share of the reference logits' spread (``program.logit_gap``).
Prints one JSON line a seed."""

import argparse
import json
import os
import sys
import tempfile
import time

# The program's logit_gap at TimeSformer-HR's size lies below this (its
# readings and the control's are in PERF.md).
LIMIT = {"timesformer": 0.1}


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--clips", type=int, default=8)
    p.add_argument("--stream-clips", type=int, default=4)
    p.add_argument("--control", default="fp8")
    args = p.parse_args()
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
    import numpy as np
    import torch

    from asltpu_torch import api
    from asltpu_torch.ops import attention as att
    from perfbench.core import harness, program, video

    _, config = harness.cell_files(args.workload)
    dev = torch.device("cuda")
    ref = program.reference(config)
    limit = LIMIT.get(config["model"])
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        params = program.params_for(config, seed, dev)
        clips = program.smooth_clips(args.clips, config, seed, dev)
        model = program.inference_model(config, params, dev)
        calls = (att.fused_attention.calls, att.plain_attention.calls)
        _, logits = api.predict(model, clips.cpu().numpy())
        line = {"seed": seed, "attention_calls": {
            "fused": att.fused_attention.calls - calls[0],
            "plain": att.plain_attention.calls - calls[1]}}
        with tempfile.TemporaryDirectory(prefix="perfbench-") as tmp:
            paths = [os.path.join(tmp, f"{k}.mp4") for k in range(args.stream_clips)]
            for k, path in enumerate(paths):
                video.write_video(path, num_frames=config["preprocess"]["num_frames"] + 4,
                                  size=(240, 320), seed=seed + k)
            staged = np.stack([api.load_clip(path, model.cfg.preprocess) for path in paths])
            _, direct = api.predict(model, staged)
            streamed = np.stack([lg for _, _, lg in api.stream_predict(
                model, paths, batch_size=2, num_decode_workers=2)])
        line["stream_vs_predict_max_abs"] = float(np.abs(streamed - direct).max())
        del model
        torch.cuda.empty_cache()
        want = ref.forward(clips, params, config)
        got = torch.from_numpy(logits).to(dev)
        line["logit_gap"] = program.logit_gap(got, want)
        line["top1_agree"] = float((got.argmax(-1) == want.argmax(-1)).float().mean())
        line["control"] = args.control
        line["control_logit_gap"] = program.logit_gap(ref.forward(clips, params, config,
                                                                  args.control), want)
        line["limit"] = limit
        line["within"] = limit is not None and line["logit_gap"] <= limit
        line["control_within"] = limit is not None and line["control_logit_gap"] <= limit
        line["memory_peak_bytes"] = torch.cuda.max_memory_allocated(dev)
        line["seconds"] = time.perf_counter() - t
        print(json.dumps(line), flush=True)
        del params, clips, want, got
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
