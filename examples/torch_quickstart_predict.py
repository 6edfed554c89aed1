"""Quickstart for the PyTorch/CUDA port: synthetic clip → load_model →
predict → stream_predict.

Runs on the CUDA card with no dataset: the clips are generated by the
port's synthetic fixture writer. Counterpart of quickstart_predict.py.

    python examples/torch_quickstart_predict.py

Set ASLTPU_EXAMPLE_FORCE_CPU=1 to run on the CPU, and ASLTPU_EXAMPLE_TINY=1
for toy shapes (seconds on a CPU; the example smoke test sets both).
"""

import os
import sys

# Runnable straight from a source checkout (no install needed).
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import tempfile

from asltpu_torch import api
from asltpu_torch.data.synthetic import write_video


def main() -> None:
    tiny = bool(os.environ.get("ASLTPU_EXAMPLE_TINY"))
    device = "cpu" if os.environ.get("ASLTPU_EXAMPLE_FORCE_CPU") else None  # None: the card
    overrides = (
        {
            "gru_hidden": 16,
            "width_mult": 0.35,
            "preprocess": {
                "num_frames": 4,
                "staging_size": (48, 48),
                "resize_short": 40,
                "crop": 32,
            },
        }
        if tiny
        else {}
    )

    tmp = tempfile.mkdtemp(prefix="asltpu_torch_example_")
    paths = []
    for i in range(4):
        p = os.path.join(tmp, f"clip{i}.mp4")
        write_video(p, num_frames=40, size=(240, 320), seed=i)
        paths.append(p)

    # North-star config: MobileNetV2 per-frame features + GRU head, bf16 on
    # the card with the hand-written CUDA preprocess kernel.
    model = api.load_model("mobilenet_gru", device=device, **overrides)

    # Single clip: host decode + staging, then preprocess → logits on the device.
    clip = api.load_clip(paths[0], model.cfg.preprocess)
    gloss, logits = api.predict(model, clip)
    print(f"predict: gloss id {gloss}, logits shape {tuple(logits.shape)}")

    # Batched streaming: decode threads → prefetch to the device → predict.
    for path, gloss, logits in api.stream_predict(model, paths, batch_size=2,
                                                  decode_backend="thread"):
        print(f"stream: {os.path.basename(path)} -> gloss id {gloss}")


if __name__ == "__main__":
    main()
