"""Continuous recognition with the PyTorch/CUDA port: an untrimmed signing
session → a gloss timeline.

``asltpu_torch.windows`` slides fixed-duration windows over the session
(each window decodes only its sampled frames, and the windows run in
batches on the device), then merges the per-window predictions into gloss
segments, pooling low-confidence stretches into explicit *uncertain*
spans. Counterpart of continuous_recognition.py.

    python examples/torch_continuous_recognition.py

Set ASLTPU_EXAMPLE_FORCE_CPU=1 to run on the CPU, and ASLTPU_EXAMPLE_TINY=1
for toy shapes (the example smoke test sets both).
"""

import os
import sys

# Runnable straight from a source checkout (no install needed).
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import tempfile

from asltpu_torch import api
from asltpu_torch.data.synthetic import write_video
from asltpu_torch.windows import merge_windows, predict_windows, segments_json


def main() -> None:
    tiny = bool(os.environ.get("ASLTPU_EXAMPLE_TINY"))
    device = "cpu" if os.environ.get("ASLTPU_EXAMPLE_FORCE_CPU") else None  # None: the card
    overrides = (
        {
            "gru_hidden": 16,
            "width_mult": 0.5,
            "num_classes": 5,
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

    tmp = tempfile.mkdtemp(prefix="asltpu_torch_cont_")
    session = os.path.join(tmp, "session.mp4")
    # A 4.8 s synthetic "session" (untrimmed continuous video).
    write_video(session, num_frames=120, size=(120, 160) if tiny else (240, 320), fps=25,
                seed=3)

    model = api.load_model("mobilenet_gru", device=device, **overrides)

    # 1-second windows, 50% overlap (the stride default).
    wins = predict_windows(model, session, window_seconds=1.0, batch_size=4 if tiny else 8,
                           decode_backend="thread")
    print(f"windows: {len(wins)}")
    for w in wins[:3]:
        print(f"  [{w.start_s:5.2f}-{w.end_s:5.2f}s] gloss={w.gloss} p={w.prob:.3f}")

    # Merge into segments; windows under min_prob pool into explicit
    # uncertain spans (gloss None): nothing is silently dropped.
    segs = merge_windows(wins, min_prob=0.3)
    print(f"segments: {len(segs)}")
    for row in segments_json(segs):
        label = row["gloss"] if row["gloss"] is not None else "(uncertain)"
        print(f"  [{row['start_s']:5.2f}-{row['end_s']:5.2f}s] {label} "
              f"windows={row['num_windows']} p={row['mean_prob']}")


if __name__ == "__main__":
    main()
