"""Deployment export with the PyTorch/CUDA port: model → ``torch.export``
artifact → predictions, no model code.

Exports the inference program (preprocessing included: on the card the
CUDA preprocess kernel is an op inside the program) with its config, then
reloads the artifact and predicts from it. Counterpart of
export_deploy.py.

    python examples/torch_export_deploy.py

Set ASLTPU_EXAMPLE_FORCE_CPU=1 to run on the CPU, and ASLTPU_EXAMPLE_TINY=1
for toy shapes (the example smoke test sets both).
"""

import os
import sys

# Runnable straight from a source checkout (no install needed).
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import tempfile

import numpy as np

from asltpu_torch import api
from asltpu_torch.data.synthetic import write_video
from asltpu_torch.export import export_model, load_exported


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

    tmp = tempfile.mkdtemp(prefix="asltpu_torch_export_")
    clip_path = os.path.join(tmp, "clip.mp4")
    write_video(clip_path, num_frames=24, size=(240, 320), seed=3)

    # 1. Build (or restore) the model and export the deployment artifact.
    model = api.load_model("mobilenet_gru", device=device, **overrides)
    artifact_dir = os.path.join(tmp, "artifact")
    meta = export_model(model, artifact_dir, batch_size=2)
    print(f"exported: platforms={meta['platforms']} batch_size={meta['batch_size']}")

    # 2. Reload: this needs the artifact directory only (a fresh process
    # without the model code would do the same).
    em = load_exported(artifact_dir)

    # 3. Stage a clip with the artifact's own preprocess config and predict
    # through the exported program.
    clip = api.load_clip(clip_path, em.preprocess)
    gloss, logits = em.predict(frames=clip)
    print(f"artifact predict: gloss id {gloss}, logits {tuple(logits.shape)}")

    # The exported program is the live model's math: the same clip through
    # the live model agrees (same device, same kernels).
    _, live = api.predict(model, clip)
    print(f"matches live model: {bool(np.allclose(logits, live, atol=1e-5))}")


if __name__ == "__main__":
    main()
