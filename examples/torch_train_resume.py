"""Train + crash + resume with the PyTorch/CUDA port on a synthetic WLASL
dataset (no downloads).

The first run fault-injects a crash at step 6; the second restores the
train state (weights, AdamW, schedule, generator) and the exact position
of the resumable loader's stream, and finishes the remaining steps.
Counterpart of train_resume.py.

    python examples/torch_train_resume.py

Runs on the card; ASLTPU_EXAMPLE_FORCE_CPU=1 runs it on the CPU (about a
minute). The same wiring at contract shapes is
``python -m asltpu_torch.cli train --model i3d --loader grain ...``.
"""

import os
import sys

# Runnable straight from a source checkout (no install needed).
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import tempfile

from asltpu_torch import api, ckpt
from asltpu_torch.config import TrainConfig
from asltpu_torch.data.loader import ResumableIterator, make_train_loader
from asltpu_torch.data.synthetic import make_synthetic_wlasl
from asltpu_torch.data.wlasl import WLASLIndex
from asltpu_torch.train.loop import FaultInjected, train


def run(steps: int, ckpt_dir: str, index: str, videos: str, fault_step: int, device):
    # I3D's temporal pools need at least 5 frames.
    model = api.build_trainable(
        "i3d", device=device, num_classes=6,
        preprocess={"num_frames": 8, "staging_size": (48, 48), "resize_short": 40,
                    "crop": 32},
    )
    records = WLASLIndex(index, videos, subset=6).split("train")
    tcfg = TrainConfig(batch_size=4, num_steps=steps, warmup_steps=2, log_every=2,
                       ckpt_every=3, ckpt_dir=ckpt_dir, fault_inject_step=fault_step)
    raw_iter = iter(make_train_loader(records, model.cfg.preprocess, tcfg.batch_size,
                                      seed=tcfg.seed))
    saved = ckpt.load_data_state(ckpt_dir)
    if saved is not None:
        raw_iter.set_state(saved)  # resume the data stream, not just the weights
    resumable = ResumableIterator(raw_iter)
    try:
        return train(model.module, tcfg, resumable, pp_cfg=model.cfg.preprocess,
                     resumable_iter=resumable)
    finally:
        raw_iter.close()


def main() -> None:
    device = "cpu" if os.environ.get("ASLTPU_EXAMPLE_FORCE_CPU") else None  # None: the card
    root = tempfile.mkdtemp(prefix="asltpu_torch_train_example_")
    index, videos = make_synthetic_wlasl(root, num_glosses=6, clips_per_gloss=2,
                                         num_frames=12, size=(64, 64))
    ckpt_dir = f"{root}/ck"
    try:
        run(10, ckpt_dir, index, videos, fault_step=6, device=device)
        raise SystemExit("expected the injected fault")
    except FaultInjected:
        print("crashed at step 6 (injected); resuming from the last save...")
    state = run(10, ckpt_dir, index, videos, fault_step=-1, device=device)
    print(f"resumed and finished at step {int(state.step)}")


if __name__ == "__main__":
    main()
