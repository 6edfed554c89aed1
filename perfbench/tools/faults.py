"""Faults planted under a cell's timed path, for reading what the compared
numbers say of a broken program: the tests drive each at a small size on
the CPU, and this script at the cell's own size on the card.

    python3 perfbench/tools/faults.py --workload i3d.finetune_b48 --seeds 1,2,3 --seconds 2

Inference faults, in ``Model.predict_fn``'s logits: one logit of one
answer altered (``altered``), the second half of a batch answered from
the first (``half_batch``), the previous call's answers returned again
(``unchanged``). Training faults, in the step: AdamW's update skipped
(``unchanged``), the loss taken over the first half of the batch
(``half_batch``), the step's answer, its loss, 1% off where it is made
(``altered``). One card: no exchange between cards to leave out."""

import argparse
import contextlib
import json
import os
import sys
import time
from typing import Iterator

INFERENCE = ("altered", "half_batch", "unchanged")
TRAINING = ("unchanged", "half_batch", "altered")


@contextlib.contextmanager
def patched(owner, name: str, value) -> Iterator[None]:
    old = getattr(owner, name)
    setattr(owner, name, value)
    try:
        yield
    finally:
        setattr(owner, name, old)


def planted_inference(fault: str):
    from asltpu_torch import api

    sound = api.Model.predict_fn
    last = {}

    def predict_fn(self):
        fn = sound(self)

        def faulty(*xs):
            out = fn(*xs).clone()
            if fault == "altered":
                out[0, 0] += 1.0
            elif fault == "half_batch":
                h = out.shape[0] // 2
                if h:
                    out[h:2 * h] = out[:h]
            elif fault == "unchanged":
                prev, last["out"] = last.get("out"), out
                if prev is not None and prev.shape == out.shape:
                    return prev
            return out
        return faulty

    return patched(api.Model, "predict_fn", predict_fn)


def planted_training(fault: str):
    import torch
    from asltpu_torch.train import loop

    if fault == "unchanged":
        return patched(torch.optim.AdamW, "step", lambda self, closure=None: None)
    sound_ce = loop.softmax_ce
    if fault == "half_batch":
        def half(logits, labels, smoothing):
            h = logits.shape[0] // 2
            return sound_ce(logits[:h], labels[:h], smoothing)

        return patched(loop, "softmax_ce", half)

    def altered(logits, labels, smoothing):
        return 1.01 * sound_ce(logits, labels, smoothing)

    return patched(loop, "softmax_ce", altered)


def planted(driver: str, fault: str):
    """The context in which ``fault`` breaks a cell of ``driver``."""
    return planted_training(fault) if driver == "finetune" else planted_inference(fault)


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args()
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
    from perfbench.core import harness

    cell, _ = harness.cell_files(args.workload)
    driver = cell["mix"]["driver"]
    try:
        for fault in (TRAINING if driver == "finetune" else INFERENCE):
            for seed in (int(s) for s in args.seeds.split(",")):
                with planted(driver, fault):
                    res, _, _ = harness.run_cell(args.workload, seed, args.seconds, False,
                                                 time.perf_counter())
                print(json.dumps({"fault": fault, "seed": seed, "correct": res["correct"],
                                  **{k: c["value"] for k, c in res["checks"].items()}}),
                      flush=True)
    finally:
        harness.stop_children()
    return 0


if __name__ == "__main__":
    sys.exit(main())
