"""optimizer_ms.train: Device time per step of the kernels, copies and sets
launched (from any thread, matched by correlation id) inside the program's
train.optimizer ranges (clip, AdamW, schedule, metrics) of the traced
slice, in ms (program_span)."""

from perfbench.core import program_spans


def read(run):
    return program_spans.device_ms_per_step(run, "train.optimizer")
