"""short_attn_ms.tsf: Device time per step of the kernels launched (from any
thread, matched by correlation id) inside the program's attention.short
spans, TimeSformer's short-sequence (temporal) attention kernels forward and
backward, in the traced slice, in ms (program_span). None where the program
has no such span."""

from perfbench.core import program_spans


def read(run):
    return program_spans.device_ms_per_step(run, "attention.short")
