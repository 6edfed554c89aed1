"""pool_attn_ms.mvit: Device time per step of the kernels launched (from any
thread, matched by correlation id) inside the program's mvit.attn spans,
MViTv2's pooling attention sub-layers from norm1 through the q/k/v
projection, the pools, the relative-position bias, attention, residual
pooling, proj and the skip's projection and pool to their residual add,
forward and backward, in the traced slice, in ms (program_span). None where
the program has no such span."""

from perfbench.core import program_spans


def read(run):
    return program_spans.device_ms_per_step(run, "mvit.attn")
