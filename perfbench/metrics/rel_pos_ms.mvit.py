"""rel_pos_ms.mvit: Device time per step of the kernels launched (from any
thread, matched by correlation id) inside the program's mvit.rel_pos spans,
the decomposed relative-position bias of each of MViTv2's attention
sub-layers (the tables' gather by the index, the three products with the
pooled q and the bias's expansion to [Lq, Lk]), forward and backward, in the
traced slice, in ms (program_span). None where the program has no such
span."""

from perfbench.core import program_spans


def read(run):
    return program_spans.device_ms_per_step(run, "mvit.rel_pos")
