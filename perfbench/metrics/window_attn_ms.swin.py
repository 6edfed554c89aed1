"""window_attn_ms.swin: Device time per step of the kernels launched (from any
thread, matched by correlation id) inside the program's swin.window_attn
spans, Video Swin's unshifted window attention sub-layers from their
LayerNorm to their residual add, forward and backward, in the traced slice,
in ms (program_span). None where the program has no such span."""

from perfbench.core import program_spans


def read(run):
    return program_spans.device_ms_per_step(run, "swin.window_attn")
