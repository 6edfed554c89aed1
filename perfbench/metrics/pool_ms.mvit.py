"""pool_ms.mvit: Device time per step of the kernels launched (from any thread,
matched by correlation id) inside the program's mvit.pool spans, the
depthwise Conv3d pools of q, k and v and their LayerNorms in each of
MViTv2's attention sub-layers, forward and backward, in the traced slice, in
ms (program_span). None where the program has no such span."""

from perfbench.core import program_spans


def read(run):
    return program_spans.device_ms_per_step(run, "mvit.pool")
