"""max_pool_ms.train: Device time per step of the kernels launched (from any
thread, matched by correlation id) inside the program's i3d.max_pool spans,
I3D's max-pools forward and backward, in the traced slice, in ms
(program_span). None where the program has no such span."""

from perfbench.core import program_spans


def read(run):
    return program_spans.device_ms_per_step(run, "i3d.max_pool")
