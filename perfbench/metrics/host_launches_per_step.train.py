"""host_launches_per_step.train: Kernel launches the host made in the traced
slice (the workload's trace_s from the window's start), per train step in it
(device_trace)."""

from perfbench.core import readers

read = readers.launches_per_step
