"""device_idle_pct.serve: Share of the traced slice with no kernel, copy or set
on the card: the whole window, or the first trace_s seconds of it where the
workload file gives trace_s (device_trace)."""

from perfbench.core import readers

read = readers.device_idle_pct
