"""mfu.train: Clips done in the window times the reference's operations per
clip (forward and backward, no recompute), over the window, against the
card's 989 TFLOP/s bf16 peak (host_clock)."""

from perfbench.core import readers

read = readers.mfu_pct
