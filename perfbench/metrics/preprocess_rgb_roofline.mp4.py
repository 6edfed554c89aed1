"""preprocess_rgb_roofline.mp4: The rgb preprocess kernel's share of its byte
bound over the traced slice: each launch's input bytes that its taps weigh
and its bf16 output at 3.35 TB/s, over the kernels' summed device time
(device_trace)."""

from perfbench.core import readers

read = readers.preprocess_rgb_roofline_pct
