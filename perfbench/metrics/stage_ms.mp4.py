"""stage_ms.mp4: Mean of the program's decode.stack spans (stack and pad
of a decoded batch) plus the mean of its prefetch.pin spans (pin and copy
enqueue), over the batches of the traced window, in ms (program_span)."""

from perfbench.core import program_spans


def read(run):
    return program_spans.mean_ms(run, "decode.stack", "prefetch.pin")
