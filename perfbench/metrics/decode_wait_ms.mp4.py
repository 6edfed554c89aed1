"""decode_wait_ms.mp4: Mean of the program's decode.wait spans (the
prefetch thread waiting on a batch's decodes) over the batches of the
traced window, in ms (program_span)."""

from perfbench.core import program_spans


def read(run):
    return program_spans.mean_ms(run, "decode.wait")
