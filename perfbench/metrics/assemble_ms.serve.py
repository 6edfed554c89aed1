"""assemble_ms.serve: Mean of the program's serve.assemble spans (the
batcher's np.stack and pad to a bucket) over the batches of the traced
slice, in ms (program_span)."""

from perfbench.core import program_spans


def read(run):
    return program_spans.mean_ms(run, "serve.assemble")
