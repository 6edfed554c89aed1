"""queue_wait_p95_ms.serve: Nearest-rank 95th percentile of the program's
serve.queue spans (a request's submit to the batcher taking it off the
queue) over the requests taken in the traced slice, in ms (program_span)."""

from perfbench.core import program_spans


def read(run):
    return program_spans.p95_ms(run, "serve.queue")
