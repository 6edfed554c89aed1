"""idle_host_work_pct.serve: Share of the device's idle time in the traced
slice during which the batcher was inside serve.assemble, serve.copy,
serve.predict or serve.reply: host work. The rest is idle time waiting for
requests (serve.collect, blocked on the queue) (program_span)."""

from perfbench.core import program_spans

HOST_WORK = ("serve.assemble", "serve.copy", "serve.predict", "serve.reply")


def read(run):
    return program_spans.idle_share_pct(run, HOST_WORK)
