"""idle_decode_wait_pct.mp4: Share of the device's idle time in the traced
window during which the prefetch thread was inside decode.wait, waiting on
the decode workers (program_span)."""

from perfbench.core import program_spans


def read(run):
    return program_spans.idle_share_pct(run, ("decode.wait",))
