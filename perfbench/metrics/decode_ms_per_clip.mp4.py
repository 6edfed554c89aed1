"""decode_ms_per_clip.mp4: Mean of the program's decode.clip spans, each
stamped in its decode worker around one clip's decode and staging, over
the clips taken in the traced window, in ms (program_span)."""

from perfbench.core import program_spans


def read(run):
    return program_spans.mean_ms(run, "decode.clip")
