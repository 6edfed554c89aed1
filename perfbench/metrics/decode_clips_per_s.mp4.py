"""decode_clips_per_s.mp4: Decode-only clips/s of a pool made as stream_predict
makes its default one, over the cell's corpus, on the harness's clock
(program_counter)."""

from perfbench.core import readers

read = readers.counter("decode_clips_per_s")
