"""short_attn_roofline.tsf: The least bytes TimeSformer's temporal attention
moves a step (forward qkv and out, backward qkv, grad_out and grad_qkv: 11
bf16 values a token and model width, B·T·h·w tokens, every block) at 3.35
TB/s, over short_attn_ms.tsf (program_span), in %. None where that is."""

from perfbench.core import arith, program, program_spans


def read(run):
    ms = program_spans.device_ms_per_step(run, "attention.short")
    if not ms:
        return None
    config = run.ctx.config
    t, n, d, _, depth = program.reference(config).sizes(config)
    tokens = run.ctx.params["batch"] * t * n
    nbytes = 11 * tokens * d * 2 * depth
    return arith.share_pct(arith.bound_seconds(nbytes=nbytes), ms / 1e3)
