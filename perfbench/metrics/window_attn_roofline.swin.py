"""window_attn_roofline.swin: The window attention sub-layers' matmul
operations a step, shifted and unshifted (the reference's window_attn_flops:
q/k/v and output projections, q·kᵀ and the weighted sum, the backward as
twice the forward, no recompute) at 989 TFLOP/s, over the sum of
window_attn_ms.swin and shifted_attn_ms.swin (program_span). None where
either is."""

from perfbench.core import arith, program, program_spans


def read(run):
    plain = program_spans.device_ms_per_step(run, "swin.window_attn")
    shifted = program_spans.device_ms_per_step(run, "swin.shifted_attn")
    if not plain or not shifted:
        return None
    config = run.ctx.config
    flops = program.reference(config).window_attn_flops(config, run.ctx.params["batch"])
    return arith.share_pct(arith.bound_seconds(flops=flops), (plain + shifted) / 1e3)
