"""space_attn_roofline.tsf: The spatial attention sub-layers' matmul operations
a step (the reference's space_attn_flops: q/k/v and output projections, q·kᵀ
and the weighted sum, the backward as twice the forward, no recompute) at
989 TFLOP/s, over space_attn_ms.tsf (program_span). None where that is."""

from perfbench.core import arith, program, program_spans


def read(run):
    ms = program_spans.device_ms_per_step(run, "timesformer.space_attn")
    if not ms:
        return None
    config = run.ctx.config
    flops = program.reference(config).space_attn_flops(config, run.ctx.params["batch"])
    return arith.share_pct(arith.bound_seconds(flops=flops), ms / 1e3)
