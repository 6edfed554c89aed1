"""pool_attn_roofline.mvit: The pooling attention sub-layers' matmul and
convolution operations a step (the reference's pool_attn_flops: the q/k/v
projection, the three depthwise pools, q·kᵀ, the three relative-position
products, the weighted sum, proj and the skip's projection, the backward as
twice the forward, no recompute) at 989 TFLOP/s, over pool_attn_ms.mvit
(program_span). None where that is."""

from perfbench.core import arith, program, program_spans


def read(run):
    ms = program_spans.device_ms_per_step(run, "mvit.attn")
    if not ms:
        return None
    config = run.ctx.config
    flops = program.reference(config).pool_attn_flops(config, run.ctx.params["batch"])
    return arith.share_pct(arith.bound_seconds(flops=flops), ms / 1e3)
