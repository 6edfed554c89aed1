"""Small sizes of the cells for runs on the CPU: the configurations at
tiny widths and float32 throughout, so that the program and the
reference agree to rounding, and the traffic cut to a few clips."""

import copy

from perfbench.core import harness


def tiny(name: str, dtype: str = "float32"):
    """(cell, config) of ``name`` at a size a CPU run holds."""
    cell, config = harness.cell_files(name)
    cell, config = copy.deepcopy(cell), copy.deepcopy(config)
    p = cell["mix"]["params"]
    pp = config["preprocess"]
    driver = cell["mix"]["driver"]
    if driver == "mp4_stream":
        p.update(batch=2, corpus_clips=4, source_hw=[48, 64], source_frames=8, writers=2,
                 fill_batches=1, passes=200, decode_clips=8)
    elif driver == "poisson_serve":
        p.update(clips=8, max_batch=4, batch_buckets=[1, 2], rate_per_s=20, warm_s=0.5,
                 trace_s=0.5)
        if p.get("max_outstanding"):
            # Offered far above what a CPU serves, so that the cap sheds.
            p.update(rate_per_s=400, max_outstanding=4)
    elif driver == "finetune":
        # Training BatchNorm over the few positions of a tiny batch's deepest
        # layers amplifies rounding: four clips of 16 × 96² keep it tame.
        p.update(batch=4, trace_s=0.5)
    if config["reference"] == "mobilenet_gru":
        config.update(width_mult=0.35, gru_hidden=16, num_classes=10, num_frames=2)
        pp.update(num_frames=2)
    else:
        config.update(num_classes=10, num_frames=16)
        pp.update(num_frames=16)
    config["compute_dtype"] = dtype
    side = 40 if config["reference"] == "mobilenet_gru" else 104
    pp.update(staging_size=[side, side], resize_short=side, crop=side - 8, out_dtype=dtype)
    return cell, config
