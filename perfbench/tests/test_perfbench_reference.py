"""Each plain reference against the program at a tiny size on the CPU,
float32 throughout: the MobileNetV2-GRU forward, the I3D training forward
and its steps, and decode with staging."""

import numpy as np
import torch

from perfbench.core import program, video, weights
from perfbench.drivers import finetune
from perfbench.reference import decode as ref_decode
from perfbench.tests.sizes import tiny

CPU = torch.device("cpu")


def test_mobilenet_gru_reference_matches_the_program():
    _, config = tiny("mobilenet_gru.serve_poisson")
    params = program.params_for(config, 5, CPU)
    clips = program.smooth_clips(4, config, 5, CPU)
    model = program.inference_model(config, params, CPU)
    got = model.predict_fn()(clips)
    want = program.reference(config).forward(clips, params, config)
    assert torch.allclose(got, want, atol=1e-4, rtol=1e-4)
    # Clips differ far beyond the agreement.
    assert (want[0] - want[1]).abs().max() > 100 * (got - want).abs().max()


def test_the_reference_takes_every_leaf_of_the_program():
    for name in ("mobilenet_gru.serve_poisson", "i3d.finetune_b48"):
        _, config = tiny(name)
        params = program.params_for(config, 1, CPU)
        from asltpu_torch import api

        module = api.build_module(api.get_config(config["model"],
                                                 **weights.port_overrides(config["model"], config)))
        weights.load_into(module, params)  # raises on a missing or unknown leaf


def test_i3d_training_reference_follows_the_program():
    cell, config = tiny("i3d.finetune_b48")
    from perfbench.core.harness import Context, SetupClock

    ctx = Context("i3d.finetune_b48", cell, config, 11, 1.0, False, CPU, SetupClock(0.0), "")
    out = finetune.run(ctx)
    (loss_gap, _), (grad_gap, _), (change_gap, _) = (out.checks[k] for k in
                                                     ("loss_gap", "grad_norm_gap",
                                                      "change_norm_gap"))
    assert loss_gap < 1e-3 and grad_gap < 1e-2 and change_gap < 1e-2


def test_reference_decode_matches_the_programs(tmp_path):
    from asltpu_torch.data.decode import decode_sampled_frames

    path = str(tmp_path / "a.mp4")
    video.write_video(path, num_frames=12, size=(48, 64), seed=3)
    got = decode_sampled_frames(path, 5, (40, 40))
    want = ref_decode.load_clip(path, 5, (40, 40))
    np.testing.assert_array_equal(got, want)
