"""The yardstick's arithmetic: the preprocess kernel's byte bound from
shapes, the bounds and shares, and the operations counted on the
reference (on the meta device, at full width)."""

import json

import pytest
import torch
import torch.nn.functional as F

from perfbench.core import arith, harness, program
from perfbench.drivers import finetune


def _taps_brute(n_in: int, n_out: int, start: int, count: int) -> int:
    """Source rows with a nonzero weight, read off the interpolation matrix
    that ``F.interpolate`` (half-pixel bilinear, no antialias) applies."""
    eye = torch.eye(n_in, dtype=torch.float64).view(n_in, 1, n_in, 1).expand(n_in, 1, n_in, 2)
    m = F.interpolate(eye, size=(n_out, 2), mode="bilinear", align_corners=False)[:, 0, :, 0]
    return int((m[:, start:start + count].abs() > 0).any(dim=1).sum())


@pytest.mark.parametrize("n_in,n_out,crop", [(256, 256, 224), (240, 256, 224), (480, 256, 224),
                                             (52, 37, 32)])
def test_taps_match_the_interpolation_matrix(n_in, n_out, crop):
    start = (n_out - crop) // 2
    assert arith._taps(n_in, n_out, start, crop) == _taps_brute(n_in, n_out, start, crop)


def test_preprocess_bytes_at_the_cells_shape():
    # 256² staged, short side 256 (no resize), crop 224: the crop's pixels
    # read once, bf16 written once.
    frames = 32 * 16
    assert arith.preprocess_rgb_bytes(frames, (256, 256), 256, 224) == frames * 3 * 224 * 224 * 3
    # The bound of a batch: 231 MB at 3.35 TB/s.
    s = arith.bound_seconds(nbytes=arith.preprocess_rgb_bytes(frames, (256, 256), 256, 224))
    assert s == pytest.approx(6.9e-5, rel=0.01)


def test_bounds_and_shares():
    assert arith.bound_seconds(flops=989e12) == pytest.approx(1.0)
    assert arith.bound_seconds(flops=1e12, nbytes=3.35e12) == pytest.approx(1.0)
    assert arith.share_pct(0.5, 2.0) == 25.0
    with pytest.raises(ValueError):
        arith.share_pct(1.0, 0.0)


def test_mobilenet_gru_operations_per_clip():
    _, config = harness.cell_files("mobilenet_gru.mp4_480p")
    flops = program.flops_per_clip(program.reference(config), config)
    # 16 frames of MobileNetV2 at 224² (0.30 GMAC each) and the GRU head.
    assert flops == pytest.approx(9.67e9, rel=0.01)


def test_i3d_train_operations_per_clip():
    _, config = harness.cell_files("i3d.finetune_b48")
    ref = program.reference(config)
    fwd = program.flops_per_clip(
        type("Fwd", (), {"param_specs": staticmethod(ref.param_specs),
                         "forward": staticmethod(
                             lambda x, p, c: ref.forward_train(x, p, c, None, recompute=False))}),
        config)
    train = finetune.train_flops_per_clip(ref, config)
    # I3D at 64 × 224²: ≈ 222 GFLOP forward with the plain 7³ stem (53 of
    # them in the stem); the backward takes twice the forward but for the
    # stem's input gradient, which no parameter needs.
    assert fwd == pytest.approx(222e9, rel=0.02)
    stem = 2 * 64 * 32 * 112 * 112 * 3 * 7 ** 3
    assert train == pytest.approx(3 * fwd - stem, rel=0.01)


def test_cell_files_parse():
    for cell in json.load(open(harness.os.path.join(harness.ROOT, "BENCHMARK.json")))["workloads"]:
        c, config = harness.cell_files(cell["name"])
        assert c["config"] == config["name"]
