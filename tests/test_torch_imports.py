"""asltpu_torch stands alone: no JAX, no asltpu, no nvcc at import; the
entry points default to the card; CPU tensors never launch a kernel."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_WALK = """
import importlib, pkgutil, sys
import asltpu_torch
for m in pkgutil.walk_packages(asltpu_torch.__path__, "asltpu_torch."):
    importlib.import_module(m.name)
bad = sorted(
    m for m in sys.modules
    if m == "asltpu" or m.startswith("asltpu.")
    or m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax", "grain")
)
assert not bad, bad
train = ("asltpu_torch.train.loop", "asltpu_torch.ops.augment", "asltpu_torch.data.loader",
         "asltpu_torch.eval.metrics", "asltpu_torch.ckpt", "asltpu_torch.models.i3d",
         "asltpu_torch.models.bilstm")
assert set(train) <= set(sys.modules), sorted(set(train) - set(sys.modules))
serving = ("asltpu_torch.serve", "asltpu_torch.serve_http", "asltpu_torch.windows",
           "asltpu_torch.cli", "asltpu_torch.cli.main", "asltpu_torch.utils",
           "asltpu_torch.utils.logging")
assert set(serving) <= set(sys.modules), sorted(set(serving) - set(sys.modules))
offline = ("asltpu_torch.export", "asltpu_torch.utils.profiling", "asltpu_torch.data.synthetic")
assert set(offline) <= set(sys.modules), sorted(set(offline) - set(sys.modules))
dist = ("asltpu_torch.dist", "asltpu_torch.dist.mesh", "asltpu_torch.dist.tp",
        "asltpu_torch.dist.multihost")
assert set(dist) <= set(sys.modules), sorted(set(dist) - set(sys.modules))
print("walked", sum(m.startswith("asltpu_torch") for m in sys.modules))
"""


def _run(code, env=None):
    return subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=120,
    )


def test_package_imports_no_jax_and_no_asltpu():
    proc = _run(_WALK)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 25


def test_top_level_names_include_the_jax_packages():
    """``asltpu_torch`` re-exports every config name that ``asltpu``
    re-exports, each the port's own."""
    import asltpu
    import asltpu.config
    import asltpu_torch
    import asltpu_torch.config

    names = {n for n in dir(asltpu) if not n.startswith("_") and hasattr(asltpu.config, n)}
    assert len(names) == 8 and {"I3DConfig", "TwoStreamFusionConfig"} <= names
    assert names <= set(dir(asltpu_torch)), sorted(names - set(dir(asltpu_torch)))
    for n in names:
        assert getattr(asltpu_torch, n) is getattr(asltpu_torch.config, n)


# What a spawned decode worker imports, and the other host-side modules.
TORCH_FREE = ("asltpu_torch._buildcache", "asltpu_torch.config", "asltpu_torch.native",
              "asltpu_torch.data.decode",
              "asltpu_torch.data.staging", "asltpu_torch.data.pad",
              "asltpu_torch.data.wlasl", "asltpu_torch.data.landmarks",
              "asltpu_torch.data.synthetic", "asltpu_torch.utils",
              "asltpu_torch.utils.profiling", "asltpu_torch.cli.main")


def test_host_modules_import_no_torch():
    proc = _run(
        "import importlib, sys\n"
        f"for m in {TORCH_FREE!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('torch', 'jax'))\n"
        "assert not bad, bad[:5]\n")
    assert proc.returncode == 0, proc.stderr


def test_kernel_module_imports_without_nvcc():
    env = dict(os.environ, PATH="/nonexistent", CUDA_HOME="/nonexistent")
    proc = _run(
        "import asltpu_torch.ops.preprocess_kernels as k\n"
        "import asltpu_torch.ops.mbconv_kernels as mb\n"
        "import asltpu_torch.models.mobilenet_fused\n"
        "from asltpu_torch.ops import _build\n"
        "assert k.preprocess_rgb.launches == 0 == k.preprocess_yuv420.launches\n"
        "assert mb.fused_mbconv_s1.launches == 0\n"
        "assert {'mbconv', 'preprocess'} <= set(_build.all_sources())\n"
        "try:\n"
        "    _build.nvcc()\n"
        "except RuntimeError as e:\n"
        "    print('no nvcc:', e)\n",
        env=env,
    )
    assert proc.returncode == 0, proc.stderr
    if not os.path.exists("/usr/local/cuda/bin/nvcc"):
        assert "no nvcc" in proc.stdout


def test_load_model_defaults_to_the_card():
    from asltpu_torch import api

    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.load_model("mobilenet_gru", width_mult=0.35, gru_hidden=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.resolve_device("cuda")
    assert api.resolve_device("cpu").type == "cpu"


def test_cpu_tensors_leave_launch_counters_at_zero():
    from asltpu_torch.config import PreprocessConfig
    from asltpu_torch.ops import preprocess_kernels as k

    rng = np.random.default_rng(0)
    rgb_cfg = PreprocessConfig(num_frames=2, staging_size=(40, 48),
                               resize_short=36, crop=32)
    yuv_cfg = PreprocessConfig(num_frames=2, staging_size=(32, 32),
                               resize_short=32, crop=32, staging_format="yuv420")
    rgb = torch.from_numpy(rng.integers(0, 256, (1, 2, 40, 48, 3), np.uint8))
    yuv = torch.from_numpy(rng.integers(0, 256, (1, 2, 48, 32), np.uint8))
    before = (k.preprocess_rgb.launches, k.preprocess_yuv420.launches)
    out_rgb = k.preprocess_rgb(rgb, rgb_cfg)
    out_yuv = k.preprocess_yuv420(yuv, yuv_cfg)
    assert (k.preprocess_rgb.launches, k.preprocess_yuv420.launches) == before
    torch.testing.assert_close(out_rgb, k.preprocess_rgb_plain(rgb, rgb_cfg),
                               rtol=0, atol=0)
    torch.testing.assert_close(out_yuv, k.preprocess_yuv420_plain(yuv, yuv_cfg),
                               rtol=0, atol=0)
    assert out_rgb.shape == (1, 2, 32, 32, 3) and out_rgb.dtype == torch.bfloat16


def test_cpu_fused_backbone_leaves_mbconv_counter_at_zero():
    from asltpu_torch.models.mobilenet_fused import fused_backbone_apply
    from asltpu_torch.models.mobilenetv2 import MobileNetV2
    from asltpu_torch.ops import mbconv_kernels as mb

    frames = torch.from_numpy(
        np.random.default_rng(1).standard_normal((1, 32, 24, 3)).astype(np.float32))
    before = mb.fused_mbconv_s1.launches
    feats = fused_backbone_apply(MobileNetV2(0.35).eval(), frames)
    assert mb.fused_mbconv_s1.launches == before == 0
    assert feats.shape == (1, 1280) and feats.dtype == torch.bfloat16


def test_unported_names_and_backends_say_so():
    """Every config of the registry builds (``i3d``, ``two_stream`` and
    TimeSformer-HR, Video Swin-B and MViTv2-B too, at full width); an
    unknown name or backend raises."""
    from asltpu_torch import api, native
    from asltpu_torch.config import CONFIG_REGISTRY, PreprocessConfig
    from asltpu_torch.data.decode import make_decode_pool

    built = {name: api.build_module(api.get_config(name)) for name in CONFIG_REGISTRY}
    assert built["i3d"].logits.conv3d.weight.shape == (2000, 1024, 1, 1, 1)
    assert built["two_stream"].fc.in_features == 512
    assert built["two_stream"].features.out_features == 1280
    tsf = built["timesformer"]
    assert tsf.pos_embed.shape == (1, 785, 768) and tsf.time_embed.shape == (1, 16, 768)
    assert len(tsf.blocks) == 12 and tsf.head.weight.shape == (2000, 768)
    swin = built["video_swin"]
    assert [len(layer.blocks) for layer in swin.layers] == [2, 2, 18, 2]
    assert swin.layers[3].blocks[1].attn.relative_position_bias_table.shape == (2535, 32)
    assert swin.head.weight.shape == (2000, 1024)
    mvit = built["mvit_v2"]
    assert len(mvit.blocks) == 24 and mvit.blocks[21].attn.qkv.weight.shape == (3 * 768, 384)
    assert mvit.head.projection.weight.shape == (2000, 768)
    assert api.build_module(api.get_config("pose_bilstm")).fc.out_features == 100
    with pytest.raises(KeyError):
        api.get_config("c3d")
    with pytest.raises(ValueError, match="no model"):
        api.build_module(api.ModelConfig())
    with pytest.raises(ValueError, match="unknown decode backend"):
        make_decode_pool(PreprocessConfig(), backend="gpu")
    for backend in ("auto", "native", "process", "thread"):
        with pytest.raises(ValueError, match="fast_flags"):
            make_decode_pool(PreprocessConfig(), backend=backend,
                             fast_flags=native.FAST_ALL)
