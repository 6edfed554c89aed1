"""Deployment export of the port (``asltpu_torch.export``), as
``tests/unit/test_export.py`` holds the JAX package's: the program of each
family exported with ``torch.export``, loaded back with no model code, gives
the live ``predict_fn``'s logits; the config round trip, single-clip
padding, shape checks, the refusals and the CLI lane. Beside them: the
port's exported ``mobilenet_gru`` against the JAX package's exported program
on the same carried weights and frames, a load in a fresh process that
imports no ``asltpu_torch.models``, and the preprocess custom ops' fake
implementations against their plain versions.

On the CPU the exported programs hold the plain preprocess; the card tests
(``tests/test_torch_cuda.py``) export on the card, where the program calls
the kernel's custom op."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from asltpu_torch.api import load_model
from asltpu_torch.config import PreprocessConfig
from asltpu_torch.export import export_model, load_exported, preprocess_ops
from asltpu_torch.ops import preprocess_kernels as k

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Tiny configs of tests/unit/test_export.py.
RGB_PP = {"num_frames": 4, "staging_size": (64, 64), "resize_short": 36, "crop": 32}
CLI_MODEL = ["--model", "mobilenet_gru", "--num-classes", "5",
             "--set", "width_mult=0.5", "--set", "gru_hidden=16",
             "--set", "preprocess.num_frames=4",
             "--set", "preprocess.staging_size=(64,64)",
             "--set", "preprocess.resize_short=36", "--set", "preprocess.crop=32"]
# The parity bound of tests/unit/test_parity.py, fp32 end to end.
ATOL = 2e-4


def _uint8(seed, shape):
    return np.random.default_rng(seed).integers(0, 255, size=shape, dtype=np.uint8)


def _live(model, *inputs):
    return model.predict_fn()(*(torch.from_numpy(np.ascontiguousarray(x))
                                for x in inputs)).numpy()


@pytest.fixture(scope="module")
def tiny_rgb_model():
    return load_model("mobilenet_gru", device="cpu", width_mult=0.5, gru_hidden=32,
                      num_classes=7, preprocess=RGB_PP)


@pytest.fixture(scope="module")
def rgb_artifact(tiny_rgb_model, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("exp") / "artifact")
    export_model(tiny_rgb_model, path, batch_size=3)
    return path


def test_export_roundtrip_matches_predict_fn(tiny_rgb_model, rgb_artifact):
    em = load_exported(rgb_artifact)
    frames = _uint8(0, (3, 4, 64, 64, 3))
    got = em.predict_batch(frames=frames)
    assert got.shape == (3, 7)
    np.testing.assert_allclose(got, _live(tiny_rgb_model, frames), atol=1e-5)
    assert em.meta["platforms"] == ["cpu"] and em.meta["preprocess"] == "plain"
    assert em.meta["torch_version"] == torch.__version__
    assert sorted(os.listdir(rgb_artifact)) == ["meta.json", "program.pt2"]


def test_export_config_roundtrip(tiny_rgb_model, rgb_artifact):
    em = load_exported(rgb_artifact)
    # Tuples come back from the JSON lists, through get_config.
    assert em.cfg == tiny_rgb_model.cfg
    assert em.cfg.preprocess.staging_size == (64, 64)
    assert em.takes_rgb and not em.takes_landmarks


def test_export_single_clip_predict_pads(tiny_rgb_model, rgb_artifact):
    em = load_exported(rgb_artifact)
    clip = _uint8(1, (4, 64, 64, 3))
    gloss, logits = em.predict(frames=clip)
    assert logits.shape == (7,)
    want = _live(tiny_rgb_model, np.repeat(clip[None], 3, axis=0))[0]
    np.testing.assert_allclose(logits, want, atol=1e-5)
    assert gloss == int(want.argmax())


def test_export_shape_validation(rgb_artifact):
    em = load_exported(rgb_artifact)
    short = _uint8(2, (2, 4, 64, 64, 3))
    with pytest.raises(ValueError, match="frames shape"):
        em.predict_batch(frames=short)
    with pytest.raises(ValueError, match="frames shape"):
        em.predict(frames=short[0, :2])


def test_export_pose_only_landmarks_input(tmp_path):
    pm = load_model("pose_bilstm", device="cpu", num_classes=5, hidden_size=16, num_frames=6)
    meta = export_model(pm, str(tmp_path / "a"), batch_size=2)
    pe = load_exported(str(tmp_path / "a"))
    assert pe.takes_landmarks and not pe.takes_rgb and meta["preprocess"] is None
    lm = np.random.default_rng(3).standard_normal((2, 6, 543, 3)).astype(np.float32)
    np.testing.assert_allclose(pe.predict_batch(landmarks=lm), _live(pm, lm), atol=1e-5)


def test_export_two_stream_both_inputs(tmp_path):
    fm = load_model("two_stream", device="cpu", num_classes=4, d_model=32, num_heads=2,
                    num_fusion_layers=1,
                    preprocess={"num_frames": 4, "staging_size": (28, 28),
                                "resize_short": 26, "crop": 24})
    export_model(fm, str(tmp_path / "f"), batch_size=2)
    fe = load_exported(str(tmp_path / "f"))
    assert fe.takes_rgb and fe.takes_landmarks
    rng = np.random.default_rng(4)
    frames = rng.integers(0, 255, size=(2, 4, 28, 28, 3), dtype=np.uint8)
    lm = rng.standard_normal((2, 4, 543, 3)).astype(np.float32)
    want = _live(fm, frames, lm)
    np.testing.assert_allclose(fe.predict_batch(frames=frames, landmarks=lm), want, atol=1e-5)
    # One clip pads both inputs alike.
    _, logits = fe.predict(frames=frames[0], landmarks=lm[0])
    np.testing.assert_allclose(logits, _live(fm, np.repeat(frames[:1], 2, 0),
                                             np.repeat(lm[:1], 2, 0))[0], atol=1e-5)


def test_export_resnet_transformer_roundtrip(tmp_path):
    m = load_model("resnet_transformer", device="cpu", num_classes=5, d_model=64,
                   num_heads=2, num_tx_layers=1,
                   preprocess={"num_frames": 4, "staging_size": (40, 40),
                               "resize_short": 36, "crop": 32})
    export_model(m, str(tmp_path / "r"), batch_size=2)
    frames = _uint8(5, (2, 4, 40, 40, 3))
    got = load_exported(str(tmp_path / "r")).predict_batch(frames=frames)
    np.testing.assert_allclose(got, _live(m, frames), atol=1e-5)


def test_export_i3d_roundtrip(tmp_path):
    # Full-width I3D at 8 frames, the fewest its pools take.
    m = load_model("i3d", device="cpu", num_classes=5,
                   preprocess={"num_frames": 8, "staging_size": (40, 40),
                               "resize_short": 36, "crop": 32})
    export_model(m, str(tmp_path / "i"), batch_size=2)
    frames = _uint8(6, (2, 8, 40, 40, 3))
    em = load_exported(str(tmp_path / "i"))
    got = em.predict_batch(frames=frames)
    np.testing.assert_allclose(got, _live(m, frames), atol=1e-4)
    # All 13 pools are the custom op, which the card runs as its kernel.
    pools = [n for n in em.program.graph.nodes
             if str(n.target) == "asltpu_torch.max_pool3d_same.default"]
    assert len(pools) == 13 and em.meta["preprocess"] == "plain"


def test_load_exported_rejects_non_artifact(tmp_path):
    with pytest.raises(IOError, match="not an export artifact"):
        load_exported(str(tmp_path))


def _edited(rgb_artifact, tmp_path, **changes):
    dst = str(tmp_path / "edited")
    shutil.copytree(rgb_artifact, dst)
    with open(os.path.join(dst, "meta.json")) as f:
        meta = json.load(f)
    meta.update(changes)
    with open(os.path.join(dst, "meta.json"), "w") as f:
        json.dump(meta, f)
    return dst


def test_load_exported_rejects_future_format(tmp_path, rgb_artifact):
    with pytest.raises(IOError, match="format_version"):
        load_exported(_edited(rgb_artifact, tmp_path, format_version=999))


def test_load_exported_refuses_a_card_artifact_without_a_card(tmp_path, rgb_artifact):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_exported(_edited(rgb_artifact, tmp_path, platforms=["cuda"]))


def test_cli_export_and_predict_exported(tmp_path, capsys):
    """The CLI lane end to end: export with --verify-clip, then predict
    --exported on the clip; both print the same gloss."""
    from asltpu_torch.cli.main import main
    from asltpu_torch.data.synthetic import write_video

    clip = str(tmp_path / "c.mp4")
    write_video(clip, num_frames=12, size=(80, 80), seed=7)
    out = str(tmp_path / "artifact")
    assert main(["export", "--device", "cpu", *CLI_MODEL, "--out", out, "--batch", "2",
                 "--verify-clip", clip]) == 0
    assert os.path.exists(os.path.join(out, "program.pt2"))
    assert main(["predict", "--exported", out, clip]) == 0
    rows = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert rows[0]["preprocess"] == "plain" and rows[0]["platforms"] == ["cpu"]
    assert rows[1]["gloss"] == rows[2]["gloss"] and rows[1]["top5"] == rows[2]["top5"]
    with pytest.raises(SystemExit, match="runs on cpu"):
        main(["predict", "--exported", out, "--device", "cuda", clip])


def test_cli_predict_exported_resolves_gloss_names(tmp_path, capsys):
    """--index gives the exported lane gloss names, as it gives predict."""
    from asltpu_torch.cli.main import main
    from asltpu_torch.data.synthetic import make_synthetic_wlasl

    index, videos = make_synthetic_wlasl(str(tmp_path / "d"), num_glosses=5,
                                         clips_per_gloss=1, num_frames=8, size=(80, 80))
    clip = os.path.join(videos, sorted(os.listdir(videos))[0])
    out = str(tmp_path / "artifact")
    assert main(["export", "--device", "cpu", *CLI_MODEL, "--out", out, "--batch", "2"]) == 0
    capsys.readouterr()
    assert main(["predict", "--exported", out, "--index", index, clip]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert isinstance(rec["gloss"], str)
    assert all(isinstance(e["gloss"], str) for e in rec["top5"])


def test_exported_mobilenet_gru_matches_the_jax_export(tmp_path):
    """The port's exported program against the JAX package's exported
    program (``asltpu.export``, traced on the CPU) with the same fp32
    weights (BatchNorm calibrated, so the clips' logits differ) on the same
    staged frames."""
    from asltpu.export import export_model as jexport_model
    from asltpu.export import load_exported as jload_exported
    from test_torch_serve import RGB, model_pair, staged_frames

    jm, tm = model_pair("mobilenet_gru", RGB)
    frames = staged_frames(tm.cfg, 3, seed=11)
    jexport_model(jm, str(tmp_path / "jax"), batch_size=3)
    export_model(tm, str(tmp_path / "torch"), batch_size=3)
    want = jload_exported(str(tmp_path / "jax")).predict_batch(frames=frames)
    got = load_exported(str(tmp_path / "torch")).predict_batch(frames=frames)
    assert np.ptp(want, axis=0).max() > 10 * ATOL  # the clips' logits differ
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_load_in_a_fresh_process_imports_no_model_code(rgb_artifact, tmp_path):
    """``load_exported``, a batch through the program and ``predict
    --exported`` in a new interpreter leave ``asltpu_torch.models`` (and
    the api that builds models) out of ``sys.modules``."""
    from asltpu_torch.data.synthetic import write_video

    clip = str(tmp_path / "c.mp4")
    write_video(clip, num_frames=8, size=(64, 64), seed=3)
    code = (
        "import sys, numpy as np\n"
        "from asltpu_torch.export import load_exported\n"
        "from asltpu_torch.cli.main import main\n"
        f"em = load_exported({rgb_artifact!r})\n"
        "out = em.predict_batch(frames=np.zeros((3, 4, 64, 64, 3), np.uint8))\n"
        "assert out.shape == (3, 7), out.shape\n"
        f"assert main(['predict', '--exported', {rgb_artifact!r}, {clip!r}]) == 0\n"
        "bad = sorted(m for m in sys.modules if m.startswith(('asltpu_torch.models', "
        "'asltpu_torch.api')) or m.split('.')[0] in ('asltpu', 'jax'))\n"
        "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("lane,shape,cfg", [
    ("rgb", (2, 3, 40, 48, 3), dict(staging_size=(40, 48), resize_short=36, crop=32)),
    ("yuv420", (2, 3, 48, 32), dict(staging_size=(32, 32), resize_short=32, crop=32,
                                    staging_format="yuv420")),
])
@pytest.mark.parametrize("out_dtype", ["bfloat16", "float32"])
def test_preprocess_ops_fake_and_export(lane, shape, cfg, out_dtype):
    """Each custom op's fake implementation gives its plain version's shape
    and dtype; a program that calls the op exports with the op in its graph
    and, loaded back, gives the plain version's values."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    pp = PreprocessConfig(num_frames=shape[1], out_dtype=out_dtype, **cfg)
    wrapper, plain = {"rgb": (k.preprocess_rgb, k.preprocess_rgb_plain),
                      "yuv420": (k.preprocess_yuv420, k.preprocess_yuv420_plain)}[lane]
    x = torch.from_numpy(_uint8(8, shape))
    want = plain(x, pp)
    with FakeTensorMode() as mode:
        fake = wrapper(mode.from_tensor(x), pp)
    assert (fake.shape, fake.dtype) == (want.shape, want.dtype)

    class Program(torch.nn.Module):
        def forward(self, frames):
            return wrapper(frames, pp)

    exported = torch.export.export(Program(), (torch.zeros_like(x),), strict=False)
    assert preprocess_ops(exported) == [f"asltpu_torch::preprocess_{lane}"]
    torch.testing.assert_close(exported.module()(x), want, rtol=0, atol=0)
