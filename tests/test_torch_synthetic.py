"""The port's synthetic task sets (``asltpu_torch.data.synthetic``) against
the JAX package's (``asltpu.data.synthetic``): at 2–3 classes, 4–8 frames
and 32–48² each generator writes the same mp4 bytes and index JSON and
returns the same arrays and timelines. Above 10 classes the two differ on
purpose, in the validation seeds only: the JAX package's val seeds of
class k are the train seeds of class k + 10, the port's lie past every
train seed (checked at 52 classes by recording the seeds, no video
written)."""

import filecmp
import json
import os

import numpy as np
import pytest

from asltpu.data import synthetic as jsynthetic
from asltpu_torch.data import synthetic as tsynthetic


def _same_dataset(want, got):
    (want_index, want_videos), (got_index, got_videos) = want, got
    assert os.path.basename(want_index) == os.path.basename(got_index)
    with open(want_index) as a, open(got_index) as b:
        assert a.read() == b.read()
    names = sorted(os.listdir(want_videos))
    assert names and names == sorted(os.listdir(got_videos))
    for name in names:
        assert filecmp.cmp(os.path.join(want_videos, name), os.path.join(got_videos, name),
                           shallow=False), name


DATASETS = {
    "make_synthetic_wlasl": dict(num_glosses=2, clips_per_gloss=2, num_frames=6,
                                 size=(32, 48), splits=["train", "test"]),
    "make_separable_wlasl": dict(num_glosses=3, train_per_gloss=2, val_per_gloss=1,
                                 num_frames=6, size=(32, 32)),
    "make_separable_wlasl_grid": dict(num_hue=2, num_rate=2, train_per_class=1,
                                      val_per_class=1, num_frames=4, size=(32, 32)),
}


@pytest.mark.parametrize("name", sorted(DATASETS))
def test_datasets_match_jax_byte_for_byte(tmp_path, name):
    kw = DATASETS[name]
    _same_dataset(getattr(jsynthetic, name)(str(tmp_path / "jax"), **kw),
                  getattr(tsynthetic, name)(str(tmp_path / "port"), **kw))


@pytest.mark.parametrize("kw", [
    dict(gloss_id=1, num_glosses=3, num_frames=5, size=(32, 32), seed=3),
    dict(gloss_id=2, num_glosses=3, num_frames=8, size=(48, 32), seed=4, hue_rate=0.17,
         hard=True),
])
def test_write_separable_video_matches_jax(tmp_path, kw):
    jsynthetic.write_separable_video(str(tmp_path / "jax.mp4"), **kw)
    tsynthetic.write_separable_video(str(tmp_path / "port.mp4"), **kw)
    assert filecmp.cmp(tmp_path / "jax.mp4", tmp_path / "port.mp4", shallow=False)


def test_write_separable_session_matches_jax(tmp_path):
    kw = dict(gloss_sequence=[1, 0, 2], num_glosses=3, frames_per_sign=5, size=(32, 32),
              seed=7)
    want = jsynthetic.write_separable_session(str(tmp_path / "jax.mp4"), **kw)
    got = tsynthetic.write_separable_session(str(tmp_path / "port.mp4"), **kw)
    assert got == want == [(1, 1, 5), (0, 6, 10), (2, 11, 15)]
    assert filecmp.cmp(tmp_path / "jax.mp4", tmp_path / "port.mp4", shallow=False)


@pytest.mark.parametrize("name,args,kw", [
    ("make_separable_landmarks", (3, 2), dict(num_frames=5, seed=1)),
    ("make_separable_fusion", (2, 2, 1), dict(num_frames=4, size=(32, 32), seed=2)),
    ("rate_wheel", (4,), {}),
])
def test_arrays_match_jax(name, args, kw):
    want = getattr(jsynthetic, name)(*args, **kw)
    got = getattr(tsynthetic, name)(*args, **kw)
    for a, b in zip(*[x if isinstance(x, tuple) else (x,) for x in (want, got)]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(b, a)


def _recorded_seeds(module, monkeypatch, tmp_path, make, **kw):
    """{split: [seed, ...]} of the clips ``make`` would write, with
    ``write_separable_video`` replaced by a recorder (no video written)."""
    seeds = []
    monkeypatch.setattr(module, "write_separable_video",
                        lambda path, **k: seeds.append(k["seed"]))
    index, _ = getattr(module, make)(str(tmp_path / module.__name__), **kw)
    with open(index) as f:
        splits = [i["split"] for e in json.load(f) for i in e["instances"]]
    out = {"train": [], "val": []}
    for split, seed in zip(splits, seeds, strict=True):
        out[split].append(seed)
    return out


@pytest.mark.parametrize("make,kw", [
    ("make_separable_wlasl_grid", {}),
    ("make_separable_wlasl", dict(num_glosses=52)),
])
def test_val_seeds_are_disjoint_from_train_seeds_at_52_classes(monkeypatch, tmp_path, make,
                                                               kw):
    jax_seeds = _recorded_seeds(jsynthetic, monkeypatch, tmp_path, make, **kw)
    port_seeds = _recorded_seeds(tsynthetic, monkeypatch, tmp_path, make, **kw)
    assert len(port_seeds["train"]) == 52 * 8 and len(port_seeds["val"]) == 52 * 4
    # The JAX package's val draws repeat train draws (defect (b))...
    assert set(jax_seeds["val"]) & set(jax_seeds["train"])
    # ...the port's do not, its train seeds are the JAX package's, and every
    # seed is distinct.
    assert port_seeds["train"] == jax_seeds["train"]
    assert not set(port_seeds["val"]) & set(port_seeds["train"])
    assert len(set(port_seeds["val"])) == len(port_seeds["val"])
    assert tsynthetic.split_seeds(52) == (("train", 0), ("val", 52_000))
    assert tsynthetic.split_seeds(10) == (("train", 0), ("val", 10_000))
