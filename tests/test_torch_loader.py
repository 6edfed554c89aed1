"""The port's training loader, as ``tests/unit/test_loader.py`` holds the
JAX package's: batch shapes and batches across epochs, a deterministic
shuffle, ``ResumableIterator.state_for`` with a ``Prefetcher`` pulling
ahead (on the CPU), and a train run cut by a fault and resumed that
consumes exactly the uninterrupted data stream."""

import numpy as np
import pytest

from asltpu_torch.config import PreprocessConfig, TrainConfig
from asltpu_torch.data.loader import ClipDataSource, ResumableIterator, make_train_loader
from asltpu_torch.data.prefetch import Prefetcher
from asltpu_torch.data.wlasl import WLASLIndex

PP = PreprocessConfig(num_frames=4, staging_size=(64, 64))


def _records(tiny_wlasl):
    index, videos = tiny_wlasl
    return WLASLIndex(index, videos, subset=6).split("train")


def _labels(batches):
    return [tuple(int(x) for x in labels) for _, labels in batches]


def test_loader_batches(tiny_wlasl):
    """6 records × 2 epochs = 12 samples → 3 batches of 4, the second across
    the epoch boundary; every record once per epoch."""
    records = _records(tiny_wlasl)
    batches = list(make_train_loader(records, PP, batch_size=4, seed=0, num_epochs=2))
    assert len(batches) == 3
    frames, labels = batches[0]
    assert frames.shape == (4, 4, 64, 64, 3) and frames.dtype == np.uint8
    assert labels.shape == (4,) and labels.dtype == np.int32
    flat = [x for b in _labels(batches) for x in b]
    want = sorted(r.label for r in records)
    assert sorted(flat[:6]) == want and sorted(flat[6:]) == want
    assert len(list(make_train_loader(records, PP, batch_size=4, num_epochs=1))) == 1


def test_loader_shuffle_is_deterministic(tiny_wlasl):
    records = _records(tiny_wlasl)

    def seq(seed):
        return _labels(make_train_loader(records, PP, batch_size=2, seed=seed, num_epochs=3))

    assert seq(0) == seq(0)
    assert seq(0) != seq(1)


def test_state_for_rewinds_past_the_prefetched_batches(tiny_wlasl):
    """A ``Prefetcher`` of depth 2 pulls ahead of the consumer: the state
    for the 3 batches consumed resumes at batch 3, with no repeat and no
    skip; a state is refused by another loader."""
    records = _records(tiny_wlasl)
    loader = make_train_loader(records, PP, batch_size=2, seed=3, num_epochs=4)
    want = _labels(loader)
    assert len(want) == 12
    it = ResumableIterator(iter(loader))
    got = []
    with Prefetcher(it, depth=2, device="cpu") as pf:
        for frames, labels in pf:
            got.append(tuple(int(x) for x in labels))
            if len(got) == 3:
                break
        state = it.state_for(3)
    assert it._seq > 3  # the prefetcher had pulled ahead
    again = iter(loader)
    again.set_state(state)
    assert got + _labels(again) == want
    other = iter(make_train_loader(records, PP, batch_size=2, seed=4, num_epochs=4))
    with pytest.raises(ValueError, match="loader state"):
        other.set_state(state)
    assert repr(ClipDataSource(records, PP)) == repr(ClipDataSource(list(records), PP))
    assert repr(ClipDataSource(records, PP)) != repr(ClipDataSource(records[:-1], PP))


def test_train_resume_continues_the_data_stream(tiny_wlasl, tmp_path):
    """Fault at step 3 after the step-2 checkpoint, then a resume: the
    batches the two runs' steps consumed are the uninterrupted stream's."""
    from asltpu_torch import api as tapi
    from asltpu_torch import ckpt as tckpt
    from asltpu_torch.train.loop import FaultInjected, train

    records = _records(tiny_wlasl)
    pp = {"num_frames": 6, "staging_size": (40, 48), "resize_short": 36, "crop": 32}
    model = tapi.build_trainable("i3d", device="cpu", num_classes=6, compute_dtype="float32",
                                 preprocess=pp)
    ckdir = str(tmp_path / "ck")

    def run(fault_at, seen):
        cfg = TrainConfig(batch_size=2, num_steps=6, warmup_steps=1, log_every=100,
                          ckpt_every=2, ckpt_dir=ckdir, fault_inject_step=fault_at)
        raw = iter(make_train_loader(records, model.cfg.preprocess, 2, seed=7, num_epochs=10))
        saved = tckpt.load_data_state(ckdir)
        if saved is not None:
            raw.set_state(saved)
        rit = ResumableIterator(raw)

        def batches():
            for frames, labels in rit:
                seen.append(tuple(int(x) for x in labels))
                yield frames, labels

        return train(model.module, cfg, Prefetcher(batches(), depth=2, device="cpu"),
                     pp_cfg=model.cfg.preprocess, resumable_iter=rit)

    truth = _labels(make_train_loader(records, model.cfg.preprocess, 2, seed=7,
                                      num_epochs=2))[:6]
    seen1, seen2 = [], []
    with pytest.raises(FaultInjected):
        run(3, seen1)
    assert tckpt.load_data_state(ckdir) is not None
    state = run(-1, seen2)
    assert state.step == 6
    assert seen1[:2] == truth[:2]
    assert seen2[:4] == truth[2:6]
