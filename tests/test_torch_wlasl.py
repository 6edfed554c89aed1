"""WLASL clip records beside the JAX package's: the index, its splits and
record batches are the same, and clip records stream through the port's
``stream_predict`` with their segments and boxes honoured."""

import dataclasses
import json
import os
import pickle

import numpy as np
import pytest

from asltpu.data import wlasl as jwlasl
from asltpu_torch import api as tapi
from asltpu_torch.data import decode as tdecode
from asltpu_torch.data import wlasl as twlasl


def _fields(records):
    return [dataclasses.astuple(r) for r in records]


@pytest.mark.parametrize("split", ["train", "test", "val"])
def test_index_splits_match_jax(tiny_wlasl, split):
    index, videos = tiny_wlasl
    for subset in (6, 4):
        want = jwlasl.WLASLIndex(index, videos, subset=subset)
        got = twlasl.WLASLIndex(index, videos, subset=subset)
        assert got.glosses == want.glosses and got.num_classes == want.num_classes
        assert _fields(got.split(split)) == _fields(want.split(split))
        assert got.label_name(3) == want.label_name(3)


def test_index_segments_boxes_and_missing_videos_match_jax(tiny_wlasl, tmp_path):
    """An index with segments, signer boxes, an instance without a split
    and one whose video is missing: the same records, present-only or not."""
    _, videos = tiny_wlasl
    entries = [
        {"gloss": "book", "instances": [
            {"video_id": "00000", "split": "train", "frame_start": 3, "frame_end": 12,
             "bbox": [4, 2, 80, 90]},
            {"video_id": "99999", "split": "train"},
        ]},
        {"gloss": "drink", "instances": [{"video_id": 1, "frame_end": 7}]},
    ]
    path = str(tmp_path / "index.json")
    with open(path, "w") as f:
        json.dump(entries, f)
    want = jwlasl.WLASLIndex(path, videos, subset=2)
    got = twlasl.WLASLIndex(path, videos, subset=2)
    assert _fields(got.records) == _fields(want.records)
    assert _fields(got.split("train", present_only=False)) == _fields(
        want.split("train", present_only=False))
    rec = got.split("train")[0]
    assert (rec.frame_start, rec.frame_end, rec.bbox) == (3, 12, (4, 2, 80, 90))
    assert pickle.loads(pickle.dumps(rec)) == rec
    with pytest.raises(ValueError, match="positive"):
        twlasl.WLASLIndex(path, videos, subset=0)


def test_batches_from_records_match_jax(tiny_wlasl):
    index, videos = tiny_wlasl
    recs = twlasl.WLASLIndex(index, videos, subset=6).records
    jrecs = jwlasl.WLASLIndex(index, videos, subset=6).records
    for kw in ({"shuffle": True, "seed": 3, "epochs": 2},
               {"shuffle": False, "drop_remainder": False, "epochs": 1}):
        got = [_fields(b) for b in twlasl.batches_from_records(recs, 5, **kw)]
        want = [_fields(b) for b in jwlasl.batches_from_records(jrecs, 5, **kw)]
        assert got == want and got


@pytest.mark.parametrize("backend", ["auto", "process"])
def test_stream_predict_takes_records(tiny_wlasl, backend):
    """Two records of one video with different segments stay apart with
    ``yield_items=True``, and each gets ``predict``'s logits on its own
    decoded segment."""
    index, videos = tiny_wlasl
    base = twlasl.WLASLIndex(index, videos, subset=6).split("test")[:2]
    recs = [dataclasses.replace(base[0], frame_start=1, frame_end=8),
            dataclasses.replace(base[0], frame_start=9, frame_end=20, bbox=(10, 0, 90, 96)),
            base[1]]
    model = tapi.load_model("mobilenet_gru", device="cpu", num_classes=6, gru_hidden=16,
                            width_mult=0.35, preprocess={"num_frames": 3,
                                                         "staging_size": (64, 64),
                                                         "resize_short": 64, "crop": 48})
    out = list(tapi.stream_predict(model, recs, batch_size=2, num_decode_workers=1,
                                   decode_backend=backend, yield_items=True))
    assert [r for r, _, _ in out] == recs
    _, want = tapi.predict(model, np.stack([tdecode.decode_record(r, model.cfg.preprocess)
                                            for r in recs]))
    np.testing.assert_allclose(np.stack([lg for _, _, lg in out]), want, atol=1e-5)
    assert np.abs(out[0][2] - out[1][2]).max() > 0
    paths = [p for p, _, _ in tapi.stream_predict(model, recs, batch_size=2,
                                                  num_decode_workers=1,
                                                  decode_backend=backend)]
    assert paths == [r.path for r in recs] and os.path.exists(paths[0])
