"""WLASL clip records: parse the ``WLASL_vX.json`` index, take its
100/300/1000/2000-gloss subsets and official train/val/test splits, and
batch the records. Counterpart of ``asltpu/data/wlasl.py``; numpy only.

The index schema is the public WLASL one (Li et al., WACV 2020)::

    [{"gloss": "book",
      "instances": [{"video_id": "69241", "split": "train",
                     "frame_start": 1, "frame_end": -1, ...}, ...]}, ...]

Subsets take the FIRST K glosses of the index (the official convention:
glosses are ordered so WLASL-100 ⊂ WLASL-300 ⊂ WLASL-1000 ⊂ WLASL-2000).
A :class:`ClipRecord` carries the segment and the signer box that the
decoders honour (:func:`asltpu_torch.data.decode.decode_record`).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

SUBSETS = (100, 300, 1000, 2000)


@dataclasses.dataclass(frozen=True)
class ClipRecord:
    video_id: str
    gloss: str
    label: int
    split: str  # train | val | test
    path: str  # resolved video file path ("" if missing on disk)
    # WLASL instances are segments of longer videos: 1-based inclusive frame
    # range (frame_end == -1 → to EOF), plus the signer bounding box
    # [x0, y0, x1, y1] in pixels (None when absent).
    frame_start: int = 1
    frame_end: int = -1
    bbox: Optional[Tuple[int, int, int, int]] = None


def gloss_label(idx, gloss_names=None):
    """Gloss id → display label, falling back to the integer id when the
    supplied name list is shorter than the model's class count."""
    i = int(idx)
    if gloss_names is not None and 0 <= i < len(gloss_names):
        return gloss_names[i]
    return i


class WLASLIndex:
    """Parsed WLASL index restricted to a K-gloss subset."""

    def __init__(
        self,
        index_json: str,
        video_dir: str,
        subset: int = 100,
        ext: str = ".mp4",
    ):
        # Official WLASL subsets are 100/300/1000/2000, but any positive K
        # ("first K glosses") is accepted — needed for synthetic fixtures
        # and custom vocabularies.
        if subset <= 0:
            raise ValueError(f"subset must be positive, got {subset}")
        with open(index_json) as f:
            entries = json.load(f)
        self.subset = subset
        self.glosses: List[str] = [e["gloss"] for e in entries[:subset]]
        self.gloss_to_label: Dict[str, int] = {
            g: i for i, g in enumerate(self.glosses)
        }
        self.records: List[ClipRecord] = []
        for label, entry in enumerate(entries[:subset]):
            for inst in entry["instances"]:
                vid = str(inst["video_id"])
                path = os.path.join(video_dir, vid + ext)
                bbox = inst.get("bbox")
                self.records.append(
                    ClipRecord(
                        video_id=vid,
                        gloss=entry["gloss"],
                        label=label,
                        split=inst.get("split", "train"),
                        path=path if os.path.exists(path) else "",
                        frame_start=int(inst.get("frame_start", 1)),
                        frame_end=int(inst.get("frame_end", -1)),
                        bbox=tuple(bbox) if bbox else None,
                    )
                )

    def split(self, name: str, present_only: bool = True) -> List[ClipRecord]:
        recs = [r for r in self.records if r.split == name]
        if present_only:
            recs = [r for r in recs if r.path]
        return recs

    @property
    def num_classes(self) -> int:
        return self.subset

    def label_name(self, label: int) -> str:
        return self.glosses[label]


def batches_from_records(
    records: Sequence[ClipRecord],
    batch_size: int,
    *,
    shuffle: bool = True,
    seed: int = 0,
    drop_remainder: bool = True,
    epochs: Optional[int] = None,
) -> Iterator[List[ClipRecord]]:
    """Yield record batches; infinite when ``epochs`` is None (training)."""
    rng = np.random.default_rng(seed)
    epoch = 0
    idx = np.arange(len(records))
    while epochs is None or epoch < epochs:
        if shuffle:
            rng.shuffle(idx)
        stop = len(idx) - (len(idx) % batch_size if drop_remainder else 0)
        for i in range(0, stop, batch_size):
            take = idx[i : i + batch_size]
            yield [records[j] for j in take]
        epoch += 1
