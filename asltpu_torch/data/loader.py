"""The training loader: a deterministic, resumable stream of (staged
frames, labels) batches over WLASL clip records. Counterpart of
``asltpu/data/loader.py``, with a numpy index sampler in place of grain's
(grain is not installed beside the port).

The sampler shuffles the records with a seeded permutation per epoch
(``numpy.random.default_rng([seed, epoch])``), runs batches across epoch
boundaries and drops the remainder at the end. Its state is the stream's
position, bytes of (epoch, position within the epoch), tied to the data
source's content-addressed ``repr``. The order is not grain's; what holds
is that a stream resumed from a saved state equals the uninterrupted one.
Clips decode in the thread that pulls the batch (a ``Prefetcher``'s, in
training), as grain's ``worker_count=0`` decodes in-process.
"""

from __future__ import annotations

import hashlib
import json
import threading
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np

from asltpu_torch.config import PreprocessConfig
from asltpu_torch.data.decode import decode_record
from asltpu_torch.data.wlasl import ClipRecord


class ResumableIterator:
    """Wrap a stateful batch iterator (``get_state()``) so that the state of
    the last CONSUMED batch stays saveable while a ``Prefetcher`` pulls
    ahead: a snapshot of ``get_state()`` is taken before each batch, and
    ``state_for(consumed)`` returns the one that resumes at batch index
    ``consumed`` (the count of batches the consumer finished)."""

    def __init__(self, it, keep: int = 16):
        self._it = it
        self._keep = keep
        self._snapshots: dict = {}
        self._seq = 0
        # __next__ runs on the Prefetcher's thread, state_for on the train
        # thread at checkpoint time: both serialise on this lock.
        self._lock = threading.Lock()

    def __iter__(self):
        return self

    def __next__(self):
        with self._lock:
            self._snapshots[self._seq] = self._it.get_state()
            # A checkpoint needs a snapshot only a prefetch depth back.
            for k in [k for k in self._snapshots if k < self._seq - self._keep]:
                del self._snapshots[k]
            self._seq += 1
            return next(self._it)

    def state_for(self, consumed: int) -> Optional[bytes]:
        """The state that resumes with batch index ``consumed``. May wait for
        one in-flight decode (the lock covers the worker's ``next``)."""
        with self._lock:
            if consumed >= self._seq:
                # Only at the exact boundary: the live state is right there.
                return self._it.get_state()
            return self._snapshots.get(consumed)


class ClipDataSource:
    """Record index → (staged frames, label), decoded by
    :func:`asltpu_torch.data.decode.decode_record` (segment and signer box
    honoured). Records without a file are left out."""

    def __init__(self, records: Sequence[ClipRecord], pp: PreprocessConfig):
        self._records = [r for r in records if r.path]
        self._pp = pp

    def __repr__(self) -> str:
        # Stable across processes and content-addressed: a saved stream
        # position is refused for another record list or preprocess config.
        h = hashlib.sha1()
        for r in self._records:
            h.update(f"{r.path}|{r.label}|{r.frame_start}|{r.frame_end}|{r.bbox}".encode())
        h.update(repr(self._pp).encode())
        return f"ClipDataSource(n={len(self._records)}, key={h.hexdigest()[:12]})"

    def __len__(self) -> int:
        return len(self._records)

    def __getitem__(self, idx) -> Tuple[np.ndarray, np.int32]:
        rec = self._records[int(idx)]
        return decode_record(rec, self._pp), np.int32(rec.label)


class TrainLoader:
    """Iterable of (frames [B, T, Hs, Ws, 3] uint8, labels [B] int32)
    batches of ``source``: shuffled per epoch from ``seed``, across epoch
    boundaries, the remainder dropped; ``num_epochs`` None runs forever.
    Each ``iter()`` starts a stream at position 0."""

    def __init__(self, source: ClipDataSource, batch_size: int, seed: int,
                 num_epochs: Optional[int]):
        if len(source) == 0:
            raise ValueError("the loader has no records with a video file")
        self.source, self.batch_size = source, batch_size
        self.seed, self.num_epochs = seed, num_epochs

    def __iter__(self) -> "LoaderIterator":
        return LoaderIterator(self)


class LoaderIterator:
    """One stream of a :class:`TrainLoader`, with ``get_state`` /
    ``set_state``."""

    def __init__(self, loader: TrainLoader):
        self._loader = loader
        self._pos = 0  # samples emitted since the start of epoch 0
        self._perm: Tuple[int, np.ndarray] = (-1, np.empty(0, np.int64))

    def __iter__(self) -> Iterator:
        return self

    def _index(self, pos: int) -> int:
        epoch, k = divmod(pos, len(self._loader.source))
        if self._perm[0] != epoch:
            rng = np.random.default_rng([self._loader.seed, epoch])
            self._perm = (epoch, rng.permutation(len(self._loader.source)))
        return int(self._perm[1][k])

    def __next__(self) -> Tuple[np.ndarray, np.ndarray]:
        ld = self._loader
        end = self._pos + ld.batch_size
        if ld.num_epochs is not None and end > ld.num_epochs * len(ld.source):
            raise StopIteration
        items = [ld.source[self._index(p)] for p in range(self._pos, end)]
        self._pos = end
        return (np.stack([f for f, _ in items]),
                np.asarray([lbl for _, lbl in items], np.int32))

    def get_state(self) -> bytes:
        epoch, position = divmod(self._pos, len(self._loader.source))
        return json.dumps({"epoch": epoch, "position": position, "seed": self._loader.seed,
                           "source": repr(self._loader.source)}).encode()

    def set_state(self, state: bytes) -> None:
        rec = json.loads(state.decode())
        want = {"seed": self._loader.seed, "source": repr(self._loader.source)}
        got = {k: rec.get(k) for k in want}
        if got != want:
            raise ValueError(f"loader state is for {got}, not this loader's {want}")
        self._pos = rec["epoch"] * len(self._loader.source) + rec["position"]


def make_train_loader(records: Sequence[ClipRecord], pp: PreprocessConfig, batch_size: int,
                      *, seed: int = 0, num_epochs: Optional[int] = None) -> TrainLoader:
    """A :class:`TrainLoader` over ``records`` staged by ``pp``."""
    return TrainLoader(ClipDataSource(records, pp), batch_size, seed, num_epochs)
