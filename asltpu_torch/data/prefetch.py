"""Double-buffered host→device prefetcher, so video decode and the copy to
the card overlap the model's compute. Counterpart of
``asltpu/data/prefetch.py``.

A background thread drains the host iterator into a bounded queue. For a
CUDA device it also pins each numpy array of a batch and starts its copy on
a stream of its own (``non_blocking``), recording an event after the copy.
The consumer makes its current stream wait on that event before it uses the
batch, so the copy of batch i+1 runs while the card computes batch i.

Spans (``batch``: the batch's index in the stream): ``prefetch.pin`` (pin
and copy enqueue) and ``prefetch.put_wait`` (blocked on a full queue) on
the background thread, ``stream.wait`` (the consumer's wait for a batch).
"""

from __future__ import annotations

import itertools
import queue
import threading
from typing import Any, Iterable, Iterator, Optional, Union

import numpy as np
import torch

from asltpu_torch.utils.profiling import span


def resolve_device(device: Union[None, str, torch.device]) -> torch.device:
    """``None`` means the card; asking for a card where there is none raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return dev


class Prefetcher:
    """Wrap a host-batch iterator with a bounded decode-ahead queue.

    A batch is a tuple; each numpy array in it becomes a tensor on
    ``device``, other items pass through unchanged.

    Args:
      host_iter: yields host-side batches.
      depth: number of batches kept ahead (2 = double buffering).
      device: where the arrays go: the card by default
        (:func:`resolve_device`), which raises where there is none.
    """

    _SENTINEL = object()

    def __init__(self, host_iter: Iterable[tuple], depth: int = 2,
                 device: Union[None, str, torch.device] = None):
        self._device = resolve_device(device)
        self._host_iter = iter(host_iter)
        self._copy_stream = (
            torch.cuda.Stream(self._device) if self._device.type == "cuda" else None
        )
        self._err: Optional[BaseException] = None
        self._stop = threading.Event()
        self._q: queue.Queue = queue.Queue(maxsize=max(1, depth))
        self._thread = threading.Thread(
            target=self._worker, name="asltpu-torch-prefetch", daemon=True
        )
        self._thread.start()

    def _to_device(self, batch: tuple):
        """(device batch, event or None), started on the copy stream."""
        if self._copy_stream is None:
            return tuple(
                torch.from_numpy(x).to(self._device) if isinstance(x, np.ndarray)
                else x for x in batch
            ), None
        with torch.cuda.stream(self._copy_stream):
            out = tuple(
                torch.from_numpy(x).pin_memory().to(self._device, non_blocking=True)
                if isinstance(x, np.ndarray) else x for x in batch
            )
            done = torch.cuda.Event()
            done.record(self._copy_stream)
        return out, done

    def _worker(self):
        try:
            for b, batch in enumerate(self._host_iter):
                if self._stop.is_set():
                    break
                with span("prefetch.pin", batch=b):
                    item = self._to_device(batch)
                with span("prefetch.put_wait", batch=b):
                    while not self._stop.is_set():
                        try:
                            self._q.put(item, timeout=0.1)
                            break
                        except queue.Full:
                            continue
        except BaseException as e:  # handed to the consumer, which re-raises
            self._err = e
        finally:
            # The sentinel must reach a live consumer, but close() may have
            # abandoned the consumer side: bound each attempt.
            while True:
                try:
                    self._q.put(self._SENTINEL, timeout=0.1)
                    break
                except queue.Full:
                    if self._stop.is_set():
                        break

    def close(self):
        """Stop the background thread and release in-flight batches. Safe to
        call more than once."""
        self._stop.set()
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        self._thread.join(timeout=5)

    def __enter__(self) -> "Prefetcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __iter__(self) -> Iterator[Any]:
        for b in itertools.count():
            with span("stream.wait", batch=b):
                item = self._q.get()
            if item is self._SENTINEL:
                if self._err is not None:
                    raise self._err
                return
            batch, done = item
            if done is not None:
                stream = torch.cuda.current_stream(self._device)
                stream.wait_event(done)
                for x in batch:
                    if isinstance(x, torch.Tensor):
                        # Allocated on the copy stream, used on this one.
                        x.record_stream(stream)
            yield batch
