"""Structured logging and per-step metrics: log lines on stderr and one CSV
per metric schema. Counterpart of ``asltpu/utils/logging.py``; host-only,
standard library."""

from __future__ import annotations

import csv
import hashlib
import logging
import os
import sys
import time
from typing import Dict, Optional

_FORMAT = "%(asctime)s %(levelname).1s %(name)s] %(message)s"


def get_logger(name: str = "asltpu_torch") -> logging.Logger:
    """A logger writing ``HH:MM:SS L name] message`` lines to stderr, set up
    once per name; it does not propagate to the root logger."""
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(_FORMAT, "%H:%M:%S"))
        logger.addHandler(handler)
        logger.setLevel(logging.INFO)
        logger.propagate = False
    return logger


class MetricsWriter:
    """Per-step scalar metrics → log line + CSV row.

    Usable as the ``metric_writer`` callback of
    :func:`asltpu_torch.train.loop.train`.
    """

    def __init__(self, log_dir: Optional[str] = None, name: str = "train"):
        self._log = get_logger(f"asltpu_torch.{name}")
        self._log_dir = log_dir
        self._name = name
        self._seen_schemas: Dict[tuple, str] = {}
        self._t0 = time.time()
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)

    def __call__(self, step: int, metrics: Dict[str, float]):
        self.write(step, metrics)

    def _csv_for(self, keys: tuple) -> str:
        """One CSV per metric schema, so interleaved train and eval writes
        land in separate well-formed files. The name follows from the
        schema's content (not the order of first appearance), so a resumed
        run appends to the same file; the header is written only when the
        file is new."""
        if keys not in self._seen_schemas:
            metric_keys = [k for k in keys if k not in ("step", "wall_time")]
            if any(k.startswith("eval_") for k in metric_keys):
                suffix = "_eval"
            elif "loss" in metric_keys:
                suffix = ""
            else:
                suffix = "_" + hashlib.sha1(",".join(metric_keys).encode()).hexdigest()[:6]
            path = os.path.join(self._log_dir, f"{self._name}_metrics{suffix}.csv")
            if not os.path.exists(path):
                with open(path, "a", newline="") as f:
                    csv.DictWriter(f, fieldnames=list(keys)).writeheader()
            self._seen_schemas[keys] = path
        return self._seen_schemas[keys]

    def write(self, step: int, metrics: Dict[str, float]):
        parts = " ".join(f"{k}={v:.4g}" for k, v in sorted(metrics.items()))
        self._log.info("step %d: %s", step, parts)
        if self._log_dir:
            keys = tuple(["step", "wall_time"] + sorted(metrics))
            row = {"step": step, "wall_time": round(time.time() - self._t0, 3),
                   **{k: metrics[k] for k in sorted(metrics)}}
            with open(self._csv_for(keys), "a", newline="") as f:
                csv.DictWriter(f, fieldnames=list(keys)).writerow(row)
