"""Evaluation: top-1 / top-5, the confusion matrix, per-class (macro)
accuracy, and a WLASL split through ``stream_predict``. Counterpart of
``asltpu/eval/metrics.py``."""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from asltpu_torch.api import Model, gloss_label, stream_predict
from asltpu_torch.data.wlasl import ClipRecord


def topk_entries(logits, gloss_names=None, k: int = 5):
    """[C] logits → top-k [{gloss, logit}]; ids past a short name list stay
    integers."""
    idx = np.argsort(-logits)[:k]
    return [{"gloss": gloss_label(i, gloss_names), "logit": round(float(logits[i]), 4)}
            for i in idx]


def topk_accuracy(logits: np.ndarray, labels: np.ndarray,
                  ks: Sequence[int] = (1, 5)) -> Dict[str, float]:
    """logits [N, C], labels [N] → {"top1": ..., "top5": ...}."""
    order = np.argsort(-logits, axis=-1)
    out = {}
    for k in ks:
        hit = (order[:, :k] == labels[:, None]).any(axis=1)
        out[f"top{k}"] = float(hit.mean()) if len(labels) else 0.0
    return out


def confusion_matrix(logits: np.ndarray, labels: np.ndarray,
                     num_classes: Optional[int] = None) -> np.ndarray:
    """logits [N, C] (or predictions [N]), labels [N] → [C, C] counts, rows
    the true class, columns the argmax prediction."""
    preds = logits if logits.ndim == 1 else np.argmax(logits, axis=-1)
    if num_classes is None:
        num_classes = logits.shape[-1] if logits.ndim > 1 else (
            int(max(preds.max(initial=0), labels.max(initial=0))) + 1)
    cm = np.zeros((num_classes, num_classes), dtype=np.int64)
    np.add.at(cm, (labels.astype(np.int64), preds.astype(np.int64)), 1)
    return cm


def per_class_metrics(logits: np.ndarray, labels: np.ndarray,
                      gloss_names: Optional[Sequence[str]] = None) -> Dict:
    """Per-class recall and its mean over the classes present in
    ``labels`` (macro top-1, the WLASL papers' aggregate beside instance
    top-k): ``{"macro_top1", "per_class": [{gloss, top1, n}, ...]}``, the
    rows worst first."""
    cm = confusion_matrix(logits, labels)
    support = cm.sum(axis=1)
    present = np.nonzero(support)[0]
    acc = cm[present, present] / support[present]
    rows = [{"gloss": gloss_label(c, gloss_names), "top1": round(float(a), 4),
             "n": int(support[c])} for c, a in zip(present, acc)]
    rows.sort(key=lambda r: (r["top1"], -r["n"]))
    return {"macro_top1": float(acc.mean()) if len(acc) else 0.0, "per_class": rows}


def evaluate_split(
    model: Model,
    records: Sequence[ClipRecord],
    batch_size: int = 16,
    num_decode_workers: int = 4,
    landmarks_for=None,
    max_clips: Optional[int] = None,
    skip_errors: bool = False,
    per_class: bool = False,
    gloss_names: Optional[Sequence[str]] = None,
) -> Dict[str, float]:
    """Streaming inference over a WLASL split → top-1/top-5. With
    ``skip_errors`` undecodable clips are dropped, counted in
    ``num_skipped`` and left out of the denominator; ``per_class`` adds
    :func:`per_class_metrics`."""
    records = [r for r in records if r.path][:max_clips]
    results = list(stream_predict(
        model, records, batch_size=batch_size, num_decode_workers=num_decode_workers,
        landmarks_for=landmarks_for, skip_errors=skip_errors,
        # Keyed by record, not path: two segments of one video stay apart.
        yield_items=True,
    ))
    if not results:
        return {"top1": 0.0, "top5": 0.0, "num_clips": 0.0,
                "num_skipped": float(len(records))}
    logits = np.stack([lg for _, _, lg in results])
    labels = np.asarray([rec.label for rec, _, _ in results])
    metrics = topk_accuracy(logits, labels)
    metrics["num_clips"] = float(len(results))
    metrics["num_skipped"] = float(len(records) - len(results))
    if per_class:
        metrics.update(per_class_metrics(logits, labels, gloss_names))
    return metrics
