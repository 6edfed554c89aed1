"""Accuracy evaluation. Counterpart of ``asltpu/eval``."""

from asltpu_torch.eval.metrics import (  # noqa: F401
    confusion_matrix,
    evaluate_split,
    per_class_metrics,
    topk_accuracy,
)
