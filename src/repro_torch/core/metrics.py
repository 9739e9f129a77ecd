"""Evaluation metrics from the paper (§1.2): accuracy, precision, recall,
F1, balanced accuracy, confusion matrix — plus the paper's build /
classification wall-clock timers.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional

import numpy as np
import torch


def confusion_matrix(y_true, y_pred, num_classes: int) -> np.ndarray:
    cm = np.zeros((num_classes, num_classes), dtype=np.int64)
    np.add.at(cm, (np.asarray(y_true), np.asarray(y_pred)), 1)
    return cm


def classification_metrics(y_true, y_pred, num_classes: int
                           ) -> Dict[str, float]:
    """Macro-averaged precision/recall/F1 + accuracy + balanced accuracy,
    per the paper's Eqs. (1)-(4)."""
    cm = confusion_matrix(y_true, y_pred, num_classes)
    tp = np.diag(cm).astype(np.float64)
    fp = cm.sum(axis=0) - tp
    fn = cm.sum(axis=1) - tp
    support = cm.sum(axis=1)

    with np.errstate(divide="ignore", invalid="ignore"):
        precision = np.where(tp + fp > 0, tp / (tp + fp), 0.0)
        recall = np.where(tp + fn > 0, tp / (tp + fn), 0.0)
        f1 = np.where(precision + recall > 0,
                      2 * precision * recall / (precision + recall), 0.0)
    present = support > 0
    return {
        "accuracy": float(tp.sum() / max(1, cm.sum())),
        "precision": float(precision[present].mean()),
        "recall": float(recall[present].mean()),
        "f1": float(f1[present].mean()),
        "balanced_accuracy": float(recall[present].mean()),
        "confusion": cm,
    }


@dataclasses.dataclass
class Timer:
    """Paper §1.2.6/§1.2.7: Build Time / Classification Time =
    end - start wall-clock.

    With a CUDA `device` the timer synchronizes the card on entry and on
    exit, so the window measures finished work (DESIGN.md §3), not the
    enqueue of asynchronous launches."""
    start_time: Optional[float] = None
    elapsed: float = 0.0
    device: Optional[torch.device] = None

    def _sync(self):
        if self.device is not None and torch.device(self.device).type == "cuda":
            torch.cuda.synchronize(self.device)

    def __enter__(self):
        self._sync()
        self.start_time = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._sync()
        self.elapsed += time.perf_counter() - self.start_time
        self.start_time = None
        return False
