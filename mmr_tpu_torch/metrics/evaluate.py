"""Streaming segmentation evaluator — the Path-A ``utils.Evaluate``,
counterpart of ``mmr_tpu/metrics/evaluate.py``.

Each ``add_batch`` takes argmax ids (or logits, argmaxed here), runs the
confusion kernel K7 (:func:`mmr_tpu_torch.ops.confusion.confusion_stats`)
on the device the tensors live on, and adds its three (C,) counts to f64
host counters. ``iou`` is ``tp / (tp + fp + fn + 1e-15)`` and
``precision_recall_f1`` uses the same epsilon, as the reference
(``utils.py:140-181``).
"""

from __future__ import annotations

import numpy as np
import torch

from mmr_tpu_torch.ops import confusion


class Evaluate:
    def __init__(self, num_classes: int):
        self.num_classes = num_classes
        self.reset()

    def reset(self) -> None:
        self.tp = np.zeros(self.num_classes, np.float64)
        self.fp = np.zeros(self.num_classes, np.float64)
        self.fn = np.zeros(self.num_classes, np.float64)

    def add_batch(self, logits_or_ids: torch.Tensor, gt_ids: torch.Tensor) -> None:
        """``logits_or_ids``: (B, H, W, C) logits or probabilities, or (B, H,
        W) ids; ``gt_ids``: (B, H, W) int ids on the same device."""
        pred = logits_or_ids
        if pred.dim() == gt_ids.dim() + 1:
            pred = pred.argmax(-1)
        tp, fp, fn = confusion.confusion_stats(pred, gt_ids, self.num_classes)
        self.tp += tp.cpu().double().numpy()
        self.fp += fp.cpu().double().numpy()
        self.fn += fn.cpu().double().numpy()

    def iou(self) -> tuple[np.ndarray, float]:
        per_class = self.tp / (self.tp + self.fp + self.fn + 1e-15)
        return per_class, float(per_class.mean())

    def precision_recall_f1(self):
        p = self.tp / (self.tp + self.fp + 1e-15)
        r = self.tp / (self.tp + self.fn + 1e-15)
        f1 = 2.0 * p * r / (p + r + 1e-15)
        return p, r, f1
