"""Streaming segmentation evaluator — the Path-A ``utils.Evaluate``,
counterpart of ``mmr_tpu/metrics/evaluate.py``.

Each ``add_batch`` takes argmax ids (or logits, argmaxed here) and runs the
confusion kernel K7 (:func:`mmr_tpu_torch.ops.confusion.confusion_stats`)
on the device the tensors live on, adding its counts into an int64
``(3, C)`` tensor there: no copy to the host and no wait for the device.
``tp``, ``fp`` and ``fn`` are f64 numpy arrays, as in JAX: reading them
copies the device counts to the host once (after the last ``add_batch``),
and they can be assigned and added to in place (``ev.tp += ...``, as the
JAX trainer does). ``iou`` is ``tp / (tp + fp + fn + 1e-15)`` and
``precision_recall_f1`` uses the same epsilon, as the reference
(``utils.py:140-181``).

With a multi-rank ``mesh`` each rank adds its own slice's batches (its K7
launches count only those), and the device totals are summed over the
ranks when the host counts are read, so every rank reads the global
counts. Every rank must then add the same number of batches and read the
counts at the same points: the sum is a collective.
"""

from __future__ import annotations

import numpy as np
import torch

from mmr_tpu_torch.core.mesh import psum_if_sharded
from mmr_tpu_torch.ops import confusion


class Evaluate:
    def __init__(self, num_classes: int, mesh=None):
        self.num_classes = num_classes
        self.mesh = mesh
        self.reset()

    def reset(self) -> None:
        self._host = np.zeros((3, self.num_classes), np.float64)
        self._device: torch.Tensor | None = None   # int64 (3, C) counts
        self._pending = False                      # counts not yet on the host

    def add_batch(self, logits_or_ids: torch.Tensor, gt_ids: torch.Tensor) -> None:
        """``logits_or_ids``: (B, H, W, C) logits or probabilities, or (B, H,
        W) ids; ``gt_ids``: (B, H, W) int ids on the same device."""
        pred = logits_or_ids
        if pred.dim() == gt_ids.dim() + 1:
            pred = pred.argmax(-1)
        if self._device is None or self._device.device != gt_ids.device:
            self._fold()
            with torch.inference_mode(False):   # updated in and out of it
                self._device = torch.zeros((3, self.num_classes),
                                           dtype=torch.int64, device=gt_ids.device)
        confusion.confusion_stats(pred, gt_ids, self.num_classes, total=self._device)
        self._pending = True

    def _fold(self) -> np.ndarray:
        """The (3, C) host counts, the device's (summed over the mesh's
        ranks) added once since the last ``add_batch``."""
        if self._pending:
            total = self._device if self.mesh is None else psum_if_sharded(
                self._device, self.mesh)
            self._host += total.cpu().numpy()
            self._device.zero_()
            self._pending = False
        return self._host

    tp = property(lambda self: self._fold()[0],
                  lambda self, v: self._fold().__setitem__(0, v))
    fp = property(lambda self: self._fold()[1],
                  lambda self, v: self._fold().__setitem__(1, v))
    fn = property(lambda self: self._fold()[2],
                  lambda self, v: self._fold().__setitem__(2, v))

    def iou(self) -> tuple[np.ndarray, float]:
        per_class = self.tp / (self.tp + self.fp + self.fn + 1e-15)
        return per_class, float(per_class.mean())

    def precision_recall_f1(self):
        p = self.tp / (self.tp + self.fp + 1e-15)
        r = self.tp / (self.tp + self.fn + 1e-15)
        f1 = 2.0 * p * r / (p + r + 1e-15)
        return p, r, f1

    def mean_f1(self) -> float:
        _, _, f1 = self.precision_recall_f1()
        return float(f1.mean())
