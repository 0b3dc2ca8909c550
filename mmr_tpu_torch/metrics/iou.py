"""IoU over confusion stats (smp ``iou_score`` with ``reduction=None`` and
``zero_division=1.0``) — the per-image form ``run_inference`` reports. The
other reductions and metrics of ``mmr_tpu/metrics/iou.py`` wait for the
train slice (ROADMAP)."""

from __future__ import annotations

import torch


def iou_score(tp, fp, fn, tn) -> torch.Tensor:
    """Per-image per-class tp / (tp + fp + fn); 1.0 where the denominator
    is 0 (smp's default ``zero_division``)."""
    den = tp + fp + fn
    zero = den == 0
    score = tp / torch.where(zero, torch.ones_like(den), den)
    return torch.where(zero, torch.ones_like(score), score)
