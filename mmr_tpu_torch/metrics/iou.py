"""Metrics over confusion stats (counterpart of ``mmr_tpu/metrics/iou.py``:
smp ``iou_score`` etc. with ``reduction`` modes and ``zero_division=1.0``).
``reduction="macro"`` over batch-summed stats is the train step's per-batch
IoU; ``None`` the per-image form ``run_inference`` reports."""

from __future__ import annotations

import torch


def _safe_divide(num, den, zero_division: float):
    zero = den == 0
    score = num / torch.where(zero, torch.ones_like(den), den)
    return torch.where(zero, torch.full_like(score, zero_division), score)


def _reduce(metric_fn, tp, fp, fn, tn, reduction, zero_division):
    if reduction == "micro":
        return metric_fn(tp.sum(), fp.sum(), fn.sum(), tn.sum(), zero_division)
    if reduction == "macro":
        return metric_fn(tp.sum(0), fp.sum(0), fn.sum(0), tn.sum(0),
                         zero_division).mean()
    if reduction == "micro-imagewise":
        return metric_fn(tp.sum(1), fp.sum(1), fn.sum(1), tn.sum(1),
                         zero_division).mean()
    if reduction == "macro-imagewise":
        return metric_fn(tp, fp, fn, tn, zero_division).mean()
    if reduction is None or reduction == "none":
        return metric_fn(tp, fp, fn, tn, zero_division)
    raise ValueError(f"unknown reduction {reduction!r}")


def iou_score(tp, fp, fn, tn, reduction=None, zero_division=1.0):
    """tp / (tp + fp + fn), ``zero_division`` where the denominator is 0."""
    return _reduce(lambda tp, fp, fn, tn, zd: _safe_divide(tp, tp + fp + fn, zd),
                   tp, fp, fn, tn, reduction, zero_division)


def f1_score(tp, fp, fn, tn, reduction=None, zero_division=1.0):
    """2·tp / (2·tp + fp + fn), ``zero_division`` where the denominator is 0."""
    return _reduce(lambda tp, fp, fn, tn, zd: _safe_divide(2 * tp, 2 * tp + fp + fn, zd),
                   tp, fp, fn, tn, reduction, zero_division)


def precision(tp, fp, fn, tn, reduction=None, zero_division=1.0):
    """tp / (tp + fp), ``zero_division`` where the denominator is 0."""
    return _reduce(lambda tp, fp, fn, tn, zd: _safe_divide(tp, tp + fp, zd),
                   tp, fp, fn, tn, reduction, zero_division)


def recall(tp, fp, fn, tn, reduction=None, zero_division=1.0):
    """tp / (tp + fn), ``zero_division`` where the denominator is 0."""
    return _reduce(lambda tp, fp, fn, tn, zd: _safe_divide(tp, tp + fn, zd),
                   tp, fp, fn, tn, reduction, zero_division)
