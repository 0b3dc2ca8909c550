"""Per-image per-class confusion statistics (smp ``get_stats``,
``mode='multiclass'``) — counterpart of ``mmr_tpu/metrics/confusion.py``."""

from __future__ import annotations

import torch


def segmentation_stats(pred_ids: torch.Tensor, gt_ids: torch.Tensor,
                       num_classes: int, ignore_index: int | None = None):
    """``pred_ids``/``gt_ids``: (B, ...) integer maps -> (tp, fp, fn, tn),
    each (B, num_classes) f32. Pixels whose ground truth is
    ``ignore_index`` count nowhere."""
    b = pred_ids.shape[0]
    pred = pred_ids.reshape(b, -1).long()
    gt = gt_ids.reshape(b, -1).long()
    if ignore_index is not None:
        valid = gt != ignore_index
    else:
        valid = torch.ones_like(gt, dtype=torch.bool)
    classes = torch.arange(num_classes, device=pred.device)
    pred_oh = (pred[..., None] == classes) & valid[..., None]  # (B, P, C)
    gt_oh = (gt[..., None] == classes) & valid[..., None]
    tp = (pred_oh & gt_oh).sum(dim=1, dtype=torch.float32)
    p_cnt = pred_oh.sum(dim=1, dtype=torch.float32)
    g_cnt = gt_oh.sum(dim=1, dtype=torch.float32)
    n_valid = valid.sum(dim=1, keepdim=True, dtype=torch.float32)
    fp = p_cnt - tp
    fn = g_cnt - tp
    tn = n_valid - tp - fp - fn
    return tp, fp, fn, tn
