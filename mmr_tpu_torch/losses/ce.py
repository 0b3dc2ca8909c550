"""Cross-entropy with ``torch.nn.CrossEntropyLoss`` semantics
(counterpart of ``mmr_tpu/losses/ce.py``): the mean over pixels of
−log softmax at the target class; ``ignore_index`` pixels leave both the
sum and the count."""

from __future__ import annotations

import torch

from mmr_tpu_torch.ops.onehot import one_hot


def cross_entropy_loss(logits: torch.Tensor, target: torch.Tensor,
                       ignore_index: int | None = None,
                       label_smoothing: float = 0.0) -> torch.Tensor:
    """``logits``: (N, H, W, C); ``target``: (N, H, W) int ids (clipped to
    [0, C) for the lookup, as the reference does)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    num_classes = logits.shape[-1]
    nll = -(logp * one_hot(target.clamp(0, num_classes - 1), num_classes)).sum(-1)
    if label_smoothing > 0.0:
        nll = (1.0 - label_smoothing) * nll - label_smoothing * logp.mean(-1)
    if ignore_index is not None:
        mask = (target != ignore_index).float()
        return (nll * mask).sum() / mask.sum().clamp_min(1.0)
    return nll.mean()
