"""Soft Dice loss with the reference's semantics (counterpart of
``mmr_tpu/losses/dice.py``): softmax over classes, one-hot target,
per-(sample, class) ``(2·I + eps) / (card + eps)`` over the spatial axes,
``mean(1 − dice)``; ``eps`` 1.0 and ``ignore_index`` truncating the
trailing class channels, as the reference's Path A does."""

from __future__ import annotations

import torch

from mmr_tpu_torch.ops.onehot import one_hot


def soft_dice_score(probs: torch.Tensor, target_onehot: torch.Tensor,
                    eps: float = 1.0, spatial_axes=(1, 2)) -> torch.Tensor:
    inter = (probs * target_onehot).sum(spatial_axes)
    card = (probs + target_onehot).sum(spatial_axes)
    return (2.0 * inter + eps) / (card + eps)


def dice_loss(logits: torch.Tensor, target: torch.Tensor, eps: float = 1.0,
              ignore_index: int | None = None) -> torch.Tensor:
    """``logits``: (N, H, W, C) raw scores; ``target``: (N, H, W) int ids."""
    if logits.dim() != 4 or logits.shape[:-1] != target.shape:
        raise ValueError(f"expected NHWC logits over target {tuple(target.shape)}, "
                         f"got {tuple(logits.shape)}")
    probs = torch.softmax(logits.float(), dim=-1)
    tgt = one_hot(target, logits.shape[-1])
    if ignore_index is not None:
        probs, tgt = probs[..., :ignore_index], tgt[..., :ignore_index]
    return (1.0 - soft_dice_score(probs, tgt, eps=eps)).mean()
