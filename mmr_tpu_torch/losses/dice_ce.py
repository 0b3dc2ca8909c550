"""Dice + CE blends (counterpart of ``mmr_tpu/losses/dice_ce.py``):
Path A's convex blend and Path B's MONAI ``DiceCELoss(softmax=True)``."""

from __future__ import annotations

import torch

from mmr_tpu_torch.losses.ce import cross_entropy_loss
from mmr_tpu_torch.losses.dice import dice_loss
from mmr_tpu_torch.ops.onehot import one_hot


def blended_ce_dice_loss(logits: torch.Tensor, target: torch.Tensor,
                         dice_loss_factor: float = 0.5, eps: float = 1.0,
                         ignore_index: int | None = None) -> torch.Tensor:
    """``f·dice + (1 − f)·CE``; ``dice_loss_factor = -1`` is CE alone."""
    if dice_loss_factor == -1:
        return cross_entropy_loss(logits, target)
    return (dice_loss_factor * dice_loss(logits, target, eps, ignore_index)
            + (1.0 - dice_loss_factor) * cross_entropy_loss(logits, target))


# MONAI DiceLoss' smoothing (smooth_nr = smooth_dr), the reference's setting
SMOOTH = 1e-5


def dice_ce_loss(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """MONAI ``DiceCELoss(softmax=True)``: include background, per-sample
    per-class dice meaned over (B, C), plus CE meaned over pixels."""
    logits = logits.float()
    probs = torch.softmax(logits, dim=-1)
    tgt = one_hot(target, logits.shape[-1])
    inter = (probs * tgt).sum((1, 2))
    denom = probs.sum((1, 2)) + tgt.sum((1, 2))
    dice = 1.0 - (2.0 * inter + SMOOTH) / (denom + SMOOTH)
    return dice.mean() + cross_entropy_loss(logits, target)
