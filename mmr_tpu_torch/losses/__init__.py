"""Losses (counterparts of ``mmr_tpu/losses``), NHWC logits / int targets."""

from mmr_tpu_torch.losses.ce import cross_entropy_loss
from mmr_tpu_torch.losses.dice import dice_loss, soft_dice_score
from mmr_tpu_torch.losses.dice_ce import blended_ce_dice_loss, dice_ce_loss

__all__ = ["cross_entropy_loss", "dice_loss", "soft_dice_score",
           "blended_ce_dice_loss", "dice_ce_loss"]
