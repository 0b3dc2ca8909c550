"""One-hot and RGB colour-key codecs (counterpart of
``mmr_tpu/ops/onehot.py``): the kornia-style ``one_hot`` of the dice loss
(``dice_loss.py:33,128-136``), ``utils.generateLabel4CE``'s RGB →
class-id matching (``utils.py:342-383``) and ``reverseOneHot``'s ids → RGB
(``utils.py:386-427``), each one vectorized comparison or gather."""

from __future__ import annotations

import numpy as np
import torch


def one_hot(labels: torch.Tensor, num_classes: int, dtype=torch.float32,
            axis: int = -1) -> torch.Tensor:
    """(..., H, W) int ids -> (..., H, W, C) (NHWC; ``axis=1`` moves the
    classes there, the reference's NCHW). Ids outside [0, C) give zeros."""
    classes = torch.arange(num_classes, dtype=torch.int32, device=labels.device)
    eye = (labels.to(torch.int32)[..., None] == classes).to(dtype)
    return eye if axis == -1 else torch.movedim(eye, -1, axis)


def rgb_to_ids(rgb: torch.Tensor, key: np.ndarray) -> torch.Tensor:
    """An RGB mask (..., H, W, 3) -> int32 class ids through the colour
    ``key`` ((C, 3) uint8, ``SegNetDataLoaderV1_SAR.py:77-95``): the first
    matching class; pixels matching none are 0 (background)."""
    key = torch.as_tensor(np.asarray(key), device=rgb.device).to(rgb.dtype)
    eq = (rgb[..., None, :] == key).all(-1)   # (..., H, W, C)
    ids = eq.to(torch.uint8).argmax(-1)
    return torch.where(eq.any(-1), ids, 0).to(torch.int32)


def ids_to_rgb(ids: torch.Tensor, key: np.ndarray) -> torch.Tensor:
    """Class ids (..., H, W) -> RGB (..., H, W, 3) uint8 through ``key``."""
    key = torch.as_tensor(np.asarray(key, np.uint8), device=ids.device)
    return key[ids.long()]
