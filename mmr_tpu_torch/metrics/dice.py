"""Scalar binary Dice coefficient (counterpart of
``mmr_tpu/metrics/dice.py``; reference ``utils.py:523-575``):
``2|A∩B| / (|A|+|B|)`` over boolean masks, 1.0 when both are empty.
Host-side numpy: Path A's heavy metric, off the step path."""

from __future__ import annotations

import numpy as np


def binary_dice(im1, im2) -> float:
    im1 = np.asarray(im1).astype(bool)
    im2 = np.asarray(im2).astype(bool)
    if im1.shape != im2.shape:
        raise ValueError("Shape mismatch: im1 and im2 must have the same shape.")
    im_sum = im1.sum() + im2.sum()
    if im_sum == 0:
        return 1.0
    return 2.0 * np.logical_and(im1, im2).sum() / im_sum
