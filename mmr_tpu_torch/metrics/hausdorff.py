"""Hausdorff distance between binary masks (counterpart of
``mmr_tpu/metrics/hausdorff.py``): the symmetric Hausdorff distance of the
nonzero-pixel coordinate sets (skimage's ``hausdorff_distance``), from
scipy KD-tree nearest-neighbour queries. Host-side, Path A's heavy metric:
the reference runs it per class on the every-25-epochs slow path, capping
∞ (one mask empty) at 1000 (``ModelTraining.py:47,622-654``)."""

from __future__ import annotations

import numpy as np
from scipy.spatial import cKDTree

INF_CAP = 1000.0  # ModelTraining.py:644


def hausdorff_distance(im1, im2) -> float:
    """0 for two empty masks, ∞ when one is empty."""
    a = np.argwhere(np.asarray(im1).astype(bool))
    b = np.argwhere(np.asarray(im2).astype(bool))
    if a.size == 0 and b.size == 0:
        return 0.0
    if a.size == 0 or b.size == 0:
        return float("inf")
    d_ab = cKDTree(b).query(a, k=1)[0].max()
    d_ba = cKDTree(a).query(b, k=1)[0].max()
    return float(max(d_ab, d_ba))


def capped_hausdorff(im1, im2) -> float:
    """Path A's flavour: ∞ → 1000 (``ModelTraining.py:640-644``)."""
    d = hausdorff_distance(im1, im2)
    return INF_CAP if np.isinf(d) else d
