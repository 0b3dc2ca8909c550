"""Synthetic SAR-RARP50-like frames (numpy only) — the frame renderer of
``mmr_tpu/data/synthetic.py``: bright elliptic "tools" per class on a dark
textured background. The Zarr store writer waits (ROADMAP)."""

from __future__ import annotations

import numpy as np


def render_frame(rng: np.random.RandomState, h: int, w: int, n_classes: int):
    """-> (image (h, w, 3) f32 in [0, 1], mask (h, w) uint8 in
    [0, n_classes])."""
    img = rng.rand(h, w, 3).astype(np.float32) * 0.2 + 0.1
    mask = np.zeros((h, w), np.uint8)
    yy, xx = np.mgrid[0:h, 0:w]
    for cls in range(1, n_classes + 1):
        if rng.rand() < 0.6:
            cy, cx = rng.randint(0, h), rng.randint(0, w)
            ry, rx = rng.randint(h // 12, h // 4), rng.randint(w // 12, w // 4)
            angle = rng.rand() * np.pi
            ca, sa = np.cos(angle), np.sin(angle)
            u = (yy - cy) * ca + (xx - cx) * sa
            v = -(yy - cy) * sa + (xx - cx) * ca
            blob = (u / ry) ** 2 + (v / rx) ** 2 < 1.0
            mask[blob] = cls
            color = np.asarray([0.3 + 0.7 * ((cls >> i) & 1) for i in range(3)],
                               np.float32)
            img[blob] = (color * (0.7 + 0.3 * rng.rand())
                         + 0.05 * rng.rand(int(blob.sum()), 3))
    return img, mask
