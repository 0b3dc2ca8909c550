"""Synthetic SAR-RARP50-like mini datasets (counterpart of
``mmr_tpu/data/synthetic.py``), for tests and smoke runs: the frame
renderer (bright elliptic "tools" per class on a dark textured
background) and :func:`make_synthetic_dataset`, which writes N small
"videos" in the Zarr store schema with a split file — the role of the
reference's ``Mini_Dataset_ZarrFile.ipynb``."""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from mmr_tpu_torch.data.zarr_io import VideoStore


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


def make_synthetic_dataset(
    path: str | Path,
    n_videos: int = 2,
    frames_per_video: int = 6,
    height: int = 96,
    width: int = 128,
    n_classes: int = 3,
    patch_size: tuple[int, int] = (64, 64),
    seed: int = 0,
    image_dtype=np.float32,
) -> Path:
    """Write ``<path>/data/data_NNN.zarr`` stores (≤ 50 sampled foreground
    coordinates per class per frame in ``class_locations``) and a
    ``train_val_test_split.json`` over all videos; returns the dataset
    root."""
    root = Path(path)
    (root / "data").mkdir(parents=True, exist_ok=True)
    rng = np.random.RandomState(seed)
    names = []
    for v in range(n_videos):
        name = f"data_{v:03d}"
        store = VideoStore.create(root / "data" / f"{name}.zarr",
                                  frames_per_video, height, width, patch_size,
                                  image_dtype=image_dtype)
        class_locations = {str(c): [] for c in range(1, n_classes + 1)}
        for t in range(frames_per_video):
            img, mask = render_frame(rng, height, width, n_classes)
            store.write_frame(t, img.transpose(2, 0, 1), mask)
            for c in range(1, n_classes + 1):
                coords = np.argwhere(mask == c)
                if coords.shape[0] == 0:
                    continue
                if coords.shape[0] > 50:
                    coords = coords[rng.choice(coords.shape[0], 50, replace=False)]
                class_locations[str(c)].extend(
                    [(t, int(y), int(x)) for y, x in coords])
        store.set_properties({"class_locations": class_locations})
        names.append(name)

    if n_videos >= 3:
        split = {"train": names[:-2], "val": [names[-2]], "test": [names[-1]]}
    elif n_videos == 2:
        split = {"train": [names[0]], "val": [names[1]], "test": [names[1]]}
    else:
        split = {"train": names, "val": names, "test": names}
    (root / "train_val_test_split.json").write_text(json.dumps(split, indent=2))
    return root
