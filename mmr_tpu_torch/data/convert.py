"""Offline dataset tooling (counterpart of the parts of
``mmr_tpu/data/convert.py`` that need no video decoder):

- :func:`_mask_frame_mapping` and :func:`_read_mask`, the annotation side
  of ``mmr_create_dataset`` (``Data_Loader.py:186-248, 349-353``), masks
  decoded by :mod:`mmr_tpu_torch.data.png`;
- :func:`write_mini_split`, the mini-dataset notebook's hand-written split
  (``Mini_Dataset_ZarrFile.ipynb``);
- :func:`calculate_dataset_statistics`, Path A's mean / std over ≤ 100
  sampled images (``data_preprocessing.py:159-210``).

``convert_zip_dataset``, ``extract_frames_*`` and ``mmr_create_dataset``
decode AVI video with ``cv2.VideoCapture`` in the JAX package; they wait
for a video decoder here.
"""

from __future__ import annotations

import json
import logging
from pathlib import Path

import numpy as np

from mmr_tpu_torch.data import png


def _mask_frame_mapping(names: list[str]) -> dict[int, str]:
    """Mask file path → annotated frame number (stem digits),
    ``Data_Loader.py:186-248``."""
    out = {}
    for name in names:
        p = Path(name)
        if p.suffix.lower() != ".png" or p.name.startswith("."):
            continue
        digits = "".join(ch for ch in p.stem if ch.isdigit())
        if digits:
            out[int(digits)] = name
    return out


def _read_mask(data: bytes) -> np.ndarray:
    """A mask PNG's bytes → (H, W) uint8 class ids; a colour-coded mask's
    channels collapse by their max (``Data_Loader.py:349-353``)."""
    mask = png.decode(data, samples=True)[0]
    if mask.ndim == 3:
        mask = mask.max(-1)
    return mask.astype(np.uint8)


def write_mini_split(out_root: str | Path, train_fraction: float = 0.8) -> Path:
    """Hand-write the mini-dataset ``train_val_test_split.json`` over the
    converted videos (the notebook's split cell: e.g. 8/2 or 4/1 train/val
    videos). At least one video lands in val; test mirrors val."""
    out_root = Path(out_root)
    ids = sorted(p.name.replace(".zarr", "")
                 for p in (out_root / "data").glob("*.zarr"))
    if not ids:
        raise FileNotFoundError(f"no converted videos under {out_root}")
    if len(ids) == 1:
        logging.getLogger("mmr_tpu_torch").warning(
            "mini split over a single video: train == val == test — "
            "validation/test metrics will be train-set leakage; convert "
            ">= 2 videos for a meaningful split")
    n_train = (max(1, min(len(ids) - 1, int(round(len(ids) * train_fraction))))
               if len(ids) > 1 else 1)
    split = {"train": ids[:n_train], "val": ids[n_train:] or ids[-1:],
             "test": ids[n_train:] or ids[-1:]}
    path = out_root / "train_val_test_split.json"
    path.write_text(json.dumps(split, indent=2))
    return path


def calculate_dataset_statistics(images_dir: str | Path,
                                 max_images: int = 100,
                                 seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Per-channel RGB mean / std of values in [0, 1] over ≤ ``max_images``
    sampled PNGs (``data_preprocessing.py:159-210``)."""
    paths = sorted(Path(images_dir).glob("*.png"))
    if not paths:
        raise FileNotFoundError(f"no PNGs under {images_dir}")
    rng = np.random.RandomState(seed)
    if len(paths) > max_images:
        paths = [paths[i] for i in rng.choice(len(paths), max_images, replace=False)]
    acc = np.zeros(3), np.zeros(3)
    for p in paths:
        img = png.read(p)
        if img.ndim == 2:   # cv2.imread gives a grey file three equal channels
            img = np.repeat(img[..., None], 3, -1)
        img = img / 255.0
        acc = acc[0] + img.mean((0, 1)), acc[1] + (img ** 2).mean((0, 1))
    mean = acc[0] / len(paths)
    std = np.sqrt(np.maximum(acc[1] / len(paths) - mean ** 2, 0))
    return mean.astype(np.float32), std.astype(np.float32)
