"""PNG-folder dataset (Path A's ``SegNetDataset``,
``SegNetDataLoaderV1_SAR.py``), counterpart of
``mmr_tpu/data/png_dataset.py``.

Directory convention: ``<root>/<split>/{images,groundtruth}/*.png`` with
matching filenames (``:39-41,117-127``). Per item:

- image: PNG → RGB float32 [0, 1], resized bilinear to the CLI's
  ``resizedHeight/Width``;
- mask: read unchanged (``cv2.IMREAD_UNCHANGED``): a greyscale id-coded
  PNG of 8 or 16 bits (SAR-RARP50: pixel value = class id, clamped to [0,
  n_classes-1], ``:172-176``) or RGB colour-coded (matched against the
  class key, ``:178-183``), resized nearest. A mask with alpha (grey +
  alpha, RGBA, or ``tRNS``) reads as four channels, which the JAX class
  compares with the three-channel key and fails on (numpy cannot
  broadcast them); the port raises ``ValueError`` naming the file;
- optional in-RAM caching (the ``SegNetDataLoaderV2`` capability, a flag).

PNGs are decoded by :mod:`mmr_tpu_torch.data.png` and resized on the host
by :func:`resize_linear` and :func:`resize_nearest`, which follow
``cv2.resize``'s rules for uint8 (the JAX class calls it): masks come out
equal to the JAX class's and images within one level of 255 of them. An
RGB mask is matched in RGB order against the key (the JAX class matches
cv2's BGR pixels against the RGB key). Augmentation runs on the device in
the train step (:func:`mmr_tpu_torch.data.augment.augment_path_a_batch`);
batches come from :meth:`PngFolderDataset.epoch` as NHWC numpy arrays.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from mmr_tpu_torch.data import png
from mmr_tpu_torch.data.classes import sarrarp50_key

_COEF_BITS = 11   # cv2's INTER_RESIZE_COEF_BITS: 11-bit fixed-point weights


def resize_nearest(img: np.ndarray, hw: tuple[int, int]) -> np.ndarray:
    """``cv2.resize(img, (w, h), interpolation=cv2.INTER_NEAREST)``: source
    index ``floor(dst · (1 / (dst_size / src_size)))``, in f64."""
    h, w = hw
    sh, sw = img.shape[:2]
    ys = np.minimum(np.floor(np.arange(h) * (1.0 / (h / sh))).astype(np.int64), sh - 1)
    xs = np.minimum(np.floor(np.arange(w) * (1.0 / (w / sw))).astype(np.int64), sw - 1)
    return img[ys[:, None], xs[None, :]]


def _taps(dst: int, src: int):
    """cv2's linear taps of one axis: source index and 11-bit weights of
    the two neighbours, from the half-pixel centre in f32, clamped at the
    edges to the edge pixel with weight 1."""
    scale = 1.0 / (dst / src)
    f = ((np.arange(dst) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = (f - s.astype(np.float32)).astype(np.float32)
    edge = (s < 0) | (s >= src - 1)
    f[edge] = 0.0
    s = np.clip(s, 0, src - 1)
    one = np.float32(1 << _COEF_BITS)
    w0 = np.rint((np.float32(1.0) - f) * one).astype(np.int64)
    w1 = np.rint(f * one).astype(np.int64)
    return s, np.minimum(s + 1, src - 1), w0, w1


def resize_linear(img: np.ndarray, hw: tuple[int, int]) -> np.ndarray:
    """``cv2.resize(img, (w, h), interpolation=cv2.INTER_LINEAR)`` of a
    uint8 (H, W) or (H, W, C) image: an exact 2× reduction averages 2×2
    blocks (cv2 takes INTER_AREA there), anything else is cv2's fixed-point
    bilinear — a horizontal pass with 11-bit weights, then a vertical pass
    that rounds as cv2's vector code does."""
    h, w = hw
    sh, sw = img.shape[:2]
    x = img.astype(np.int64)
    if (sh, sw) == (2 * h, 2 * w):
        s = x[0::2, 0::2] + x[0::2, 1::2] + x[1::2, 0::2] + x[1::2, 1::2]
        return ((s + 2) >> 2).astype(np.uint8)
    xs0, xs1, a0, a1 = _taps(w, sw)
    ys0, ys1, b0, b1 = _taps(h, sh)
    extra = (None,) * (img.ndim - 2)
    rows = x[:, xs0] * a0[(None, slice(None)) + extra] + x[:, xs1] * a1[(None, slice(None)) + extra]
    r0, r1 = rows[ys0] >> 4, rows[ys1] >> 4
    bs = (slice(None), None) + extra
    v = ((r0 * b0[bs]) >> 16) + ((r1 * b1[bs]) >> 16)
    return np.clip((v + 2) >> 2, 0, 255).astype(np.uint8)


class PngFolderDataset:
    def __init__(
        self,
        root: str | Path,
        split: str = "train",
        resized_hw: tuple[int, int] = (256, 256),
        crop_size: int = 256,
        num_classes: int = 10,
        color_key: np.ndarray | None = None,
        cache_in_ram: bool = False,
        full_res: bool = False,
    ):
        self.root = Path(root) / split
        self.img_dir = self.root / "images"
        self.gt_dir = self.root / "groundtruth"
        if not self.img_dir.is_dir():
            raise FileNotFoundError(str(self.img_dir))
        self.files = sorted(p.name for p in self.img_dir.glob("*.png"))
        if not self.files:
            raise FileNotFoundError(f"no PNGs under {self.img_dir}")
        self.split = split
        self.resized_hw = resized_hw
        self.crop_size = crop_size
        self.num_classes = num_classes
        self.key = color_key if color_key is not None else sarrarp50_key()
        self.full_res = full_res
        self._cache: dict[int, tuple[np.ndarray, np.ndarray]] | None = (
            {} if cache_in_ram else None)

    def __len__(self):
        return len(self.files)

    # train images resize to 540×960 before the random crop — the reference's
    # fixed train-time size (SegNetDataLoaderV1_SAR.py:153-156)
    TRAIN_RESIZE_HW = (540, 960)

    def _load(self, i: int, crop_rng: np.random.RandomState | None = None
              ) -> tuple[np.ndarray, np.ndarray]:
        random_crop = (self.split == "train" and self.crop_size == -1
                       and not self.full_res)
        if self._cache is not None and i in self._cache:
            if not random_crop:
                return self._cache[i]
            # the cache holds the resized pair before its crop
            return self._random_crop(*self._cache[i], crop_rng)
        name = self.files[i]
        img = png.read(self.img_dir / name)
        gt_path = self.gt_dir / name
        if not gt_path.exists():
            raise FileNotFoundError(str(gt_path))
        gt = png.read(gt_path, unchanged=True)
        if gt.ndim == 3 and gt.shape[2] != 3:
            raise ValueError(f"{gt_path}: a mask of {gt.shape[2]} channels "
                             "(alpha) cannot be matched against the RGB class key")
        if random_crop:
            # resize to the fixed train size, then random-crop to target
            # (cropSize == -1 semantics, SegNetDataLoaderV1_SAR.py:210-213)
            th, tw = self.resized_hw
            hw = (max(self.TRAIN_RESIZE_HW[0], th), max(self.TRAIN_RESIZE_HW[1], tw))
            img, gt = resize_linear(img, hw), resize_nearest(gt, hw)
            if self._cache is not None:
                self._cache[i] = (img, gt)
            return self._random_crop(img, gt, crop_rng)
        if not self.full_res:
            img = resize_linear(img, self.resized_hw)
            gt = resize_nearest(gt, self.resized_hw)
        out = self._finish(img, gt)
        if self._cache is not None:
            self._cache[i] = out
        return out

    def _finish(self, img: np.ndarray, gt: np.ndarray):
        if gt.ndim == 3:  # RGB colour-coded → ids via the key
            eq = (gt[..., None, :] == self.key[None, None]).all(-1)
            ids = np.where(eq.any(-1), eq.argmax(-1), 0)
        else:  # id-coded greyscale (sarrarp50), clamp like :172-176
            ids = np.clip(gt, 0, self.num_classes - 1)
        return (img.astype(np.float32) / 255.0, ids.astype(np.int32))

    def _random_crop(self, img: np.ndarray, gt: np.ndarray,
                     crop_rng: np.random.RandomState | None):
        th, tw = self.resized_hw
        rh, rw = img.shape[0], img.shape[1]
        rng = crop_rng or np.random
        y0 = int(rng.randint(0, rh - th + 1))
        x0 = int(rng.randint(0, rw - tw + 1))
        return self._finish(img[y0:y0 + th, x0:x0 + tw],
                            gt[y0:y0 + th, x0:x0 + tw])

    def __getitem__(self, i: int):
        return self._load(i)

    def epoch(self, batch_size: int, shuffle: bool | None = None,
              seed: int = 0, drop_last: bool = True):
        """Yield (images NHWC f32, masks NHW i32) batches; the order (and
        the random crops) from ``np.random.RandomState(seed)``, as JAX's."""
        rng = np.random.RandomState(seed)
        order = np.arange(len(self))
        if shuffle if shuffle is not None else self.split == "train":
            rng.shuffle(order)
        n = len(order) - (len(order) % batch_size if drop_last else 0)
        for s in range(0, max(n, 1 if not drop_last else 0), batch_size):
            idx = order[s:s + batch_size]
            if len(idx) == 0:
                return
            items = [self._load(int(i), crop_rng=rng) for i in idx]
            yield (np.stack([x[0] for x in items]),
                   np.stack([x[1] for x in items]))
