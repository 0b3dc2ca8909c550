"""Offline dataset converters (counterpart of ``mmr_tpu/data/convert.py``),
host-side tooling off the training path:

1. :func:`convert_zip_dataset` — the ``mmr_create_dataset`` capability
   (``Data_Loader.py:402-695``): SAR-RARP50 challenge ZIPs (nested
   per-video zips, a flat ZIP of one video, or a directory of video
   folders) → per-video Zarr stores in the reference schema, with ≤ 50
   sampled foreground coordinates per class per frame for the
   oversampling sampler, and :func:`write_mini_split`, the mini-dataset
   notebook's hand-written split (``Mini_Dataset_ZarrFile.ipynb``);
2. :func:`extract_frames_dataset` — Path A's ``data_preprocessing.py``:
   annotated frames → ``<split>/{images,groundtruth}/*.png`` folders with
   an 80/20 video split (``:57-157``), and
   :func:`calculate_dataset_statistics`, mean / std over ≤ 100 sampled
   images (``:159-210``).

Videos are Motion-JPEG AVI read by :class:`mmr_tpu_torch.data.video.
VideoReader` (the JAX package's ``cv2.VideoCapture``; other codecs raise
``NotImplementedError`` naming their fourcc) with OpenCV's chroma
upsampling (``fancy_upsampling=False``: each chroma sample repeated), so
the frames the reference trains on come out within a few levels of
OpenCV's FFmpeg decode at sharp colour edges too; masks are PNG decoded by
:mod:`mmr_tpu_torch.data.png`. The random draws (the coordinates sampled
a class a frame, the video split) are JAX's, in its order, so masks,
``class_locations`` and split files come out equal to its own.
"""

from __future__ import annotations

import io
import json
import logging
import tempfile
import zipfile
from pathlib import Path

import numpy as np

from mmr_tpu_torch.data import png
from mmr_tpu_torch.data.video import VideoReader
from mmr_tpu_torch.data.zarr_io import VideoStore


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


def _write_video_store(video: VideoReader, mask_idx2name: dict[int, str], read_mask,
                       out_path: Path, n_classes: int, patch_size,
                       rng: np.random.RandomState, image_dtype=np.float32) -> None:
    """The annotated frames of ``video`` with their masks → one store at
    ``out_path``; a frame the video lacks is warned about and left
    unwritten. ``rng`` draws ≤ 50 coordinates a class a frame, in class
    order (``Data_Loader.py:330-397``)."""
    frames = sorted(mask_idx2name)
    store = VideoStore.create(out_path, len(frames), video.height, video.width,
                              patch_size, image_dtype=image_dtype)
    class_locations = {str(c): [] for c in range(1, n_classes + 1)}
    for i, frame_idx in enumerate(frames):
        frame = video.read(frame_idx)
        if frame is None:
            print(f"    Warning: could not read frame {frame_idx}")
            continue
        mask = read_mask(mask_idx2name[frame_idx])
        chw = frame.transpose(2, 0, 1).astype(np.float32) / 255.0
        store.write_frame(i, chw, mask)
        for cls in range(1, n_classes + 1):
            coords = np.argwhere(mask == cls)
            if coords.shape[0] == 0:
                continue
            if coords.shape[0] > 50:
                coords = coords[rng.choice(coords.shape[0], 50, replace=False)]
            class_locations[str(cls)].extend(
                [(i, int(y), int(x)) for y, x in coords])
    store.set_properties({"class_locations": class_locations})
    print(f"    Saved: {out_path}")


def convert_zip_dataset(zip_path: str | Path, out_path: str | Path, n_classes: int,
                        patch_size, seed: int = 0, n_videos: int | None = None,
                        write_split: bool = False, image_dtype=np.float32) -> Path:
    """ZIP (nested per-video zips, or one video's files) or a directory of
    video folders → Zarr dataset at ``<out>/data/data_NNN.zarr``.

    ``n_videos`` converts only the first N videos and ``write_split``
    writes :func:`write_mini_split` over them (the mini-dataset workflow).
    ``image_dtype=np.uint8`` writes the compact store variant (lossless for
    8-bit video); float32 is the reference's schema. In a nested ZIP a
    video that fails is skipped with its reason printed, as in JAX."""
    zip_path = Path(zip_path)
    out_root = Path(out_path)
    (out_root / "data").mkdir(parents=True, exist_ok=True)
    rng = np.random.RandomState(seed)
    index = 0

    def handle_video_zip(zf: zipfile.ZipFile, name: str):
        nonlocal index
        with tempfile.TemporaryDirectory() as td:
            avi = [f for f in zf.namelist() if f.endswith(".avi")]
            if not avi:
                raise FileNotFoundError(
                    f"No .avi video in {name}; files: {zf.namelist()[:10]}")
            video_path = Path(td) / "video.avi"
            video_path.write_bytes(zf.read(avi[0]))
            mapping = _mask_frame_mapping(zf.namelist())
            with VideoReader(video_path, fancy_upsampling=False) as video:
                _write_video_store(
                    video, mapping, lambda n: _read_mask(zf.read(n)),
                    out_root / "data" / f"data_{index:03d}.zarr",
                    n_classes, patch_size, rng, image_dtype)
        index += 1

    def at_limit() -> bool:
        return n_videos is not None and index >= n_videos

    if zip_path.is_dir():
        # video_dir/{*.avi, segmentation/*.png} (Data_Loader.py:489)
        for vdir in sorted(p for p in zip_path.iterdir() if p.is_dir()):
            if at_limit():
                break
            avis = list(vdir.glob("*.avi"))
            masks = _mask_frame_mapping([str(p) for p in vdir.rglob("*.png")])
            if not avis or not masks:
                continue
            with VideoReader(avis[0], fancy_upsampling=False) as video:
                _write_video_store(
                    video, masks, lambda n: _read_mask(Path(n).read_bytes()),
                    out_root / "data" / f"data_{index:03d}.zarr",
                    n_classes, patch_size, rng, image_dtype)
            index += 1
    else:
        with zipfile.ZipFile(zip_path) as outer:
            inner_zips = [n for n in outer.namelist() if n.endswith(".zip")]
            if inner_zips:   # nested zips (Data_Loader.py:675-681)
                for inner_name in sorted(inner_zips):
                    if at_limit():
                        break
                    print(f"Processing {inner_name}")
                    try:
                        with zipfile.ZipFile(io.BytesIO(outer.read(inner_name))) as zf:
                            handle_video_zip(zf, inner_name)
                    except Exception as e:   # per-video resilience (:484-486)
                        print(f"    Skipping {inner_name}: {e}")
            else:
                handle_video_zip(outer, zip_path.name)
    if write_split:
        write_mini_split(out_root)
    return out_root


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


def extract_frames_from_video(video_path, frame_indices, out_dir, prefix) -> int:
    """The frames ``frame_indices`` of a video → ``<prefix>_<idx:09d>.png``
    RGB files in ``out_dir`` (``data_preprocessing.py:16-55``); frames the
    video lacks are skipped. Returns the number written."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    n = 0
    with VideoReader(video_path, fancy_upsampling=False) as video:
        for idx in frame_indices:
            frame = video.read(idx)
            if frame is None:
                continue
            png.write(out_dir / f"{prefix}_{idx:09d}.png", frame)
            n += 1
    return n


def extract_frames_dataset(raw_root: str | Path, out_root: str | Path,
                           val_fraction: float = 0.2, seed: int = 42) -> Path:
    """Video folders (video.avi + segmentation/*.png) → PNG-folder dataset
    ``<split>/{images,groundtruth}/`` with an 80/20 video split drawn as
    JAX draws it (``data_preprocessing.py:57-157``)."""
    raw_root, out_root = Path(raw_root), Path(out_root)
    vdirs = sorted(p for p in raw_root.iterdir() if p.is_dir())
    rng = np.random.RandomState(seed)
    order = rng.permutation(len(vdirs))
    n_val = max(1, int(round(len(vdirs) * val_fraction))) if len(vdirs) > 1 else 0
    val_set = {vdirs[i].name for i in order[:n_val]}
    for vdir in vdirs:
        split = "val" if vdir.name in val_set else "train"
        masks = sorted(vdir.rglob("segmentation/*.png")) or sorted(vdir.rglob("*.png"))
        mapping = _mask_frame_mapping([str(m) for m in masks])
        frame_ids = sorted(mapping)
        avis = list(vdir.glob("*.avi"))
        if not avis:
            continue
        extract_frames_from_video(avis[0], frame_ids, out_root / split / "images",
                                  vdir.name)
        gt_dir = out_root / split / "groundtruth"
        gt_dir.mkdir(parents=True, exist_ok=True)
        for idx in frame_ids:
            (gt_dir / f"{vdir.name}_{idx:09d}.png").write_bytes(
                Path(mapping[idx]).read_bytes())
    return out_root


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
        img = png.read(p) / 255.0
        acc = acc[0] + img.mean((0, 1)), acc[1] + (img ** 2).mean((0, 1))
    mean = acc[0] / len(paths)
    std = np.sqrt(np.maximum(acc[1] / len(paths) - mean ** 2, 0))
    return mean.astype(np.float32), std.astype(np.float32)
