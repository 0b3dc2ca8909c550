"""Write the fixtures of the port's host decoders (``tests/torch_fixtures``):

- ``mjpeg_1080.avi``: three 1080×1920 frames written by OpenCV's Motion-JPEG
  writer (baseline JPEG, 4:2:0, an ``idx1`` index);
- ``blosc/``: six Zarr stores written by the JAX package's
  ``VideoStore`` (tensorstore: blosc, zstd clevel 3, bitshuffle) — float32
  and uint8 images with their masks, one pair chunked 64×80 (edge chunks
  partial), one chunked 60×45 (2700 elements a plane: not a multiple of 8,
  so c-blosc stores those blocks unshuffled), and ``f32_full`` and
  ``u8_full``: one frame in one chunk of the size real stores hold, (3, 1,
  512, 640), cut from the Motion-JPEG fixture's first decoded frame;
- ``records.json``: sha256 of each decoded frame (the port's decode, checked
  equal to PIL's), of each store's arrays and of the ``PatchSampler``
  batches as the JAX package reads them.

Run from the repository root on a machine with OpenCV, PIL and the JAX
package (``JAX_PLATFORMS=cpu python tests/torch_fixtures/make_fixtures.py``).
It is not a test, and the card's machine never runs it: ``chip_smoke.py``
phase 16 and ``tests/test_torch_native_data.py`` read what it wrote.
"""

from __future__ import annotations

import hashlib
import io
import json
import shutil
import sys
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = HERE.parents[1]
sys.path.insert(0, str(ROOT))

AVI = "mjpeg_1080.avi"
FRAME = (1080, 1920)
N_FRAMES = 3
N_CLASSES = 9
STORES = {   # name: (dtype, frames, height, width, patch)
    "f32_a": ("float32", 2, 135, 240, (64, 80)),
    "f32_b": ("float32", 2, 90, 100, (60, 45)),
    "u8_a": ("uint8", 2, 135, 240, (64, 80)),
    "u8_b": ("uint8", 2, 90, 100, (60, 45)),
    "f32_full": ("float32", 1, 512, 640, (512, 640)),
    "u8_full": ("uint8", 1, 512, 640, (512, 640)),
}
FULL_CROP = (284, 640)   # top-left of the *_full frames in the fixture's first frame
SAMPLER = {"patch": [64, 64], "batch": 3, "steps": 3, "seed": 11,
           "epoch_seed": 100, "oversample_foreground_percent": 0.5,
           "initial_patch_size": [72, 80]}


def sha(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def scene(rng: np.random.RandomState, h: int, w: int, t: int) -> np.ndarray:
    """A tissue-like RGB frame: low-frequency colour fields with a fine
    texture, two bright instrument-like bars, sensor noise."""
    y, x = np.mgrid[:h, :w] / np.float32(max(h, w))
    r = 150 + 60 * np.sin(6 * x + 2 * y + t) + 20 * np.cos(17 * y)
    g = 70 + 40 * np.sin(5 * y - 3 * x + 0.5 * t)
    b = 60 + 30 * np.cos(9 * x * y + t)
    img = np.stack([r, g, b], -1) + (12 * np.sin(90 * x) * np.sin(70 * y))[..., None]
    for k in range(2):
        x0 = int(w * (0.2 + 0.4 * k + 0.05 * t))
        img[int(h * 0.3):int(h * 0.7), x0:x0 + w // 12] = (200, 200, 210)
    img += rng.normal(0, 4.0, img.shape)
    return np.clip(np.rint(img), 0, 255).astype(np.uint8)


def masks_for(h: int, w: int, t: int) -> np.ndarray:
    """Class ids 0..N_CLASSES: the bars as classes 1 and 2, blocks of the
    others."""
    m = np.zeros((h, w), np.uint8)
    for k in range(2):
        x0 = int(w * (0.2 + 0.4 * k + 0.05 * t))
        m[int(h * 0.3):int(h * 0.7), x0:x0 + w // 12] = k + 1
    for c in range(3, N_CLASSES + 1):
        y0, x0 = (c * 37 + 11 * t) % (h - h // 8), (c * 53) % (w - w // 8)
        m[y0:y0 + h // 10, x0:x0 + w // 10] = c
    return m


def write_avi(rng) -> tuple[list[str], list[np.ndarray]]:
    import cv2
    from PIL import Image

    from mmr_tpu_torch.data.video import VideoReader

    path = HERE / AVI
    h, w = FRAME
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"MJPG"), 5, (w, h))
    for t in range(N_FRAMES):
        writer.write(scene(rng, h, w, t)[..., ::-1])
    writer.release()
    out, frames = [], []
    with VideoReader(path) as video:
        assert video.frame_count == N_FRAMES and (video.height, video.width) == FRAME
        for t in range(N_FRAMES):
            mine = video.read(t)
            pil = np.array(Image.open(io.BytesIO(video.frame_bytes(t))))
            assert np.array_equal(mine, pil), f"frame {t}: port != PIL"
            out.append(sha(mine))
            frames.append(mine)
    return out, frames


def write_stores(rng, frames) -> dict:
    from mmr_tpu.data.zarr_io import VideoStore as JaxStore

    root = HERE / "blosc"
    shutil.rmtree(root, ignore_errors=True)
    records = {}
    for name, (dtype, t, h, w, patch) in STORES.items():
        store = JaxStore.create(root / f"{name}.zarr", t, h, w, patch,
                                image_dtype=np.dtype(dtype))
        locs = {str(c): [] for c in range(1, N_CLASSES + 1)}
        for i in range(t):
            if name.endswith("_full"):
                y, x = FULL_CROP
                rgb = frames[i][y:y + h, x:x + w]
            else:
                rgb = scene(rng, h, w, i)
            img = rgb.transpose(2, 0, 1).astype(np.float32) / 255.0
            mask = masks_for(h, w, i)
            store.write_frame(i, img, mask)
            for c in range(1, N_CLASSES + 1):
                yx = np.argwhere(mask == c)[:20]
                locs[str(c)] += [(i, int(y), int(x)) for y, x in yx]
        store.set_properties({"class_locations": locs})
        read = JaxStore(root / f"{name}.zarr")
        records[name] = {"dtype": dtype, "shape": [t, h, w], "patch": list(patch),
                         "image": sha(np.asarray(read.image[:])),
                         "mask": sha(np.asarray(read.mask[:]))}
    return records


def sampler_records() -> dict:
    from mmr_tpu.data.patch_dataset import PatchSampler as JaxSampler

    out = {}
    for kind in ("f32", "u8"):
        paths = [HERE / "blosc" / f"{kind}_{ab}.zarr" for ab in "ab"]
        s = JaxSampler(paths, tuple(SAMPLER["patch"]), SAMPLER["batch"], SAMPLER["steps"],
                       oversample_foreground_percent=SAMPLER["oversample_foreground_percent"],
                       initial_patch_size=tuple(SAMPLER["initial_patch_size"]),
                       seed=SAMPLER["seed"])
        out[kind] = [[sha(img), sha(mask)]
                     for img, mask in s.epoch(epoch_seed=SAMPLER["epoch_seed"], num_workers=1)]
    return out


def main() -> None:
    rng = np.random.RandomState(2026)
    frame_sha, frames = write_avi(rng)
    records = {
        "hash": "sha256 of the C-order bytes of each array",
        "avi": {"file": AVI, "shape": [*FRAME, 3], "frames": frame_sha,
                "what": "RGB uint8 frames decoded by the port, equal to PIL's decode"},
        "stores": write_stores(rng, frames),
        "sampler": {**SAMPLER, "batches": sampler_records(),
                    "what": "[image, mask] of each batch of JAX's PatchSampler over "
                            "<kind>_a.zarr and <kind>_b.zarr"},
    }
    (HERE / "records.json").write_text(json.dumps(records, indent=1) + "\n")
    total = sum(f.stat().st_size for f in HERE.rglob("*") if f.is_file())
    print(f"fixtures: {total} bytes")


if __name__ == "__main__":
    main()
