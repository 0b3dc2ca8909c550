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
- ``mjpeg_prog_1080.avi``: two 1080×1920 frames, progressive 4:2:2 JPEGs
  from ``cv2.imencode`` in an ``idx1`` AVI; ``mjpeg_440.avi``,
  ``mjpeg_411.avi``, ``mjpeg_prog_440.avi``, ``mjpeg_prog_411.avi``: two
  240×320 frames each, baseline and progressive at 4:4:0 and 4:1:1;
- ``blosc/<cname>_f32.zarr`` and ``<cname>_u8.zarr`` for blosc's other
  compressors (blosclz, lz4, lz4hc, snappy, zlib; the shuffles varied), and
  ``lz4_full.zarr`` and ``zlib_full.zarr``, the full-size chunk of
  ``f32_full`` again: written by the JAX package's ``VideoStore``
  (tensorstore) with its compressor set to each;
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
# the Motion-JPEG variants: name -> (frames, height, width, cv2 sampling, progressive)
MJPEG = {
    "mjpeg_prog_1080": (2, 1080, 1920, "422", True),
    "mjpeg_440": (2, 240, 320, "440", False),
    "mjpeg_411": (2, 240, 320, "411", False),
    "mjpeg_prog_440": (2, 240, 320, "440", True),
    "mjpeg_prog_411": (2, 240, 320, "411", True),
}
# blosc's other compressors: name -> (cname, shuffle, dtype, frames, height, width, patch)
OTHER_STORES = {
    "blosclz_f32": ("blosclz", "shuffle", "float32", 2, 90, 100, (60, 45)),
    "blosclz_u8": ("blosclz", "bitshuffle", "uint8", 2, 90, 100, (60, 45)),
    "lz4_f32": ("lz4", "bitshuffle", "float32", 2, 90, 100, (60, 45)),
    "lz4_u8": ("lz4", "noshuffle", "uint8", 2, 90, 100, (60, 45)),
    "lz4hc_f32": ("lz4hc", "noshuffle", "float32", 2, 90, 100, (60, 45)),
    "lz4hc_u8": ("lz4hc", "shuffle", "uint8", 2, 90, 100, (60, 45)),
    "snappy_f32": ("snappy", "bitshuffle", "float32", 2, 90, 100, (60, 45)),
    "snappy_u8": ("snappy", "shuffle", "uint8", 2, 90, 100, (60, 45)),
    "zlib_f32": ("zlib", "shuffle", "float32", 2, 90, 100, (60, 45)),
    "zlib_u8": ("zlib", "bitshuffle", "uint8", 2, 90, 100, (60, 45)),
    "lz4_full": ("lz4", "bitshuffle", "float32", 1, 512, 640, (512, 640)),
    "zlib_full": ("zlib", "bitshuffle", "float32", 1, 512, 640, (512, 640)),
}
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


def write_store(path: Path, rng, frames, full: bool, dtype, t, h, w, patch) -> dict:
    """One store written by JAX's ``VideoStore``: frames of ``scene`` (or,
    ``full``, crops of the Motion-JPEG fixture's frames) and ``masks_for``;
    its record."""
    from mmr_tpu.data.zarr_io import VideoStore as JaxStore

    store = JaxStore.create(path, t, h, w, patch, image_dtype=np.dtype(dtype))
    locs = {str(c): [] for c in range(1, N_CLASSES + 1)}
    for i in range(t):
        if full:
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
    read = JaxStore(path)
    return {"dtype": dtype, "shape": [t, h, w], "patch": list(patch),
            "image": sha(np.asarray(read.image[:])), "mask": sha(np.asarray(read.mask[:]))}


def write_stores(rng, frames) -> dict:
    root = HERE / "blosc"
    for name in STORES:
        shutil.rmtree(root / f"{name}.zarr", ignore_errors=True)
    return {name: write_store(root / f"{name}.zarr", rng, frames, name.endswith("_full"),
                              dtype, t, h, w, patch)
            for name, (dtype, t, h, w, patch) in STORES.items()}


def write_other_stores(frames) -> dict:
    """The stores of blosc's other compressors: JAX's ``VideoStore`` with its
    codec's compressor and shuffle set to each (clevel 5, c-blosc's
    default), so tensorstore writes every array of the store with it."""
    import mmr_tpu.data.zarr_io as jax_zarr

    rng = np.random.RandomState(2027)
    records, saved = {}, jax_zarr._BLOSC
    try:
        for name, (cname, shuffle, dtype, t, h, w, patch) in OTHER_STORES.items():
            jax_zarr._BLOSC = {"name": "blosc", "configuration": {
                "cname": cname, "clevel": 5, "shuffle": shuffle}}
            path = HERE / "blosc" / f"{name}.zarr"
            shutil.rmtree(path, ignore_errors=True)
            records[name] = {"cname": cname, "shuffle": shuffle,
                             **write_store(path, rng, frames, name.endswith("_full"), dtype,
                                           t, h, w, patch)}
    finally:
        jax_zarr._BLOSC = saved
    return records


def avi_bytes(frames: list[bytes], w: int, h: int) -> bytes:
    """A Motion-JPEG AVI of the given JPEG frames: the header list (one
    ``MJPG`` video stream), a ``movi`` list and an ``idx1`` index whose
    offsets are taken from the ``movi`` fourcc."""
    import struct

    def chunk(fcc: bytes, data: bytes) -> bytes:
        return fcc + struct.pack("<I", len(data)) + data + b"\0" * (len(data) & 1)

    def lst(kind: bytes, *parts: bytes) -> bytes:
        body = kind + b"".join(parts)
        return b"LIST" + struct.pack("<I", len(body)) + body

    n = len(frames)
    avih = struct.pack("<14I", 200000, 0, 0, 0x10, n, 0, 1, 0, w, h, 0, 0, 0, 0)
    strh = struct.pack("<4s4sIHHIIIIIIIIhhhh", b"vids", b"MJPG", 0, 0, 0, 0, 1, 5, 0, n,
                       0, 0, 0, 0, 0, w, h)
    strf = struct.pack("<Iiihh4sIiiII", 40, w, h, 1, 24, b"MJPG", w * h * 3, 0, 0, 0, 0)
    movi, idx = b"", b""
    for f in frames:
        idx += struct.pack("<4sIII", b"00dc", 0x10, 4 + len(movi), len(f))
        movi += chunk(b"00dc", f)
    body = (b"AVI " + lst(b"hdrl", chunk(b"avih", avih),
                          lst(b"strl", chunk(b"strh", strh), chunk(b"strf", strf)))
            + lst(b"movi", movi) + chunk(b"idx1", idx))
    return b"RIFF" + struct.pack("<I", len(body)) + body


def write_mjpeg_variants() -> dict:
    """The progressive and 4:4:0 / 4:1:1 AVIs: ``scene`` frames encoded by
    ``cv2.imencode`` (quality 90), each frame's port decode checked equal to
    PIL's and recorded."""
    import cv2
    from PIL import Image

    from mmr_tpu_torch.data.video import VideoReader

    rng = np.random.RandomState(2028)
    records = {}
    for name, (n, h, w, sampling, progressive) in MJPEG.items():
        factor = getattr(cv2, f"IMWRITE_JPEG_SAMPLING_FACTOR_{sampling}")
        params = [cv2.IMWRITE_JPEG_QUALITY, 90, cv2.IMWRITE_JPEG_PROGRESSIVE, int(progressive),
                  cv2.IMWRITE_JPEG_SAMPLING_FACTOR, factor]
        jpegs = [cv2.imencode(".jpg", scene(rng, h, w, t)[..., ::-1], params)[1].tobytes()
                 for t in range(n)]
        path = HERE / f"{name}.avi"
        path.write_bytes(avi_bytes(jpegs, w, h))
        shas = []
        with VideoReader(path) as video:
            assert video.frame_count == n and (video.height, video.width) == (h, w)
            for t in range(n):
                mine = video.read(t)
                pil = np.array(Image.open(io.BytesIO(video.frame_bytes(t))))
                assert np.array_equal(mine, pil), f"{name} frame {t}: port != PIL"
                shas.append(sha(mine))
        records[name] = {"file": path.name, "shape": [h, w, 3],
                         "sampling": f"{sampling[0]}:{sampling[1]}:{sampling[2]}",
                         "progressive": progressive, "frames": shas}
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
        "mjpeg": write_mjpeg_variants(),
        "other_compressors": write_other_stores(frames),
    }
    (HERE / "records.json").write_text(json.dumps(records, indent=1) + "\n")
    total = sum(f.stat().st_size for f in HERE.rglob("*") if f.is_file())
    print(f"fixtures: {total} bytes")


if __name__ == "__main__":
    main()
