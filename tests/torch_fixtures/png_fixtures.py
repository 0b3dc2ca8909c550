"""PNG files of the formats ``cv2.imread`` reads beyond 8-bit, non-interlaced
grey / RGB / RGBA: an encoder for any colour type, bit depth and Adam7
interlacing (:func:`encode`), and the frames of ``tests/torch_fixtures/png``
that ``chip_smoke.py`` phase 11 trains on with Path A's CLI, each an image
and its mask:

- ``f16.png``: a 16-bit RGB image, a 16-bit grey id mask (ids above the
  class range, clipped by the dataset);
- ``adam7.png``: an Adam7-interlaced RGB image and grey id mask;
- ``grey_alpha.png``: a grey + alpha image, a 4-bit grey mask (levels scaled
  to 0-255 by the reader, then clipped).

``records.json`` keeps, for each file, the sha256 and shape of
``cv2.imread``'s decode in both modes (image: ``IMREAD_COLOR``, unchanged:
``IMREAD_UNCHANGED``), channels turned to RGB(A) order, which the port's
``data/png.py`` must give. Run from the repository root where OpenCV is
installed (``python tests/torch_fixtures/png_fixtures.py``); the card's
machine only reads what it wrote.
"""

from __future__ import annotations

import hashlib
import json
import struct
import zlib
from pathlib import Path

import numpy as np

OUT = Path(__file__).resolve().parent / "png"
HW = (64, 64)
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def _rows(samples: np.ndarray, depth: int) -> bytes:
    """(h, w, n) samples -> filter-0 rows: big-endian at depth 16, packed
    from the high bits down below 8."""
    h = samples.shape[0]
    flat = samples.reshape(h, -1).astype(np.int64)
    if depth == 16:
        b = flat.astype(">u2").view(np.uint8).reshape(h, -1)
    elif depth == 8:
        b = flat.astype(np.uint8)
    else:
        per = 8 // depth
        flat = np.pad(flat, ((0, 0), (0, -flat.shape[1] % per)))
        shifts = np.arange(8 - depth, -1, -depth)
        b = (flat.reshape(h, -1, per) << shifts).sum(-1).astype(np.uint8)
    return np.concatenate([np.zeros((h, 1), np.uint8), b], 1).tobytes()


def encode(samples: np.ndarray, depth: int, colour: int, interlace: bool = False,
           palette: np.ndarray | None = None, trns: bytes | None = None) -> bytes:
    """A PNG file of (H, W) or (H, W, n) ``samples`` at ``depth`` bits in
    ``colour`` type (0 grey, 2 RGB, 3 palette, 4 grey + alpha, 6 RGBA),
    Adam7-interlaced when asked (each pass its own rows), with a ``PLTE``
    and a ``tRNS`` chunk when given."""
    s = samples if samples.ndim == 3 else samples[..., None]
    h, w = s.shape[:2]
    passes = ADAM7 if interlace else ((0, 0, 1, 1),)
    raw = b"".join(_rows(s[y0::dy, x0::dx], depth) for x0, y0, dx, dy in passes
                   if s[y0::dy, x0::dx].size)
    extra = b""
    if palette is not None:
        extra += _chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    if trns is not None:
        extra += _chunk(b"tRNS", trns)
    return (b"\x89PNG\r\n\x1a\n"
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, colour, 0, 0,
                                          int(interlace)))
            + extra + _chunk(b"IDAT", zlib.compress(raw, 9)) + _chunk(b"IEND", b""))


def _field(h: int, w: int, k: int) -> np.ndarray:
    """A smooth (h, w) field in [0, 1] (small files)."""
    y, x = np.mgrid[0:h, 0:w] / np.array([h, w])[:, None, None]
    return 0.5 + 0.45 * np.sin(3 * x + 2 * y + k) * np.cos(2 * y - x + 0.5 * k)


def _ids(h: int, w: int, k: int, top: int) -> np.ndarray:
    """Blocky class ids in [0, top)."""
    y, x = np.mgrid[0:h, 0:w]
    return ((y // 12 + x // 16 + k) % top).astype(np.int64)


def frames() -> dict[str, tuple[bytes, bytes]]:
    """name -> (image file, mask file) of the phase-11 fixtures."""
    h, w = HW
    rgb = lambda k: np.stack([_field(h, w, k + c) for c in range(3)], -1)
    mask16 = _ids(h, w, 0, 10)
    mask16[:4, :4] = 300   # beyond the classes: clipped to the last one
    return {
        "f16.png": (encode(np.rint(rgb(0) * 65535), 16, 2),
                    encode(mask16, 16, 0)),
        "adam7.png": (encode(np.rint(rgb(3) * 255), 8, 2, interlace=True),
                      encode(_ids(h, w, 1, 10), 8, 0, interlace=True)),
        "grey_alpha.png": (encode(np.stack([np.rint(_field(h, w, 5) * 255),
                                            np.rint(_field(h, w, 6) * 255)], -1),
                                  8, 4),
                           encode(_ids(h, w, 2, 16), 4, 0)),
    }


def _sha(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def main() -> None:
    import cv2

    records = {}
    for name, files in frames().items():
        for part, data in zip(("images", "groundtruth"), files):
            path = OUT / part / name
            path.parent.mkdir(parents=True, exist_ok=True)
            path.write_bytes(data)
            rec = {}
            for mode, flag in (("image", cv2.IMREAD_COLOR),
                               ("unchanged", cv2.IMREAD_UNCHANGED)):
                a = cv2.imread(str(path), flag)
                if a.ndim == 3:   # BGR(A) -> RGB(A)
                    a = a[..., [2, 1, 0, 3][:a.shape[2]]]
                rec[mode] = {"sha256": _sha(a), "shape": list(a.shape),
                             "dtype": str(a.dtype)}
            records[f"{part}/{name}"] = rec
    (OUT / "records.json").write_text(json.dumps(records, indent=1) + "\n")


if __name__ == "__main__":
    main()
