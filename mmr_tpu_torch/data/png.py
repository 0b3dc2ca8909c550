"""PNG files with ``zlib`` and numpy: the port's image codec, in the place
the JAX package gives ``cv2.imread`` / ``cv2.imwrite``.

:func:`read` decodes 8-bit greyscale, RGB, RGBA and palette files, not
interlaced, with all five row filters. It returns ``(H, W)`` uint8 for a
greyscale file and ``(H, W, 3)`` uint8 RGB for the others: alpha is
dropped and a palette expanded, as ``cv2.imread`` does (which gives BGR).
Anything else raises ``ValueError`` with its reason: a bit depth other
than 8, an interlaced file, grey + alpha, a bad chunk CRC, a truncated
file. :func:`read_text` returns a file's ``tEXt`` chunks; :func:`decode`
does both for a file's bytes, and gives the stored samples on request. :func:`write`
encodes (H, W) grey or (H, W, 3) RGB uint8, with optional ``tEXt``
chunks.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 6: 4}   # colour type -> samples a pixel


def _chunks(data: bytes, name: str):
    """(type, body) of each chunk, CRCs checked."""
    if data[:8] != SIGNATURE:
        raise ValueError(f"{name}: not a PNG file")
    pos = 8
    while True:
        if pos + 8 > len(data):
            raise ValueError(f"{name}: truncated (no IEND chunk)")
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        end = pos + 12 + length
        if end > len(data):
            raise ValueError(f"{name}: truncated {kind.decode('latin-1')} chunk")
        body = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[end - 4:end])
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"{name}: bad CRC in the {kind.decode('latin-1')} chunk")
        yield kind, body
        if kind == b"IEND":
            return
        pos = end


def _unfilter(raw: bytes, h: int, w: int, bpp: int, name: str) -> np.ndarray:
    """Undo the per-row filters (0 none, 1 sub, 2 up, 3 average, 4 Paeth)
    of an (h, w) image of bpp bytes a pixel. Rows of filters 0-2 are undone
    a row at a time (sub by a cumulative sum); an image with average or
    Paeth rows, whose pixels depend on the decoded left, upper and
    upper-left pixels, by anti-diagonals, all the pixels of one at once."""
    stride = w * bpp
    if len(raw) != h * (stride + 1):
        raise ValueError(f"{name}: image data holds {len(raw)} bytes, "
                         f"expected {h * (stride + 1)}")
    rows = np.frombuffer(raw, np.uint8).reshape(h, stride + 1)
    filters, line = rows[:, 0], rows[:, 1:].reshape(h, w, bpp).astype(np.int32)
    if int(filters.max(initial=0)) > 4:
        bad = int(np.argmax(filters > 4))
        raise ValueError(f"{name}: unknown row filter {filters[bad]} in row {bad}")
    # out[y + 1, x + 1] is pixel (y, x); row 0 and column 0 are the zeros
    # that the filters read outside the image
    out = np.zeros((h + 1, w + 1, bpp), np.int32)
    if int(filters.max(initial=0)) <= 2:
        for y, f in enumerate(filters):
            if f == 0:
                out[y + 1, 1:] = line[y]
            elif f == 1:
                out[y + 1, 1:] = np.cumsum(line[y], axis=0) & 0xFF
            else:
                out[y + 1, 1:] = (line[y] + out[y, 1:]) & 0xFF
        return out[1:, 1:].astype(np.uint8)
    for d in range(h + w - 1):
        ys = np.arange(max(0, d - w + 1), min(h, d + 1))
        xs = d - ys
        a, b, c = out[ys + 1, xs], out[ys, xs + 1], out[ys, xs]
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        f = filters[ys][:, None]
        pred = np.select([f == 1, f == 2, f == 3, f == 4],
                         [a, b, (a + b) >> 1, paeth], 0)
        out[ys + 1, xs + 1] = (line[ys, xs] + pred) & 0xFF
    return out[1:, 1:].astype(np.uint8)


def decode(data: bytes, name: str = "<bytes>", samples: bool = False):
    """(image, tEXt chunks) of the PNG file ``data`` (``name`` in errors).
    The image as :func:`read` gives it; with ``samples``, the stored
    samples as PIL's ``np.array(Image.open(...))`` gives them: (H, W)
    grey or palette indices, (H, W, 3) RGB, (H, W, 4) RGBA."""
    header, palette, idat, text = None, None, [], {}
    for kind, body in _chunks(data, name):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"tEXt":
            key, _, value = body.partition(b"\0")
            text[key.decode("latin-1")] = value.decode("latin-1")
    if header is None:
        raise ValueError(f"{name}: no IHDR chunk")
    w, h, depth, colour, _, _, interlace = header
    if depth != 8:
        raise ValueError(f"{name}: bit depth {depth} is not supported (8 only)")
    if colour not in _CHANNELS:
        raise ValueError(f"{name}: colour type {colour} is not supported "
                         "(grey, RGB, palette, RGBA only)")
    if interlace:
        raise ValueError(f"{name}: interlaced PNG is not supported")
    if colour == 3 and palette is None:
        raise ValueError(f"{name}: palette image without a PLTE chunk")
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError(f"{name}: truncated or corrupt image data ({e})") from None
    n = _CHANNELS[colour]
    px = _unfilter(raw, h, w, n, name)
    if samples:
        img = px[..., 0] if n == 1 else px
    elif colour == 0:
        img = px[..., 0]
    elif colour == 3:
        if int(px.max(initial=0)) >= len(palette):
            raise ValueError(f"{name}: palette index beyond the PLTE chunk")
        img = palette[px[..., 0]]
    else:
        img = px[..., :3]
    return np.ascontiguousarray(img), text


def read(path: str | Path) -> np.ndarray:
    """(H, W) uint8 for a greyscale file, else (H, W, 3) uint8 RGB."""
    return decode(Path(path).read_bytes(), str(path))[0]


def read_text(path: str | Path) -> dict[str, str]:
    """The file's ``tEXt`` chunks, keyword -> text."""
    return decode(Path(path).read_bytes(), str(path))[1]


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def write(path: str | Path, img: np.ndarray,
          text: dict[str, str] | None = None) -> Path:
    """Write (H, W) grey or (H, W, 3) RGB uint8 ``img`` (filter 0 rows);
    ``text``: keyword -> Latin-1 text, stored as ``tEXt`` chunks."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or not (img.ndim == 2 or
                                     (img.ndim == 3 and img.shape[2] == 3)):
        raise ValueError(f"expected (H, W) or (H, W, 3) uint8, got "
                         f"{img.shape} {img.dtype}")
    h, w = img.shape[:2]
    colour = 0 if img.ndim == 2 else 2
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           np.ascontiguousarray(img).reshape(h, -1)], axis=1)
    parts = [SIGNATURE,
             _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, colour, 0, 0, 0))]
    for key, value in (text or {}).items():
        parts.append(_chunk(b"tEXt", key.encode("latin-1") + b"\0"
                            + value.encode("latin-1")))
    parts += [_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)),
              _chunk(b"IEND", b"")]
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(b"".join(parts))
    return path
