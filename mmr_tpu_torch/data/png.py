"""PNG files with ``zlib`` and numpy: the port's image codec, in the place
the JAX package gives ``cv2.imread`` / ``cv2.imwrite``.

:func:`read` decodes every PNG that ``cv2.imread`` reads: grey, RGB,
palette, grey + alpha and RGBA, bit depths 1, 2, 4, 8 and 16 where the
format allows them, all five row filters, Adam7 interlacing, and a
palette's or an RGB file's ``tRNS``. It has cv2's two modes, with the
channels in RGB(A) order where cv2 gives BGR(A):

- the image mode (``cv2.IMREAD_COLOR``, the default): (H, W, 3) uint8 RGB;
  16-bit samples keep their high byte (libpng's ``png_set_strip_16``),
  grey and grey + alpha repeat the grey in three channels, a palette is
  expanded, alpha is dropped;
- the unchanged mode (``cv2.IMREAD_UNCHANGED``, for masks): grey (H, W),
  RGB (H, W, 3), RGBA (H, W, 4) and grey + alpha as (H, W, 4) of (grey,
  grey, grey, alpha), uint8 or, at bit depth 16, uint16; a palette is
  expanded to RGB, or RGBA where the file has ``tRNS``; an RGB file with
  ``tRNS`` gains alpha (0 at its colour, the depth's maximum elsewhere), a
  grey file's ``tRNS`` is ignored, as cv2 does.

Grey samples of 1, 2 or 4 bits are scaled to 0–255 in both modes. A bad
chunk CRC, a truncated file or data that does not fill the image raises
``ValueError`` with its reason. :func:`read_text` returns a file's
``tEXt`` chunks; :func:`decode` does both for a file's bytes, and gives
the stored samples on request. :func:`write` encodes (H, W) grey or (H, W,
3) RGB uint8, with optional ``tEXt`` chunks.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}   # colour type -> samples a pixel
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
           6: (8, 16)}
# Adam7: (x0, y0, dx, dy) of each pass
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


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


def _unfilter(rows: np.ndarray, bpp: int, name: str) -> np.ndarray:
    """Undo the per-row filters (0 none, 1 sub, 2 up, 3 average, 4 Paeth)
    of (h, 1 + stride) filtered rows whose pixels are ``bpp`` bytes (1 below
    8 bits a pixel); (h, stride) uint8 out. Rows of filters 0-2 are undone
    a row at a time (sub by a cumulative sum); an image with average or
    Paeth rows, whose pixels depend on the decoded left, upper and
    upper-left pixels, by anti-diagonals, all the pixels of one at once."""
    h, w = rows.shape[0], (rows.shape[1] - 1) // bpp
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
        return out[1:, 1:].astype(np.uint8).reshape(h, w * bpp)
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
    return out[1:, 1:].astype(np.uint8).reshape(h, w * bpp)


def _unpack(b: np.ndarray, w: int, depth: int, n: int) -> np.ndarray:
    """Unfiltered (h, stride) row bytes -> (h, w, n) samples: uint8, or
    uint16 (big-endian in the file) at depth 16; below 8 bits the samples
    of a byte from its high bits down."""
    h = b.shape[0]
    if depth == 8:
        return b.reshape(h, w, n)
    if depth == 16:
        b = b.reshape(h, w * n, 2).astype(np.uint16)
        return ((b[..., 0] << 8) | b[..., 1]).reshape(h, w, n)
    shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
    v = (b[..., None] >> shifts) & np.uint8((1 << depth) - 1)
    return v.reshape(h, -1)[:, :w, None]


def _samples(raw: bytes, h: int, w: int, depth: int, n: int, interlace: int,
             name: str) -> np.ndarray:
    """The (h, w, n) stored samples of the decompressed image data: one
    image, or Adam7's seven passes (each filtered on its own; an empty pass
    has no bytes) put back in place."""
    passes = _ADAM7 if interlace else ((0, 0, 1, 1),)
    bpp = max(1, depth * n // 8)
    sizes = []
    for x0, y0, dx, dy in passes:
        pw, ph = -(-(w - x0) // dx), -(-(h - y0) // dy)
        stride = -(-pw * depth * n // 8)
        sizes.append((pw, ph, stride, ph * (stride + 1) if pw > 0 and ph > 0 else 0))
    if len(raw) != sum(z[3] for z in sizes):
        raise ValueError(f"{name}: image data holds {len(raw)} bytes, "
                         f"expected {sum(z[3] for z in sizes)}")
    out = np.zeros((h, w, n), np.uint16 if depth == 16 else np.uint8)
    pos = 0
    for (x0, y0, dx, dy), (pw, ph, stride, size) in zip(passes, sizes):
        if size:
            rows = np.frombuffer(raw, np.uint8, size, pos).reshape(ph, stride + 1)
            out[y0::dy, x0::dx] = _unpack(_unfilter(rows, bpp, name), pw, depth, n)
            pos += size
    return out


def _convert(px: np.ndarray, colour: int, depth: int, palette, trns,
             unchanged: bool, name: str) -> np.ndarray:
    """Stored samples -> the image ``cv2.imread`` gives in either mode
    (module docstring), channels in RGB(A) order."""
    if colour == 3:
        idx = px[..., 0]
        palette = palette[:1 << depth]   # libpng keeps 2**depth entries
        if int(idx.max(initial=0)) >= len(palette):
            raise ValueError(f"{name}: palette index beyond the PLTE chunk")
        rgb = palette[idx]
        # libpng ignores a tRNS longer than the palette
        if not (unchanged and trns and len(trns) <= len(palette)):
            return rgb
        alpha = np.full(256, 255, np.uint8)
        alpha[:len(trns)] = np.frombuffer(trns, np.uint8)
        return np.concatenate([rgb, alpha[idx][..., None]], -1)
    if depth < 8:   # grey of 1, 2 or 4 bits, scaled to 0-255
        px = px * np.uint8(255 // ((1 << depth) - 1))
    grey = colour in (0, 4)
    if not unchanged:
        if depth == 16:
            px = (px >> 8).astype(np.uint8)
        return np.repeat(px[..., :1], 3, -1) if grey else px[..., :3]
    if colour == 0:
        return px[..., 0]
    if colour == 4:
        return px[..., [0, 0, 0, 1]]
    if colour == 2 and trns is not None and len(trns) >= 6:
        key = np.frombuffer(trns[:6], ">u2").astype(px.dtype)
        top = np.iinfo(px.dtype).max
        alpha = np.where((px == key).all(-1), 0, top).astype(px.dtype)
        return np.concatenate([px, alpha[..., None]], -1)
    return px


def decode(data: bytes, name: str = "<bytes>", samples: bool = False,
           unchanged: bool = False):
    """(image, tEXt chunks) of the PNG file ``data`` (``name`` in errors).
    The image as :func:`read` gives it in the image mode or, with
    ``unchanged``, the unchanged mode; with ``samples``, the stored
    samples (after de-interlacing): (H, W) grey levels or palette indices
    unscaled, else (H, W, channels), uint16 at bit depth 16."""
    header, palette, trns, idat, text = None, None, None, [], {}
    for kind, body in _chunks(data, name):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"tRNS":
            trns = body
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"tEXt":
            key, _, value = body.partition(b"\0")
            text[key.decode("latin-1")] = value.decode("latin-1")
    if header is None:
        raise ValueError(f"{name}: no IHDR chunk")
    w, h, depth, colour, _, _, interlace = header
    if colour not in _CHANNELS:
        raise ValueError(f"{name}: colour type {colour} is not a PNG colour type")
    if depth not in _DEPTHS[colour]:
        raise ValueError(f"{name}: bit depth {depth} is not allowed with "
                         f"colour type {colour}")
    if interlace > 1:
        raise ValueError(f"{name}: unknown interlace method {interlace}")
    if colour == 3 and palette is None:
        raise ValueError(f"{name}: palette image without a PLTE chunk")
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError(f"{name}: truncated or corrupt image data ({e})") from None
    n = _CHANNELS[colour]
    px = _samples(raw, h, w, depth, n, interlace, name)
    if samples:
        img = px[..., 0] if n == 1 else px
    else:
        img = _convert(px, colour, depth, palette, trns, unchanged, name)
    return np.ascontiguousarray(img), text


def read(path: str | Path, unchanged: bool = False) -> np.ndarray:
    """``cv2.imread(path)`` in RGB order: (H, W, 3) uint8; with
    ``unchanged``, ``cv2.imread(path, cv2.IMREAD_UNCHANGED)`` in RGB(A)
    order (module docstring)."""
    return decode(Path(path).read_bytes(), str(path), unchanged=unchanged)[0]


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
