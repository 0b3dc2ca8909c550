"""AVI files of Motion-JPEG video: the port's counterpart of the part of
``cv2.VideoCapture`` that ``mmr_tpu/data/convert.py`` uses (the frame
width and height, a seek to a frame, a read of it).

The container is parsed as RIFF: the ``AVI `` RIFF and any OpenDML
``AVIX`` RIFFs after it, the video stream's header and format
(``strh`` / ``strf``), its fourcc, and its frames' chunks found through,
in this order, the OpenDML super index (``indx`` pointing at ``ix##``
standard indexes, which reach past the first gigabyte), the ``idx1``
index, or else a walk of every ``movi`` list. Frame ``i`` is the stream's
``i``-th chunk, as FFmpeg counts them; a chunk of zero bytes repeats the
frame before it; a frame past the end reads as ``None`` (``cap.read()``'s
``False``).

Only JPEG-in-AVI is decoded: the fourccs ``MJPG``, ``mjpg``, ``AVRn`` and
``AVDJ``, frames baseline, extended or progressive (SOF0-SOF2), at any
sampling whose ratios are whole numbers (4:4:4, 4:2:2, 4:2:0, 4:4:0,
4:1:1, ...). Any other fourcc raises ``NotImplementedError`` naming it, as
do lossless, arithmetic-coded and 12-bit frames. Frames are decoded by
:func:`mmr_tpu_torch.data.hostlib.jpeg_decode`: by default sample for
sample as libjpeg-turbo (and PIL) decodes them, with its chroma
upsampling; with ``fancy_upsampling=False`` the chroma comes as OpenCV's
FFmpeg backend gives it (each sample repeated at 4:2:2 and 4:2:0 of even
height; swscale's cubic resampling at 4:4:0, 4:1:1 and odd heights), so
the frames come within a few levels of ``cv2.VideoCapture``'s (FFmpeg
rounds its IDCT and colour conversion otherwise) where libjpeg's filters
part from them by tens of levels at sharp colour edges.
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

from mmr_tpu_torch.data import hostlib

JPEG_FOURCCS = ("MJPG", "mjpg", "AVRn", "AVDJ")


def _fourcc(raw: bytes) -> str:
    return raw.decode("latin-1")


class VideoReader:
    """One AVI file: ``width``, ``height``, ``fourcc``, ``frame_count``;
    :meth:`read` gives frame ``i`` as (H, W, 3) RGB uint8, or None past
    the last frame; ``fancy_upsampling``: libjpeg's chroma upsampling
    (True) or OpenCV's chroma (False)."""

    def __init__(self, path: str | Path, fancy_upsampling: bool = True):
        self.path = Path(path)
        self.fancy_upsampling = fancy_upsampling
        self._f = open(self.path, "rb")
        try:
            self._parse()
        except BaseException:
            self._f.close()
            raise

    # ------------------------------------------------------------ container
    def _read_at(self, offset: int, n: int) -> bytes:
        self._f.seek(offset)
        data = self._f.read(n)
        if len(data) != n:
            raise ValueError(f"{self.path}: truncated AVI ({n} bytes wanted at {offset})")
        return data

    def _chunks(self, start: int, end: int):
        """(fourcc, data offset, size, list type or None) of the chunks in
        [start, end)."""
        pos = start
        while pos + 8 <= end:
            head = self._read_at(pos, 8)
            fcc, size = _fourcc(head[:4]), struct.unpack("<I", head[4:])[0]
            kind = None
            if fcc in ("RIFF", "LIST"):
                kind = _fourcc(self._read_at(pos + 8, 4))
            yield fcc, pos + 8, size, kind
            pos += 8 + size + (size & 1)

    def _parse(self) -> None:
        size = self.path.stat().st_size
        riffs = [(off, n, kind) for fcc, off, n, kind in self._chunks(0, size)
                 if fcc == "RIFF"]
        if not riffs or riffs[0][2] != "AVI ":
            raise ValueError(f"{self.path}: not an AVI file")
        off, n, _ = riffs[0]
        top = list(self._chunks(off + 4, min(off + n, size)))
        hdrl = next(((o, s) for f, o, s, k in top if f == "LIST" and k == "hdrl"), None)
        if hdrl is None:
            raise ValueError(f"{self.path}: AVI without a header list")
        stream, super_index = None, None
        number = 0
        for f, o, s, k in self._chunks(hdrl[0] + 4, hdrl[0] + hdrl[1]):
            if f != "LIST" or k != "strl":
                continue
            parts = {pf: (po, ps) for pf, po, ps, _ in self._chunks(o + 4, o + s)}
            strh = self._read_at(*parts["strh"]) if "strh" in parts else b""
            if strh[:4] == b"vids":
                strf = self._read_at(*parts["strf"])
                if len(strf) < 20:
                    raise ValueError(f"{self.path}: short video stream format")
                self.width, height = struct.unpack("<ii", strf[4:12])
                self.height = abs(height)
                self.fourcc = _fourcc(strf[16:20])
                stream = number
                super_index = parts.get("indx")
                break
            number += 1
        if stream is None:
            raise ValueError(f"{self.path}: AVI without a video stream")
        if self.fourcc not in JPEG_FOURCCS:
            raise NotImplementedError(
                f"{self.path}: video codec fourcc {self.fourcc!r} (this reader "
                f"decodes Motion-JPEG AVI: {', '.join(JPEG_FOURCCS)})")
        self._ids = {f"{stream:02d}dc".encode(), f"{stream:02d}db".encode()}
        movis = []
        for roff, rn, _ in riffs:
            items = top if roff == off else list(
                self._chunks(roff + 4, min(roff + rn, size)))
            movis += [(o, s) for f, o, s, k in items if f == "LIST" and k == "movi"]
        if super_index is not None:
            index = self._odml_index(*super_index)
        else:
            idx1 = next(((o, s) for f, o, s, _ in top if f == "idx1"), None)
            index = self._idx1(*idx1, movis) if idx1 else None
            if index is None:
                index = [(o, s) for mo, ms in movis for o, s in self._movi_walk(mo, ms)]
        self._index = index

    def _odml_index(self, offset: int, size: int) -> list[tuple[int, int]]:
        head = self._read_at(offset, min(size, 24))
        per, _, kind, used = struct.unpack("<HBBI", head[:8])
        if kind != 0 or per != 4:
            raise ValueError(f"{self.path}: OpenDML super index of type {kind}")
        frames = []
        for k in range(used):
            qoff, _, _ = struct.unpack("<QII", self._read_at(offset + 24 + 16 * k, 16))
            head = self._read_at(qoff, 32)
            per, _, kind, count = struct.unpack("<HBBI", head[8:16])
            base = struct.unpack("<Q", head[20:28])[0]
            if kind != 1 or per != 2:
                raise ValueError(f"{self.path}: OpenDML standard index of type {kind}")
            entries = np.frombuffer(self._read_at(qoff + 32, 8 * count), "<u4")
            entries = entries.reshape(count, 2)
            frames += [(base + int(o), int(s) & 0x7FFFFFFF) for o, s in entries]
        return frames

    def _idx1(self, offset: int, size: int, movis) -> list[tuple[int, int]] | None:
        """The stream's entries of the ``idx1`` index, their offsets taken
        from the ``movi`` fourcc (the usual base) or from the file's start,
        whichever points at the entry's chunk id; None when it is empty."""
        raw = np.frombuffer(self._read_at(offset, size - size % 16), np.uint8)
        rows = raw.reshape(-1, 16)
        ids = [bytes(r[:4]) for r in rows]
        keep = [i for i, c in enumerate(ids) if c in self._ids]
        if not keep or not movis:
            return None
        off = rows[keep][:, 8:12].copy().view("<u4")[:, 0].astype(np.int64)
        siz = rows[keep][:, 12:16].copy().view("<u4")[:, 0].astype(np.int64)
        first = ids[keep[0]]
        for base in (movis[0][0], 0):
            try:
                if self._read_at(base + int(off[0]), 4) == first:
                    return [(base + int(o) + 8, int(s)) for o, s in zip(off, siz)]
            except ValueError:
                pass
        raise ValueError(f"{self.path}: idx1 offsets point at no chunk")

    def _movi_walk(self, offset: int, size: int):
        for fcc, o, s, kind in self._chunks(offset + 4, offset + size):
            if fcc == "LIST" and kind == "rec ":
                yield from self._movi_walk(o, s)
            elif fcc.encode("latin-1") in self._ids:
                yield o, s

    # --------------------------------------------------------------- frames
    @property
    def frame_count(self) -> int:
        return len(self._index)

    def frame_bytes(self, i: int) -> bytes | None:
        """Frame ``i``'s JPEG bytes (a zero-byte chunk: the frame before
        it), or None past the end."""
        if not 0 <= i < len(self._index):
            return None
        for j in range(i, -1, -1):
            off, size = self._index[j]
            if size:
                return self._read_at(off, size)
        return None

    def read(self, i: int) -> np.ndarray | None:
        """Frame ``i`` as (H, W, 3) RGB uint8, or None past the end."""
        data = self.frame_bytes(i)
        if data is None:
            return None
        frame = hostlib.jpeg_decode(data, f"{self.path} frame {i}", self.fancy_upsampling)
        if frame.shape[2] == 1:
            frame = np.repeat(frame, 3, axis=2)
        return frame

    def close(self) -> None:
        self._f.close()

    def __enter__(self) -> "VideoReader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
