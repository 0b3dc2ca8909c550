"""Zarr v3 video stores without tensorstore (counterpart of
``mmr_tpu/data/zarr_io.py``), in numpy, ``json``, ``zlib``, the standard
library and the port's host decoders (:mod:`mmr_tpu_torch.data.hostlib`).

The on-disk schema is the reference's (zarr v3, ``Data_Loader.py:303-397``):

    <dataset>/data/data_NNN.zarr/
        zarr.json            (group; attrs: properties.class_locations)
        image/               (3, T, H, W) float32 or uint8, chunks (3, 1, *patch)
        mask/                (T, H, W) uint8, chunks (1, *patch)

Chunks are files ``<array>/c/<i>/<j>/...`` (the ``default`` chunk key
encoding), edge chunks stored at full size; a chunk that holds only the
fill value is absent, and reads as the fill value. :class:`ZarrArray`
reads the codecs ``bytes`` (little endian) alone, ``bytes`` + ``gzip``,
and ``bytes`` + ``blosc`` with the zstd compressor: the stores the
reference's converter writes (zstd, clevel 3, bitshuffle;
``Data_Loader.py:664-666``) and JAX's ``VideoStore`` writes through
tensorstore. It writes ``bytes`` + ``gzip``, which tensorstore reads too;
writing blosc would need an encoder this package does not have, so a write
into a blosc array raises. It takes what the schema holds and nothing
more: uint8 and float32, the ``/`` chunk key separator, a numeric fill
value, blosc over zstd; anything else (another codec, another blosc
compressor) raises ``NotImplementedError`` naming it, rather than being
misread.

Reads decode only the chunks a window touches, each on a shared thread
pool (``zlib``, the host decoders and file reads release the GIL, so the
decodes run in parallel), straight into the caller's output array.
"""

from __future__ import annotations

import itertools
import json
import os
import shutil
import threading
import zlib
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

from mmr_tpu_torch.data import hostlib
from mmr_tpu_torch.ops.padcrop import window_slices

GZIP_LEVEL = 1
_DTYPES = ("uint8", "float32")
_COMPRESSORS = ("gzip", "blosc")   # the codecs this reader takes after ``bytes``

POOL_THREADS = min(32, os.cpu_count() or 1)   # the chunk pool's default size

_pool: ThreadPoolExecutor | None = None
_pool_threads = POOL_THREADS
_pool_lock = threading.Lock()


def _executor() -> ThreadPoolExecutor:
    """The chunk codec pool, made at first use: one per process, so the
    reads of every store and sampler share the cores."""
    global _pool
    with _pool_lock:
        if _pool is None:
            _pool = ThreadPoolExecutor(max_workers=_pool_threads,
                                       thread_name_prefix="zarr-chunk")
        return _pool


def set_pool_threads(n: int) -> None:
    """Decode every later chunk on ``n`` threads (``POOL_THREADS`` until
    this is called). Reads already started finish on the old pool."""
    global _pool, _pool_threads
    if n < 1:
        raise ValueError(f"{n} pool threads")
    with _pool_lock:
        if _pool is not None:
            _pool.shutdown(wait=False)
        _pool, _pool_threads = None, int(n)


def _waiter(futures, result=None):
    def wait():
        for f in futures:
            f.result()
        return result
    return wait


class ZarrArray:
    """One zarr v3 array: ``shape``, ``chunks``, ``dtype``,
    ``fill_value``; ``arr[index]`` reads (ints and unit-step slices),
    :meth:`read_async` reads into a given array, :meth:`write` writes."""

    def __init__(self, path: str | Path):
        self.path = Path(path)
        meta = json.loads((self.path / "zarr.json").read_text())
        if meta.get("zarr_format") != 3 or meta.get("node_type") != "array":
            raise ValueError(f"{self.path}: not a zarr v3 array")
        self.shape = tuple(int(n) for n in meta["shape"])
        grid = meta["chunk_grid"]
        if grid["name"] != "regular":
            raise NotImplementedError(f"{self.path}: chunk grid {grid['name']!r}")
        self.chunks = tuple(int(n) for n in grid["configuration"]["chunk_shape"])
        enc = meta.get("chunk_key_encoding", {"name": "default"})
        sep = enc.get("configuration", {}).get("separator", "/")
        if enc["name"] != "default" or sep != "/":
            raise NotImplementedError(
                f"{self.path}: chunk key encoding {enc['name']!r}, separator {sep!r}")
        if meta.get("storage_transformers"):
            raise NotImplementedError(f"{self.path}: storage transformers")
        if meta["data_type"] not in _DTYPES:
            raise NotImplementedError(f"{self.path}: data type {meta['data_type']!r}")
        self.dtype = np.dtype(meta["data_type"]).newbyteorder("<")
        codecs = meta["codecs"]
        names = [c["name"] for c in codecs]
        bad = next((n for i, n in enumerate(names)
                    if (i == 0) != (n == "bytes") or (i > 0 and n not in _COMPRESSORS)),
                   None)
        if bad is not None or len(names) > 2:
            raise NotImplementedError(
                f"{self.path}: codec {bad or names[-1]!r} is not supported "
                f"(codecs {names}; this reader takes 'bytes', 'bytes' + 'gzip' "
                f"and 'bytes' + 'blosc')")
        endian = codecs[0].get("configuration", {}).get("endian", "little")
        if endian != "little":
            raise NotImplementedError(f"{self.path}: {endian} endian bytes")
        self._codec = names[1] if len(names) == 2 else None
        if self._codec == "blosc":
            cname = codecs[1].get("configuration", {}).get("cname")
            if cname != "zstd":
                raise NotImplementedError(
                    f"{self.path}: blosc compressor {cname!r} is not supported "
                    f"(this reader takes blosc over zstd, the reference's)")
            hostlib.library()   # built here, on the opener's thread, not on the pool
        fill = meta.get("fill_value", 0)
        if isinstance(fill, (str, bool)) or not isinstance(fill, (int, float)):
            raise NotImplementedError(f"{self.path}: fill value {fill!r}")
        self.fill_value = self.dtype.type(fill)

    @classmethod
    def create(cls, path: str | Path, shape, chunks, dtype) -> "ZarrArray":
        """A new empty array at ``path`` (an array there before is
        removed), codecs ``bytes`` + ``gzip`` at ``GZIP_LEVEL``, fill
        value 0."""
        path = Path(path)
        if (path / "zarr.json").exists():
            shutil.rmtree(path)
        path.mkdir(parents=True, exist_ok=True)
        (path / "zarr.json").write_text(json.dumps({
            "zarr_format": 3, "node_type": "array",
            "shape": [int(n) for n in shape], "data_type": np.dtype(dtype).name,
            "chunk_grid": {"name": "regular",
                           "configuration": {"chunk_shape": [int(n) for n in chunks]}},
            "chunk_key_encoding": {"name": "default"},
            "fill_value": 0,
            "codecs": [{"name": "bytes", "configuration": {"endian": "little"}},
                       {"name": "gzip", "configuration": {"level": GZIP_LEVEL}}],
        }))
        return cls(path)

    @property
    def ndim(self) -> int:
        return len(self.shape)

    # ------------------------------------------------------------ chunks
    def _chunk_path(self, idx) -> Path:
        return self.path.joinpath("c", *map(str, idx))

    def _read_chunk(self, idx) -> np.ndarray | None:
        """Chunk ``idx`` at full chunk shape, or None where it is absent."""
        path = self._chunk_path(idx)
        try:
            data = path.read_bytes()
        except FileNotFoundError:
            return None
        n = int(np.prod(self.chunks)) * self.dtype.itemsize
        if self._codec == "blosc":
            buf = hostlib.blosc_decompress_into(data, np.empty(n, np.uint8), str(path))
            return buf.view(self.dtype).reshape(self.chunks)
        if self._codec == "gzip":
            try:   # one output buffer of the chunk's size: no regrowth, no join
                data = zlib.decompress(data, 31, n)
            except zlib.error as e:
                raise ValueError(f"{path}: corrupt gzip chunk ({e})") from None
        if len(data) != n:
            raise ValueError(f"{path}: {len(data)} bytes, a chunk holds {n}")
        return np.frombuffer(data, self.dtype).reshape(self.chunks)

    def _write_chunk(self, idx, src, part: np.ndarray) -> None:
        if self._codec == "blosc":
            raise NotImplementedError(
                f"{self.path}: writing blosc chunks (this package writes 'bytes' + 'gzip')")
        in_bounds = tuple(min(c, n - i * c)
                          for i, c, n in zip(idx, self.chunks, self.shape))
        whole = all(s.stop - s.start == m for s, m in zip(src, in_bounds))
        old = None if whole else self._read_chunk(idx)
        buf = (np.full(self.chunks, self.fill_value, self.dtype) if old is None
               else old.copy())
        buf[src] = part
        path = self._chunk_path(idx)
        if not np.any(buf != self.fill_value):
            path.unlink(missing_ok=True)   # fill-valued chunks stay absent
            return
        data = buf.tobytes()
        if self._codec == "gzip":
            c = zlib.compressobj(GZIP_LEVEL, zlib.DEFLATED, 31)
            data = c.compress(data) + c.flush()
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f".{path.name}.tmp")
        tmp.write_bytes(data)
        os.replace(tmp, path)

    # ------------------------------------------------------------ regions
    def _region(self, index) -> tuple[tuple[slice, ...], list[int]]:
        """(one unit-step slice a dim, the dims indexed by an int)."""
        if not isinstance(index, tuple):
            index = (index,)
        if len(index) > self.ndim:
            raise IndexError(f"{len(index)} indices for {self.ndim} dims")
        index = index + (slice(None),) * (self.ndim - len(index))
        region, ints = [], []
        for d, (ix, n) in enumerate(zip(index, self.shape)):
            if isinstance(ix, slice):
                lo, hi, step = ix.indices(n)
                if step != 1:
                    raise IndexError("only unit-step slices are supported")
                region.append(slice(lo, max(lo, hi)))
            else:
                i = int(ix) + (n if int(ix) < 0 else 0)
                if not 0 <= i < n:
                    raise IndexError(f"index {ix} is out of bounds for dim {d} of {n}")
                region.append(slice(i, i + 1))
                ints.append(d)
        return tuple(region), ints

    def _plan(self, region):
        """(chunk index, slices in the chunk, slices in the region) for
        every chunk the region touches."""
        ranges = [range(s.start // c, (s.stop - 1) // c + 1) if s.stop > s.start
                  else range(0) for s, c in zip(region, self.chunks)]
        for idx in itertools.product(*ranges):
            src, dst = [], []
            for i, c, s in zip(idx, self.chunks, region):
                lo, hi = max(s.start, i * c), min(s.stop, (i + 1) * c)
                src.append(slice(lo - i * c, hi - i * c))
                dst.append(slice(lo - s.start, hi - s.start))
            yield idx, tuple(src), tuple(dst)

    def read_async(self, index, out: np.ndarray | None = None):
        """Start reading ``index``: each touched chunk is decoded on the
        pool into ``out`` (a writable array or view of the region's shape,
        int-indexed dims kept at size 1; a new array when None). Returns
        ``wait() -> out`` (int-indexed dims dropped from a new array)."""
        region, ints = self._region(index)
        shape = tuple(s.stop - s.start for s in region)
        new = out is None
        if new:
            out = np.empty(shape, self.dtype)
        elif out.shape != shape:
            raise ValueError(f"out has shape {out.shape}, the region {shape}")

        def fill(idx, src, dst):
            chunk = self._read_chunk(idx)
            out[dst] = self.fill_value if chunk is None else chunk[src]

        pool = _executor()
        futures = [pool.submit(fill, *t) for t in self._plan(region)]
        if new:
            result = out.reshape([n for d, n in enumerate(shape) if d not in ints])
        else:
            result = out
        return _waiter(futures, result)

    def __getitem__(self, index) -> np.ndarray:
        return self.read_async(index)()

    def write_async(self, index, data: np.ndarray):
        """Start writing ``data`` (the region's shape, int-indexed dims
        dropped) at ``index``, a chunk a pool task; chunks the region
        covers in part are read, merged and rewritten. Returns ``wait()``."""
        region, ints = self._region(index)
        shape = tuple(s.stop - s.start for s in region)
        want = tuple(n for d, n in enumerate(shape) if d not in ints)
        if np.shape(data) != want:
            raise ValueError(f"data has shape {np.shape(data)}, the region {want}")
        data = np.expand_dims(np.asarray(data, self.dtype), tuple(ints))
        pool = _executor()
        return _waiter([pool.submit(self._write_chunk, idx, src, data[dst])
                        for idx, src, dst in self._plan(region)])

    def write(self, index, data) -> None:
        self.write_async(index, data)()


class VideoStore:
    """One per-video Zarr store (the reference's ``data_NNN.zarr``)."""

    def __init__(self, path: str | Path):
        self.path = Path(path)
        self._image: ZarrArray | None = None
        self._mask: ZarrArray | None = None

    # ------------------------------------------------------------- creation
    @classmethod
    def create(cls, path: str | Path, n_frames: int, height: int, width: int,
               patch_size: tuple[int, int], image_dtype=np.float32) -> "VideoStore":
        """A new store of ``n_frames`` frames of ``height`` × ``width``,
        chunked by ``patch_size``. ``image_dtype=np.uint8`` is the compact
        variant (lossless for 8-bit video, whose reference values are
        ``k/255`` floats); float32 is the reference's schema."""
        self = cls(path)
        self.path.mkdir(parents=True, exist_ok=True)
        (self.path / "zarr.json").write_text(json.dumps({
            "zarr_format": 3, "node_type": "group", "attributes": {},
        }))
        ph, pw = int(patch_size[0]), int(patch_size[1])
        self._image = ZarrArray.create(self.path / "image",
                                       (3, n_frames, height, width), (3, 1, ph, pw),
                                       image_dtype)
        self._mask = ZarrArray.create(self.path / "mask", (n_frames, height, width),
                                      (1, ph, pw), np.uint8)
        return self

    @property
    def image_dtype(self) -> np.dtype:
        return self.image.dtype

    def write_frame(self, i: int, image_chw: np.ndarray, mask_hw: np.ndarray) -> None:
        """Frame ``i``: ``image_chw`` (3, H, W) in [0, 1] (rounded to
        uint8 levels in a compact store), ``mask_hw`` (H, W) class ids."""
        if self.image_dtype == np.uint8:
            img = np.clip(np.rint(np.asarray(image_chw, np.float32) * 255.0),
                          0, 255).astype(np.uint8)
        else:
            img = image_chw.astype(np.float32)
        waits = [self.image.write_async((slice(None), i), img),
                 self.mask.write_async((i,), mask_hw.astype(np.uint8))]
        for wait in waits:
            wait()

    def set_properties(self, properties: dict) -> None:
        meta = json.loads((self.path / "zarr.json").read_text())
        meta.setdefault("attributes", {})["properties"] = properties
        (self.path / "zarr.json").write_text(json.dumps(meta))

    # -------------------------------------------------------------- reading
    @property
    def image(self) -> ZarrArray:
        if self._image is None:
            self._image = ZarrArray(self.path / "image")
        return self._image

    @property
    def mask(self) -> ZarrArray:
        if self._mask is None:
            self._mask = ZarrArray(self.path / "mask")
        return self._mask

    @property
    def properties(self) -> dict:
        meta = json.loads((self.path / "zarr.json").read_text())
        return meta.get("attributes", {}).get("properties", {})

    @property
    def class_locations(self) -> dict[int, list]:
        return {int(k): v for k, v in self.properties.get("class_locations", {}).items()}

    @property
    def shape(self):
        """(T, H, W) of the mask array."""
        return tuple(self.mask.shape)

    def _window(self, image: bool, t: int, y0: int, x0: int, h: int, w: int,
                pad_value):
        """Start reading frame ``t``'s window at (y0, x0) of size (h, w):
        the image as (h, w, 3) in the store dtype, or the mask as (h, w),
        ``pad_value`` outside the frame. Returns ``wait() -> array``."""
        if not 0 <= int(t) < self.shape[0]:
            raise IndexError(f"frame {t} is out of bounds for {self.shape[0]} frames")
        src, (by, bx) = window_slices((y0, x0), (h, w), self.shape[1:])
        ny, nx = (s.stop - s.start for s in src)
        arr = self.image if image else self.mask
        out = np.full((h, w, 3) if image else (h, w), pad_value, arr.dtype)
        inner = out[by:by + ny, bx:bx + nx]
        if image:
            region = (slice(None), slice(t, t + 1)) + src
            view = inner.transpose(2, 0, 1)[:, None]
        else:
            region = (slice(t, t + 1),) + src
            view = inner[None]
        done = arr.read_async(region, out=view)

        def finish():
            done()
            return out
        return finish

    def read_image_window(self, t: int, y0: int, x0: int, h: int, w: int,
                          pad_value: float = 0.0) -> np.ndarray:
        """Frame ``t``'s window → (h, w, 3) float32 NHWC, padded with
        ``pad_value`` outside the frame (the ``crop_from_zarr`` contract,
        ``Pre_Process.py:466-535``); a compact store's values / 255."""
        img = self._window(True, t, y0, x0, h, w, pad_value)()
        if img.dtype == np.uint8:
            img = img.astype(np.float32) / 255.0
        return img

    def read_mask_window(self, t: int, y0: int, x0: int, h: int, w: int) -> np.ndarray:
        return self._window(False, t, y0, x0, h, w, 0)()

    def read_windows_async(self, t: int, y0: int, x0: int, h: int, w: int):
        """Start the image and mask window reads (their chunks decode on the
        pool) and return ``finish() -> (img_hwc, mask_hw_u8)``; the image
        keeps the STORE dtype (uint8 0..255 for compact stores, f32 [0, 1]
        for the reference schema), zero outside the frame."""
        img = self._window(True, t, y0, x0, h, w, 0)
        mask = self._window(False, t, y0, x0, h, w, 0)
        return lambda: (img(), mask())

    def read_frames(self, t0: int, t1: int) -> tuple[np.ndarray, np.ndarray]:
        """Whole frames [t0, t1) → image (T, H, W, 3) in the STORE dtype
        (uint8 0..255 for compact stores, divided by 255 on the device;
        f32 [0, 1] for reference-schema stores), mask (T, H, W) u8. Every
        chunk of the frames decodes on the pool at once."""
        _, h, w = self.shape
        t0, t1, _ = slice(t0, t1).indices(self.shape[0])
        t1 = max(t0, t1)
        img = np.empty((t1 - t0, h, w, 3), self.image_dtype)
        mask = np.empty((t1 - t0, h, w), np.uint8)
        waits = [self.image.read_async((slice(None), slice(t0, t1)),
                                       out=img.transpose(3, 0, 1, 2)),
                 self.mask.read_async((slice(t0, t1),), out=mask)]
        for wait in waits:
            wait()
        return img, mask


def list_dataset_stores(dataset_path: str | Path) -> list[Path]:
    """All ``*.zarr`` stores under ``<dataset>/data/`` (or the path itself),
    sorted — the reference's discovery convention (``model_inference.py:169-194``)."""
    root = Path(dataset_path)
    data_dir = root / "data" if (root / "data").is_dir() else root
    return sorted(p for p in data_dir.glob("*.zarr") if p.is_dir())
