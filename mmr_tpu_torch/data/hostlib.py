"""The port's host-side codecs (``mmr_tpu_torch/csrc/host/*.c``): zstd
frames both ways; c-blosc 1.x chunks read over every compressor tensorstore
writes (blosclz, lz4, lz4hc, snappy, zlib, zstd) and written over zstd
(the reference's setting, clevel 3, with bitshuffle, byte shuffle or none);
and Huffman-coded JPEG, baseline and progressive, decoded as libjpeg-turbo
decodes it. They run on the CPU, where the JAX package's codecs run too
(c-blosc inside tensorstore, FFmpeg inside OpenCV).

The library is built at first use by the C compiler (``cc``, or ``$CC``)
into ``mmr_tpu_torch/_build/`` under a name keyed on a hash of the sources
and flags, by the policy of the CUDA library
(:func:`mmr_tpu_torch.ops._build.cached_build`): an edited source
rebuilds, an unchanged one is reused, processes that build at once each
write a file of their own and rename it into place, and the threads of
one process build once. There is no stand-in: without a compiler every
decode and encode raises.

:mod:`ctypes` releases the GIL during each call, so the Zarr chunk pool
encodes and decodes on all its threads at once. Damaged input raises
``ValueError`` and input this library does not take
``NotImplementedError``, each naming ``what`` (a chunk's path, a video's
frame) and the reason.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
import time
from pathlib import Path

import numpy as np

from mmr_tpu_torch.ops import _build

_PKG = Path(__file__).resolve().parents[1]
SRC_DIR = _PKG / "csrc" / "host"
BUILD_DIR = _PKG / "_build"
CC_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c11")

_P = ctypes.c_void_p
_N = ctypes.c_size_t
_IP = ctypes.POINTER(ctypes.c_int)
_NP = ctypes.POINTER(ctypes.c_size_t)
SIGNATURES = {
    "mmr_zstd_decompress": [ctypes.c_char_p, _N, _P, _N, _NP, ctypes.c_char_p, _N],
    "mmr_blosc_decompress": [ctypes.c_char_p, _N, _P, _N, _NP, ctypes.c_char_p, _N],
    "mmr_zstd_compress": [_P, _N, _P, _N, _NP, ctypes.c_char_p, _N],
    "mmr_blosc_compress": [_P, _N, _N, ctypes.c_int, _P, _N, _NP, ctypes.c_char_p, _N],
    "mmr_jpeg_info": [ctypes.c_char_p, _N, _IP, _IP, _IP, ctypes.c_char_p, _N],
    "mmr_jpeg_decode": [ctypes.c_char_p, _N, _P, _N, ctypes.c_int, ctypes.c_char_p, _N],
}
# each encoder's bound, size_t bound(size_t n): its largest output for n bytes
BOUNDS = {"mmr_zstd_compress": "mmr_zstd_compress_bound",
          "mmr_blosc_compress": "mmr_blosc_compress_bound"}
_CORRUPT, _UNSUPPORTED, _NOMEM = 1, 2, 3
# zarr's blosc ``shuffle`` names, as the encoder's argument
SHUFFLES = {"noshuffle": 0, "shuffle": 1, "bitshuffle": 2}
_ERRLEN = 512


def _cc_compile(sources: list[Path], tmp_lib: Path) -> None:
    cc = os.environ.get("CC") or shutil.which("cc")
    if not cc:
        raise RuntimeError(
            "no C compiler: the host decoders of mmr_tpu_torch (csrc/host/*.c: "
            "zstd, blosc, zlib, JPEG) are built at first use with cc (or $CC)")
    t0 = time.perf_counter()
    done = subprocess.run([cc, *CC_FLAGS, "-o", str(tmp_lib), *map(str, sources)],
                          capture_output=True, text=True)
    if done.returncode != 0:
        raise RuntimeError(f"{cc} failed to build the host decoders:\n"
                           f"{done.stdout}{done.stderr}")
    print(f"[mmr_tpu_torch] built {tmp_lib.name} in {time.perf_counter() - t0:.2f} s",
          flush=True)


def build() -> Path:
    """Compile the library if the one for these sources is missing;
    returns its path."""
    sources = sorted(SRC_DIR.glob("*.c"))
    return _build.cached_build("libmmr_host", CC_FLAGS, sources, sorted(SRC_DIR.glob("*.h")),
                               lambda tmp, tmp_lib: _cc_compile(sources, tmp_lib),
                               BUILD_DIR)


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded library (built on first call)."""
    lib = _build.load(build(), SIGNATURES)
    for name in BOUNDS.values():
        getattr(lib, name).argtypes = [_N]
        getattr(lib, name).restype = _N
    return lib


def _raise(rc: int, err, what: str) -> None:
    msg = f"{what}: {err.value.decode(errors='replace')}"
    if rc == _UNSUPPORTED:
        raise NotImplementedError(msg)
    if rc == _NOMEM:
        raise MemoryError(msg)
    raise ValueError(msg)


def _into(entry: str, data: bytes, out: np.ndarray, what: str) -> None:
    """Decode ``data`` with ``entry`` into all of ``out`` (C-contiguous)."""
    if not out.flags.c_contiguous or not out.flags.writeable:
        raise ValueError("the output must be a writable C-contiguous array")
    err = ctypes.create_string_buffer(_ERRLEN)
    got = ctypes.c_size_t()
    rc = getattr(library(), entry)(bytes(data), len(data), out.ctypes.data, out.nbytes,
                                   ctypes.byref(got), err, _ERRLEN)
    if rc:
        _raise(rc, err, what)
    if got.value != out.nbytes:
        raise ValueError(f"{what}: {got.value} bytes decoded, {out.nbytes} expected")


def zstd_decompress_into(data: bytes, out: np.ndarray, what: str = "zstd data") -> np.ndarray:
    """Every zstd frame of ``data`` into ``out``, which it must fill."""
    _into("mmr_zstd_decompress", data, out, what)
    return out


def blosc_decompress_into(data: bytes, out: np.ndarray,
                          what: str = "blosc chunk") -> np.ndarray:
    """One c-blosc 1.x chunk (blosclz, lz4, snappy, zlib or zstd streams)
    into ``out``, which it must fill."""
    _into("mmr_blosc_decompress", data, out, what)
    return out


def _compress(entry: str, data, what: str, *extra) -> bytes:
    if isinstance(data, (bytes, bytearray, memoryview)):
        src = np.frombuffer(data, np.uint8)
    else:
        src = np.ascontiguousarray(data).reshape(-1).view(np.uint8)
    lib = library()
    out = np.empty(getattr(lib, BOUNDS[entry])(src.nbytes), np.uint8)
    err = ctypes.create_string_buffer(_ERRLEN)
    got = ctypes.c_size_t()
    rc = getattr(lib, entry)(src.ctypes.data, src.nbytes, *extra, out.ctypes.data,
                             out.nbytes, ctypes.byref(got), err, _ERRLEN)
    if rc:
        _raise(rc, err, what)
    return out[:got.value].tobytes()


def zstd_compress(data, what: str = "zstd data") -> bytes:
    """``data`` (bytes or a C-ordered array's bytes) as one zstd frame."""
    return _compress("mmr_zstd_compress", data, what)


def blosc_compress(data, typesize: int, what: str = "blosc chunk",
                   shuffle: str = "bitshuffle") -> bytes:
    """``data`` (bytes or a C-ordered array's bytes, elements of
    ``typesize`` bytes) as one c-blosc 1.x chunk: zstd, ``shuffle`` (a zarr
    blosc name: ``bitshuffle``, ``shuffle`` or ``noshuffle``) in its header
    flags and applied to each block, the block size c-blosc picks at
    clevel 3."""
    if shuffle not in SHUFFLES:
        raise NotImplementedError(f"{what}: blosc shuffle {shuffle!r} (one of {list(SHUFFLES)})")
    return _compress("mmr_blosc_compress", data, what, int(typesize), SHUFFLES[shuffle])


def jpeg_decode(data: bytes, what: str = "JPEG image",
                fancy_upsampling: bool = True) -> np.ndarray:
    """A Huffman-coded JPEG (baseline, extended or progressive) → (H, W, 3)
    RGB or (H, W, 1) grey uint8: with ``fancy_upsampling``, the samples
    libjpeg-turbo gives with its default settings (its triangular chroma
    upsampling at 4:2:2, 4:2:0 and 4:4:0, each sample repeated at other
    ratios); without, the chroma as OpenCV's FFmpeg backend gives
    Motion-JPEG frames through swscale: each sample repeated at 4:4:4, and at
    4:2:2 and 4:2:0 of even height, elsewhere resampled by its generic
    scaler (Keys' cubic, a = -0.6) to half the width and the full height,
    each pair of pixels sharing one (within a few levels: FFmpeg's IDCT,
    swscale's fixed point and its colour conversion round otherwise)."""
    lib, data = library(), bytes(data)
    err = ctypes.create_string_buffer(_ERRLEN)
    h, w, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    rc = lib.mmr_jpeg_info(data, len(data), ctypes.byref(h), ctypes.byref(w),
                           ctypes.byref(c), err, _ERRLEN)
    if rc:
        _raise(rc, err, what)
    out = np.empty((h.value, w.value, c.value), np.uint8)
    rc = lib.mmr_jpeg_decode(data, len(data), out.ctypes.data, out.nbytes, int(fancy_upsampling), err,
                             _ERRLEN)
    if rc:
        _raise(rc, err, what)
    return out
