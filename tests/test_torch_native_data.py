"""The port's host decoders (``mmr_tpu_torch/csrc/host``, built by ``cc``
at first use) and Path B's data entry held against the JAX package on the
CPU:

- zstd frames against the ``zstandard`` library's at levels 1, 3, 9, 19
  and 22 (raw, RLE and compressed blocks; Huffman and FSE tables of every
  mode); blosc-zstd chunks written by tensorstore at clevels 1, 3 and 9
  (c-blosc's zstd levels 1, 5 and 22), with bitshuffle, byte shuffle and
  none, over noise, smooth and constant content, edge chunks, a
  3×1×512×640 float32 chunk (30 blosc blocks of several zstd blocks) and
  chunks of 105 and 221 elements (blocks c-blosc leaves unshuffled):
  the port's ``ZarrArray`` reads them bit-equal to tensorstore; split
  streams, raw streams and memcpyed chunks built here by the format;
- the committed JAX-written stores (``tests/torch_fixtures``) read by the
  port's ``VideoStore`` and ``PatchSampler`` bit-equal to JAX's reads and
  to the recorded sha256;
- JPEG frames decoded exactly as PIL (libjpeg-turbo) decodes them: cv2's
  Motion-JPEG at 48×64 and 1080×1920 (4:2:0), PIL's 4:4:4 and 4:2:2,
  restart markers, grey, frames without DHT (Annex K tables), odd sizes;
  AVI through ``idx1``, a ``movi`` walk and a hand-built OpenDML file
  (``AVIX`` + ``indx`` / ``ix00``) that cv2 reads too;
- ``convert_zip_dataset`` (nested ZIP, flat ZIP, folder) and
  ``extract_frames_dataset`` against JAX's: masks, ``class_locations`` and
  split files exactly equal, frames within a stated bound of cv2's decode;
- the refusals, each naming what it refuses, and ``mmr_torch_create_dataset``
  end to end.
"""

import io
import json
import shutil
import struct
import zipfile
from pathlib import Path

import cv2
import numpy as np
import pytest
import tensorstore as ts
import zstandard
from PIL import Image

from mmr_tpu_torch.data import convert, hostlib, png, zarr_io
from mmr_tpu_torch.data.patch_dataset import PatchSampler
from mmr_tpu_torch.data.video import VideoReader
from mmr_tpu_torch.data.zarr_io import VideoStore, ZarrArray
from tests.test_torch_train_modules import few_torch_threads  # noqa: F401

FIXTURES = Path(__file__).resolve().parent / "torch_fixtures"
RECORDS = json.loads((FIXTURES / "records.json").read_text())
BYTES = {"name": "bytes", "configuration": {"endian": "little"}}

# the converters' frames (``VideoReader(fancy_upsampling=False)``: each
# chroma sample repeated, as OpenCV's FFmpeg backend does) against cv2's
# decode of the same Motion-JPEG (FFmpeg's IDCT and YUV -> BGR round
# otherwise), in levels of 255, measured (mean, max) by kind of content:
# smooth frames with sensor noise 0.69-0.74 / 3-4 (48×64 and the
# converter's 90×128 videos); JAX's own converter-test frames (a blue block
# on grey, ``tests/test_convert.py:26-27``: sharp colour edges) 0.33-0.64
# / 3; the 1080×1920 fixture (tissue-like fields, bright bars, noise)
# 0.64-0.65 / 3-4. Every kind is held to the converter's bound:
CV2_MEAN, CV2_MAX = 1.5, 16
# libjpeg's decode (the default, PIL's samples: the triangular chroma
# filter) against cv2's, measured: smooth 0.94-1.32 / 5-7, edges 1.12-1.67
# / 79, the fixture 0.67-0.68 / 30-38; held per kind at
LIBJPEG_GAP = {"smooth": (1.5, 16), "edges": (2.0, 96), "fixture": (1.0, 48)}


@pytest.fixture(scope="module", autouse=True)
def two_decode_threads():
    zarr_io.set_pool_threads(2)
    yield
    zarr_io.set_pool_threads(zarr_io.POOL_THREADS)


def _sha(a) -> str:
    import hashlib
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def _content(kind, shape, dtype, rng):
    n = int(np.prod(shape))
    if kind == "noise":
        a = rng.rand(n) if dtype == "float32" else rng.randint(0, 256, n)
    elif kind == "smooth":
        a = (np.sin(np.arange(n) / 300.0) + 1) / 2
        a = np.round(a * 255) / 255 if dtype == "float32" else np.round(a * 255)
    else:
        a = np.full(n, 0.5 if dtype == "float32" else 7)
    return a.reshape(shape).astype(dtype)


def _ts_array(path, shape, chunks, dtype, codecs):
    return ts.open({"driver": "zarr3", "kvstore": {"driver": "file", "path": str(path)},
                    "metadata": {"shape": list(shape), "data_type": dtype,
                                 "chunk_grid": {"name": "regular", "configuration":
                                                {"chunk_shape": list(chunks)}},
                                 "codecs": codecs},
                    "create": True, "delete_existing": True}).result()


def _blosc(cname="zstd", clevel=3, shuffle="bitshuffle", typesize=4):
    return {"name": "blosc", "configuration": {"cname": cname, "clevel": clevel,
                                               "shuffle": shuffle, "typesize": typesize}}


def _chunk_file(path) -> Path:
    return next(f for f in sorted(Path(path).rglob("*")) if f.is_file()
                and f.name != "zarr.json")


# ------------------------------------------------------------------- zstd

@pytest.mark.parametrize("level", [1, 3, 9, 19, 22])
@pytest.mark.parametrize("kind", ["noise", "smooth", "constant", "records", "bytes",
                                  "short"])
def test_zstd_matches_zstandard(level, kind):
    """One frame each of float noise (4-stream Huffman literals with
    FSE-coded weights, treeless literals at levels 9 and 19), smooth floats
    (raw literals, RLE and compressed sequence tables), a constant
    (predefined tables), text records (repeat offsets, repeat tables),
    random bytes (raw blocks) and a short text (one Huffman stream at level
    19), plus the same with a checksum, without a content size (a window
    descriptor), and two frames after a skippable one."""
    rng = np.random.RandomState(level)
    if kind == "records":
        data = b"".join(b"%06d,%s,%d\n" % (i, b"abc" * (i % 5), i * 7 % 13)
                        for i in range(8000))
    elif kind == "bytes":
        data = rng.bytes(150_000)
    elif kind == "short":
        data = bytes(rng.choice(list(b"abcdefgh"), 1600))
    else:
        data = _content(kind, (40_001,), "float32", rng).tobytes()
    out = np.empty(len(data), np.uint8)
    for opts in ({}, {"write_checksum": True}, {"write_content_size": False}):
        comp = zstandard.ZstdCompressor(level=level, **opts).compress(data)
        assert hostlib.zstd_decompress_into(comp, out).tobytes() == data
    half = zstandard.ZstdCompressor(level=level).compress(data[:1000])
    skip = struct.pack("<II", 0x184D2A5A, 3) + b"xyz"
    two = np.empty(2000, np.uint8)
    assert hostlib.zstd_decompress_into(skip + half + half, two).tobytes() == data[:1000] * 2
    with pytest.raises(ValueError, match="truncated|corrupt"):
        hostlib.zstd_decompress_into(comp[:len(comp) // 2], out)


def test_zstd_streamed_blocks():
    """A streamed frame of many 128 KiB blocks, treeless literals and
    repeated tables included (zstandard's stream writer at level 3)."""
    data = _content("smooth", (1_000_000,), "float32", np.random.RandomState(0)).tobytes()
    c = zstandard.ZstdCompressor(level=3).compressobj()
    comp = c.compress(data[:2_000_000]) + c.compress(data[2_000_000:]) + c.flush()
    out = np.empty(len(data), np.uint8)
    assert hostlib.zstd_decompress_into(comp, out).tobytes() == data


def _zstd_frame(blocks, size: int) -> bytes:
    """A single-segment zstd frame of ``size`` bytes: (type, content) blocks."""
    out = struct.pack("<IBI", 0xFD2FB528, 0xA0, size)   # 4-byte content size
    for i, (kind, body) in enumerate(blocks):
        n = body[1] if kind == 1 else len(body)
        out += (int(i == len(blocks) - 1) | kind << 1 | n << 3).to_bytes(3, "little")
        out += body[:1] if kind == 1 else body
    return out


def test_zstd_hand_built_blocks():
    """Blocks zstandard does not write here, built by the format: a raw
    block, an RLE block, RLE literals, and Huffman literals in one stream
    whose tree is given as direct 4-bit weights (symbols 'a' 'b' 'c' and the
    implied 'd': codes 01, 000, 001, 1)."""
    frame = _zstd_frame([(0, b"raw!"), (1, bytes([ord("z"), 5]))], 9)
    assert hostlib.zstd_decompress_into(frame, np.empty(9, np.uint8)).tobytes() == b"raw!zzzzz"
    rle_lit = bytes([1 | 20 << 3, ord("q"), 0])          # 20 literals 'q', no sequences
    frame = _zstd_frame([(2, rle_lit)], 20)
    assert hostlib.zstd_decompress_into(frame, np.empty(20, np.uint8)).tobytes() == b"q" * 20
    weights = [0] * 100
    weights[97:100] = [2, 1, 1]                          # 'a' 2 bits, 'b' 'c' 3, 'd' 1
    tree = bytes([127 + 100]) + bytes(weights[i] << 4 | weights[i + 1] for i in range(0, 100, 2))
    codes = {"a": "01", "b": "000", "c": "001", "d": "1"}
    text = "abcdddadcbaddda" * 7
    bits = "".join(codes[ch] for ch in text)
    stream = ((1 << len(bits)) | int(bits, 2)).to_bytes(len(bits) // 8 + 1, "little")
    comp = len(tree) + len(stream)
    head = (2 | len(text) << 4 | comp << 14).to_bytes(3, "little")   # 1 stream, 10-bit sizes
    frame = _zstd_frame([(2, head + tree + stream + b"\0")], len(text))
    out = np.empty(len(text), np.uint8)
    assert hostlib.zstd_decompress_into(frame, out).tobytes() == text.encode()
    co = zstandard.ZstdCompressor(level=3).compressobj()
    zeros = co.compress(bytes(300_000)) + co.flush()      # RLE blocks after the first
    assert hostlib.zstd_decompress_into(zeros, np.empty(300_000, np.uint8)).tobytes() == bytes(300_000)


# ------------------------------------------------------------------ blosc

@pytest.mark.parametrize("dtype", ["float32", "uint8"])
@pytest.mark.parametrize("clevel", [1, 3, 9])
@pytest.mark.parametrize("shuffle", ["bitshuffle", "shuffle", "noshuffle"])
@pytest.mark.parametrize("kind", ["noise", "smooth", "constant"])
def test_blosc_tensorstore_store_read_by_port(tmp_path, dtype, clevel, shuffle, kind):
    """A (3, 2, 37, 45) array in (3, 1, 16, 24) chunks (edge chunks
    partial; 1152 elements a chunk) written by tensorstore with blosc-zstd:
    the port's reads equal tensorstore's, whole and windowed."""
    rng = np.random.RandomState(clevel)
    a = _content(kind, (3, 2, 37, 45), dtype, rng)
    arr = _ts_array(tmp_path / "a", a.shape, (3, 1, 16, 24), dtype,
                    [BYTES, _blosc(clevel=clevel, shuffle=shuffle, typesize=a.itemsize)])
    arr.write(a).result()
    mine = ZarrArray(tmp_path / "a")
    np.testing.assert_array_equal(mine[:], np.asarray(arr[:]))
    np.testing.assert_array_equal(mine[:, 1, 5:33, 20:44], a[:, 1, 5:33, 20:44])


@pytest.mark.parametrize("shape, dtype", [((3, 1, 512, 640), "float32"),
                                          ((1, 512, 640), "uint8"),
                                          ((3, 1, 5, 7), "float32"),
                                          ((1, 13, 17), "uint8"),
                                          ((1, 1000, 37), "float32")],
                         ids=["f32-512x640", "u8-512x640", "f32-105", "u8-221",
                              "f32-leftover"])
def test_blosc_whole_chunks(tmp_path, shape, dtype):
    """Single chunks: a flagship image chunk (3.9 MB, 30 blosc blocks, each
    several zstd blocks), a mask chunk (a leftover block), 105 and 221
    elements (not a multiple of 8: c-blosc stores the block unshuffled) and
    a leftover block of 4232 elements, each as tensorstore wrote it."""
    rng = np.random.RandomState(1)
    a = np.round(rng.rand(*shape) * 255).astype(dtype)
    if dtype == "float32":
        a /= 255
    arr = _ts_array(tmp_path / "a", shape, shape, dtype,
                    [BYTES, _blosc(typesize=a.itemsize)])
    arr.write(a).result()
    out = np.empty(a.nbytes, np.uint8)
    hostlib.blosc_decompress_into(_chunk_file(tmp_path / "a" / "c").read_bytes(), out)
    assert out.tobytes() == a.tobytes()


def test_blosc_decodes_on_many_threads(tmp_path):
    """The decoders keep no state between calls and release the GIL: 16
    threads decoding the flagship-size chunk at once all get its bytes."""
    from concurrent.futures import ThreadPoolExecutor

    a = np.round(np.random.RandomState(3).rand(3, 1, 128, 160) * 255).astype(np.float32) / 255
    arr = _ts_array(tmp_path / "a", a.shape, a.shape, "float32", [BYTES, _blosc()])
    arr.write(a).result()
    chunk = _chunk_file(tmp_path / "a" / "c").read_bytes()

    def decode(_):
        return hostlib.blosc_decompress_into(chunk, np.empty(a.nbytes, np.uint8)).tobytes()

    with ThreadPoolExecutor(16) as pool:
        outs = list(pool.map(decode, range(64), timeout=60))
    assert all(o == a.tobytes() for o in outs)


def _blosc_frame(data: bytes, typesize: int, blocksize: int, flags: int,
                 split: bool, raw_streams=False) -> bytes:
    """A c-blosc 1.x chunk built by the format: byte shuffle (flag 0x01)
    done here, each block's streams zstd frames (or stored raw)."""
    nbytes = len(data)
    starts, body = [], b""
    nblocks = -(-nbytes // blocksize)
    head = 16 + 4 * nblocks
    for b in range(nblocks):
        block = data[b * blocksize:(b + 1) * blocksize]
        last = len(block) < blocksize
        if flags & 0x01:
            n = len(block) // typesize
            arr = np.frombuffer(block[:n * typesize], np.uint8).reshape(n, typesize)
            block = arr.T.tobytes() + block[n * typesize:]
        nsplit = typesize if split and not last else 1
        starts.append(head + len(body))
        size = len(block) // nsplit
        for j in range(nsplit):
            part = block[j * size:(j + 1) * size]
            comp = part if raw_streams else zstandard.ZstdCompressor(level=3).compress(part)
            body += struct.pack("<I", len(comp)) + comp
    flags |= (4 << 5) | (0 if split else 0x10)
    hdr = struct.pack("<BBBBIII", 2, 1, flags, typesize, nbytes, blocksize,
                      head + len(body))
    return hdr + struct.pack(f"<{nblocks}I", *starts) + body


@pytest.mark.parametrize("split, shuffle, raw", [(True, True, False), (True, False, True),
                                                 (False, True, False)],
                         ids=["split-shuffle", "split-raw", "nosplit-shuffle"])
def test_blosc_split_and_raw_streams(split, shuffle, raw):
    """Split streams (one per byte of a 4-byte element, the leftover block
    unsplit), streams stored raw, byte shuffle with a tail, and the
    memcpyed flag, in chunks built by the format."""
    data = np.round(np.random.RandomState(2).rand(10_001) * 255).astype(np.float32).tobytes()
    data += b"xyz"   # a block tail past the last whole element
    chunk = _blosc_frame(data, 4, 8192, 0x01 if shuffle else 0, split, raw)
    out = np.empty(len(data), np.uint8)
    assert hostlib.blosc_decompress_into(chunk, out).tobytes() == data
    memcpyed = struct.pack("<BBBBIII", 2, 1, 0x02 | (4 << 5), 4, len(data), len(data),
                           16 + len(data)) + data
    assert hostlib.blosc_decompress_into(memcpyed, out).tobytes() == data


# ---------------------------------------------------- JAX-written stores

@pytest.mark.parametrize("name", sorted(RECORDS["stores"]))
def test_fixture_store_read_by_port(name):
    """The committed stores written by JAX's ``VideoStore`` (the small ones
    and the two of one (3, 1, 512, 640) chunk): the port's arrays equal
    JAX's reads and the recorded sha256, windows too; the class locations
    are JAX's."""
    from mmr_tpu.data.zarr_io import VideoStore as JaxStore

    rec = RECORDS["stores"][name]
    path = FIXTURES / "blosc" / f"{name}.zarr"
    mine, theirs = VideoStore(path), JaxStore(path)
    img, mask = mine.read_frames(0, mine.shape[0])
    assert _sha(mine.image[:]) == _sha(np.asarray(theirs.image[:])) == rec["image"]
    assert _sha(mask) == _sha(np.asarray(theirs.mask[:])) == rec["mask"]
    assert img.dtype == np.dtype(rec["dtype"]) and list(mine.shape) == rec["shape"]
    assert mine.class_locations == theirs.class_locations
    for window in ((0, -9, -13, 64, 48), (mine.shape[0] - 1, 40, 70, 64, 64)):
        for x, y in zip(mine.read_windows_async(*window)(),
                        theirs.read_windows_async(*window)()):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("kind", ["f32", "u8"])
def test_fixture_sampler_matches_jax(kind):
    """The port's ``PatchSampler`` over the JAX-written blosc stores: each
    batch equals JAX's batch, and the recorded sha256."""
    from mmr_tpu.data.patch_dataset import PatchSampler as JaxSampler

    s = RECORDS["sampler"]
    paths = [FIXTURES / "blosc" / f"{kind}_{ab}.zarr" for ab in "ab"]
    kw = dict(oversample_foreground_percent=s["oversample_foreground_percent"],
              initial_patch_size=tuple(s["initial_patch_size"]), seed=s["seed"])
    mine = PatchSampler(paths, tuple(s["patch"]), s["batch"], s["steps"], **kw)
    theirs = JaxSampler(paths, tuple(s["patch"]), s["batch"], s["steps"], **kw)
    got = list(mine.epoch(epoch_seed=s["epoch_seed"]))
    want = list(theirs.epoch(epoch_seed=s["epoch_seed"], num_workers=1))
    assert [[_sha(i), _sha(m)] for i, m in got] == s["batches"][kind]
    for (gi, gm), (wi, wm) in zip(got, want):
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gm, wm)


def test_jax_video_store_read_by_port(tmp_path):
    """A store JAX's ``VideoStore`` writes now (float32, 100×130 frames in
    64×64 chunks, a frame unwritten): the port reads it bit-equal."""
    from mmr_tpu.data.zarr_io import VideoStore as JaxStore

    rng = np.random.RandomState(3)
    s = JaxStore.create(tmp_path / "v.zarr", 3, 100, 130, (64, 64))
    for i in (0, 2):
        s.write_frame(i, np.round(rng.rand(3, 100, 130) * 255).astype(np.float32) / 255,
                      rng.randint(0, 4, (100, 130)).astype(np.uint8))
    mine = VideoStore(tmp_path / "v.zarr")
    np.testing.assert_array_equal(mine.image[:], np.asarray(s.image[:]))
    np.testing.assert_array_equal(mine.mask[:], np.asarray(s.mask[:]))


# ------------------------------------------------------------------- JPEG

def _pil(data: bytes) -> np.ndarray:
    a = np.array(Image.open(io.BytesIO(data)))
    return a[..., None] if a.ndim == 2 else a


def _pil_jpeg(img, **kw) -> bytes:
    b = io.BytesIO()
    Image.fromarray(img).save(b, "JPEG", **kw)
    return b.getvalue()


def _scene(rng, h, w, t=0):
    y, x = np.mgrid[:h, :w] / np.float32(max(h, w))
    img = np.stack([150 + 60 * np.sin(6 * x + 2 * y + t), 70 + 40 * np.sin(5 * y - 3 * x),
                    60 + 30 * np.cos(9 * x * y + t)], -1)
    img += rng.normal(0, 3.0, img.shape)
    return np.clip(np.rint(img), 0, 255).astype(np.uint8)


def _strip_dht(data: bytes) -> bytes:
    """The JPEG without its DHT segments (an AVI1 Motion-JPEG frame)."""
    out, p = data[:2], 2
    while True:
        m, n = data[p + 1], struct.unpack(">H", data[p + 2:p + 4])[0]
        if m == 0xDA:
            return out + data[p:]
        if m != 0xC4:
            out += data[p:p + 2 + n]
        p += 2 + n


def test_jpeg_decode_equals_pil():
    """Every frame kind decodes sample for sample as PIL's libjpeg-turbo:
    4:4:4, 4:2:2 and 4:2:0 at qualities 30-95 with standard and optimized
    tables, odd sizes (MCUs past the right and bottom edges, chroma at most
    2 samples wide), grey, RGB components (an Adobe marker, transform 0),
    a frame relabelled SOF1 (extended Huffman), restart markers every 3
    MCUs, 4:2:2 from cv2, and frames with their DHT removed (Annex K
    tables)."""
    rng = np.random.RandomState(4)
    cases = []
    for h, w in ((48, 64), (37, 53), (2, 3), (17, 5), (135, 270)):
        for kind in ("noise", "scene"):
            img = (rng.randint(0, 256, (h, w, 3)).astype(np.uint8) if kind == "noise"
                   else _scene(rng, h, w))
            for sub in (0, 1, 2):
                cases += [_pil_jpeg(img, quality=q, subsampling=sub) for q in (30, 95)]
                cases.append(_strip_dht(_pil_jpeg(img, quality=75, subsampling=sub)))
            if h > 2:
                cases.append(_pil_jpeg(img, quality=80, subsampling=2, optimize=True))
            cases.append(_pil_jpeg(img[..., 0], quality=80))
            cases.append(_pil_jpeg(img, quality=90, keep_rgb=True))
            cases.append(cases[0].replace(b"\xff\xc0", b"\xff\xc1", 1))
            cases.append(cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_RST_INTERVAL, 3])[1].tobytes())
            cases.append(cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                                    cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422]
                                      )[1].tobytes())
    assert any(b"\xff\xdd" in c for c in cases)
    for data in cases:
        np.testing.assert_array_equal(hostlib.jpeg_decode(data), _pil(data))


_ZZ = np.array([0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40,
                48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36,
                29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61,
                54, 47, 55, 62, 63])


class _Bits:
    """An entropy-coded segment: bits MSB first, 0xFF stuffed, 1-padded."""

    def __init__(self):
        self.out, self.acc, self.n = bytearray(), 0, 0

    def put(self, value: int, n: int):
        self.acc, self.n = (self.acc << n) | (value & ((1 << n) - 1)), self.n + n
        while self.n >= 8:
            self.n -= 8
            byte = (self.acc >> self.n) & 0xFF
            self.out += bytes([byte, 0] if byte == 0xFF else [byte])

    def flush(self) -> bytes:
        if self.n:
            self.put((1 << (8 - self.n)) - 1, 8 - self.n)
        return bytes(self.out)


def _seg(marker: int, body: bytes) -> bytes:
    return struct.pack(">BBH", 0xFF, marker, len(body) + 2) + body


def _jpeg_from_coefficients(coefs, sampling, size, restart=0) -> bytes:
    """A baseline JPEG built here from quantized coefficient blocks: one
    non-interleaved scan a component, each preceded by a DHT that redefines
    slots 0 (a new code order each scan) and a DQT that redefines the
    component's table; DC codes 4 bits, AC codes 8 bits."""
    h, w = size
    out = b"\xff\xd8" + _seg(0xDB, bytes([0]) + bytes(range(1, 65)))
    comps = b"".join(bytes([i + 1, hh << 4 | vv, i]) for i, (hh, vv) in enumerate(sampling))
    out += _seg(0xC0, struct.pack(">BHHB", 8, h, w, len(sampling)) + comps)
    if restart:
        out += _seg(0xDD, struct.pack(">H", restart))
    ac_syms = [0x00, 0xF0] + [r << 4 | z for r in range(16) for z in range(1, 11)]
    for c, blocks in enumerate(coefs):
        q = np.arange(64, 0, -1) % 16 + 1 if c % 2 else np.full(64, 2 + c)
        out += _seg(0xDB, bytes([c]) + bytes(q[_ZZ].astype(np.uint8)))
        dc_vals = list(range(12))[::-1] if c == 1 else list(range(12))
        ac_vals = ac_syms[c:] + ac_syms[:c]
        out += _seg(0xC4, bytes([0x00]) + bytes([0, 0, 0, 12] + [0] * 12) + bytes(dc_vals)
                    + bytes([0x10]) + bytes([0] * 7 + [162] + [0] * 8) + bytes(ac_vals))
        out += _seg(0xDA, bytes([1, c + 1, 0x00, 0, 63, 0]))
        dc_code = {v: i for i, v in enumerate(dc_vals)}
        ac_code = {v: i for i, v in enumerate(ac_vals)}
        bits, pred, mcus = _Bits(), 0, blocks.reshape(-1, 64)
        for m, blk in enumerate(mcus):
            if restart and m and m % restart == 0:
                out_bytes = bits.flush()
                out += out_bytes + bytes([0xFF, 0xD0 + (m // restart - 1) % 8])
                bits, pred = _Bits(), 0
            zz = blk[_ZZ]
            diff, pred = int(zz[0]) - pred, int(zz[0])
            n = abs(diff).bit_length()
            bits.put(dc_code[n], 4)
            bits.put(diff if diff >= 0 else diff + (1 << n) - 1, n)
            run, last = 0, max([k for k in range(1, 64) if zz[k]], default=0)
            for k in range(1, last + 1):
                if not zz[k]:
                    run += 1
                    continue
                while run > 15:
                    bits.put(ac_code[0xF0], 8)
                    run -= 16
                n = abs(int(zz[k])).bit_length()
                bits.put(ac_code[run << 4 | n], 8)
                bits.put(int(zz[k]) if zz[k] > 0 else int(zz[k]) + (1 << n) - 1, n)
                run = 0
            if last < 63:
                bits.put(ac_code[0x00], 8)
        out += bits.flush()
    return out + b"\xff\xd9"


@pytest.mark.parametrize("size, sampling, restart", [
    ((37, 53), ((2, 2), (1, 1), (1, 1)), 0),
    ((40, 48), ((2, 1), (1, 1), (1, 1)), 5),
    ((17, 9), ((1, 1), (1, 1), (1, 1)), 2),
], ids=["420", "422-restart", "444-restart"])
def test_jpeg_non_interleaved_scans_equal_pil(size, sampling, restart):
    """JPEGs of one scan a component (blocks cover each component's own
    size, not the MCU grid's), Huffman and quantization tables redefined
    between the scans, restart intervals inside them: decoded as PIL
    decodes them. The coefficients keep every sample within a few hundred
    levels of the range, as an encoder's from 8-bit samples do; far larger
    ones decode otherwise in PIL's libjpeg-turbo build than in libjpeg's C
    range-limit table, which this decoder follows."""
    rng = np.random.RandomState(9)
    h, w = size
    hmax, vmax = max(s[0] for s in sampling), max(s[1] for s in sampling)
    coefs = []
    for hh, vv in sampling:
        bh = -(-(-(-h * vv // vmax)) // 8)
        bw = -(-(-(-w * hh // hmax)) // 8)
        blk = np.zeros((bh * bw, 64), np.int64)
        blk[:, 0] = rng.randint(-40, 41, bh * bw)
        nz = rng.rand(bh * bw, 63) < 0.2
        blk[:, 1:] = np.where(nz, rng.randint(-5, 6, (bh * bw, 63)), 0)
        coefs.append(blk)
    data = _jpeg_from_coefficients(coefs, sampling, size, restart)
    np.testing.assert_array_equal(hostlib.jpeg_decode(data), _pil(data))


def test_fixture_mjpeg_frames():
    """The committed 1080×1920 cv2 Motion-JPEG (4:2:0, 1080 rows: the last
    MCU row half outside the frame): each frame equals PIL's decode and the
    recorded sha256; a frame past the end is None."""
    rec = RECORDS["avi"]
    with VideoReader(FIXTURES / rec["file"]) as v:
        assert (v.height, v.width, v.fourcc, v.frame_count) == (1080, 1920, "MJPG", 3)
        for t, want in enumerate(rec["frames"]):
            frame = v.read(t)
            assert frame.shape == tuple(rec["shape"]) and _sha(frame) == want
            np.testing.assert_array_equal(frame, _pil(v.frame_bytes(t)))
        assert v.read(3) is None and v.read(-1) is None


# -------------------------------------------------------------------- AVI

def _ck(fcc: bytes, data: bytes) -> bytes:
    return fcc + struct.pack("<I", len(data)) + data + (b"\0" if len(data) & 1 else b"")


def _lst(kind: bytes, *parts: bytes) -> bytes:
    body = kind + b"".join(parts)
    return b"LIST" + struct.pack("<I", len(body)) + body


def _hdrl(n, w, h, fourcc, indx=b"", audio=False):
    """The header list; with ``audio``, a PCM stream 0 before the video."""
    avih = struct.pack("<14I", 200000, 0, 0, 0x10, n, 0, 1 + audio, 0, w, h, 0, 0, 0, 0)
    strh = struct.pack("<4s4sIHHIIIIIIIIhhhh", b"vids", fourcc, 0, 0, 0, 0, 1, 5, 0, n,
                       0, 0, 0, 0, 0, w, h)
    strf = struct.pack("<Iiihh4sIiiII", 40, w, h, 1, 24, fourcc, w * h * 3, 0, 0, 0, 0)
    auds = _lst(b"strl", _ck(b"strh", struct.pack("<4s4sIHHIIIIIIIIhhhh", b"auds", b"\0" * 4,
                                                 0, 0, 0, 0, 1, 8000, 0, 800, 0, 0, 2,
                                                 0, 0, 0, 0)),
                _ck(b"strf", struct.pack("<HHIIHH", 1, 1, 8000, 16000, 2, 16)))
    return _lst(b"hdrl", _ck(b"avih", avih), auds if audio else b"",
                _lst(b"strl", _ck(b"strh", strh), _ck(b"strf", strf), indx))


def _avi(frames, w, h, fourcc=b"MJPG", index=True, absolute=False, audio=False,
         rec=False) -> bytes:
    """An AVI with an ``idx1`` index, its offsets from ``movi`` (or from the
    file's start, ``absolute``); with ``audio``, a PCM stream 0 whose chunks
    come between the frames (the video is stream 1); with ``rec``, each
    frame in a ``rec `` list."""
    vid = b"01dc" if audio else b"00dc"
    head = b"AVI " + _hdrl(len(frames), w, h, fourcc, audio=audio)
    base = 8 + len(head) + 8 if absolute else 0   # the 'movi' fourcc's offset
    movi, idx = b"", b""
    for f in frames:
        if audio:
            idx += struct.pack("<4sIII", b"00wb", 0, base + 4 + len(movi), 6)
            movi += _ck(b"00wb", b"\1\2" * 3)
        c = _ck(vid, f)
        if rec:
            movi += b"LIST" + struct.pack("<I", 4 + len(c)) + b"rec "
        idx += struct.pack("<4sIII", vid, 0x10, base + 4 + len(movi), len(f))
        movi += c
    body = head + _lst(b"movi", movi)
    if index:
        body += _ck(b"idx1", idx)
    return b"RIFF" + struct.pack("<I", len(body)) + body


def _odml_avi(frames, w, h) -> bytes:
    """An OpenDML AVI: the first half of the frames in the ``AVI `` RIFF,
    the rest in an ``AVIX`` RIFF, each RIFF's frames indexed by an
    ``ix00`` chunk after its ``movi`` list, both named by the stream's
    ``indx`` super index; no ``idx1``."""
    halves = [frames[:len(frames) // 2], frames[len(frames) // 2:]]
    indx_size = 24 + 16 * 2
    head = b"RIFF" + b"\0" * 4 + b"AVI "
    hdrl_len = len(_hdrl(len(frames), w, h, b"MJPG", _ck(b"indx", b"\0" * indx_size)))
    out = bytearray()
    entries, riff_starts = [], []
    pos = len(head) + hdrl_len
    for k, half in enumerate(halves):
        riff = b"" if k == 0 else b"RIFF" + b"\0" * 4 + b"AVIX"
        base = pos + len(riff) + 12          # the movi list's first chunk header
        movi, offs, p = b"", [], base
        for f in half:
            offs.append((p + 8 - base, len(f)))
            c = _ck(b"00dc", f)
            movi += c
            p += len(c)
        ix = struct.pack("<HBBI4sQI", 2, 0, 1, len(half), b"00dc", base, 0)
        ix += b"".join(struct.pack("<II", o, s) for o, s in offs)
        part = riff + _lst(b"movi", movi)
        entries.append((pos + len(part), 8 + len(ix), len(half)))
        part += _ck(b"ix00", ix)
        riff_starts.append(pos)
        out += part
        pos += len(part)
    indx = struct.pack("<HBBI4s3I", 4, 0, 0, 2, b"00dc", 0, 0, 0)
    indx += b"".join(struct.pack("<QII", *e) for e in entries)
    data = bytearray(head + _hdrl(len(frames), w, h, b"MJPG", _ck(b"indx", indx)) + out)
    first_end = riff_starts[1]
    data[4:8] = struct.pack("<I", first_end - 8)
    data[first_end + 4:first_end + 8] = struct.pack("<I", len(data) - first_end - 8)
    return bytes(data)


def test_avi_indexes_and_fourccs(tmp_path):
    """PIL's 4:4:4 and 4:2:2 JPEGs wrapped here in AVIs read the same
    through ``idx1`` (offsets from ``movi`` or from the file's start), a
    ``movi`` walk (``rec `` lists included) and OpenDML indexes (cv2 reads
    the OpenDML file's frames as it reads the ``idx1`` file's), with an
    audio stream before the video's; every JPEG fourcc is taken; a
    zero-byte chunk repeats the frame before it."""
    rng = np.random.RandomState(5)
    jpegs = [_pil_jpeg(_scene(rng, 48, 64, t), quality=90, subsampling=[0, 1][t % 2])
             for t in range(5)]
    want = [_pil(j) for j in jpegs]
    files = {"idx1": _avi(jpegs, 64, 48), "walk": _avi(jpegs, 64, 48, index=False),
             "odml": _odml_avi(jpegs, 64, 48),
             "absolute": _avi(jpegs, 64, 48, absolute=True),
             "audio": _avi(jpegs, 64, 48, audio=True),
             "audio-walk": _avi(jpegs, 64, 48, audio=True, index=False),
             "rec-walk": _avi(jpegs, 64, 48, rec=True, index=False)}
    for fcc in ("mjpg", "AVRn", "AVDJ"):
        files[fcc] = _avi(jpegs, 64, 48, fourcc=fcc.encode())
    for name, data in files.items():
        (tmp_path / f"{name}.avi").write_bytes(data)
        with VideoReader(tmp_path / f"{name}.avi") as v:
            assert v.frame_count == 5 and (v.width, v.height) == (64, 48), name
            for t in range(5):
                np.testing.assert_array_equal(v.read(t), want[t])
    cv = {}
    for name in ("idx1", "odml"):
        cap = cv2.VideoCapture(str(tmp_path / f"{name}.avi"))
        cv[name] = [cap.read()[1] for _ in range(5)]
        assert all(f is not None for f in cv[name]) and not cap.read()[0]
    for a, b in zip(cv["idx1"], cv["odml"]):
        np.testing.assert_array_equal(a, b)
    (tmp_path / "gap.avi").write_bytes(_avi([jpegs[0], b"", jpegs[2]], 64, 48))
    with VideoReader(tmp_path / "gap.avi") as v:
        np.testing.assert_array_equal(v.read(1), want[0])
        np.testing.assert_array_equal(v.read(2), want[2])


def _edge_frames(n=3, h=48, w=64):
    """JAX's converter-test frames (``tests/test_convert.py:26-27``), BGR:
    grey levels with a blue block."""
    frames = []
    for t in range(n):
        f = np.full((h, w, 3), t * 20 % 255, np.uint8)
        f[10:20, 10:30] = (255, 0, 0)
        frames.append(f)
    return frames


def test_cv2_gap(tmp_path):
    """cv2 reads Motion-JPEG through FFmpeg. Against it, on smooth frames
    with noise, JAX's converter-test frames (sharp colour edges) and the
    full-HD fixture: the port's OpenCV-style decode (repeated chroma, what
    the converters store) stays within the converter's bound on every kind;
    its libjpeg decode (the default) within each kind's measured gap, up to
    79 levels at the edges, where the triangular filter blends the chroma."""
    rng = np.random.RandomState(6)
    kinds = {"smooth": [_scene(rng, 48, 64, t)[..., ::-1] for t in range(3)],
             "edges": _edge_frames()}
    paths = {"fixture": FIXTURES / RECORDS["avi"]["file"]}
    for kind, frames in kinds.items():
        paths[kind] = tmp_path / f"{kind}.avi"
        w = cv2.VideoWriter(str(paths[kind]), cv2.VideoWriter_fourcc(*"MJPG"), 5, (64, 48))
        for f in frames:
            w.write(f)
        w.release()
    for kind, path in paths.items():
        for fancy, (mean, peak) in ((False, (CV2_MEAN, CV2_MAX)), (True, LIBJPEG_GAP[kind])):
            cap = cv2.VideoCapture(str(path))
            with VideoReader(path, fancy_upsampling=fancy) as v:
                for t in range(3):
                    d = np.abs(v.read(t).astype(int) - cap.read()[1][..., ::-1])
                    assert d.mean() <= mean and d.max() <= peak, (kind, fancy, t, d.mean(),
                                                                  d.max())


# ------------------------------------------------------------- conversion

def _video_frames(rng, n, h, w):
    return [_scene(rng, h, w, t) for t in range(n)]


def _mask(rng, h, w, t):
    m = np.zeros((h, w), np.uint8)
    m[10 + t:30 + t, 5:60] = 1
    m[h // 2:h // 2 + 25, 70:120] = 2
    m[5:12, 100 + t:110 + t] = 3
    return m


def _write_video_dir(vdir, rng, n=6, h=90, w=128, annotated=(0, 2, 5, 8)):
    """``video_left.avi`` (cv2 MJPG, RGB frames stored as BGR) and
    ``segmentation/<frame>.png``; frame 8 is past the video's end."""
    seg = vdir / "segmentation"
    seg.mkdir(parents=True)
    writer = cv2.VideoWriter(str(vdir / "video_left.avi"),
                             cv2.VideoWriter_fourcc(*"MJPG"), 5, (w, h))
    for f in _video_frames(rng, n, h, w):
        writer.write(f[..., ::-1])
    writer.release()
    for t in annotated:
        cv2.imwrite(str(seg / f"{t:09d}.png"), _mask(rng, h, w, t))


def _zip_dir(vdir) -> bytes:
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w") as zf:
        for f in sorted(vdir.rglob("*")):
            if f.is_file():
                zf.write(f, str(f.relative_to(vdir)))
    return buf.getvalue()


@pytest.fixture(scope="module")
def raw_videos(tmp_path_factory):
    """Three video folders, the nested ZIP of their ZIPs, the same with a
    fourth that holds an mp4v video, and the flat ZIP of the first."""
    root = tmp_path_factory.mktemp("raw")
    rng = np.random.RandomState(7)
    for v in range(3):
        _write_video_dir(root / "dirs" / f"video_{v:02d}", rng)
    bad = root / "bad"
    (bad / "segmentation").mkdir(parents=True)
    w = cv2.VideoWriter(str(bad / "video_left.avi"), cv2.VideoWriter_fourcc(*"mp4v"), 5,
                        (64, 48))
    for _ in range(2):
        w.write(np.zeros((48, 64, 3), np.uint8))
    w.release()
    cv2.imwrite(str(bad / "segmentation" / "000000000.png"), np.ones((48, 64), np.uint8))
    for name in ("nested.zip", "with_mp4v.zip"):
        with zipfile.ZipFile(root / name, "w") as zf:
            for v in range(3):
                zf.writestr(f"video_{v:02d}.zip", _zip_dir(root / "dirs" / f"video_{v:02d}"))
            if name == "with_mp4v.zip":
                zf.writestr("video_03.zip", _zip_dir(bad))
    (root / "flat.zip").write_bytes(_zip_dir(root / "dirs" / "video_00"))
    return root


def _same_dataset(mine: Path, theirs: Path):
    from mmr_tpu.data.zarr_io import VideoStore as JaxStore

    names = sorted(p.name for p in (theirs / "data").glob("*.zarr"))
    assert names and names == sorted(p.name for p in (mine / "data").glob("*.zarr"))
    for name in names:
        a, b = VideoStore(mine / "data" / name), JaxStore(theirs / "data" / name)
        assert a.shape == b.shape and a.image_dtype == b.image_dtype
        assert a.class_locations == b.class_locations
        np.testing.assert_array_equal(a.mask[:], np.asarray(b.mask[:]))
        ia, ib = a.image[:], np.asarray(b.image[:])
        scale = 1.0 if a.image_dtype == np.uint8 else 255.0
        d = np.abs(ia.astype(np.float64) - ib) * scale
        assert d.mean() <= CV2_MEAN and d.max() <= CV2_MAX + 1e-3, (name, d.mean(), d.max())
    for f in ("train_val_test_split.json",):
        assert (mine / f).exists() == (theirs / f).exists()
        if (mine / f).exists():
            assert (mine / f).read_bytes() == (theirs / f).read_bytes()


@pytest.mark.parametrize("source, kw", [
    ("nested.zip", {"write_split": True}),
    ("nested.zip", {"n_videos": 2, "image_dtype": np.uint8}),
    ("flat.zip", {}),
    ("dirs", {"write_split": True, "seed": 3}),
], ids=["nested", "nested-n2-u8", "flat", "folder"])
def test_convert_zip_dataset_matches_jax(tmp_path, raw_videos, source, kw):
    """The port's converter and JAX's over the same sources: the same
    stores (frame 8, past each video's end, warned about and left
    unwritten), masks, class locations and split files exactly equal,
    frames within the bound of cv2's decode."""
    from mmr_tpu.data.convert import convert_zip_dataset as jax_convert

    mine = convert.convert_zip_dataset(raw_videos / source, tmp_path / "mine", 3,
                                       (64, 64), **kw)
    theirs = jax_convert(raw_videos / source, tmp_path / "theirs", 3, (64, 64), **kw)
    _same_dataset(mine, theirs)


@pytest.mark.parametrize("content", ["edges", "full_hd"])
def test_convert_content_matches_jax(tmp_path, content):
    """The converters on content away from the smooth frames: JAX's own
    converter-test video (a blue block on grey: sharp colour edges; 8
    frames, 3 annotated) and the committed 1080×1920 fixture (3 frames,
    masks of 9 classes; uint8 stores in 512×640 chunks), each as a nested
    ZIP. Masks, class locations and split files equal JAX's; frames within
    the converter's bound of cv2's decode (measured on these frames: mean
    0.33-0.64 / max 3, and 0.64-0.65 / 3-4)."""
    from mmr_tpu.data.convert import convert_zip_dataset as jax_convert
    from tests.test_convert import _make_video_zip

    if content == "edges":
        inner = _make_video_zip(tmp_path, "video_01.zip")
        args, kw = (2, (32, 32)), {"write_split": True}
    else:
        inner = tmp_path / "video_01.zip"
        rng = np.random.RandomState(16)
        with zipfile.ZipFile(inner, "w") as zf:
            zf.write(FIXTURES / RECORDS["avi"]["file"], "video_left.avi")
            for t in range(3):
                m = np.zeros((1080, 1920), np.uint8)
                for c in range(1, 10):
                    y, x = rng.randint(0, 1000), rng.randint(0, 1800)
                    m[y:y + 80, x:x + 120] = c
                zf.writestr(f"segmentation/{t:09d}.png", cv2.imencode(".png", m)[1].tobytes())
        args, kw = (9, (512, 640)), {"image_dtype": np.uint8}
    outer = tmp_path / "videos.zip"
    with zipfile.ZipFile(outer, "w") as zf:
        zf.write(inner, "video_01.zip")
    mine = convert.convert_zip_dataset(outer, tmp_path / "mine", *args, **kw)
    theirs = jax_convert(outer, tmp_path / "theirs", *args, **kw)
    _same_dataset(mine, theirs)


def test_extract_frames_dataset_matches_jax(tmp_path, raw_videos):
    """Path A's extraction: the same split of videos, the same file names
    (each video's 4 masks copied, 3 frames extracted: frame 8 is past the
    end), ground truth byte-equal, frames within the bound of cv2's
    decode."""
    from mmr_tpu.data.convert import extract_frames_dataset as jax_extract

    mine = convert.extract_frames_dataset(raw_videos / "dirs", tmp_path / "mine",
                                          val_fraction=0.34, seed=0)
    theirs = jax_extract(raw_videos / "dirs", tmp_path / "theirs", val_fraction=0.34, seed=0)
    files = sorted(str(p.relative_to(theirs)) for p in theirs.rglob("*.png"))
    assert len(files) == 21 and files == sorted(str(p.relative_to(mine))
                                                for p in mine.rglob("*.png"))
    for f in files:
        if "groundtruth" in f:
            assert (mine / f).read_bytes() == (theirs / f).read_bytes()
        else:
            d = np.abs(png.read(mine / f).astype(int) - png.read(theirs / f))
            assert d.mean() <= CV2_MEAN and d.max() <= CV2_MAX, (f, d.mean(), d.max())


def test_create_dataset_cli(tmp_path, raw_videos, capsys):
    """``mmr_torch_create_dataset`` end to end: "[H,W]" parsed, uint8
    stores, the split file; the mp4v video is skipped with its fourcc
    named (JAX's cv2 would convert it)."""
    from mmr_tpu_torch.cli.create_dataset import main

    assert main([str(raw_videos / "with_mp4v.zip"), str(tmp_path / "ds"), "3", "[64,64]",
                 "--image_dtype", "uint8", "--write_split"]) == 0
    out = capsys.readouterr().out
    assert "Skipping video_03.zip" in out and "fourcc 'mp4v'" in out
    stores = sorted((tmp_path / "ds" / "data").glob("*.zarr"))
    assert len(stores) == 3 and VideoStore(stores[0]).image_dtype == np.uint8
    assert json.loads((tmp_path / "ds" / "train_val_test_split.json").read_text())["val"]


# ---------------------------------------------------------------- refusals

def test_refusals_name_what_they_refuse(tmp_path):
    """Another fourcc (cv2's mp4v AVI), progressive, lossless,
    arithmetic-coded and 12-bit JPEG, a non-zstd blosc store and chunk
    (lz4, written by tensorstore), a zstd dictionary,
    a blosc header of another version: ``NotImplementedError`` naming each;
    a truncated chunk: ``ValueError`` naming its file; a write into a blosc
    array is refused."""
    w = cv2.VideoWriter(str(tmp_path / "m.avi"), cv2.VideoWriter_fourcc(*"mp4v"), 5, (64, 48))
    w.write(np.zeros((48, 64, 3), np.uint8))
    w.release()
    with pytest.raises(NotImplementedError, match="fourcc 'mp4v'"):
        VideoReader(tmp_path / "m.avi")
    img = np.random.RandomState(8).randint(0, 256, (32, 32, 3)).astype(np.uint8)
    with pytest.raises(NotImplementedError, match=r"progressive JPEG \(SOF2\)"):
        hostlib.jpeg_decode(_pil_jpeg(img, progressive=True))
    base = _pil_jpeg(img)
    sof = base.index(b"\xff\xc0")
    for marker, name in ((0xC3, r"lossless JPEG \(SOF3\)"),
                         (0xC9, r"arithmetic-coded sequential JPEG \(SOF9\)")):
        with pytest.raises(NotImplementedError, match=name):
            hostlib.jpeg_decode(base[:sof + 1] + bytes([marker]) + base[sof + 2:])
    with pytest.raises(NotImplementedError, match="12-bit JPEG"):
        hostlib.jpeg_decode(base[:sof + 4] + b"\x0c" + base[sof + 5:])
    a = np.arange(4096, dtype=np.float32).reshape(1, 64, 64)
    arr = _ts_array(tmp_path / "lz4", a.shape, a.shape, "float32", [BYTES, _blosc("lz4")])
    arr.write(a).result()
    with pytest.raises(NotImplementedError, match="blosc compressor 'lz4'"):
        ZarrArray(tmp_path / "lz4")
    lz4 = _chunk_file(tmp_path / "lz4" / "c").read_bytes()
    out = np.empty(a.nbytes, np.uint8)
    with pytest.raises(NotImplementedError, match="blosc compressor lz4"):
        hostlib.blosc_decompress_into(lz4, out)
    with pytest.raises(NotImplementedError, match="blosc header version 3"):
        hostlib.blosc_decompress_into(b"\x03" + lz4[1:], out)
    d = zstandard.train_dictionary(1024, [b"%d,record %d,abc" % (i, i * 7) for i in range(2000)])
    dict_frame = zstandard.ZstdCompressor(dict_data=d).compress(b"abc" * 99)
    with pytest.raises(NotImplementedError, match=f"zstd dictionary ID {d.dict_id()}"):
        hostlib.zstd_decompress_into(dict_frame, np.empty(297, np.uint8))
    b = _ts_array(tmp_path / "b", (1, 64, 64), (1, 64, 64), "float32", [BYTES, _blosc()])
    b.write(a).result()
    chunk = _chunk_file(tmp_path / "b" / "c")
    chunk.write_bytes(chunk.read_bytes()[:-20])
    with pytest.raises(ValueError, match=str(chunk)):
        ZarrArray(tmp_path / "b")[:]
    with pytest.raises(NotImplementedError, match="writing blosc"):
        ZarrArray(tmp_path / "b").write((0,), np.zeros((64, 64), np.float32))


def test_build_without_cc_raises(tmp_path, monkeypatch):
    """No compiler, no decoder: the build raises and names ``cc``."""
    monkeypatch.setattr(hostlib, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.delenv("CC", raising=False)
    monkeypatch.setattr(shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="cc"):
        hostlib.build()


def test_build_once_across_threads(tmp_path):
    """Threads that ask for a library at once build it once: the chunk pool's
    first reads wait for one build (``ops/_build.py::cached_build``, the policy
    of the CUDA and host libraries)."""
    import threading
    import time
    from concurrent.futures import ThreadPoolExecutor

    from mmr_tpu_torch.ops import _build

    src = tmp_path / "a.c"
    src.write_text("int a;")
    calls = []

    def compile(tmp, tmp_lib):
        calls.append(threading.get_ident())
        time.sleep(0.05)
        tmp_lib.write_bytes(b"lib")

    with ThreadPoolExecutor(6) as pool:
        libs = list(pool.map(lambda _: _build.cached_build(
            "libt", ("-O2",), [src], [], compile, tmp_path / "b"), range(6)))
    assert len(calls) == 1 and len(set(libs)) == 1 and libs[0].read_bytes() == b"lib"
    assert [p.name for p in (tmp_path / "b").iterdir()] == [libs[0].name]
