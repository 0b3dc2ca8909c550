"""The port's host codecs (``mmr_tpu_torch/csrc/host``, built by ``cc``
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
  blosc's other compressors (blosclz, lz4, lz4hc, snappy, zlib) under each
  shuffle, read equal to tensorstore, truncated and damaged streams refused;
- the port's encoders: zstd frames that ``zstandard`` and the port's
  decoder both read back exactly; blosc chunks with tensorstore's header
  (flags, typesize, block size) that tensorstore reads, at typesizes 1, 2,
  4 and 8, and under the array's shuffle; the committed arrays and a
  full-HD synthetic frame stored within 1.10× tensorstore's bytes, the
  masks within 1.40×;
- the committed JAX-written stores (``tests/torch_fixtures``) read by the
  port's ``VideoStore`` and ``PatchSampler`` bit-equal to JAX's reads and
  to the recorded sha256;
- JPEG frames decoded exactly as PIL (libjpeg-turbo) decodes them: cv2's
  Motion-JPEG at 48×64 and 1080×1920 (4:2:0), PIL's 4:4:4 and 4:2:2,
  restart markers, grey, frames without DHT (Annex K tables), odd sizes;
  progressive frames and 4:4:0 / 4:1:1 sampling from cv2, other whole
  ratios built here, quantization tables latched at each component's first
  scan; AVI through ``idx1``, a ``movi`` walk and a hand-built OpenDML file
  (``AVIX`` + ``indx`` / ``ix00``) that cv2 reads too; the converters'
  decode within a stated bound of cv2's at every layout;
- ``convert_zip_dataset`` (nested ZIP, flat ZIP, folder) and
  ``extract_frames_dataset`` against JAX's: masks, ``class_locations``,
  codecs and split files exactly equal, frames within a stated bound of
  cv2's decode;
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
MEMCPYED = 0x02   # the blosc flag of a chunk stored uncompressed
OTHER_STORES = RECORDS["other_compressors"]   # blosclz, lz4, lz4hc, snappy, zlib

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
# Since the converters' decode follows swscale's generic scaler where cv2's
# FFmpeg backend runs it (4:4:0, 4:1:1, 4:2:0 at odd heights: Keys' cubic
# chroma at ceil(W/2) x H), every layout measures within (mean, max)
# 0.08-0.74 / 2-4 of cv2 (4:4:0, 4:1:1 and progressive 4:2:2 fixtures,
# sharp edges at 4:4:0 and 4:1:1, 4:2:0 at 135 rows).
# libjpeg's decode (the default, PIL's samples: the triangular chroma
# filter) against cv2's, measured: smooth 0.94-1.32 / 5-7 (0.70-0.72 / 4-5
# at 135 rows), edges 1.12-1.67 / 79 (0.34-1.07 / 17-38 at 4:4:0 and
# 4:1:1), the 1080×1920 fixtures 0.67-0.72 / 21-38, the 240×320 tissue-like
# fixtures at 4:4:0 and 4:1:1 0.81-0.98 / 14-21; held per kind at
LIBJPEG_GAP = {"smooth": (1.5, 16), "edges": (2.0, 96), "fixture": (1.0, 48),
               "scene": (1.5, 32)}


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


@pytest.mark.parametrize("kind", ["noise", "smooth", "constant", "records", "bytes", "short",
                                  "empty", "one", "large"])
def test_zstd_encoder_read_by_zstandard(kind):
    """The port's zstd frames: ``zstandard`` and the port's decoder both
    give the input back exactly; float noise (raw or Huffman literals),
    smooth floats and text records (FSE sequences, repeat offsets), a
    constant (RLE), random bytes (raw blocks), a short text (one Huffman
    stream), empty and 1-byte input, and 600 kB (five blocks, matches that
    reach back across them)."""
    rng = np.random.RandomState(11)
    if kind == "records":
        data = b"".join(b"%06d,%s,%d\n" % (i, b"abc" * (i % 5), i * 7 % 13)
                        for i in range(8000))
    elif kind == "bytes":
        data = rng.bytes(150_000)
    elif kind == "short":
        data = bytes(rng.choice(list(b"abcdefgh"), 1600))
    elif kind in ("empty", "one"):
        data = b"x" if kind == "one" else b""
    elif kind == "large":
        data = _content("smooth", (150_000,), "float32", rng).tobytes()
    else:
        data = _content(kind, (40_001,), "float32", rng).tobytes()
    comp = hostlib.zstd_compress(data)
    assert zstandard.ZstdDecompressor().decompress(comp) == data
    out = np.empty(len(data), np.uint8)
    assert hostlib.zstd_decompress_into(comp, out).tobytes() == data
    if kind in ("smooth", "records", "large"):   # within 1.10x of libzstd's level 1
        assert len(comp) <= 1.10 * len(zstandard.ZstdCompressor(level=1).compress(data))


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
                                          ((1, 1000, 37), "float32"),
                                          ((1, 300, 37), "int16"),
                                          ((1, 250, 37), "float64")],
                         ids=["f32-512x640", "u8-512x640", "f32-105", "u8-221",
                              "f32-leftover", "i16", "f64"])
def test_blosc_whole_chunks(tmp_path, shape, dtype):
    """Single chunks: a flagship image chunk (3.9 MB, 30 blosc blocks, each
    several zstd blocks), a mask chunk (a leftover block), 105 and 221
    elements (not a multiple of 8: c-blosc stores the block unshuffled), a
    leftover block of 4232 elements, and typesizes 2 and 8, each as
    tensorstore wrote it: the port decodes it; the port's chunk of the same
    array has tensorstore's header (version, flags, typesize, nbytes,
    c-blosc's block size) but for cbytes and the memcpyed flag, which follow
    the compressed size, and tensorstore reads it in place of its own."""
    rng = np.random.RandomState(1)
    a = np.round(rng.rand(*shape) * 255).astype(dtype)
    if dtype.startswith("float"):
        a /= 255
    spec = (tmp_path / "a", shape, shape, dtype, [BYTES, _blosc(typesize=a.itemsize)])
    arr = _ts_array(*spec)
    arr.write(a).result()
    out = np.empty(a.nbytes, np.uint8)
    chunk = _chunk_file(tmp_path / "a" / "c")
    theirs = chunk.read_bytes()
    hostlib.blosc_decompress_into(theirs, out)
    assert out.tobytes() == a.tobytes()
    mine = hostlib.blosc_compress(a, a.itemsize)
    assert [mine[:2], mine[2] & ~MEMCPYED, mine[3:12]] == [theirs[:2], theirs[2] & ~MEMCPYED,
                                                           theirs[3:12]]
    assert hostlib.blosc_decompress_into(mine, out).tobytes() == a.tobytes()
    chunk.write_bytes(mine)
    reread = ts.open({"driver": "zarr3", "kvstore": {"driver": "file",
                                                     "path": str(tmp_path / "a")}}).result()
    np.testing.assert_array_equal(np.asarray(reread[...].read().result()), a)


def test_blosc_decodes_on_many_threads(tmp_path):
    """The codecs keep no state between calls and release the GIL: 16
    threads decoding the flagship-size chunk at once all get its bytes, and
    16 encoding it at once all write the same chunk, which decodes to it."""
    from concurrent.futures import ThreadPoolExecutor

    a = np.round(np.random.RandomState(3).rand(3, 1, 128, 160) * 255).astype(np.float32) / 255
    arr = _ts_array(tmp_path / "a", a.shape, a.shape, "float32", [BYTES, _blosc()])
    arr.write(a).result()
    chunk = _chunk_file(tmp_path / "a" / "c").read_bytes()

    def decode(_):
        return hostlib.blosc_decompress_into(chunk, np.empty(a.nbytes, np.uint8)).tobytes()

    with ThreadPoolExecutor(16) as pool:
        outs = list(pool.map(decode, range(64), timeout=60))
        chunks = list(pool.map(lambda _: hostlib.blosc_compress(a, 4), range(32), timeout=60))
    assert all(o == a.tobytes() for o in outs)
    assert len(set(chunks)) == 1
    assert hostlib.blosc_decompress_into(chunks[0], np.empty(a.nbytes, np.uint8)).tobytes() \
        == a.tobytes()


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


@pytest.mark.parametrize("dtype", ["float32", "uint8"])
@pytest.mark.parametrize("shuffle", ["bitshuffle", "shuffle", "noshuffle"])
@pytest.mark.parametrize("cname", ["blosclz", "lz4", "lz4hc", "snappy", "zlib"])
def test_blosc_other_compressors_read_by_port(tmp_path, cname, shuffle, dtype):
    """A (3, 2, 70, 90) array in (3, 1, 32, 48) chunks (edge chunks
    partial) of smooth content in coarse steps, written by tensorstore with
    each of blosc's other compressors (clevel 5, c-blosc's default; split
    streams where c-blosc splits): the port's reads equal tensorstore's,
    whole and windowed. A truncated chunk and one whose first compressed
    stream is zeroed raise ``ValueError`` naming the file. (c-blosc stores
    snappy's uint8 chunks memcpyed: a single stream's worst-case snappy
    length exceeds the room it leaves it.)"""
    a = _content("smooth", (3, 2, 70, 90), dtype, np.random.RandomState(5))
    a = np.round(a * 32) / 32 if dtype == "float32" else a // 8 * 8
    arr = _ts_array(tmp_path / "a", a.shape, (3, 1, 32, 48), dtype,
                    [BYTES, _blosc(cname, 5, shuffle, a.itemsize)])
    arr.write(a).result()
    mine = ZarrArray(tmp_path / "a")
    np.testing.assert_array_equal(mine[:], np.asarray(arr[:]))
    np.testing.assert_array_equal(mine[:, 1, 5:63, 20:84], a[:, 1, 5:63, 20:84])
    chunk = tmp_path / "a" / "c" / "0" / "0" / "0" / "0"
    data = chunk.read_bytes()
    code = {"blosclz": 0, "lz4": 1, "lz4hc": 1, "snappy": 2, "zlib": 3}[cname]
    assert data[2] >> 5 == code and bool(data[2] & MEMCPYED) == (cname == "snappy"
                                                                 and dtype == "uint8")
    chunk.write_bytes(data[:len(data) * 2 // 3])
    with pytest.raises(ValueError, match=str(chunk)):
        mine[:, 0]
    if data[2] & MEMCPYED:
        return
    split = not data[2] & 0x10
    neblock = struct.unpack("<I", data[8:12])[0] // (a.itemsize if split else 1)
    p = struct.unpack("<I", data[16:20])[0]   # block 0's streams: the first compressed
    while (size := struct.unpack("<I", data[p:p + 4])[0]) == neblock:
        p += 4 + size
    chunk.write_bytes(data[:p + 4] + bytes(size) + data[p + 4 + size:])
    with pytest.raises(ValueError, match=str(chunk)):
        mine[:, 0]


@pytest.mark.parametrize("dtype", ["float32", "uint8"])
@pytest.mark.parametrize("shuffle", ["bitshuffle", "shuffle", "noshuffle"])
def test_port_writes_the_array_shuffle(tmp_path, shuffle, dtype):
    """The port writing into tensorstore-created blosc-zstd arrays under
    each shuffle (a (3, 2, 37, 45) array in (3, 1, 16, 24) chunks, edge
    chunks partial): every chunk's header has the flags of tensorstore's
    chunk at the same place (the memcpyed flag aside, which follows the
    compressed size), and tensorstore reads the array back."""
    rng = np.random.RandomState(6)
    a = _content("smooth", (3, 2, 37, 45), dtype, rng)
    arr = _ts_array(tmp_path / "a", a.shape, (3, 1, 16, 24), dtype,
                    [BYTES, _blosc("zstd", 3, shuffle, a.itemsize)])
    arr.write(a).result()
    chunks = sorted(f for f in (tmp_path / "a" / "c").rglob("*") if f.is_file())
    theirs = [f.read_bytes()[:4] for f in chunks]
    ZarrArray(tmp_path / "a").write((slice(None),), a[::-1].copy())
    mine = [f.read_bytes()[:4] for f in chunks]
    want = {"bitshuffle": 0x04, "shuffle": 0x01, "noshuffle": 0x00}[shuffle] | 0x10 | 4 << 5
    assert {t[2] & ~MEMCPYED for t in theirs} == {want}
    assert [(m[:2], m[2] & ~MEMCPYED, m[3]) for m in mine] == [(t[:2], t[2] & ~MEMCPYED, t[3])
                                                              for t in theirs]
    reread = ts.open({"driver": "zarr3", "kvstore": {"driver": "file",
                                                     "path": str(tmp_path / "a")}}).result()
    np.testing.assert_array_equal(np.asarray(reread[...].read().result()), a[::-1])


# ---------------------------------------------------- JAX-written stores

@pytest.mark.parametrize("name", sorted(RECORDS["stores"]) + sorted(OTHER_STORES))
def test_fixture_store_read_by_port(name):
    """The committed stores written by JAX's ``VideoStore`` (the small ones
    and the two of one (3, 1, 512, 640) chunk), and those it wrote with
    blosc's other compressors: the port's arrays equal JAX's reads and the
    recorded sha256, windows too; the class locations are JAX's."""
    from mmr_tpu.data.zarr_io import VideoStore as JaxStore

    rec = RECORDS["stores"].get(name) or OTHER_STORES[name]
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


def _stored(array: Path) -> int:
    return sum(f.stat().st_size for f in (array / "c").rglob("*") if f.is_file())


@pytest.mark.parametrize("name", ["f32_full", "u8_full", "render_f32", "render_u8", "masks"])
def test_port_blosc_within_tensorstore_size(tmp_path, name):
    """The port's default writer against tensorstore's c-blosc (zstd
    clevel 3, bitshuffle) on the same arrays: the committed full-size image
    chunks written again through ``VideoStore`` (read back to the recorded
    sha256), and one full-HD ``render_frame`` written by both stores in
    512×640 chunks (edge chunks at full size). The port's image chunks take
    at most 1.10× tensorstore's bytes (measured 0.99, 1.02, 1.00, 1.00).
    ``masks``: the mask array of every committed zstd store written again:
    each at most 1.40× tensorstore's bytes (measured 1.23 and 1.34 for the
    64×80 and 60×45 chunks, tens of bytes each, where the port's greedy
    matcher loses to libzstd's lazy parse; 0.77 for the full-size chunk)."""
    from mmr_tpu.data.zarr_io import VideoStore as JaxStore
    from mmr_tpu_torch.data.synthetic import render_frame

    if name == "masks":
        for store in RECORDS["stores"]:
            src = VideoStore(FIXTURES / "blosc" / f"{store}.zarr")
            mine = VideoStore.create(tmp_path / store, *src.shape, src.mask.chunks[1:])
            mine.mask.write((slice(None),), src.mask[:])
            assert _sha(VideoStore(tmp_path / store).mask[:]) == RECORDS["stores"][store]["mask"]
            assert _stored(tmp_path / store / "mask") <= 1.40 * _stored(src.path / "mask"), store
        return
    if name.startswith("render"):
        dtype = np.float32 if name.endswith("f32") else np.uint8
        img, mask = render_frame(np.random.RandomState(12), 1080, 1920, 9)
        stores = [cls.create(tmp_path / who, 1, 1080, 1920, (512, 640), image_dtype=dtype)
                  for who, cls in (("mine", VideoStore), ("theirs", JaxStore))]
        for s in stores:
            s.write_frame(0, img.transpose(2, 0, 1), mask)
        mine, theirs = tmp_path / "mine", tmp_path / "theirs"
        np.testing.assert_array_equal(np.asarray(JaxStore(mine).image[:]),
                                      np.asarray(stores[1].image[:]))
    else:
        theirs = FIXTURES / "blosc" / f"{name}.zarr"
        src = VideoStore(theirs)
        t, h, w = src.shape
        mine = tmp_path / "mine"
        dst = VideoStore.create(mine, t, h, w, src.image.chunks[2:], image_dtype=src.image_dtype)
        img, mask = src.read_frames(0, t)
        dst.image.write((slice(None),), img.transpose(3, 0, 1, 2))
        dst.mask.write((slice(None),), mask)
        assert _sha(VideoStore(mine).image[:]) == RECORDS["stores"][name]["image"]
    assert _stored(mine / "image") <= 1.10 * _stored(theirs / "image")


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


SAMPLINGS = {"4:4:4": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
             "4:2:2": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
             "4:2:0": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
             "4:4:0": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
             "4:1:1": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411, "grey": None}


def _segments(data: bytes) -> list[tuple[int, int, int]]:
    """(marker, start, end) of each marker segment of a JPEG after SOI, a
    scan's entropy-coded data (restart markers included) inside its SOS
    segment's span."""
    out, p = [], 2
    while data[p + 1] != 0xD9:
        m, end = data[p + 1], p + 2 + struct.unpack(">H", data[p + 2:p + 4])[0]
        while m == 0xDA and not (data[end] == 0xFF and data[end + 1]
                                 and not 0xD0 <= data[end + 1] <= 0xD7):
            end += 1
        out.append((m, p, end))
        p = end
    return out + [(0xD9, p, p + 2)]


@pytest.mark.parametrize("restart", [0, 7])
@pytest.mark.parametrize("sampling", list(SAMPLINGS))
@pytest.mark.parametrize("progressive", [True, False], ids=["progressive", "baseline"])
def test_jpeg_samplings_equal_pil(progressive, sampling, restart):
    """cv2's progressive (SOF2: DC and AC first and refinement scans, EOB
    runs) and baseline JPEGs at each sampling cv2 writes, 4:4:0 (h1v2: the
    fancy vertical filter) and 4:1:1 (h4v1: samples repeated) among them,
    grey, with and without a restart interval of 7 MCUs (EOB runs reset at
    each RSTn), at odd sizes whose edge blocks are partial, sharp colour
    edges inside: decoded sample for sample as PIL decodes them; so are
    PIL's progressive frames with optimized tables."""
    rng = np.random.RandomState(10)
    for h, w in ((37, 53), (17, 5), (2, 3), (101, 131)):
        img = _scene(rng, h, w)
        img[h // 3:h // 2 + 1, w // 4:w // 2 + 1] = (200, 30, 40)
        params = [cv2.IMWRITE_JPEG_QUALITY, 85, cv2.IMWRITE_JPEG_PROGRESSIVE, int(progressive),
                  cv2.IMWRITE_JPEG_RST_INTERVAL, restart]
        if SAMPLINGS[sampling] is None:
            data = cv2.imencode(".jpg", img[..., 0], params)[1].tobytes()
        else:
            params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLINGS[sampling]]
            data = cv2.imencode(".jpg", img, params)[1].tobytes()
        markers = [m for m, _, _ in _segments(data)]
        assert (0xC2 in markers) == progressive and (0xDD in markers) == bool(restart)
        np.testing.assert_array_equal(hostlib.jpeg_decode(data), _pil(data))
        if progressive and sampling in ("4:4:4", "4:2:2", "4:2:0"):
            sub = ["4:4:4", "4:2:2", "4:2:0"].index(sampling)
            data = _pil_jpeg(img, quality=70, subsampling=sub, progressive=True, optimize=True)
            np.testing.assert_array_equal(hostlib.jpeg_decode(data), _pil(data))


def test_progressive_scans_as_libjpeg():
    """A PIL progressive 4:2:0 frame (10 scans: interleaved DC first, AC
    spectral selection of each component, AC and DC refinements) taken
    apart: a DQT redefining both tables before the last scan changes nothing
    (each component's table is latched at its first scan), as in PIL's
    decode; scan headers out of range, an AC scan of several components,
    a refinement whose first scan was dropped, an AC scan before its DC
    scan: ``ValueError`` naming it; the frame cut after its sixth scan,
    whose coefficients libjpeg would smooth: ``NotImplementedError``."""
    img = _scene(np.random.RandomState(12), 45, 61)
    img[10:30, 20:40] = (30, 200, 60)
    data = _pil_jpeg(img, quality=80, subsampling=2, progressive=True)
    segs = _segments(data)
    scans = [(a, b) for m, a, b in segs if m == 0xDA]
    assert len(scans) == 10 and data[scans[0][0] + 4] == 3   # interleaved DC first
    want = _pil(data)
    np.testing.assert_array_equal(hostlib.jpeg_decode(data), want)
    last = scans[-1][0]
    dqt = _seg(0xDB, bytes([0]) + bytes([1] * 64) + bytes([1]) + bytes([9] * 64))
    later = data[:last] + dqt + data[last:]
    np.testing.assert_array_equal(_pil(later), want)
    np.testing.assert_array_equal(hostlib.jpeg_decode(later), want)

    def edit(k, ss=None, se=None, ahal=None):
        a = scans[k][0]
        n = data[a + 4]
        head = bytearray(data[a:a + 5 + 2 * n + 3])
        for off, v in ((5 + 2 * n, ss), (6 + 2 * n, se), (7 + 2 * n, ahal)):
            if v is not None:
                head[off] = v
        return data[:a] + bytes(head) + data[a + len(head):]

    def drop(k):
        return data[:scans[k][0]] + data[scans[k][1]:]

    bad = {"spectral selection 1..64": edit(1, se=64),
           "spectral selection 6..5": edit(1, ss=6, se=5),
           "approximation 0/14": edit(1, ahal=14),
           "approximation 2/0": edit(5, ahal=0x20),
           "3 components with spectral selection 1..5": edit(0, ss=1, se=5),
           "after no first scan": drop(1),
           "AC scan of component 1 before its DC scan": drop(0)}
    for name, frame in bad.items():
        with pytest.raises(ValueError, match=name):
            hostlib.jpeg_decode(frame)
    cut = data[:scans[6][0]] + b"\xff\xd9"
    with pytest.raises(NotImplementedError, match="block smoothing"):
        hostlib.jpeg_decode(cut)


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
    ((45, 70), ((4, 2), (1, 1), (1, 1)), 0),
    ((53, 37), ((1, 4), (1, 1), (1, 1)), 3),
    ((43, 59), ((2, 2), (2, 1), (1, 2)), 0),
    ((31, 50), ((4, 1), (2, 1), (1, 1)), 0),
], ids=["420", "422-restart", "444-restart", "410", "1x4-restart", "mixed", "411-mixed"])
def test_jpeg_non_interleaved_scans_equal_pil(size, sampling, restart):
    """JPEGs of one scan a component (blocks cover each component's own
    size, not the MCU grid's), Huffman and quantization tables redefined
    between the scans, restart intervals inside them, at the sampling
    ratios cv2 writes and at others libjpeg takes (4 × 2 and 1 × 4 luma,
    chroma components of different ratios: h2v2, h1v2 and h2v1 filters and
    repeated samples in one frame): decoded as PIL decodes them. The coefficients keep every sample within a few hundred
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


@pytest.mark.parametrize("name", ["mjpeg_1080", *sorted(RECORDS["mjpeg"])])
def test_fixture_mjpeg_frames(name):
    """The committed Motion-JPEG AVIs: cv2's 1080×1920 video (4:2:0, 1080
    rows: the last MCU row half outside the frame), and the progressive
    4:2:2 1080×1920 and 240×320 baseline and progressive 4:4:0 and 4:1:1
    AVIs of ``cv2.imencode`` frames: each frame equals PIL's decode and the
    recorded sha256; a frame past the end is None."""
    rec = RECORDS["avi"] if name == "mjpeg_1080" else RECORDS["mjpeg"][name]
    with VideoReader(FIXTURES / rec["file"]) as v:
        assert (v.height, v.width, v.fourcc) == (*rec["shape"][:2], "MJPG")
        assert v.frame_count == len(rec["frames"])
        for t, want in enumerate(rec["frames"]):
            frame = v.read(t)
            assert frame.shape == tuple(rec["shape"]) and _sha(frame) == want
            np.testing.assert_array_equal(frame, _pil(v.frame_bytes(t)))
        assert v.read(v.frame_count) is None and v.read(-1) is None


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


def _cv2_gap_videos(tmp_path, layout) -> dict:
    """{kind: AVI} of a layout: at 4:2:0, cv2's writer on smooth frames with
    noise and on JAX's converter-test frames (48×64), and the full-HD
    fixture; at 4:2:0 with 135 rows (an odd height), cv2's writer on both
    kinds; at 4:4:0 and 4:1:1, the baseline and progressive 240×320
    fixtures and the converter-test frames from ``cv2.imencode``; the
    progressive 4:2:2 full-HD fixture."""
    rng = np.random.RandomState(6)
    if layout in ("4:2:0", "4:2:0 odd height"):
        h, w = (48, 64) if layout == "4:2:0" else (135, 270)
        kinds = {"smooth": [_scene(rng, h, w, t)[..., ::-1] for t in range(3)],
                 "edges": _edge_frames(3, h, w)}
        paths = {"fixture": FIXTURES / RECORDS["avi"]["file"]} if layout == "4:2:0" else {}
        for kind, frames in kinds.items():
            paths[kind] = tmp_path / f"{kind}.avi"
            writer = cv2.VideoWriter(str(paths[kind]), cv2.VideoWriter_fourcc(*"MJPG"), 5, (w, h))
            for f in frames:
                writer.write(f)
            writer.release()
        return paths
    if layout == "progressive 4:2:2":
        return {"fixture": FIXTURES / RECORDS["mjpeg"]["mjpeg_prog_1080"]["file"]}
    tag = layout.replace(":", "")[:3]
    params = [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLINGS[layout]]
    (tmp_path / "edges.avi").write_bytes(_avi(
        [cv2.imencode(".jpg", f, params)[1].tobytes() for f in _edge_frames()], 64, 48))
    return {"scene": FIXTURES / f"mjpeg_{tag}.avi", "progressive scene":
            FIXTURES / f"mjpeg_prog_{tag}.avi", "edges": tmp_path / "edges.avi"}


@pytest.mark.parametrize("layout", ["4:2:0", "4:2:0 odd height", "4:4:0", "4:1:1",
                                    "progressive 4:2:2"])
def test_cv2_gap(tmp_path, layout):
    """cv2 reads Motion-JPEG through FFmpeg and swscale. Against it, on
    smooth frames with noise, JAX's converter-test frames (sharp colour
    edges) and the tissue-like fixtures, at every layout: the port's
    OpenCV-style decode (what the converters store: repeated chroma at
    4:2:2 and 4:2:0 of even height, swscale's cubic chroma elsewhere) stays
    within the converter's bound on every kind; its libjpeg decode (the
    default) within each kind's measured gap, up to 79 levels at the
    edges, where the triangular filter blends the chroma."""
    for kind, path in _cv2_gap_videos(tmp_path, layout).items():
        for fancy, (mean, peak) in ((False, (CV2_MEAN, CV2_MAX)),
                                    (True, LIBJPEG_GAP[kind.split()[-1]])):
            cap = cv2.VideoCapture(str(path))
            with VideoReader(path, fancy_upsampling=fancy) as v:
                assert v.frame_count >= 2
                for t in range(v.frame_count):
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
        for arr in ("image", "mask"):
            meta = [json.loads((root / "data" / name / arr / "zarr.json").read_text())
                    for root in (mine, theirs)]
            assert meta[0]["codecs"] == meta[1]["codecs"], (name, arr)
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
    unwritten), masks, class locations, codecs (blosc-zstd) and split files
    exactly equal, frames within the bound of cv2's decode."""
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


def test_create_dataset_progressive_matches_jax(tmp_path):
    """``mmr_torch_create_dataset`` on a nested ZIP of two videos, the
    progressive 4:4:0 and 4:1:1 fixtures (240×320), with masks of 9
    classes: the stores JAX's ``convert_zip_dataset`` makes from it (float32
    in 128×160 chunks, the split file): masks, class locations, codecs and
    split exact, frames within the converter's bound of cv2's decode."""
    from mmr_tpu.data.convert import convert_zip_dataset as jax_convert
    from mmr_tpu_torch.cli.create_dataset import main

    rng = np.random.RandomState(19)
    outer = tmp_path / "videos.zip"
    with zipfile.ZipFile(outer, "w") as zo:
        for v, name in enumerate(("mjpeg_prog_440", "mjpeg_prog_411")):
            rec = RECORDS["mjpeg"][name]
            inner = tmp_path / f"video_{v + 1:02d}.zip"
            with zipfile.ZipFile(inner, "w") as zi:
                zi.write(FIXTURES / rec["file"], "video_left.avi")
                for t in range(len(rec["frames"])):
                    m = np.zeros(rec["shape"][:2], np.uint8)
                    for c in range(1, 10):
                        y, x = rng.randint(0, 200), rng.randint(0, 280)
                        m[y:y + 30, x:x + 40] = c
                    zi.writestr(f"segmentation/{t:09d}.png", cv2.imencode(".png", m)[1].tobytes())
            zo.write(inner, inner.name)
    assert main([str(outer), str(tmp_path / "mine"), "9", "[128,160]", "--write_split"]) == 0
    theirs = jax_convert(outer, tmp_path / "theirs", 9, (128, 160), write_split=True)
    _same_dataset(tmp_path / "mine", theirs)


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
    """Another fourcc (cv2's mp4v AVI), lossless, arithmetic-coded
    (sequential and progressive), hierarchical, 12-bit, CMYK and DNL-height
    JPEG, a zstd dictionary, a
    blosc header of another version, blosc's delta filter, a write into a
    blosc-lz4 array (tensorstore wrote it; the port reads it), a typesize
    c-blosc lacks: ``NotImplementedError`` naming each; a truncated chunk:
    ``ValueError`` naming its file, and written anew by the port, read back
    by both readers."""
    w = cv2.VideoWriter(str(tmp_path / "m.avi"), cv2.VideoWriter_fourcc(*"mp4v"), 5, (64, 48))
    w.write(np.zeros((48, 64, 3), np.uint8))
    w.release()
    with pytest.raises(NotImplementedError, match="fourcc 'mp4v'"):
        VideoReader(tmp_path / "m.avi")
    img = np.random.RandomState(8).randint(0, 256, (32, 32, 3)).astype(np.uint8)
    base = _pil_jpeg(img)
    sof = base.index(b"\xff\xc0")
    for marker, name in ((0xC3, r"lossless JPEG \(SOF3\)"),
                         (0xC9, r"arithmetic-coded sequential JPEG \(SOF9\)"),
                         (0xCA, r"arithmetic-coded progressive JPEG \(SOF10\)")):
        with pytest.raises(NotImplementedError, match=name):
            hostlib.jpeg_decode(base[:sof + 1] + bytes([marker]) + base[sof + 2:])
    with pytest.raises(NotImplementedError, match="12-bit JPEG"):
        hostlib.jpeg_decode(base[:sof + 4] + b"\x0c" + base[sof + 5:])
    with pytest.raises(NotImplementedError, match=r"differential sequential JPEG \(SOF5\)"):
        hostlib.jpeg_decode(base[:sof + 1] + b"\xc5" + base[sof + 2:])
    with pytest.raises(NotImplementedError, match="height given by a DNL marker"):
        hostlib.jpeg_decode(base[:sof + 5] + b"\0\0" + base[sof + 7:])
    b = io.BytesIO()
    Image.fromarray(img).convert("CMYK").save(b, "JPEG")
    with pytest.raises(NotImplementedError, match="4-component JPEG"):
        hostlib.jpeg_decode(b.getvalue())
    a = np.arange(4096, dtype=np.float32).reshape(1, 64, 64)
    arr = _ts_array(tmp_path / "lz4", a.shape, a.shape, "float32", [BYTES, _blosc("lz4")])
    arr.write(a).result()
    lz4 = _chunk_file(tmp_path / "lz4" / "c").read_bytes()
    out = np.empty(a.nbytes, np.uint8)
    with pytest.raises(NotImplementedError, match="blosc header version 3"):
        hostlib.blosc_decompress_into(b"\x03" + lz4[1:], out)
    with pytest.raises(NotImplementedError, match="blosc delta filter"):
        hostlib.blosc_decompress_into(lz4[:2] + bytes([lz4[2] | 0x08]) + lz4[3:], out)
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
    ZarrArray(tmp_path / "b").write((0,), a[0])   # the damaged chunk written anew
    np.testing.assert_array_equal(ZarrArray(tmp_path / "b")[:], a)
    np.testing.assert_array_equal(np.asarray(b[...].read().result()), a)
    with pytest.raises(NotImplementedError, match="blosc compressor 'lz4'"):
        ZarrArray(tmp_path / "lz4").write((0,), a[0])
    with pytest.raises(NotImplementedError, match="c.bin: blosc typesize 300"):
        hostlib.blosc_compress(a, 300, "c.bin")


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
