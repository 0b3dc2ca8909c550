"""Path B's host data path in the port against the JAX package on the CPU:
the Zarr stores both ways (the port's gzip stores read by JAX's
tensorstore-backed ``VideoStore``, tensorstore's gzip and raw stores read
by the port, absent chunks as the fill value, blosc-lz4 refused), the window
crops, the ``PatchSampler`` (bit-equal batches for three epochs), the
``VideoFrameDataset``, ``make_synthetic_dataset``, the split files (byte-
equal to scikit-learn's), the one-hot codecs and the converter's parts
that need no video decoder. Everything is exact."""

import io
import json

import numpy as np
import pytest
import tensorstore as ts
import torch

from mmr_tpu_torch.data import convert, png, splits, zarr_io
from mmr_tpu_torch.data.patch_dataset import PatchSampler
from mmr_tpu_torch.data.synthetic import make_synthetic_dataset
from mmr_tpu_torch.data.video_dataset import VideoFrameDataset
from mmr_tpu_torch.data.zarr_io import VideoStore, ZarrArray, list_dataset_stores
from mmr_tpu_torch.ops import onehot, padcrop
from tests.test_torch_train_modules import few_torch_threads  # noqa: F401

BYTES = {"name": "bytes", "configuration": {"endian": "little"}}
GZIP = {"name": "gzip", "configuration": {"level": 1}}


@pytest.fixture(scope="module", autouse=True)
def two_decode_threads():
    """The chunk pool held to two threads, as torch is: these stores are
    small, and the cores are the other test workers'."""
    zarr_io.set_pool_threads(2)
    yield
    zarr_io.set_pool_threads(zarr_io.POOL_THREADS)


def _frame(rng, h, w, n_classes=4):
    """(3, h, w) f32 levels k / 255 and (h, w) uint8 ids."""
    img = rng.rand(3, h, w).astype(np.float32)
    mask = rng.randint(0, n_classes, (h, w)).astype(np.uint8)
    return (np.round(img * 255) / 255).astype(np.float32), mask


def _port_store(path, rng, t, h, w, patch, dtype, skip=(), background=()):
    """A port-written store with frames ``skip`` left unwritten and frames
    ``background`` all class 0 (their mask chunks absent)."""
    s = VideoStore.create(path, t, h, w, patch, image_dtype=dtype)
    locs = {"1": [], "2": [], "3": []}
    for i in range(t):
        if i in skip:
            continue
        img, mask = _frame(rng, h, w)
        if i in background:
            mask[:] = 0
        s.write_frame(i, img, mask)
        for c in (1, 2, 3):
            yx = np.argwhere(mask == c)[:7]
            locs[str(c)] += [(i, int(y), int(x)) for y, x in yx]
    s.set_properties({"class_locations": locs})
    return s


def _ts_store(path, rng, t, h, w, patch, codecs, skip=(), background=()):
    """The same schema written by tensorstore with ``codecs``."""
    path.mkdir(parents=True)
    (path / "zarr.json").write_text(json.dumps(
        {"zarr_format": 3, "node_type": "group", "attributes": {}}))

    def arr(name, shape, chunks, dtype):
        return ts.open({"driver": "zarr3", "kvstore": {"driver": "file",
                                                        "path": str(path / name)},
                        "metadata": {"shape": list(shape), "data_type": dtype,
                                     "chunk_grid": {"name": "regular", "configuration":
                                                    {"chunk_shape": list(chunks)}},
                                     "codecs": codecs},
                        "create": True}).result()

    image = arr("image", (3, t, h, w), (3, 1) + patch, "float32")
    mask = arr("mask", (t, h, w), (1,) + patch, "uint8")
    for i in range(t):
        if i in skip:
            continue
        img, m = _frame(rng, h, w)
        if i in background:
            m[:] = 0
        image[:, i].write(img).result()
        mask[i].write(m).result()
    return path


def _chunk_files(store, t):
    """(image, mask) chunk files of frame ``t``."""
    return [[f for f in (store / arr / "c" / lead).rglob("*") if f.is_file()]
            for arr, lead in (("image", f"0/{t}"), ("mask", f"{t}"))]


def _same_store(a, b):
    ia, ma = a.read_frames(0, a.shape[0])
    ib, mb = b.read_frames(0, b.shape[0])
    assert ia.dtype == ib.dtype and a.shape == b.shape
    np.testing.assert_array_equal(ia, ib)
    np.testing.assert_array_equal(ma, mb)
    for window in ((0, -9, -13, 64, 48), (a.shape[0] - 1, 40, 70, 64, 64),
                   (1, 0, 0, a.shape[1] + 20, a.shape[2] + 3)):
        for x, y in zip(a.read_windows_async(*window)(), b.read_windows_async(*window)()):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(a.read_image_window(*window, pad_value=0.25),
                                      b.read_image_window(*window, pad_value=0.25))
        np.testing.assert_array_equal(a.read_mask_window(*window),
                                      b.read_mask_window(*window))


# ------------------------------------------------------------------ stores

@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_port_store_read_by_jax(tmp_path, dtype):
    """(a) 100×130 frames in 64×64 chunks (edge chunks partial), frame 2
    unwritten, frame 3 all background: JAX's tensorstore reader gets the
    port's arrays and properties, bit for bit."""
    from mmr_tpu.data.zarr_io import VideoStore as JaxStore

    rng = np.random.RandomState(3)
    mine = _port_store(tmp_path / "v.zarr", rng, 5, 100, 130, (64, 64), dtype,
                       skip=(2,), background=(3,))
    assert _chunk_files(mine.path, 2) == [[], []]
    assert _chunk_files(mine.path, 3)[0] and not _chunk_files(mine.path, 3)[1]
    theirs = JaxStore(tmp_path / "v.zarr")
    assert theirs.image_dtype == mine.image_dtype == np.dtype(dtype)
    assert theirs.class_locations == mine.class_locations
    _same_store(VideoStore(tmp_path / "v.zarr"), theirs)
    img, mask = mine.read_frames(2, 4)
    assert not img[0].any() and not mask.any()


@pytest.mark.parametrize("codecs", [[BYTES, GZIP], [BYTES]], ids=["gzip", "raw"])
def test_tensorstore_store_read_by_port(tmp_path, codecs):
    """(b) tensorstore's gzip and raw stores, with an unwritten frame and
    an all-background frame (absent chunks), read bit-equal by the port."""
    from mmr_tpu.data.zarr_io import VideoStore as JaxStore

    rng = np.random.RandomState(4)
    path = _ts_store(tmp_path / "t.zarr", rng, 4, 90, 70, (32, 48), codecs,
                     skip=(1,), background=(2,))
    assert _chunk_files(path, 1) == [[], []]
    assert _chunk_files(path, 2)[0] and not _chunk_files(path, 2)[1]
    _same_store(VideoStore(path), JaxStore(path))


def test_blosc_store_raises(tmp_path):
    """(c) a blosc store of another compressor than the reference's zstd
    (lz4, written by tensorstore) is refused, naming the compressor; the
    reference's blosc-zstd stores read (``test_torch_native_data.py``)."""
    path = tmp_path / "b.zarr"
    _ts_store(path, np.random.RandomState(2), 2, 40, 40, (32, 32),
              [BYTES, {"name": "blosc", "configuration": {
                  "cname": "lz4", "clevel": 3, "shuffle": "bitshuffle", "typesize": 4}}])
    with pytest.raises(NotImplementedError, match="blosc compressor 'lz4'"):
        VideoStore(path).read_frames(0, 1)
    with pytest.raises(NotImplementedError, match="blosc compressor 'lz4'"):
        PatchSampler([path], (32, 32), 2, 1)


def test_zarr_array_partial_writes_and_indexing(tmp_path):
    """Writes that cover a chunk in part merge with what is stored; a write
    of the fill value removes the chunk; ints and slices index as numpy;
    data of another shape than the region's is refused."""
    a = ZarrArray.create(tmp_path / "a", (5, 37, 21), (2, 16, 8), np.float32)
    ref = np.zeros(a.shape, np.float32)
    rng = np.random.RandomState(5)
    for index in ((slice(1, 4), slice(3, 30), slice(2, 19)), (2,), (4, slice(None), 7),
                  (slice(None), 20)):
        val = rng.randn(*ref[index].shape).astype(np.float32)
        a.write(index, val)
        ref[index] = val
        np.testing.assert_array_equal(a[:], ref)
    a.write((slice(None), slice(None), slice(0, 8)), np.zeros((5, 37, 8), np.float32))
    ref[..., :8] = 0
    assert not (tmp_path / "a" / "c" / "0" / "0" / "0").exists()
    for index in ((3,), (-1, 5), (slice(1, 5), slice(10, 12), 20), (slice(2, 2),)):
        np.testing.assert_array_equal(ZarrArray(tmp_path / "a")[index], ref[index])
    with pytest.raises(IndexError):
        a[5]
    with pytest.raises(ValueError, match="shape"):
        a.write((2,), np.zeros((37, 1), np.float32))


@pytest.mark.parametrize("key, value, what", [
    ("data_type", "int16", "data type"),
    ("codecs", [{"name": "bytes", "configuration": {"endian": "big"}}], "big endian"),
    ("chunk_key_encoding", {"name": "default", "configuration": {"separator": "."}},
     "separator"),
    ("chunk_key_encoding", {"name": "v2"}, "chunk key encoding"),
    ("fill_value", "NaN", "fill value"),
    ("codecs", [BYTES, {"name": "zstd", "configuration": {"level": 1}}], "zstd"),
])
def test_zarr_array_refuses_what_the_schema_lacks(tmp_path, key, value, what):
    """Metadata outside the stores' schema (another data type, big-endian
    bytes, another chunk key, a non-numeric fill, another codec) is refused
    by name, never misread."""
    ZarrArray.create(tmp_path / "a", (2, 4), (1, 4), np.float32)
    meta = json.loads((tmp_path / "a" / "zarr.json").read_text())
    meta[key] = value
    (tmp_path / "a" / "zarr.json").write_text(json.dumps(meta))
    with pytest.raises(NotImplementedError, match=what):
        ZarrArray(tmp_path / "a")


def test_center_pad_bbox_crop_matches_jax():
    from mmr_tpu.ops import padcrop as jp

    arr = np.arange(3 * 11 * 13, dtype=np.float32).reshape(3, 11, 13)
    for lo, patch in (((-3, -4), (8, 9)), ((5, 9), (8, 9)), ((-2, 3), (16, 20)),
                      ((0, 0), (11, 13))):
        np.testing.assert_array_equal(padcrop.center_pad_bbox_crop(arr, lo, patch, 7.0),
                                      jp.center_pad_bbox_crop(arr, lo, patch, 7.0))
        assert padcrop.window_slices(lo, patch, (11, 13)) == jp.window_slices(
            lo, patch, (11, 13))


# ------------------------------------------------------- sampler, datasets

@pytest.fixture(scope="module")
def sampler_stores(tmp_path_factory):
    """Per dtype: a 100×130 store and a 40×50 one (frames smaller than the
    patch), a frame of each unwritten, written by the port."""
    root = tmp_path_factory.mktemp("sampler")
    rng = np.random.RandomState(6)
    out = {}
    for dtype in (np.uint8, np.float32):
        out[dtype] = [
            _port_store(root / f"{dtype.__name__}_a.zarr", rng, 5, 100, 130, (64, 64),
                        dtype, skip=(4,)).path,
            _port_store(root / f"{dtype.__name__}_b.zarr", rng, 3, 40, 50, (32, 32),
                        dtype, skip=(1,)).path]
    return out


@pytest.mark.parametrize("strategy", ["deterministic", "probabilistic"])
@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_patch_sampler_matches_jax(sampler_stores, strategy, dtype):
    """(d) three epochs of B=3 (6 batches each, the permutation wraps),
    64×64 patches read at an initial 72×80, both oversampling strategies:
    the batches are JAX's, bit for bit."""
    from mmr_tpu.data.patch_dataset import PatchSampler as JaxSampler

    kw = dict(oversample_foreground_percent=0.5, oversample_strategy=strategy,
              initial_patch_size=(72, 80), seed=11)
    mine = PatchSampler(sampler_stores[dtype], (64, 64), 3, 6, **kw)
    theirs = JaxSampler(sampler_stores[dtype], (64, 64), 3, 6, **kw)
    for e in range(3):
        got = list(mine.epoch(epoch_seed=100 + e))
        want = list(theirs.epoch(epoch_seed=100 + e, num_workers=2))
        assert len(got) == len(want) == len(mine) == 6
        for (gi, gm), (wi, wm) in zip(got, want):
            assert gi.dtype == wi.dtype == np.dtype(dtype) and gi.shape == (3, 72, 80, 3)
            np.testing.assert_array_equal(gi, wi)
            np.testing.assert_array_equal(gm, wm)


def test_patch_sampler_refuses_mixed_dtypes(sampler_stores):
    with pytest.raises(ValueError, match="mix image dtypes"):
        PatchSampler([sampler_stores[np.uint8][0], sampler_stores[np.float32][0]],
                     (64, 64), 2, 1)
    with pytest.raises(ValueError, match="no stores"):
        PatchSampler([], (64, 64), 2, 1)


def test_video_frame_dataset_matches_jax(sampler_stores):
    """(e) items of 2-frame chunks over both stores, the last one short."""
    from mmr_tpu.data.video_dataset import VideoFrameDataset as JaxDataset

    paths = sampler_stores[np.uint8]
    mine, theirs = VideoFrameDataset(paths, 2), JaxDataset(paths, 2)
    assert mine.index == theirs.index and len(mine) == 5
    for a, b in zip(mine, theirs):
        assert {k: a[k] for k in ("id", "t0", "t1")} == {k: b[k] for k in ("id", "t0", "t1")}
        assert a["image"].dtype == b["image"].dtype
        np.testing.assert_array_equal(a["image"], b["image"])
        np.testing.assert_array_equal(a["mask"], b["mask"])


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_make_synthetic_dataset_matches_jax(tmp_path, dtype):
    """(f) the same seed writes the same arrays, class_locations and split
    file (3 videos of 3 frames, 70×90 in 32×48 chunks)."""
    from mmr_tpu.data.synthetic import make_synthetic_dataset as jax_make
    from mmr_tpu.data.zarr_io import VideoStore as JaxStore

    kw = dict(n_videos=3, frames_per_video=3, height=70, width=90, n_classes=4,
              patch_size=(32, 48), seed=9, image_dtype=dtype)
    a, b = make_synthetic_dataset(tmp_path / "p", **kw), jax_make(tmp_path / "j", **kw)
    assert ((a / "train_val_test_split.json").read_bytes()
            == (b / "train_val_test_split.json").read_bytes())
    pa, pb = list_dataset_stores(a), list_dataset_stores(b)
    assert [p.name for p in pa] == [p.name for p in pb] == [
        "data_000.zarr", "data_001.zarr", "data_002.zarr"]
    for x, y in zip(pa, pb):
        assert VideoStore(x).properties == JaxStore(y).properties
        _same_store(JaxStore(x), JaxStore(y))


# ------------------------------------------------------------------ splits

@pytest.mark.parametrize("n", range(1, 41))
@pytest.mark.parametrize("splitting", ["train-val-test", "5-fold"])
def test_split_files_match_sklearn(tmp_path, splitting, n):
    """(g) the split files of n ids are JAX's (scikit-learn's) byte for
    byte, seed 12345; where JAX raises (n ≤ 2 for train-val-test, n < 5
    for 5-fold) the port raises ``ValueError`` too."""
    from mmr_tpu.data import splits as js

    for side in ("p", "j"):
        for i in range(n):
            (tmp_path / side / "data" / f"vid_{(i * 7) % 41:02d}.zarr").mkdir(parents=True)
    try:
        want = js.create_split_files(tmp_path / "j", splitting).read_bytes()
    except ValueError:
        with pytest.raises(ValueError):
            splits.create_split_files(tmp_path / "p", splitting)
        assert n <= 2 if splitting == "train-val-test" else n < 5
        return
    assert splits.create_split_files(tmp_path / "p", splitting).read_bytes() == want
    section = ("test", None) if splitting == "train-val-test" else ("val", n % 5)
    assert splits.get_data_ids(tmp_path / "p", splitting, *section) == js.get_data_ids(
        tmp_path / "j", splitting, *section)


# ------------------------------------------------------------------ onehot

def test_onehot_codecs_match_jax():
    """(h) ``one_hot`` (NHWC and NCHW, ids outside the classes),
    ``rgb_to_ids`` (unmatched pixels → 0), ``ids_to_rgb``."""
    import jax.numpy as jnp
    from mmr_tpu.data.classes import sarrarp50_key
    from mmr_tpu.ops import onehot as jo

    rng = np.random.RandomState(7)
    ids = rng.randint(-1, 7, (2, 5, 6))
    for axis, dtype in ((-1, torch.float32), (1, torch.bfloat16)):
        got = onehot.one_hot(torch.from_numpy(ids), 6, dtype=dtype, axis=axis)
        want = jo.one_hot(jnp.asarray(ids), 6, dtype=jnp.float32, axis=axis)
        assert got.dtype == dtype
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(want))
    key = sarrarp50_key()
    rgb = key[rng.randint(0, len(key), (2, 5, 6))]
    rgb[0, 0, 0] = (1, 2, 3)
    got = onehot.rgb_to_ids(torch.from_numpy(rgb), key)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jo.rgb_to_ids(jnp.asarray(rgb), key)))
    back = onehot.ids_to_rgb(got, key)
    np.testing.assert_array_equal(back.numpy(), np.asarray(jo.ids_to_rgb(jnp.asarray(got.numpy()), key)))


# ----------------------------------------------------------------- convert

def test_convert_helpers_match_jax(tmp_path):
    """``_mask_frame_mapping``, ``_read_mask`` (grey, RGB, RGBA and palette
    masks, against PIL), ``write_mini_split`` and
    ``calculate_dataset_statistics`` (against cv2)."""
    from PIL import Image

    from mmr_tpu.data import convert as jc

    names = ["a/000000060.png", "a/.hidden1.png", "a/notes.txt", "b/frame_12.PNG",
             "b/none.png", "c/000000120.png"]
    assert convert._mask_frame_mapping(names) == jc._mask_frame_mapping(names)
    rng = np.random.RandomState(8)
    for mode, shape in (("L", (9, 7)), ("RGB", (9, 7, 3)), ("RGBA", (9, 7, 4)), ("P", (9, 7))):
        buf = io.BytesIO()
        arr = rng.randint(0, 10, shape).astype(np.uint8)
        if mode == "P":
            im = Image.new("P", shape[::-1])
            im.putdata(arr.ravel().tolist())
            im.putpalette(rng.randint(0, 256, 768).tolist())
        else:
            im = Image.fromarray(arr)
        assert im.mode == mode
        im.save(buf, "PNG")
        got, want = convert._read_mask(buf.getvalue()), jc._read_mask(buf.getvalue())
        assert got.dtype == want.dtype == np.uint8
        np.testing.assert_array_equal(got, want)

    for n in (1, 2, 5):
        for side in ("p", "j"):
            for i in range(n):
                (tmp_path / f"{side}{n}" / "data" / f"data_{i:03d}.zarr").mkdir(parents=True)
        assert (convert.write_mini_split(tmp_path / f"p{n}").read_bytes()
                == jc.write_mini_split(tmp_path / f"j{n}").read_bytes())

    for i in range(5):
        png.write(tmp_path / "imgs" / f"f{i}.png", rng.randint(0, 256, (12, 10, 3)).astype(np.uint8))
    png.write(tmp_path / "imgs" / "grey.png", rng.randint(0, 256, (12, 10)).astype(np.uint8))
    for kw in ({}, {"max_images": 3, "seed": 2}):
        got = convert.calculate_dataset_statistics(tmp_path / "imgs", **kw)
        want = jc.calculate_dataset_statistics(tmp_path / "imgs", **kw)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
