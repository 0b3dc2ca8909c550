"""Path A end to end in the port, module by module against the JAX package
on the CPU: the class registry, the PNG codec against ``cv2``, the PNG
folder dataset against JAX's (masks exact, images within one level of
255 with ≥ 99 % exact: the port's resize follows ``cv2.resize``'s
fixed-point rules), SGD and RMSprop against ``optax`` (rtol 1e-5 / atol
1e-6 in f32), the checkpoint round trip (bit-exact), the ``.pth`` layout
both ways across the packages, the plot files, and the two CLIs on a tiny
PNG dataset with ``--device cpu``.
"""

import json
import struct
import zlib

import cv2
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from mmr_tpu_torch.data import classes, png
from mmr_tpu_torch.data.png_dataset import PngFolderDataset
from mmr_tpu_torch.metrics.evaluate import Evaluate
from mmr_tpu_torch.models import create_model
from mmr_tpu_torch.models.convert import from_jax_variables, to_jax_variables
from mmr_tpu_torch.monitor import save_accuracy_curves, save_losses, save_triptychs
from mmr_tpu_torch.monitor.plots import COLOURS, GAP, point_pixel
from mmr_tpu_torch.train import checkpoint as ckpt
from mmr_tpu_torch.train.optim import build_optimizer
from mmr_tpu_torch.train.state import TrainState
from tests.test_torch_models import _fill
from tests.test_torch_train_modules import few_torch_threads  # noqa: F401


def _smooth(rng, h, w, c):
    """A textured uint8 image (every PNG row filter gets used by libpng)."""
    y, x = np.mgrid[0:h, 0:w]
    base = np.sin(x / 7.0) * 60 + np.cos(y / 5.0) * 50 + 120
    a = np.stack([base + rng.randint(0, 25, (h, w)) + 9 * k for k in range(c)], -1)
    return np.clip(a, 0, 255).astype(np.uint8)


def _png_bytes(ihdr, raw_rows, extra=()):
    chunk = lambda k, b: (struct.pack(">I", len(b)) + k + b
                          + struct.pack(">I", zlib.crc32(k + b)))
    return (png.SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", *ihdr))
            + b"".join(chunk(k, b) for k, b in extra)
            + chunk(b"IDAT", zlib.compress(raw_rows)) + chunk(b"IEND", b""))


# ----------------------------------------------------------------- classes

def test_classes_match_jax(tmp_path):
    from mmr_tpu.data import classes as cj

    assert classes.SARRARP50_CLASSES == cj.SARRARP50_CLASSES
    np.testing.assert_array_equal(classes.sarrarp50_key(), cj.sarrarp50_key())
    assert classes.sarrarp50_names() == cj.sarrarp50_names()
    mine = [("bg", (0, 0, 0), "misc"), ("tool", (1, 2, 3), "instrument")]
    for write, load in ((classes.write_class_json, cj.load_class_json),
                        (cj.write_class_json, classes.load_class_json)):
        key, names = load(write(tmp_path / "c.json", mine))
        np.testing.assert_array_equal(key, [[0, 0, 0], [1, 2, 3]])
        assert names == ["bg", "tool"]


# --------------------------------------------------------------- PNG codec

def _cv2_rgb(data: bytes, unchanged: bool) -> np.ndarray:
    """``cv2.imdecode`` in either mode, channels turned to RGB(A) order."""
    a = cv2.imdecode(np.frombuffer(data, np.uint8),
                     cv2.IMREAD_UNCHANGED if unchanged else cv2.IMREAD_COLOR)
    return a[..., [2, 1, 0, 3][:a.shape[2]]] if a.ndim == 3 else a


@pytest.mark.parametrize("kind", ["grey", "rgb", "rgba", "palette"])
def test_png_reads_as_cv2(tmp_path, kind):
    """The decoder against ``cv2.imread`` in both modes (colour files: BGR →
    RGB) on files libpng writes (adaptive row filters), and a palette file
    written here; the encoder's files read back by cv2."""
    rng = np.random.RandomState(3)
    f = tmp_path / f"{kind}.png"
    if kind == "palette":
        pal = rng.randint(0, 256, (7, 3)).astype(np.uint8)
        idx = rng.randint(0, 7, (19, 23)).astype(np.uint8)
        rows = np.concatenate([np.zeros((19, 1), np.uint8), idx], 1)
        f.write_bytes(_png_bytes((23, 19, 8, 3, 0, 0, 0), rows.tobytes(),
                                 [(b"PLTE", pal.tobytes())]))
    else:
        img = _smooth(rng, 37, 53, {"grey": 1, "rgb": 3, "rgba": 4}[kind])
        cv2.imwrite(str(f), img[..., 0] if kind == "grey" else img)
    for unchanged in (False, True):
        got = png.read(f, unchanged=unchanged)
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, _cv2_rgb(f.read_bytes(), unchanged))
    got = got[..., :3] if got.ndim == 3 else got
    png.write(tmp_path / "w.png", got, {"k": "v"})
    back = cv2.imread(str(tmp_path / "w.png"), cv2.IMREAD_UNCHANGED)
    np.testing.assert_array_equal(back if got.ndim == 2 else back[..., ::-1], got)
    assert png.read_text(tmp_path / "w.png") == {"k": "v"}


def _formats():
    """(id, samples, depth, colour, interlace, palette, tRNS) of the PNG
    formats beyond 8-bit, non-interlaced grey / RGB / RGBA."""
    rng = np.random.RandomState(4)
    s = lambda n, top, hw=(13, 21): rng.randint(0, top + 1, (*hw, n))
    pal = rng.randint(0, 256, (16, 3)).astype(np.uint8)
    key = s(3, 255, (9, 11))
    key[0, 0] = key[-1, -1] = (7, 8, 9)
    return [
        ("16-bit", s(1, 65535), 16, 0, False, None, None),
        ("interlaced", s(3, 255, (19, 23)), 8, 2, True, None, None),
        ("grey + alpha", s(2, 255), 8, 4, False, None, None),
        ("grey + alpha 16-bit interlaced", s(2, 65535), 16, 4, True, None, None),
        ("RGB 16-bit", s(3, 65535), 16, 2, False, None, None),
        ("RGBA 16-bit interlaced", s(4, 65535, (5, 3)), 16, 6, True, None, None),
        ("grey 1-bit", s(1, 1), 1, 0, False, None, None),
        ("grey 2-bit interlaced", s(1, 3, (11, 9)), 2, 0, True, None, None),
        ("grey 4-bit", s(1, 15, (7, 13)), 4, 0, False, None, None),
        ("palette 1-bit", s(1, 1), 1, 3, False, pal[:2], None),
        ("palette 2-bit tRNS", s(1, 3), 2, 3, False, pal[:4], bytes([0, 90])),
        ("palette 4-bit interlaced", s(1, 15, (17, 10)), 4, 3, True, pal, None),
        ("palette 8-bit tRNS", s(1, 15), 8, 3, False, pal, bytes(range(0, 250, 25))),
        ("RGB tRNS", key, 8, 2, False, None, bytes([0, 7, 0, 8, 0, 9])),
        ("grey tRNS", s(1, 255), 8, 0, False, None, bytes([0, 5])),
    ]


@pytest.mark.parametrize("case", _formats(), ids=lambda c: c[0])
def test_png_formats_read_as_cv2(case):
    """16-bit, Adam7-interlaced, grey + alpha, 1/2/4-bit grey and palette
    files and ``tRNS`` read equal to ``cv2.imread`` in both modes: the
    image mode 8-bit RGB (16 bits keep their high byte), the unchanged mode
    uint16 kept and alpha kept (RGB(A) order)."""
    from tests.torch_fixtures.png_fixtures import encode

    _, samples, depth, colour, interlace, pal, trns = case
    data = encode(samples, depth, colour, interlace, pal, trns)
    for unchanged in (False, True):
        got = png.decode(data, unchanged=unchanged)[0]
        want = _cv2_rgb(data, unchanged)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", ["bad CRC", "truncated"])
def test_png_refuses(tmp_path, case):
    f = tmp_path / "x.png"
    rows = np.zeros((4, 1 + 4 * 3), np.uint8).tobytes()
    data = _png_bytes((4, 4, 8, 2, 0, 0, 0), rows)
    if case == "bad CRC":
        data = data[:30] + bytes([data[30] ^ 1]) + data[31:]
    else:
        data = data[:-20]
    f.write_bytes(data)
    with pytest.raises(ValueError, match=case):
        png.read(f)


# ------------------------------------------------------------ PNG dataset

@pytest.fixture(scope="module")
def png_root(tmp_path_factory):
    """``tests/test_cli.py``'s layout at 40×56: textured images, id-coded
    grey masks, written by cv2."""
    root = tmp_path_factory.mktemp("pngs")
    rng = np.random.RandomState(1)
    for split in ("train", "val"):
        (root / split / "images").mkdir(parents=True)
        (root / split / "groundtruth").mkdir(parents=True)
        for i in range(6):
            mask = np.zeros((40, 56), np.uint8)
            mask[8:24, 8:40] = 1
            mask[30:40, 5:20] = 2 + i % 2
            mask[0, :3] = 12                       # clamped to the last class
            img = np.clip(_smooth(rng, 40, 56, 3).astype(int)
                          + np.eye(3, dtype=int)[mask % 3] * 60, 0, 255)
            cv2.imwrite(str(root / split / "images" / f"f{i}.png"), img.astype(np.uint8))
            cv2.imwrite(str(root / split / "groundtruth" / f"f{i}.png"), mask)
    return root


@pytest.mark.parametrize("split,crop,shuffle", [("val", 256, None),
                                                ("train", -1, None),
                                                ("train", 256, True)])
def test_png_dataset_matches_jax(png_root, split, crop, shuffle):
    """Batches in the same order, random crops included (one RandomState of
    the seed), at (32, 48): a plain resize (40×56 → 32×48) or the train
    path's 540×960 resize and crop."""
    from mmr_tpu.data.png_dataset import PngFolderDataset as DatasetJ

    args = (png_root, split, (32, 48), crop, 10)
    mine, theirs = PngFolderDataset(*args), DatasetJ(*args)
    n = 0
    for (ia, ma), (ib, mb) in zip(mine.epoch(2, shuffle=shuffle, seed=5),
                                  theirs.epoch(2, shuffle=shuffle, seed=5)):
        assert ia.dtype == np.float32 and ma.dtype == np.int32
        np.testing.assert_array_equal(ma, mb)
        d = np.abs(ia - ib)
        assert d.max() <= 1.0 / 255 + 1e-7 and (d == 0).mean() >= 0.99
        n += 1
    assert n == 3
    if crop != -1:   # an item alone crops from the global numpy generator
        np.testing.assert_array_equal(mine[1][1], theirs[1][1])


def test_png_dataset_reads_fixture_formats(tmp_path):
    """A folder of ``tests/torch_fixtures/png`` (16-bit, Adam7 and grey +
    alpha images; 16-bit, Adam7 and 4-bit id masks): each item equals the
    JAX class's exactly, and each file decodes to ``records.json``'s cv2
    decode in both modes. A grey + alpha mask reads as four channels: the
    JAX class fails on it (numpy cannot broadcast it against the RGB key),
    the port raises naming the file."""
    import hashlib
    import shutil

    from mmr_tpu.data.png_dataset import PngFolderDataset as DatasetJ
    from tests.torch_fixtures.png_fixtures import OUT, encode

    records = json.loads((OUT / "records.json").read_text())
    for name, rec in records.items():
        for mode, want in rec.items():
            a = png.read(OUT / name, unchanged=mode == "unchanged")
            assert [list(a.shape), str(a.dtype)] == [want["shape"], want["dtype"]]
            assert hashlib.sha256(a.tobytes()).hexdigest() == want["sha256"], name
    shutil.copytree(OUT, tmp_path / "val", ignore=shutil.ignore_patterns("*.json"))
    args = (tmp_path, "val", (64, 64), 256, 10)
    mine, theirs = PngFolderDataset(*args), DatasetJ(*args)
    assert len(mine.files) == 3
    for i in range(3):
        for a, b in zip(mine[i], theirs[i]):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    gt = tmp_path / "val" / "groundtruth" / mine.files[0]
    gt.write_bytes(encode(np.full((64, 64, 2), 3), 8, 4))
    with pytest.raises(ValueError):
        DatasetJ(*args)[0]
    with pytest.raises(ValueError, match=mine.files[0]):
        PngFolderDataset(*args)[0]


def test_png_dataset_colour_masks(tmp_path):
    """An RGB-coded mask maps each key colour, in RGB order, to its id;
    other colours to 0."""
    key = classes.sarrarp50_key()
    ids = np.arange(12).reshape(3, 4) % 11          # 10 is no key colour
    rgb = np.where((ids < 10)[..., None], key[np.minimum(ids, 9)], 77).astype(np.uint8)
    png.write(tmp_path / "t" / "images" / "a.png", rgb)
    png.write(tmp_path / "t" / "groundtruth" / "a.png", rgb)
    _, m = PngFolderDataset(tmp_path, "t", (3, 4), 256)[0]
    np.testing.assert_array_equal(m, np.where(ids < 10, ids, 0))


# -------------------------------------------------------------- optimizers

@pytest.mark.parametrize("name,clip,differential", [
    ("sgd", None, False), ("sgd", 0.5, True),
    ("rmsprop", None, False), ("rmsprop", 0.5, True)])
def test_sgd_rmsprop_match_jax(rng, name, clip, differential):
    """Three updates on a small tree with coupled weight decay, the clip on
    (0.5: active) or off and the differential LR: the port's flat update
    against ``mmr_tpu.train.optim.build_optimizer``."""
    from mmr_tpu.train.optim import build_optimizer as opt_j

    kw = {"weight_decay": 1e-2, "clip_grad_norm": clip, "differential_lr": differential}
    if name == "sgd":
        kw["momentum"] = 0.9
    names = ["encoder.w", "head.b", "head.w"]
    p0 = [rng.randn(*s).astype(np.float32) for s in [(3, 4), (5,), (2, 2)]]
    gs = [[rng.randn(*p.shape).astype(np.float32) for p in p0] for _ in range(3)]
    tree = lambda leaves: {"encoder": {"w": leaves[0]},
                           "head": {"b": leaves[1], "w": leaves[2]}}
    oj = opt_j(name, **kw)
    pj = jax.tree_util.tree_map(jnp.asarray, tree(p0))
    sj = oj.init(pj)
    ot = build_optimizer(name, **kw)
    pt = [torch.from_numpy(p.copy()) for p in p0]
    st = ot.init(pt)
    mult = ot.lr_mult(names, pt)
    for g in gs:
        pj, sj = oj.apply_updates(pj, sj, tree([jnp.asarray(x) for x in g]), 1e-2)
        st = ot.apply_updates(pt, st, [torch.from_numpy(x) for x in g], 1e-2, mult)
    for got, want in zip(pt, jax.tree_util.tree_leaves(pj)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


# ------------------------------------------------------------- checkpoints

def _trained_unet(seed=0, classes_=10):
    model = create_model("unet", classes=classes_, device="cpu",
                         generator=torch.Generator().manual_seed(seed))
    opt = build_optimizer("sgd", momentum=0.9)
    state = TrainState.create(model, opt)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.01)
    state.opt_state["trace"].uniform_(-1, 1, generator=torch.Generator().manual_seed(1))
    state.step = 7
    return state


def test_checkpoint_round_trip(tmp_path):
    """best_f1 written only when the F1 improves; loading gives the same
    bits, the optimizer state with ``weights_only=False``; a resume path
    of another head loads tolerantly and lists what it skipped."""
    state = _trained_unet()
    cm = ckpt.CheckpointManager(tmp_path / "checkpoints")
    assert cm.save_best_by_f1(state, 3, 0.5) and cm.exists("best_f1")
    assert not cm.save_best_by_f1(state, 4, 0.4)
    fresh = TrainState.create(create_model("unet", classes=10, device="cpu"),
                              build_optimizer("sgd", momentum=0.9))
    fresh, meta = cm.load(fresh, "best_f1")
    assert meta == {"epoch": 3, "mean_f1": 0.5} and fresh.step == 7
    for (k, a), b in zip(state.model.state_dict().items(),
                         fresh.model.state_dict().values()):
        assert torch.equal(a, b), k
    assert torch.equal(fresh.opt_state["trace"], state.opt_state["trace"])
    other = TrainState.create(create_model("unet", classes=5, device="cpu"),
                              build_optimizer("adam"))
    other, meta = ckpt.load_checkpoint_path(tmp_path, other)
    assert meta["epoch"] == 3 and meta["skipped"] == ["outc.bias", "outc.weight"]
    assert torch.equal(other.model.inc.conv1.conv.weight,
                       state.model.inc.conv1.conv.weight)


def test_pth_across_packages(tmp_path):
    """A ``.pth`` from JAX's ``export_torch_checkpoint`` gives the port the
    f32 logits of the same variables loaded directly (atol 1e-4), and the
    port's export reads back through JAX's ``import_torch_checkpoint`` to
    the port's own weights (SegNet: transposed convs and BN statistics)."""
    from mmr_tpu.models.factory import create_model as create_j
    from mmr_tpu.train import checkpoint as ckpt_j
    from mmr_tpu.train.state import TrainState as StateJ

    model_j, _ = create_j("segnet", classes=4, dtype=jnp.float32)
    shapes = jax.eval_shape(lambda k, x: model_j.init(k, x, train=False),
                            jax.random.key(0), jnp.zeros((1, 64, 64, 3)))
    v = _fill(shapes, np.random.RandomState(5))
    ckpt_j.export_torch_checkpoint(tmp_path / "j.pth", StateJ(
        params=v["params"], batch_stats=v["batch_stats"], opt_state=None), 9, 0.25)

    port = TrainState.create(create_model("segnet", classes=4, dtype=torch.float32,
                                          device="cpu"), build_optimizer("adam"))
    port.model.load_state_dict(from_jax_variables(v, port.model))
    x = torch.from_numpy(np.random.RandomState(6).rand(1, 64, 64, 3).astype(np.float32))
    with torch.no_grad():
        direct = port.model(x)
        for t in port.model.state_dict().values():
            t.zero_()
    port, meta = ckpt.import_torch_checkpoint(tmp_path / "j.pth", port)
    assert meta == {"epoch": 9, "validation_loss": 0.25}
    with torch.no_grad():
        np.testing.assert_allclose(port.model(x).numpy(), direct.numpy(), atol=1e-4)

    ckpt.export_torch_checkpoint(tmp_path / "p.pth", port, 2)
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
    back, meta = ckpt_j.import_torch_checkpoint(tmp_path / "p.pth", StateJ(
        params=zeros["params"], batch_stats=zeros["batch_stats"], opt_state=None))
    assert meta == {"epoch": 2}
    want = to_jax_variables(port.model.state_dict(), port.model)
    flat = lambda tree: np.concatenate([np.ravel(a) for a in jax.tree_util.tree_leaves(tree)])
    assert (jax.tree_util.tree_structure(back.params)
            == jax.tree_util.tree_structure(want["params"]))
    for tree in ("params", "batch_stats"):
        np.testing.assert_array_equal(flat(getattr(back, tree)), flat(want[tree]))


# ------------------------------------------------------------------- plots

def test_plots_decode_to_their_inputs(tmp_path):
    """Curve plots give their series back (``tEXt``) with each point drawn
    in its series' colour at :func:`point_pixel`; the triptych's panels are
    the image and the two id maps in the key's colours."""
    train, val = [1.5, 1.1, 0.8], [1.7, 1.3, 1.2]
    f = save_losses(train, val, tmp_path, loss_name="CE+Dice")
    meta = json.loads(png.read_text(f)["plot"])
    assert meta["series"] == {"Train CE+Dice": train, "Val CE+Dice": val}
    img = png.read(f)
    for vals, colour in zip((train, val), COLOURS):
        for x, y in zip(meta["x"], vals):
            r, c = point_pixel(x, y, meta["x_range"], meta["y_range"])
            assert tuple(img[r, c]) == colour
    hist = {"epoch": [1, 2], "train_iou": [0.1, 0.3], "val_iou": [0.2, 0.25]}
    f = save_accuracy_curves(hist, tmp_path)
    assert json.loads(png.read_text(f)["plot"])["series"] == {
        "Train IoU": [0.1, 0.3], "Val IoU": [0.2, 0.25]}

    rng = np.random.RandomState(2)
    images = rng.rand(3, 5, 7, 3).astype(np.float32)
    masks, preds = rng.randint(0, 10, (2, 3, 5, 7))
    f = save_triptychs(images, masks, preds, tmp_path / "t.png", max_samples=2)
    t, key = png.read(f), classes.sarrarp50_key()
    assert t.shape == (2 * 5 + GAP, 3 * 7 + 2 * GAP, 3)
    for i in range(2):
        r = i * (5 + GAP)
        np.testing.assert_array_equal(t[r:r + 5, :7],
                                      np.floor(images[i] * 255 + 0.5).astype(np.uint8))
        np.testing.assert_array_equal(t[r:r + 5, 7 + GAP:14 + GAP], key[masks[i]])
        np.testing.assert_array_equal(t[r:r + 5, 14 + 2 * GAP:], key[preds[i]])


# ---------------------------------------------------------------- the CLIs

def test_cli_needs_a_card_or_cpu(png_root, tmp_path, monkeypatch):
    """Without ``--device cpu`` and without a card both CLIs raise."""
    from mmr_tpu_torch.cli import eval_path_a, train_path_a

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_path_a.main(["--data_dir", str(png_root), "--save_dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        eval_path_a.main(["--data_dir", str(png_root), "--checkpoint_dir", str(tmp_path)])


def test_cli_train_then_eval(tmp_path):
    """``unet`` at 48×48 for 2 epochs on the CPU, then ``eval_path_a`` on
    its best-F1 checkpoint: the files exist and decode, and the evaluator's
    mean IoU equals an ``Evaluate`` run over the same predictions; then a
    ``--resume`` of the run for one more epoch, its head re-initialised."""
    from mmr_tpu_torch.cli import eval_path_a, train_path_a

    rng = np.random.RandomState(1)
    root = tmp_path / "data"
    for split in ("train", "val"):
        for i in range(8):
            mask = np.zeros((48, 48), np.uint8)
            mask[8:24, 8:40] = 1
            mask[30:40, 5:20] = 2
            img = np.eye(3, dtype=np.uint8)[mask] * 200 + 20
            img = img + rng.randint(0, 30, img.shape).astype(np.uint8)
            png.write(root / split / "images" / f"f{i}.png", img)
            png.write(root / split / "groundtruth" / f"f{i}.png", mask)
    run = tmp_path / "run"
    assert train_path_a.main([
        "--data_dir", str(root), "--model", "unet", "--epochs", "2",
        "--trainBatchSize", "8", "--valBatchSize", "8", "--lr", "1e-3",
        "--optimizer", "SGD", "--resizedHeight", "48", "--resizedWidth", "48",
        "--cropSize", "-1", "--save_dir", str(run), "--heavy_metric_interval", "1",
        "--device", "cpu"]) == 0
    log = (run / "train.log").read_text()
    assert "epoch 2/2" in log and "heavy metrics" in log
    assert png.read(run / "loss.png").shape == (400, 640, 3)
    assert len(json.loads(png.read_text(run / "accuracy.png")["plot"])["x"]) == 2
    assert png.read(run / "epoch_2_samples.png").shape == (4 * 48 + 3 * GAP,
                                                            3 * 48 + 2 * GAP, 3)
    assert json.loads((run / "checkpoints" / "best_f1.json").read_text())["epoch"] >= 1

    out = tmp_path / "eval"
    assert eval_path_a.main([
        "--data_dir", str(root), "--split", "val", "--model", "unet",
        "--checkpoint_dir", str(run / "checkpoints"), "--valBatchSize", "4",
        "--resizedHeight", "48", "--resizedWidth", "48", "--save_dir", str(out),
        "--device", "cpu"]) == 0
    report = json.loads((out / "eval_report.json").read_text())
    assert png.read(out / "eval_samples.png").shape == (4 * 48 + 3 * GAP, 3 * 48 + 2 * GAP, 3)

    model = create_model("unet", classes=10, device="cpu")
    state = TrainState.create(model, build_optimizer("adam"))
    ckpt.CheckpointManager(run / "checkpoints").load(state, "best_f1", weights_only=True)
    ev = Evaluate(10)
    model.eval()
    with torch.no_grad():
        for imgs, masks in PngFolderDataset(root, "val", (48, 48), -1, 10).epoch(4):
            ev.add_batch(model(torch.from_numpy(imgs)), torch.from_numpy(masks))
    assert report["mean_iou"] == ev.iou()[1]
    assert report["mean_f1"] == ev.mean_f1()
    assert np.isfinite(report["loss"])

    # --resume from the run: weights loaded, the head fresh, epoch 3 only
    epoch = json.loads((run / "checkpoints" / "best_f1.json").read_text())["epoch"]
    assert train_path_a.main([
        "--data_dir", str(root), "--model", "unet", "--epochs", str(epoch + 1),
        "--trainBatchSize", "8", "--valBatchSize", "8", "--resizedHeight", "48",
        "--resizedWidth", "48", "--save_dir", str(tmp_path / "again"),
        "--resume", str(run), "--save_samples", "False", "--device", "cpu"]) == 0
    log = (tmp_path / "again" / "train.log").read_text()
    assert f"(epoch {epoch})" in log and "re-initialized head 'outc'" in log
    assert f"epoch {epoch + 1}/{epoch + 1}" in log and f"epoch {epoch}/" not in log
