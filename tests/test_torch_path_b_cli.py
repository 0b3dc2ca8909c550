"""Path B's three CLIs in the port on the CPU (``--device cpu``), on a small
synthetic Zarr dataset: ``mmr_torch_train_model`` (its split file byte-
equal to the JAX package's, its config, checkpoints and logs, a resume
with ``-c``), ``mmr_torch_infer`` on the saved test split
(``inference_report.json``) and ``mmr_torch_visualize`` (a triptych the
PNG reader decodes); the argument errors are JAX's ``parse_args``'s, and
without ``--device cpu`` and without a card every CLI raises."""

import json
import pickle
import shutil

import numpy as np
import pytest

from mmr_tpu_torch.cli import infer, train_model, visualize
from mmr_tpu_torch.config import create_config, read_config
from mmr_tpu_torch.data import png
from mmr_tpu_torch.data.synthetic import make_synthetic_dataset
from tests.test_torch_train_modules import few_torch_threads  # noqa: F401
from tests.test_torch_zarr_data import two_decode_threads  # noqa: F401

HW = (64, 64)
TRAIN = ["train-val-test", "3", "[64,64]", "--device", "cpu", "--batch_size", "2",
         "--n_epochs", "1", "--steps_per_epoch", "2", "--val_steps_per_epoch", "1"]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A 4-video uint8 dataset (5 frames of 72×96 each, 64×64 chunks)
    without a split file, and one epoch of the train CLI on it."""
    root = tmp_path_factory.mktemp("path_b")
    ds = make_synthetic_dataset(root / "ds", n_videos=4, frames_per_video=5,
                                height=72, width=96, n_classes=3, patch_size=HW,
                                seed=2, image_dtype=np.uint8)
    (ds / "train_val_test_split.json").unlink()
    run = root / "run"
    assert train_model.main([str(ds), str(run), *TRAIN]) == 0
    return ds, run


def test_train_cli_writes_its_run(trained, tmp_path):
    """The split is JAX's (scikit-learn's) over the same stores; the run
    holds the config, last / best checkpoints, the loss history and the
    metrics of one epoch."""
    from mmr_tpu.data.splits import create_split_files

    ds, run = trained
    shutil.copytree(ds / "data", tmp_path / "data")
    want = create_split_files(tmp_path, "train-val-test").read_bytes()
    assert (ds / "train_val_test_split.json").read_bytes() == want
    config = read_config(run / "config.yaml")
    assert config["patch_size"] == list(HW) and config["n_classes"] == 3
    assert config["dataset_path"] == str(ds) and config["steps_per_epoch"] == 2
    for name in ("last_model", "best_model"):
        assert (run / "checkpoints" / name).is_file()
        assert json.loads((run / "checkpoints" / f"{name}.json").read_text())["epoch"] == 1
    losses = pickle.loads((run / "loss_dict.pkl").read_bytes())
    assert len(losses["train"]) == len(losses["val"]) == 1
    assert np.all(np.isfinite(losses["train"] + losses["val"]))
    assert json.loads((run / "training_metrics.json").read_text())["epoch"] == [1]


def test_infer_and_visualize_cli(trained, capsys):
    """``mmr_torch_infer`` takes the saved test split (the dataset path is
    the training one) and writes the report; ``mmr_torch_visualize``
    writes a two-row triptych and, with ``--legend --architecture``, the
    class legend (each bar in ``matplotlib.cm.hot(i / (n − 1))`` at its
    centre, its label's glyphs beside it) and the architecture diagram
    (six boxes, five arrows, the model's parameter count) after printing
    the layer summary."""
    from matplotlib import cm

    from mmr_tpu_torch.data.classes import sarrarp50_names

    ds, run = trained
    assert infer.main([str(ds), str(run), "--device", "cpu", "--infer_batch_size", "2"]) == 0
    report = json.loads((run / "inference_report.json").read_text())
    assert set(report) == {"overall_mean_iou", "per_class_iou", "videos", "total_time_s"}
    test_ids = json.loads((ds / "train_val_test_split.json").read_text())["test"]
    assert sorted(report["videos"]) == sorted(test_ids)
    assert len(report["per_class_iou"]) == 3 and np.isfinite(report["overall_mean_iou"])
    assert (run / "test_plots_0" / "config.yaml").is_file()

    out = run / "vis"
    capsys.readouterr()
    assert visualize.main([str(run), str(ds / "data" / "data_001.zarr"), "--frames", "0", "4",
                           "--out", str(out), "--device", "cpu", "--legend",
                           "--architecture"]) == 0
    img = png.read(out / "prediction_triptychs.png")
    assert img.shape == (2 * 72 + 4, 3 * 96 + 2 * 4, 3)
    printed = capsys.readouterr().out
    assert "Model Architecture Summary:" in printed and "Total params" in printed

    legend = png.read(out / "class_legend.png")
    bars = json.loads(png.read_text(out / "class_legend.png")["legend"])["classes"]
    names = sarrarp50_names()[:4]   # the background and the 3 classes trained
    assert [b["label"] for b in bars] == [f"{i}: {n}" for i, n in enumerate(names)]
    for i, b in enumerate(bars):
        top, left, h, w = b["bar"]
        want = np.floor(np.array(cm.hot(i / (len(bars) - 1))[:3]) * 255 + 0.5)
        np.testing.assert_array_equal(legend[top + h // 2, left + w // 2], want)
        beside = legend[top:top + h, left + w + 4:]
        assert (beside == 0).all(-1).sum() > 20   # the label's black glyphs

    diagram = png.read(out / "architecture_diagram.png")
    meta = json.loads(png.read_text(out / "architecture_diagram.png")["diagram"])
    assert len(meta["boxes"]) == 6 and len(meta["arrows"]) == 5
    n_params = int(meta["boxes"][5]["label"].split()[0].replace(",", ""))
    assert str(n_params) in printed.replace(",", "")
    for box in meta["boxes"]:
        r, c, h, w = box["box"]
        np.testing.assert_array_equal(diagram[r + 3, c + 3], box["colour"])
        assert (diagram[r:r + h, c:c + w] == 0).all(-1).sum() > 2 * (h + w)


def test_train_cli_resumes(trained, tmp_path):
    """``-c`` refuses a changed override, as JAX does; with ``n_epochs``
    raised in ``config.yaml`` it resumes from ``last_model`` at epoch 2."""
    ds, run = trained
    again = tmp_path / "run"
    shutil.copytree(run, again)
    with pytest.raises(AssertionError, match="forbids config changes"):
        train_model.main([str(ds), str(again), *TRAIN[:3], "-c", "--device", "cpu",
                          "--batch_size", "4"])
    config = read_config(again / "config.yaml")
    create_config(dict(config, n_epochs=2, results_path=str(again)), again)
    assert train_model.main([str(ds), str(again), *TRAIN[:3], "-c", "--device", "cpu"]) == 0
    losses = pickle.loads((again / "loss_dict.pkl").read_bytes())
    assert len(losses["train"]) == 2
    assert losses["train"][0] == pickle.loads((run / "loss_dict.pkl").read_bytes())["train"][0]
    assert json.loads((again / "checkpoints" / "last_model.json").read_text())["epoch"] == 2
    assert any("Resumed from epoch 1" in f.read_text()
               for f in again.glob("training_log_*.log"))


@pytest.mark.parametrize("case", ["fold_missing", "fold_extra", "results_exist",
                                  "bad_splitting"])
def test_train_cli_argument_errors_match_jax(trained, tmp_path, capsys, case):
    from mmr_tpu.cli import train_model as jax_train_model

    ds, run = trained
    argv = {"fold_missing": [str(ds), str(tmp_path / "r"), "5-fold", "3", "[64,64]"],
            "fold_extra": [str(ds), str(tmp_path / "r"), "train-val-test", "3", "[64,64]",
                           "-f", "1"],
            "results_exist": [str(ds), str(run), "train-val-test", "3", "[64,64]"],
            "bad_splitting": [str(ds), str(tmp_path / "r"), "3-fold", "3", "[64,64]"]}[case]
    errors = []
    for parse in (train_model.parse_args, jax_train_model.parse_args):
        with pytest.raises(SystemExit) as e:
            parse(argv)
        errors.append((e.value.code, capsys.readouterr().err.splitlines()[-1]
                       .split("error: ")[1]))
    assert errors[0] == errors[1]


def test_clis_raise_without_a_card(trained, tmp_path):
    """Without ``--device cpu`` the CLIs ask for CUDA, which this machine
    lacks: each raises before it writes anything."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    ds, run = trained
    for main, argv in ((train_model.main, [str(ds), str(tmp_path / "r"), *TRAIN[:3]]),
                       (infer.main, [str(ds), str(run)]),
                       (visualize.main, [str(run), str(ds)])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main(argv)
    assert not (tmp_path / "r").exists()
