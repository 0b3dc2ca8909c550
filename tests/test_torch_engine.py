"""Path B's training engine in the port (``mmr_tpu_torch/train/engine.py::
Trainer``, ``data/pipeline.py``, ``monitor/``, Path B's checkpoints,
``run_inference(save_plots=True)``) on the CPU.

- One epoch of JAX's ``Trainer`` and one of the port's, on the same
  variables (``jax.eval_shape`` of the init filled from seeded numpy, BN
  away from identity, carried across by ``Trainer.init_state(variables)``),
  the same duck-typed sampler (uint8 batches), ``precision: fp32``, every
  transform off: UNet++ over mbv3 at 64×64, B=2, 2 train steps, 1 val
  batch. Both feed the f32 model the uint8 path's bf16-normalized batch.
  Bounds: train loss rtol 1e-4 (measured 5.2e-6), val loss rtol 1e-4
  (measured 6.9e-6): f32 on both sides, but Adam's first update moves
  each weight by about ±lr along the sign of its gradient, and weights
  whose gradient is at the f32 noise floor (the analytically zero mbv3
  ``bn3`` biases) take opposite signs on the two sides; per-class IoU
  atol 2e-3 (measured 1.26e-3) and macro IoU atol 1e-3 (measured
  1.3e-4): argmax flips of near-tied pixels. JAX's plots and checkpoints
  are not written, and its state is committed to the step's sharding so
  that its train step compiles once.
- Two epochs of the port with the default augmentation, then a resume to
  a third, against three straight epochs: loss history and weights
  bit-equal.
"""

import json
import pickle
import threading

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from mmr_tpu_torch.config import get_default_config, read_config
from mmr_tpu_torch.data import png
from mmr_tpu_torch.data.pipeline import PrefetchIterator, microbatch_stacker
from mmr_tpu_torch.train.engine import Trainer
from tests.test_torch_models import _fill
from tests.test_torch_train_modules import few_torch_threads  # noqa: F401

HW = (64, 64)
NC = 9          # classes without the background


class Sampler:
    """JAX's ``PatchSampler`` interface over a fixed pool: ``epoch(seed)``
    yields ``n`` batches of ``batch`` uint8 frames and masks picked by the
    seed."""

    def __init__(self, images, masks, batch, n):
        self.images, self.masks, self.batch, self.n = images, masks, batch, n

    def __len__(self):
        return self.n

    def epoch(self, epoch_seed):
        rng = np.random.RandomState(epoch_seed)
        for _ in range(self.n):
            idx = rng.randint(0, len(self.images), self.batch)
            yield self.images[idx], self.masks[idx]


@pytest.fixture(scope="module")
def pool():
    from mmr_tpu_torch.data.synthetic import render_frame

    rng = np.random.RandomState(5)
    frames = [render_frame(rng, 80, 96, NC) for _ in range(6)]
    images = np.stack([(f[0] * 255.0 + 0.5).astype(np.uint8) for f in frames])
    masks = np.stack([f[1] for f in frames])
    return images, masks


def _samplers(pool, train_n=2, batch=2):
    images, masks = pool
    y0, x0 = (80 - HW[0]) // 2, (96 - HW[1]) // 2
    crop = (slice(None), slice(y0, y0 + HW[0]), slice(x0, x0 + HW[1]))
    return (Sampler(images[crop], masks[crop], batch, train_n),
            Sampler(images[crop], masks[crop], batch, 1))


def _config(results, **kw):
    cfg = get_default_config(NC, HW)
    cfg.update(results_path=str(results), patch_size=list(HW), n_epochs=1,
               val_plot_interval=1, precision="fp32")
    cfg.update(kw)
    return cfg


def _all_off(cfg):
    cfg["transformations"].update({k: False for k in (
        "scaling", "rotation", "gaussian_noise", "gaussian_blur", "low_resolution",
        "brightness", "contrast", "gamma", "mirror")})
    return cfg


@pytest.fixture(scope="module")
def versus_jax(pool, tmp_path_factory):
    """One epoch of each trainer from the same variables, then each one's
    validation pass again for its per-class IoU."""
    from jax.sharding import NamedSharding, PartitionSpec
    from mmr_tpu.core.mesh import create_mesh
    from mmr_tpu.train import engine as jax_engine
    from mmr_tpu.train.state import TrainState as JaxState

    # no triptychs: JAX's predict runs its model op by op (~20 s on the CPU)
    jt = jax_engine.Trainer(
        _all_off(_config(tmp_path_factory.mktemp("jax"), val_plot_interval=0)),
        mesh=create_mesh(devices=jax.devices()[:1]))
    shapes = jax.eval_shape(lambda k, x: jt.model.init(k, x, train=False),
                            jax.random.key(0), jnp.zeros((1, *HW, 3)))
    variables = _fill(shapes, np.random.RandomState(1234))
    # committed to the step's replicated sharding, as the step returns it:
    # one compile of JAX's train step, not one for each of its two calls
    jt.state = jax.device_put(
        JaxState.create(jax.tree_util.tree_map(jnp.asarray, variables), jt.optimizer),
        NamedSharding(jt.mesh, PartitionSpec()))
    with pytest.MonkeyPatch.context() as mp:
        # only the numbers are compared: JAX's plots (matplotlib) and
        # checkpoints (orbax) are not written (~3 s on the CPU)
        mp.setattr(jax_engine, "save_losses", lambda *a: None)
        mp.setattr(jax_engine, "save_dashboard", lambda *a: None)
        mp.setattr(jt.checkpoints, "save", lambda *a: True)
        want = jt.train(*_samplers(pool))
    want_val = jt.validate_one_epoch(_samplers(pool)[1], 1)

    pt = Trainer(_all_off(_config(tmp_path_factory.mktemp("port"), val_plot_interval=0)),
                 device="cpu")
    pt.init_state(variables)
    got = pt.train(*_samplers(pool))
    got_val = pt.validate_one_epoch(_samplers(pool)[1], 1)
    return jt, pt, variables, want, got, want_val, got_val


def test_one_epoch_matches_jax_trainer(versus_jax):
    jt, pt, _, want, got, want_val, got_val = versus_jax
    assert not getattr(pt.model, "fused", False)
    np.testing.assert_allclose(got["train_loss"], want["train_loss"], rtol=1e-4)
    np.testing.assert_allclose(got["val_loss"], want["val_loss"], rtol=1e-4)
    np.testing.assert_allclose(got["train_iou"], want["train_iou"], atol=1e-3)
    np.testing.assert_allclose(got["val_iou"], want["val_iou"], atol=1e-3)
    np.testing.assert_allclose(got_val[0], want_val[0], rtol=1e-4)
    np.testing.assert_allclose(got_val[2], want_val[2], atol=2e-3)
    assert got["lr"] == want["lr"]
    assert pt.state.step == int(jt.state.step) == 2


def test_history_keys_and_model_summary_match_jax(versus_jax, tmp_path):
    """The monitor's ``history`` keys (in order) and ``model_summary``'s
    text equal JAX's on the same model."""
    from mmr_tpu.monitor import TrainingMonitor as JaxMonitor
    from mmr_tpu.monitor import model_summary as jax_summary
    from mmr_tpu_torch.monitor import model_summary

    jt, pt, variables, want, got, _, _ = versus_jax
    assert list(got) == list(want) == list(JaxMonitor(tmp_path, 1).history)
    assert model_summary(pt.model) == jax_summary(jt.model, {"params": variables["params"]})
    assert model_summary(pt.model).splitlines()[-2].endswith("3,714,090")


@pytest.fixture(scope="module")
def resumed(pool, tmp_path_factory):
    """Three straight epochs, and two plus a resume to three, with the
    default augmentation (low resolution on too), a profile of epoch 2."""
    def run(path, n_epochs, resume=False):
        cfg = _config(path, n_epochs=n_epochs, profile_epochs=[2])
        cfg["transformations"]["low_resolution"] = True
        tr = Trainer(cfg, device="cpu")
        if resume:
            assert tr.maybe_resume()
        else:
            assert not tr.maybe_resume()
        return tr, tr.train(*_samplers(pool))

    straight = tmp_path_factory.mktemp("straight")
    split = tmp_path_factory.mktemp("split")
    full, _ = run(straight, 3)
    first, hist2 = run(split, 2)
    resumed, hist3 = run(split, 3, resume=True)
    return straight, split, full, first, hist2, resumed, hist3


def test_two_epoch_run_writes_every_artifact(resumed):
    _, split, _, first, hist2, _, _ = resumed
    assert hist2["epoch"] == [1, 2] and all(np.isfinite(hist2["train_loss"]))
    assert all(0.0 < c <= 100.0 for c in hist2["cpu_percent"])   # /proc/stat deltas
    assert hist2["device_mem_mb"] == [0.0, 0.0]                  # no CUDA device used
    metrics = json.loads((split / "training_metrics.json").read_text())
    assert set(metrics) == set(hist2)
    log = next(split.glob("training_log_*.log")).read_text()
    assert "Model Architecture Summary" in log and "Training complete" in log
    assert "New best model" in log
    assert len(pickle.loads((split / "loss_dict.pkl").read_bytes())["train"]) == 3
    for f in ("plots/loss.png", "training_dashboard.png", "plots/epoch_1.png",
              "plots/epoch_2.png"):
        assert png.read(split / f).ndim == 3, f
    dash = json.loads(png.read_text(split / "training_dashboard.png")["dashboard"])
    assert [p["title"] for p in dash["panels"]][:2] == ["Loss", "IoU"]
    for name in ("last_model", "best_model"):
        assert (split / "checkpoints" / name).is_file()
        meta = json.loads((split / "checkpoints" / f"{name}.json").read_text())
        assert set(meta) == {"epoch", "validation_loss"}
    assert (split / "profile" / "epoch_2.trace.json").stat().st_size > 0


def test_resume_is_bit_equal_to_an_uninterrupted_run(resumed):
    straight, split, full, _, _, resumed_tr, hist3 = resumed
    assert resumed_tr.start_epoch == 3 and hist3["epoch"] == [3]
    a = pickle.loads((straight / "loss_dict.pkl").read_bytes())
    b = pickle.loads((split / "loss_dict.pkl").read_bytes())
    assert a == b and len(a["train"]) == 3
    for (k, x), y in zip(full.model.state_dict().items(),
                         resumed_tr.model.state_dict().values()):
        assert torch.equal(x, y), k
    for k in ("mu", "nu"):
        assert torch.equal(full.state.opt_state[k], resumed_tr.state.opt_state[k])
    assert full.state.step == resumed_tr.state.step == 6


def test_best_model_follows_the_lowest_validation_loss(resumed, tmp_path):
    from mmr_tpu_torch.train.checkpoint import CheckpointManager

    straight, _, full, *_ = resumed
    val = pickle.loads((straight / "loss_dict.pkl").read_bytes())["val"]
    best = json.loads((straight / "checkpoints" / "best_model.json").read_text())
    assert best == {"epoch": int(np.argmin(val)) + 1, "validation_loss": min(val)}
    cm = CheckpointManager(tmp_path)
    state = full.state
    assert cm.save(state, 1, 0.5)
    assert not cm.save(state, 2, 0.7)
    meta = lambda n: json.loads((tmp_path / f"{n}.json").read_text())
    assert meta("best_model")["epoch"] == 1 and meta("last_model")["epoch"] == 2
    assert cm.save(state, 3, 0.4) and meta("best_model")["epoch"] == 3
    loaded, m = cm.load(state, "best_model")
    assert m == {"epoch": 3, "validation_loss": 0.4}


def test_prefetch_surfaces_errors_and_closes():
    def bad():
        yield 1
        raise KeyError("sampler broke")

    it = PrefetchIterator(bad(), lambda x: x * 2)
    with pytest.raises(KeyError, match="sampler broke"):
        assert list(it) == [2]
    it.close()
    assert not it.thread.is_alive()

    started = threading.Event()

    def endless():
        started.set()
        i = 0
        while True:
            yield i
            i += 1

    it = PrefetchIterator(endless(), lambda x: x, depth=2, ready=lambda x: -x)
    assert next(iter(it)) == 0 and next(iter(it)) == -1
    it.close()   # the worker was blocked on a full queue
    assert started.is_set() and not it.thread.is_alive()


def test_microbatch_stacker_matches_jax():
    from mmr_tpu.data.pipeline import microbatch_stacker as jax_stacker

    rng = np.random.RandomState(0)
    batches = [(rng.rand(2, 4, 4, 3), rng.randint(0, 3, (2, 4, 4))) for _ in range(5)]
    got, want = list(microbatch_stacker(batches, 2)), list(jax_stacker(batches, 2))
    assert len(got) == len(want) == 2
    for (a, b), (c, d) in zip(got, want):
        assert a.shape == (2, 2, 4, 4, 3)
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)


def test_config_knobs_reach_the_step(tmp_path):
    """``per_sample_spatial``, ``heavy_augmentation`` and the rest reach the
    step's ``AugmentConfig``; ``dummy_2d`` and heavy's batch-shared draws
    are logged (``tests/test_config.py:123``); the config's JAX ``packed``
    name maps to ``fused`` (refused off the card's bf16 path)."""
    cfg = _config(tmp_path)
    cfg["transformations"].update(per_sample_spatial=True, dummy_2d=True,
                                  heavy_augmentation=True, gamma=False)
    cfg["model"] = {"arch": "Unet", "encoder_name": "resnet18",
                    "encoder_weights": None, "in_channels": 3, "classes": 10}
    tr = Trainer(cfg, device="cpu")
    assert tr.augment.per_sample_spatial and tr.augment.heavy and not tr.augment.gamma
    assert tr.augment.patch_size == HW
    text = next(tmp_path.glob("training_log_*.log")).read_text()
    assert "dummy_2d" in text
    assert "heavy_augmentation" not in text    # per-sample draws: no warning
    cfg["transformations"]["per_sample_spatial"] = False
    Trainer(cfg, device="cpu")
    assert "heavy_augmentation=True" in "".join(
        p.read_text() for p in tmp_path.glob("training_log_*.log"))
    cfg = _config(tmp_path / "b")
    cfg["model"]["packed"] = True
    with pytest.raises(ValueError, match="bf16"):
        Trainer(cfg, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            Trainer(_config(tmp_path / "c"))


def test_run_inference_writes_numbered_plot_dirs(versus_jax, tmp_path):
    from mmr_tpu_torch.infer.evaluator import run_inference
    from tests.test_torch_infer import _Videos

    _, pt, *_ = versus_jax
    data = _Videos(np.random.RandomState(2), n_frames=3, hw=(64, 96))
    config = {"n_classes": NC, "patch_size": (64, 64), "sw_overlap": 0.5,
              "results_path": str(tmp_path), "model": {"arch": "UnetPlusPlus"}}
    for i in range(2):
        report = run_inference(pt.model, data, config, preprocess=pt.preprocess,
                               device="cpu")
        out = tmp_path / f"test_plots_{i}"
        back = read_config(out / "config.yaml")
        assert back == {**config, "patch_size": [64, 64]}
        assert sorted(p.name for p in out.glob("*.png")) == [
            "video_0_0-2.png", "video_1_0-2.png"]
        assert png.read(out / "video_0_0-2.png").shape == (2 * 64 + 4, 3 * 96 + 8, 3)
    assert np.isfinite(report["overall_mean_iou"])
