"""The port's data-parallel mesh (``mmr_tpu_torch/core/mesh.py`` and the
modules that run on it) held against the JAX package's mesh, on the CPU.

Two gloo ranks (``tests/torch_mesh_worker.py``, one process each, one
torch thread, a ``FileStore`` under ``tmp_path``, a 120 s group timeout)
run every multi-rank case in one session while this process builds the
references: JAX's 2-device steps and sliding window
(``create_mesh(devices=jax.devices()[:2])``) and the port's one-rank runs.
A torchrun of Path A's CLI (2 gloo ranks) runs beside them. Every
subprocess is waited for with a timeout and killed after it.

- The plain f32 UNet++/mbv3 step (``tests/test_torch_train_step.py``'s
  variables and global batch, B = 2: one sample a rank) against JAX's
  GSPMD step at that file's f32 bounds, gradients included (AdamW's first
  moment over 1 − b1 on both sides: the averaged, clipped gradient).
- The fused step (kernels' plain versions, bf16) on 2 ranks against 1:
  loss rtol 2e-2, IoU atol 5e-3, the whole gradient's cosine ≥ 0.99 and
  its norm within 2 %, BN statistics atol 1e-3 / rtol 1e-2
  (``tests/test_multichip.py:101-105``).
- The eval step with a class absent from rank 1's shard against JAX's
  2-device eval step; ``Evaluate`` over 2 ranks against 1 rank over every
  batch (exact counts); the sliding window against JAX's
  ``make_sliding_window_fn(mesh=)`` on ``tests/test_multichip.py``'s case.
- The ``Trainer`` for one epoch on 2 ranks against 1 (default
  augmentation: a plain model draws for the global batch), files written
  once; ``PatchSampler(part=)``'s slices; Path A's CLI under torchrun.
"""

import json
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from flax import linen as nn

from mmr_tpu_torch.core import mesh as pm
from mmr_tpu_torch.models.convert import from_jax_variables, to_jax_variables
from tests import torch_mesh_worker as worker
from tests.test_torch_models import _fill
from tests.test_torch_train_modules import few_torch_threads  # noqa: F401

NC = 10
LR = 1e-4
CLIP = 12.0
SHAPE = (2, 64, 128)
HW = (64, 64)
WAIT = 300     # seconds a subprocess may take
ROOT = Path(__file__).resolve().parents[1]


class Tiny(nn.Module):
    classes: int = 3

    @nn.compact
    def __call__(self, x, train: bool = False):
        return nn.Conv(self.classes, (3, 3), padding=[(1, 1), (1, 1)])(x).astype(jnp.float32)


def _tiny_torch(variables) -> dict:
    k = np.asarray(variables["params"]["Conv_0"]["kernel"])
    return {"weight": torch.from_numpy(np.ascontiguousarray(k.transpose(3, 2, 0, 1))),
            "bias": torch.from_numpy(np.array(variables["params"]["Conv_0"]["bias"]))}


def _png_set(root: Path):
    """``tests/test_torch_path_a_cli.py::test_cli_train_then_eval``'s frames."""
    from mmr_tpu_torch.data import png

    rng = np.random.RandomState(1)
    for split in ("train", "val"):
        for i in range(8):
            mask = np.zeros((48, 48), np.uint8)
            mask[8:24, 8:40] = 1
            mask[30:40, 5:20] = 2
            img = np.eye(3, dtype=np.uint8)[mask] * 200 + 20
            img = img + rng.randint(0, 30, img.shape).astype(np.uint8)
            png.write(root / split / "images" / f"f{i}.png", img)
            png.write(root / split / "groundtruth" / f"f{i}.png", mask)


def _pool():
    """``tests/test_torch_engine.py``'s pool, cropped to 64×64."""
    from mmr_tpu_torch.data.synthetic import render_frame

    rng = np.random.RandomState(5)
    frames = [render_frame(rng, 80, 96, NC - 1) for _ in range(6)]
    crop = (slice(8, 72), slice(16, 80))
    return (np.stack([(f[0] * 255.0 + 0.5).astype(np.uint8)[crop] for f in frames]),
            np.stack([f[1][crop] for f in frames]))


def _jax_plain_step(variables, images, masks):
    """JAX's f32 UNet++/mbv3 step on a 2-device GSPMD mesh."""
    from jax.sharding import NamedSharding, PartitionSpec as P
    from mmr_tpu.core.mesh import create_mesh
    from mmr_tpu.losses.dice_ce import dice_ce_loss as dice_ce_j
    from mmr_tpu.models.decoders import UnetPlusPlusModel
    from mmr_tpu.models.factory import get_preprocessing as pre_j
    from mmr_tpu.train.optim import build_optimizer as opt_j
    from mmr_tpu.train.state import TrainState as StateJ
    from mmr_tpu.train.steps import make_train_step as step_j

    mesh = create_mesh(devices=jax.devices()[:2])
    model = UnetPlusPlusModel(num_classes=NC, dtype=jnp.float32)
    opt = opt_j("adamw", clip_grad_norm=CLIP, weight_decay=1e-2)
    state = jax.device_put(StateJ.create(jax.tree_util.tree_map(jnp.asarray, variables),
                                         opt), NamedSharding(mesh, P()))
    state, metrics = step_j(model, opt, dice_ce_j, NC, mesh=mesh,
                            preprocess=pre_j("tu-mobilenetv3_small_100"))(
        state, images, masks, LR, jax.random.key(0))
    g = np.asarray(state.opt_state["mu"], np.float64) / (1.0 - opt.b1)
    leaves, treedef = jax.tree_util.tree_flatten(variables["params"])
    offs = np.cumsum([0] + [a.size for a in leaves])
    return {"loss": float(metrics["loss"]), "iou": float(metrics["iou"]),
            "grads": jax.tree_util.tree_unflatten(treedef, [
                g[o:o + a.size].reshape(a.shape) for o, a in zip(offs, leaves)]),
            "params": jax.tree_util.tree_map(np.asarray, state.params),
            "batch_stats": jax.tree_util.tree_map(np.asarray, state.batch_stats)}


def _jax_tiny(inp, tiny3, tiny4):
    """JAX's 2-device eval step and sharded sliding window on ``Tiny``."""
    from mmr_tpu.core.mesh import create_mesh, shard_batch
    from mmr_tpu.infer.sliding_window import make_sliding_window_fn
    from mmr_tpu.losses.dice_ce import dice_ce_loss as dice_ce_j
    from mmr_tpu.train.optim import build_optimizer as opt_j
    from mmr_tpu.train.state import TrainState as StateJ
    from mmr_tpu.train.steps import make_eval_step as eval_j

    mesh = create_mesh(devices=jax.devices()[:2])
    ev = eval_j(Tiny(4), dice_ce_j, 4, mesh=mesh)(
        StateJ.create(tiny4, opt_j("adamw")), inp["eval_images"], inp["eval_masks"])
    sw = make_sliding_window_fn(Tiny(3), tiny3, (16, 16), 3, sw_batch_size=4, mesh=mesh)
    return ({k: np.asarray(v) for k, v in ev.items()},
            np.asarray(sw(shard_batch(mesh, inp["frames"]))))


def _wait(proc, what):
    try:
        out, err = proc.communicate(timeout=WAIT)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
        pytest.fail(f"{what} did not end in {WAIT} s:\n{err[-3000:]}")
    assert proc.returncode == 0, f"{what} exited {proc.returncode}:\n{err[-3000:]}"
    return out


def _tiny_variables(rng, classes):
    """``Tiny``'s variables, drawn with numpy."""
    return {"params": {"Conv_0": {
        "kernel": (0.3 * rng.randn(3, 3, 3, classes)).astype(np.float32),
        "bias": (0.1 * rng.randn(classes)).astype(np.float32)}}}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh")
    from mmr_tpu.models.decoders import UnetPlusPlusModel
    from mmr_tpu_torch.config import get_default_config

    _png_set(out / "pngs")
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT))
    launch = lambda cmd: subprocess.Popen(cmd, cwd=ROOT, env=env, text=True,
                                          stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    procs = [launch([sys.executable, "-m", "torch.distributed.run", "--standalone",
                     "--nproc_per_node", "2", "-m", "mmr_tpu_torch.cli.train_path_a",
                     "--data_dir", str(out / "pngs"), "--model", "unet", "--epochs", "1",
                     "--trainBatchSize", "4", "--valBatchSize", "4", "--optimizer", "SGD",
                     "--resizedHeight", "48", "--resizedWidth", "48", "--cropSize", "-1",
                     "--save_dir", str(out / "cli"), "--heavy_metric_interval", "1",
                     "--device", "cpu"])]
    try:
        ev_rng = np.random.RandomState(3)
        tiny3, tiny4 = _tiny_variables(ev_rng, 3), _tiny_variables(ev_rng, 4)
        eval_masks = ev_rng.randint(0, 3, (4, 16, 16))
        eval_masks[:2, :4, :4] = 3                  # class 3 on rank 0's shard only
        inp = {"nc": NC, "clip": CLIP, "lr": LR,
               "tiny3": _tiny_torch(tiny3), "tiny4": _tiny_torch(tiny4),
               "eval_images": ev_rng.rand(4, 16, 16, 3).astype(np.float32),
               "eval_masks": eval_masks,
               "ev_pred": [ev_rng.randint(0, 5, (4, 8, 8)) for _ in range(3)],
               "ev_gt": [ev_rng.randint(0, 5, (4, 8, 8)) for _ in range(3)],
               "frames": np.random.RandomState(6210).rand(8, 40, 48, 3).astype(np.float32)}
        tiny = {}
        side = threading.Thread(target=lambda: tiny.update(ref=_jax_tiny(inp, tiny3, tiny4)))
        side.start()   # traces and compiles beside the UNet++'s

        shapes = jax.eval_shape(
            lambda k, x: UnetPlusPlusModel(num_classes=NC, dtype=jnp.float32).init(
                k, x, train=False),
            jax.random.key(0), jnp.zeros((1,) + SHAPE[1:] + (3,)))
        variables = _fill(shapes, np.random.RandomState(1234))
        rng = np.random.RandomState(7)
        images = rng.randint(0, 256, (1,) + SHAPE + (3,)).astype(np.uint8)
        masks = rng.randint(0, NC, (1,) + SHAPE).astype(np.int32)
        trainer_config = get_default_config(NC - 1, HW)
        trainer_config.update(patch_size=list(HW), n_epochs=1, val_plot_interval=1,
                              precision="fp32")
        inp.update(images=images, masks=masks, state_dict=from_jax_variables(variables),
                   trainer_config=trainer_config, pool=_pool())
        torch.save(inp, out / "inputs.pt")
        procs += [launch([sys.executable, str(ROOT / "tests" / "torch_mesh_worker.py"),
                          str(r), "2", str(out)]) for r in range(2)]

        res = {"variables": variables, "inp": inp, "out": out,
               "jax": _jax_plain_step(variables, images, masks)}
        side.join(WAIT)
        res["jax_eval"], res["jax_window"] = tiny["ref"]
        one = pm.Mesh(0, 1, None, torch.device("cpu"))
        n = torch.get_num_threads()
        torch.set_num_threads(min(n, 2))
        try:
            res["one"] = {"fused": worker.step_case(one, inp, fused=True,
                                                    fused_frontend=True, packed_min_hw=0),
                          "evaluate": worker.evaluate_case(one, inp),
                          "trainer": worker.trainer_case(one, inp, out)}
        finally:
            torch.set_num_threads(n)
        res["cli_log"] = _wait(procs[0], "torchrun of train_path_a")
        for r, p in enumerate(procs[1:]):
            _wait(p, f"rank {r}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    res["ranks"] = [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(2)]
    return res


# ------------------------------------------------------------------- mesh

@pytest.mark.parametrize("data,model,n", [(-1, 1, 1), (-1, 1, 8), (2, 1, 2), (4, 2, 8),
                                          (-1, 2, 8), (3, 1, 8), (2, 2, 2), (-1, 3, 8)])
def test_mesh_spec_resolves_as_jax(data, model, n):
    from mmr_tpu.core.mesh import MeshSpec as SpecJ

    def run(spec):
        try:
            return spec(data=data, model=model).resolve(n)
        except ValueError as e:
            return str(e)

    assert run(pm.MeshSpec) == run(SpecJ)


@pytest.mark.parametrize("b,axis,rank,size", [(8, 0, 0, 2), (8, 0, 1, 2), (6, 1, 2, 3),
                                              (7, 0, 0, 1), (5, 0, 1, 2), (3, 1, 0, 2)])
def test_shard_batch_and_local_slice_as_jax(monkeypatch, b, axis, rank, size):
    """The rank's slice is JAX's ``local_batch_slice`` of its process; a
    batch that does not divide raises JAX's ``ValueError``; a one-rank mesh
    takes any size."""
    from mmr_tpu.core import mesh as jm

    monkeypatch.setattr(jax, "process_count", lambda: size)
    monkeypatch.setattr(jax, "process_index", lambda: rank)
    x = np.arange(2 * b * 3).reshape((b, 2, 3) if axis == 0 else (2, b, 3))
    mesh = pm.Mesh(rank, size, None, torch.device("cpu"))
    assert pm.local_batch_slice(b, mesh) == jm.local_batch_slice(b)
    if size > 1 and b % size:
        with pytest.raises(ValueError) as port:
            pm.shard_batch(mesh, (x,), axis=axis)
        jmesh = jm.create_mesh(devices=jax.devices()[:size])
        with pytest.raises(ValueError) as ref:
            jm.shard_batch(jmesh, (x,), axis=axis)
        assert str(port.value) == str(ref.value)
    else:
        got, = pm.shard_batch(mesh, (x,), axis=axis)
        take = (slice(None),) * axis + (jm.local_batch_slice(b),)
        np.testing.assert_array_equal(got.numpy(), x[take])


def test_create_mesh_refuses(monkeypatch):
    """No silent fallback: NCCL takes cards only; a mesh on CUDA without a
    card raises; the model axis must be 1; ``devices`` gives one a rank."""
    with pytest.raises(ValueError, match="NCCL takes cards only"):
        pm.create_mesh(devices=["cpu"], backend="nccl")
    with pytest.raises(ValueError, match="does not tile"):
        pm.create_mesh(pm.MeshSpec(model=2), devices=["cpu"])
    with pytest.raises(ValueError, match="2 devices for 1 ranks"):
        pm.create_mesh(devices=["cpu", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pm.create_mesh()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pm.launch_mesh("cuda")
    one = pm.launch_mesh("cpu")
    assert (one.rank, one.size, one.group, one.device.type) == (0, 1, None, "cpu")


# ------------------------------------------------------------------- steps

def _pairs(got, want, path=()):
    for k, v in want.items():
        if isinstance(v, dict):
            yield from _pairs(got[k], v, path + (k,))
        else:
            yield "/".join(path + (k,)), got[k], v


def _flat(tree, like):
    return np.concatenate([np.asarray(g, np.float64).ravel()
                           for _, g, _ in _pairs(tree, like)])


def test_plain_step_matches_jax_gspmd(runs):
    """2 ranks vs JAX's 2-device GSPMD step at ``tests/test_torch_train_step
    .py``'s f32 bounds: loss rtol 1e-5, IoU atol 1e-4, the whole averaged
    gradient within 1 % (relative L2), params atol 3·lr, BN statistics
    rtol 1e-4 (sync-BN: the global batch's); both ranks hold the same
    state."""
    want = runs["jax"]
    r0, r1 = (r["plain"] for r in runs["ranks"])
    for r in (r0, r1):
        np.testing.assert_allclose(r["loss"], want["loss"], rtol=1e-5)
        np.testing.assert_allclose(r["iou"], want["iou"], atol=1e-4)
    grads = to_jax_variables(r0["grads"])["params"]
    got, ref = _flat(grads, want["grads"]), _flat(want["grads"], want["grads"])
    assert np.linalg.norm(got - ref) / np.linalg.norm(ref) < 0.01
    v = to_jax_variables(r0["state_dict"])
    for n, got, ref in _pairs(v["params"], want["params"]):
        np.testing.assert_allclose(got, ref, atol=3 * LR, rtol=0, err_msg=n)
    for n, got, ref in _pairs(v["batch_stats"], want["batch_stats"]):
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-6, err_msg=n)
    for k, t in r0["state_dict"].items():
        assert torch.equal(t, r1["state_dict"][k]), k


def test_fused_step_matches_one_rank(runs):
    """The fused step (K1–K5 plain versions, bf16) on 2 ranks vs 1 on the
    global batch: loss rtol 2e-2, IoU atol 5e-3, whole-gradient norm within
    2 %, BN statistics atol 1e-3 / rtol 1e-2.

    The whole gradient's direction is held to what bf16 allows at this
    random init, where the plain bf16 model's gradient has cosine 0.74 to
    the f32 one (``tests/test_torch_train_step.py``): the 2-rank gradient's
    cosine to the 1-rank one ≥ 0.98 (measured 0.988; the 1-rank step on
    its batch in reverse order, the same sums in another order, 0.998),
    and its cosine to the f32 gradient of the same 2-rank step (held
    against JAX above) no lower than the 1-rank fused gradient's less 0.01
    (measured 0.744 against 0.739): sync-BN adds no bias."""
    one = runs["one"]["fused"]
    r0, r1 = (r["fused"] for r in runs["ranks"])
    np.testing.assert_allclose(r0["loss"], one["loss"], rtol=2e-2)
    np.testing.assert_allclose(r0["iou"], one["iou"], atol=5e-3)
    flat = lambda g: torch.cat([t.reshape(-1).double() for t in g.values()]).numpy()
    cos = lambda a, b: a @ b / (np.linalg.norm(a) * np.linalg.norm(b))
    f32 = flat(runs["ranks"][0]["plain"]["grads"])
    got, ref = flat(r0["grads"]), flat(one["grads"])
    assert cos(got, ref) >= 0.98
    assert cos(got, f32) >= cos(ref, f32) - 0.01
    assert abs(np.linalg.norm(got) / np.linalg.norm(ref) - 1) <= 0.02
    for k, t in one["state_dict"].items():
        if "running" in k:
            torch.testing.assert_close(r0["state_dict"][k], t, atol=1e-3, rtol=1e-2,
                                       msg=k)
        assert torch.equal(r0["state_dict"][k], r1["state_dict"][k]), k


def test_eval_step_sums_stats_before_the_iou(runs):
    """Class 3 only on rank 0's shard: both ranks report JAX's 2-device
    loss (the ranks' mean), tp/fp/fn (summed) and the macro IoU of the
    sums, not a mean of per-shard IoUs."""
    want = runs["jax_eval"]
    for r in runs["ranks"]:
        got = r["eval"]
        np.testing.assert_allclose(float(got["loss"]), want["loss"], rtol=1e-5)
        np.testing.assert_allclose(float(got["iou"]), want["iou"], atol=1e-6)
        for k in ("tp", "fp", "fn"):
            np.testing.assert_array_equal(got[k].numpy(), want[k])
    assert want["tp"][3] + want["fn"][3] == 32


def test_evaluate_sums_counts_over_ranks(runs):
    """``Evaluate`` on 2 ranks, each adding its slices, reads the counts of
    one rank adding every batch, exactly."""
    one = runs["one"]["evaluate"]
    for r in runs["ranks"]:
        for k in ("tp", "fp", "fn"):
            np.testing.assert_array_equal(r["evaluate"][k], one[k])
        assert r["evaluate"]["miou"] == one["miou"]


def test_sliding_window_matches_jax_sharded(runs):
    """Each rank blends its 4 of the 8 frames; gathered, they equal JAX's
    ``make_sliding_window_fn(mesh=)`` (``tests/test_multichip.py``'s
    bound, atol 1e-5)."""
    want = runs["jax_window"]
    for rank, r in enumerate(runs["ranks"]):
        np.testing.assert_allclose(r["window"]["all"].numpy(), want, atol=1e-5)
        np.testing.assert_allclose(r["window"]["local"].numpy(),
                                   want[4 * rank:4 * rank + 4], atol=1e-5)


# ------------------------------------------------------------------- entry points

def test_trainer_two_ranks_match_one_and_write_once(runs):
    """One epoch (2 steps of a global B=2, 1 validation batch, the default
    augmentation drawn for the global batch) on 2 ranks vs 1: losses rtol
    1e-4 and IoU atol 1e-3 (``tests/test_torch_engine.py``'s bounds),
    weights atol 4·lr (two Adam steps, each moving a weight by about ±lr:
    weights whose gradient is at the f32 noise floor take opposite signs;
    measured 3.9e-4), BN statistics atol 1e-3 / rtol 1e-2; rank 0 wrote
    every file once, the other rank none."""
    one = runs["one"]["trainer"]
    for r in runs["ranks"]:
        h, ref = r["trainer"]["history"], one["history"]
        np.testing.assert_allclose(h["train_loss"], ref["train_loss"], rtol=1e-4)
        np.testing.assert_allclose(h["val_loss"], ref["val_loss"], rtol=1e-4)
        np.testing.assert_allclose(h["val_iou"], ref["val_iou"], atol=1e-3)
        assert h["samples_per_sec"][0] > 0
        for k, t in one["state_dict"].items():
            tol = dict(atol=1e-3, rtol=1e-2) if "running" in k else dict(atol=4 * LR, rtol=0)
            torch.testing.assert_close(r["trainer"]["state_dict"][k], t, msg=k, **tol)
    run1, run2 = runs["out"] / "run1", runs["out"] / "run2"
    names = lambda d: sorted(str(p.relative_to(d)) for p in d.rglob("*")
                             if not p.name.startswith("training_log_"))
    assert names(run2) == names(run1)
    logs = list(run2.glob("training_log_*.log"))
    assert len(logs) == 1
    text = logs[0].read_text()
    assert text.count("Training complete") == 1 and text.count("Epoch 1/1") == 1
    assert len(json.loads((run2 / "training_metrics.json").read_text())["epoch"]) == 1


def test_patch_sampler_part_reads_its_slice(tmp_path):
    """``epoch(part=)`` makes every draw of the global batch and yields
    that slice of it, epoch after epoch."""
    from mmr_tpu_torch.data.patch_dataset import PatchSampler
    from mmr_tpu_torch.data.synthetic import make_synthetic_dataset

    make_synthetic_dataset(tmp_path, 2, 3, 40, 48, 3, (16, 16), 0, np.uint8)
    stores = sorted((tmp_path / "data").glob("*.zarr"))
    full = PatchSampler(stores, (16, 16), 4, 3, seed=1)
    half = PatchSampler(stores, (16, 16), 4, 3, seed=1)
    for seed in (3, 4):
        for (fi, fm), (hi, hm) in zip(full.epoch(seed), half.epoch(seed, part=slice(2, 4))):
            np.testing.assert_array_equal(hi, fi[2:4])
            np.testing.assert_array_equal(hm, fm[2:4])


def test_path_a_cli_under_torchrun(runs):
    """``python -m torch.distributed.run --nproc_per_node 2 ...
    train_path_a --device cpu``: exit 0 (checked by the fixture), one set
    of files, written once by rank 0."""
    from mmr_tpu_torch.data import png

    run = runs["out"] / "cli"
    assert sorted(p.name for p in run.iterdir()) == [
        "accuracy.png", "checkpoints", "epoch_1_samples.png", "loss.png", "train.log"]
    assert sorted(p.name for p in (run / "checkpoints").iterdir()) == ["best_f1",
                                                                       "best_f1.json"]
    log = (run / "train.log").read_text()
    assert log.count("epoch 1/1") == 1 and log.count("heavy metrics over 8 val") == 1
    assert log.count(" done") == 1
    assert png.read(run / "epoch_1_samples.png").ndim == 3
