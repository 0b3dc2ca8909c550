"""The port's training modules held against the JAX package on the same
seeded inputs: losses, IoU reductions, the flat-buffer AdamW, LR
schedules and BatchNorm in train mode. f32 on both sides, so only
summation order differs; each bound is stated where it is checked."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from mmr_tpu_torch.losses import (blended_ce_dice_loss, cross_entropy_loss,
                                  dice_ce_loss, dice_loss)
from mmr_tpu_torch.metrics.iou import iou_score
from mmr_tpu_torch.models.layers import FusedBatchNorm, nchw
from mmr_tpu_torch.train.optim import FusedAdamW, build_optimizer
from mmr_tpu_torch.train.schedules import build_lr_schedule


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    """These tensors are small: two torch threads run the training test
    files as fast as eight, and leave the cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _logits_target(rng, nc=6, ignore=None):
    logits = (rng.randn(2, 8, 12, nc) * 2).astype(np.float32)
    target = rng.randint(0, nc, (2, 8, 12))
    if ignore is not None:
        target[0, :2] = ignore
    return logits, target


@pytest.mark.parametrize("name", ["ce", "ce_ignore_smooth", "dice",
                                  "dice_ignore", "dice_ce", "blended"])
def test_losses_match_jax(rng, name):
    """Loss values, rtol 1e-5 (f32 softmax and sums on both sides)."""
    from mmr_tpu.losses.ce import cross_entropy_loss as ce_j
    from mmr_tpu.losses.dice import dice_loss as dice_j
    from mmr_tpu.losses.dice_ce import blended_ce_dice_loss as blend_j
    from mmr_tpu.losses.dice_ce import dice_ce_loss as dice_ce_j

    logits, target = _logits_target(rng, ignore=255 if "ignore" in name else None)
    cases = {
        "ce": (cross_entropy_loss, ce_j, {}),
        "ce_ignore_smooth": (cross_entropy_loss, ce_j,
                             {"ignore_index": 255, "label_smoothing": 0.1}),
        "dice": (dice_loss, dice_j, {}),
        "dice_ignore": (dice_loss, dice_j, {"ignore_index": 4}),
        "dice_ce": (dice_ce_loss, dice_ce_j, {}),
        "blended": (blended_ce_dice_loss, blend_j, {"dice_loss_factor": 0.5}),
    }
    port, ref, kw = cases[name]
    got = float(port(torch.from_numpy(logits), torch.from_numpy(target), **kw))
    want = float(ref(jnp.asarray(logits), jnp.asarray(target), **kw))
    np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("reduction", ["micro", "macro", "micro-imagewise",
                                       "macro-imagewise", None])
def test_iou_reductions_match_jax(rng, reduction):
    """Every reduction of ``mmr_tpu.metrics.iou._reduce``, with a class
    absent from one image (zero_division), rtol 1e-6."""
    from mmr_tpu.metrics.iou import iou_score as iou_j

    stats = rng.randint(0, 20, (4, 3, 5)).astype(np.float32)
    stats[:, 1, 2] = 0.0
    got = iou_score(*torch.from_numpy(stats), reduction=reduction).numpy()
    want = np.asarray(iou_j(*jnp.asarray(stats), reduction=reduction))
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("clip, differential", [(12.0, False), (0.5, True)])
def test_fused_adamw_matches_jax(rng, clip, differential):
    """Two updates (bias corrections at count 1 and 2), with the clip
    active (0.5) or not (12) and the differential LR: params, moments, f32
    1e-6 relative to each buffer's largest value."""
    from mmr_tpu.train.optim import FusedAdamW as AdamJ

    names = ["encoder.w", "head.b", "head.w"]
    p0 = [rng.randn(*s).astype(np.float32) for s in [(3, 4), (5,), (2, 2)]]
    gs = [[rng.randn(*p.shape).astype(np.float32) for p in p0] for _ in range(2)]
    tree = lambda leaves: {"encoder": {"w": leaves[0]},
                           "head": {"b": leaves[1], "w": leaves[2]}}

    aj = AdamJ(weight_decay=1e-2, clip=clip, differential_lr=differential)
    pj = jax.tree_util.tree_map(jnp.asarray, tree(p0))
    sj = aj.init(pj)
    at = FusedAdamW(weight_decay=1e-2, clip=clip, differential_lr=differential)
    pt = [torch.from_numpy(p.copy()) for p in p0]
    st = at.init(pt)
    mult = at.lr_mult(names, pt)
    for g in gs:
        pj, sj = aj.apply_updates(pj, sj, tree([jnp.asarray(x) for x in g]), 1e-2)
        st = at.apply_updates(pt, st, [torch.from_numpy(x) for x in g], 1e-2, mult)
    for got, want in zip(pt, jax.tree_util.tree_leaves(pj)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6 * np.abs(np.asarray(want)).max())
    for k in ("mu", "nu"):
        want = np.asarray(sj[k])
        np.testing.assert_allclose(st[k].numpy(), want, rtol=1e-6,
                                   atol=1e-6 * np.abs(want).max())
    assert st["count"] == int(sj["count"]) == 2


def test_other_optimizers_raise():
    """The four names of the JAX surface build (SGD and RMSprop are held
    against JAX in ``test_torch_path_a_cli.py``); any other raises as
    JAX's ``build_optimizer`` does."""
    from mmr_tpu_torch.train.optim import FlatRMSprop, FlatSGD

    assert isinstance(build_optimizer("AdamW", clip_grad_norm=12.0), FusedAdamW)
    assert isinstance(build_optimizer("SGD", momentum=0.9), FlatSGD)
    assert isinstance(build_optimizer("rmsprop"), FlatRMSprop)
    for name in ("adagrad", "lamb"):
        with pytest.raises(ValueError, match="unknown optimizer"):
            build_optimizer(name)


@pytest.mark.parametrize("config", [
    {}, {"name": "PolynomialLR", "total_iters": 7, "power": 0.9},
    {"name": "StepLR", "step_size": 3, "gamma": 0.5},
    {"name": "StepLR", "lr_steps": 2}, {"name": "CosineAnnealingLR", "T_max": 9},
    {"name": "ConstantLR"}])
def test_lr_schedules_match_jax(config):
    from mmr_tpu.train.schedules import build_lr_schedule as sched_j

    got, want = build_lr_schedule(config, 1e-4, 12), sched_j(config, 1e-4, 12)
    for epoch in range(14):
        assert got(epoch) == pytest.approx(want(epoch), rel=1e-12), epoch


def test_batchnorm_train_mode_matches_flax(rng):
    """Train-mode outputs and the updated running statistics (biased
    variance, momentum 0.9) vs flax ``FusedBatchNorm``, f32, 1e-5."""
    from mmr_tpu.models.layers import FusedBatchNorm as BNJ

    C = 6
    x = (rng.randn(3, 5, 7, C) * 2 + 0.5).astype(np.float32)
    gamma = rng.uniform(0.5, 1.5, C).astype(np.float32)
    beta = rng.randn(C).astype(np.float32)
    mean0 = rng.randn(C).astype(np.float32) * 0.1
    var0 = rng.uniform(0.5, 1.5, C).astype(np.float32)
    bn_j = BNJ(use_running_average=False, momentum=0.9, epsilon=1e-5,
               dtype=jnp.float32)
    variables = {"params": {"scale": gamma, "bias": beta},
                 "batch_stats": {"mean": mean0, "var": var0}}
    y_j, upd = bn_j.apply(variables, jnp.asarray(x), mutable=["batch_stats"])

    bn = FusedBatchNorm(C).train()
    bn.load_state_dict({"weight": torch.from_numpy(gamma),
                        "bias": torch.from_numpy(beta),
                        "running_mean": torch.from_numpy(mean0),
                        "running_var": torch.from_numpy(var0)})
    with torch.no_grad():
        y = bn(nchw(torch.from_numpy(x))).permute(0, 2, 3, 1)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), rtol=1e-5, atol=1e-5)
    for k, name in (("mean", "running_mean"), ("var", "running_var")):
        np.testing.assert_allclose(getattr(bn, name).numpy(),
                                   np.asarray(upd["batch_stats"][k]),
                                   rtol=1e-5, atol=1e-6)
