"""Path A's canonical configuration in the port — smp UNet++ over ResNet-18
(``smp_UNet++``), 10 classes, Adam with coupled L2, the blended CE + Dice
loss (factor 0.5), the Path-A augmentation, ``Evaluate`` and
``evaluate_checkpoint`` — held against the JAX package on the same
variables and inputs (f32, 2 × 64 × 64 at full channel width).

The JAX variables come from ``jax.eval_shape`` of the model's init, filled
from seeded numpy with BN away from identity, and reach the port through
``from_jax_variables``. One JAX program, compiled once in the module
fixture, gives the encoder's features, the eval logits and one train step.
The step's gradients are read from its Adam first moment, which after one
step with coupled L2 is ``(1 − b1)·(g + wd·p)``.
"""

import functools

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from mmr_tpu_torch.losses import blended_ce_dice_loss
from mmr_tpu_torch.models import create_model
from mmr_tpu_torch.models.convert import from_jax_variables, to_jax_variables
from mmr_tpu_torch.train.optim import FusedAdamW, build_optimizer
from mmr_tpu_torch.train.state import TrainState
from mmr_tpu_torch.train.steps import make_train_step
from tests.test_torch_models import _fill
from tests.test_torch_train_modules import few_torch_threads  # noqa: F401
from tests.test_torch_train_step import _flat, _pairs

NC = 10
LR, WD = 1e-3, 1e-5          # train_sarrarp50.sh: Adam, lr 1e-3, wd 1e-5
SHAPE = (2, 64, 64)
LOSS = functools.partial(blended_ce_dice_loss, dice_loss_factor=0.5)


def _rel_to_max(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.fixture(scope="module")
def case():
    from mmr_tpu.losses.dice_ce import blended_ce_dice_loss as loss_j
    from mmr_tpu.models.encoders import get_encoder
    from mmr_tpu.models.factory import create_model as create_j
    from mmr_tpu.train.optim import build_optimizer as opt_j
    from mmr_tpu.train.state import TrainState as StateJ
    from mmr_tpu.train.steps import make_train_step as step_j

    model, _ = create_j("smp_UNet++", classes=NC, dtype=jnp.float32)
    shapes = jax.eval_shape(lambda k, x: model.init(k, x, train=False),
                            jax.random.key(0), jnp.zeros((1,) + SHAPE[1:] + (3,)))
    variables = _fill(shapes, np.random.RandomState(1234))
    rng = np.random.RandomState(7)
    images = rng.rand(1, *SHAPE, 3).astype(np.float32)
    masks = rng.randint(0, NC, (1,) + SHAPE).astype(np.int32)

    enc = get_encoder("resnet18").build(jnp.float32, "encoder")
    opt = opt_j("adam", weight_decay=WD)
    step = step_j(model, opt, functools.partial(loss_j, dice_loss_factor=0.5), NC)

    @jax.jit
    def program(v, state, images, masks):
        x = images[0]
        feats = enc.apply({k: v[k]["encoder"] for k in ("params", "batch_stats")},
                          x, train=False)
        logits = model.apply(v, x, train=False)
        return feats, logits, step(state, images, masks, LR, jax.random.key(0))

    fresh = jax.tree_util.tree_map(jnp.asarray, variables)
    feats, logits, (state, metrics) = program(
        fresh, StateJ.create(fresh, opt), jnp.asarray(images), jnp.asarray(masks))
    adam = [s for s in jax.tree_util.tree_leaves(
        state.opt_state, is_leaf=lambda n: hasattr(n, "mu")) if hasattr(s, "mu")][0]
    grads = jax.tree_util.tree_map(
        lambda mu, p: np.asarray(mu, np.float64) / (1 - 0.9) - WD * p,
        adam.mu, variables["params"])
    to_np = functools.partial(jax.tree_util.tree_map, np.asarray)
    return {"variables": variables, "images": images, "masks": masks,
            "feats": [np.asarray(f) for f in feats], "logits": np.asarray(logits),
            "loss": float(metrics["loss"]), "iou": float(metrics["iou"]),
            "grads": grads, "params": to_np(state.params),
            "batch_stats": to_np(state.batch_stats)}


def _port(case, dtype=torch.float32):
    model = create_model("smp_UNet++", classes=NC, device="cpu", dtype=dtype)
    model.load_state_dict(from_jax_variables(case["variables"]))
    return model


def test_weights_carry_across(case):
    """The port's ``smp_UNet++`` takes the JAX tree (ResNet names
    ``conv1``, ``bn1``, ``layer{i}_{b}/…``, ``downsample_*``) whole and
    gives it back unchanged; the zoo's other strings build other models
    (``tests/test_torch_zoo.py``), and Segformer still raises."""
    model = _port(case)
    assert model.encoder_name == "resnet18"
    back = to_jax_variables(model.state_dict())
    for tree in ("params", "batch_stats"):
        pairs = list(_pairs(back[tree], case["variables"][tree]))
        assert len(pairs) == len(jax.tree_util.tree_leaves(case["variables"][tree]))
        for n, got, want in pairs:
            np.testing.assert_array_equal(got, want, err_msg=n)
    for arch in ("segnet", "unet", "resnet18", "smp_unet18", "smp_DeepLabV3+",
                 "smp_MANet"):
        assert type(create_model(arch, device="cpu")) is not type(model)
    with pytest.raises(NotImplementedError):
        create_model("Segformer", device="cpu")
    with pytest.raises(NotImplementedError):
        create_model("smp_UNet++", device="cpu", fused=True, fused_frontend=True)


def test_resnet18_encoder_matches_jax(case):
    """The five features of the eval-mode encoder: max|Δ| / max|ref| < 1e-4
    (f32 on both sides, summation order only)."""
    model = _port(case)
    x = torch.from_numpy(case["images"][0]).permute(0, 3, 1, 2)
    with torch.no_grad():
        feats = model.encoder(x)
    assert len(feats) == 5
    for f, want in zip(feats, case["feats"]):
        got = f.permute(0, 2, 3, 1).numpy()
        assert got.shape == want.shape
        assert _rel_to_max(got, want) < 1e-4


def test_plain_f32_forward_matches_jax(case):
    """The whole UNet++/ResNet-18 eval forward vs JAX ``packed=False``:
    max|Δ| / max|ref| < 1e-4."""
    with torch.no_grad():
        got = _port(case)(torch.from_numpy(case["images"][0])).numpy()
    assert got.shape == SHAPE + (NC,) and got.dtype == np.float32
    assert _rel_to_max(got, case["logits"]) < 1e-4


def test_path_a_step_matches_jax(case):
    """One f32 Path-A step (Adam with coupled L2, the blended loss, no
    augmentation) vs the JAX step: loss rtol 1e-5; the whole gradient
    within 1 % relative L2 (f32 reordering amplified by train-mode BN over
    the few values of the coarse rows); every parameter after Adam within
    2·lr (Adam's first step moves a weight by about ±lr); BN running
    statistics within 1e-4 of each leaf's largest value (a mean near 0
    has no relative precision)."""
    model = _port(case)
    opt = build_optimizer("Adam", weight_decay=WD)
    step = make_train_step(model, opt, LOSS, NC, device="cpu")
    state, metrics = step(TrainState.create(model, opt),
                          torch.from_numpy(case["images"]),
                          torch.from_numpy(case["masks"]), LR)
    assert state.step == 1
    np.testing.assert_allclose(float(metrics["loss"]), case["loss"], rtol=1e-5)
    np.testing.assert_allclose(float(metrics["iou"]), case["iou"], atol=1e-4)
    grads = to_jax_variables({n: p.grad for n, p in model.named_parameters()})
    got, want = _flat(grads["params"], case["grads"]), _flat(case["grads"], case["grads"])
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < 1e-2
    v = to_jax_variables(model.state_dict())
    for n, got, want in _pairs(v["params"], case["params"]):
        np.testing.assert_allclose(got, want, atol=2 * LR, rtol=0, err_msg=n)
    for n, got, want in _pairs(v["batch_stats"], case["batch_stats"]):
        np.testing.assert_allclose(got, want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max(), err_msg=n)


@pytest.mark.parametrize("clip,differential", [(None, False), (1.0, True)])
def test_adam_matches_optax(rng, clip, differential):
    """``build_optimizer("adam")`` vs the JAX optax chain (clip →
    add_decayed_weights → scale_by_adam, the LR-free direction scaled by
    −lr·mult) over three steps on a small tree: rtol 1e-5."""
    from mmr_tpu.train.optim import build_optimizer as opt_j

    tree = {"encoder": {"w": rng.randn(3, 4).astype(np.float32)},
            "head": {"b": rng.randn(5).astype(np.float32)}}
    grads = [jax.tree_util.tree_map(lambda a: rng.randn(*a.shape).astype(np.float32),
                                    tree) for _ in range(3)]
    kw = dict(clip_grad_norm=clip, differential_lr=differential, weight_decay=0.1)
    oj = opt_j("adam", **kw)
    pj = jax.tree_util.tree_map(jnp.asarray, tree)
    sj = oj.init(pj)
    for g in grads:
        pj, sj = oj.apply_updates(pj, sj, jax.tree_util.tree_map(jnp.asarray, g), LR)

    ot = build_optimizer("adam", **kw)
    assert isinstance(ot, FusedAdamW) and not ot.decoupled_decay
    names = ["encoder.w", "head.b"]
    params = [torch.from_numpy(tree["encoder"]["w"].copy()),
              torch.from_numpy(tree["head"]["b"].copy())]
    st = ot.init(params)
    mult = ot.lr_mult(names, params)
    for g in grads:
        st = ot.apply_updates(params, st, [torch.from_numpy(g["encoder"]["w"]),
                                           torch.from_numpy(g["head"]["b"])], LR, mult)
    np.testing.assert_allclose(params[0].numpy(), np.asarray(pj["encoder"]["w"]), rtol=1e-5)
    np.testing.assert_allclose(params[1].numpy(), np.asarray(pj["head"]["b"]), rtol=1e-5)


def test_path_a_augment_matches_jax_draws(rng):
    """``apply_path_a`` fed JAX's own draws vs ``augment_path_a_batch``:
    masks and the spatial transforms exactly, the photometric ones within
    1e-6. A 5 × 8 canvas puts the rotation's centre on half pixels, so the
    same-canvas crop, the zero fill and the rounding half away from zero
    all count."""
    from mmr_tpu.data.augment import augment_path_a_batch as aug_j
    from mmr_tpu_torch.data.augment import PathADraws, apply_path_a

    b, h, w = 8, 5, 8
    images = rng.rand(b, h, w, 3).astype(np.float32)
    masks = rng.randint(0, NC, (b, h, w)).astype(np.int32)
    key = jax.random.key(3)
    want_i, _, want_m = aug_j(key, jnp.asarray(images),
                              jnp.zeros_like(jnp.asarray(images)), jnp.asarray(masks))

    def draws(k):   # augment.py:515-538, per sample
        ks = jax.random.split(k, 7)
        bern = lambda i: jax.random.bernoulli(ks[i], 0.5)
        unif = lambda i: jax.random.uniform(ks[i], (), minval=0.9, maxval=1.1)
        return bern(0), bern(1), bern(2), unif(3), bern(4), unif(5), bern(6)

    d = jax.vmap(draws)(jax.random.split(key, b))
    assert all(0 < int(np.asarray(d[i]).sum()) < b for i in (0, 1, 2, 4, 6))
    got_i, got_m = apply_path_a(torch.from_numpy(images), torch.from_numpy(masks),
                                PathADraws(*(torch.from_numpy(np.array(a)) for a in d)))
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
    np.testing.assert_allclose(got_i.numpy(), np.asarray(want_i), atol=1e-6, rtol=0)


def test_augment_hook_in_the_step(case):
    """``make_train_step(augment=augment_path_a_batch)`` draws from the
    generator it is given: two steps from equal generators agree exactly,
    and the hook needs one."""
    from mmr_tpu_torch.data.augment import augment_path_a_batch

    images, masks = torch.from_numpy(case["images"]), torch.from_numpy(case["masks"])

    def run():
        model = _port(case)
        opt = build_optimizer("adam", weight_decay=WD)
        step = make_train_step(model, opt, LOSS, NC, device="cpu",
                               augment=augment_path_a_batch)
        state, m = step(TrainState.create(model, opt), images, masks, LR,
                        torch.Generator().manual_seed(5))
        return float(m["loss"]), step, state

    (a, step, state), (b, _, _) = run(), run()
    assert a == b and np.isfinite(a)
    with pytest.raises(ValueError):
        step(state, images, masks, LR)


def test_evaluate_and_evaluate_checkpoint_match_jax(rng, capsys):
    """``Evaluate`` on id maps and on logits, and ``evaluate_checkpoint``
    over the same logits, vs the JAX package: exact counters, the same
    dict (the loss to f32 rounding) and the same printout."""
    from mmr_tpu.infer.evaluator import evaluate_checkpoint as eval_j
    from mmr_tpu.losses.dice_ce import blended_ce_dice_loss as loss_j
    from mmr_tpu.metrics.evaluate import Evaluate as EvaluateJ
    from mmr_tpu_torch.infer.evaluator import evaluate_checkpoint
    from mmr_tpu_torch.metrics import Evaluate

    logits = [(3 * rng.randn(2, 12, 16, NC)).astype(np.float32) for _ in range(3)]
    masks = [rng.randint(0, NC, (2, 12, 16)).astype(np.uint8) for _ in range(3)]
    ids = rng.randint(0, NC, (2, 12, 16))
    ej, et = EvaluateJ(NC), Evaluate(NC)
    ej.add_batch(jnp.asarray(ids), jnp.asarray(masks[0]))
    et.add_batch(torch.from_numpy(ids), torch.from_numpy(masks[0]))
    ej.add_batch(jnp.asarray(logits[1]), jnp.asarray(masks[1]))
    et.add_batch(torch.from_numpy(logits[1]), torch.from_numpy(masks[1]))
    for k in ("tp", "fp", "fn"):
        np.testing.assert_array_equal(getattr(et, k), getattr(ej, k))
    assert et.iou()[1] == ej.iou()[1]

    class Replay:   # a "model" that answers each batch with its logits
        def __init__(self, wrap):
            self.it, self.wrap = iter(logits), wrap

        def apply(self, variables, images, train=False):
            return self.wrap(next(self.it))

    class ReplayT(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.it = iter(logits)

        def forward(self, images):
            return torch.from_numpy(next(self.it))

    batches = [(np.zeros((2, 12, 16, 3), np.float32), m) for m in masks]
    want = eval_j(Replay(jnp.asarray), None, batches, NC,
                  loss_fn=functools.partial(loss_j, dice_loss_factor=0.5))
    out_j = capsys.readouterr().out
    got = evaluate_checkpoint(ReplayT(), batches, NC, loss_fn=LOSS, device="cpu")
    assert capsys.readouterr().out == out_j
    assert got.keys() == want.keys()
    np.testing.assert_allclose(got.pop("loss"), want.pop("loss"), rtol=1e-6)
    assert got == want


def test_heavy_metrics_match_jax(rng):
    """Path A's host-side heavy metrics: binary Dice and the capped
    Hausdorff distance, equal to the JAX package's."""
    from mmr_tpu.metrics.dice import binary_dice as dice_j
    from mmr_tpu.metrics.hausdorff import capped_hausdorff as haus_j
    from mmr_tpu_torch.metrics import binary_dice, capped_hausdorff

    p, m = rng.randint(0, 4, (2, 24, 32))
    for c in range(4):
        assert binary_dice(p == c, m == c) == dice_j(p == c, m == c)
        assert capped_hausdorff(p == c, m == c) == haus_j(p == c, m == c)
    empty = np.zeros((8, 8), bool)
    assert capped_hausdorff(empty, p[:8, :8] == 0) == 1000.0
    assert binary_dice(empty, empty) == 1.0
