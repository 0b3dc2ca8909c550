"""The rest of Path A's zoo in the port — smp Unet, DeepLabV3+ and MAnet
over ResNet-18, the hand-written UNet and SegNet, and ResNet-UNet — held
against the JAX package on the same variables and inputs (f32, 2 × 64 × 64
at full channel width), with the modules they brought: the dilated
encoder, the separable ASPP, PAB, ConvTransposeBN, the bilinear resizes
and ``pad_to``.

The JAX variables come from ``jax.eval_shape`` of the model's init, filled
from seeded numpy with BN away from identity, and reach the port through
``from_jax_variables``. One JAX program per model, compiled once and kept
for the module, gives its eval logits and, for UNet and DeepLabV3+, one
Adam step, whose gradients are read from the Adam first moment as in
``tests/test_torch_path_a.py``. DeepLabV3+'s ASPP dropout gets the same
fed keep-mask on both sides: JAX's through ``flax.linen.intercept_methods``.
"""

import functools
import importlib

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from flax import linen as fnn

from mmr_tpu_torch.losses import blended_ce_dice_loss
from mmr_tpu_torch.models import create_model
from mmr_tpu_torch.models.convert import from_jax_variables, to_jax_variables
from mmr_tpu_torch.models.layers import Conv3x3, nchw, nhwc
from mmr_tpu_torch.ops import conv3x3_packed as k6
from mmr_tpu_torch.train.optim import build_optimizer
from mmr_tpu_torch.train.state import TrainState
from mmr_tpu_torch.train.steps import make_train_step
from tests.test_torch_models import _fill
from tests.test_torch_train_modules import few_torch_threads  # noqa: F401
from tests.test_torch_train_step import _flat, _pairs

NC = 10
LR, WD = 1e-3, 1e-5
LOSS = functools.partial(blended_ce_dice_loss, dice_loss_factor=0.5)
ZOO = ["smp_unet18", "smp_DeepLabV3+", "smp_MANet", "unet", "segnet", "resnet18"]
TRAINED = ("unet", "smp_DeepLabV3+")


def _rel_to_max(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


def _feed_dropout(mask):
    """A flax interceptor: every non-deterministic ``nn.Dropout`` keeps
    where ``mask`` is True, ``where(keep, x / (1 − rate), 0)``."""
    def interceptor(next_fun, args, kwargs, context):
        m = context.module
        if (isinstance(m, fnn.Dropout) and context.method_name == "__call__"
                and not kwargs.get("deterministic", m.deterministic)):
            x = args[0]
            return jnp.where(mask, x / (1.0 - m.rate), 0.0).astype(x.dtype)
        return next_fun(*args, **kwargs)
    return interceptor


def _jax_case(zoo, hw=(64, 64), train=False, **kw):
    from mmr_tpu.losses.dice_ce import blended_ce_dice_loss as loss_j
    from mmr_tpu.models.encoders import get_encoder
    from mmr_tpu.models.factory import create_model as create_j
    from mmr_tpu.train.optim import build_optimizer as opt_j
    from mmr_tpu.train.state import TrainState as StateJ
    from mmr_tpu.train.steps import make_train_step as step_j

    model, _ = create_j(zoo, classes=NC, dtype=jnp.float32, **kw)
    shapes = jax.eval_shape(lambda k, x: model.init(k, x, train=False),
                            jax.random.key(0), jnp.zeros((1,) + hw + (3,)))
    variables = _fill(shapes, np.random.RandomState(1234))
    rng = np.random.RandomState(7)
    images = rng.rand(1, 2, *hw, 3).astype(np.float32)
    masks = rng.randint(0, NC, (1, 2) + hw).astype(np.int32)
    keep = rng.rand(2, hw[0] // 16, hw[1] // 16, 256) < 0.5   # ASPP's dropout
    fresh = jax.tree_util.tree_map(jnp.asarray, variables)
    out = {"variables": variables, "images": images, "masks": masks,
           "keep": keep, "kw": kw}
    if not train:
        out["logits"] = np.asarray(jax.jit(
            lambda v, x: model.apply(v, x, train=False))(fresh, images[0]))
        return out
    opt = opt_j("adam", weight_decay=WD)
    step = step_j(model, opt, functools.partial(loss_j, dice_loss_factor=0.5), NC)

    enc = getattr(model, "encoder_name", None) and get_encoder(
        model.encoder_name).build(jnp.float32, "encoder", output_stride=16)

    def program(v, images, masks):
        logits = model.apply(v, images[0], train=False)
        feats = enc and enc.apply({k: v[k]["encoder"] for k in ("params", "batch_stats")},
                                  images[0], train=False)
        return logits, feats, step(StateJ.create(v, opt), images, masks, LR,
                                   jax.random.key(0))

    with fnn.intercept_methods(_feed_dropout(jnp.asarray(keep))):
        logits, feats, (state, metrics) = jax.jit(program)(
            fresh, jnp.asarray(images), jnp.asarray(masks))
    adam = [s for s in jax.tree_util.tree_leaves(
        state.opt_state, is_leaf=lambda n: hasattr(n, "mu")) if hasattr(s, "mu")][0]
    to_np = functools.partial(jax.tree_util.tree_map, np.asarray)
    out.update(
        logits=np.asarray(logits), feats=feats and [np.asarray(f) for f in feats],
        loss=float(metrics["loss"]),
        iou=float(metrics["iou"]), params=to_np(state.params),
        batch_stats=to_np(state.batch_stats),
        grads=jax.tree_util.tree_map(
            lambda mu, p: np.asarray(mu, np.float64) / (1 - 0.9) - WD * p,
            adam.mu, variables["params"]))
    return out


@pytest.fixture(scope="module")
def cases():
    """One JAX program per model, compiled on first use and kept."""
    memo = {}

    def get(zoo, hw=(64, 64), **kw):
        key = (zoo, hw, tuple(sorted(kw.items())))
        if key not in memo:
            memo[key] = _jax_case(zoo, hw, train=zoo in TRAINED and not kw, **kw)
        return memo[key]
    return get


def _port(case, zoo):
    model = create_model(zoo, classes=NC, device="cpu", dtype=torch.float32,
                         **case["kw"])
    model.load_state_dict(from_jax_variables(case["variables"], model))
    return model


@pytest.mark.parametrize("zoo,hw,kw", [(z, (64, 64), {}) for z in ZOO] + [
    ("resnet34", (64, 64), {}),
    ("unet", (60, 60), {"bilinear": False})])   # ConvTranspose up, pad_to 6 -> 7
def test_eval_logits_match_jax(cases, zoo, hw, kw):
    """Eval-mode f32 logits of every zoo model vs JAX on the same variables:
    max|Δ| / max|ref| < 1e-4 (f32 on both sides, summation order only);
    the port's tree goes back to JAX's unchanged."""
    case = cases(zoo, hw, **kw)
    model = _port(case, zoo)
    with torch.no_grad():
        got = model(torch.from_numpy(case["images"][0])).numpy()
    assert got.shape == (2,) + hw + (NC,) and got.dtype == np.float32
    assert _rel_to_max(got, case["logits"]) < 1e-4
    back = to_jax_variables(model.state_dict(), model)
    for tree in ("params", "batch_stats"):
        for n, a, b in _pairs(back[tree], case["variables"].get(tree, {})):
            np.testing.assert_array_equal(a, b, err_msg=n)


@pytest.mark.parametrize("zoo", TRAINED)
def test_train_step_matches_jax(cases, zoo):
    """One f32 Path-A step (Adam with coupled L2, the blended loss, no
    augmentation; DeepLabV3+'s dropout fed the same keep-mask) vs JAX: loss
    rtol 1e-5, IoU atol 1e-4, the whole gradient within 1 % relative L2,
    every parameter after Adam within 2·lr, BN statistics within 1e-4 of
    each leaf's largest value (``test_torch_path_a.py``'s bounds)."""
    case = cases(zoo)
    model = _port(case, zoo)
    for m in model.modules():
        if hasattr(m, "keep"):
            m.keep = torch.from_numpy(case["keep"]).permute(0, 3, 1, 2)
    opt = build_optimizer("adam", weight_decay=WD)
    step = make_train_step(model, opt, LOSS, NC, device="cpu")
    state, metrics = step(TrainState.create(model, opt),
                          torch.from_numpy(case["images"]),
                          torch.from_numpy(case["masks"]), LR)
    np.testing.assert_allclose(float(metrics["loss"]), case["loss"], rtol=1e-5)
    np.testing.assert_allclose(float(metrics["iou"]), case["iou"], atol=1e-4)
    grads = to_jax_variables({n: p.grad for n, p in model.named_parameters()}, model)
    got, want = _flat(grads["params"], case["grads"]), _flat(case["grads"], case["grads"])
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < 1e-2
    v = to_jax_variables(model.state_dict(), model)
    for n, a, b in _pairs(v["params"], case["params"]):
        np.testing.assert_allclose(a, b, atol=2 * LR, rtol=0, err_msg=n)
    for n, a, b in _pairs(v["batch_stats"], case["batch_stats"]):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4 * np.abs(b).max(),
                                   err_msg=n)


def test_dropout_needs_draws(cases):
    """A model with dropout trains only with a generator (or fed masks):
    the step raises without one; two steps from equal generators agree."""
    case = cases("smp_DeepLabV3+")
    images, masks = torch.from_numpy(case["images"]), torch.from_numpy(case["masks"])

    def step_once(gen):
        model = _port(case, "smp_DeepLabV3+")
        opt = build_optimizer("adam", weight_decay=WD)
        step = make_train_step(model, opt, LOSS, NC, device="cpu")
        return float(step(TrainState.create(model, opt), images, masks, LR,
                          gen)[1]["loss"])

    with pytest.raises(ValueError, match="dropout"):
        step_once(None)
    a, b = (step_once(torch.Generator().manual_seed(3)) for _ in range(2))
    assert a == b and np.isfinite(a)


# ------------------------------------------------------------ the modules

def _apply_j(module, variables, *args, train=False):
    """``module.apply`` compiled as one program (eagerly, every op would
    compile on its own)."""
    out = jax.jit(lambda v, *a: module.apply(
        v, *a, train=train, mutable=["batch_stats"] if train else False))(
            variables, *args)
    return out if train else (out, None)


def _load(mod_t, variables):
    mod_t.load_state_dict(from_jax_variables(variables, mod_t))
    return mod_t


def _init_j(module, *args, **kw):
    shapes = jax.eval_shape(lambda k: module.init(k, *args, **kw), jax.random.key(0))
    return _fill(shapes, np.random.RandomState(5))


@pytest.mark.parametrize("train", [False, True])
def test_separable_aspp_at_small_rates(rng, train):
    """``SeparableConvBNReLU`` (dilation 2) and ``ASPP`` at rates (1, 2, 3)
    on 2 × 16 × 16 — where, unlike 64 × 64 input's 4 × 4 deep feature,
    every tap of every dilated conv sees the image — vs JAX, f32: eval
    outputs and, in train mode, the outputs and updated BN statistics
    (ASPP's dropout fed the same mask), rel-to-max < 1e-4."""
    from mmr_tpu.models.decoders import ASPP as AsppJ
    from mmr_tpu.models.decoders import SeparableConvBNReLU as SepJ
    from mmr_tpu_torch.models.decoders import ASPP, SeparableConvBNReLU

    x = rng.randn(2, 16, 16, 12).astype(np.float32)
    keep = rng.rand(2, 16, 16, 32) < 0.5
    for mj, mt in ((SepJ(32, dilation=2, dtype=jnp.float32), SeparableConvBNReLU(12, 32, 2)),
                   (AsppJ(32, (1, 2, 3), dtype=jnp.float32), ASPP(12, 32, (1, 2, 3)))):
        v = _init_j(mj, jnp.asarray(x), train=False)
        with fnn.intercept_methods(_feed_dropout(jnp.asarray(keep))):
            want, stats = _apply_j(mj, v, jnp.asarray(x), train=train)
        mt = _load(mt, v).train(train)
        if hasattr(mt, "drop"):
            mt.drop.keep = torch.from_numpy(keep).permute(0, 3, 1, 2)
        with torch.no_grad():
            got = nhwc(mt(nchw(torch.from_numpy(x)))).numpy()
        assert _rel_to_max(got, np.asarray(want)) < 1e-4
        if train:
            back = to_jax_variables(mt.state_dict())["batch_stats"]
            for n, a, b in _pairs(back, jax.device_get(stats["batch_stats"])):
                np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6, err_msg=n)


@pytest.mark.parametrize("k,s,p,hw", [(4, 2, 1, (5, 7)), (4, 1, 0, (3, 3)),
                                      (2, 2, 0, (4, 5))])
def test_conv_transpose(rng, k, s, p, hw):
    """flax ``ConvTranspose`` (kernel unflipped, the dilated input padded
    by k − 1 − p) vs the port's ``ConvTranspose2d`` through
    ``from_jax_variables(…, model)``: ``ConvTransposeBN`` (SegNet's k4 s2
    p1, k4 s1 p0) and UNet's biased k2 s2 'SAME' upconv, f32, output size
    (H − 1)·s − 2p + k; the weights go back to JAX's tree unchanged."""
    from mmr_tpu.models.layers import ConvTransposeBN as CtbnJ
    from mmr_tpu_torch.models.layers import ConvTranspose2d, ConvTransposeBN

    x = rng.randn(2, *hw, 6).astype(np.float32)
    if k == 2:
        mj = fnn.ConvTranspose(5, (2, 2), strides=(2, 2), dtype=jnp.float32)
        v = _fill(jax.eval_shape(lambda kk: mj.init(kk, jnp.asarray(x)),
                                 jax.random.key(0)), np.random.RandomState(5))
        want = jax.jit(mj.apply)(v, jnp.asarray(x))
        mt = torch.nn.Module()
        mt.conv = ConvTranspose2d(6, 5, 2, 2)
        v = {"params": {"conv": v["params"]}}
        _load(mt, v)
        fwd = mt.conv
    else:
        mj = CtbnJ(5, (k, k), (s, s), p, dtype=jnp.float32)
        v = _init_j(mj, jnp.asarray(x), train=False)
        want, _ = _apply_j(mj, v, jnp.asarray(x))
        mt = fwd = _load(ConvTransposeBN(6, 5, k, s, p), v).eval()
    with torch.no_grad():
        got = nhwc(fwd(nchw(torch.from_numpy(x)))).numpy()
    assert got.shape[1:3] == tuple((n - 1) * s - 2 * p + k for n in hw)
    assert _rel_to_max(got, np.asarray(want)) < 1e-5
    back = to_jax_variables(mt.state_dict(), mt)
    for n, a, b in _pairs(back["params"], v["params"]):
        np.testing.assert_array_equal(a, b, err_msg=n)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_resizes_match_jax(rng, dtype):
    """``resize_bilinear`` both ways (align_corners True / False), up and
    down and by non-integer factors, ``resize_nearest`` by non-integer
    factors, ``upsample2x`` with and without a mode, and ``pad_to`` on odd
    sizes, vs JAX: equal in f32 to 1e-6, and in bf16 (the lerp in the
    input's dtype) to one bf16 rounding."""
    import mmr_tpu.ops.padcrop as pj
    import mmr_tpu_torch.ops.padcrop as pt
    import mmr_tpu_torch.ops.resize as rt

    rj = importlib.import_module("mmr_tpu.ops.resize")   # ops/__init__ binds resize()

    jd, td = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16,
                                                                   torch.bfloat16)
    x = rng.randn(2, 5, 7, 3).astype(np.float32)
    xj, xt = jnp.asarray(x, jd), torch.from_numpy(x).to(td)
    calls = [(rj.resize_bilinear, rt.resize_bilinear, ((9, 13), ac))
             for ac in (True, False)]
    calls += [(rj.resize_bilinear, rt.resize_bilinear, ((3, 4), ac))
              for ac in (True, False)]
    calls += [(rj.resize_nearest, rt.resize_nearest, ((8, 11),)),
              (rj.resize_nearest, rt.resize_nearest, ((3, 4),)),
              (rj.upsample2x, rt.upsample2x, ()),
              (rj.upsample2x, rt.upsample2x, ("bilinear", True)),
              (pj.pad_to, pt.pad_to, ((8, 10),))]
    atol = 1e-6 if dtype == "f32" else 2 ** -7 * np.abs(x).max()
    for fj, ft, args in calls:
        static = tuple(range(1, 1 + len(args)))
        want = np.asarray(jax.jit(fj, static_argnums=static)(xj, *args), np.float32)
        got = ft(xt, *args)
        assert got.dtype == td and got.shape == want.shape, (fj.__name__, args)
        np.testing.assert_allclose(got.float().numpy(), want, atol=atol, rtol=0,
                                   err_msg=f"{fj.__name__}{args}")


def test_pab_matches_jax(rng):
    """``PAB`` with smp's quirks (softmax over the whole hw × hw map, the
    raw (b, hw, C) → (b, C, h, w) reshape) on 2 × 6 × 5 × 12, f32."""
    from mmr_tpu.models.decoders import PAB as PabJ
    from mmr_tpu_torch.models.decoders import PAB

    x = rng.randn(2, 6, 5, 12).astype(np.float32)
    mj = PabJ(8, dtype=jnp.float32)
    v = _fill(jax.eval_shape(lambda k: mj.init(k, jnp.asarray(x)), jax.random.key(0)),
              np.random.RandomState(5))
    want = np.asarray(jax.jit(mj.apply)(v, jnp.asarray(x)))
    mt = _load(PAB(12, 8), v)
    with torch.no_grad():
        got = nhwc(mt(nchw(torch.from_numpy(x)))).numpy()
    assert _rel_to_max(got, want) < 1e-5


def test_dilated_encoder_matches_jax(cases):
    """ResNet-18 at output stride 16 (the last stage dilated, its 1×1
    downsample kept), DeepLabV3+'s encoder: the five eval features vs
    JAX's, f32, rel-to-max < 1e-4; f5 stays at stride 16."""
    case = cases("smp_DeepLabV3+")
    model = _port(case, "smp_DeepLabV3+")
    with torch.no_grad():
        got = model.encoder(nchw(torch.from_numpy(case["images"][0])))
    assert [tuple(f.shape[2:]) for f in got] == [(32, 32), (16, 16), (8, 8),
                                                 (4, 4), (4, 4)]
    for g, w in zip(got, case["feats"]):
        assert _rel_to_max(nhwc(g).numpy(), w) < 1e-4


@pytest.mark.parametrize("zoo,k6_per_forward", [
    ("smp_unet18", 7), ("smp_MANet", 8), ("unet", 12), ("segnet", 0),
    ("resnet18", 0), ("smp_DeepLabV3+", 0)])
def test_k6_dispatch_per_zoo_model(monkeypatch, zoo, k6_per_forward):
    """How many Conv3x3s of each zoo model take K6 in a bf16 forward at
    256 × 256, B = 8 (output H·W ≥ 64·64): smp Unet 7 (blocks 2–4 and the
    head), MAnet 8 (block 2's two convs, block 3's hl_conv1 and two convs,
    block 4, the head), UNet 12 (inc, down1, down2, up2–up4); SegNet,
    ResNet-UNet and DeepLabV3+ have no Conv3x3 at all. Shapes only: the
    model runs on the meta device with the op counted, not computed."""
    calls = []

    def counted(x, w, bias=None, relu=False):
        calls.append(tuple(x.shape))
        return x.new_empty(x.shape[:3] + (w.shape[3],))

    monkeypatch.setattr(k6, "conv3x3p_bias_act", counted)
    model = create_model(zoo, classes=NC, device="cpu").to("meta")
    with torch.no_grad():
        out = model(torch.empty(8, 256, 256, 3, device="meta"))
    assert out.shape == (8, 256, 256, NC)
    assert len(calls) == k6_per_forward
    assert all(s[1] * s[2] >= 64 * 64 for s in calls)
    n_conv3x3 = sum(isinstance(m, Conv3x3) for m in model.modules())
    assert (n_conv3x3 == 0) == (k6_per_forward == 0)
