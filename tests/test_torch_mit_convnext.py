"""The reference's best published architectures in the port — the smp
Unet over ConvNeXt-V2 (plain and fused) and Segformer over MiT, with the
encoders, flax's LayerNorm and the four-level UNet++ and MAnet — held
against the JAX package on the same variables and inputs.

Small configurations, registered under the same names in both packages'
``ENCODERS``: ConvNeXt-V2 depths (1, 1, 1, 1), dims (32, 48, 64, 96)
(and V1 with LayerScale for UNet++); MiT depths (1, 1, 1, 1), dims (16,
32, 40, 64), heads (1, 2, 5, 8), sr (8, 4, 2, 1). Inputs 2 × 64 × 64,
10 classes. The variables are the port model's tree in flax layout (its
shapes from the meta device: JAX's ``apply`` raises on a missing leaf and
the gradient test on an extra one), filled from seeded numpy (LayerNorm
scales, GRN and LayerScale away from their init values; BN away from
identity), and reach the port through ``from_jax_variables``. One JAX
program, compiled once for the module, gives each model's f32 encoder
features and logits and, for the Unet and Segformer, the bf16 logits and
the f32 train-mode gradients of DiceCE.
"""

import concurrent.futures

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from mmr_tpu_torch.losses import dice_ce_loss
from mmr_tpu_torch.models import create_model
from mmr_tpu_torch.models.convert import from_jax_variables, to_jax_variables
from mmr_tpu_torch.models.layers import LayerNorm, nchw, nhwc
from mmr_tpu_torch.ops.head_loss import assemble_dice_ce
from tests.test_torch_models import _fill
from tests.test_torch_train_modules import few_torch_threads  # noqa: F401
from tests.test_torch_train_step import _pairs

NC = 10
HW = (64, 64)
CNXT = dict(depths=(1, 1, 1, 1), dims=(32, 48, 64, 96))
MIT = dict(dims=(16, 32, 40, 64), depths=(1, 1, 1, 1))
SMALL = {"_t_cnxt2": ("convnext", True), "_t_cnxt1": ("convnext", False),
         "_t_mit": ("mit", None)}


def _rel_to_max(got, want):
    return np.abs(np.asarray(got, np.float64) - want).max() / np.abs(want).max()


@pytest.fixture(scope="module", autouse=True)
def small_encoders():
    """The small configurations in both registries, for this module."""
    from mmr_tpu.models.encoders import ENCODERS as ENC_J
    from mmr_tpu.models.encoders import EncoderSpec as SpecJ
    from mmr_tpu.models.encoders.convnext import ConvNeXtEncoder as CnxtJ
    from mmr_tpu.models.encoders.mix_transformer import (
        MixVisionTransformerEncoder as MitJ)
    from mmr_tpu_torch.models.encoders import ENCODERS, EncoderSpec
    from mmr_tpu_torch.models.encoders.convnext import ConvNeXtEncoder
    from mmr_tpu_torch.models.encoders.mix_transformer import (
        MixVisionTransformerEncoder)

    for name, (kind, grn) in SMALL.items():
        if kind == "convnext":
            ENC_J[name] = SpecJ(build=lambda dtype, name, g=grn, **kw: CnxtJ(
                **CNXT, use_grn=g, dtype=dtype, name=name),
                channels=(0,) + CNXT["dims"])
            ENCODERS[name] = EncoderSpec(build=lambda g=grn, **kw: ConvNeXtEncoder(
                **CNXT, use_grn=g, **kw), channels=(0,) + CNXT["dims"])
        else:
            ENC_J[name] = SpecJ(build=lambda dtype, name, **kw: MitJ(
                **MIT, dtype=dtype, name=name), channels=(0,) + MIT["dims"])
            ENCODERS[name] = EncoderSpec(build=lambda **kw: MixVisionTransformerEncoder(
                **MIT, **kw), channels=(0,) + MIT["dims"])
    yield
    for name in SMALL:
        ENC_J.pop(name)
        ENCODERS.pop(name)


def _batch():
    rng = np.random.RandomState(7)
    return (rng.rand(2, *HW, 3).astype(np.float32),
            rng.randint(0, NC, (2,) + HW).astype(np.int32))


MODELS = [("Unet", "_t_cnxt2"), ("Segformer", "_t_mit")]
TRAINED = set(MODELS)
ALL = MODELS + [("UnetPlusPlus", "_t_cnxt1")]


def _jax_program(arch, enc):
    """``program(v, x, y)`` of one model: its f32 eval logits and encoder
    features (captured from the same apply) and, for the trained models,
    the bf16 eval logits and the f32 train-mode DiceCE with its
    gradients."""
    from mmr_tpu.losses.dice_ce import dice_ce_loss as loss_j
    from mmr_tpu.models.factory import create_model as create_j

    m32, _ = create_j(arch, encoder_name=enc, classes=NC, dtype=jnp.float32)
    m16, _ = create_j(arch, encoder_name=enc, classes=NC, dtype=jnp.bfloat16)
    is_encoder = lambda mdl, method: mdl.name == "encoder" and method == "__call__"

    def program(v, x, y):
        logits, inter = m32.apply(v, x, train=False, mutable=["intermediates"],
                                  capture_intermediates=is_encoder)
        out = {"feats": inter["intermediates"]["encoder"]["__call__"][0][1:],
               "logits": logits}
        if (arch, enc) in TRAINED:
            out["logits16"] = m16.apply(v, x, train=False)

            def loss(params):
                logits, _ = m32.apply({**v, "params": params}, x, train=True,
                                      mutable=["batch_stats"])
                return loss_j(logits, y)
            out["loss"], out["grads"] = jax.value_and_grad(loss)(v["params"])
        return out

    return program


def _variables(arch, enc):
    """The model's tree (the port's, in flax layout; JAX's ``apply`` checks
    it) filled from seeded numpy."""
    with torch.device("meta"):
        shapes = _shape_tree(create_model(arch, encoder_name=enc, classes=NC,
                                          device="meta"))
    if not shapes["batch_stats"]:
        del shapes["batch_stats"]
    return _fill(shapes, np.random.RandomState(1234))


def _run_jax(variables, images, masks):
    progs = {k: _jax_program(*k) for k in ALL}
    outs = jax.jit(lambda vs, x, y: {k: progs[k](vs[k], x, y) for k in ALL})(
        {k: jax.tree_util.tree_map(jnp.asarray, variables[k]) for k in ALL},
        jnp.asarray(images), jnp.asarray(masks))
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), outs)


@pytest.fixture(scope="module", autouse=True)
def program(small_encoders):
    """The module's one JAX program for its three models, traced and
    compiled on a side thread from the module's start (XLA's compile lets
    the tests that do not need it run meanwhile): (variables, images,
    masks, a future of the outputs)."""
    variables = {k: _variables(*k) for k in ALL}
    images, masks = _batch()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        yield variables, images, masks, pool.submit(_run_jax, variables, images, masks)


@pytest.fixture(scope="module")
def cases(program):
    """``{(arch, encoder): {"variables", "images", "masks", outputs...}}``."""
    variables, images, masks, outs = program
    return {k: {"variables": variables[k], "images": images, "masks": masks,
                **outs.result()[k]} for k in ALL}


def _port(case, arch, enc, dtype=torch.float32, **kw):
    model = create_model(arch, encoder_name=enc, classes=NC, device="cpu",
                         dtype=dtype, **kw)
    model.load_state_dict(from_jax_variables(case["variables"], model))
    return model


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_layer_norm_matches_flax(rng, dtype):
    """The port's ``LayerNorm`` vs flax's ``nn.LayerNorm(dtype)`` on tokens
    with a large mean (mean 4, spread 0.5: the fast variance E[x²] − E[x]²
    cancels 16 against 16.25): f32 within 1e-4 relative to the largest
    (measured 1.4e-5: the cancellation amplifies summation order), bf16
    within one bf16 ulp of each value (one rounding on both sides)."""
    from flax import linen as fnn

    jd, td = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16,
                                                                   torch.bfloat16)
    x = (rng.randn(3, 50, 24) * 0.5 + 4.0).astype(np.float32)
    ln = fnn.LayerNorm(epsilon=1e-6, dtype=jd, param_dtype=jnp.float32)
    v = {"params": {"scale": rng.uniform(0.5, 1.5, 24).astype(np.float32),
                    "bias": (rng.randn(24) * 0.1).astype(np.float32)}}
    want = np.asarray(jax.jit(ln.apply)(v, jnp.asarray(x, jd)), np.float32)
    mt = LayerNorm(24)
    mt.load_state_dict(from_jax_variables(v))
    with torch.no_grad():
        got = mt(torch.from_numpy(x).to(td)).float().numpy()
    if dtype == "f32":
        assert _rel_to_max(got, want) < 1e-4
    else:
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
        assert (np.abs(got - want) <= ulp).all()


def _shape_tree(model):
    """The flax variable tree of the port's ``model`` as shapes
    (``jax.ShapeDtypeStruct``), named and laid out as
    ``to_jax_variables`` gives it."""
    from mmr_tpu_torch.models.convert import jax_leaf

    tree = {"params": {}, "batch_stats": {}}
    for name, v in model.state_dict().items():
        coll, path, leaf, a = jax_leaf(name, np.broadcast_to(np.float32(0), v.shape))
        node = tree[coll]
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = jax.ShapeDtypeStruct(a.shape, jnp.float32)
    return tree


def test_full_width_models_build():
    """``create_model`` at full width on the meta device: Unet over
    ``tu-convnextv2_tiny`` (fused) 31,976,426 parameters and Segformer over
    ``mit_b2`` 24,745,162, the counts of JAX's trees; ``mit_b0``,
    ``tu-convnext_tiny`` and ``tu-convnextv2_tiny`` in Unet, UNet++, MAnet
    and Segformer give (1, 64, 64, 10) at 64 × 64, as JAX does: JAX's
    ``apply`` traced (``jax.eval_shape``) over the port's own tree for
    MAnet over ``mit_b0``, whose four-level wiring no other test holds
    against JAX (a trace costs ~1 s; the small configurations' Unet, UNet++
    and Segformer are held by value above, the encoders' trees by the
    manifest). DeepLabV3+ refuses them in both packages."""
    from mmr_tpu.models.factory import create_model as create_j

    x = jnp.zeros((1, 64, 64, 3))
    with torch.device("meta"):
        for arch, enc, n in (("Unet", "tu-convnextv2_tiny", 31_976_426),
                             ("Segformer", "mit_b2", 24_745_162)):
            m = create_model(arch, encoder_name=enc, classes=NC, device="meta",
                             **({"fused": True} if arch == "Unet" else {}))
            assert sum(p.numel() for p in m.parameters()) == n
        for enc in ("mit_b0", "tu-convnext_tiny", "tu-convnextv2_tiny"):
            for arch in ("Unet", "UnetPlusPlus", "MAnet", "Segformer"):
                m = create_model(arch, encoder_name=enc, classes=NC,
                                 device="meta", dtype=torch.float32)
                got = tuple(m(torch.empty(1, 64, 64, 3)).shape)
                assert got == (1, 64, 64, NC), (arch, enc)
                if (arch, enc) == ("MAnet", "mit_b0"):
                    mj, _ = create_j(arch, encoder_name=enc, classes=NC,
                                     dtype=jnp.float32)
                    assert jax.eval_shape(lambda v, x: mj.apply(v, x, train=False),
                                          _shape_tree(m), x).shape == got
            mj, _ = create_j("DeepLabV3Plus", encoder_name=enc, classes=NC)
            with pytest.raises(TypeError):
                jax.eval_shape(lambda x: mj.init(jax.random.key(0), x), x)
            with pytest.raises(ValueError, match="output_stride"):
                create_model("DeepLabV3Plus", encoder_name=enc, device="meta")


def test_resize_plans_outlive_inference_mode():
    """Segformer's bilinear resizes in training after a forward under
    ``torch.inference_mode`` (serving, then training, in one process): the
    cached gather indices and weights are ordinary tensors, which autograd
    may save."""
    from mmr_tpu_torch.ops.resize import resize_bilinear

    with torch.inference_mode():
        resize_bilinear(torch.rand(1, 5, 3, 2), (11, 13))
    x = torch.rand(1, 5, 3, 2, requires_grad=True)
    resize_bilinear(x, (11, 13)).sum().backward()
    assert x.grad.shape == x.shape


@pytest.mark.parametrize("arch,enc", MODELS)
def test_f32_encoder_and_logits_match_jax(cases, arch, enc):
    """Eval-mode f32: the encoder's four features and the logits vs JAX,
    max|Δ| / max|ref| < 1e-4 (summation order only; measured ≤ 1.7e-6);
    the port's tree goes back to JAX's unchanged."""
    case = cases[(arch, enc)]
    model = _port(case, arch, enc)
    x = torch.from_numpy(case["images"])
    with torch.no_grad():
        feats = model.encoder(nchw(x))
        got = model(x).numpy()
    assert feats[0] is None and len(feats) == 5
    for f, want in zip(feats[1:], case["feats"]):
        assert _rel_to_max(nhwc(f).numpy(), want) < 1e-4
    assert got.shape == (2,) + HW + (NC,)
    assert _rel_to_max(got, case["logits"]) < 1e-4
    back = to_jax_variables(model.state_dict(), model)
    for tree in ("params", "batch_stats"):
        for n, a, b in _pairs(back[tree], case["variables"].get(tree, {})):
            np.testing.assert_array_equal(a, b, err_msg=n)


@pytest.mark.parametrize("arch,enc", MODELS)
def test_bf16_logits_match_jax(cases, arch, enc):
    """Eval-mode bf16 (flax LayerNorm, GRN in f32, the attention's f32
    logits and PV product) vs JAX's bf16 model: atol 0.25 / rtol 0.05
    (``TestPackedUnetPP``'s bounds; measured max |Δ| 0.039 (Unet) and 0.043
    (Segformer)), and argmax agreement ≥ 0.99 or, where JAX's bf16 model
    agrees with its own f32 model on fewer pixels, no lower than that less
    0.01. Segformer's ×4 head spreads each near-tied stride-4 logit over
    16 pixels: there JAX's bf16 agrees with its f32 on 0.990, the port's
    bf16 with JAX's on 0.988 (the Unet: 1.0). XLA on the CPU keeps some
    bf16 sums in f32 (excess precision) and adds a conv's bias after
    rounding, so the two bf16 paths cannot agree bit for bit."""
    case = cases[(arch, enc)]
    model = _port(case, arch, enc, torch.bfloat16)
    with torch.no_grad():
        got = model(torch.from_numpy(case["images"])).numpy()
    want = case["logits16"]
    np.testing.assert_allclose(got, want, atol=0.25, rtol=0.05)
    own = (want.argmax(-1) == case["logits"].argmax(-1)).mean()
    assert (got.argmax(-1) == want.argmax(-1)).mean() >= min(0.99, own - 0.01)


@pytest.mark.parametrize("arch,enc", MODELS)
def test_f32_train_grads_match_jax(cases, arch, enc):
    """One f32 train-mode forward (BN on batch statistics) and DiceCE
    backward vs JAX's: the loss rtol 1e-5; every parameter's gradient
    within 2e-2 of its leaf's largest value and the whole gradient within
    1e-2 (relative L2). Measured: Unet worst leaf 8.7e-3 and 3.4e-3 whole,
    Segformer 4.9e-5 and 1.3e-5. The Unet's gradient is ill-conditioned in
    f32 at this size: each block's own pieces (dwconv, LayerNorm, Dense,
    GELU, GRN) match JAX's gradients within 1e-6, but computing only the
    LayerNorms in float64 moves the port's own eval-mode gradient by 1.3e-3,
    and train-mode BN over the 32 values of block 0 adds more. Leaves that
    are analytically zero — a bias that a train-mode BN or the softmax over
    keys cancels (``linear_c*``, ``norm4``, ``attn/k`` biases) — are held by
    size: below 1e-5 of the model's largest gradient on both sides
    (measured ≤ 7.2e-7)."""
    case = cases[(arch, enc)]
    model = _port(case, arch, enc).train()
    loss = dice_ce_loss(model(torch.from_numpy(case["images"])),
                        torch.from_numpy(case["masks"]).long())
    loss.backward()
    np.testing.assert_allclose(loss.item(), case["loss"], rtol=1e-5)
    grads = to_jax_variables({n: p.grad for n, p in model.named_parameters()}, model)
    pairs = list(_pairs(grads["params"], case["grads"]))
    assert len(pairs) == len(jax.tree_util.tree_leaves(case["grads"]))
    top = max(np.abs(w).max() for _, _, w in pairs)
    for n, g, w in pairs:
        if np.abs(w).max() < 1e-5 * top:
            assert np.abs(g).max() < 1e-5 * top, n
        else:
            assert _rel_to_max(g, w) < 2e-2, n
    got = np.concatenate([g.ravel() for _, g, _ in pairs])
    want = np.concatenate([w.ravel() for _, _, w in pairs])
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < 1e-2


def test_fused_unet_matches_jax_plain_bf16(cases):
    """The port's fused Unet (``packed_min_hw`` 256: blocks 2–4 and the
    head on K1's plain version, block 2 with its skip, blocks 3–4 with
    none; blocks 0–1 plain) vs JAX's plain bf16 Unet:
    ``TestPackedUnetPP``'s bounds, atol 0.25 / rtol 0.05, argmax ≥ 0.99
    (measured max |Δ| 0.047, agreement 1.0)."""
    case = cases[("Unet", "_t_cnxt2")]
    model = _port(case, "Unet", "_t_cnxt2", torch.bfloat16, fused=True,
                  packed_min_hw=256)
    with torch.no_grad():
        got = model(torch.from_numpy(case["images"])).numpy()
    want = case["logits16"]
    np.testing.assert_allclose(got, want, atol=0.25, rtol=0.05)
    assert (got.argmax(-1) == want.argmax(-1)).mean() >= 0.99


def test_fused_unet_head_loss(cases):
    """The fused Unet with ``labels``: eval mode, its DiceCE from the head
    + loss statistics (K5a's plain version) equals ``dice_ce_loss`` of its
    fused logits within rtol 1e-4 (the logits are rounded to bf16 before
    the loss, the statistics are not; measured 4.4e-6); in train mode
    (moments, K3 and K5b's plain versions) every parameter gets a finite
    gradient and the blocks' BN statistics move."""
    case = cases[("Unet", "_t_cnxt2")]
    model = _port(case, "Unet", "_t_cnxt2", torch.bfloat16, fused=True,
                  packed_min_hw=256)
    x, y = torch.from_numpy(case["images"]), torch.from_numpy(case["masks"]).long()
    with torch.no_grad():
        res = model(x, labels=y)
        loss, _ = assemble_dice_ce(res["stats"], res["conf"], res["n_pixels"])
        want = dice_ce_loss(model(x), y)
    np.testing.assert_allclose(float(loss), float(want), rtol=1e-4)
    before = model.block3.conv1.bn.running_var.clone()
    model.train()
    res = model(x, labels=y)
    assemble_dice_ce(res["stats"], res["conf"], res["n_pixels"])[0].backward()
    for n, p in model.named_parameters():
        assert p.grad is not None and bool(torch.isfinite(p.grad).all()), n
    assert not torch.equal(model.block3.conv1.bn.running_var, before)


def test_four_level_unetpp_matches_jax(cases):
    """UNet++ over a four-level encoder (ConvNeXt V1 here: LayerScale, no
    GRN): the plan over four features, the last block at stride 2 and a
    ×2 align_corners head. Eval f32 encoder features and logits vs JAX,
    rel-to-max < 1e-4 (measured ≤ 1.4e-6); the fused UNet++ refuses such an
    encoder (JAX's packed one returns stride-2 logits there). MAnet's
    four-level wiring is held by shape in ``test_full_width_models_build``."""
    case = cases[("UnetPlusPlus", "_t_cnxt1")]
    model = _port(case, "UnetPlusPlus", "_t_cnxt1")
    x = torch.from_numpy(case["images"])
    with torch.no_grad():
        feats = model.encoder(nchw(x))[1:]
        got = model(x).numpy()
    for f, want in zip(feats, case["feats"]):
        assert _rel_to_max(nhwc(f).numpy(), want) < 1e-4
    assert got.shape == (2,) + HW + (NC,)
    assert _rel_to_max(got, case["logits"]) < 1e-4
    with pytest.raises(ValueError, match="five-level"):
        create_model("UnetPlusPlus", encoder_name="_t_cnxt1", device="cpu",
                     fused=True)
