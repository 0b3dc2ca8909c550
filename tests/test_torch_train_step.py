"""One train step of the port (``mmr_tpu_torch.train.steps``) held
against the JAX ``make_train_step`` of the unpacked f32 UNet++/mbv3 on the
same variables and the same uint8 batch (2 × 64 × 128, 10 classes;
defaults of the reference: AdamW, lr 1e-4, weight decay 1e-2, clip 12,
DiceCE, ImageNet preprocessing).

The JAX variables come from ``jax.eval_shape`` of the model's init, filled
from seeded numpy with BN away from identity (as
``tests/test_torch_models.py``), and reach the port through
``from_jax_variables``; updated parameters and BN statistics come back
through ``to_jax_variables``. ``make_train_step`` returns no gradients:
they are read from its own AdamW first moment, which after one step is
``(1 − b1)·g`` with ``g`` the clipped gradient (``optim.py:137-140``);
the port's gradients are clipped the same way before the comparison.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from mmr_tpu_torch.losses import dice_ce_loss
from mmr_tpu_torch.models import create_model, get_preprocessing
from mmr_tpu_torch.models.convert import from_jax_variables, to_jax_variables
from mmr_tpu_torch.train.optim import build_optimizer
from mmr_tpu_torch.train.state import TrainState
from mmr_tpu_torch.train.steps import make_eval_step, make_train_step
from tests.test_torch_models import _fill
from tests.test_torch_train_modules import few_torch_threads  # noqa: F401

NC = 10
LR = 1e-4
CLIP = 12.0
SHAPE = (2, 64, 128)


@pytest.fixture(scope="module")
def case():
    """The JAX side once for the module: variables, batch, and the step's
    loss, IoU, gradients, updated params and batch stats."""
    from mmr_tpu.losses.dice_ce import dice_ce_loss as dice_ce_j
    from mmr_tpu.models.decoders import UnetPlusPlusModel
    from mmr_tpu.models.factory import get_preprocessing as pre_j
    from mmr_tpu.train.optim import build_optimizer as opt_j
    from mmr_tpu.train.state import TrainState as StateJ
    from mmr_tpu.train.steps import make_train_step as step_j

    model = UnetPlusPlusModel(num_classes=NC, dtype=jnp.float32)
    shapes = jax.eval_shape(lambda k, x: model.init(k, x, train=False),
                            jax.random.key(0), jnp.zeros((1,) + SHAPE[1:] + (3,)))
    variables = _fill(shapes, np.random.RandomState(1234))
    rng = np.random.RandomState(7)
    images = rng.randint(0, 256, (1,) + SHAPE + (3,)).astype(np.uint8)
    masks = rng.randint(0, NC, (1,) + SHAPE).astype(np.int32)
    pre = pre_j("tu-mobilenetv3_small_100")

    opt = opt_j("adamw", clip_grad_norm=CLIP, weight_decay=1e-2)
    fresh = jax.tree_util.tree_map(jnp.asarray, variables)   # the step donates
    state, metrics = step_j(model, opt, dice_ce_j, NC, preprocess=pre)(
        StateJ.create(fresh, opt), jnp.asarray(images), jnp.asarray(masks), LR,
        jax.random.key(0))
    g = np.asarray(state.opt_state["mu"], np.float64) / (1.0 - opt.b1)
    leaves, treedef = jax.tree_util.tree_flatten(variables["params"])
    offs = np.cumsum([0] + [a.size for a in leaves])
    grads = jax.tree_util.tree_unflatten(treedef, [
        g[o:o + a.size].reshape(a.shape) for o, a in zip(offs, leaves)])
    return {"variables": variables, "images": images, "masks": masks,
            "loss": float(metrics["loss"]), "iou": float(metrics["iou"]),
            "grads": grads,
            "params": jax.tree_util.tree_map(np.asarray, state.params),
            "batch_stats": jax.tree_util.tree_map(np.asarray, state.batch_stats)}


def _port_step(case, **model_kw):
    model = create_model(classes=NC, device="cpu", **model_kw)
    model.load_state_dict(from_jax_variables(case["variables"]))
    opt = build_optimizer("adamw", clip_grad_norm=CLIP, weight_decay=1e-2)
    state = TrainState.create(model, opt)
    step = make_train_step(model, opt, dice_ce_loss, NC, device="cpu",
                           preprocess=get_preprocessing("tu-mobilenetv3_small_100"))
    state, metrics = step(state, torch.from_numpy(case["images"]),
                          torch.from_numpy(case["masks"]), LR)
    named = dict(model.named_parameters())
    gn = torch.sqrt(sum((p.grad.double() ** 2).sum() for p in named.values()))
    clip = min(1.0, CLIP / max(float(gn), 1e-12))
    grads = to_jax_variables({n: p.grad * clip for n, p in named.items()})
    return state, metrics, grads["params"], to_jax_variables(model.state_dict())


def _pairs(got, want, path=()):
    for k, v in want.items():
        if isinstance(v, dict):
            yield from _pairs(got[k], v, path + (k,))
        else:
            yield "/".join(path + (k,)), got[k], v


def _rel_to_max(a, b):
    return np.abs(a - b).max() / (np.abs(b).max() + 1e-12)


def _flat(tree, like):
    return np.concatenate([g.ravel() for _, g, _ in _pairs(tree, like)])


def _cosine(a, b):
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def test_plain_f32_step_matches_jax(case):
    """The port's plain f32 model. Bounds: loss rtol 1e-5 and IoU atol 1e-4
    (f32 on both sides, summation order only); the whole gradient within 1 %
    (relative L2; measured 0.6 %: train-mode BN over the few values of the
    coarse rows — 16 at the 1/32 scale — amplifies f32 reordering); updated
    params atol 3·lr (Adam's first step moves each weight by about ±lr, so a
    gradient whose sign differs between the sides lands 2·lr apart); BN
    statistics rtol 1e-4."""
    state, metrics, grads, v = _port_step(case, dtype=torch.float32)
    assert state.step == 1 and state.opt_state["count"] == 1
    np.testing.assert_allclose(float(metrics["loss"]), case["loss"], rtol=1e-5)
    np.testing.assert_allclose(float(metrics["iou"]), case["iou"], atol=1e-4)
    got, want = _flat(grads, case["grads"]), _flat(case["grads"], case["grads"])
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < 0.01
    for n, got, want in _pairs(v["params"], case["params"]):
        np.testing.assert_allclose(got, want, atol=3 * LR, rtol=0, err_msg=n)
    for n, got, want in _pairs(v["batch_stats"], case["batch_stats"]):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6, err_msg=n)


def test_fused_step_matches_jax(case):
    """The fused model (every node, the head loss, stem and b0_0 on the
    kernels' plain versions, bf16) vs the same f32 JAX step: loss rtol 2e-2
    and BN running stats atol 0.05 / rtol 0.1 (``test_packed_chain.py:238``),
    updated params atol 3·lr, the head's gradients per leaf rel-to-max
    < 0.25 (``:409``), the macro IoU atol 5e-3 (argmax flips of near-tied
    pixels).

    Deeper leaves cannot be held per leaf against any bf16 path: the
    gradient at this random init is ill-conditioned. Relative noise of
    2^-9 (bf16's rounding) on every BN output of the plain f32 model moves
    54 of the 68 decoder leaves by more than 0.25 of their largest value;
    the port's plain bf16 autograd model has gradient cosine 0.74 to the
    f32 JAX step; against the JAX package's own packed bf16 step (Pallas in
    interpret mode) 197 of 206 leaves differ by more than
    0.25 although the losses agree to 4e-5. So the whole gradient is held
    to what bf16 itself allows — its cosine to the JAX gradient within 0.05
    of the plain bf16 model's — the decoder's wiring per leaf at f32 storage
    in ``test_fused_block_wiring_matches_jax``, and the kernels' roundings
    per kernel in ``test_torch_train_kernels.py``."""
    state, metrics, grads, v = _port_step(case, fused=True, fused_frontend=True,
                                          packed_min_hw=0)
    np.testing.assert_allclose(float(metrics["loss"]), case["loss"], rtol=2e-2)
    np.testing.assert_allclose(float(metrics["iou"]), case["iou"], atol=5e-3)
    for n, g, w in _pairs(grads["head"], case["grads"]["head"]):
        assert _rel_to_max(g, w) < 0.25, n
    for n, got, want in _pairs(v["params"], case["params"]):
        np.testing.assert_allclose(got, want, atol=3 * LR, rtol=0, err_msg=n)
    for n, got, want in _pairs(v["batch_stats"], case["batch_stats"]):
        np.testing.assert_allclose(got, want, atol=0.05, rtol=0.1, err_msg=n)
    _, _, g16, _ = _port_step(case)
    want = _flat(case["grads"], case["grads"])
    cos_fused = _cosine(_flat(grads, case["grads"]), want)
    assert cos_fused > _cosine(_flat(g16, case["grads"]), want) - 0.05


def test_fused_frontend_grads_match_jax(case, rng):
    """``TestPackedFrontend::test_grads_match`` for the port: the stem and
    b0_0 gradients (conv_stem, bn1, b0_0's dw / SE / pw / BNs) through a
    shallow feature-level loss Σ f1·r1 + Σ f2·r2, the fused front-end (K2
    forward, K4 backward, plain versions here, bf16) vs the JAX XLA encoder
    in bf16: per leaf rel-to-max < 0.25 (``test_packed_chain.py:409``;
    measured worst: bn1's scale, 0.195)."""
    from mmr_tpu.models.encoders import get_encoder as get_encoder_j
    from mmr_tpu_torch.models.fused_blocks import as_array
    from mmr_tpu_torch.models.layers import nhwc

    img = case["images"][0, :1].astype(np.float32) / 255.0
    h, w = img.shape[1:3]
    r1 = rng.randn(1, h // 2, w // 2, 16).astype(np.float32)
    r2 = rng.randn(1, h // 4, w // 4, 16).astype(np.float32)
    enc_v = {k: case["variables"][k]["encoder"] for k in ("params", "batch_stats")}
    enc_j = get_encoder_j("tu-mobilenetv3_small_100").build(jnp.bfloat16, "encoder")

    def loss_j(params):
        out, _ = enc_j.apply({"params": params, "batch_stats": enc_v["batch_stats"]},
                             jnp.asarray(img), train=True, mutable=["batch_stats"])
        return ((out[0].astype(jnp.float32) * r1).sum()
                + (out[1].astype(jnp.float32) * r2).sum())

    g_j = jax.jit(jax.grad(loss_j))(jax.tree_util.tree_map(jnp.asarray,
                                                          enc_v["params"]))

    model = create_model(classes=NC, device="cpu", fused=True, fused_frontend=True)
    model.load_state_dict(from_jax_variables(case["variables"]))
    model.train()
    f1, f2 = model.encoder(torch.from_numpy(img).permute(0, 3, 1, 2))[:2]
    ((nhwc(as_array(f1)).float() * torch.from_numpy(r1)).sum()
     + (nhwc(as_array(f2)).float() * torch.from_numpy(r2)).sum()).backward()
    front = ("encoder.conv_stem.", "encoder.bn1.", "encoder.b0_0.")
    grads = to_jax_variables({n[len("encoder."):]: p.grad
                              for n, p in model.named_parameters()
                              if n.startswith(front)})["params"]
    errs = {n: _rel_to_max(g, np.asarray(w, np.float32))
            for name in ("conv_stem", "bn1", "b0_0")
            for n, g, w in _pairs(grads[name], g_j[name], (name,))}
    assert max(errs.values()) < 0.25, errs


def test_fused_block_wiring_matches_jax(rng, monkeypatch):
    """The decoder's train-mode wiring held per leaf against the JAX
    package: one fused ``DecoderBlock`` in train mode — conv1 over a lazily
    ×2-upsampled input and a skip, each with a BN + relu prologue pending;
    K1 with moments; the batch-statistics BN from those moments; conv2 with
    conv1's BN + relu as its prologue; K3 backward with the moments'
    cotangent — vs the JAX f32 ``DecoderBlock`` on the activated inputs,
    through a loss Σ out·r on the block's activated output. ``r`` has a
    per-channel mean, so the BN's mean and variance terms carry much of
    each gradient.

    The kernels' plain versions run at f32 storage (``dtype=torch.float32``:
    every bf16 rounding dropped), so the comparison sees the wiring alone:
    every gradient — the six parameter leaves, both raw inputs and both
    prologues — within max|Δ| / max|ref| < 1e-4 (measured 1.4e-5: f32
    summation order), the updated running statistics rtol 1e-5. With the
    path's bf16 roundings this comparison spreads up to 0.21 (the JAX
    package's own bf16 block: 0.72): the moment terms that carry the
    gradient also cancel most of it. The roundings are held per kernel in
    ``test_torch_train_kernels.py``."""
    import mmr_tpu_torch.ops.fused_conv as fc
    from mmr_tpu.models.decoders import DecoderBlock as DecoderBlockJ
    from mmr_tpu_torch.models.decoders import DecoderBlock
    from mmr_tpu_torch.models.fused_blocks import Pending, as_array, up_lazy
    from mmr_tpu_torch.models.layers import nhwc

    f32 = torch.float32
    monkeypatch.setattr(fc, "fused_conv", lambda i, w, b=None, emit_moments=False:
                        fc.fused_conv_ref(i, w, b, emit_moments, dtype=f32))
    monkeypatch.setattr(fc, "fused_conv_bwd",
                        lambda *a: fc.fused_conv_bwd_ref(*a, dtype=f32))
    monkeypatch.setattr(fc, "_grad_bf16", lambda t: t)

    b, h, w, cx, cs, co = 2, 8, 16, 32, 24, 16
    x = rng.randn(b, h, w, cx).astype(np.float32)
    skip = rng.randn(b, 2 * h, 2 * w, cs).astype(np.float32)
    pro = [(rng.uniform(0.5, 1.5, c).astype(np.float32),
            (0.3 * rng.randn(c)).astype(np.float32)) for c in (cx, cs)]
    r = (rng.randn(b, 2 * h, 2 * w, co) + rng.randn(co)).astype(np.float32)

    block_j = DecoderBlockJ(co, dtype=jnp.float32)
    shapes = jax.eval_shape(lambda k: block_j.init(k, jnp.zeros(x.shape),
                                                   [jnp.zeros(skip.shape)]),
                            jax.random.key(0))
    variables = _fill(shapes, rng)

    def loss_j(params, x, skip, pro):
        (sx, tx), (ss, ts) = pro
        out, upd = block_j.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            jax.nn.relu(x * sx + tx), [jax.nn.relu(skip * ss + ts)], train=True,
            mutable=["batch_stats"])
        return (out * r).sum(), upd["batch_stats"]

    (_, stats_j), g_j = jax.value_and_grad(loss_j, argnums=(0, 1, 2, 3),
                                           has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, variables["params"]), x, skip, pro)

    block = DecoderBlock(cx, cs, co)
    block.load_state_dict(from_jax_variables(variables))
    block.train()
    raws = [torch.from_numpy(a).requires_grad_() for a in (x, skip)]
    vecs = [[torch.from_numpy(v).requires_grad_() for v in p] for p in pro]
    out = block.fused([up_lazy(Pending(raws[0], *vecs[0], "relu")),
                       Pending(raws[1], *vecs[1], "relu")])
    (nhwc(as_array(out)) * torch.from_numpy(r)).sum().backward()

    grads = to_jax_variables({n: p.grad for n, p in block.named_parameters()})
    errs = {n: _rel_to_max(g, np.asarray(w_))
            for n, g, w_ in _pairs(grads["params"], g_j[0])}
    errs.update({n: _rel_to_max(t.grad.numpy(), np.asarray(w_))
                 for n, t, w_ in (("dx", raws[0], g_j[1]), ("dskip", raws[1], g_j[2]),
                                  ("dsx", vecs[0][0], g_j[3][0][0]),
                                  ("dtx", vecs[0][1], g_j[3][0][1]),
                                  ("dss", vecs[1][0], g_j[3][1][0]),
                                  ("dts", vecs[1][1], g_j[3][1][1]))})
    assert len(errs) == 12 and max(errs.values()) < 1e-4, errs
    for n, got, want in _pairs(to_jax_variables(block.state_dict())["batch_stats"],
                               stats_j):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6, err_msg=n)


def test_grad_accumulation_means_microbatches(case):
    """``n_accum=2`` over two copies of the batch takes the same update as
    one microbatch (the gradient is the microbatches' mean, one clip, one
    AdamW step; ``steps.py:164-180``) and reports the mean loss, while each
    microbatch updates the BN statistics in turn. The gradients (AdamW's
    first moment) agree to 1e-5 of their largest; the params to 2·lr,
    because Adam normalizes the f32 noise of analytically zero gradients
    (a ``bn3`` bias before a 1×1 conv + BN) to steps of up to ±lr."""
    def run(n):
        model = create_model(classes=NC, device="cpu", dtype=torch.float32)
        model.load_state_dict(from_jax_variables(case["variables"]))
        opt = build_optimizer("adamw", clip_grad_norm=CLIP)
        step = make_train_step(model, opt, dice_ce_loss, NC, n_accum=n,
                               device="cpu", preprocess=get_preprocessing())
        images = torch.from_numpy(case["images"][:, :1]).expand(n, -1, -1, -1, -1)
        masks = torch.from_numpy(case["masks"][:, :1]).expand(n, -1, -1, -1)
        state, m = step(TrainState.create(model, opt), images, masks, LR)
        return m, state.opt_state["mu"], model.state_dict()

    (m1, mu1, sd1), (m2, mu2, sd2) = run(1), run(2)
    np.testing.assert_allclose(float(m2["loss"]), float(m1["loss"]), rtol=1e-6)
    torch.testing.assert_close(mu2, mu1, rtol=0, atol=1e-5 * mu1.abs().max().item())
    for k, v in sd1.items():
        if "running" not in k:   # BN statistics: updated once vs twice
            torch.testing.assert_close(sd2[k], v, rtol=0, atol=2 * LR, msg=k)


def test_eval_step_and_unported_augment(case):
    """The eval step reports the loss and macro IoU of eval-mode logits;
    an augment that is neither an AugmentConfig nor a callable raises."""
    model = create_model(classes=NC, device="cpu", dtype=torch.float32)
    model.load_state_dict(from_jax_variables(case["variables"]))
    ev = make_eval_step(model, dice_ce_loss, NC, device="cpu",
                        preprocess=get_preprocessing())
    m = ev(None, torch.from_numpy(case["images"][0]),
           torch.from_numpy(case["masks"][0]))
    assert np.isfinite(float(m["loss"])) and 0 <= float(m["iou"]) <= 1
    assert float((m["tp"] + m["fn"]).sum()) == np.prod(SHAPE)
    opt = build_optimizer("adamw")
    with pytest.raises(TypeError, match="AugmentConfig or a callable"):
        make_train_step(model, opt, dice_ce_loss, NC, augment=object(), device="cpu")
