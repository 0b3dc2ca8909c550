"""The port's CUDA kernels and its fused model on the card, held against
the plain PyTorch versions (f32, TF32 off) on the same inputs.

Every test is marked ``gpu`` and skips without a CUDA card. The file
imports torch, numpy and the port only (the card's machine has no JAX), so
it also runs there without the JAX-side conftest:

    python -m pytest -m gpu --noconftest tests/test_torch_gpu.py -q

Kernel tolerance: atol = rtol = 2e-2 — both sides read the same bf16
inputs and round the prologue at the same place; accumulation order and
one bf16 rounding of y remain. Moments: rtol 1e-3 of the largest moment
(f32 sums in another order; the kernels add block sums by atomics).
Backward outputs (dx, dW, d(scale, shift), dbias): max|Δ| / max|ref| and
‖Δ‖ / ‖ref‖ both < 1e-2 — both sides read the same bf16 inputs and round
at the same places; summation order (the kernels add block partials by
atomics) and one bf16 rounding of dx remain, so a dropped tap or a lost
correction term fails. The confusion kernel counts in integers: exact.
"""

import numpy as np
import pytest
import torch

from mmr_tpu_torch.ops.fused_conv import (Pending, fused_conv, fused_conv_bwd,
                                          fused_conv_bwd_ref, fused_conv_down,
                                          fused_conv_down_bwd,
                                          fused_conv_down_bwd_ref,
                                          fused_conv_down_ref, fused_conv_ref)
from mmr_tpu_torch.ops.confusion import confusion_stats, confusion_stats_ref
from mmr_tpu_torch.ops.conv3x3_packed import (conv3x3, conv3x3_dw,
                                              conv3x3_dw_ref, conv3x3_ref,
                                              conv3x3p_bias_act)
from mmr_tpu_torch.ops.head_loss import (head_loss_bwd, head_loss_bwd_ref,
                                         head_loss_fwd, head_loss_fwd_ref)

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    old = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = old


def _close(got, want):
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("cins,cout,hw", [
    ([16], 16, (16, 32)),
    ([32, 16, 16], 32, (16, 32)),
    ([24, 24], 24, (18, 40)),           # ragged channels, partial tiles
    ([5, 7], 10, (18, 40)),             # channels not a multiple of 8
    ([256, 24, 24], 128, (16, 32)),     # the x_0_1 mix
    ([576, 48], 256, (8, 16)),          # cout > 128: two output tiles
])
def test_fused_conv_kernel(dev, cins, cout, hw):
    g = torch.Generator(device=dev).manual_seed(0)
    H, W = hw
    ins, ws = [], []
    for j, c in enumerate(cins):
        up = j == 0
        h, w = (H // 2, W // 2) if up else (H, W)
        x = torch.randn(2, h, w, c, device=dev, generator=g).to(torch.bfloat16)
        s = torch.rand(c, device=dev, generator=g) + 0.5
        t = torch.randn(c, device=dev, generator=g) * 0.3
        ins.append(Pending(x, s, t, ["relu", "hswish", "linear"][j % 3], up))
        ws.append(torch.randn(3, 3, c, cout, device=dev, generator=g) * 0.1)
    bias = torch.randn(cout, device=dev, generator=g)
    before = fused_conv.launches
    got = fused_conv(ins, ws, bias)
    assert fused_conv.launches == before + 1
    _close(got, fused_conv_ref(ins, ws, bias))
    # no prologue, no bias
    plain = [Pending(p.raw, up2x=p.up2x) for p in ins]
    _close(fused_conv(plain, ws), fused_conv_ref(plain, ws))


@pytest.mark.parametrize("depthwise", [False, True])
@pytest.mark.parametrize("act", [None, "relu", "hswish", "linear"])
def test_fused_conv_down_kernel(dev, depthwise, act):
    g = torch.Generator(device=dev).manual_seed(1)
    c = 16 if depthwise else 3
    x = torch.randn(2, 34, 66, c, device=dev, generator=g).to(torch.bfloat16)
    s = torch.rand(c, device=dev, generator=g) + 0.5
    t = torch.randn(c, device=dev, generator=g) * 0.3
    w = torch.randn(3, 3, 1 if depthwise else c, 16, device=dev, generator=g) * 0.3
    w = w[..., :c] if depthwise else w
    p = Pending(x) if act is None else Pending(x, s, t, act)
    before = fused_conv_down.launches
    got = fused_conv_down(p, w, depthwise=depthwise)
    assert fused_conv_down.launches == before + 1
    assert got.shape == (2, 17, 33, c if depthwise else 16)
    _close(got, fused_conv_down_ref(p, w, depthwise=depthwise))


def test_wrappers_raise_instead_of_falling_back(dev):
    x = torch.zeros(1, 8, 16, 8, device=dev, dtype=torch.bfloat16)
    w = torch.zeros(3, 3, 8, 4, device=dev)
    with pytest.raises(ValueError):          # more inputs than the kernel takes
        fused_conv([Pending(x)] * 9, [w] * 9)
    with pytest.raises(ValueError):          # f32 input
        fused_conv([Pending(x.float())], [w])
    big = torch.zeros(1, 8, 16, 64, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError):          # dense weights beyond shared memory
        fused_conv_down(Pending(big), torch.zeros(3, 3, 64, 64, device=dev))


def test_fused_model_matches_plain(dev):
    """Every node fused (incl. x_0_0: Cin 624, Cout 256) vs the plain f32
    model on the same weights."""
    from mmr_tpu_torch.models import create_model

    fused = create_model(classes=10, device=dev, fused=True,
                         fused_frontend=True, packed_min_hw=0)
    plain = create_model(classes=10, device=dev, dtype=torch.float32)
    plain.load_state_dict(fused.state_dict())
    x = torch.rand(2, 128, 256, 3, device=dev,
                   generator=torch.Generator(device=dev).manual_seed(2))
    k1, k2 = fused_conv.launches, fused_conv_down.launches
    with torch.inference_mode():
        a, b = fused(x), plain(x)
    assert fused_conv.launches - k1 == 23 and fused_conv_down.launches - k2 == 2
    torch.testing.assert_close(a, b, atol=0.25, rtol=0.05)
    assert (a.argmax(-1) == b.argmax(-1)).float().mean().item() > 0.99


def test_run_inference_on_card(dev):
    from mmr_tpu_torch.data.synthetic import render_frame
    from mmr_tpu_torch.infer.evaluator import run_inference
    from mmr_tpu_torch.models import create_model, get_preprocessing

    rng = np.random.RandomState(3)
    frames = [render_frame(rng, 160, 320, 9) for _ in range(3)]
    item = {"id": "v0", "t0": 0, "t1": 3,
            "image": np.stack([(f[0] * 255).astype(np.uint8) for f in frames]),
            "mask": np.stack([f[1] for f in frames])}

    class Data:
        infer_batch_size = 3

        def __iter__(self):
            return iter([item])

    model = create_model(classes=10, device=dev, fused=True, fused_frontend=True)
    before = fused_conv_down.launches
    rep = run_inference(model, Data(), {"n_classes": 9, "patch_size": (128, 256)},
                        preprocess=get_preprocessing(), save_plots=False)
    assert fused_conv_down.launches > before
    assert np.isfinite(rep["overall_mean_iou"]) and rep["videos"]["v0"]["fps"] > 0


# ------------------------------------------------- training kernels K1-K5

def _mom_close(got, want):
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-3,
                               atol=1e-3 * want.abs().max().item())


def _grad_close(name, got, want):
    torch.cuda.synchronize()
    d, w = got.float() - want.float(), want.float()
    rel = (d.abs().max() / w.abs().max()).item()
    l2 = (d.norm() / w.norm()).item()
    assert rel < 1e-2 and l2 < 1e-2, (name, rel, l2)


def _rand(g, dev, *shape, scale=1.0, dtype=torch.float32):
    return (torch.randn(*shape, device=dev, generator=g) * scale).to(dtype)


# (input channels, lazily upsampled?) per input, cout, (H, W) of the output,
# batch: small shapes, then train-path shapes of the 512x640 flagship
TRAIN_CONVS = [
    ([(16, True), (24, False)], 24, (16, 32), 2),
    ([(5, True), (7, False)], 10, (18, 40), 2),        # ragged channels / tiles
    ([(256, True), (24, False), (24, False)], 128, (64, 80), 8),  # x_0_1.conv1
    ([(32, True)], 16, (512, 640), 8),                            # x_0_4.conv1
]


@pytest.mark.parametrize("spec,cout,hw,batch", TRAIN_CONVS)
def test_k1_moments_and_k3(dev, spec, cout, hw, batch):
    g = torch.Generator(device=dev).manual_seed(3)
    H, W = hw
    ins, ws = [], []
    for j, (c, up) in enumerate(spec):
        h, w = (H // 2, W // 2) if up else (H, W)
        x = _rand(g, dev, batch, h, w, c, dtype=torch.bfloat16)
        s = torch.rand(c, device=dev, generator=g) + 0.5
        t = _rand(g, dev, c, scale=0.3)
        ins.append(Pending(x, s, t, ["relu", "hswish", "linear"][j % 3], up))
        ws.append(_rand(g, dev, 3, 3, c, cout, scale=0.1))
    y, mom = fused_conv(ins, ws, emit_moments=True)
    y_ref, mom_ref = fused_conv_ref(ins, ws, emit_moments=True)
    _close(y, y_ref)
    _mom_close(mom, mom_ref)

    dy = _rand(g, dev, batch, H, W, cout, dtype=torch.bfloat16)
    dmom = _rand(g, dev, 2, cout, scale=1e-3)
    before = fused_conv_bwd.launches
    got = fused_conv_bwd(ins, ws, y, dy, dmom, has_bias=True)
    assert fused_conv_bwd.launches == before + 1
    want = fused_conv_bwd_ref(ins, ws, y, dy, dmom, has_bias=True)
    for j in range(len(ins)):
        _grad_close(f"dx{j}", got[0][j], want[0][j])
        _grad_close(f"dw{j}", got[1][j], want[1][j])
        for a, b in zip(got[2][j], want[2][j]):
            _grad_close(f"dpro{j}", a, b)
    _grad_close("dbias", got[3], want[3])


@pytest.mark.parametrize("depthwise,hw,batch", [
    (False, (34, 66), 2), (True, (34, 66), 2),
    (False, (512, 640), 8), (True, (256, 320), 8)])     # the stem, b0_0
def test_k2_moments_and_k4(dev, depthwise, hw, batch):
    g = torch.Generator(device=dev).manual_seed(4)
    c = 16 if depthwise else 3
    x = _rand(g, dev, batch, *hw, c, dtype=torch.bfloat16)
    s = torch.rand(c, device=dev, generator=g) + 0.5
    t = _rand(g, dev, c, scale=0.3)
    p = Pending(x, s, t, "hswish") if depthwise else Pending(x)
    w = _rand(g, dev, 3, 3, 1 if depthwise else c, 16, scale=0.3)
    w = w[..., :c] if depthwise else w
    y, mom = fused_conv_down(p, w, depthwise=depthwise, emit_moments=True)
    y_ref, mom_ref = fused_conv_down_ref(p, w, depthwise=depthwise,
                                         emit_moments=True)
    _close(y, y_ref)
    _mom_close(mom, mom_ref)
    dy = _rand(g, dev, *y.shape, dtype=torch.bfloat16)
    dmom = _rand(g, dev, 2, y.shape[-1], scale=1e-3)
    before = fused_conv_down_bwd.launches
    got = fused_conv_down_bwd(p, w, y, dy, dmom, depthwise=depthwise,
                              need_dx=depthwise)
    assert fused_conv_down_bwd.launches == before + 1
    want = fused_conv_down_bwd_ref(p, w, y, dy, dmom, depthwise=depthwise,
                                   need_dx=depthwise)
    _grad_close("dw", got[1], want[1])
    if depthwise:
        _grad_close("dx", got[0], want[0])
        for a, b in zip(got[2], want[2]):
            _grad_close("dpro", a, b)


@pytest.mark.parametrize("hw,batch,nc", [((20, 40), 2, 3), ((512, 640), 8, 10)])
def test_k5_head_loss(dev, hw, batch, nc):
    g = torch.Generator(device=dev).manual_seed(5)
    c = 16
    x = Pending(_rand(g, dev, batch, *hw, c, dtype=torch.bfloat16),
                torch.rand(c, device=dev, generator=g) + 0.5,
                _rand(g, dev, c, scale=0.3), "relu")
    w = _rand(g, dev, 3, 3, c, nc, scale=0.3)
    bias = _rand(g, dev, nc, scale=0.1)
    labels = torch.randint(0, nc, (batch, *hw), device=dev, generator=g)
    logp, stats, conf = head_loss_fwd(x, w, bias, labels)
    logp_r, stats_r, conf_r = head_loss_fwd_ref(x, w, bias, labels)
    _close(logp, logp_r)
    torch.testing.assert_close(stats, stats_r, rtol=2e-2, atol=1e-3 * stats_r.abs().max().item())
    assert (conf - conf_r).abs().sum().item() <= 1e-3 * conf_r.sum().item()
    assert conf.sum().item() == batch * hw[0] * hw[1]
    dstats = _rand(g, dev, batch, 4, nc, scale=1e-4)
    dstats[:, 3] = 1.0 / labels.numel()
    before = head_loss_bwd.launches
    got = head_loss_bwd(x, w, logp, labels, dstats)
    assert head_loss_bwd.launches == before + 1
    want = head_loss_bwd_ref(x, w, logp, labels, dstats)
    for name, a, b in zip(["dx", "dw", "dscale", "dshift", "dbias"],
                          [got[0], got[1], *got[2], got[3]],
                          [want[0], want[1], *want[2], want[3]]):
        _grad_close(name, a, b)


def test_fused_train_step_on_card(dev):
    """A few fused train steps at a small size: every training kernel
    launches, the loss is finite and falls."""
    from mmr_tpu_torch.losses import dice_ce_loss
    from mmr_tpu_torch.models import create_model
    from mmr_tpu_torch.train.optim import build_optimizer
    from mmr_tpu_torch.train.state import TrainState
    from mmr_tpu_torch.train.steps import make_train_step

    model = create_model(classes=10, device=dev, fused=True,
                         fused_frontend=True, packed_min_hw=0)
    opt = build_optimizer("adamw", clip_grad_norm=12.0)
    state = TrainState.create(model, opt)
    step = make_train_step(model, opt, dice_ce_loss, 10)
    g = torch.Generator().manual_seed(6)
    images = torch.randint(0, 256, (1, 2, 128, 256, 3), generator=g, dtype=torch.uint8)
    masks = torch.randint(0, 10, (1, 2, 128, 256), generator=g)
    counts = [f.launches for f in (fused_conv, fused_conv_bwd, fused_conv_down,
                                   fused_conv_down_bwd, head_loss_fwd,
                                   head_loss_bwd)]
    losses = []
    for _ in range(4):
        state, m = step(state, images, masks, 1e-3)
        losses.append(float(m["loss"]))
    now = [f.launches for f in (fused_conv, fused_conv_bwd, fused_conv_down,
                                fused_conv_down_bwd, head_loss_fwd, head_loss_bwd)]
    assert [b - a for a, b in zip(counts, now)] == [4 * 22, 4 * 22, 8, 8, 4, 4]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]


# ------------------------------------------- Path-A kernels K6a, K6b, K7

# (B, H, W, Cin, Cout): ragged small shapes, then convs of Path A's 256x256
# B=8 step: x_0_2.conv1, x_0_3.conv1, a 64 -> 64 conv2, x_0_4.conv2, the
# head, and the head's dx (K6a over its cotangent: Cin 10 -> Cout 16)
K6_CONVS = [(2, 18, 40, 5, 10), (2, 16, 32, 24, 200),
            (8, 64, 64, 320, 64), (8, 128, 128, 320, 32),
            (8, 128, 128, 64, 64), (8, 256, 256, 16, 16),
            (8, 256, 256, 16, 10), (8, 256, 256, 10, 16)]


@pytest.mark.parametrize("b,h,w,cin,cout", K6_CONVS)
def test_k6a_k6b(dev, b, h, w, cin, cout):
    g = torch.Generator(device=dev).manual_seed(7)
    x = _rand(g, dev, b, h, w, cin, dtype=torch.bfloat16)
    wt = _rand(g, dev, 3, 3, cin, cout, scale=(9 * cin) ** -0.5)
    bias = _rand(g, dev, cout, scale=0.5)
    before = conv3x3.launches
    for relu, bb in ((False, bias), (True, None)):
        y = conv3x3(x, wt, bb, relu)
        assert y.shape == (b, h, w, cout) and y.dtype == torch.bfloat16
        _close(y, conv3x3_ref(x, wt, bb, relu))
    assert conv3x3.launches == before + 2
    gy = _rand(g, dev, b, h, w, cout, dtype=torch.bfloat16)
    before = conv3x3_dw.launches
    dw = conv3x3_dw(x, gy)
    assert conv3x3_dw.launches == before + 1
    _grad_close("dw", dw, conv3x3_dw_ref(x, gy))


def test_k6_autograd_op(dev):
    """``conv3x3p_bias_act`` on the card: forward K6a, backward K6a (dx) +
    K6b (dW) + Σg, held against the plain versions of the same steps."""
    g = torch.Generator(device=dev).manual_seed(8)
    x = _rand(g, dev, 4, 64, 64, 96, dtype=torch.bfloat16).requires_grad_()
    w = _rand(g, dev, 3, 3, 96, 32, scale=0.03).requires_grad_()
    bias = _rand(g, dev, 32, scale=0.5).requires_grad_()
    gy = _rand(g, dev, 4, 64, 64, 32, dtype=torch.bfloat16)
    k6a, k6b = conv3x3.launches, conv3x3_dw.launches
    y = conv3x3p_bias_act(x, w, bias, relu=True)
    y.backward(gy)
    assert conv3x3.launches - k6a == 2 and conv3x3_dw.launches - k6b == 1
    with torch.no_grad():
        gm = torch.where(y > 0, gy.float(), 0.0)
        gin = gm.to(torch.bfloat16)
        _grad_close("dx", x.grad, conv3x3_ref(gin, w.flip(0, 1).transpose(2, 3)))
        _grad_close("dw", w.grad, conv3x3_dw_ref(x, gin))
        _grad_close("dbias", bias.grad, gm.sum((0, 1, 2)))


@pytest.mark.parametrize("shape,pdt,gdt,nc", [
    ((4, 256, 256), torch.int64, torch.uint8, 10),     # Path A's eval batch
    ((3, 37, 53), torch.int64, torch.int64, 10),
    ((2, 100, 100), torch.int32, torch.int64, 128),
    ((1, 7, 9), torch.uint8, torch.uint8, 3)])
def test_k7_confusion(dev, shape, pdt, gdt, nc):
    """Exact, and the same from run to run; ids outside [0, nc) (negative
    sentinels, ids >= nc, uint8 255) count nowhere."""
    g = torch.Generator(device=dev).manual_seed(9)

    def ids(dt):
        lo = 0 if dt == torch.uint8 else -2
        a = torch.randint(lo, nc + 3, shape, device=dev, generator=g)
        if dt == torch.uint8:
            a[..., :2] = 255
        return a.to(dt)

    pred, gt = ids(pdt), ids(gdt)
    gt[0, :4] = pred[0, :4].to(gdt)                # agreements
    before = confusion_stats.launches
    got = confusion_stats(pred, gt, nc)
    again = confusion_stats(pred, gt, nc)
    assert confusion_stats.launches == before + 2
    torch.cuda.synchronize()
    for a, b, c in zip(got, confusion_stats_ref(pred, gt, nc), again):
        assert a.dtype == torch.float32 and a.shape == (nc,)
        assert torch.equal(a, b) and torch.equal(a, c)


def test_path_a_train_and_eval_on_card(dev):
    """A few Path-A steps (UNet++/ResNet-18 in bf16, Adam, blended loss,
    Path-A augmentation) at 128x128: 11 Conv3x3s at H·W >= 4096 give 22
    K6a + 11 K6b launches per step; the loss is finite and falls; then
    ``evaluate_checkpoint``: one K7 launch and 11 K6a per batch."""
    import functools

    from mmr_tpu_torch.data.augment import augment_path_a_batch
    from mmr_tpu_torch.infer.evaluator import evaluate_checkpoint
    from mmr_tpu_torch.losses import blended_ce_dice_loss
    from mmr_tpu_torch.models import create_model
    from mmr_tpu_torch.train.optim import build_optimizer
    from mmr_tpu_torch.train.state import TrainState
    from mmr_tpu_torch.train.steps import make_train_step

    loss_fn = functools.partial(blended_ce_dice_loss, dice_loss_factor=0.5)
    model = create_model("smp_UNet++", classes=10, device=dev)
    opt = build_optimizer("adam", weight_decay=1e-5)
    state = TrainState.create(model, opt)
    step = make_train_step(model, opt, loss_fn, 10, augment=augment_path_a_batch)
    g = torch.Generator().manual_seed(10)
    images = torch.rand(1, 2, 128, 128, 3, generator=g)
    masks = torch.randint(0, 10, (1, 2, 128, 128), generator=g)
    gen = torch.Generator(device=dev).manual_seed(0)
    k6a, k6b = conv3x3.launches, conv3x3_dw.launches
    losses = []
    for _ in range(4):
        state, m = step(state, images, masks, 1e-3, gen)
        losses.append(float(m["loss"]))
    assert (conv3x3.launches - k6a, conv3x3_dw.launches - k6b) == (4 * 22, 4 * 11)
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    k6a, k7 = conv3x3.launches, confusion_stats.launches
    rep = evaluate_checkpoint(model, [(images[0], masks[0].to(torch.uint8))], 10,
                              loss_fn=loss_fn)
    assert (conv3x3.launches - k6a, confusion_stats.launches - k7) == (11, 1)
    assert np.isfinite(rep["loss"]) and 0.0 <= rep["mean_iou"] <= 1.0


# ------------------------------------------------ K8a, K8b; the zoo on K6

# (B, H, W, Cin, Cout): cin 3 / 8 / 16 / 24, H not a multiple of 16 (nor
# of the 8-row block), cout 1 .. 2 fragments, and the 16 -> 16 shape the
# TPU kernel was written for (conv3x3.py:4-7) at a smaller batch
K8_CONVS = [(2, 21, 30, 3, 16), (2, 16, 32, 8, 8), (1, 40, 24, 16, 24),
            (2, 34, 50, 24, 16), (4, 512, 512, 16, 16)]


@pytest.mark.parametrize("b,h,w,cin,cout", K8_CONVS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_k8a_k8b(dev, b, h, w, cin, cout, dtype):
    """K8a in f32 and bf16 storage, relu on and off, bias and no bias, y
    in x's dtype (f32: within 2e-2 of the plain version, which reads the
    same bf16-rounded x and w); K8b with dy in x's storage type, as the
    VJP passes it."""
    from mmr_tpu_torch.ops.conv3x3 import (conv3x3_shift, conv3x3_shift_dw,
                                           conv3x3_shift_dw_ref,
                                           conv3x3_shift_ref)

    g = torch.Generator(device=dev).manual_seed(11)
    x = _rand(g, dev, b, h, w, cin, dtype=dtype)
    wt = _rand(g, dev, 3, 3, cin, cout, scale=(9 * cin) ** -0.5)
    bias = _rand(g, dev, cout, scale=0.5)
    before = conv3x3_shift.launches
    for relu, bb in ((False, bias), (True, None), (True, bias)):
        y = conv3x3_shift(x, wt, bb, relu)
        assert y.shape == (b, h, w, cout) and y.dtype == dtype
        _close(y, conv3x3_shift_ref(x, wt, bb, relu))
    assert conv3x3_shift.launches == before + 3
    before = conv3x3_shift_dw.launches
    dy = _rand(g, dev, b, h, w, cout, dtype=dtype)
    dw = conv3x3_shift_dw(x, dy)
    assert dw.dtype == torch.float32 and dw.shape == (3, 3, cin, cout)
    _grad_close("dw", dw, conv3x3_shift_dw_ref(x, dy))
    assert conv3x3_shift_dw.launches == before + 1


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_k8_bias_act_force_dispatch(dev, dtype, monkeypatch):
    """``conv3x3_bias_act`` under ``_FORCE``: K8a forward and dx, K8b dW
    (one launch each direction), held against the plain versions of the
    same steps; with ``_FORCE`` off it launches nothing."""
    from mmr_tpu_torch.ops import conv3x3 as k8

    g = torch.Generator(device=dev).manual_seed(12)
    x = _rand(g, dev, 2, 40, 72, 16, dtype=dtype).requires_grad_()
    w = _rand(g, dev, 3, 3, 16, 24, scale=0.08).requires_grad_()
    bias = _rand(g, dev, 24, scale=0.5).requires_grad_()
    gy = _rand(g, dev, 2, 40, 72, 24, dtype=dtype)
    counts = lambda: (k8.conv3x3_shift.launches, k8.conv3x3_shift_dw.launches)
    before = counts()
    monkeypatch.setattr(k8, "_FORCE", False)
    k8.conv3x3_bias_act(x, w, bias, True).backward(gy)
    assert counts() == before
    x.grad = w.grad = bias.grad = None
    monkeypatch.setattr(k8, "_FORCE", True)
    y = k8.conv3x3_bias_act(x, w, bias, True)
    y.backward(gy)
    assert counts() == (before[0] + 2, before[1] + 1)
    with torch.no_grad():
        _close(y, k8.conv3x3_shift_ref(x, w, bias, True))
        gm = torch.where(y > 0, gy.float(), 0.0)
        gin = gm.to(dtype)
        _grad_close("dx", x.grad, k8.conv3x3_shift_ref(
            gin, w.flip(0, 1).transpose(2, 3), torch.zeros(16, device=dev)))
        _grad_close("dw", w.grad, k8.conv3x3_shift_dw_ref(x, gin))
        _grad_close("dbias", bias.grad, gm.sum((0, 1, 2)))


# the zoo's K6 shapes at 256x256, B=8: UNet's cin-3 inc.conv1, UNet's
# up1-side cin 512 -> 256 at 64x64 (up2_conv.conv1), MAnet's block3
# hl_conv1 (64 -> 64 at 64x64 on the 128x128 block's input) and its dx
ZOO_K6 = [(8, 256, 256, 3, 64), (8, 64, 64, 512, 256), (8, 64, 64, 256, 128),
          (8, 64, 64, 64, 64), (8, 256, 256, 64, 3)]


@pytest.mark.parametrize("b,h,w,cin,cout", ZOO_K6)
def test_k6_zoo_shapes(dev, b, h, w, cin, cout):
    test_k6a_k6b(dev, b, h, w, cin, cout)


@pytest.mark.parametrize("arch,k6,dx", [
    ("smp_unet18", 7, 7), ("smp_MANet", 8, 8), ("unet", 12, 11),
    ("segnet", 0, 0), ("resnet18", 0, 0), ("smp_DeepLabV3+", 0, 0)])
def test_zoo_train_and_eval_on_card(dev, arch, k6, dx):
    """Two bf16 Path-A steps of each zoo model at 256x256, B=2 (Adam,
    blended loss, augmentation, dropout from the step's generator): per
    step K6a k6 forward + dx launches (UNet's first conv reads the image,
    which needs no gradient: 11 dx) and K6b k6, the loss finite; one eval
    batch through ``evaluate_checkpoint``: k6 K6a launches and one K7."""
    import contextlib
    import functools
    import io

    from mmr_tpu_torch.data.augment import augment_path_a_batch
    from mmr_tpu_torch.infer.evaluator import evaluate_checkpoint
    from mmr_tpu_torch.losses import blended_ce_dice_loss
    from mmr_tpu_torch.models import create_model
    from mmr_tpu_torch.train.optim import build_optimizer
    from mmr_tpu_torch.train.state import TrainState
    from mmr_tpu_torch.train.steps import make_train_step

    loss_fn = functools.partial(blended_ce_dice_loss, dice_loss_factor=0.5)
    model = create_model(arch, classes=10, device=dev)
    opt = build_optimizer("adam", weight_decay=1e-5)
    state = TrainState.create(model, opt)
    step = make_train_step(model, opt, loss_fn, 10, augment=augment_path_a_batch)
    g = torch.Generator().manual_seed(13)
    images = torch.rand(1, 2, 256, 256, 3, generator=g)
    masks = torch.randint(0, 10, (1, 2, 256, 256), generator=g)
    gen = torch.Generator(device=dev).manual_seed(0)
    k6a, k6b = conv3x3.launches, conv3x3_dw.launches
    for _ in range(2):
        state, m = step(state, images, masks, 1e-3, gen)
        assert np.isfinite(float(m["loss"]))
    assert (conv3x3.launches - k6a, conv3x3_dw.launches - k6b) == (2 * (k6 + dx), 2 * k6)
    k6a, k7 = conv3x3.launches, confusion_stats.launches
    with contextlib.redirect_stdout(io.StringIO()):
        report = evaluate_checkpoint(model, [(images[0], masks[0])], 10)
    assert (conv3x3.launches - k6a, confusion_stats.launches - k7) == (k6, 1)
    assert np.isfinite(report["mean_iou"])
