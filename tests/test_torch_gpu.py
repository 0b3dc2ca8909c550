"""The port's CUDA kernels and its fused model on the card, held against
the plain PyTorch versions (f32, TF32 off) on the same inputs.

Every test is marked ``gpu`` and skips without a CUDA card. The file
imports torch, numpy and the port only (the card's machine has no JAX), so
it also runs there without the JAX-side conftest:

    python -m pytest -m gpu --noconftest tests/test_torch_gpu.py -q

Kernel tolerance: atol = rtol = 2e-2 — both sides read the same bf16
inputs and round the prologue at the same place; accumulation order and
one bf16 rounding of y remain. Moments: rtol 1e-3 of the largest moment
(f32 sums in another order: K1 adds block sums by atomics, K2 in a fixed
order). Backward outputs (dx, dW, d(scale, shift), dbias): max|Δ| /
max|ref| and ‖Δ‖ / ‖ref‖ both < 1e-2 — both sides read the same bf16
inputs and round at the same places; summation order (K3 adds block
partials by atomics, K4 and K5b in a fixed order) and one bf16 rounding
of dx remain, so a dropped tap or a lost correction term fails. K2, K4,
K5a's statistics, K5b, K6b and K8b give bit-equal results on a second
launch. The confusion
kernel counts in integers: exact.
"""

import numpy as np
import pytest
import torch

from mmr_tpu_torch.ops.fused_conv import (Pending, fused_conv, fused_conv_bwd,
                                          fused_conv_bwd_ref, fused_conv_down,
                                          fused_conv_down_bwd,
                                          fused_conv_down_bwd_ref,
                                          fused_conv_down_ref, fused_conv_ref)
from mmr_tpu_torch.ops import conv3x3_packed as k6_ops
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
    ones = torch.ones(40, device=dev)
    head_in = Pending(torch.zeros(1, 8, 16, 40, device=dev, dtype=torch.bfloat16),
                      ones, ones, "relu")
    with pytest.raises(ValueError):          # a head input wider than 32
        head_loss_bwd(head_in, torch.zeros(3, 3, 40, 10, device=dev),
                      torch.zeros(1, 8, 16, 10, device=dev, dtype=torch.bfloat16),
                      torch.zeros(1, 8, 16, device=dev, dtype=torch.long),
                      torch.zeros(1, 4, 10, device=dev))


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
    # the Hopper tiles' edges: W = 80 (a 64-pixel segment and 16 more),
    # 136; lazy x2 inputs of 200 and 320 channels (not multiples of 16)
    ([(200, True), (24, False)], 64, (32, 80), 2),
    ([(320, True), (10, False)], 32, (20, 136), 2),
    # no lazy input: three dx in one launch, columns padded to 8
    ([(16, False), (10, False), (24, False)], 16, (24, 72), 2),
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


@pytest.mark.parametrize("spec,cout,hw,batch", [TRAIN_CONVS[i] for i in (0, 2, 6)])
def test_k3_thru_addend(dev, spec, cout, hw, batch):
    """K3 with a ``thru`` addend on every input (a lazy ×2 input's at its
    source resolution): dx against the plain version with the same
    addend; d scale / d shift and dW equal the launch without addends
    (the addend is no part of this consumer's share)."""
    g = torch.Generator(device=dev).manual_seed(17)
    H, W = hw
    ins, ws = [], []
    for j, (c, up) in enumerate(spec):
        h, w = (H // 2, W // 2) if up else (H, W)
        x = _rand(g, dev, batch, h, w, c, dtype=torch.bfloat16)
        s = torch.rand(c, device=dev, generator=g) + 0.5
        ins.append(Pending(x, s, _rand(g, dev, c, scale=0.3), "relu", up))
        ws.append(_rand(g, dev, 3, 3, c, cout, scale=0.1))
    y = fused_conv(ins, ws)
    dy = _rand(g, dev, batch, H, W, cout, dtype=torch.bfloat16)
    daccs = [_rand(g, dev, *p.raw.shape, dtype=torch.bfloat16) for p in ins]
    before = fused_conv_bwd.launches
    got = fused_conv_bwd(ins, ws, y, dy, None, False, daccs)
    assert fused_conv_bwd.launches == before + 1
    want = fused_conv_bwd_ref(ins, ws, y, dy, None, False, daccs)
    plain = fused_conv_bwd(ins, ws, y, dy)
    for j in range(len(ins)):
        _grad_close(f"dx{j}", got[0][j], want[0][j])
        _grad_close(f"dw{j}", got[1][j], plain[1][j])
        for a, b in zip(got[2][j], plain[2][j]):
            _grad_close(f"dpro{j}", a, b)


# the depthwise mode of K1 / K3 (the stride-1 depthwise tile): the mbv3
# b1_1's C = 88 at its B=8 512x640 shape, ragged H and W, and other C
# (16: the warp-shuffle sums; 24, 96)
@pytest.mark.parametrize("c,act,bias,hw,batch", [
    (88, "relu", False, (64, 80), 8),
    (88, "relu", True, (33, 65), 2),
    (16, "hswish", True, (34, 66), 2),
    (24, "linear", False, (1, 70), 2),
    (96, "relu", True, (130, 258), 2),
])
def test_depthwise_k1_k3(dev, c, act, bias, hw, batch):
    """K1's and K3's depthwise mode vs their plain versions (the grouped
    stride-1 conv): y and its moments, dx, dW, d scale / d shift, dbias; the
    launches counted under ``fused_conv`` / ``fused_conv_bwd``; a second
    launch bit-equal."""
    g = torch.Generator(device=dev).manual_seed(18)
    x = _rand(g, dev, batch, *hw, c, dtype=torch.bfloat16)
    s = torch.rand(c, device=dev, generator=g) + 0.5
    p = Pending(x, s, _rand(g, dev, c, scale=0.3), act)
    w = _rand(g, dev, 3, 3, 1, c, scale=0.3)
    b = _rand(g, dev, c, scale=0.5) if bias else None
    before = fused_conv.launches
    y, mom = fused_conv([p], [w], b, emit_moments=True, depthwise=True)
    assert fused_conv.launches == before + 1 and y.shape == (batch, *hw, c)
    y_ref, mom_ref = fused_conv_ref([p], [w], b, emit_moments=True,
                                    depthwise=True)
    _close(y, y_ref)
    _mom_close(mom, mom_ref)
    y2, mom2 = fused_conv([p], [w], b, emit_moments=True, depthwise=True)
    assert torch.equal(y, y2) and torch.equal(mom, mom2)
    dy = _rand(g, dev, *y.shape, dtype=torch.bfloat16)
    dmom = _rand(g, dev, 2, c, scale=1e-3)
    args = ([p], [w], y, dy, dmom, bias, None, True)
    before = fused_conv_bwd.launches
    got = fused_conv_bwd(*args)
    assert fused_conv_bwd.launches == before + 1
    want = fused_conv_bwd_ref(*args)
    again = fused_conv_bwd(*args)
    _grad_close("dx", got[0][0], want[0][0])
    _grad_close("dw", got[1][0], want[1][0])
    for a, r in zip(got[2][0], want[2][0]):
        _grad_close("dpro", a, r)
    if bias:
        _grad_close("dbias", got[3], want[3])
    assert torch.equal(got[0][0], again[0][0]) and torch.equal(got[1][0],
                                                               again[1][0])
    with pytest.raises(ValueError):          # wider than the kernels take
        wide = Pending(_rand(g, dev, 1, 4, 8, 104, dtype=torch.bfloat16))
        fused_conv([wide], [_rand(g, dev, 3, 3, 1, 104)], depthwise=True)


def test_fused_b1_encoder_on_card(dev):
    """The encoder with ``fused_b1`` at 2 × 128 × 256 against the plain
    encoder on the same weights: f3 within 0.04 of its largest value in
    eval and train mode; one K2 + K4 (b0_0, b1_0), one depthwise K1 + K3
    (b1_1) more than the fused front-end alone; finite gradients."""
    from mmr_tpu_torch.models.encoders import get_encoder
    from mmr_tpu_torch.models.layers import nchw

    spec = get_encoder("tu-mobilenetv3_small_100")
    g = torch.Generator().manual_seed(19)
    plain = spec.build().to(dev)
    fused = spec.build(fused_frontend=True, fused_b1=True).to(dev)
    fused.load_state_dict(plain.state_dict())
    x = torch.rand(2, 128, 256, 3, generator=g).to(dev)
    x = nchw(x.to(torch.bfloat16)).contiguous(memory_format=torch.channels_last)
    for train in (False, True):
        plain.train(train)
        fused.train(train)
        counts = [f.launches for f in (fused_conv, fused_conv_bwd,
                                       fused_conv_down, fused_conv_down_bwd)]
        with torch.set_grad_enabled(train):
            want = plain(x)[2].float()
            got = fused(x)[2]
            if train:
                got.float().square().sum().backward()
        now = [f.launches for f in (fused_conv, fused_conv_bwd,
                                    fused_conv_down, fused_conv_down_bwd)]
        assert [b - a for a, b in zip(counts, now)] == (
            [1, 1, 3, 3] if train else [1, 0, 3, 0])
        rel = ((got.float() - want).abs().max() / want.abs().max()).item()
        assert rel < 0.04, (train, rel)
    grads = [p.grad for n, p in fused.named_parameters() if n.startswith("b1_")]
    assert grads and all(gr is not None and bool(torch.isfinite(gr).all())
                         for gr in grads)


def test_threaded_step_matches_unthreaded_on_card(dev):
    """The fused model's train-mode gradients with ``thread_dx`` on and off
    (2 × 128 × 256, every node fused: 16 threaded inputs), two runs of each:
    losses within 1e-3, and the threaded gradient's cosine to the
    unthreaded one no further below 1 than the runs' own (less 0.005). A
    run does not repeat itself: K1 adds its moments and K3 its dW by f32
    atomics, and train-mode BN over the coarse nodes' 64 values a channel
    amplifies that to a cosine of 0.994 between two identical runs on an
    H100; at the flagship's 512×640 B=8 it is 0.9997."""
    from mmr_tpu_torch.losses import dice_ce_loss
    from mmr_tpu_torch.models import create_model

    g = torch.Generator().manual_seed(20)
    x = torch.rand(2, 128, 256, 3, generator=g).to(dev)
    labels = torch.randint(0, 10, (2, 128, 256), generator=g).to(dev)
    runs = {}
    for thread in (True, False, True, False):
        m = create_model(classes=10, device=dev, fused=True, fused_frontend=True,
                         packed_min_hw=0, thread_dx=thread)
        m.train()
        loss = dice_ce_loss(m(x), labels)
        loss.backward()
        assert m.threaded_inputs == (16 if thread else 0)
        runs.setdefault(thread, []).append(
            (loss.item(), torch.cat([q.grad.flatten() for q in m.parameters()])))
    cos = lambda a, b: (a.double() @ b.double()
                        / (a.double().norm() * b.double().norm())).item()
    (lt, t1), (_, t2) = runs[True]
    (lu, u1), (_, u2) = runs[False]
    assert abs(lt - lu) <= 1e-3 * abs(lu)
    assert cos(t1, u1) >= min(cos(t1, t2), cos(u1, u2)) - 0.005


# the smp Unet over tu-convnextv2_tiny, B=8 512x640 (chip_smoke.py phase
# 13): the fused blocks' conv1 — block 1's lazy x2 256 beside the raw
# 192-channel skip (448 in, the widest concat a K1 launch meets), block 2's
# 128 + 96, block 3's lone lazy 64 — then the widest concat at a ragged H
# and W, and one raw 64 -> 32 input alone
PUB_CONVS = [
    ([(256, True), (192, False)], 128, (64, 80), 8),
    ([(128, True), (96, False)], 64, (128, 160), 8),
    ([(64, True)], 32, (256, 320), 8),
    ([(256, True), (192, False)], 128, (62, 84), 2),
    ([(64, False)], 32, (42, 70), 2),
]


@pytest.mark.parametrize("spec,cout,hw,batch", PUB_CONVS)
def test_k1_k3_published_unet_shapes(dev, spec, cout, hw, batch):
    test_k1_moments_and_k3(dev, spec, cout, hw, batch)


# K1 on the Hopper tile's edges: W = 80 (a 64-pixel segment and 16 more),
# H = 20 (not a multiple of a block's 8 rows), 1, 4 and 8 inputs with a
# lazy x2 input and 24 / 48-channel inputs (chunks padded to 16), cout 16,
# 32, 64 and 256; (input channels, lazily upsampled?) per input
K1_EDGES = [
    ([(24, False)], 16),
    ([(16, True), (24, False), (48, False), (16, False)], 32),
    ([(32, True), (24, False), (24, False), (48, False), (16, False),
      (16, False), (8, False), (5, False)], 64),
    ([(256, True), (24, False), (24, False), (48, False)], 256),
]


def _k1_inputs(g, dev, spec, cout, hw, batch):
    """Pending inputs (acts relu, hswish, linear and none in turn) and
    their HWIO weight slices."""
    H, W = hw
    ins, ws = [], []
    for j, (c, up) in enumerate(spec):
        h, w = (H // 2, W // 2) if up else (H, W)
        x = _rand(g, dev, batch, h, w, c, dtype=torch.bfloat16)
        act = ["relu", "hswish", "linear", None][j % 4]
        s = torch.rand(c, device=dev, generator=g) + 0.5
        t = _rand(g, dev, c, scale=0.3)
        ins.append(Pending(x, up2x=up) if act is None
                   else Pending(x, s, t, act, up))
        ws.append(_rand(g, dev, 3, 3, c, cout, scale=0.1))
    return ins, ws


@pytest.mark.parametrize("mom", [False, True])
@pytest.mark.parametrize("spec,cout", K1_EDGES)
def test_k1_hopper_edges(dev, spec, cout, mom):
    g = torch.Generator(device=dev).manual_seed(14)
    ins, ws = _k1_inputs(g, dev, spec, cout, (20, 80), 2)
    bias = _rand(g, dev, cout)
    before = fused_conv.launches
    got = fused_conv(ins, ws, bias, emit_moments=mom)
    assert fused_conv.launches == before + 1
    want = fused_conv_ref(ins, ws, bias, emit_moments=mom)
    if mom:
        _close(got[0], want[0])
        _mom_close(got[1], want[1])
    else:
        _close(got, want)


@pytest.mark.parametrize("ntile", [16, 32, 64])
def test_k1_tiles_agree(dev, ntile, monkeypatch):
    """Every output-channel tile K1 can take gives the plain result."""
    from mmr_tpu_torch.ops import fused_conv as fc

    g = torch.Generator(device=dev).manual_seed(15)
    ins, ws = _k1_inputs(g, dev, [(24, True), (40, False)], 96, (18, 136), 2)
    monkeypatch.setitem(fc.K1_TILE, 96, ntile)
    y, mom = fused_conv(ins, ws, emit_moments=True)
    y_ref, mom_ref = fused_conv_ref(ins, ws, emit_moments=True)
    _close(y, y_ref)
    _mom_close(mom, mom_ref)


@pytest.mark.parametrize("depthwise,cin,cout,act,bias,hw,batch", [
    (False, 3, 16, None, False, (34, 66), 2),
    (True, 16, 16, "hswish", False, (34, 66), 2),
    (False, 3, 16, None, False, (512, 640), 8),        # the stem
    (True, 16, 16, "hswish", False, (256, 320), 8),    # b0_0
    (False, 16, 16, "relu", True, (34, 66), 2),        # a prologue, a bias
    (False, 3, 16, None, False, (33, 65), 2),          # odd H and W
    (True, 16, 16, "hswish", True, (33, 65), 2),
    (False, 4, 5, "hswish", True, (1, 65), 2),         # a 1-row image
    (True, 16, 16, "relu", False, (1, 65), 2),
    # the channels' edges, with more tiles than blocks (a block walks
    # several): depthwise C 8, 32, 64 (one raw buffer), dense Cout 32
    (True, 8, 8, "relu", True, (130, 258), 8),
    (True, 32, 32, "hswish", True, (130, 258), 8),
    (True, 64, 64, "linear", True, (130, 258), 8),
    (False, 16, 32, "hswish", True, (130, 258), 8),
    (False, 3, 32, None, False, (66, 130), 2),
    # C where c / 8 does not divide the block's threads: the mbv3 b1_0's
    # 72 at its B=8 512x640 shape (16-column tiles above 64 channels), 72
    # and 88 ragged, 24 (one raw buffer never needed) and 96, the widest
    (True, 72, 72, "relu", False, (128, 160), 8),
    (True, 72, 72, "relu", True, (33, 65), 2),
    (True, 88, 88, "hswish", True, (130, 258), 2),
    (True, 24, 24, "linear", False, (34, 66), 2),
    (True, 96, 96, "relu", True, (66, 130), 2),
])
def test_k2_moments_and_k4(dev, depthwise, cin, cout, act, bias, hw, batch):
    """K2 with moments and K4 (dense: dW alone as the stem, then with dx;
    depthwise: with dx) vs their plain versions; a second launch on the
    same inputs gives bit-equal y, moments, dx, dW, dscale, dshift, dbias."""
    g = torch.Generator(device=dev).manual_seed(4)
    x = _rand(g, dev, batch, *hw, cin, dtype=torch.bfloat16)
    s = torch.rand(cin, device=dev, generator=g) + 0.5
    t = _rand(g, dev, cin, scale=0.3)
    p = Pending(x) if act is None else Pending(x, s, t, act)
    w = _rand(g, dev, 3, 3, 1 if depthwise else cin, cout, scale=0.3)
    b = _rand(g, dev, cout, scale=0.5) if bias else None
    y, mom = fused_conv_down(p, w, b, depthwise, emit_moments=True)
    y_ref, mom_ref = fused_conv_down_ref(p, w, b, depthwise, emit_moments=True)
    _close(y, y_ref)
    _mom_close(mom, mom_ref)
    y2, mom2 = fused_conv_down(p, w, b, depthwise, emit_moments=True)
    assert torch.equal(y, y2) and torch.equal(mom, mom2)
    dy = _rand(g, dev, *y.shape, dtype=torch.bfloat16)
    dmom = _rand(g, dev, 2, cout, scale=1e-3)
    for need_dx in (True,) if depthwise else (False, True):
        args = (p, w, y, dy, dmom, bias, depthwise, need_dx)
        before = fused_conv_down_bwd.launches
        got = fused_conv_down_bwd(*args)
        assert fused_conv_down_bwd.launches == before + 1
        want = fused_conv_down_bwd_ref(*args)
        again = fused_conv_down_bwd(*args)
        names = ["dx", "dw", "dpro", "dbias"]
        for name, a, r, a2 in zip(names, got, want, again):
            assert (a is None) == (r is None) == (a2 is None), name
            if a is None:
                continue
            for u, v, u2 in zip(*(z if isinstance(z, tuple) else (z,)
                                  for z in (a, r, a2))):
                _grad_close(name, u, v)
                assert torch.equal(u, u2), name


def test_k2_k4_launch_in_any_order(dev):
    """A launch does not depend on the launches before it: the kernels'
    shared memory changes with the channels, and a smaller launch of a
    kernel followed by a larger one must still run (dense Cin 16, 4, 16;
    depthwise C 32, 16, 32, 64, 16)."""
    g = torch.Generator(device=dev).manual_seed(16)
    for depthwise, cin, cout in [(False, 16, 16), (False, 4, 16),
                                 (False, 16, 32), (True, 32, 32),
                                 (True, 16, 16), (True, 32, 32),
                                 (True, 64, 64), (True, 16, 16),
                                 (True, 72, 72), (True, 16, 16)]:
        x = _rand(g, dev, 2, 18, 34, cin, dtype=torch.bfloat16)
        s = torch.rand(cin, device=dev, generator=g) + 0.5
        p = Pending(x, s, _rand(g, dev, cin, scale=0.3), "relu")
        w = _rand(g, dev, 3, 3, 1 if depthwise else cin, cout, scale=0.3)
        y, mom = fused_conv_down(p, w, None, depthwise, emit_moments=True)
        y_ref, mom_ref = fused_conv_down_ref(p, w, None, depthwise,
                                             emit_moments=True)
        _close(y, y_ref)
        _mom_close(mom, mom_ref)
        dy = _rand(g, dev, *y.shape, dtype=torch.bfloat16)
        for need_dx in (True,) if depthwise else (False, True):
            args = (p, w, y, dy, None, False, depthwise, need_dx)
            got = fused_conv_down_bwd(*args)
            want = fused_conv_down_bwd_ref(*args)
            _grad_close("dw", got[1], want[1])
            if need_dx:
                _grad_close("dx", got[0], want[0])


# (H, W), batch, classes, input channels, with_conf, label type: the
# flagship's shape, then ragged H and W (tiles cut by the image's edge), n
# = 3, nc 1 .. 16, cin 8, 24 and 48 (two 32-channel chunks), labels in
# every type the kernel reads, with ids outside [0, nc) among them
K5_CASES = [((20, 40), 2, 3, 16, True, torch.int64),
            ((512, 640), 8, 10, 16, True, torch.int64),
            ((9, 70), 3, 10, 16, True, torch.uint8),
            ((20, 136), 3, 16, 16, False, torch.int32),
            ((20, 136), 2, 1, 16, True, torch.int64),
            ((9, 70), 3, 3, 16, False, torch.int64),
            ((9, 70), 2, 10, 8, True, torch.int32),
            ((20, 136), 3, 10, 24, True, torch.uint8),
            ((20, 136), 2, 16, 48, True, torch.int64),
            ((13, 80), 3, 1, 24, False, torch.int32),
            ((13, 80), 2, 3, 48, False, torch.uint8),
            ((9, 70), 3, 16, 8, True, torch.int64)]


@pytest.mark.parametrize("hw,batch,nc,cin,with_conf,ldt", K5_CASES)
def test_k5_head_loss(dev, hw, batch, nc, cin, with_conf, ldt):
    """K5a against its plain version (logp 2e-2, stats rtol 2e-2 / atol 1e-3
    of the largest, conf within 1e-3 of its total: a near tie may flip an
    argmax), conf zero without with_conf, the labelled pixels counted
    exactly, stats and conf bit-equal on a second launch; then K5b on its
    log-probs where it takes the input (cin <= 32)."""
    g = torch.Generator(device=dev).manual_seed(5)
    x = Pending(_rand(g, dev, batch, *hw, cin, dtype=torch.bfloat16),
                torch.rand(cin, device=dev, generator=g) + 0.5,
                _rand(g, dev, cin, scale=0.3), "relu")
    w = _rand(g, dev, 3, 3, cin, nc, scale=0.3 * (16 / cin) ** 0.5)
    bias = _rand(g, dev, nc, scale=0.1)
    labels = torch.randint(-1, nc, (batch, *hw), device=dev, generator=g)
    if ldt == torch.uint8:
        labels = torch.where(labels < 0, 255, labels)
    labels = labels.to(ldt)
    before = head_loss_fwd.launches
    logp, stats, conf = head_loss_fwd(x, w, bias, labels, with_conf)
    assert head_loss_fwd.launches == before + 1
    logp_r, stats_r, conf_r = head_loss_fwd_ref(x, w, bias, labels, with_conf)
    _close(logp, logp_r)
    torch.testing.assert_close(stats, stats_r, rtol=2e-2, atol=1e-3 * stats_r.abs().max().item())
    labelled = ((labels.long() >= 0) & (labels.long() < nc)).sum().item()
    if with_conf:
        assert (conf - conf_r).abs().sum().item() <= 1e-3 * conf_r.sum().item()
        assert conf.sum().item() == labelled
    else:
        assert not conf.any()
    again = head_loss_fwd(x, w, bias, labels, with_conf)
    torch.cuda.synchronize()
    assert torch.equal(again[1], stats) and torch.equal(again[2], conf)
    if cin > 32:
        return
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


@pytest.mark.parametrize("nc", [10, 16])
@pytest.mark.parametrize("cin", [16, 24])
def test_k5b_ragged_tile(dev, nc, cin):
    """K5b over tiles cut by the image's edge (H not a multiple of a tile's
    4 rows, W not of its 64 pixels): dx, dW, d(scale, shift) and dbias
    against the plain version; a 24-channel input takes the 32-wide tile."""
    g = torch.Generator(device=dev).manual_seed(16)
    batch, hw = 3, (22, 100)
    x = Pending(_rand(g, dev, batch, *hw, cin, dtype=torch.bfloat16),
                torch.rand(cin, device=dev, generator=g) + 0.5,
                _rand(g, dev, cin, scale=0.3), "relu")
    w = _rand(g, dev, 3, 3, cin, nc, scale=0.3)
    labels = torch.randint(-1, nc, (batch, *hw), device=dev, generator=g)
    logp = torch.log_softmax(_rand(g, dev, batch, *hw, nc, scale=2.0), -1)
    logp = logp.to(torch.bfloat16)
    dstats = _rand(g, dev, batch, 4, nc, scale=1e-3)
    dstats[:, 3] = 1.0 / labels.numel()
    got = head_loss_bwd(x, w, logp, labels, dstats)
    want = head_loss_bwd_ref(x, w, logp, labels, dstats)
    for name, a, b in zip(["dx", "dw", "dscale", "dshift", "dbias"],
                          [got[0], got[1], *got[2], got[3]],
                          [want[0], want[1], *want[2], want[3]]):
        assert a.shape == b.shape, name
        _grad_close(name, a, b)
    again = head_loss_bwd(x, w, logp, labels, dstats)
    torch.cuda.synchronize()
    assert torch.equal(got[1], again[1]) and torch.equal(got[3], again[3])


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
# head, and the head's dx (K6a over its cotangent: Cin 10 -> Cout 16), and
# the step's other cout-64 dW shapes (cin 64 .. 320 at 64x64 and 128x128)
K6_CONVS = [(2, 18, 40, 5, 10), (2, 16, 32, 24, 200),
            (8, 64, 64, 320, 64), (8, 128, 128, 320, 32),
            (8, 128, 128, 64, 64), (8, 256, 256, 16, 16),
            (8, 256, 256, 16, 10), (8, 256, 256, 10, 16),
            (8, 128, 128, 256, 64), (8, 128, 128, 192, 64),
            (8, 128, 128, 128, 64), (8, 64, 64, 256, 64),
            (8, 64, 64, 192, 64), (8, 64, 64, 64, 64),
            # the Hopper tiles' edges: odd H, W = 80 and 136, 200 channels
            (2, 19, 80, 200, 64), (2, 9, 136, 320, 10), (1, 33, 40, 10, 5)]


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
    assert dw.shape == (3, 3, cin, cout) and dw.dtype == torch.float32
    _grad_close("dw", dw, conv3x3_dw_ref(x, gy))
    assert torch.equal(conv3x3_dw(x, gy), dw)    # no atomics: the same bits


# Segformer's head over mit_b2 at B=8 512x640: 256 -> 10 at stride 4
# (128x160), its dx 10 -> 256, and the same at a ragged H and W
PUB_K6 = [(8, 128, 160, 256, 10), (8, 128, 160, 10, 256), (2, 33, 70, 256, 10)]


@pytest.mark.parametrize("b,h,w,cin,cout", PUB_K6)
def test_k6_segformer_head_shapes(dev, b, h, w, cin, cout):
    test_k6a_k6b(dev, b, h, w, cin, cout)


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


@pytest.mark.parametrize("fwd_kernel,bwd_kernel", [(True, False), (False, True)])
def test_k6_routes_apart(dev, fwd_kernel, bwd_kernel):
    """``conv3x3p_bias_act`` with its forward and its backward on different
    routes (the per-shape table decides each apart), at Segformer's head
    (256 → 10 at 128×160): the
    kernel direction launches K6a / K6b, the other none; y, dx, dW and
    dbias held against the plain versions on the same bf16 cotangent (y
    of the library route: the weights and the bias rounded to bf16)."""
    g = torch.Generator(device=dev).manual_seed(12)
    x = _rand(g, dev, 8, 128, 160, 256, dtype=torch.bfloat16).requires_grad_()
    w = _rand(g, dev, 3, 3, 256, 10, scale=0.02).requires_grad_()
    bias = _rand(g, dev, 10, scale=0.5).requires_grad_()
    gy = _rand(g, dev, 8, 128, 160, 10, dtype=torch.bfloat16)
    k6a, k6b = conv3x3.launches, conv3x3_dw.launches
    y = conv3x3p_bias_act(x, w, bias, False, fwd_kernel, bwd_kernel)
    assert conv3x3.launches - k6a == int(fwd_kernel)
    y.backward(gy)
    assert conv3x3.launches - k6a == int(fwd_kernel) + int(bwd_kernel)
    assert conv3x3_dw.launches - k6b == int(bwd_kernel)
    with torch.no_grad():
        b16 = bias if fwd_kernel else bias.to(torch.bfloat16)
        _close(y, conv3x3_ref(x, w, b16))
        _grad_close("dx", x.grad, conv3x3_ref(gy, w.flip(0, 1).transpose(2, 3)))
        _grad_close("dw", w.grad, conv3x3_dw_ref(x, gy))
        _grad_close("dbias", bias.grad, gy.float().sum((0, 1, 2)))


@pytest.mark.parametrize("shape,pdt,gdt,nc", [
    ((4, 256, 256), torch.int64, torch.uint8, 10),     # Path A's eval batch
    ((3, 37, 53), torch.int64, torch.int64, 10),
    ((2, 100, 100), torch.int32, torch.int64, 128),
    ((1, 7, 9), torch.uint8, torch.uint8, 3),
    ((1, 1080, 1920), torch.uint8, torch.int64, 10),   # a full-HD pair
    ((2, 301, 203), torch.int32, torch.int32, 10),
    ((3, 97, 131), torch.int64, torch.int32, 128)])
def test_k7_confusion(dev, shape, pdt, gdt, nc):
    """Exact, and the same from run to run; ids outside [0, nc) (negative
    sentinels, ids >= nc, uint8 255) count nowhere. One launch a call, f32
    stats or counts added into an int64 (3, nc) total."""
    g = torch.Generator(device=dev).manual_seed(9)
    pred, gt = _k7_ids(g, dev, shape, pdt, gdt, nc)
    before = confusion_stats.launches
    got = confusion_stats(pred, gt, nc)
    again = confusion_stats(pred, gt, nc)
    total = torch.full((3, nc), 5, dtype=torch.int64, device=dev)
    assert confusion_stats(pred, gt, nc, total=total) is total
    confusion_stats(pred, gt, nc, total=total)
    assert confusion_stats.launches == before + 4
    torch.cuda.synchronize()
    want = confusion_stats_ref(pred, gt, nc)
    for a, b, c in zip(got, want, again):
        assert a.dtype == torch.float32 and a.shape == (nc,)
        assert torch.equal(a, b) and torch.equal(a, c)
    assert torch.equal(total, 5 + 2 * torch.stack(want).long())
    ref_total = torch.full((3, nc), 5, dtype=torch.int64, device=dev)
    assert confusion_stats_ref(pred, gt, nc, total=ref_total) is ref_total
    assert torch.equal(ref_total, 5 + torch.stack(want).long())


def _k7_ids(g, dev, shape, pdt, gdt, nc):
    def ids(dt):
        lo = 0 if dt == torch.uint8 else -2
        a = torch.randint(lo, nc + 3, shape, device=dev, generator=g)
        if dt == torch.uint8:
            a[..., :2] = 255
        return a.to(dt)

    pred, gt = ids(pdt), ids(gdt)
    gt[0, :4] = pred[0, :4].to(gdt)                # agreements
    return pred, gt


@pytest.mark.parametrize("pdt,gdt,poff,goff,n", [
    (torch.uint8, torch.uint8, 1, 0, 1000),    # no pixel aligns both maps
    (torch.uint8, torch.uint8, 1, 1, 4099),    # both a byte in: a scalar head
    (torch.uint8, torch.int64, 3, 1, 7777),
    (torch.int32, torch.int32, 2, 2, 33),
    (torch.int64, torch.uint8, 0, 0, 5),       # fewer pixels than a vector
    (torch.int64, torch.int64, 1, 0, 100003)])
def test_k7_views_at_offsets(dev, pdt, gdt, poff, goff, n):
    """Maps that are views starting ``off`` elements into their storage
    (not 16-byte aligned), with n no multiple of 16: the scalar head and
    tail around the vectors, or scalar reads throughout."""
    g = torch.Generator(device=dev).manual_seed(11)
    pred = torch.randint(0, 12, (n + poff,), device=dev, generator=g).to(pdt)[poff:]
    gt = torch.randint(0, 12, (n + goff,), device=dev, generator=g).to(gdt)[goff:]
    gt[: n // 3] = pred[: n // 3].to(gdt)
    got = confusion_stats(pred, gt, 10)
    again = confusion_stats(pred, gt, 10)
    torch.cuda.synchronize()
    for a, b, c in zip(got, confusion_stats_ref(pred, gt, 10), again):
        assert torch.equal(a, b) and torch.equal(a, c)


def test_k7_streams_and_graphs(dev):
    """Each stream has its own scratch: launches on two streams and the
    replays of a captured launch all give the exact counts."""
    g = torch.Generator(device=dev).manual_seed(13)
    pred, gt = _k7_ids(g, dev, (2, 130, 70), torch.int64, torch.uint8, 10)
    want = torch.stack(confusion_stats_ref(pred, gt, 10)).long()
    total = torch.zeros((3, 10), dtype=torch.int64, device=dev)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    confusion_stats(pred, gt, 10, total=total)
    with torch.cuda.stream(side):
        got = torch.stack(confusion_stats(pred, gt, 10))
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            confusion_stats(pred, gt, 10, total=total)
    torch.cuda.current_stream().wait_stream(side)
    for _ in range(3):
        graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(got, want.float()) and torch.equal(total, 4 * want)


def test_evaluate_add_batch_makes_no_sync(dev):
    """``Evaluate.add_batch`` leaves its counts on the card: no host sync
    (sync debug mode "error"); the counts read afterwards equal the plain
    version's."""
    from mmr_tpu_torch.metrics.evaluate import Evaluate

    g = torch.Generator(device=dev).manual_seed(12)
    logits = torch.randn(2, 64, 96, 10, device=dev, generator=g)
    masks = torch.randint(0, 10, (2, 64, 96), device=dev, generator=g).to(torch.uint8)
    ev = Evaluate(10)
    ev.add_batch(logits, masks)                 # allocations and scratch
    torch.cuda.synchronize()
    old = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        ev.add_batch(logits, masks)
        ev.add_batch(logits.argmax(-1), masks)
    finally:
        torch.cuda.set_sync_debug_mode(old)
    want = torch.stack(confusion_stats_ref(logits.argmax(-1), masks, 10))
    np.testing.assert_array_equal(np.stack([ev.tp, ev.fp, ev.fn]),
                                  3 * want.double().cpu().numpy())


def _k6_hooks(model):
    """Forward pre-hooks on every ``Conv3x3`` of ``model`` that note (h, w,
    cin, cout, needs dx) of each bf16 conv a forward runs; returns (the
    list they fill, their handles)."""
    from mmr_tpu_torch.models.layers import Conv3x3

    shapes = []

    def hook(m, a):
        if a[0].dtype == torch.bfloat16:
            shapes.append((a[0].shape[2], a[0].shape[3], m.in_channels,
                           m.out_channels, a[0].requires_grad))
    return shapes, [m.register_forward_pre_hook(hook) for m in model.modules()
                    if isinstance(m, Conv3x3)]


def _table_k6(shapes) -> tuple[int, int, int]:
    """(K6a forwards, K6a dx, K6b) the committed dispatch table asks of one
    train step over these Conv3x3 shapes: each forward at (h, w, cin,
    cout), each backward at (h, w, cout, cin), a dx where the input needs a
    gradient."""
    from mmr_tpu_torch.ops.conv3x3_packed import use_kernel

    bf16 = torch.bfloat16
    bwd = [use_kernel(bf16, h, w, co, ci) for h, w, ci, co, _ in shapes]
    return (sum(use_kernel(bf16, h, w, ci, co) for h, w, ci, co, _ in shapes),
            sum(b and s[4] for b, s in zip(bwd, shapes)), sum(bwd))


def test_path_a_train_and_eval_on_card(dev):
    """A few Path-A steps (UNet++/ResNet-18 in bf16, Adam, blended loss,
    Path-A augmentation) at 128x128: 23 bf16 Conv3x3s, 11 of them at H·W >=
    4096; the K6a / K6b launches a step are those the committed dispatch
    table asks of their shapes (a shape it lacks takes K6 at H·W >= 4096);
    the loss is finite and falls; then ``evaluate_checkpoint``: one K7
    launch and the table's K6a forwards per batch."""
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
    shapes, hooks = _k6_hooks(model)
    losses = []
    for _ in range(4):
        state, m = step(state, images, masks, 1e-3, gen)
        losses.append(float(m["loss"]))
        for h in hooks:
            h.remove()
    assert len(shapes) == 23 and sum(s[0] * s[1] >= 4096 for s in shapes) == 11
    fwd, dx, dw = _table_k6(shapes)
    assert (conv3x3.launches - k6a, conv3x3_dw.launches - k6b) == (4 * (fwd + dx), 4 * dw)
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    k6a, k7 = conv3x3.launches, confusion_stats.launches
    rep = evaluate_checkpoint(model, [(images[0], masks[0].to(torch.uint8))], 10,
                              loss_fn=loss_fn)
    assert (conv3x3.launches - k6a, confusion_stats.launches - k7) == (fwd, 1)
    assert np.isfinite(rep["loss"]) and 0.0 <= rep["mean_iou"] <= 1.0


# ------------------------------------------------ K8a, K8b; the zoo on K6

# (B, H, W, Cin, Cout): cin 3 / 8 / 16 / 24, H not a multiple of 16 (nor
# of the 8-row block), cout 1 .. 2 fragments, the 16 -> 16 shape the TPU
# kernel was written for (conv3x3.py:4-7) at a smaller batch and at its
# own (more pixel tiles than the dW grid has blocks), and dW's wide modes
# (K8a's convs above 32 channels on K6a's kernel); last, a narrow-tile
# case at a ragged width with 4-byte staging (cin 12) and 20 outputs
K8_CONVS = [(2, 21, 30, 3, 16), (2, 16, 32, 8, 8), (1, 40, 24, 16, 24),
            (2, 34, 50, 24, 16), (4, 512, 512, 16, 16), (2, 17, 136, 10, 5),
            (32, 512, 512, 16, 16), (2, 19, 80, 72, 64), (2, 9, 136, 40, 24),
            (3, 21, 70, 12, 20)]


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
    assert torch.equal(conv3x3_shift_dw(x, dy), dw)


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


def test_k8a_launch_in_any_order(dev):
    """A K8a launch does not depend on the launches before it: narrow-tile
    launches (each kernel's shared memory and attributes set on its own
    launch), launches on K6a's kernel, bf16 and f32 storage, mixed."""
    from mmr_tpu_torch.ops.conv3x3 import conv3x3_shift, conv3x3_shift_ref

    g = torch.Generator(device=dev).manual_seed(19)
    for cin, cout, dtype in [(16, 16, torch.bfloat16), (72, 64, torch.bfloat16),
                             (3, 16, torch.float32), (24, 16, torch.bfloat16),
                             (16, 24, torch.float32), (40, 24, torch.bfloat16),
                             (5, 5, torch.bfloat16), (32, 32, torch.bfloat16),
                             (16, 16, torch.float32), (16, 16, torch.bfloat16)]:
        x = _rand(g, dev, 2, 18, 70, cin, dtype=dtype)
        w = _rand(g, dev, 3, 3, cin, cout, scale=(9 * cin) ** -0.5)
        bias = _rand(g, dev, cout, scale=0.5)
        _close(conv3x3_shift(x, w, bias, True), conv3x3_shift_ref(x, w, bias, True))


# K6b's and K8b's narrow inputs (mma.sync: cin <= 32) against every output
# width class; odd H, W = 80 and 136 (partial 64-pixel tiles)
DW_NARROW = [(cin, cout) for cin in (3, 5, 10, 16, 24, 32)
             for cout in (5, 10, 16, 24, 64)]


@pytest.mark.parametrize("cin,cout", DW_NARROW)
def test_k6b_k8b_narrow(dev, cin, cout):
    """K6b (bf16) and K8b (bf16 and f32 storage) at cin <= 32, each held
    against its plain version and bit-equal on a second launch."""
    from mmr_tpu_torch.ops.conv3x3 import (conv3x3_shift_dw,
                                           conv3x3_shift_dw_ref)

    g = torch.Generator(device=dev).manual_seed(17)
    for b, h, w in ((2, 19, 80), (1, 17, 136)):
        x = _rand(g, dev, b, h, w, cin, dtype=torch.bfloat16)
        gy = _rand(g, dev, b, h, w, cout, dtype=torch.bfloat16)
        dw = conv3x3_dw(x, gy)
        _grad_close("dw", dw, conv3x3_dw_ref(x, gy))
        assert torch.equal(conv3x3_dw(x, gy), dw)
        xf, gf = x.float(), gy.float()
        dwf = conv3x3_shift_dw(xf, gf)
        _grad_close("dw f32", dwf, conv3x3_shift_dw_ref(xf, gf))
        assert torch.equal(conv3x3_shift_dw(xf, gf), dwf)


def test_k6b_k8b_launch_in_any_order(dev):
    """A dW launch does not depend on the launches before it: the kernel's
    mode, tile and shared memory change with the channels (narrow, wide,
    narrow, f32, wide, narrow), and each launch sets its attributes."""
    from mmr_tpu_torch.ops.conv3x3 import (conv3x3_shift_dw,
                                           conv3x3_shift_dw_ref)

    g = torch.Generator(device=dev).manual_seed(18)
    for cin, cout, dtype in [(16, 16, torch.bfloat16), (256, 64, torch.bfloat16),
                             (3, 64, torch.bfloat16), (16, 16, torch.float32),
                             (320, 32, torch.bfloat16), (24, 10, torch.bfloat16),
                             (16, 16, torch.bfloat16)]:
        x = _rand(g, dev, 2, 18, 70, cin, dtype=dtype)
        dy = _rand(g, dev, 2, 18, 70, cout, dtype=dtype)
        dw = conv3x3_shift_dw(x, dy)
        _grad_close("dw", dw, conv3x3_shift_dw_ref(x, dy))


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
def test_zoo_train_and_eval_on_card(dev, monkeypatch, arch, k6, dx):
    """Two bf16 Path-A steps of each zoo model at 256x256, B=2 (Adam,
    blended loss, augmentation, dropout from the step's generator): ``k6``
    of its Conv3x3s at H·W >= 4096, ``dx`` of them with a dx (UNet's first
    conv reads the image, which needs no gradient); per step the K6a
    forward + dx and K6b launches the committed dispatch table asks of all
    its Conv3x3 shapes, the loss finite; one eval batch through
    ``evaluate_checkpoint``: the table's K6a forwards and one K7; then one
    step under ``_FORCE``: every Conv3x3 on K6a (forward and dx) and K6b,
    the loss finite."""
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
    shapes, hooks = _k6_hooks(model)
    for _ in range(2):
        state, m = step(state, images, masks, 1e-3, gen)
        assert np.isfinite(float(m["loss"]))
        for h in hooks:
            h.remove()
    big = [s for s in shapes if s[0] * s[1] >= 4096]
    assert (len(big), sum(s[4] for s in big)) == (k6, dx)
    fwd, n_dx, dw = _table_k6(shapes)
    assert (conv3x3.launches - k6a, conv3x3_dw.launches - k6b) == (2 * (fwd + n_dx), 2 * dw)
    k6a, k7 = conv3x3.launches, confusion_stats.launches
    with contextlib.redirect_stdout(io.StringIO()):
        report = evaluate_checkpoint(model, [(images[0], masks[0])], 10)
    assert (conv3x3.launches - k6a, confusion_stats.launches - k7) == (fwd, 1)
    assert np.isfinite(report["mean_iou"])
    monkeypatch.setattr(k6_ops, "_FORCE", True)
    k6a, k6b = conv3x3.launches, conv3x3_dw.launches
    state, m = step(state, images, masks, 1e-3, gen)
    assert np.isfinite(float(m["loss"]))
    assert (conv3x3.launches - k6a, conv3x3_dw.launches - k6b) == (
        len(shapes) + sum(s[4] for s in shapes), len(shapes))


# ------------------------------------------------ Path B: augmentation, Trainer

@pytest.mark.parametrize("heavy, warp", [(False, True), (False, False), (True, True)])
def test_path_b_augment_on_card(dev, heavy, warp):
    """Path B's augmentation on the card against the CPU on the same draws
    (made on the CPU, fed to both): masks equal; images within atol 1e-3
    (the card rounds exp, pow and the f32 statistics in its own order, so
    a value can land on the neighbouring bf16 value; measured 3.05e-5 on
    an H100, one bf16 step at |x| in [0.125, 0.25) is 9.8e-4), f32 and
    uint8 paths; then the draws' own path on the card (a CPU generator,
    per-sample draws on the card) runs."""
    from mmr_tpu_torch.data.augment import (AugmentConfig, apply_augment,
                                            apply_augment_u8, augment_draws,
                                            augment_train_batch_u8)

    mean, std = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
    cfg = AugmentConfig(patch_size=(64, 96), heavy=heavy, low_resolution=True)
    g = torch.Generator().manual_seed(3)
    img = torch.randint(0, 256, (6, 80, 112, 3), generator=g, dtype=torch.uint8)
    masks = torch.randint(0, 10, (6, 80, 112), generator=g, dtype=torch.uint8)
    d = next(d for s in range(200) for d in [augment_draws(
        cfg, torch.Generator().manual_seed(s), img.shape, "cpu")] if d.warp == warp)
    imf = (img.float() / 255 - torch.tensor(mean)) / torch.tensor(std)
    for got, want in (
            (apply_augment(imf.to(dev), masks.to(dev), d, cfg),
             apply_augment(imf, masks, d, cfg)),
            (apply_augment_u8(img.to(dev), masks.to(dev), d, cfg, mean, std),
             apply_augment_u8(img, masks, d, cfg, mean, std))):
        assert torch.equal(got[1].cpu(), want[1])
        err = (got[0].cpu().float() - want[0].float()).abs().max().item()
        print(f"card vs CPU: max |dimage| {err:.3e}")
        assert err <= 1e-3, err
    out, m = augment_train_batch_u8(torch.Generator().manual_seed(0), img.to(dev),
                                    masks.to(dev), cfg, mean, std)
    assert out.is_cuda and out.shape == (6, 64, 96, 3) and bool(torch.isfinite(out).all())


def test_trainer_two_epochs_on_card(dev, tmp_path):
    """Path B's ``Trainer`` for two epochs at 256×256 on the card with the
    default augmentation through the uint8 path: the fused decoder,
    front end and head + loss run (K1–K5b launch), the losses are finite,
    every artifact is written, and a resume starts at epoch 3."""
    from mmr_tpu_torch.config import get_default_config
    from mmr_tpu_torch.train.engine import Trainer

    class Sampler:
        def __init__(self, n):
            self.n = n

        def __len__(self):
            return self.n

        def epoch(self, epoch_seed):
            rng = np.random.RandomState(epoch_seed)
            for _ in range(self.n):
                yield (rng.randint(0, 256, (4, 256, 256, 3)).astype(np.uint8),
                       rng.randint(0, 10, (4, 256, 256)).astype(np.uint8))

    cfg = get_default_config(9, (256, 256))
    cfg.update(results_path=str(tmp_path), patch_size=[256, 256], n_epochs=2,
               val_plot_interval=1)
    tr = Trainer(cfg)
    assert tr.model.fused and tr.model.encoder.fused_frontend
    kernels = (fused_conv, fused_conv_bwd, fused_conv_down, fused_conv_down_bwd,
               head_loss_fwd, head_loss_bwd)
    before = [f.launches for f in kernels]
    hist = tr.train(Sampler(3), Sampler(2))
    assert all(b > a for a, b in zip(before, [f.launches for f in kernels]))
    assert all(np.isfinite(hist["train_loss"] + hist["val_loss"]))
    for f in ("training_metrics.json", "loss_dict.pkl", "training_dashboard.png",
              "plots/loss.png", "plots/epoch_2.png", "checkpoints/last_model",
              "checkpoints/best_model.json"):
        assert (tmp_path / f).is_file(), f
    cfg["n_epochs"] = 3
    again = Trainer(cfg)
    assert again.maybe_resume() and again.start_epoch == 3
    assert again.train(Sampler(1), Sampler(1))["epoch"] == [3]
