"""The port's CUDA kernels and its fused model on the card, held against
the plain PyTorch versions (f32, TF32 off) on the same inputs.

Every test is marked ``gpu`` and skips without a CUDA card. The file
imports torch, numpy and the port only (the card's machine has no JAX), so
it also runs there without the JAX-side conftest:

    python -m pytest -m gpu --noconftest tests/test_torch_gpu.py -q

Kernel tolerance: atol = rtol = 2e-2 — both sides read the same bf16
inputs and round the prologue at the same place; accumulation order and
one bf16 rounding of y remain.
"""

import numpy as np
import pytest
import torch

from mmr_tpu_torch.ops.fused_conv import (Pending, fused_conv,
                                          fused_conv_down, fused_conv_down_ref,
                                          fused_conv_ref)

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
