#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``mmr_tpu_torch``) on one NVIDIA card.

Two paths of the UNet++/MobileNetV3 flagship, two of Path A's
UNet++/ResNet-18, the rest of the Path-A zoo, and the standalone
shifted-GEMM conv. The flagship at full width (10 classes,
3,714,090 random weights from ``--seed``, BN perturbed away from
identity): serving — full-HD 1080×1920 sliding-window inference, roi
512×640, overlap 0.5, Gaussian blend, bf16, 6-frame temporal batches — and
training — ``make_train_step`` at the reference's defaults (512×640 patches,
batch 8, AdamW lr 1e-4, clip 12, PolynomialLR, bf16, fused decoder,
front-end and head + loss).

1. The card's name and power limit; build the CUDA kernels from
   ``mmr_tpu_torch/csrc`` (build time, ``ptxas -v``).
2. One eval forward of one frame's 20 windows through the fused path,
   recording every kernel launch: each K1 (``fused_conv``) and K2
   (``fused_conv_down``) launch is held against its plain PyTorch version
   on the same inputs (f32, TF32 off; atol = rtol = 2e-2).
3. The fused model vs the plain f32 model on those windows: argmax
   agreement ≥ 0.99, logits within atol 0.25 / rtol 0.05; 21 K1 and 2 K2
   launches per forward.
4. Serving: ``run_inference`` over synthetic full-HD videos; per-video fps
   and IoU; the launch counts of that run; fused-vs-plain argmax agreement
   on the first frame batch.
5. Times (CUDA events) of every recorded launch, its plain version and the
   one cuDNN call computing the same function (``library_ms``, never used
   by the port), with each launch's bound on an H100 SXM; frames/s of the
   fused and the plain bf16 model, the host time to issue a forward, and
   the device-busy time and top device events under ``torch.profiler``.
6. Training on synthetic frames and masks: one train step with every
   kernel launch recorded and held against its plain version (K1 with
   moments, K3, K2 with moments, K4, K5a, K5b: forward outputs atol = rtol
   = 2e-2, moments rtol 1e-3 of the largest, statistics rtol 2e-2, backward
   outputs max|Δ| / max|ref| and ‖Δ‖ / ‖ref‖ both < 1e-2 — both sides read
   the same bf16 inputs and round at the same places, so a dropped tap or
   a lost correction term fails) and the launch counts checked
   (20 K1 + 20 K3, 2 K2 + 2 K4, 1 K5a + 1 K5b); the fused step vs the plain
   f32 step on the same weights and batch (loss rtol 2e-2; train-mode head
   argmax agreement with plain f32 no lower than the plain bf16 model's,
   less 0.02); five steps on one batch (the loss falls);
   the median step time, frames/s, host issue time, device-busy time, top
   device events; each training kernel's time, plain time, bound and one
   library call (cuDNN ``convolution_backward`` on the materialized input
   for K3/K4; ``F.conv2d`` + log-softmax + DiceCE under autograd for K5).

7. Path-A training: Path A's canonical configuration (smp UNet++ over
   ResNet-18, 10 classes, full width, random weights from ``--seed``, BN
   perturbed) through ``make_train_step`` at 256×256, B=8, Adam lr 1e-3
   with coupled L2 1e-5, the blended CE + Dice loss (0.5), StepLR epoch 0
   and the Path-A augmentation. One recorded step: every K6a launch
   (``conv3x3``: the 16 decoder convs and the head at H·W ≥ 4096, forward
   and again for dx) and every K6b (``conv3x3_dw``, dW) held against its
   plain version (forward atol = rtol = 2e-2, dx and dW at ``GRAD_REL``);
   34 K6a + 17 K6b launches; the step vs the plain f32 step on the same
   weights, batch and augmentation draws (loss rtol 2e-2); five steps (the
   loss falls); step median, host issue, device busy, top device events.
8. Path-A evaluation: ``evaluate_checkpoint`` of that model over three
   synthetic 4×256×256 batches (uint8 masks): every K7 launch
   (``confusion_stats``) equals its plain version exactly, every K6a
   launch within 2e-2 (17 per forward); the returned mean IoU equals the
   one from the plain K7 on the same id maps.

9. The rest of the Path-A zoo at full width, 10 classes, random weights
   from ``--seed``, BN perturbed: ``smp_unet18``, ``smp_DeepLabV3+``,
   ``smp_MANet``, ``unet``, ``segnet``, ``resnet18`` (ResNet-UNet), each
   trained as in phase 7 (256×256, B=8, Adam, blended loss, augmentation,
   bf16; dropout drawn from the step's generator). One recorded step: every
   K6a / K6b launch held as in phase 7, the counts those of the code (K6a
   per forward: 7, 0, 8, 12, 0, 0; a dx for each but UNet's first conv,
   which reads the image); three steps (the loss falls); step median, host
   issue, device busy and idle share; then one ``evaluate_checkpoint``
   batch of 4×256×256 with its K6a and K7 launches held, and its time.
10. K8 (``ops/conv3x3.py::conv3x3_bias_act`` under ``_FORCE = True``) at
    the shape its TPU docstring measures, 16 → 16 channels on (32, 512,
    512) bf16: forward, dx and dW (2 K8a + 1 K8b launches) held against
    the plain versions (forward 2e-2, dx and dW at ``GRAD_REL``) and timed
    beside their bound, plain and library calls; then an f32-storage case
    and one with H not a multiple of 16, held and timed.

Times of every new kernel beside its plain version, its bound and one
library call (``F.conv2d`` for K6a and K8a, ``convolution_backward`` for
K6b and K8b, ``torch.bincount`` on ``gt·C + pred`` for K7; never used by
the port).
Phases 5 and 6 run their plain-bf16 yardsticks with
``conv3x3_packed._FORCE = False``: the library conv they always measured.

Prints a ``{"kernels": [...]}`` line, then, last,
``{"ok": true, "device": {...}}``. Any failed check exits non-zero with no
result line, as does a machine without CUDA. Run: ``python3 chip_smoke.py``.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import importlib
import inspect
import io
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 tensor-core rate
PEAK_F32_OPS = 67e12       # H100 SXM f32 rate outside the tensor cores
PEAK_BYTES = 3.35e12       # H100 SXM HBM3 rate
ROI = (512, 640)
FRAME = (1080, 1920)
N_CLASSES = 10
VIDEOS, FRAMES, BATCH = 2, 12, 6   # serving: videos x frames, frames per chunk
REPS = 20                          # timed repetitions
TRAIN_BATCH, LR, CLIP = 8, 1e-4, 12.0   # config.py:77, :85-88
TRAIN_STEPS = 10                        # timed train steps


def check(cond: bool, msg: str):
    if not cond:
        raise RuntimeError(f"CHECK FAILED: {msg}")


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_issue_ms(fn, reps: int) -> float:
    """Median host time to issue ``fn`` (the device drained before each)."""
    ts = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        ts.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return sorted(ts)[len(ts) // 2]


def device_profile(fn, reps: int):
    """Device-busy ms per call — the sum of the device events (kernels,
    copies) ``torch.profiler`` records over ``reps`` calls — and the top
    device events as (name, ms per call, count per call). Busy is 0 when
    the profiler records no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    ms = lambda e: e.self_device_time_total / 1e3 / reps
    top = sorted(dev, key=ms, reverse=True)[:8]
    return sum(ms(e) for e in dev), [(e.key[:70], ms(e), e.count / reps) for e in top]


def perturb(model, gen: torch.Generator):
    """Conv gain 1.1 and BN scale/shift/running stats away from identity,
    so the logits are O(1) and a BN-fold error would show."""
    from mmr_tpu_torch.models.layers import FusedBatchNorm

    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.Conv2d):
                m.weight.mul_(1.1)
            elif isinstance(m, FusedBatchNorm):
                c = m.weight.numel()
                rnd = lambda: torch.rand(c, generator=gen)
                m.weight.copy_(0.9 + 0.4 * rnd())
                m.bias.copy_(0.1 * torch.randn(c, generator=gen))
                m.running_mean.copy_(0.1 * torch.randn(c, generator=gen))
                m.running_var.copy_(0.6 + 0.8 * rnd())


def k1_labels(min_hw: int) -> list[str]:
    """Launch order of the fused decoder (see ``_fused_decoder``)."""
    h5, w5 = ROI[0] // 32, ROI[1] // 32
    fused = lambda l: (h5 << (l + 1)) * (w5 << (l + 1)) >= min_hw
    names = []
    for layer in range(4):
        for d in range(4 - layer):
            if fused(d + layer):
                names += [f"x_{d}_{d + layer}.conv1", f"x_{d}_{d + layer}.conv2"]
    if fused(4):
        names += ["x_0_4.conv1", "x_0_4.conv2", "head"]
    return names


# ------------------------------------------------- kernel records and work

KERNELS = {  # kind -> (module, wrapper, plain version, source, TPU kernel)
    "K1": ("mmr_tpu_torch.ops.fused_conv", "fused_conv", "fused_conv_ref",
           "mmr_tpu_torch/csrc/fused_conv.cu", "mmr_tpu/ops/pallas/packed_chain.py:1070"),
    "K2": ("mmr_tpu_torch.ops.fused_conv", "fused_conv_down", "fused_conv_down_ref",
           "mmr_tpu_torch/csrc/fused_conv_down.cu",
           "mmr_tpu/ops/pallas/packed_chain.py:1786"),
    "K3": ("mmr_tpu_torch.ops.fused_conv", "fused_conv_bwd", "fused_conv_bwd_ref",
           "mmr_tpu_torch/csrc/fused_conv_bwd.cu",
           "mmr_tpu/ops/pallas/packed_chain.py:1207"),
    "K4": ("mmr_tpu_torch.ops.fused_conv", "fused_conv_down_bwd",
           "fused_conv_down_bwd_ref", "mmr_tpu_torch/csrc/fused_conv_down_bwd.cu",
           "mmr_tpu/ops/pallas/packed_chain.py:1877"),
    "K5a": ("mmr_tpu_torch.ops.head_loss", "head_loss_fwd", "head_loss_fwd_ref",
            "mmr_tpu_torch/csrc/head_loss.cu", "mmr_tpu/ops/pallas/packed_chain.py:2491"),
    "K5b": ("mmr_tpu_torch.ops.head_loss", "head_loss_bwd", "head_loss_bwd_ref",
            "mmr_tpu_torch/csrc/head_loss.cu", "mmr_tpu/ops/pallas/packed_chain.py:2540"),
    "K6a": ("mmr_tpu_torch.ops.conv3x3_packed", "conv3x3", "conv3x3_ref",
            "mmr_tpu_torch/csrc/conv3x3.cu", "mmr_tpu/ops/pallas/conv3x3_packed.py:283"),
    "K6b": ("mmr_tpu_torch.ops.conv3x3_packed", "conv3x3_dw", "conv3x3_dw_ref",
            "mmr_tpu_torch/csrc/conv3x3.cu", "mmr_tpu/ops/pallas/conv3x3_packed.py:323"),
    "K7": ("mmr_tpu_torch.ops.confusion", "confusion_stats", "confusion_stats_ref",
           "mmr_tpu_torch/csrc/confusion.cu", "mmr_tpu/ops/pallas/confusion.py:81"),
    "K8a": ("mmr_tpu_torch.ops.conv3x3", "conv3x3_shift", "conv3x3_shift_ref",
            "mmr_tpu_torch/csrc/conv3x3.cu", "mmr_tpu/ops/pallas/conv3x3.py:165"),
    "K8b": ("mmr_tpu_torch.ops.conv3x3", "conv3x3_shift_dw", "conv3x3_shift_dw_ref",
            "mmr_tpu_torch/csrc/conv3x3.cu", "mmr_tpu/ops/pallas/conv3x3.py:208"),
}
# modules that bind a wrapper under its own name (besides its defining module)
BINDERS = {"K1": ("mmr_tpu_torch.models.fused_blocks",),
           "K2": ("mmr_tpu_torch.models.fused_encoder",)}
GRAD_REL = 1e-2   # backward outputs: max|Δ| / max|ref| and ‖Δ‖ / ‖ref‖


def wrapper(kind):
    mod, name = KERNELS[kind][:2]
    return getattr(importlib.import_module(mod), name)


def plain(kind):
    mod, _, ref = KERNELS[kind][:3]
    return getattr(importlib.import_module(mod), ref)


def _clone(v):
    from mmr_tpu_torch.ops.fused_conv import Pending

    if isinstance(v, torch.Tensor):
        return v.detach().clone()
    if isinstance(v, Pending):
        return Pending(_clone(v.raw), _clone(v.scale), _clone(v.shift), v.act,
                       v.up2x)
    if isinstance(v, (list, tuple)):
        return type(v)(_clone(x) for x in v)
    if isinstance(v, dict):
        return {k: _clone(x) for k, x in v.items()}
    return v


def _tensors(out):
    """Flatten a kernel's outputs to a list of tensors (None dropped)."""
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, (list, tuple)):
        return [t for o in out for t in _tensors(o)]
    return []


def _in_backward() -> bool:
    """Whether the wrapper was called from an autograd ``backward`` (K6a's
    and K8a's dx launches) rather than a forward."""
    f = sys._getframe(2)
    for _ in range(4):
        if f is None:
            return False
        if f.f_code.co_name == "backward":
            return True
        f = f.f_back
    return False


@contextlib.contextmanager
def recording():
    """Stand a recorder in for every kernel wrapper, wherever the port binds
    it. Each call is kept as (kind, its arguments by name, its outputs,
    whether a backward made it), cloned: the optimizer updates the weights
    in place. A wrapper counts its launches under its module-level name, so
    while the recorder stands there they land on the recorder's
    ``launches``, which starts at 0. Yields (records, {kind: recorder})."""
    records, recorders, saved = [], {}, []
    for kind, (mod, name, *_) in KERNELS.items():
        fn = wrapper(kind)
        sig = inspect.signature(fn)

        def wrapped(*a, _fn=fn, _kind=kind, _sig=sig, **kw):
            out = _fn(*a, **kw)
            args = _sig.bind(*a, **kw)
            args.apply_defaults()
            records.append((_kind, _clone(args.arguments), _clone(out),
                            _in_backward()))
            return out
        wrapped.launches = 0
        recorders[kind] = wrapped
        for m in map(importlib.import_module, (mod,) + BINDERS.get(kind, ())):
            saved.append((m, name, getattr(m, name)))
            setattr(m, name, wrapped)
    try:
        yield records, recorders
    finally:
        for m, name, fn in saved:
            setattr(m, name, fn)


def _materialized(inputs):
    """bf16 NCHW (channels_last) concat of the activated, upsampled inputs."""
    from mmr_tpu_torch.ops.fused_conv import activated
    from mmr_tpu_torch.ops.resize import upsample2x

    xs = [activated(p) for p in inputs]
    xs = [upsample2x(x) if p.up2x else x for x, p in zip(xs, inputs)]
    return torch.cat(xs, -1).to(torch.bfloat16).permute(0, 3, 1, 2)


def _oihw(ws):
    w = torch.cat(ws, 2).permute(3, 2, 0, 1).to(torch.bfloat16)
    return w.contiguous(memory_format=torch.channels_last)


def _bf16(t):
    return None if t is None else t.to(torch.bfloat16)


def _library(kind, args):
    """One PyTorch (cuDNN) computation of the same function on the same
    inputs, bf16, the prologue applied beforehand; the port never calls it."""
    from mmr_tpu_torch.losses import dice_ce_loss
    from mmr_tpu_torch.ops.fused_conv import activated

    conv_bwd = torch.ops.aten.convolution_backward
    if kind in ("K6a", "K8a"):
        x, w = _bf16(args["x"]).permute(0, 3, 1, 2), _oihw([args["w"]])
        b = _bf16(args["bias"])
        return lambda: F.conv2d(x, w, b, padding=1)
    if kind in ("K6b", "K8b"):
        dy = args["g"] if kind == "K6b" else args["dy"]
        x, dy = _bf16(args["x"]).permute(0, 3, 1, 2), _bf16(dy).permute(0, 3, 1, 2)
        w = torch.empty((dy.shape[1], x.shape[1], 3, 3), dtype=torch.bfloat16,
                        device=x.device).contiguous(memory_format=torch.channels_last)
        return lambda: conv_bwd(dy, x, w, None, [1, 1], [1, 1], [1, 1], False,
                                [0, 0], 1, [False, True, False])
    if kind == "K7":
        nc = args["num_classes"]
        pred, gt = args["pred_ids"].reshape(-1), args["gt_ids"].reshape(-1)
        return lambda: torch.bincount(gt.long() * nc + pred, minlength=nc * nc)
    if kind in ("K1", "K3"):
        x, w = _materialized(args["inputs"]), _oihw(args["weights"])
        if kind == "K1":
            b = _bf16(args["bias"])
            return lambda: F.conv2d(x, w, b, padding=1)
        dy = args["dy"].permute(0, 3, 1, 2)
        return lambda: conv_bwd(dy, x, w, None, [1, 1], [1, 1], [1, 1], False,
                                [0, 0], 1, [True, True, False])
    if kind in ("K2", "K4"):
        p, groups = args["x"], args["x"].c if args["depthwise"] else 1
        x, w = activated(p).to(torch.bfloat16).permute(0, 3, 1, 2), _oihw([args["w"]])
        if kind == "K2":
            b = _bf16(args["bias"])
            return lambda: F.conv2d(x, w, b, stride=2, padding=1, groups=groups)
        dy = args["dy"].permute(0, 3, 1, 2)
        return lambda: conv_bwd(dy, x, w, None, [2, 2], [1, 1], [1, 1], False,
                                [0, 0], groups, [args["need_dx"], True, False])
    # K5a / K5b: F.conv2d + log-softmax + DiceCE (autograd for the backward)
    p, labels = args["x"], args["labels"]
    x = activated(p).to(torch.bfloat16).permute(0, 3, 1, 2).detach()
    w = _oihw([args["w"]])
    b = torch.zeros(w.shape[0], device=w.device) if kind == "K5b" else args["bias"]
    b = _bf16(b)

    def loss():
        logits = F.conv2d(x, w, b, padding=1).float().permute(0, 2, 3, 1)
        return dice_ce_loss(logits, labels)

    if kind == "K5a":
        return loss
    x.requires_grad_(True)
    w.requires_grad_(True)
    graph = loss()
    return lambda: torch.autograd.grad(graph, [x, w], retain_graph=True)


def _work(kind, args, out):
    """(operations, bytes, the card's peak rate for those operations) of
    the function on these inputs: each input read once (weights as the
    kernels read them, bf16), each output written once. A backward does
    the work of two convolutions where it forms dx and dW; the confusion
    counts do three integer compares a pixel (held to the f32 rate)."""
    nb = lambda t: 0 if t is None else t.numel() * t.element_size()
    pending = lambda p: nb(p.raw) + (8 * p.c if p.scale is not None else 0)
    written = sum(nb(t) for t in _tensors(out))
    if kind == "K7":
        return (3 * args["pred_ids"].numel(),
                nb(args["pred_ids"]) + nb(args["gt_ids"]) + written, PEAK_F32_OPS)
    if kind in ("K6a", "K6b", "K8a", "K8b"):
        x, fwd = args["x"], kind in ("K6a", "K8a")
        dy = None if fwd else args["g" if kind == "K6b" else "dy"]
        cout = args["w"].shape[-1] if fwd else dy.shape[-1]
        macs = math.prod(x.shape[:3]) * 9 * x.shape[3] * cout
        read = nb(x) + (2 * 9 * x.shape[3] * cout + nb(args["bias"]) if fwd
                        else nb(dy))
        return 2 * macs, read + written, PEAK_BF16_FLOPS
    if kind in ("K1", "K3"):
        ins, cout = args["inputs"], args["weights"][0].shape[-1]
        grid = (_tensors(out)[0] if kind == "K1" else args["dy"]).shape[:3]
        cin = sum(p.c for p in ins)
        macs = math.prod(grid) * 9 * cin * cout
        read = sum(pending(p) for p in ins) + 2 * 9 * cin * cout
    elif kind in ("K2", "K4"):
        x, w = args["x"], args["w"]
        cout = x.c if args["depthwise"] else w.shape[-1]
        grid = (_tensors(out)[0] if kind == "K2" else args["dy"]).shape[:3]
        macs = math.prod(grid) * 9 * cout * (1 if args["depthwise"] else x.c)
        read = pending(x) + 2 * w.numel()
    else:
        x, w, labels = args["x"], args["w"], args["labels"]
        macs = labels.numel() * 9 * x.c * w.shape[-1]
        read = pending(x) + 2 * w.numel() + nb(labels)
    if kind in ("K1", "K2", "K5a"):
        return 2 * macs, read + nb(args["bias"]) + written, PEAK_BF16_FLOPS
    if kind == "K5b":
        return (4 * macs, read + nb(args["logp"]) + nb(args["dstats"]) + written,
                PEAK_BF16_FLOPS)
    both = kind == "K3" or args["need_dx"]
    read += nb(args["dy"]) + (0 if args["dmom"] is None
                              else nb(args["y"]) + nb(args["dmom"]))
    return (4 if both else 2) * macs, read + written, PEAK_BF16_FLOPS


def _hold(kind, out, ref, backward=False):
    """Hold a launch's outputs against its plain version. Forward outputs
    (y, logp) atol = rtol = 2e-2, moments rtol 1e-3 of the largest, the
    head's statistics rtol 2e-2 and confusion within 1e-3 of its total;
    backward outputs (dx, dW, d(scale, shift), dbias; K6a and K8a launched
    by a backward, K6b, K8b) max|Δ| / max|ref| and ‖Δ‖ / ‖ref‖ both <
    GRAD_REL; K7's
    integer counts exactly. Returns (max abs error of the first output,
    the worst max|Δ| / max|ref|, the worst ‖Δ‖ / ‖ref‖)."""
    got, want = _tensors(out), _tensors(ref)
    check(len(got) == len(want), f"{kind}: {len(got)} outputs vs {len(want)}")
    max_abs, worst, worst_l2 = None, 0.0, 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = g.float(), w.float()
        d = (g - w).abs()
        if max_abs is None:
            max_abs = d.max().item()
        scale = max(w.abs().max().item(), 1e-30)
        rel = d.max().item() / scale
        l2 = d.norm().item() / max(w.norm().item(), 1e-30)
        worst, worst_l2 = max(worst, rel), max(worst_l2, l2)
        if kind == "K7":
            ok = bool(torch.equal(g, w))
        elif kind in ("K1", "K2") and i == 1:
            ok = bool(torch.allclose(g, w, rtol=1e-3, atol=1e-3 * scale))
        elif kind == "K5a" and i == 1:
            ok = bool(torch.allclose(g, w, rtol=2e-2, atol=1e-3 * scale))
        elif kind == "K5a" and i == 2:
            ok = d.sum().item() <= 1e-3 * max(w.sum().item(), 1.0)
        elif kind in ("K1", "K2", "K5a") or (kind in ("K6a", "K8a")
                                              and not backward):
            ok = bool(torch.allclose(g, w, atol=2e-2, rtol=2e-2))
        else:
            ok = rel < GRAD_REL and l2 < GRAD_REL
        check(ok, f"{kind} output {i} disagrees with its plain version "
                  f"(max abs {d.max().item():.3e}, rel-to-max {rel:.3e}, "
                  f"rel-L2 {l2:.3e})")
    return max_abs, worst, worst_l2


def hold_records(phase, records, labels=None) -> list[dict]:
    """Hold every recorded launch against its plain version on the same
    inputs; returns one case per launch with its work."""
    cases = []
    for kind, args, out, backward in records:
        with torch.no_grad():
            ref = plain(kind)(**args)
        max_abs, rel, l2 = _hold(kind, out, ref, backward)
        ops, nbytes, peak = _work(kind, args, out)
        n = sum(c["kind"] == kind for c in cases) + 1
        label = next(labels[kind]) if labels else f"#{n}"
        if kind in ("K6a", "K8a") and backward:
            label += " dx"
        cases.append({"kind": kind, "label": label, "args": args,
                      "max_abs": max_abs, "ops_ms": ops / peak * 1e3,
                      "bytes_ms": nbytes / PEAK_BYTES * 1e3})
        print(f"[{phase}] {kind:3s} {label:14s} out {tuple(_tensors(out)[0].shape)} "
              f"max_abs {max_abs:.3e} rel-to-max {rel:.3e} rel-L2 {l2:.3e} ok",
              flush=True)
    return cases


def time_cases(phase, cases):
    """CUDA-event times of every case's kernel, plain version and library
    call, and its bound on an H100 SXM."""
    for c in cases:
        kind, args = c["kind"], c["args"]
        fn, ref = wrapper(kind), plain(kind)
        with torch.no_grad():
            c["ms"] = cuda_ms(lambda: fn(**args), REPS)
            c["plain_ms"] = cuda_ms(lambda: ref(**args), 5)
        c["library_ms"] = cuda_ms(_library(kind, args), REPS)
        c["bound_ms"] = max(c["ops_ms"], c["bytes_ms"])
        c["bound_by"] = "operations" if c["ops_ms"] >= c["bytes_ms"] else "bytes"
        print(f"[{phase}] {kind:3s} {c['label']:14s} ms {c['ms']:.4f} plain "
              f"{c['plain_ms']:.4f} library {c['library_ms']:.4f} bound "
              f"{c['bound_ms']:.4f} ({c['bound_by']})", flush=True)


def kernel_entry(kind, cases, launches, per) -> dict:
    """The ``kernels`` line's entry: sums over ``cases`` (one per launch)."""
    _, name, _, src, repl = KERNELS[kind]
    cs = [c for c in cases if c["kind"] == kind]
    tot = lambda k: sum(c[k] for c in cs)
    return {"name": name, "route": "cuda", "source": src, "replaces": repl,
            "launches": launches, "max_abs_err": max(c["max_abs"] for c in cs),
            "ms": tot("ms"), "plain_ms": tot("plain_ms"), "bound_ms": tot("bound_ms"),
            "bound_by": "operations" if tot("ops_ms") >= tot("bytes_ms") else "bytes",
            "library_ms": tot("library_ms"), "per": per}

# ------------------------------------------------------------- training

N_EPOCHS = 200   # config.py:51; PolynomialLR(total_iters=200, power=0.9)
TRAIN_COUNTS = {"K1": 20, "K2": 2, "K3": 20, "K4": 2, "K5a": 1, "K5b": 1,
                "K6a": 0, "K6b": 0, "K7": 0, "K8a": 0, "K8b": 0}
FLAGSHIP = ("K1", "K2", "K3", "K4", "K5a", "K5b")


@contextlib.contextmanager
def library_conv3x3():
    """Every ``Conv3x3`` on the library conv (K6 off): the plain-bf16
    yardstick of phases 5 and 6, as measured before K6 existed."""
    from mmr_tpu_torch.ops import conv3x3_packed

    old, conv3x3_packed._FORCE = conv3x3_packed._FORCE, False
    try:
        yield
    finally:
        conv3x3_packed._FORCE = old


def train_phase(model, dev, rng) -> dict:
    """Phase 6; returns {kind: kernel entry} for K1..K5b of the train step."""
    from mmr_tpu_torch.data.synthetic import render_frame
    from mmr_tpu_torch.losses import dice_ce_loss
    from mmr_tpu_torch.models import create_model, get_preprocessing
    from mmr_tpu_torch.train.optim import build_optimizer
    from mmr_tpu_torch.train.schedules import build_lr_schedule
    from mmr_tpu_torch.train.state import TrainState
    from mmr_tpu_torch.train.steps import make_train_step

    sd0 = {k: v.clone() for k, v in model.state_dict().items()}
    pre = get_preprocessing("tu-mobilenetv3_small_100")
    t0 = time.time()
    frames = [render_frame(rng, *ROI, N_CLASSES - 1) for _ in range(TRAIN_BATCH)]
    images = torch.from_numpy(np.stack(
        [(f[0] * 255.0 + 0.5).astype(np.uint8) for f in frames]))[None]
    masks = torch.from_numpy(np.stack([f[1] for f in frames]).astype(np.int64))[None]
    print(f"[6] rendered {TRAIN_BATCH} frames {ROI} with masks in "
          f"{time.time() - t0:.1f} s", flush=True)
    lr = build_lr_schedule({"name": "PolynomialLR", "total_iters": N_EPOCHS,
                            "power": 0.9}, LR, N_EPOCHS)(0)

    def trainer(m):
        opt = build_optimizer("adamw", clip_grad_norm=CLIP, weight_decay=1e-2)
        return TrainState.create(m, opt), make_train_step(
            m, opt, dice_ce_loss, N_CLASSES, preprocess=pre, device=dev)

    fused = create_model(classes=N_CLASSES, device=dev, fused=True,
                         fused_frontend=True)
    plain = create_model(classes=N_CLASSES, device=dev, dtype=torch.float32)

    # ---- 6b. train-mode head argmax vs plain f32 (same weights): the fused
    # model agrees at least as well as the plain bf16 model does ---------------
    plain16 = create_model(classes=N_CLASSES, device=dev)
    for m in (fused, plain, plain16):
        m.load_state_dict(sd0)
        m.train()
    with torch.no_grad(), library_conv3x3():
        img = pre(images[0].to(dev).float() / 255.0)
        want = plain(img).argmax(-1)
        agree, agree16 = ((m(img).argmax(-1) == want).float().mean().item()
                          for m in (fused, plain16))
    print(f"[6] train-mode logits vs plain f32: argmax agreement fused {agree:.5f}, "
          f"plain bf16 {agree16:.5f}", flush=True)
    check(agree >= agree16 - 0.02, "fused train-mode head disagrees with plain f32 "
          "more than the plain bf16 model does")
    del plain16

    # ---- 6a. one recorded step: every launch vs its plain version ----------
    for m in (fused, plain):
        m.load_state_dict(sd0)
    state, step = trainer(fused)
    with recording() as (records, recorders):
        state, met = step(state, images, masks, lr)
        torch.cuda.synchronize()
    launches = {k: r.launches for k, r in recorders.items()}
    loss1 = float(met["loss"])
    print(f"[6] launches in one train step: {launches}", flush=True)
    check(launches == TRAIN_COUNTS, f"expected {TRAIN_COUNTS} launches")
    k1_mom = sum(1 for k, args, *_ in records if k == "K1" and args["emit_moments"])
    check(k1_mom == TRAIN_COUNTS["K1"], f"{k1_mom} K1 launches emitted moments")
    cases = hold_records(6, records)

    # ---- 6b'. fused step loss vs the plain f32 step -----------------------
    pstate, pstep = trainer(plain)
    pstate, pmet = pstep(pstate, images, masks, lr)
    ploss = float(pmet["loss"])
    print(f"[6] step 1 loss: fused {loss1:.5f} (IoU {float(met['iou']):.4f}), "
          f"plain f32 {ploss:.5f} (IoU {float(pmet['iou']):.4f})", flush=True)
    check(abs(loss1 - ploss) <= 2e-2 * abs(ploss), "fused loss disagrees with plain f32")
    del plain, pstate, pstep

    # ---- 6c. five steps on one batch: the loss falls -------------------------
    images_d, masks_d = images.to(dev), masks.to(dev)
    losses = [loss1]
    for _ in range(4):
        state, met = step(state, images_d, masks_d, lr)
        losses.append(float(met["loss"]))
    print(f"[6] losses over 5 steps: {[round(v, 5) for v in losses]}", flush=True)
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          "the loss did not fall over five steps")

    # ---- 6d. times --------------------------------------------------------------
    run = lambda: step(state, images_d, masks_d, lr)
    ts = []
    for _ in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        run()
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t) * 1e3)
    ts.sort()
    med = ts[len(ts) // 2]
    issue = host_issue_ms(run, 5)
    busy, top = device_profile(run, 3)
    idle = f"{1 - busy / med:.3f}" if busy > 0 else "not measured"
    print(f"[6] train step (B={TRAIN_BATCH}, {ROI[0]}x{ROI[1]}): median "
          f"{med:.3f} ms ({TRAIN_BATCH * 1e3 / med:.2f} frames/s), min {ts[0]:.3f}, "
          f"max {ts[-1]:.3f}, {len(ts)} steps; host issue median {issue:.3f} ms; "
          f"device busy {busy:.3f} ms per step (torch.profiler, 3 steps); device "
          f"idle share of the median {idle}", flush=True)
    for key, t, cnt in top:
        print(f"[6]     {t:8.3f} ms  x{cnt:5.1f}  {key}", flush=True)

    time_cases(6, cases)
    per = f"sum over the launches of one train step (B={TRAIN_BATCH}, {ROI[0]}x{ROI[1]})"
    return {kind: kernel_entry(kind, cases, launches[kind], per) for kind in FLAGSHIP}


# ------------------------------------------------------------- Path A

PATH_A_HW, PATH_A_BATCH = (256, 256), 8   # train_sarrarp50.sh: 256x256, B=8
PATH_A_LR, PATH_A_WD, PATH_A_EPOCHS = 1e-3, 1e-5, 20   # Adam, StepLR(lr_steps 2)
EVAL_BATCHES, EVAL_BATCH = 3, 4
K6_PER_FORWARD = 17   # 16 decoder convs + the head at output H·W >= 4096


def _counts(**nonzero) -> dict:
    return {k: nonzero.get(k, 0) for k in KERNELS}


def _path_a_batch(rng, n):
    """n synthetic images (f32 in [0, 1]) and their uint8 masks."""
    from mmr_tpu_torch.data.synthetic import render_frame

    frames = [render_frame(rng, *PATH_A_HW, N_CLASSES - 1) for _ in range(n)]
    return (torch.from_numpy(np.stack([f[0] for f in frames])),
            torch.from_numpy(np.stack([f[1] for f in frames])))


def _timed_steps(phase, run, n):
    """Median step time, host issue time, device busy and top events."""
    ts = []
    for _ in range(n):
        torch.cuda.synchronize()
        t = time.perf_counter()
        run()
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t) * 1e3)
    ts.sort()
    med = ts[len(ts) // 2]
    issue = host_issue_ms(run, 5)
    busy, top = device_profile(run, 3)
    idle = f"{1 - busy / med:.3f}" if busy > 0 else "not measured"
    print(f"[{phase}] median {med:.3f} ms, min {ts[0]:.3f}, max {ts[-1]:.3f}, "
          f"{len(ts)} runs; host issue median {issue:.3f} ms; device busy "
          f"{busy:.3f} ms per run (torch.profiler, 3 runs); device idle share "
          f"of the median {idle}", flush=True)
    for key, t, cnt in top:
        print(f"[{phase}]     {t:8.3f} ms  x{cnt:5.1f}  {key}", flush=True)
    return med


def path_a_train_phase(dev, seed):
    """Phase 7; returns (the trained model, {K6a, K6b: kernel entry})."""
    from mmr_tpu_torch.data.augment import augment_path_a_batch
    from mmr_tpu_torch.losses import blended_ce_dice_loss
    from mmr_tpu_torch.models import create_model
    from mmr_tpu_torch.train.optim import build_optimizer
    from mmr_tpu_torch.train.schedules import step_lr
    from mmr_tpu_torch.train.state import TrainState
    from mmr_tpu_torch.train.steps import make_train_step

    gen = torch.Generator().manual_seed(seed + 1)
    model = create_model("smp_UNet++", classes=N_CLASSES, device=dev, generator=gen)
    perturb(model, gen)
    sd0 = {k: v.clone() for k, v in model.state_dict().items()}
    n_params = sum(p.numel() for p in model.parameters())
    images, masks = _path_a_batch(np.random.RandomState(seed + 1), PATH_A_BATCH)
    images, masks = images[None], masks.long()[None]
    loss_fn = functools.partial(blended_ce_dice_loss, dice_loss_factor=0.5)
    lr = step_lr(PATH_A_LR, PATH_A_EPOCHS, 2, 0.1)(0)
    draws = lambda: torch.Generator(device=dev).manual_seed(seed)

    def trainer(m):
        opt = build_optimizer("adam", weight_decay=PATH_A_WD)
        return TrainState.create(m, opt), make_train_step(
            m, opt, loss_fn, N_CLASSES, augment=augment_path_a_batch, device=dev)

    # ---- 7a. one recorded step: every launch vs its plain version ----------
    state, step = trainer(model)
    with recording() as (records, recorders):
        state, met = step(state, images, masks, lr, draws())
        torch.cuda.synchronize()
    launches = {k: r.launches for k, r in recorders.items()}
    print(f"[7] smp_UNet++ / resnet18: {n_params} parameters; launches in one "
          f"train step: {launches}", flush=True)
    n_dx = sum(1 for k, *_, bwd in records if k == "K6a" and bwd)
    print(f"[7] K6a: {launches['K6a'] - n_dx} forward + {n_dx} dx launches, "
          f"K6b: {launches['K6b']} dW launches", flush=True)
    check(launches == _counts(K6a=2 * K6_PER_FORWARD, K6b=K6_PER_FORWARD)
          and n_dx == K6_PER_FORWARD, "unexpected launch counts")
    cases = hold_records(7, records)
    loss1 = float(met["loss"])

    # ---- 7b. the step vs the plain f32 step (same weights, batch, draws) -----
    plain = create_model("smp_UNet++", classes=N_CLASSES, device=dev,
                         dtype=torch.float32)
    plain.load_state_dict(sd0)
    pstate, pstep = trainer(plain)
    pstate, pmet = pstep(pstate, images, masks, lr, draws())
    ploss = float(pmet["loss"])
    print(f"[7] step 1 loss: bf16 with K6 {loss1:.5f} (IoU {float(met['iou']):.4f}), "
          f"plain f32 {ploss:.5f} (IoU {float(pmet['iou']):.4f})", flush=True)
    check(abs(loss1 - ploss) <= 2e-2 * abs(ploss), "Path-A loss disagrees with plain f32")
    del plain, pstate, pstep

    # ---- 7c. five steps: the loss falls --------------------------------------
    images_d, masks_d = images.to(dev), masks.to(dev)
    g = draws()
    losses = [loss1]
    for _ in range(4):
        state, met = step(state, images_d, masks_d, lr, g)
        losses.append(float(met["loss"]))
    print(f"[7] losses over 5 steps: {[round(v, 5) for v in losses]}", flush=True)
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          "the loss did not fall over five steps")

    # ---- 7d. times -------------------------------------------------------------
    print(f"[7] Path-A train step (B={PATH_A_BATCH}, {PATH_A_HW[0]}x{PATH_A_HW[1]}, "
          f"bf16, augmentation on):", flush=True)
    med = _timed_steps(7, lambda: step(state, images_d, masks_d, lr, g), TRAIN_STEPS)
    print(f"[7] {PATH_A_BATCH * 1e3 / med:.2f} images/s", flush=True)
    time_cases(7, cases)
    per = (f"sum over the launches of one Path-A train step (B={PATH_A_BATCH}, "
           f"{PATH_A_HW[0]}x{PATH_A_HW[1]}): forward and dx for K6a")
    return model, {k: kernel_entry(k, cases, launches[k], per) for k in ("K6a", "K6b")}


def path_a_eval_phase(model, dev, seed) -> dict:
    """Phase 8; returns {K6a, K7: kernel entry}."""
    from mmr_tpu_torch.infer.evaluator import evaluate_checkpoint
    from mmr_tpu_torch.losses import blended_ce_dice_loss
    from mmr_tpu_torch.ops.confusion import confusion_stats_ref

    rng = np.random.RandomState(seed + 2)
    batches = [_path_a_batch(rng, EVAL_BATCH) for _ in range(EVAL_BATCHES)]
    loss_fn = functools.partial(blended_ce_dice_loss, dice_loss_factor=0.5)
    with recording() as (records, recorders):
        report = evaluate_checkpoint(model, batches, N_CLASSES, loss_fn=loss_fn,
                                     device=dev)
        torch.cuda.synchronize()
    launches = {k: r.launches for k, r in recorders.items()}
    print(f"[8] launches in evaluate_checkpoint over {EVAL_BATCHES} batches of "
          f"{EVAL_BATCH}x{PATH_A_HW[0]}x{PATH_A_HW[1]}: {launches}", flush=True)
    check(launches == _counts(K6a=K6_PER_FORWARD * EVAL_BATCHES, K7=EVAL_BATCHES),
          "unexpected launch counts")
    cases = hold_records(8, records)

    counts = np.zeros((3, N_CLASSES), np.float64)
    for k, args, *_ in records:
        if k == "K7":
            counts += np.stack([t.cpu().double().numpy()
                                for t in confusion_stats_ref(**args)])
    per_class = counts[0] / (counts.sum(0) + 1e-15)
    miou = float(per_class.mean())
    print(f"[8] mean IoU {report['mean_iou']:.6f} (plain K7: {miou:.6f}), "
          f"mean F1 {report['mean_f1']:.6f}, loss {report['loss']:.5f}", flush=True)
    check(report["mean_iou"] == miou, "mean IoU differs from the plain K7's")
    check(np.isfinite(report["loss"]), "non-finite eval loss")

    def run():
        with contextlib.redirect_stdout(io.StringIO()):   # the class-wise table
            evaluate_checkpoint(model, batches[:1], N_CLASSES, device=dev)

    med = _timed_steps(8, run, 5)
    print(f"[8] evaluate_checkpoint of one {EVAL_BATCH}x{PATH_A_HW[0]}x"
          f"{PATH_A_HW[1]} batch: median {med:.3f} ms "
          f"({EVAL_BATCH * 1e3 / med:.2f} images/s)", flush=True)
    first = cases[:K6_PER_FORWARD] + [c for c in cases if c["kind"] == "K7"][:1]
    time_cases(8, first)
    per = (f"sum over the launches of one eval batch ({EVAL_BATCH}x{PATH_A_HW[0]}x"
           f"{PATH_A_HW[1]}); launches over {EVAL_BATCHES} batches")
    return {k: kernel_entry(k, first, launches[k], per) for k in ("K6a", "K7")}


# ------------------------------------------------------------- the zoo

# Path-A zoo string -> Conv3x3s at output H·W >= 4096 in one 256x256 forward
# (K6a forward launches; K6b per train step), and how many of them need a
# dx (UNet's inc.conv1 reads the image, which needs no gradient)
ZOO = {"smp_unet18": (7, 7), "smp_DeepLabV3+": (0, 0), "smp_MANet": (8, 8),
       "unet": (12, 11), "segnet": (0, 0), "resnet18": (0, 0)}
ZOO_STEPS, ZOO_TIMED = 3, 5


def zoo_phase(dev, seed) -> dict:
    """Phase 9; returns {model: {"K6a", "K6b", "K7": launches of its train
    step and eval batch}}."""
    from mmr_tpu_torch.data.augment import augment_path_a_batch
    from mmr_tpu_torch.infer.evaluator import evaluate_checkpoint
    from mmr_tpu_torch.losses import blended_ce_dice_loss
    from mmr_tpu_torch.models import create_model
    from mmr_tpu_torch.train.optim import build_optimizer
    from mmr_tpu_torch.train.schedules import step_lr
    from mmr_tpu_torch.train.state import TrainState
    from mmr_tpu_torch.train.steps import make_train_step

    loss_fn = functools.partial(blended_ce_dice_loss, dice_loss_factor=0.5)
    lr = step_lr(PATH_A_LR, PATH_A_EPOCHS, 2, 0.1)(0)
    images, masks = _path_a_batch(np.random.RandomState(seed + 3), PATH_A_BATCH)
    images, masks = images[None].to(dev), masks.long()[None].to(dev)
    batch = _path_a_batch(np.random.RandomState(seed + 4), EVAL_BATCH)
    out = {}
    for i, (zoo, (k6, dx)) in enumerate(ZOO.items()):
        gen = torch.Generator().manual_seed(seed + 10 + i)
        model = create_model(zoo, classes=N_CLASSES, device=dev, generator=gen)
        perturb(model, gen)
        n_params = sum(p.numel() for p in model.parameters())
        opt = build_optimizer("adam", weight_decay=PATH_A_WD)
        state = TrainState.create(model, opt)
        step = make_train_step(model, opt, loss_fn, N_CLASSES,
                               augment=augment_path_a_batch, device=dev)
        g = torch.Generator(device=dev).manual_seed(seed)
        with recording() as (records, recorders):
            state, met = step(state, images, masks, lr, g)
            torch.cuda.synchronize()
        launches = {k: r.launches for k, r in recorders.items()}
        n_dx = sum(1 for k, *_, bwd in records if k == "K6a" and bwd)
        print(f"[9] {zoo}: {type(model).__name__}, {n_params} parameters; "
              f"launches in one train step: K6a {launches['K6a'] - n_dx} forward "
              f"+ {n_dx} dx, K6b {launches['K6b']}", flush=True)
        check(launches == _counts(K6a=k6 + dx, K6b=k6) and n_dx == dx,
              f"{zoo}: unexpected launch counts {launches}")
        hold_records(9, records)
        del records
        losses = [float(met["loss"])]
        for _ in range(ZOO_STEPS - 1):
            state, met = step(state, images, masks, lr, g)
            losses.append(float(met["loss"]))
        print(f"[9] {zoo}: losses over {ZOO_STEPS} steps: "
              f"{[round(v, 5) for v in losses]}", flush=True)
        check(all(np.isfinite(losses)) and losses[-1] < losses[0],
              f"{zoo}: the loss did not fall over {ZOO_STEPS} steps")
        print(f"[9] {zoo} train step (B={PATH_A_BATCH}, {PATH_A_HW[0]}x"
              f"{PATH_A_HW[1]}, bf16, augmentation on):", flush=True)
        med = _timed_steps(9, lambda: step(state, images, masks, lr, g), ZOO_TIMED)
        print(f"[9] {zoo}: {PATH_A_BATCH * 1e3 / med:.2f} images/s", flush=True)

        with recording() as (records, recorders), \
                contextlib.redirect_stdout(io.StringIO()):
            report = evaluate_checkpoint(model, [batch], N_CLASSES,
                                         loss_fn=loss_fn, device=dev)
            torch.cuda.synchronize()
        eval_launches = {k: r.launches for k, r in recorders.items()}
        print(f"[9] {zoo}: evaluate_checkpoint of one {EVAL_BATCH}x"
              f"{PATH_A_HW[0]}x{PATH_A_HW[1]} batch: K6a {eval_launches['K6a']}, "
              f"K7 {eval_launches['K7']}; mean IoU {report['mean_iou']:.6f}, "
              f"loss {report['loss']:.5f}", flush=True)
        check(eval_launches == _counts(K6a=k6, K7=1),
              f"{zoo}: unexpected eval launch counts {eval_launches}")
        check(np.isfinite(report["loss"]) and np.isfinite(report["mean_iou"]),
              f"{zoo}: non-finite eval metrics")
        hold_records(9, records)

        def run():
            with contextlib.redirect_stdout(io.StringIO()):
                evaluate_checkpoint(model, [batch], N_CLASSES, device=dev)

        med = _timed_steps(9, run, ZOO_TIMED)
        print(f"[9] {zoo}: eval batch median {med:.3f} ms "
              f"({EVAL_BATCH * 1e3 / med:.2f} images/s)", flush=True)
        out[zoo] = {"K6a": launches["K6a"], "K6b": launches["K6b"],
                    "eval_K6a": eval_launches["K6a"], "eval_K7": eval_launches["K7"]}
        del model, state, opt, step, records
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------- K8

K8_SHAPE = (32, 512, 512, 16, 16)   # conv3x3.py:4-7, :22: 16 -> 16 on (32, 512, 512)
K8_EXTRA = [(torch.float32, (8, 256, 256, 16, 16)),   # f32 storage
            (torch.bfloat16, (4, 200, 136, 24, 16))]  # H not a multiple of 16


def _k8_run(dev, gen, dtype, shape):
    """Forward and backward of ``conv3x3_bias_act`` (ReLU, bias) under
    ``_FORCE``: K8a forward, K8a dx, K8b dW. Returns the recording."""
    from mmr_tpu_torch.ops import conv3x3 as k8

    b, h, w, cin, cout = shape
    x = torch.randn(b, h, w, cin, device=dev, generator=gen).to(dtype)
    wt = torch.randn(3, 3, cin, cout, device=dev, generator=gen) / math.sqrt(9 * cin)
    bias = 0.5 * torch.randn(cout, device=dev, generator=gen)
    gy = torch.randn(b, h, w, cout, device=dev, generator=gen).to(dtype)
    x.requires_grad_()
    old, k8._FORCE = k8._FORCE, True
    try:
        with recording() as (records, recorders):
            y = k8.conv3x3_bias_act(x, wt, bias, True)
            y.backward(gy)
            torch.cuda.synchronize()
    finally:
        k8._FORCE = old
    launches = {k: r.launches for k, r in recorders.items()}
    check(launches == _counts(K8a=2, K8b=1),
          f"K8 {shape} {dtype}: unexpected launch counts {launches}")
    check(bool(torch.isfinite(y).all()) and y.dtype == dtype,
          f"K8 {shape} {dtype}: non-finite or mistyped output")
    return records, launches


def k8_phase(dev, seed) -> dict:
    """Phase 10; returns {K8a, K8b: kernel entry} of the main shape."""
    gen = torch.Generator(device=dev).manual_seed(seed + 5)
    b, h, w, cin, cout = K8_SHAPE
    records, launches = _k8_run(dev, gen, torch.bfloat16, K8_SHAPE)
    print(f"[10] conv3x3_bias_act under _FORCE, bf16 {cin} -> {cout} on "
          f"({b}, {h}, {w}): launches {launches}", flush=True)
    cases = hold_records(10, records)
    del records
    time_cases(10, cases)
    for dtype, shape in K8_EXTRA:
        recs, _ = _k8_run(dev, gen, dtype, shape)
        print(f"[10] {str(dtype)[6:]} {shape}:", flush=True)
        extra = hold_records(10, recs)
        del recs
        time_cases(10, extra)
    per = (f"sum over the launches of one conv3x3_bias_act forward + backward, "
           f"bf16 {cin} -> {cout} on ({b}, {h}, {w}): forward and dx for K8a")
    return {k: kernel_entry(k, cases, launches[k], per) for k in ("K8a", "K8b")}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the weights and the synthetic frames")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1

    from mmr_tpu_torch.data.synthetic import render_frame
    from mmr_tpu_torch.infer.evaluator import run_inference
    from mmr_tpu_torch.infer.sliding_window import (_window_starts,
                                                    make_sliding_window_fn)
    from mmr_tpu_torch.models import create_model, get_preprocessing
    from mmr_tpu_torch.ops import _build
    from mmr_tpu_torch.ops.fused_conv import fused_conv, fused_conv_down

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")

    # ---- 1. card, build ------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    t0 = time.time()
    _build.library()
    print(f"[1] kernels built and loaded in {time.time() - t0:.1f} s", flush=True)

    # ---- model, one frame's windows --------------------------------------
    gen = torch.Generator().manual_seed(args.seed)
    model = create_model(classes=N_CLASSES, device=dev, generator=gen,
                         fused=True, fused_frontend=True)
    perturb(model, gen)
    plain32 = create_model(classes=N_CLASSES, device=dev, dtype=torch.float32)
    plain32.load_state_dict(model.state_dict())
    plain16 = create_model(classes=N_CLASSES, device=dev)
    plain16.load_state_dict(model.state_dict())
    pre = get_preprocessing("tu-mobilenetv3_small_100")
    rng = np.random.RandomState(args.seed)
    img, _ = render_frame(rng, *FRAME, N_CLASSES - 1)
    frame = pre(torch.from_numpy(img).to(dev)).to(torch.bfloat16)
    coords = [(y, x) for y in _window_starts(FRAME[0], ROI[0], 0.5)
              for x in _window_starts(FRAME[1], ROI[1], 0.5)]
    windows = torch.stack([frame[y:y + ROI[0], x:x + ROI[1]] for y, x in coords])
    n_win = windows.shape[0]
    check(n_win == 20, f"full-HD grid has {n_win} windows, expected 20")

    # ---- 2. record one forward's launches; kernel vs plain ------------------
    with recording() as (records, recorders), torch.inference_mode():
        logits_f = model(windows)
        torch.cuda.synchronize()
    launches = {k: r.launches for k, r in recorders.items()}
    print(f"[3] launches per window-batch forward: {launches}", flush=True)
    want = {k: {"K1": 21, "K2": 2}.get(k, 0) for k in KERNELS}
    check(launches == want, f"expected {want} launches")
    labels = {"K1": iter(k1_labels(model.packed_min_hw)),
              "K2": iter(["stem", "b0_0.conv_dw"])}
    cases = hold_records(2, records, labels)

    # ---- 3. fused model vs plain f32 model -------------------------------
    with torch.inference_mode():
        logits_p = plain32(windows.float())
    agree = (logits_f.argmax(-1) == logits_p.argmax(-1)).float().mean().item()
    dl = (logits_f - logits_p).abs()
    within = bool(torch.allclose(logits_f, logits_p, atol=0.25, rtol=0.05))
    print(f"[3] fused vs plain f32 ({n_win} windows): argmax agreement {agree:.5f}, "
          f"max |dlogit| {dl.max().item():.4f} (max |logit| "
          f"{logits_p.abs().max().item():.3f}), within atol .25/rtol .05: {within}",
          flush=True)
    check(agree >= 0.99 and within, "fused model disagrees with the plain model")
    check(bool(torch.isfinite(logits_f).all()), "non-finite fused logits")

    # ---- 4. serving --------------------------------------------------------
    class Videos:
        infer_batch_size = BATCH

        def __init__(self):
            self.items = []
            for v in range(VIDEOS):
                fr = [render_frame(rng, *FRAME, N_CLASSES - 1)
                      for _ in range(FRAMES)]
                im = np.stack([(f[0] * 255.0 + 0.5).astype(np.uint8) for f in fr])
                mk = np.stack([f[1] for f in fr])
                for t0 in range(0, FRAMES, BATCH):
                    t1 = min(t0 + BATCH, FRAMES)
                    self.items.append({"id": f"video_{v:03d}", "t0": t0, "t1": t1,
                                       "image": im[t0:t1], "mask": mk[t0:t1]})

        def __iter__(self):
            return iter(self.items)

    t0 = time.time()
    data = Videos()
    print(f"[4] rendered {VIDEOS} x {FRAMES} full-HD frames in "
          f"{time.time() - t0:.1f} s", flush=True)
    config = {"n_classes": N_CLASSES - 1, "patch_size": ROI, "sw_overlap": 0.5}
    fused_conv.launches = fused_conv_down.launches = 0
    report = run_inference(model, data, config, preprocess=pre,
                           save_plots=False, device=dev)
    s1, s2 = fused_conv.launches, fused_conv_down.launches
    n_frames = VIDEOS * FRAMES
    print(f"[4] serving launches: K1 {s1}, K2 {s2} over {n_frames} frames", flush=True)
    check(s1 == 21 * n_frames and s2 == 2 * n_frames,
          "serving did not run every frame through the kernels")
    print("[4] serving " + json.dumps({v: {k: round(x, 4) for k, x in s.items()}
                                       for v, s in report["videos"].items()}),
          flush=True)
    check(np.isfinite(report["overall_mean_iou"]), "non-finite IoU")
    first = data.items[0]["image"]
    sw_f = make_sliding_window_fn(model, ROI, N_CLASSES, preprocess=pre,
                                  compute_dtype=torch.bfloat16, fuse_blend=True,
                                  device=dev)
    sw_p = make_sliding_window_fn(plain32, ROI, N_CLASSES, preprocess=pre,
                                  fuse_blend=True, device=dev)
    a_f, a_p = sw_f(first).argmax(-1), sw_p(first).argmax(-1)
    agree_sw = (a_f == a_p).float().mean().item()
    print(f"[4] first frame batch ({first.shape[0]} frames): fused vs plain f32 "
          f"argmax agreement {agree_sw:.5f}", flush=True)
    check(agree_sw >= 0.99, "served argmax disagrees with the plain path")

    # ---- 5. times ----------------------------------------------------------
    time_cases(5, cases)
    with torch.inference_mode(), library_conv3x3():
        for name, m in (("fused", model), ("plain bf16 cuDNN", plain16)):
            ts = sorted(cuda_ms(lambda: m(windows), 1, warmup=0 if i else 2)
                        for i in range(REPS))
            med = ts[len(ts) // 2]
            print(f"[5] one full-HD frame ({n_win} windows) forward, {name}: "
                  f"median {med:.3f} ms ({1e3 / med:.2f} frames/s), max "
                  f"{ts[-1]:.3f} ms, {len(ts)} samples", flush=True)
            issue = host_issue_ms(lambda: m(windows), 5)
            busy, top = device_profile(lambda: m(windows), 3)
            idle = f"{1 - busy / med:.3f}" if busy > 0 else "not measured"
            print(f"[5]   {name}: host issue median {issue:.3f} ms; device busy "
                  f"{busy:.3f} ms per frame (torch.profiler, 3 frames); device "
                  f"idle share of the median {idle}", flush=True)
            for key, t, cnt in top:
                print(f"[5]     {t:8.3f} ms  x{cnt:5.1f}  {key}", flush=True)

    per = "sum over the launches of one 20-window forward"
    kernels = [kernel_entry("K1", cases, s1, per), kernel_entry("K2", cases, s2, per)]
    # ---- 6. training -------------------------------------------------------
    train = train_phase(model, dev, rng)
    for kind, e in zip(("K1", "K2"), kernels):   # their train-step numbers beside
        e.update({f"train_{k}": train[kind][k] for k in
                  ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
                   "bound_by", "library_ms")})
    kernels += [train[k] for k in ("K3", "K4", "K5a", "K5b")]
    # ---- 7. Path-A training, 8. Path-A evaluation ------------------------
    path_a, entries = path_a_train_phase(dev, args.seed)
    evals = path_a_eval_phase(path_a, dev, args.seed)
    entries["K6a"].update({f"eval_{k}": evals["K6a"][k] for k in
                           ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
                            "bound_by", "library_ms", "per")})
    kernels += [entries["K6a"], entries["K6b"], evals["K7"]]
    # ---- 9. the rest of the Path-A zoo, 10. K8 ------------------------------
    zoo = zoo_phase(dev, args.seed)
    for kind, key in (("K6a", "K6a"), ("K6b", "K6b"), ("K7", "eval_K7")):
        e = kernels[[k["name"] for k in kernels].index(KERNELS[kind][1])]
        e["zoo_launches"] = {m: c[key] for m, c in zoo.items()}
    entries["K6a"]["zoo_eval_launches"] = {m: c["eval_K6a"] for m, c in zoo.items()}
    k8 = k8_phase(dev, args.seed)
    kernels += [k8["K8a"], k8["K8b"]]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": 1}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
