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
   ``mmr_tpu_torch/csrc`` (build time, ``ptxas -v``, one line of registers
   and spills per Hopper kernel: ``common.cuh``'s, K1's
   ``pending_conv_kernel``, K5b's ``head_bwd_kernel`` and the stride-2
   pair's ``down_*_kernel``s, K6b/K8b's ``conv3x3_dw_kernel``, the narrow
   tile's ``narrow_head_kernel`` (K5a) and ``narrow_conv_kernel`` (K8a)),
   and each Hopper kernel's dynamic shared memory and resident blocks per
   SM (K2's and K4's at the flagship's input channels; the dW kernel's per
   mode; the narrow tile's at cin 16 and 32).
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
   (20 K1 + 20 K3, 2 K2 + 2 K4, 1 K5a + 1 K5b), K5a's statistics and
   confusion bit-equal on a second launch; the fused step vs the plain
   f32 step on the same weights and batch (loss rtol 2e-2; train-mode head
   argmax agreement with plain f32 no lower than the plain bf16 model's,
   less 0.02); five steps on one batch (the loss falls);
   the median step time, frames/s, host issue time, device-busy time, top
   device events; each training kernel's time, plain time, bound and one
   library call (cuDNN ``convolution_backward`` on the materialized input
   for K3/K4; ``F.conv2d`` + log-softmax + DiceCE under autograd for K5).
   6e. K4's dense dx (not on the flagship's path, whose stem reads the
   image): the train-mode stem on a B=8 512×640 image that requires a
   gradient, its K4 launch (dW and dx) held at the backward bound, timed
   beside its bound, plain version and ``convolution_backward`` with the
   input mask on, split by device kernel; its own entry in the kernels line.

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
   (``confusion_stats``, adding into ``Evaluate``'s running total) equals
   its plain version exactly, every K6a launch within 2e-2 (17 per
   forward); the returned mean IoU equals the one from the plain K7 on the
   same id maps. 8b. K7 alone at a full-HD uint8 / int64 pair, int32
   maps, 128 classes with ids outside [0, nc) and views one byte into
   their storage: exact, f32 stats and running totals, bit-equal on a
   second launch.

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
    and one with H not a multiple of 16, held and timed; each K8a launch
    (forward, dx) split by device kernel with its persistent grid.
11. Path A through its two CLIs: 16 train and 8 val 256×256 synthetic
    frames written as PNGs by ``data/png.py``; ``cli.train_path_a.main``
    for 2 epochs (``smp_UNet++``, batches 8 / 4), ``cli.eval_path_a.main``
    on its ``best_f1`` checkpoint: exit codes, the log, checkpoint, curves
    and triptychs, launch counts (the trainer's K6a / K6b, one K7 a val
    batch), the mean IoU against the plain K7's, the evaluator's model
    against its checkpoint; the evaluation's images/s, host issue and
    device busy.

Times of every new kernel beside its plain version, its bound and one
library call (``F.conv2d`` for K6a and K8a, ``convolution_backward`` for
K6b and K8b, ``torch.bincount`` on ``gt·C + pred`` for K7; never used by
the port). Those times are of each launch repeated alone, wrapper (weight
packs, cached per weight version for K1, K2, K4, K5 and K8a) included; phases
5–10 also print the device time of K1 and K2 (serve, train), K3, K4, K5a,
K5b, K6a, K6b (phases 7 and 9), K7 (phase 8), K8a and K8b (phase 10) by part
(``device_split``: ``torch.profiler`` time of the kernels alone — K2's
dense and depthwise kernels and their moments' reduction; K3's dy prep,
dW, dx and the source-resolution dx of lazily ×2 inputs; K4's dense and
depthwise kernels and their reduction; K5a's head kernel and its rows'
reduction; K5b's dx + dW kernel and its reduction; K6a's and K8a's
forward and dx; K6b's and K8b's dW kernel and its reduction; K7's one
kernel, with a memset and a finalize kernel where a version has them),
per launch
and summed,
beside the share of the wrapper-included time that is host work; phases 5
and 6 also time every K1 launch at each output-channel tile it can take
(``k1_tile_ab``).
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
    whether a backward made it), cloned (the arguments as the call found
    them): the optimizer updates the weights in place, and K7 adds into a
    running total. A wrapper counts its launches under its module-level name, so
    while the recorder stands there they land on the recorder's
    ``launches``, which starts at 0. Yields (records, {kind: recorder})."""
    records, recorders, saved = [], {}, []
    for kind, (mod, name, *_) in KERNELS.items():
        fn = wrapper(kind)
        sig = inspect.signature(fn)

        def wrapped(*a, _fn=fn, _kind=kind, _sig=sig, **kw):
            args = _sig.bind(*a, **kw)
            args.apply_defaults()
            with torch.inference_mode(False):   # clones that keep versions
                before = _clone(args.arguments)  # K7 adds into its total
            out = _fn(*a, **kw)
            with torch.inference_mode(False):
                records.append((_kind, before, _clone(out), _in_backward()))
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


# the port's kernels each wrapper launches (demangled CUDA names hold these),
# as parts of its device time; K6a's and K8a's part is the case's label
# (forward, dx)
PARTS = {
    "K1": {"pending_conv_kernel": "conv"},
    "K2": {"down_stem_kernel": "dense", "down_dw_fwd_kernel": "depthwise",
           "down_rows_reduce_kernel": "reduce"},
    "K3": {"dy_prep_kernel": "dy prep", "conv_dw_wg_kernel": "dW",
           "conv_wg_kernel": "dx", "conv_up2_dx_kernel": "dx x2"},
    "K4": {"down_stem_bwd_kernel": "dense", "down_dw_bwd_kernel": "depthwise",
           "down_rows_reduce_kernel": "reduce"},
    "K5a": {"narrow_head_kernel": "head", "head_rows_reduce_kernel": "reduce"},
    "K5b": {"head_bwd_kernel": "dx + dW", "head_bwd_reduce_kernel": "reduce"},
    "K6a": {"conv_wg_kernel": None},
    "K8a": {"narrow_conv_kernel": None},
    "K6b": {"conv3x3_dw_kernel": "dW", "dw_rows_reduce_kernel": "reduce"},
    "K8b": {"conv3x3_dw_kernel": "dW", "dw_rows_reduce_kernel": "reduce"},
    "K7": {"confusion_kernel": "count", "finalize_kernel": "finalize",
           "Memset": "memset"},
}


def graph_ms(fn, reps: int = 20) -> float:
    """Device ms a call of ``fn`` without the profiler: CUDA events around
    ``reps`` back-to-back replays of one CUDA graph of it (no host work
    between the launches), warmed up and captured on one side stream (a
    wrapper's per-stream scratch is then made before the capture)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side, capture_error_mode="relaxed"):
        fn()
    graph.replay()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _profiled_parts(fn, args, names, part_of, reps):
    """({part: ms a call}, {part: events counted}) of ``reps`` calls of
    ``fn(**args)`` under ``torch.profiler``, a warm-up call inside it
    first. The profiler has been seen to lose some calls' events (0.2 to
    0.8 of them a call, or all of them) and, without a synchronize at each
    step, to count the warm-up's: the profile is taken again, up to three
    times, until it has events and every part counts a whole number of
    them a call, and a part's time is its mean event time times its events
    a call, rounded. ({}, {}) when no profile had an event."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    for _ in range(3):
        with torch.no_grad(), profile(
                activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                schedule=schedule(wait=0, warmup=1, active=reps, repeat=1)) as prof:
            for _ in range(reps + 1):   # each call done before its step ends
                fn(**args)
                torch.cuda.synchronize()
                prof.step()
        total, counts = {}, {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA and any(k in e.name for k in names):
                part = part_of(e.name)
                total[part] = total.get(part, 0.0) + e.time_range.elapsed_us() / 1e3
                counts[part] = counts.get(part, 0) + 1
        if counts and all(n % reps == 0 for n in counts.values()):
            break
    return ({k: v / counts[k] * max(1, round(counts[k] / reps))
             for k, v in total.items()}, counts)


def persistent_grid(kind, args):
    """The persistent grid a launch of ``kind`` on ``args`` runs, as its C
    entry sizes it from the card (blocks, blocks a SM, SMs, shared memory),
    or None for a kernel whose grid follows its tiles."""
    from mmr_tpu_torch.ops.conv3x3 import narrow_grid, uses_narrow
    from mmr_tpu_torch.ops.conv3x3_packed import dw_grid
    from mmr_tpu_torch.ops.fused_conv import down_grid
    from mmr_tpu_torch.ops.head_loss import LABEL_KINDS, head_grid

    dev = torch.cuda.current_device()
    if kind in ("K2", "K4"):
        return down_grid(args["x"], args["w"], args["depthwise"], kind == "K4",
                         bool(args.get("need_dx")))
    if kind in ("K6b", "K8b"):
        x, g = args["x"], args["g" if kind == "K6b" else "dy"]
        return dw_grid(*x.shape, g.shape[-1], x.dtype == torch.float32, dev)
    if kind == "K5a":
        return head_grid(*args["x"].raw.shape, args["w"].shape[-1],
                         LABEL_KINDS[args["labels"].dtype], dev)
    if kind == "K8a" and uses_narrow(args["x"].shape[-1], args["w"].shape[-1]):
        x = args["x"]
        return narrow_grid(*x.shape, args["w"].shape[-1],
                           x.dtype == torch.float32, dev)
    return None


def device_split(phase, cases, kind, reps=5) -> dict:
    """Device time of the kernels each ``kind`` launch runs, by part, from
    ``torch.profiler`` (``_profiled_parts``; the wrapper's own weight packs
    and zero fills are other kernels and not counted): the parts of
    ``PARTS[kind]`` by kernel name (K6a, K8a: "forward" and "dx" by the
    case's label). Prints each launch's parts with their events counted a
    call (a fraction: events lost; "not measured" where no profile had
    one), the persistent grid of K2, K4, K5a, K6b, K8a and K8b as
    their C entries size it (blocks, blocks a SM, SMs) and their device time from a
    CUDA graph's replays (``graph_ms``, no profiler), the parts' sums and
    the share of the wrapper-included time (``ms``, each launch timed
    alone) that is not device time, over the launches that were measured.
    Returns {part: ms summed over the measured cases}."""
    fn, split, names, measured = wrapper(kind), {}, PARTS[kind], []
    for c in (c for c in cases if c["kind"] == kind):
        args = c["args"]
        with torch.no_grad():
            fn(**args)
        torch.cuda.synchronize()
        if kind in ("K6a", "K8a"):
            label = "dx" if c["label"].endswith(" dx") else "forward"
            part_of = lambda name, label=label: label
        else:
            part_of = lambda name: next(v for k, v in names.items() if k in name)
        parts, counts = _profiled_parts(fn, args, names, part_of, reps)
        for k, v in parts.items():
            split[k] = split.get(k, 0.0) + v
        if parts:
            measured.append(c)
        grid = ""
        gr = persistent_grid(kind, args)
        if gr is not None:
            try:
                with torch.no_grad():
                    graph = f"{graph_ms(lambda: fn(**args)):.4f} ms"
            except RuntimeError as e:   # a diagnostic: say why, go on
                graph = f"not measured ({str(e)[:80]})"
            grid = (f"; grid {gr['blocks']} blocks ({gr['per_sm']} a SM x "
                    f"{gr['sms']} SMs, {gr['smem']} B shared memory); "
                    f"{graph} a call from a CUDA graph's replays")
        dev = "not measured (no profiler event in 3 profiles)"
        if parts:
            dev = ", ".join(f"{k} {v:.4f} ({counts[k] / reps:g} a call)"
                            for k, v in parts.items()) + " ms"
        print(f"[{phase}] {kind:3s} {c['label']:14s} device {dev}{grid}",
              flush=True)
    n = sum(c["kind"] == kind for c in cases)
    print(f"[{phase}] {kind} device split, summed over the {len(measured)} "
          f"of {n} launches measured (ms): "
          + json.dumps({k: round(v, 4) for k, v in split.items()}), flush=True)
    timed = [c["ms"] for c in measured if "ms" in c]
    if timed:
        dev, alone = sum(split.values()), sum(timed)
        print(f"[{phase}] {kind}: device {dev:.4f} ms, each launch timed alone "
              f"with its wrapper {alone:.4f} ms: wrapper work "
              f"{100 * (1 - dev / alone):.1f} %", flush=True)
    return split


def k1_tile_ab(phase, cases) -> dict:
    """K1's output-channel tiles A/B: every K1 case timed (CUDA events,
    wrapper included, packs cached; the least of three runs of ``REPS // 2``
    launches, so that a stall of the host does not decide) at each tile N
    in (16, 32, 64) its cout takes, summed by cout. Prints the sums and the
    fastest N per cout and returns {cout: {N: ms}}."""
    from mmr_tpu_torch.ops import fused_conv as fc

    table = {}
    for c in (c for c in cases if c["kind"] == "K1"):
        cout = c["args"]["weights"][0].shape[-1]
        for n in (16, 32, 64):
            if n > fc._wg_tile(cout)[0]:
                continue
            old = fc.K1_TILE.get(cout)
            fc.K1_TILE[cout] = n
            try:
                with torch.no_grad():
                    ms = min(cuda_ms(lambda: fc.fused_conv(**c["args"]),
                                     REPS // 2) for _ in range(3))
            finally:
                if old is None:
                    del fc.K1_TILE[cout]
                else:
                    fc.K1_TILE[cout] = old
            row = table.setdefault(cout, {})
            row[n] = row.get(n, 0.0) + ms
    for cout, row in sorted(table.items()):
        best = min(row, key=row.get)
        print(f"[{phase}] K1 tile A/B, cout {cout}: " + ", ".join(
            f"N={n} {ms:.4f} ms" for n, ms in row.items())
            + f"; fastest N={best}, in use N="
            f"{fc.K1_TILE.get(cout, fc._wg_tile(cout)[0])}", flush=True)
    return table


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
    head = next(c for c in cases if c["kind"] == "K5a")
    with torch.no_grad():
        again = wrapper("K5a")(**head["args"])
    _, stats, conf = next(rec[2] for rec in records if rec[0] == "K5a")
    check(torch.equal(again[1], stats) and torch.equal(again[2], conf),
          "K5a's statistics differ on a second launch")
    print("[6] K5a stats and conf bit-equal on a second launch", flush=True)

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
    k1_tile_ab(6, cases)
    per = f"sum over the launches of one train step (B={TRAIN_BATCH}, {ROI[0]}x{ROI[1]})"
    out = {kind: kernel_entry(kind, cases, launches[kind], per) for kind in FLAGSHIP}
    for kind in ("K1", "K2", "K3", "K4", "K5a", "K5b"):
        out[kind]["device_ms"] = device_split(6, cases, kind)
    return out


def stem_dx_phase(model, dev) -> dict:
    """Phase 6e: K4's dense dx (``need_dx``; not on the flagship's path,
    whose stem reads the image) at the stem's shape: the train-mode stem
    (``fused_stem``: K2 with moments, then K4) on a B=8 512×640 image that
    requires a gradient, its BN affine from the moments, a loss on the
    pending output. The K4 launch is held against its plain version,
    timed, split by device kernel; returns its kernel entry."""
    from mmr_tpu_torch.models.fused_encoder import fused_stem

    gen = torch.Generator(device=dev).manual_seed(7)
    enc = model.encoder
    enc.train()
    x = torch.randn(TRAIN_BATCH, 3, *ROI, device=dev, generator=gen)
    x = x.contiguous(memory_format=torch.channels_last).requires_grad_(True)
    with recording() as (records, recorders):
        f = fused_stem(enc, x)
        r = torch.randn(f.raw.shape, device=dev, generator=gen)
        ((f.raw.float() * r).sum() + (f.scale * f.scale).sum()
         + f.shift.sum()).backward()
        torch.cuda.synchronize()
    enc.eval()
    launches = {k: rec.launches for k, rec in recorders.items()}
    print(f"[6e] launches of the stem's train step with the image's gradient: "
          f"{launches}", flush=True)
    check(launches == _counts(K2=1, K4=1), "expected one K2 and one K4 launch")
    k4 = [rec for rec in records if rec[0] == "K4"]
    check(k4[0][1]["need_dx"] and not k4[0][1]["depthwise"],
          "the stem's K4 launch did not compute the dense dx")
    check(bool(torch.isfinite(x.grad).all()), "non-finite image gradient")
    cases = hold_records("6e", k4)
    time_cases("6e", cases)
    entry = kernel_entry("K4", cases, launches["K4"],
                         f"one launch: the stem's dW and dense dx (need_dx) at "
                         f"B={TRAIN_BATCH}, {ROI[0]}x{ROI[1]}; not on the "
                         "flagship's path")
    entry["name"] = "fused_conv_down_bwd (dense dx)"
    entry["device_ms"] = device_split("6e", cases, "K4")
    return entry


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
    out = {k: kernel_entry(k, cases, launches[k], per) for k in ("K6a", "K6b")}
    for k in ("K6a", "K6b"):
        out[k]["device_ms"] = device_split(7, cases, k)
    return model, out


def path_a_eval_phase(model, dev, seed) -> dict:
    """Phase 8; returns {K6a, K7: kernel entry}."""
    from mmr_tpu_torch.infer.evaluator import evaluate_checkpoint
    from mmr_tpu_torch.losses import blended_ce_dice_loss

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

    miou = plain_k7_miou(records)
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
    out = {k: kernel_entry(k, first, launches[k], per) for k in ("K6a", "K7")}
    for k in ("K6a", "K7"):
        out[k]["device_ms"] = device_split(8, first, k)
    return out


def plain_k7_miou(records) -> float:
    """Mean IoU of the recorded K7 launches' maps, counted by the plain K7
    as ``Evaluate`` adds them (f64 sums, its epsilon)."""
    from mmr_tpu_torch.ops.confusion import confusion_stats_ref

    counts = np.zeros((3, N_CLASSES), np.float64)
    for k, args, *_ in records:
        if k == "K7":
            counts += np.stack([t.cpu().double().numpy() for t in confusion_stats_ref(
                args["pred_ids"], args["gt_ids"], args["num_classes"])])
    return float((counts[0] / (counts.sum(0) + 1e-15)).mean())


# K7 at other shapes and kinds: (shape, pred kind, gt kind, classes, the
# elements of storage before both maps: views not 16-byte aligned if not 0)
K7_HOLDS = [((1, 1080, 1920), torch.uint8, torch.int64, 10, 0),
            ((4, 256, 256), torch.int32, torch.int32, 10, 0),
            ((2, 300, 200), torch.int64, torch.uint8, 128, 0),
            ((262139,), torch.uint8, torch.uint8, 10, 1)]


def k7_hold_phase(dev, seed):
    """Phase 8b: K7 held exactly against its plain version at a full-HD
    uint8 / int64 pair, int32 maps, 128 classes with ids outside [0, nc),
    and views that start one byte into their storage with n no multiple of
    16; f32 stats and a running total, each bit-equal on a second launch."""
    from mmr_tpu_torch.ops.confusion import confusion_stats, confusion_stats_ref

    g = torch.Generator(device=dev).manual_seed(seed + 7)

    def ids(shape, dt, nc, off):
        n = math.prod(shape)
        a = torch.randint(0 if dt == torch.uint8 else -2, nc + 3, (off + n,),
                          device=dev, generator=g)
        return a.to(dt)[off:].view(shape)

    for shape, pdt, gdt, nc, off in K7_HOLDS:
        pred, gt = ids(shape, pdt, nc, off), ids(shape, gdt, nc, off)
        half = pred.numel() // 2
        gt.view(-1)[:half] = pred.reshape(-1)[:half].to(gdt)   # agreements
        want = torch.stack(confusion_stats_ref(pred, gt, nc))
        got = [torch.stack(confusion_stats(pred, gt, nc)) for _ in range(2)]
        totals = [confusion_stats(pred, gt, nc,
                                  total=torch.zeros((3, nc), dtype=torch.int64, device=dev))
                  for _ in range(2)]
        check(all(torch.equal(t, want) for t in got)
              and all(torch.equal(t, want.long()) for t in totals),
              f"K7 {tuple(pred.shape)} {pdt} / {gdt}, nc {nc}: differs from its "
              "plain version or between launches")
        print(f"[8b] K7 {tuple(pred.shape)} {str(pdt)[6:]} / {str(gdt)[6:]}, nc {nc}, "
              f"{off} element(s) into storage: exact, bit-equal on a second "
              f"launch ({int(want[0].sum())} tp)", flush=True)


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
        k6b = [c for c in hold_records(9, records) if c["kind"] == "K6b"]
        del records
        if k6b:
            time_cases(9, k6b)
            device_split(9, k6b, "K6b")
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
    split_a = device_split(10, cases, "K8a")
    split = device_split(10, cases, "K8b")
    for dtype, shape in K8_EXTRA:
        recs, _ = _k8_run(dev, gen, dtype, shape)
        print(f"[10] {str(dtype)[6:]} {shape}:", flush=True)
        extra = hold_records(10, recs)
        del recs
        time_cases(10, extra)
        device_split(10, extra, "K8a")
        device_split(10, extra, "K8b")
    per = (f"sum over the launches of one conv3x3_bias_act forward + backward, "
           f"bf16 {cin} -> {cout} on ({b}, {h}, {w}): forward and dx for K8a")
    out = {k: kernel_entry(k, cases, launches[k], per) for k in ("K8a", "K8b")}
    out["K8a"]["device_ms"] = split_a
    out["K8b"]["device_ms"] = split
    return out


# ------------------------------------------------- Path A through its CLIs

CLI_TRAIN, CLI_VAL, CLI_EPOCHS, CLI_BATCH, CLI_VAL_BATCH = 16, 8, 2, 8, 4


def path_a_cli_phase(dev, seed) -> None:
    """Phase 11: Path A end to end through its two CLIs. 16 train and 8 val
    256×256 frames rendered by ``data/synthetic.py`` and written as PNGs
    by ``data/png.py``; ``cli.train_path_a.main`` for 2 epochs
    (``smp_UNet++``, batches 8 / 4), then ``cli.eval_path_a.main`` on its
    ``best_f1`` checkpoint with ``--save_dir``. Checks: both exit 0; the
    log, the checkpoint, the curves and the triptychs exist and decode;
    the trainer's K6a / K6b launches are the code's (34 K6a + 17 K6b a
    step, 17 K6a a validation, heavy-metric and sample forward), the
    evaluator's one K7 a val batch; the evaluator's mean IoU equals the
    plain K7's on the recorded maps; its model gives the logits of the
    checkpoint loaded into a fresh bf16 model (phase 8's 2e-2). Prints the
    evaluation's images/s, host issue and device busy."""
    import tempfile

    from mmr_tpu_torch.cli import eval_path_a, train_path_a
    from mmr_tpu_torch.data import png
    from mmr_tpu_torch.data.png_dataset import PngFolderDataset
    from mmr_tpu_torch.data.synthetic import render_frame
    from mmr_tpu_torch.infer.evaluator import evaluate_checkpoint
    from mmr_tpu_torch.models import create_model

    rng = np.random.RandomState(seed + 6)
    with tempfile.TemporaryDirectory() as tmp:
        root, run, out = (f"{tmp}/{d}" for d in ("data", "run", "eval"))
        for split, n in (("train", CLI_TRAIN), ("val", CLI_VAL)):
            for i in range(n):
                img, mask = render_frame(rng, *PATH_A_HW, N_CLASSES - 1)
                png.write(f"{root}/{split}/images/f{i:03d}.png",
                          (img * 255.0 + 0.5).astype(np.uint8))
                png.write(f"{root}/{split}/groundtruth/f{i:03d}.png", mask)
        hw = ["--resizedHeight", str(PATH_A_HW[0]), "--resizedWidth", str(PATH_A_HW[1]),
              "--device", str(dev)]
        for kind in KERNELS:
            wrapper(kind).launches = 0
        t0 = time.perf_counter()
        rc = train_path_a.main([
            "--data_dir", root, "--model", "smp_UNet++", "--epochs", str(CLI_EPOCHS),
            "--trainBatchSize", str(CLI_BATCH), "--valBatchSize", str(CLI_VAL_BATCH),
            "--save_dir", run, "--seed", str(seed), *hw])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = {k: wrapper(k).launches for k in KERNELS}
        steps = CLI_EPOCHS * (CLI_TRAIN // CLI_BATCH)
        forwards = CLI_EPOCHS * (CLI_VAL // CLI_VAL_BATCH) + CLI_VAL // CLI_VAL_BATCH + 1
        print(f"[11] train_path_a: exit {rc} in {dt:.1f} s ({steps} steps, "
              f"{forwards} eval forwards); launches {launches}", flush=True)
        check(rc == 0, "train_path_a did not exit 0")
        check(launches == _counts(K6a=K6_PER_FORWARD * (2 * steps + forwards),
                                  K6b=K6_PER_FORWARD * steps),
              "train_path_a's launch counts are not the code's")
        log = open(f"{run}/train.log").read()
        check(f"epoch {CLI_EPOCHS}/{CLI_EPOCHS}" in log and "heavy metrics" in log,
              "train.log lacks the epochs' lines")
        for f in ("loss.png", "accuracy.png"):
            series = json.loads(png.read_text(f"{run}/{f}")["plot"])["series"]
            check(all(len(v) == CLI_EPOCHS and np.all(np.isfinite(v))
                      for v in series.values()), f"{f} does not hold the epochs")
        sample = png.read(f"{run}/epoch_{CLI_EPOCHS}_samples.png")
        state = torch.load(f"{run}/checkpoints/best_f1", map_location=dev,
                           weights_only=True)["model"]

        spied = {}

        def spy(model, *a, **kw):
            spied["model"] = model
            return evaluate_checkpoint(model, *a, **kw)

        eval_path_a.evaluate_checkpoint = spy
        try:
            with recording() as (records, recorders):
                t0 = time.perf_counter()
                rc = eval_path_a.main([
                    "--data_dir", root, "--split", "val", "--model", "smp_UNet++",
                    "--checkpoint_dir", f"{run}/checkpoints",
                    "--valBatchSize", str(CLI_VAL_BATCH), "--save_dir", out, *hw])
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
        finally:
            eval_path_a.evaluate_checkpoint = evaluate_checkpoint
        launches = {k: r.launches for k, r in recorders.items()}
        val_batches = CLI_VAL // CLI_VAL_BATCH
        print(f"[11] eval_path_a: exit {rc} in {dt:.1f} s; launches {launches}",
              flush=True)
        check(rc == 0, "eval_path_a did not exit 0")
        check(launches == _counts(K6a=K6_PER_FORWARD * (val_batches + 1), K7=val_batches),
              "eval_path_a's launch counts: not one K7 a val batch")
        hold_records(11, records)
        report = json.loads(open(f"{out}/eval_report.json").read())
        miou = plain_k7_miou(records)
        print(f"[11] eval_path_a mean IoU {report['mean_iou']:.6f} (plain K7: "
              f"{miou:.6f}), mean F1 {report['mean_f1']:.6f}, loss "
              f"{report['loss']:.5f}", flush=True)
        check(report["mean_iou"] == miou, "the CLI's mean IoU differs from the plain K7's")
        triptych = png.read(f"{out}/eval_samples.png")
        rows = min(4, CLI_VAL_BATCH)   # save_triptychs' max_samples, its gap 4
        check(sample.shape == triptych.shape == (
            rows * PATH_A_HW[0] + (rows - 1) * 4, 3 * PATH_A_HW[1] + 2 * 4, 3),
            "a triptych has another size")

        # the CLI's model against the checkpoint loaded into a fresh model
        batches = [next(PngFolderDataset(root, "val", PATH_A_HW, -1, N_CLASSES)
                        .epoch(CLI_VAL_BATCH, shuffle=False))]
        model = spied["model"]
        fresh = create_model("smp_UNet++", classes=N_CLASSES, device=dev)
        fresh.load_state_dict(state)
        fresh.eval()
        with torch.no_grad():
            x = torch.from_numpy(batches[0][0]).to(dev)
            a, b = model(x), fresh(x)
        check(bool(torch.isfinite(a).all()) and torch.allclose(a, b, atol=2e-2, rtol=2e-2),
              "the CLI's model differs from its checkpoint")
        print(f"[11] eval CLI's model vs its checkpoint in a fresh model: max |dlogit| "
              f"{(a - b).abs().max().item():.3e}", flush=True)

        def run_eval():
            with contextlib.redirect_stdout(io.StringIO()):
                evaluate_checkpoint(model, batches, N_CLASSES, device=dev)

        med = _timed_steps(11, run_eval, 5)
        print(f"[11] eval_path_a's evaluation of one {CLI_VAL_BATCH}x{PATH_A_HW[0]}x"
              f"{PATH_A_HW[1]} batch: median {med:.3f} ms "
              f"({CLI_VAL_BATCH * 1e3 / med:.2f} images/s)", flush=True)


# ------------------------------------------------------------- Path B's Trainer

TRAINER_TRAIN, TRAINER_VAL, TRAINER_POOL = 6, 2, 16   # batches an epoch, frames
TRAINER_EPOCHS, VIDEO_FRAMES = 2, 6
EVAL_COUNTS = {"K1": 21, "K2": 2}   # one eval forward (phase 3)


def trainer_counts(steps: int, forwards: int) -> dict:
    """Launches of ``steps`` flagship train steps and ``forwards`` eval
    forwards."""
    return {k: steps * TRAIN_COUNTS[k] + forwards * EVAL_COUNTS.get(k, 0)
            for k in KERNELS}


class PoolSampler:
    """JAX's ``PatchSampler`` interface (``epoch(epoch_seed)``, ``len()``)
    over a pool of uint8 frames and masks: each batch draws
    ``TRAIN_BATCH`` of them by the epoch's seed."""

    def __init__(self, images, masks, n):
        self.images, self.masks, self.n = images, masks, n

    def __len__(self):
        return self.n

    def epoch(self, epoch_seed):
        rng = np.random.RandomState(epoch_seed)
        for _ in range(self.n):
            idx = rng.randint(0, len(self.images), TRAIN_BATCH)
            yield self.images[idx], self.masks[idx]


def trainer_phase(dev, seed, smi) -> dict:
    """Phase 12: Path B's ``Trainer`` at full width —
    ``get_default_config(9, (512, 640))`` (UNet++ over mbv3, 10 classes,
    AdamW 1e-4, clip 12, PolynomialLR, bf16, the default augmentation
    through the uint8 path), 2 epochs of 6 train batches of 8 and 2 val
    batches drawn from 16 rendered frames, triptychs every epoch. Holds
    every launch of the first train step at phase 6's bounds and its
    counts (20 K1 + 20 K3, 2 K2 + 2 K4, K5a, K5b), the run's counts
    (train steps and eval forwards, 21 K1 + 2 K2 each), the falling train
    loss, every artifact (decoded), a resume to epoch 3 in a fresh
    ``Trainer``, and ``run_inference(save_plots=True)`` over one full-HD
    video of 6 frames (its ``test_plots_0/config.yaml`` read back). Prints
    the epochs' times and samples/s, the train step's median, host issue,
    device busy and idle share, and the augmentation alone (device and
    host-issue ms). Returns {kind: launches of the two-epoch run}."""
    import pickle
    import tempfile

    from mmr_tpu_torch.config import get_default_config, read_config
    from mmr_tpu_torch.data import png
    from mmr_tpu_torch.data.augment import (AugmentConfig, apply_augment_u8,
                                            augment_draws, augment_train_batch_u8)
    from mmr_tpu_torch.data.synthetic import render_frame
    from mmr_tpu_torch.infer.evaluator import run_inference
    from mmr_tpu_torch.train.engine import Trainer

    t_phase = time.perf_counter()
    rng = np.random.RandomState(seed + 12)
    frames = [render_frame(rng, *ROI, N_CLASSES - 1) for _ in range(TRAINER_POOL)]
    images = np.stack([(f[0] * 255.0 + 0.5).astype(np.uint8) for f in frames])
    masks = np.stack([f[1] for f in frames])
    train_s = PoolSampler(images, masks, TRAINER_TRAIN)
    val_s = PoolSampler(images, masks, TRAINER_VAL)
    print(f"[12] {smi}: rendered {TRAINER_POOL} frames {ROI} in "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        cfg = get_default_config(N_CLASSES - 1, ROI)
        cfg.update(results_path=tmp, patch_size=list(ROI), n_epochs=TRAINER_EPOCHS,
                   val_plot_interval=1, seed=seed)
        tr = Trainer(cfg, device=dev)
        check(tr.model.fused and tr.model.encoder.fused_frontend,
              "the Trainer did not turn the fused decoder and front end on")
        check(tr.augment == AugmentConfig(patch_size=ROI, low_resolution=False),
              "the Trainer's augmentation is not the default one")

        step, first = tr._train_step, {}

        def recorded_first(*a):
            if first:
                return step(*a)
            with recording() as (records, recorders):
                out = step(*a)
                torch.cuda.synchronize()
            first.update(records=records,
                         launches={k: r.launches for k, r in recorders.items()})
            return out

        tr._train_step = recorded_first
        for kind in KERNELS:
            wrapper(kind).launches = 0
        t0 = time.perf_counter()
        hist = tr.train(train_s, val_s)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = {k: wrapper(k).launches for k in KERNELS}
        tr._train_step = step
        steps, forwards = TRAINER_EPOCHS * TRAINER_TRAIN, TRAINER_EPOCHS * (TRAINER_VAL + 1)
        print(f"[12] {TRAINER_EPOCHS} epochs in {dt:.1f} s; first step's launches "
              f"{first['launches']}; the rest of the run's {launches}", flush=True)
        check(first["launches"] == TRAIN_COUNTS, f"expected {TRAIN_COUNTS} launches "
              "in the Trainer's first train step")
        check(launches == trainer_counts(steps - 1, forwards),
              "the run's launches are not its train steps' and eval forwards'")
        hold_records(12, first.pop("records"))
        for e in range(TRAINER_EPOCHS):
            print(f"[12] {smi}: epoch {hist['epoch'][e]}: {hist['epoch_time_s'][e]:.3f} s, "
                  f"{hist['samples_per_sec'][e]:.2f} samples/s, train loss "
                  f"{hist['train_loss'][e]:.5f}, val loss {hist['val_loss'][e]:.5f}, "
                  f"IoU train {hist['train_iou'][e]:.4f} val {hist['val_iou'][e]:.4f}, "
                  f"device memory {hist['device_mem_mb'][e]:.0f} MB", flush=True)
        check(all(np.isfinite(hist["train_loss"] + hist["val_loss"])), "non-finite loss")
        check(hist["train_loss"][-1] < hist["train_loss"][0],
              "the train loss did not fall over the two epochs")

        res = tr.results_path
        metrics = json.loads((res / "training_metrics.json").read_text())
        check(metrics["epoch"] == [1, 2], "training_metrics.json lacks the epochs")
        log = next(res.glob("training_log_*.log")).read_text()
        check("Training complete" in log and "New best model" in log
              and "Model Architecture Summary" in log, "the log lacks its lines")
        loss_dict = pickle.loads((res / "loss_dict.pkl").read_bytes())
        check(loss_dict["train"] == hist["train_loss"], "loss_dict.pkl differs")
        for f in ("plots/loss.png", "training_dashboard.png", "plots/epoch_1.png",
                  "plots/epoch_2.png"):
            check(png.read(res / f).ndim == 3, f"{f} does not decode")
        for name in ("last_model", "best_model"):
            ck = torch.load(res / "checkpoints" / name, map_location="cpu",
                            weights_only=True)
            meta = json.loads((res / "checkpoints" / f"{name}.json").read_text())
            check(set(ck) == {"model", "opt_state", "step"} and set(meta) == {
                "epoch", "validation_loss"}, f"checkpoint {name} is malformed")
        print(f"[12] artifacts written and decoded: {sorted(p.name for p in res.iterdir())}",
              flush=True)

        # ---- resume in a fresh Trainer -----------------------------------
        again = Trainer(dict(cfg, n_epochs=TRAINER_EPOCHS + 1), device=dev)
        for kind in KERNELS:
            wrapper(kind).launches = 0
        check(again.maybe_resume() and again.start_epoch == TRAINER_EPOCHS + 1,
              "the resume did not start at epoch 3")
        hist3 = again.train(train_s, val_s)
        torch.cuda.synchronize()
        resumed = {k: wrapper(k).launches for k in KERNELS}
        check(resumed == trainer_counts(TRAINER_TRAIN, TRAINER_VAL + 1),
              "the resumed epoch's launches are not the code's")
        loss3 = pickle.loads((res / "loss_dict.pkl").read_bytes())
        check(hist3["epoch"] == [3] and loss3["train"][:2] == loss_dict["train"]
              and len(loss3["train"]) == 3, "the resumed loss_dict lost epochs 1-2")
        print(f"[12] resumed at epoch {again.start_epoch}: {hist3['epoch_time_s'][0]:.3f} s, "
              f"train loss {hist3['train_loss'][0]:.5f}, val loss "
              f"{hist3['val_loss'][0]:.5f}; launches {resumed}", flush=True)

        # ---- run_inference(save_plots=True) on one full-HD video ---------
        vr = np.random.RandomState(seed + 13)
        fr = [render_frame(vr, *FRAME, N_CLASSES - 1) for _ in range(VIDEO_FRAMES)]
        video = [{"id": "video_000", "t0": 0, "t1": VIDEO_FRAMES,
                  "image": np.stack([(f[0] * 255.0 + 0.5).astype(np.uint8) for f in fr]),
                  "mask": np.stack([f[1] for f in fr])}]
        for kind in KERNELS:
            wrapper(kind).launches = 0
        with contextlib.redirect_stdout(io.StringIO()):
            report = run_inference(again.model, video, again.config,
                                   preprocess=again.preprocess, device=dev)
        torch.cuda.synchronize()
        served = {k: wrapper(k).launches for k in KERNELS}
        check(served == _counts(K1=21 * VIDEO_FRAMES, K2=2 * VIDEO_FRAMES),
              "run_inference's launches are not 21 K1 + 2 K2 a frame")
        out = res / "test_plots_0"
        check(read_config(out / "config.yaml") == again.config,
              "test_plots_0/config.yaml does not read back to the config")
        check(png.read(out / f"video_000_0-{VIDEO_FRAMES}.png").ndim == 3,
              "run_inference wrote no triptych")
        check(np.isfinite(report["overall_mean_iou"]), "non-finite IoU")
        print(f"[12] run_inference(save_plots=True): {VIDEO_FRAMES} full-HD frames, "
              f"{report['videos']['video_000']['fps']:.2f} fps, mean IoU "
              f"{report['overall_mean_iou']:.4f}; launches {served}; wrote "
              f"{sorted(p.name for p in out.iterdir())}", flush=True)

        # ---- times ------------------------------------------------------------
        img_d = torch.from_numpy(images[:TRAIN_BATCH]).to(dev)[None]
        msk_d = torch.from_numpy(masks[:TRAIN_BATCH]).to(dev)[None]
        gen = torch.Generator().manual_seed(seed)
        lr = again.lr_schedule(0)
        run = lambda: again._train_step(again.state, img_d, msk_d, lr, gen)
        med = _timed_steps(12, run, TRAIN_STEPS)
        print(f"[12] {smi}: Trainer train step (B={TRAIN_BATCH}, {ROI[0]}x{ROI[1]}, "
              f"default augmentation, uint8 path): median {med:.3f} ms "
              f"({TRAIN_BATCH * 1e3 / med:.2f} samples/s)", flush=True)
        pre = again.preprocess
        for name, acfg in (("defaults", again.augment),
                           ("every transform on", AugmentConfig(patch_size=ROI,
                                                                low_resolution=True))):
            g = torch.Generator().manual_seed(seed)
            fn = lambda: augment_train_batch_u8(g, img_d[0], msk_d[0], acfg,
                                                pre.mean, pre.std)
            busy, _ = device_profile(fn, REPS)
            print(f"[12] {smi}: augment_train_batch_u8, {name}, B={TRAIN_BATCH} "
                  f"{ROI[0]}x{ROI[1]} (draws as training makes them, {REPS} calls): "
                  f"device {busy:.3f} ms, host issue {host_issue_ms(fn, REPS):.3f} ms, "
                  f"wall {cuda_ms(fn, REPS):.3f} ms a call", flush=True)
        acfg = AugmentConfig(patch_size=ROI, low_resolution=True)
        d = next(d for s in range(100) for d in [augment_draws(
            acfg, torch.Generator().manual_seed(s), img_d[0].shape, dev)] if d.warp)
        fn = lambda: apply_augment_u8(img_d[0], msk_d[0], d, acfg, pre.mean, pre.std)
        busy, top = device_profile(fn, REPS)
        print(f"[12] {smi}: apply_augment_u8, every transform on, the warp branch, "
              f"fixed draws: device {busy:.3f} ms, host issue "
              f"{host_issue_ms(fn, REPS):.3f} ms a call", flush=True)
        for key, t, cnt in top:
            print(f"[12]     {t:8.3f} ms  x{cnt:5.1f}  {key}", flush=True)
        del tr, again, first
    torch.cuda.empty_cache()
    print(f"[12] {smi}: phase 12 wall time {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return launches


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
    for name, (entry, kinds, tiles) in _build.HOPPER_KERNELS.items():
        info = getattr(_build.library(), entry)
        for kind in kinds if isinstance(kinds, tuple) else (kinds,):
            mode = f" (mode {kind})" if isinstance(kinds, tuple) else ""
            print(f"[1] {name}{mode}: dynamic shared memory, blocks per SM: "
                  + ", ".join(f"N={n} {info(0, kind, n)} B, {info(1, kind, n)}"
                              for n in tiles), flush=True)

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
    k1_tile_ab(5, cases)
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
    for e, kind in zip(kernels, ("K1", "K2")):
        e["device_ms"] = device_split(5, cases, kind)
    # ---- 6. training -------------------------------------------------------
    train = train_phase(model, dev, rng)
    for kind, e in zip(("K1", "K2"), kernels):   # their train-step numbers beside
        e.update({f"train_{k}": train[kind][k] for k in
                  ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
                   "bound_by", "library_ms", "device_ms") if k in train[kind]})
    kernels += [train[k] for k in ("K3", "K4", "K5a", "K5b")]
    kernels.insert(-2, stem_dx_phase(model, dev))
    # ---- 7. Path-A training, 8. Path-A evaluation ------------------------
    path_a, entries = path_a_train_phase(dev, args.seed)
    evals = path_a_eval_phase(path_a, dev, args.seed)
    k7_hold_phase(dev, args.seed)
    entries["K6a"].update({f"eval_{k}": evals["K6a"][k] for k in
                           ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
                            "bound_by", "library_ms", "per", "device_ms")})
    kernels += [entries["K6a"], entries["K6b"], evals["K7"]]
    # ---- 9. the rest of the Path-A zoo, 10. K8 ------------------------------
    zoo = zoo_phase(dev, args.seed)
    for kind, key in (("K6a", "K6a"), ("K6b", "K6b"), ("K7", "eval_K7")):
        e = kernels[[k["name"] for k in kernels].index(KERNELS[kind][1])]
        e["zoo_launches"] = {m: c[key] for m, c in zoo.items()}
    entries["K6a"]["zoo_eval_launches"] = {m: c["eval_K6a"] for m, c in zoo.items()}
    k8 = k8_phase(dev, args.seed)
    kernels += [k8["K8a"], k8["K8b"]]
    # ---- 11. Path A through its CLIs ----------------------------------------
    path_a_cli_phase(dev, args.seed)
    # ---- 12. Path B's Trainer ------------------------------------------------
    trained = trainer_phase(dev, args.seed, smi)
    for e in kernels:
        kind = next((k for k in FLAGSHIP if KERNELS[k][1] == e["name"]), None)
        if kind is not None:
            e["trainer_launches"] = trained[kind]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": 1}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
