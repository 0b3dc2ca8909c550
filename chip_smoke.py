#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``mmr_tpu_torch``) on one NVIDIA card.

Two paths of the UNet++/MobileNetV3 flagship, two of Path A's
UNet++/ResNet-18, the rest of the Path-A zoo, the standalone
shifted-GEMM conv, Path B's ``Trainer``, and the reference's best
published models (Unet/ConvNeXt-V2, Segformer/MiT). The flagship at full width (10 classes,
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
   The step runs with ``thread_dx`` (the default): K3 launches take the
   ``thru`` addends of the surfaces the decoder threads, held with the
   rest; the same step with ``thread_dx=False`` on the same weights and
   batch (launch counts equal, loss rtol 1e-3, clipped-gradient cosine ≥
   0.999), and each step's surface-sized cotangent sums (autograd's add
   ops on 4-D tensors, ``torch.profiler``): fewer with threading by the
   inputs the decoder threaded; the two steps, and the two models'
   forward alone and forward + backward, timed in 16 pairs whose first
   call alternates (host issue and wall: median, min, max; the per-pair
   differences; the medians by position in the pair), and the host's
   self time by op in forward + backward, threaded against unthreaded
   (``torch.profiler``; the ops that differ most).
   6e. K4's dense dx (not on the flagship's path, whose stem reads the
   image): the train-mode stem on a B=8 512×640 image that requires a
   gradient, its K4 launch (dW and dx) held at the backward bound, timed
   beside its bound, plain version and ``convolution_backward`` with the
   input mask on, split by device kernel; its own entry in the kernels line.

7. Path-A training: Path A's canonical configuration (smp UNet++ over
   ResNet-18, 10 classes, full width, random weights from ``--seed``, BN
   perturbed) through ``make_train_step`` at 256×256, B=8, Adam lr 1e-3
   with coupled L2 1e-5, the blended CE + Dice loss (0.5), StepLR epoch 0
   and the Path-A augmentation. One recorded step under the committed
   dispatch table (``ops/conv_table.json``): the K6 launches it asks
   (``k6_expected``: each Conv3x3's forward and backward at their own
   keys); then, from the same weights and a fresh optimizer, one recorded
   step with every bf16 Conv3x3 on K6 (``conv3x3_packed._FORCE``): 23 K6a
   forward + 23 dx (``conv3x3``) and 23 K6b (``conv3x3_dw``) launches; every
   launch of both held against its plain version (forward atol = rtol =
   2e-2, dx and dW at ``GRAD_REL``); both steps vs the plain f32 step on
   the same weights, batch and augmentation draws (loss rtol 2e-2); four
   more steps (the loss falls); step median, host issue, device busy, top
   device events, under the table and under ``_FORCE``. The kernels line's
   K6a / K6b numbers are those of the first run under the table that
   launches them (this step's, else phase 13's), the ``_FORCE`` step's
   beside them as ``forced_*``.
8. Path-A evaluation: ``evaluate_checkpoint`` of that model over three
   synthetic 4×256×256 batches (uint8 masks): every K7 launch
   (``confusion_stats``, adding into ``Evaluate``'s running total) equals
   its plain version exactly, every K6a launch (the table's, per forward)
   within 2e-2; the returned mean IoU equals the one from the plain K7 on
   the same id maps. 8b. K7 alone at a full-HD uint8 / int64 pair, int32
   maps, 128 classes with ids outside [0, nc) and views one byte into
   their storage: exact, f32 stats and running totals, bit-equal on a
   second launch.

9. The rest of the Path-A zoo at full width, 10 classes, random weights
   from ``--seed``, BN perturbed: ``smp_unet18``, ``smp_DeepLabV3+``,
   ``smp_MANet``, ``unet``, ``segnet``, ``resnet18`` (ResNet-UNet), each
   trained as in phase 7 (256×256, B=8, Adam, blended loss, augmentation,
   bf16; dropout drawn from the step's generator). One recorded step: every
   K6a / K6b launch held as in phase 7, the counts the table's (a dx
   for each but UNet's first conv, which reads the image); three steps (the
   loss falls); step median, host
   issue, device busy and idle share; then one ``evaluate_checkpoint``
   batch of 4×256×256 with its K6a and K7 launches held, and its time.
10. K8 (``ops/conv3x3.py::conv3x3_bias_act`` under ``_FORCE = True``) at
    the shape its TPU docstring measures, 16 → 16 channels on (32, 512,
    512) bf16: forward, dx and dW (2 K8a + 1 K8b launches) held against
    the plain versions (forward 2e-2, dx and dW at ``GRAD_REL``) and timed
    beside their bound, plain and library calls; then an f32-storage case
    and one with H not a multiple of 16, held and timed; each K8a launch
    (forward, dx) split by device kernel with its persistent grid.
11. Path A through its two CLIs: 13 train and 8 val 256×256 synthetic
    frames written as PNGs by ``data/png.py`` and, in the train split, the
    committed 16-bit, Adam7-interlaced and grey + alpha PNG frames of
    ``tests/torch_fixtures/png`` (each first read in both modes to cv2's
    recorded pixels); ``cli.train_path_a.main`` for 2 epochs
    (``smp_UNet++``, batches 8 / 4), ``cli.eval_path_a.main`` on its
    ``best_f1`` checkpoint: exit codes, the log, checkpoint, curves and
    triptychs, launch counts (the trainer's K6a / K6b, the table's; one K7
    a val batch), the mean IoU against the plain K7's, the evaluator's model
    against its checkpoint; the evaluation's images/s, host issue and
    device busy.
12. Path B's ``Trainer`` at the default config (``trainer_phase``): two
    epochs, checkpoints, a resume, ``run_inference(save_plots=True)``.
13. The reference's best published models (``published_phase``): the smp
    Unet over ``tu-convnextv2_tiny`` with the fused decoder (31,976,426
    parameters; K1 ×8 + K3 ×8, K5a + K5b a train step, K1 ×9 a forward)
    and Segformer over ``mit_b2`` (24,745,162; its 3×3 head at 128×160
    where the table sends it: the forward to cuDNN, dx and dW to K6a / K6b),
    at B=8 512×640 and on 6 full-HD frames: eval logits of the
    kernel path vs the plain bf16 path, one recorded train step held
    launch by launch, the loss over five steps, step and serving times,
    each launch timed and split; ``tu-convnext_tiny`` (UNet++) and
    ``mit_b0`` (Segformer) at B=2 256×256; a weight store loaded through
    ``create_model(encoder_weights="imagenet")`` bit-equal;
    ``mmr_torch_export_weights --state_dict`` on a seeded torchvision
    ResNet-18 ``.pth``: a store ``verify_store`` accepts.
14. Path B end to end from Zarr stores on disk (``zarr_phase``): a
    synthetic dataset of 3 videos × 8 full-HD frames (9 tool classes,
    512×640 chunks, uint8) and one float32 store of 8 frames written by
    ``make_synthetic_dataset``; the ``PatchSampler`` alone at B=8 512×640
    for both dtypes (batches/s, decoded MB/s, against phase 12's step
    rate); ``mmr_torch_train_model`` in process for 2 epochs of 6 + 2
    batches, then ``-c`` for a third (launch counts the code's, files,
    finite losses, the resume at epoch 3); ``mmr_torch_infer`` on the
    saved test split (21 K1 + 2 K2 a frame; frames/s and the share of the
    time spent reading frames); ``mmr_torch_visualize --legend
    --architecture`` on one frame (a triptych, ``class_legend.png`` with
    its 10 bars and ``architecture_diagram.png`` with its 6 boxes and 5
    arrows, all decoded by the PNG reader; the layer summary printed).
15. Data parallelism over two ranks under torchrun (``mesh_phase``): NCCL
    with a card a rank where two cards are visible, else gloo with both
    ranks on the one card. (a) The flagship's fused train step on phase
    6's weights and batch split 4 + 4: each rank's 46 launches recorded
    and held at phase 6's bounds; against one rank on all 8: loss rtol
    2e-2, the clipped gradient's cosine ≥ 0.99 and norm within 2 %, BN
    running statistics atol 1e-3 / rtol 1e-2; the plain f32 step: loss
    rtol 1e-5, gradient relative L2 < 1e-2; each rank's step median, host
    issue, device busy, collectives a step and their time. (b) 12 full-HD
    frames through ``make_sliding_window_fn(mesh=)``, 6 a rank (21 K1 + 2
    K2 a frame), gathered, against one rank serving all 12 (phase 3's
    bounds); frames/s of both. (c) ``train_path_a`` under torchrun for one
    epoch on phase 11's PNG frames: exit 0, each file and log line once,
    each rank's K6a / K6b launches the code's. (d) ``Evaluate(mesh=)``: 6
    batches of 4×256×256 uint8 id maps, 3 a rank on K7; the counts summed
    over the ranks equal one rank's over all 6 exactly, and so does the
    mean IoU. The ranks are this script
    run by torchrun with ``--mesh-rank`` / ``--cli-rank``; their lines of
    the phase are printed.
16. Path B's data entry (``native_data_phase``): the host decoders built
    by ``cc``; the committed 1080×1920 Motion-JPEG fixture decoded to the
    recorded sha256 (ms a frame); the committed JAX-written blosc-zstd
    stores read through ``VideoStore`` and ``PatchSampler`` to JAX's
    recorded sha256, and MB/s of their chunks decoded beside gzip copies
    (64×80 chunks and full-size 512×640 ones);
    ``mmr_torch_create_dataset`` on a ZIP of two video ZIPs (the fixture
    and PNG masks) at the flagship's defaults, one ``mmr_torch_train_model``
    epoch on those stores (launches the code's) and ``mmr_torch_infer``.
17. The fused b1 pair (``b1_phase``): the mbv3 encoder with
    ``fused_frontend=True, fused_b1=True`` at B=8 512×640 against the plain
    encoder on the same weights, eval and train: every launch held (b1_0's
    depthwise on K2 / K4 at C = 72, b1_1's on the depthwise mode of K1 /
    K3 at C = 88), the launch counts the code's, f3 and b1's BN statistics
    within ``test_packed_chain.py``'s bounds; the four new launches timed
    and split; the b1 pair fused vs plain (median, host issue, busy).
18. K6's per-shape dispatch table (``k6_table_phase``): the committed
    ``ops/conv_table.json`` holds both directions of every bf16 Conv3x3
    shape phases 2–17 run and of JAX's ``bench_conv_kernel.py`` shapes; a
    line a key with its route and the table's alternated-pair medians,
    gain and spread, and K6a's forward and dx and K6b under ``_FORCE`` at
    that key (B=2) held against their plain versions at phase 7's bounds.

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
import threading
import time
from pathlib import Path

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


def device_profile(fn, reps: int, skip: str | None = None):
    """Device-busy ms per call — the sum of the device events (kernels,
    copies) ``torch.profiler`` records over ``reps`` calls, but those whose
    name holds ``skip`` (lower case) — and the top device events as (name,
    ms per call, count per call). Busy is 0 when the profiler records no
    device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
           and not (skip and skip in e.key.lower())]
    ms = lambda e: e.self_device_time_total / 1e3 / reps
    top = sorted(dev, key=ms, reverse=True)[:8]
    return sum(ms(e) for e in dev), [(e.key[:70], ms(e), e.count / reps) for e in top]


def perturb(model, gen: torch.Generator):
    """Conv gain 1.1 and BN scale/shift/running stats away from identity,
    so the logits are O(1) and a BN-fold error would show; LayerNorm
    scale/shift away from identity and GRN's gamma/beta away from 0 (the
    MiT / ConvNeXt trunks), so a LayerNorm or GRN error would show too."""
    from mmr_tpu_torch.models.encoders.convnext import GRN
    from mmr_tpu_torch.models.layers import FusedBatchNorm, LayerNorm

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
            elif isinstance(m, LayerNorm):
                c = m.weight.numel()
                m.weight.copy_(0.9 + 0.4 * torch.rand(c, generator=gen))
                m.bias.copy_(0.1 * torch.randn(c, generator=gen))
            elif isinstance(m, GRN):
                c = m.gamma.numel()
                m.gamma.copy_(0.1 * torch.randn(c, generator=gen))
                m.beta.copy_(0.1 * torch.randn(c, generator=gen))


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
BINDERS = {"K1": ("mmr_tpu_torch.models.fused_blocks",
                  "mmr_tpu_torch.models.fused_encoder"),
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
        groups = x.shape[1] if args.get("depthwise") else 1
        if kind == "K1":
            b = _bf16(args["bias"])
            return lambda: F.conv2d(x, w, b, padding=1, groups=groups)
        dy = args["dy"].permute(0, 3, 1, 2)
        # with addends, the sums that K3's `thru` saves (as autograd does
        # them: two surfaces read, one written) after the library's backward
        adds = [a for a in (args.get("daccs") or []) if a is not None]
        return lambda: (conv_bwd(dy, x, w, None, [1, 1], [1, 1], [1, 1], False,
                                 [0, 0], groups, [True, True, False]),
                        [a + a for a in adds])
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
        cin = 1 if args.get("depthwise") else sum(p.c for p in ins)
        macs = math.prod(grid) * 9 * cin * cout
        read = (sum(pending(p) for p in ins) + 2 * 9 * cin * cout
                + sum(nb(a) for a in (args.get("daccs") or [])))
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
    "K1": {"pending_conv_kernel": "conv", "down_dw_fwd_kernel": "depthwise",
           "down_rows_reduce_kernel": "reduce"},
    "K2": {"down_stem_kernel": "dense", "down_dw_fwd_kernel": "depthwise",
           "down_rows_reduce_kernel": "reduce"},
    "K3": {"dy_prep_kernel": "dy prep", "conv_dw_wg_kernel": "dW",
           "conv_wg_kernel": "dx", "conv_up2_dx_kernel": "dx x2",
           "down_dw_bwd_kernel": "depthwise", "down_rows_reduce_kernel": "reduce"},
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


PROFILES = 6   # profiles taken at most for one launch's device split


def _profiled_parts(fn, args, names, part_of, reps):
    """({part: ms a call}, {part: events counted}) of ``reps`` calls of
    ``fn(**args)`` under ``torch.profiler``, a warm-up call inside it
    first. The profiler has been seen to lose some calls' events (0.2 to
    0.8 of them a call, or all of them) and, without a synchronize at each
    step, to count the warm-up's: the profile is taken again, up to six
    times, until it has events and every part counts a whole number of
    them a call, and a part's time is its mean event time times its events
    a call, rounded. ({}, {}) when no profile had an event."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    for _ in range(PROFILES):
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
    if kind in ("K1", "K3") and args.get("depthwise"):   # the stride-1 tile
        return down_grid(args["inputs"][0], args["weights"][0], True,
                         kind == "K3", True, stride=1)
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
        dev = f"not measured (no profiler event in {PROFILES} profiles)"
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
    for c in (c for c in cases if c["kind"] == "K1"
              and not c["args"].get("depthwise")):
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
def conv3x3_forced(on: bool):
    """Every bf16 ``Conv3x3`` on K6a / K6b in both directions (``on``) or on
    the library conv (not ``on``: the plain-bf16 yardstick of phases 5 and
    6, as measured before K6 existed), whatever the table says
    (``conv3x3_packed._FORCE``)."""
    from mmr_tpu_torch.ops import conv3x3_packed

    old, conv3x3_packed._FORCE = conv3x3_packed._FORCE, on
    try:
        yield
    finally:
        conv3x3_packed._FORCE = old


def conv3x3_shapes(model, hw) -> list[tuple]:
    """(h, w, cin, cout, needs_dx) of every bf16 ``Conv3x3`` that a forward
    of ``model`` on (B, *hw, 3) inputs runs, in order: one batch-1 forward
    on the model's own device in eval mode with grad on (the shapes of a
    train step's forward), every Conv3x3 on the library conv; the model's
    mode and every wrapper's launch count are restored."""
    from mmr_tpu_torch.models.layers import Conv3x3

    seen = []

    def hook(mod, args):
        x = args[0]
        if x.dtype == torch.bfloat16:
            seen.append((x.shape[2], x.shape[3], mod.in_channels,
                         mod.out_channels, x.requires_grad))
    hooks = [m.register_forward_pre_hook(hook) for m in model.modules()
             if isinstance(m, Conv3x3)]
    counts = {k: wrapper(k).launches for k in KERNELS}
    training = model.training
    try:
        model.eval()
        with conv3x3_forced(False), torch.enable_grad():
            model(torch.zeros(1, *hw, 3, device=next(model.parameters()).device))
    finally:
        for h in hooks:
            h.remove()
        model.train(training)
        for k, n in counts.items():
            wrapper(k).launches = n
    return seen


def k6_expected(model, hw) -> dict:
    """The K6 launches the committed dispatch table asks of ``model`` at
    ``hw``: ``fwd`` K6a launches a forward, ``dx`` K6a and ``dw`` K6b
    launches a train step's backward (each Conv3x3's forward asked at (h,
    w, cin, cout), its backward at (h, w, cout, cin); a dx only where its
    input needs a gradient)."""
    from mmr_tpu_torch.ops.conv3x3_packed import use_kernel

    n = {"fwd": 0, "dx": 0, "dw": 0}
    for h, w, cin, cout, needs_dx in conv3x3_shapes(model, hw):
        bwd = use_kernel(torch.bfloat16, h, w, cout, cin)
        n["fwd"] += use_kernel(torch.bfloat16, h, w, cin, cout)
        n["dw"] += bwd
        n["dx"] += bwd and needs_dx
    return n


def k6_step(n: dict, steps: int = 1, forwards: int = 0) -> dict:
    """Launches of ``steps`` train steps and ``forwards`` eval forwards of a
    model whose ``k6_expected`` is ``n``."""
    return {"K6a": steps * (n["fwd"] + n["dx"]) + forwards * n["fwd"],
            "K6b": steps * n["dw"]}


def flagship_counts(model) -> None:
    """Fold the K6 launches the table asks of the flagship (``model``, at
    ``ROI``) into ``TRAIN_COUNTS`` and ``EVAL_COUNTS``: its coarse decoder
    nodes, below ``packed_min_hw``, are plain Conv3x3s."""
    n = k6_expected(model, ROI)
    TRAIN_COUNTS.update(k6_step(n))
    EVAL_COUNTS.update(k6_step(n, 0, 1))


def forward_counts(frames: int) -> dict:
    """Launches of ``frames`` flagship eval forwards."""
    return {k: frames * EVAL_COUNTS.get(k, 0) for k in KERNELS}


def k6_models() -> list[tuple]:
    """(phases, ``create_model`` arguments, input H×W) of every model whose
    bf16 Conv3x3s the phases run."""
    return ([("7, 8, 11, 15", {"arch": "smp_UNet++"}, PATH_A_HW)]
            + [("9", {"arch": zoo}, PATH_A_HW) for zoo in ZOO]
            + [("2-6, 12, 14-16", {"fused": True, "fused_frontend": True}, ROI),
               ("13", {"arch": PUB_UNET[0], "encoder_name": PUB_UNET[1],
                       "fused": True}, ROI),
               ("13", {"arch": PUB_SEG[0], "encoder_name": PUB_SEG[1]}, ROI)]
            + [("13", {"arch": a, "encoder_name": e}, PUB_SMALL_HW)
               for a, e in PUB_SMALL])


def k6_table_keys(dev) -> dict:
    """{(h, w, cin, cout): where} of both directions of every bf16
    Conv3x3 shape the phases run (``k6_models``, built on ``dev``) and of
    every shape of JAX's ``bench_conv_kernel.py`` (``dispatch.BENCH_SHAPES``)."""
    from mmr_tpu_torch.models import create_model
    from mmr_tpu_torch.ops.dispatch import BENCH_SHAPES

    keys = {}

    def add(shape, where):
        h, w, cin, cout = shape
        for key in ((h, w, cin, cout), (h, w, cout, cin)):
            keys.setdefault(key, [])
            if where not in keys[key]:
                keys[key].append(where)
    for hw, cin, cout in BENCH_SHAPES:
        add((hw, hw, cin, cout), "bench_conv_kernel.py")
    for phases, kw, hw in k6_models():
        model = create_model(classes=N_CLASSES, device=dev, **kw)
        for shape in conv3x3_shapes(model, hw):
            add(shape[:4], f"phase {phases}")
        del model
    return keys


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
    with torch.no_grad(), conv3x3_forced(False):
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
    grad1 = _clipped_grad(state).clone()
    thru = thru_phase(sd0, trainer, pre, images, masks, lr, records, launches,
                      loss1, grad1)

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
    out["K3"].update(thru)
    # the K3 launches that took addends, split again with them and without
    # (the same launches' other inputs): what the in-kernel adds cost
    added = [c for c in cases if c["kind"] == "K3"
             and any(d is not None for d in c["args"].get("daccs") or [])]
    bare = [{"kind": "K3", "label": c["label"] + " no add",
             "args": {**c["args"], "daccs": None}} for c in added]
    split = {k: sum(device_split("6 thru", group, "K3").values())
             for k, group in (("with addends", added), ("without", bare))}
    print(f"[6] thru: the {len(added)} K3 launches with addends, device ms with "
          f"them {split['with addends']:.4f}, without {split['without']:.4f}",
          flush=True)
    out["K3"]["thru_device_ms"] = split
    out["inputs"] = (sd0, images, masks, lr)   # phase 15's weights and batch
    return out


def cotangent_sums(run) -> int:
    """The surface-sized cotangent sums autograd makes in one call of
    ``run``: the ``aten::add`` / ``aten::add_`` ops on 4-D tensors that the
    autograd engine issues to add a gradient into another
    (``torch.profiler``, record_shapes; each is one elementwise kernel on
    the card), wherever the backward runs."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        run()
        torch.cuda.synchronize()
    engine = "autograd::engine::evaluate_function"
    return sum(1 for e in prof.events()
               if e.name in ("aten::add", "aten::add_") and e.input_shapes
               and len(e.input_shapes[0]) == 4 and e.cpu_parent is not None
               and e.cpu_parent.name.startswith(engine))


def thru_phase(sd0, trainer, pre, images, masks, lr, records, launches,
               loss1, grad1) -> dict:
    """Phase 6's ``thru`` part. The recorded step (``thread_dx``, the
    default) against the same step with ``thread_dx=False`` on the same
    weights and batch: launch counts of both, loss rtol 1e-3, clipped
    gradient cosine ≥ 0.999; the surface-sized cotangent sums of each step
    (:func:`cotangent_sums`), fewer with threading by the inputs the
    decoder threaded. The two steps, then the two models' forward alone
    and forward + backward, timed in alternated pairs
    (:func:`alternated_times`). Returns the K3 entry's ``thru`` keys."""
    from mmr_tpu_torch.models import create_model

    dev = grad1.device
    k3 = [a for k, a, *_ in records if k == "K3"]
    addends = sum(d is not None for a in k3 for d in (a.get("daccs") or []))
    with_add = sum(any(d is not None for d in (a.get("daccs") or [])) for a in k3)
    models = {}
    for thread in (True, False):
        m = create_model(classes=N_CLASSES, device=dev, fused=True,
                         fused_frontend=True, thread_dx=thread)
        m.load_state_dict(sd0)
        models[thread] = m
    st, step = trainer(models[False])
    _zero_launches()
    st, met = step(st, images, masks, lr)
    torch.cuda.synchronize()
    off_launches = {k: v for k, v in _launches().items() if v}
    loss0, grad0 = float(met["loss"]), _clipped_grad(st)
    cos = (grad1.double() @ grad0.double()
           / (grad1.double().norm() * grad0.double().norm())).item()
    runs, sums = {}, {}
    images_d, masks_d = images.to(dev), masks.to(dev)
    for thread, m in models.items():
        st, step = trainer(m)
        runs[thread] = functools.partial(step, st, images_d, masks_d, lr)
        sums[thread] = cotangent_sums(runs[thread])
    threaded = models[True].threaded_inputs
    times = alternated_times("6 thru: step", runs)
    img = pre(images_d[0].float() / 255.0)
    split = {}
    for part in ("forward", "backward"):
        split[part] = alternated_times(
            f"6 thru: {part} alone", {t: functools.partial(
                fwd_bwd, m, img, masks_d[0], part) for t, m in models.items()},
            device=False)
    host_ops("6 thru: forward + backward", {t: functools.partial(
        fwd_bwd, m, img, masks_d[0], "backward") for t, m in models.items()})
    print(f"[6] thru: {with_add} of {len(k3)} K3 launches took {addends} "
          f"addends (threaded inputs the decoder counts: {threaded}), each held "
          f"against its plain version above; launches threaded "
          f"{ {k: v for k, v in launches.items() if v} }, unthreaded "
          f"{off_launches}", flush=True)
    print(f"[6] thru: loss threaded {loss1:.6f}, unthreaded {loss0:.6f}; clipped "
          f"gradient cosine {cos:.6f}; surface-sized cotangent sums a step: "
          f"threaded {sums[True]}, unthreaded {sums[False]} (fewer by "
          f"{sums[False] - sums[True]})", flush=True)
    check(threaded == addends and models[False].threaded_inputs == 0,
          "the decoder's threaded inputs differ from the K3 addends")
    check(off_launches == {k: v for k, v in launches.items() if v},
          "threading changed the launch counts")
    check(abs(loss1 - loss0) <= 1e-3 * abs(loss0) and cos >= 0.999,
          "the threaded step disagrees with the unthreaded one")
    check(sums[False] - sums[True] == threaded,
          "threading did not remove one cotangent sum per threaded input")
    return {"thru_addends": addends, "thru_launches": with_add,
            "cotangent_sums": {"threaded": sums[True], "unthreaded": sums[False]},
            "step_ms": {("threaded" if t else "unthreaded"): v
                        for t, v in times.items()},
            "host_issue_ms": {part: {("threaded" if t else "unthreaded"): v["issue"]
                                     for t, v in d.items()}
                              for part, d in split.items()}}


THRU_PAIRS = 16   # alternated threaded / unthreaded pairs a comparison


def _spread(v: list) -> dict:
    v = sorted(v)
    return {"median": v[len(v) // 2], "min": v[0], "max": v[-1]}


def alternated_times(tag: str, runs: dict, pairs: int = THRU_PAIRS,
                     device: bool = True) -> dict:
    """Two versions of one call (``runs``: {True: threaded, False:
    unthreaded}) timed in ``pairs`` pairs after one warm call each; the
    version that runs first swaps from pair to pair, so an order effect
    falls on both. Per version the median, min and max of its host issue
    time (call to return, the device drained before) and wall time (to the
    device drained after) and, with ``device``, its device busy
    (:func:`device_profile`, 3 runs); printed with the per-pair differences
    (threaded − unthreaded) and the medians by position in the pair."""
    wall = {t: [] for t in runs}
    issue = {t: [] for t in runs}
    pos = {0: [], 1: []}
    for fn in runs.values():
        fn()
    for i in range(pairs):
        for j, t in enumerate((True, False) if i % 2 == 0 else (False, True)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            runs[t]()
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            issue[t].append((t1 - t0) * 1e3)
            wall[t].append((t2 - t0) * 1e3)
            pos[j].append((t2 - t0) * 1e3)
    out = {}
    for t in runs:
        name = "threaded" if t else "unthreaded"
        out[t] = {"wall": _spread(wall[t]), "issue": _spread(issue[t])}
        busy = device_profile(runs[t], 3)[0] if device else None
        out[t]["busy"] = busy
        w, h = out[t]["wall"], out[t]["issue"]
        print(f"[{tag}] {name}: wall median {w['median']:.3f} ms (min "
              f"{w['min']:.3f}, max {w['max']:.3f}), host issue median "
              f"{h['median']:.3f} (min {h['min']:.3f}, max {h['max']:.3f})"
              + (f", device busy {busy:.3f}" if device else ""), flush=True)
    for what, v in (("wall", wall), ("host issue", issue)):
        d = _spread([a - b for a, b in zip(v[True], v[False])])
        print(f"[{tag}] threaded - unthreaded {what}, {pairs} pairs: median "
              f"{d['median']:+.3f} ms (min {d['min']:+.3f}, max "
              f"{d['max']:+.3f})", flush=True)
    print(f"[{tag}] wall median by position in the pair: first "
          f"{_spread(pos[0])['median']:.3f} ms, second "
          f"{_spread(pos[1])['median']:.3f}", flush=True)
    return out


def host_ops(tag: str, runs: dict, reps: int = 3, top: int = 12):
    """Where the host's time differs between two versions of one call
    (``runs``: {True: threaded, False: unthreaded}): each profiled over
    ``reps`` calls (``torch.profiler``, CPU and CUDA activity: the aten ops
    on every thread, the autograd engine's included, and the CUDA runtime
    calls), the ops' self host time a call; prints the ``top`` ops by the
    size of their difference, with their calls a call."""
    from torch.profiler import ProfilerActivity, profile

    ops = {}
    for t in (True, False, False, True):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                runs[t]()
            torch.cuda.synchronize()
        for e in prof.key_averages():
            ms, n = ops.setdefault(t, {}).get(e.key, (0.0, 0))
            ops[t][e.key] = (ms + e.self_cpu_time_total / 1e3 / (2 * reps),
                             n + e.count / (2 * reps))
    tot = {t: sum(ms for ms, _ in v.values()) for t, v in ops.items()}
    print(f"[{tag}] host self time a call, profiled (2 x {reps} calls each, "
          f"order T F F T): threaded {tot[True]:.3f} ms, unthreaded "
          f"{tot[False]:.3f}; the ops that differ most (threaded / unthreaded "
          "ms, calls):", flush=True)
    keys = set(ops[True]) | set(ops[False])
    diff = lambda k: ops[True].get(k, (0, 0))[0] - ops[False].get(k, (0, 0))[0]
    for k in sorted(keys, key=lambda k: -abs(diff(k)))[:top]:
        (a, na), (b, nb) = ops[True].get(k, (0, 0)), ops[False].get(k, (0, 0))
        print(f"[{tag}]   {diff(k):+8.3f} ms  {a:8.3f} / {b:8.3f}  "
              f"x{na:.0f} / x{nb:.0f}  {k}", flush=True)


def fwd_bwd(model, img, msk, part: str):
    """The fused model's train-mode forward with the fused head + loss
    (:func:`assemble_dice_ce` of its statistics) and, for ``part ==
    "backward"``, the loss's backward too, the gradients then dropped."""
    from mmr_tpu_torch.ops.head_loss import assemble_dice_ce

    model.train()
    res = model(img, labels=msk, with_conf=False)
    loss, _ = assemble_dice_ce(res["stats"], res["conf"], res["n_pixels"])
    if part == "backward":
        loss.backward()
        model.zero_grad(set_to_none=True)


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
    """Phase 7; returns (the trained model, {K6a, K6b: kernel entry}: the
    step under the table's numbers where it launched the kernel, the
    ``_FORCE`` step's as ``forced_*``; the K6 launches the table asks of a
    forward and a step)."""
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
    shapes = conv3x3_shapes(model, PATH_A_HW)
    n = k6_expected(model, PATH_A_HW)
    forced = {"fwd": len(shapes), "dx": sum(s[4] for s in shapes), "dw": len(shapes)}

    def trainer(m):
        opt = build_optimizer("adam", weight_decay=PATH_A_WD)
        return TrainState.create(m, opt), make_train_step(
            m, opt, loss_fn, N_CLASSES, augment=augment_path_a_batch, device=dev)

    def recorded_step(tag, want):
        nonlocal state
        with recording() as (records, recorders):
            state, met = step(state, images, masks, lr, draws())
            torch.cuda.synchronize()
        launches = {k: r.launches for k, r in recorders.items()}
        n_dx = sum(1 for k, *_, bwd in records if k == "K6a" and bwd)
        print(f"[7] {tag}: K6a {launches['K6a'] - n_dx} forward + {n_dx} dx "
              f"launches, K6b {launches['K6b']} dW launches", flush=True)
        check(launches == _counts(**k6_step(want)) and n_dx == want["dx"],
              f"{tag}: launch counts are not the table's ({want})")
        return float(met["loss"]), float(met["iou"]), launches, hold_records(7, records)

    # ---- 7a. one recorded step under the table; one with K6 forced, from the
    # same weights with a fresh optimizer ---------------------------------------
    print(f"[7] smp_UNet++ / resnet18: {n_params} parameters; {len(shapes)} bf16 "
          f"Conv3x3s; the table sends {n['fwd']} forwards and {n['dw']} "
          f"backwards to K6", flush=True)
    state, step = trainer(model)
    loss1, iou1, table_launches, table_cases = recorded_step(
        "train step under the table", n)
    model.load_state_dict(sd0)
    state, step = trainer(model)
    with conv3x3_forced(True):
        floss, fiou, launches, cases = recorded_step("train step under _FORCE", forced)

    # ---- 7b. both steps vs the plain f32 step (same weights, batch, draws) ---
    plain = create_model("smp_UNet++", classes=N_CLASSES, device=dev,
                         dtype=torch.float32)
    plain.load_state_dict(sd0)
    pstate, pstep = trainer(plain)
    pstate, pmet = pstep(pstate, images, masks, lr, draws())
    ploss = float(pmet["loss"])
    print(f"[7] step 1 loss: bf16 under the table {loss1:.5f} (IoU {iou1:.4f}), "
          f"under _FORCE {floss:.5f} (IoU {fiou:.4f}), plain f32 {ploss:.5f} "
          f"(IoU {float(pmet['iou']):.4f})", flush=True)
    for tag, loss in (("under the table", loss1), ("under _FORCE", floss)):
        check(abs(loss - ploss) <= 2e-2 * abs(ploss),
              f"Path-A loss {tag} disagrees with plain f32")
    del plain, pstate, pstep

    # ---- 7c. four more steps: the loss falls ----------------------------------
    images_d, masks_d = images.to(dev), masks.to(dev)
    g = draws()
    losses = [floss]
    for _ in range(4):
        state, met = step(state, images_d, masks_d, lr, g)
        losses.append(float(met["loss"]))
    print(f"[7] losses over 5 steps: {[round(v, 5) for v in losses]}", flush=True)
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          "the loss did not fall over five steps")

    # ---- 7d. times: the step under the table and under _FORCE -------------------
    for tag, ctx in (("the table", contextlib.nullcontext()),
                     ("_FORCE", conv3x3_forced(True))):
        print(f"[7] Path-A train step (B={PATH_A_BATCH}, {PATH_A_HW[0]}x"
              f"{PATH_A_HW[1]}, bf16, augmentation on) under {tag}:", flush=True)
        with ctx:
            med = _timed_steps(7, lambda: step(state, images_d, masks_d, lr, g),
                               TRAIN_STEPS)
        print(f"[7] under {tag}: {PATH_A_BATCH * 1e3 / med:.2f} images/s", flush=True)
    time_cases(7, cases + table_cases)
    run = f"one Path-A train step (B={PATH_A_BATCH}, {PATH_A_HW[0]}x{PATH_A_HW[1]})"
    forced_e = k6_entries(7, cases, launches, f"sum over the launches of {run} "
                          "with every Conv3x3 on K6 (conv3x3_packed._FORCE = "
                          "True): forward and dx for K6a")
    table_e = k6_entries(7, table_cases, table_launches,
                         f"sum over the launches of {run} under the table")
    out = {}
    for k in ("K6a", "K6b"):
        out[k] = {f: forced_e[k][f] for f in ("name", "route", "source", "replaces")}
        out[k].update(table_e.get(k, {}))
        out[k].update({f"forced_{f}": forced_e[k][f] for f in K6_FIELDS})
    return model, out, n


K6_FIELDS = ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms", "per", "device_ms")


def k6_entries(phase, cases, launches, per) -> dict:
    """{kind: kernel entry with its ``device_ms``} of K6a and K6b over one
    recorded run's timed ``cases``, for each of the two that it ran."""
    return {k: {**kernel_entry(k, cases, launches[k], per),
                "device_ms": device_split(phase, cases, k)}
            for k in ("K6a", "K6b") if any(c["kind"] == k for c in cases)}


def k6_main_path(entries, published) -> None:
    """Fill the kernels line's K6a / K6b numbers (``K6_FIELDS``) from the
    first run under the dispatch table that launched each: phase 7's
    ``smp_UNet++`` step (already in ``entries``), else phase 13's published
    models' steps. Where the table sent no conv of those runs to the
    kernel, its launches are 0 and its times those of phase 7's ``_FORCE``
    step, as ``per`` says."""
    for k, e in entries.items():
        if "launches" in e:
            continue
        pub = next((p[k] for p in published.values() if k in p), None)
        if pub is not None:
            e.update({f: pub[f] for f in K6_FIELDS})
        else:
            e.update({f: e[f"forced_{f}"] for f in K6_FIELDS})
            e["launches"] = 0
            e["per"] = ("no run under the table launched it; times of "
                        + e["forced_per"])
        print(f"[13] {k} in the kernels line: {e['launches']} launches, "
              f"{e['ms']:.4f} ms ({e['per']})", flush=True)


def path_a_eval_phase(model, dev, seed, n) -> dict:
    """Phase 8 (``n``: the K6 launches the table asks of a forward);
    returns {K7, and K6a where the table sends forwards to it: kernel
    entry}."""
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
    check(launches == _counts(K6a=n["fwd"] * EVAL_BATCHES, K7=EVAL_BATCHES),
          "launch counts are not the table's")
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
    first = cases[:n["fwd"]] + [c for c in cases if c["kind"] == "K7"][:1]
    time_cases(8, first)
    per = (f"sum over the launches of one eval batch ({EVAL_BATCH}x{PATH_A_HW[0]}x"
           f"{PATH_A_HW[1]}); launches over {EVAL_BATCHES} batches")
    kinds = ("K6a", "K7") if n["fwd"] else ("K7",)
    out = {k: kernel_entry(k, first, launches[k], per) for k in kinds}
    for k in kinds:
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

# the rest of the Path-A zoo; each one's K6 launches come from the table
# (``k6_expected``: UNet's inc.conv1 reads the image and needs no dx)
ZOO = ("smp_unet18", "smp_DeepLabV3+", "smp_MANet", "unet", "segnet", "resnet18")
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
    for i, zoo in enumerate(ZOO):
        gen = torch.Generator().manual_seed(seed + 10 + i)
        model = create_model(zoo, classes=N_CLASSES, device=dev, generator=gen)
        perturb(model, gen)
        n = k6_expected(model, PATH_A_HW)
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
        check(launches == _counts(**k6_step(n)) and n_dx == n["dx"],
              f"{zoo}: launch counts {launches} are not the table's ({n})")
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
        check(eval_launches == _counts(K6a=n["fwd"], K7=1),
              f"{zoo}: eval launch counts {eval_launches} are not the table's")
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


PNG_FIXTURES = Path(__file__).resolve().parent / "tests" / "torch_fixtures" / "png"


def write_path_a_pngs(root, seed) -> list[str]:
    """Phase 11's PNG folder under ``root``: ``CLI_TRAIN`` train and
    ``CLI_VAL`` val frames, 256×256, rendered by ``data/synthetic.py`` and
    written by ``data/png.py``, the train split's last ones the committed
    fixtures of ``tests/torch_fixtures/png`` (a 16-bit, an Adam7-interlaced
    and a grey + alpha image with 16-bit, interlaced and 4-bit masks; 64×64,
    resized by the dataset). Each fixture is first read in both modes and
    held against the sha256 of cv2's decode in ``records.json``. Returns the
    fixtures' names."""
    import hashlib
    import shutil

    from mmr_tpu_torch.data import png
    from mmr_tpu_torch.data.synthetic import render_frame

    records = json.loads((PNG_FIXTURES / "records.json").read_text())
    for name, rec in records.items():
        for mode, want in rec.items():
            a = png.read(PNG_FIXTURES / name, unchanged=mode == "unchanged")
            check(hashlib.sha256(a.tobytes()).hexdigest() == want["sha256"],
                  f"{name} ({mode}) does not decode to cv2's pixels")
    fixtures = sorted(p.name for p in (PNG_FIXTURES / "images").glob("*.png"))
    rng = np.random.RandomState(seed + 6)
    for split, n in (("train", CLI_TRAIN - len(fixtures)), ("val", CLI_VAL)):
        for i in range(n):
            img, mask = render_frame(rng, *PATH_A_HW, N_CLASSES - 1)
            png.write(f"{root}/{split}/images/f{i:03d}.png",
                      (img * 255.0 + 0.5).astype(np.uint8))
            png.write(f"{root}/{split}/groundtruth/f{i:03d}.png", mask)
    for part in ("images", "groundtruth"):
        for name in fixtures:
            shutil.copy(PNG_FIXTURES / part / name, f"{root}/train/{part}/{name}")
    return fixtures


def path_a_cli_phase(dev, seed, n) -> None:
    """Phase 11: Path A end to end through its two CLIs on
    ``write_path_a_pngs``' folder (16 train frames, 3 of them the PNG
    fixtures, and 8 val); ``cli.train_path_a.main`` for 2 epochs
    (``smp_UNet++``, batches 8 / 4: every train frame is read each epoch),
    then ``cli.eval_path_a.main`` on its ``best_f1`` checkpoint with
    ``--save_dir``. Checks: both exit 0; the log, the checkpoint, the
    curves and the triptychs exist and decode; the trainer's K6a / K6b
    launches are the table's (``n``: a step's and a forward's, for every
    step and every validation, heavy-metric and sample forward), the
    evaluator's one K7 a val batch; the evaluator's mean IoU equals the
    plain K7's on the recorded maps; its model gives the logits of the
    checkpoint loaded into a fresh bf16 model (phase 8's 2e-2). Prints the
    evaluation's images/s, host issue and device busy."""
    import tempfile

    from mmr_tpu_torch.cli import eval_path_a, train_path_a
    from mmr_tpu_torch.data import png
    from mmr_tpu_torch.data.png_dataset import PngFolderDataset
    from mmr_tpu_torch.infer.evaluator import evaluate_checkpoint
    from mmr_tpu_torch.models import create_model

    with tempfile.TemporaryDirectory() as tmp:
        root, run, out = (f"{tmp}/{d}" for d in ("data", "run", "eval"))
        fixtures = write_path_a_pngs(root, seed)
        print(f"[11] PNG fixtures {fixtures} decode to cv2's pixels in both modes; "
              f"{CLI_TRAIN} train frames with them, {CLI_VAL} val", flush=True)
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
        check(launches == _counts(**k6_step(n, steps, forwards)),
              "train_path_a's launch counts are not the table's")
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
        check(launches == _counts(K6a=n["fwd"] * (val_batches + 1), K7=val_batches),
              "eval_path_a's launch counts: not the table's K6a and one K7 a val batch")
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
    host-issue ms). Returns {"launches": {kind: launches of the two-epoch
    run}, "history": the monitor's history, "step_ms": the step's median}."""
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
        check(served == forward_counts(VIDEO_FRAMES),
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
    return {"launches": launches, "history": hist, "step_ms": med}


# ------------------------------------------- the reference's best models

PUB_UNET = ("Unet", "tu-convnextv2_tiny")   # PKG-INFO Example 3, 83.55 % mIoU
PUB_SEG = ("Segformer", "mit_b2")           # PKG-INFO Example 2, 82.38 % mIoU
PUB_PARAMS = {PUB_UNET: 31_976_426, PUB_SEG: 24_745_162}
# launches other than K6's (the table decides those: ``k6_expected``)
PUB_TRAIN = {PUB_UNET: _counts(K1=8, K3=8, K5a=1, K5b=1),   # blocks 1-4, head
             PUB_SEG: _counts()}
PUB_EVAL = {PUB_UNET: _counts(K1=9), PUB_SEG: _counts()}   # a forward
PUB_SMALL = (("UnetPlusPlus", "tu-convnext_tiny"), ("Segformer", "mit_b0"))
PUB_SMALL_HW, PUB_SMALL_BATCH = (256, 256), 2


def _launches() -> dict:
    return {k: wrapper(k).launches for k in KERNELS}


def _zero_launches():
    for kind in KERNELS:
        wrapper(kind).launches = 0


def _logits_agree(phase, name, got, want, smi) -> None:
    """Eval logits of the kernel path vs the plain bf16 path: atol 0.25 /
    rtol 0.05, argmax agreement ≥ 0.99 (``TestPackedUnetPP``'s bounds)."""
    agree = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
    dl = (got - want).abs().max().item()
    within = bool(torch.allclose(got, want, atol=0.25, rtol=0.05))
    print(f"[{phase}] {smi}: {name}: argmax agreement {agree:.5f}, max |dlogit| "
          f"{dl:.4f} (max |logit| {want.abs().max().item():.3f}), within atol "
          f".25/rtol .05: {within}", flush=True)
    check(agree >= 0.99 and within and bool(torch.isfinite(got).all()),
          f"{name}: the kernel path disagrees with the plain bf16 path")


def _flat_tree(tree, prefix=""):
    """{path: leaf} of a nested dict."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_tree(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def torchvision_resnet18(seed: int) -> dict:
    """A ResNet-18 ``state_dict`` in torchvision's names (``layer1.0.conv1``,
    ``layer2.0.downsample.0``), normal values from ``seed``: the port's
    encoder's names mapped back."""
    import re

    from mmr_tpu_torch.models.encoders import get_encoder

    with torch.device("meta"):
        names = get_encoder("resnet18").build().state_dict()
    g = torch.Generator().manual_seed(seed)
    return {re.sub(r"^layer(\d)_(\d+)\.", r"layer\1.\2.", k)
            .replace("downsample_conv.", "downsample.0.")
            .replace("downsample_bn.", "downsample.1."): torch.randn(v.shape, generator=g)
            for k, v in names.items()}


def published_phase(dev, seed, smi) -> dict:
    """Phase 13: the reference's best published models at full width, 10
    classes, bf16, random weights from the seed (BN, LayerNorm and GRN
    perturbed): the smp Unet over ``tu-convnextv2_tiny`` with the fused
    decoder (blocks 1-4 on K1, K3 backward; the head + loss on K5a / K5b;
    block 0 at 32x40 on cuDNN) and Segformer over ``mit_b2`` (the 3x3 head
    at 128x160 on K6a, K6a dx and K6b backward). For each: eval logits of
    the kernel path vs the plain bf16 path (the Unet unfused, Segformer's
    head on the library conv) at the TestPackedUnetPP bounds and the
    launches of an eval forward; one recorded ``make_train_step`` step at
    B=8 512x640 (AdamW, DiceCE) with every launch held against its plain
    version at phase 6's bounds and the counts the code's; five steps on
    one batch (the loss falls); 10 timed steps (median, host issue, device
    busy, idle share); ``run_inference`` on 6 full-HD frames (frames/s and
    the counts); each launch timed beside its bound, plain version and
    library call, and split by device kernel. Then ``tu-convnext_tiny``
    (UNet++) and ``mit_b0`` (Segformer) at B=2 256x256, one eval forward
    each, and the weight store: a random ``tu-convnextv2_tiny`` encoder tree
    saved by ``save_weight_store`` under a temporary
    ``$MMR_TPU_WEIGHTS_DIR`` and loaded by ``create_model(encoder_weights=
    "imagenet")`` on the card, bit-equal. Returns {model: {kind: kernel
    entry}}."""
    import os
    import tempfile

    from mmr_tpu_torch.cli import export_weights
    from mmr_tpu_torch.data.synthetic import render_frame
    from mmr_tpu_torch.infer.evaluator import run_inference
    from mmr_tpu_torch.losses import dice_ce_loss
    from mmr_tpu_torch.models import create_model, get_preprocessing
    from mmr_tpu_torch.models.convert import jax_leaf, to_jax_variables
    from mmr_tpu_torch.models.pretrained import save_weight_store
    from mmr_tpu_torch.models.weight_manifest import verify_store
    from mmr_tpu_torch.train.optim import build_optimizer
    from mmr_tpu_torch.train.schedules import build_lr_schedule
    from mmr_tpu_torch.train.state import TrainState
    from mmr_tpu_torch.train.steps import make_train_step

    t_phase = time.perf_counter()
    rng = np.random.RandomState(seed + 13)
    frames = [render_frame(rng, *ROI, N_CLASSES - 1) for _ in range(TRAIN_BATCH)]
    images = torch.from_numpy(np.stack(
        [(f[0] * 255.0 + 0.5).astype(np.uint8) for f in frames]))[None]
    masks = torch.from_numpy(np.stack([f[1] for f in frames]).astype(np.int64))[None]
    fr = [render_frame(rng, *FRAME, N_CLASSES - 1) for _ in range(VIDEO_FRAMES)]
    video = [{"id": "video_000", "t0": 0, "t1": VIDEO_FRAMES,
              "image": np.stack([(f[0] * 255.0 + 0.5).astype(np.uint8) for f in fr]),
              "mask": np.stack([f[1] for f in fr])}]
    print(f"[13] rendered {TRAIN_BATCH} frames {ROI} and {VIDEO_FRAMES} full-HD "
          f"frames in {time.perf_counter() - t_phase:.1f} s", flush=True)
    lr = build_lr_schedule({"name": "PolynomialLR", "total_iters": N_EPOCHS,
                            "power": 0.9}, LR, N_EPOCHS)(0)
    images_d, masks_d = images.to(dev), masks.to(dev)
    out = {}
    for key in (PUB_UNET, PUB_SEG):
        arch, enc = key
        name = f"{arch}/{enc}"
        fused = {"fused": True} if arch == "Unet" else {}
        gen = torch.Generator().manual_seed(seed + 13)
        model = create_model(arch, encoder_name=enc, classes=N_CLASSES, device=dev,
                             generator=gen, **fused)
        perturb(model, gen)
        n_params = sum(p.numel() for p in model.parameters())
        check(n_params == PUB_PARAMS[key], f"{name}: {n_params} parameters")
        n = k6_expected(model, ROI)
        want_train = {**PUB_TRAIN[key], **k6_step(n)}
        want_eval = {**PUB_EVAL[key], **k6_step(n, 0, 1)}
        pre = get_preprocessing(enc)
        x = pre(images_d[0].float() / 255.0)

        # ---- 13a. eval: the kernel path vs the plain bf16 path ---------------
        plain = create_model(arch, encoder_name=enc, classes=N_CLASSES, device=dev)
        plain.load_state_dict(model.state_dict())
        with torch.inference_mode():
            _zero_launches()
            got = model(x)
            torch.cuda.synchronize()
            launches = _launches()
            with conv3x3_forced(False):
                want = plain(x)
        del plain
        print(f"[13] {name}: {n_params} parameters; launches of an eval forward "
              f"(B={TRAIN_BATCH}): {launches}", flush=True)
        check(launches == want_eval, f"{name}: expected {want_eval} launches")
        _logits_agree(13, f"{name} eval, kernels vs plain bf16", got, want, smi)
        del got, want

        # ---- 13b. one recorded train step ------------------------------------
        opt = build_optimizer("adamw", clip_grad_norm=CLIP, weight_decay=1e-2)
        state = TrainState.create(model, opt)
        step = make_train_step(model, opt, dice_ce_loss, N_CLASSES, preprocess=pre,
                               device=dev)
        with recording() as (records, recorders):
            state, met = step(state, images, masks, lr)
            torch.cuda.synchronize()
        launches = {k: r.launches for k, r in recorders.items()}
        print(f"[13] {name}: launches in one train step: {launches}", flush=True)
        check(launches == want_train, f"{name}: expected {want_train} "
              "launches in a train step")
        n_dx = sum(1 for k, *_, bwd in records if k == "K6a" and bwd)
        check(n_dx == n["dx"], f"{name}: {n_dx} K6a dx launches, expected {n['dx']}")
        cases = hold_records(13, records)
        del records

        # ---- 13c. five steps on one batch: the loss falls ----------------------
        losses = [float(met["loss"])]
        for _ in range(4):
            state, met = step(state, images_d, masks_d, lr)
            losses.append(float(met["loss"]))
        print(f"[13] {name}: losses over 5 steps: {[round(v, 5) for v in losses]}",
              flush=True)
        check(all(np.isfinite(losses)) and losses[-1] < losses[0],
              f"{name}: the loss did not fall over five steps")

        # ---- 13d. times ------------------------------------------------------
        print(f"[13] {smi}: {name} train step (B={TRAIN_BATCH}, {ROI[0]}x{ROI[1]}, "
              "AdamW, DiceCE, bf16):", flush=True)
        med = _timed_steps(13, lambda: step(state, images_d, masks_d, lr), TRAIN_STEPS)
        print(f"[13] {smi}: {name} {TRAIN_BATCH * 1e3 / med:.2f} frames/s "
              "trained", flush=True)
        _zero_launches()
        with contextlib.redirect_stdout(io.StringIO()):
            report = run_inference(model, video, {"n_classes": N_CLASSES - 1,
                                                  "patch_size": ROI,
                                                  "sw_overlap": 0.5},
                                   preprocess=pre, save_plots=False, device=dev)
        torch.cuda.synchronize()
        served = _launches()
        want = {k: VIDEO_FRAMES * c for k, c in want_eval.items()}
        check(served == want, f"{name}: run_inference's launches are not "
              f"{want_eval} a frame")
        check(np.isfinite(report["overall_mean_iou"]), f"{name}: non-finite IoU")
        print(f"[13] {smi}: {name} run_inference on {VIDEO_FRAMES} full-HD frames "
              f"(roi {ROI[0]}x{ROI[1]}, overlap 0.5, Gaussian, 20 windows a frame): "
              f"{report['videos']['video_000']['fps']:.2f} frames/s, mean IoU "
              f"{report['overall_mean_iou']:.4f}; launches {served}", flush=True)
        time_cases(13, cases)
        per = (f"sum over the launches of one {name} train step (B={TRAIN_BATCH}, "
               f"{ROI[0]}x{ROI[1]})")
        kinds = [k for k, c in want_train.items() if c]
        out[name] = {k: kernel_entry(k, cases, launches[k], per) for k in kinds}
        for k in kinds:
            out[name][k]["device_ms"] = device_split(13, cases, k)
            out[name][k]["serve_launches"] = served[k]
        del model, state, step, opt, cases
        torch.cuda.empty_cache()

    # ---- 13e. the small builds ------------------------------------------------
    for arch, enc in PUB_SMALL:
        gen = torch.Generator().manual_seed(seed + 14)
        model = create_model(arch, encoder_name=enc, classes=N_CLASSES, device=dev,
                             generator=gen)
        perturb(model, gen)
        x = torch.rand((PUB_SMALL_BATCH, *PUB_SMALL_HW, 3), device=dev, generator=
                       torch.Generator(device=dev).manual_seed(seed))
        with torch.inference_mode():
            y = model(get_preprocessing(enc)(x))
        torch.cuda.synchronize()
        check(tuple(y.shape) == (PUB_SMALL_BATCH, *PUB_SMALL_HW, N_CLASSES)
              and bool(torch.isfinite(y).all()), f"{arch}/{enc}: bad output")
        print(f"[13] {arch}/{enc}: {sum(p.numel() for p in model.parameters())} "
              f"parameters, one eval forward at B={PUB_SMALL_BATCH} "
              f"{PUB_SMALL_HW[0]}x{PUB_SMALL_HW[1]}: {tuple(y.shape)}, finite", flush=True)
        del model

    # ---- 13f. the weight store ---------------------------------------------
    arch, enc = PUB_UNET
    old = os.environ.get("MMR_TPU_WEIGHTS_DIR")
    with tempfile.TemporaryDirectory() as tmp:
        os.environ["MMR_TPU_WEIGHTS_DIR"] = tmp
        try:
            with torch.device("meta"):
                meta = create_model(arch, encoder_name=enc, classes=N_CLASSES,
                                    device="meta", fused=True)
            fill, params = np.random.RandomState(seed + 15), {}
            for k, v in meta.encoder.state_dict().items():
                _, node_path, leaf, a = jax_leaf(k, np.broadcast_to(np.float32(0), v.shape))
                node = params
                for q in node_path:
                    node = node.setdefault(q, {})
                node[leaf] = fill.uniform(0.01, 0.2, a.shape).astype(np.float32)
            path = save_weight_store(enc, params, {})
            model = create_model(arch, encoder_name=enc, classes=N_CLASSES, device=dev,
                                 fused=True, encoder_weights="imagenet")
            back = _flat_tree(to_jax_variables(model.encoder.state_dict())["params"])
            want = _flat_tree(params)
            check(back.keys() == want.keys() and all(
                np.array_equal(back[k], want[k]) for k in want),
                "the encoder loaded from the weight store is not bit-equal to it")
            print(f"[13] weight store {os.path.basename(path)} ({len(want)} leaves) "
                  f"loaded by create_model(encoder_weights='imagenet') on the card: "
                  "bit-equal", flush=True)
            del model, meta
            # ---- 13g. mmr_torch_export_weights on a seeded torchvision .pth ------
            pth = os.path.join(tmp, "resnet18.pth")
            torch.save(torchvision_resnet18(seed + 16), pth)
            printed = io.StringIO()
            with contextlib.redirect_stdout(printed):
                rc = export_weights.main(["--encoder", "resnet18", "--state_dict", pth])
            line = json.loads(printed.getvalue().strip().splitlines()[-1])
            check(rc == 0 and verify_store("resnet18", line["store"]) == {
                "sha256": line["sha256"], "n_leaves": line["n_leaves"]},
                "mmr_torch_export_weights wrote a store verify_store refuses")
            print(f"[13] mmr_torch_export_weights --encoder resnet18 --state_dict "
                  f"<seeded torchvision .pth>: exit {rc}, {line['n_leaves']} leaves, "
                  "accepted by verify_store against weights_manifest.json", flush=True)
        finally:
            if old is None:
                os.environ.pop("MMR_TPU_WEIGHTS_DIR", None)
            else:
                os.environ["MMR_TPU_WEIGHTS_DIR"] = old
    torch.cuda.empty_cache()
    print(f"[13] {smi}: phase 13 wall time {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return out


# ------------------------------------------- Path B from Zarr stores, CLIs

ZARR_VIDEOS, ZARR_FRAMES = 3, 8      # uint8 videos x full-HD frames; + 1 f32 store
ZARR_SAMPLER_BATCHES = 24            # batches timed per dtype
ZARR_TRAIN, ZARR_VAL, ZARR_EPOCHS = 6, 2, 2


def sampler_decoded_bytes(sampler, epoch_seed) -> int:
    """The bytes of chunks that ``sampler.epoch(epoch_seed)`` decodes: the
    same epoch drawn again (the draws depend on the seed alone), each
    read's chunks counted and read by a second, untimed pass."""
    from mmr_tpu_torch.data import zarr_io

    decoded, lock = [0], threading.Lock()
    read_chunk = zarr_io.ZarrArray._read_chunk

    def counting(self, idx):
        chunk = read_chunk(self, idx)
        if chunk is not None:
            with lock:
                decoded[0] += chunk.nbytes
        return chunk

    zarr_io.ZarrArray._read_chunk = counting
    try:
        for _ in sampler.epoch(epoch_seed=epoch_seed):
            pass
    finally:
        zarr_io.ZarrArray._read_chunk = read_chunk
    return decoded[0]


def zarr_phase(dev, seed, smi, trained) -> dict:
    """Phase 14: Path B end to end from Zarr stores on disk through the
    port's CLIs, the flagship at its defaults (UNet++ over mbv3, 10
    classes, 512×640, B=8). ``make_synthetic_dataset`` writes
    ``ZARR_VIDEOS`` × ``ZARR_FRAMES`` full-HD frames (9 tool classes, 512×640
    chunks, uint8) and one float32 store of ``ZARR_FRAMES`` frames (the
    reference's schema); its split file is removed, so the CLI makes it.
    Times the ``PatchSampler`` alone at B=8 512×640 for both dtypes
    (batches/s, samples/s; MB/s of chunks decoded, the bytes counted in a
    second, untimed pass) beside phase 12's step (``trained``). Runs
    ``cli.train_model.main`` for ``ZARR_EPOCHS`` epochs of ``ZARR_TRAIN``
    + ``ZARR_VAL`` batches, then ``-c`` for one more
    (``n_epochs`` raised in its ``config.yaml``), ``cli.infer.main`` on the
    saved test split (one video, ``infer_batch_size`` 6) and
    ``cli.visualize.main`` on one frame. Checks exit codes, files, finite
    losses, the launch counts (``trainer_counts`` of the steps and eval
    forwards; 21 K1 + 2 K2 a served frame and a visualized forward), the
    resume at epoch 3, the report and the triptych. Returns {kind:
    launches of the two-epoch CLI run}."""
    import pickle
    import tempfile

    from mmr_tpu_torch.cli import infer, train_model, visualize
    from mmr_tpu_torch.config import create_config, read_config
    from mmr_tpu_torch.data import png, video_dataset, zarr_io
    from mmr_tpu_torch.data.augment import AugmentConfig
    from mmr_tpu_torch.data.patch_dataset import PatchSampler
    from mmr_tpu_torch.data.synthetic import make_synthetic_dataset
    from mmr_tpu_torch.infer.sliding_window import _window_starts

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        # ---- the dataset -----------------------------------------------------
        t0 = time.perf_counter()
        ds = make_synthetic_dataset(f"{tmp}/ds", ZARR_VIDEOS, ZARR_FRAMES, *FRAME,
                                    N_CLASSES - 1, ROI, seed + 14, np.uint8)
        (ds / "train_val_test_split.json").unlink()
        t_u8 = time.perf_counter() - t0
        t0 = time.perf_counter()
        f32 = make_synthetic_dataset(f"{tmp}/f32", 1, ZARR_FRAMES, *FRAME,
                                     N_CLASSES - 1, ROI, seed + 15, np.float32)
        t_f32 = time.perf_counter() - t0
        for name, root, dt in (("uint8", ds, t_u8), ("float32", f32, t_f32)):
            stores = [zarr_io.VideoStore(p) for p in zarr_io.list_dataset_stores(root)]
            on_disk = sum(f.stat().st_size for f in root.rglob("*") if f.is_file())
            arrays = sum(np.prod(s.shape) * (3 * s.image_dtype.itemsize + 1) for s in stores)
            print(f"[14] wrote {len(stores)} {name} store(s) of {ZARR_FRAMES} {FRAME[0]}x"
                  f"{FRAME[1]} frames in {dt:.1f} s: {on_disk / 1e6:.1f} MB on disk for "
                  f"{arrays / 1e6:.1f} MB of arrays (gzip level {zarr_io.GZIP_LEVEL})",
                  flush=True)

        # ---- the sampler alone -------------------------------------------------
        initial = AugmentConfig(patch_size=ROI, low_resolution=False).initial_patch_size
        step_rate = TRAIN_BATCH * 1e3 / trained["step_ms"]
        rates = {}
        for name, root in (("uint8", ds), ("float32", f32)):
            sampler = PatchSampler(zarr_io.list_dataset_stores(root), ROI, TRAIN_BATCH,
                                   ZARR_SAMPLER_BATCHES, initial_patch_size=initial,
                                   seed=seed)
            n, t0 = 0, time.perf_counter()
            for imgs, masks in sampler.epoch(epoch_seed=seed):
                n += 1
            dt = time.perf_counter() - t0
            check(n == ZARR_SAMPLER_BATCHES and imgs.shape == (TRAIN_BATCH, *initial, 3)
                  and imgs.dtype == np.dtype(name), f"the {name} sampler's batches")
            rates[name] = n * TRAIN_BATCH / dt
            decoded = sampler_decoded_bytes(sampler, seed)
            print(f"[14] {smi}: PatchSampler ({name}, B={TRAIN_BATCH}, {initial[0]}x"
                  f"{initial[1]}): {n / dt:.2f} batches/s, {rates[name]:.1f} samples/s, "
                  f"{decoded / 1e6 / dt:.1f} MB/s of chunks decoded "
                  f"({decoded / 1e6 / n:.1f} MB a batch); phase 12's step in this call "
                  f"takes {step_rate:.1f} samples/s", flush=True)

        # ---- mmr_torch_train_model ----------------------------------------------
        run = f"{tmp}/run"
        argv = [str(ds), run, "train-val-test", str(N_CLASSES - 1), f"[{ROI[0]},{ROI[1]}]",
                "--device", str(dev)]
        _zero_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            rc = train_model.main(argv + [
                "--n_epochs", str(ZARR_EPOCHS), "--steps_per_epoch", str(ZARR_TRAIN),
                "--val_steps_per_epoch", str(ZARR_VAL), "--seed", str(seed)])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = _launches()
        config = read_config(f"{run}/config.yaml")
        forwards = ZARR_EPOCHS * ZARR_VAL + sum(
            e % config["val_plot_interval"] == 0 for e in range(1, ZARR_EPOCHS + 1))
        print(f"[14] mmr_torch_train_model: exit {rc} in {dt:.1f} s; launches {launches}",
              flush=True)
        check(rc == 0, "mmr_torch_train_model did not exit 0")
        check(launches == trainer_counts(ZARR_EPOCHS * ZARR_TRAIN, forwards),
              "the train CLI's launches are not its steps' and eval forwards'")
        res = Path(run)
        for f in (res / "config.yaml", res / "checkpoints" / "last_model",
                  res / "checkpoints" / "best_model", ds / "train_val_test_split.json"):
            check(f.is_file(), f"{f.name} was not written")
        split = json.loads((ds / "train_val_test_split.json").read_text())
        hist = json.loads((res / "training_metrics.json").read_text())
        check(hist["epoch"] == list(range(1, ZARR_EPOCHS + 1))
              and np.all(np.isfinite(hist["train_loss"] + hist["val_loss"])),
              "the train CLI's losses are missing or not finite")
        pool = trained["history"]
        for e in range(ZARR_EPOCHS):
            print(f"[14] {smi}: epoch {e + 1} from Zarr: {hist['epoch_time_s'][e]:.3f} s, "
                  f"{hist['samples_per_sec'][e]:.2f} samples/s, train loss "
                  f"{hist['train_loss'][e]:.5f}, val loss {hist['val_loss'][e]:.5f} "
                  f"(phase 12's fixed pool: {pool['epoch_time_s'][e]:.3f} s, "
                  f"{pool['samples_per_sec'][e]:.2f} samples/s)", flush=True)

        # ---- -c for a third epoch ------------------------------------------------
        create_config(dict(config, n_epochs=ZARR_EPOCHS + 1), run)
        _zero_launches()
        with contextlib.redirect_stdout(io.StringIO()):
            rc = train_model.main(argv + ["-c"])
        torch.cuda.synchronize()
        resumed = _launches()
        losses = pickle.loads((res / "loss_dict.pkl").read_bytes())
        last = json.loads((res / "checkpoints" / "last_model.json").read_text())
        logs = "".join(f.read_text() for f in res.glob("training_log_*.log"))
        print(f"[14] mmr_torch_train_model -c: exit {rc}; last_model at epoch "
              f"{last['epoch']}, {len(losses['train'])} train losses; launches {resumed}",
              flush=True)
        check(rc == 0 and last["epoch"] == ZARR_EPOCHS + 1
              and f"Resumed from epoch {ZARR_EPOCHS}" in logs
              and len(losses["train"]) == ZARR_EPOCHS + 1
              and losses["train"][:ZARR_EPOCHS] == hist["train_loss"],
              "the resume did not continue at epoch 3")
        check(resumed == trainer_counts(ZARR_TRAIN, ZARR_VAL + (
            (ZARR_EPOCHS + 1) % config["val_plot_interval"] == 0)),
              "the resumed epoch's launches are not the code's")

        # ---- mmr_torch_infer --------------------------------------------------------
        reads = []
        get_item = video_dataset.VideoFrameDataset.__getitem__

        def timed_get(self, i):
            t = time.perf_counter()
            item = get_item(self, i)
            reads.append(time.perf_counter() - t)
            return item

        _zero_launches()
        video_dataset.VideoFrameDataset.__getitem__ = timed_get
        try:
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                rc = infer.main([str(ds), run, "--infer_batch_size", "6",
                                 "--device", str(dev)])
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        finally:
            video_dataset.VideoFrameDataset.__getitem__ = get_item
        served = _launches()
        report = json.loads((res / "inference_report.json").read_text())
        n_frames = len(split["test"]) * ZARR_FRAMES
        print(f"[14] mmr_torch_infer: exit {rc} in {dt:.1f} s; {n_frames} frames of "
              f"{split['test']}; launches {served}", flush=True)
        check(rc == 0 and sorted(report["videos"]) == sorted(split["test"])
              and np.isfinite(report["overall_mean_iou"]),
              "mmr_torch_infer did not report the test split")
        check(served == forward_counts(n_frames),
              "mmr_torch_infer's launches are not 21 K1 + 2 K2 a frame")
        for v, r in report["videos"].items():
            print(f"[14] {smi}: {v}: {r['fps']:.2f} frames/s (reads included), mean IoU "
                  f"{r['mean_iou']:.4f}", flush=True)
        print(f"[14] {smi}: reading frames took {sum(reads):.3f} s of the report's "
              f"{report['total_time_s']:.3f} s ({len(reads)} chunks of <= 6 frames; read "
              f"share {sum(reads) / report['total_time_s']:.3f})", flush=True)

        # ---- mmr_torch_visualize --------------------------------------------------
        n_win = (len(_window_starts(FRAME[0], ROI[0], 0.25))
                 * len(_window_starts(FRAME[1], ROI[1], 0.25)))
        vis_forwards = -(-n_win // config["sw_batch_size"])
        store = ds / "data" / f"{split['test'][0]}.zarr"
        _zero_launches()
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            rc = visualize.main([run, str(store), "--frames", "3", "--out", f"{tmp}/vis",
                                 "--legend", "--architecture", "--device", str(dev)])
        torch.cuda.synchronize()
        shown = _launches()
        img = png.read(f"{tmp}/vis/prediction_triptychs.png")
        legend = png.read(f"{tmp}/vis/class_legend.png")
        diagram = png.read(f"{tmp}/vis/architecture_diagram.png")
        bars = json.loads(png.read_text(f"{tmp}/vis/class_legend.png")["legend"])
        boxes = json.loads(png.read_text(f"{tmp}/vis/architecture_diagram.png")["diagram"])
        print(f"[14] mmr_torch_visualize --legend --architecture: exit {rc}; triptych "
              f"{img.shape}, class_legend.png {legend.shape} ({len(bars['classes'])} "
              f"bars), architecture_diagram.png {diagram.shape} "
              f"({boxes['boxes'][5]['label']}); launches {shown}", flush=True)
        check(rc == 0 and img.shape == (FRAME[0], 3 * FRAME[1] + 2 * 4, 3),
              "mmr_torch_visualize wrote no triptych of one frame")
        check(len(bars["classes"]) == N_CLASSES and len(boxes["boxes"]) == 6
              and len(boxes["arrows"]) == 5
              and "Model Architecture Summary:" in printed.getvalue(),
              "mmr_torch_visualize's legend or diagram is not whole")
        check(shown == forward_counts(vis_forwards),
              "mmr_torch_visualize's launches are not its forwards'")
    wall = time.perf_counter() - t_phase
    print(f"[14] {smi}: sampler {rates['uint8']:.1f} (uint8) / {rates['float32']:.1f} "
          f"(float32) samples/s, Zarr epochs {hist['epoch_time_s'][0]:.3f} / "
          f"{hist['epoch_time_s'][1]:.3f} s, infer "
          f"{min(r['fps'] for r in report['videos'].values()):.2f} frames/s; "
          f"phase 14 wall time {wall:.1f} s", flush=True)
    torch.cuda.empty_cache()
    return launches


# ------------------------------------------------------------- 15. data parallelism

MESH_RANKS = 2
MESH_STEPS = 5          # timed train steps a rank
MESH_FRAMES = 12        # full-HD frames served over the ranks
MESH_TIMEOUT = 600      # seconds a torchrun of phase 15 may take
MESH_CLI_EPOCHS = 1
MESH_EVAL_BATCHES, MESH_EVAL_BATCH, MESH_EVAL_SEED = 6, 4, 15   # (d)
RANK_SCRIPT = Path(__file__).resolve()   # what torchrun runs a rank of


def mesh_backend() -> str:
    """NCCL with one card a rank where there are cards enough, else gloo
    with the ranks sharing the card."""
    return "nccl" if torch.cuda.device_count() >= MESH_RANKS else "gloo"


def torchrun(phase, args, what: str) -> str:
    """``chip_smoke.py ARGS`` as ``MESH_RANKS`` ranks under torchrun, in a
    session of its own (killed whole at the time limit); its phase lines go
    to stdout, its end into a failed check."""
    import os
    import signal

    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", str(MESH_RANKS), str(RANK_SCRIPT), *args]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True, start_new_session=True,
                            cwd=Path(__file__).resolve().parent)
    try:
        out, _ = proc.communicate(timeout=MESH_TIMEOUT)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    for line in out.splitlines():
        if f"[{phase}" in line:
            print(line, flush=True)
    check(proc.returncode == 0, f"{what} exited {proc.returncode}:\n{out[-3000:]}")
    return out


@contextlib.contextmanager
def collectives(timed: bool = False):
    """Count (and, ``timed``, time with the device drained around each
    call) the collectives the port issues: ``torch.distributed``'s
    all_reduce, broadcast and all_gather. Yields {"calls", "ms"}."""
    import torch.distributed as dist

    tally, saved = {"calls": 0, "ms": 0.0}, {}
    for name in ("all_reduce", "broadcast", "all_gather"):
        fn = saved[name] = getattr(dist, name)

        def counted(*a, _fn=fn, **kw):
            tally["calls"] += 1
            if not timed:
                return _fn(*a, **kw)
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = _fn(*a, **kw)
            torch.cuda.synchronize()
            tally["ms"] += (time.perf_counter() - t) * 1e3
            return out
        setattr(dist, name, counted)
    try:
        yield tally
    finally:
        for name, fn in saved.items():
            setattr(dist, name, fn)


def _clipped_grad(state) -> torch.Tensor:
    """The step's clipped (and, on a mesh, rank-averaged) gradient: AdamW's
    first moment after one step over 1 − b1."""
    return state.opt_state["mu"] / (1.0 - 0.9)


def _mesh_steps(model, mesh_or_dev, pre):
    from mmr_tpu_torch.losses import dice_ce_loss
    from mmr_tpu_torch.train.optim import build_optimizer
    from mmr_tpu_torch.train.state import TrainState
    from mmr_tpu_torch.train.steps import make_train_step

    opt = build_optimizer("adamw", clip_grad_norm=CLIP, weight_decay=1e-2)
    where = ({"device": mesh_or_dev} if isinstance(mesh_or_dev, torch.device)
             else {"mesh": mesh_or_dev})
    return TrainState.create(model, opt), make_train_step(
        model, opt, dice_ce_loss, N_CLASSES, preprocess=pre, **where)


def mesh_rank(out: Path) -> None:
    """One rank of phase 15 (a) and (b), run by torchrun: the flagship's
    fused and plain f32 train steps on this rank's half of phase 6's batch,
    every launch recorded and held, five timed steps with their
    collectives; then this rank's frames of ``MESH_FRAMES`` full-HD frames
    served, and on rank 0 one rank serving them all. Writes
    ``out/rank<r>.pt``."""
    import torch.distributed as dist
    from mmr_tpu_torch.core.mesh import create_mesh, gather_batch, shard_batch
    from mmr_tpu_torch.infer.sliding_window import make_sliding_window_fn
    from mmr_tpu_torch.models import create_model, get_preprocessing
    from mmr_tpu_torch.ops import _build
    from mmr_tpu_torch.ops.fused_conv import fused_conv, fused_conv_down

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = create_mesh(backend=mesh_backend())
    tag, dev = f"15 r{mesh.rank}", mesh.device
    _build.library()
    inp = torch.load(out / "inputs.pt", weights_only=False)
    pre = get_preprocessing("tu-mobilenetv3_small_100")
    print(f"[{tag}] {dist.get_backend()} rank {mesh.rank} of {mesh.size} on {dev} "
          f"({torch.cuda.get_device_name(dev)})", flush=True)
    res = {}

    # ---- (a) the flagship's train step on 4 + 4 of phase 6's batch --------
    images, masks = shard_batch(mesh, (inp["images"], inp["masks"]), axis=1)
    fused = create_model(classes=N_CLASSES, device=dev, fused=True, fused_frontend=True)
    fused.load_state_dict(inp["weights"])
    flagship_counts(fused)
    state, step = _mesh_steps(fused, mesh, pre)
    with recording() as (records, recorders), collectives() as calls:
        state, met = step(state, images, masks, inp["lr"])
        torch.cuda.synchronize()
    launches = {k: r.launches for k, r in recorders.items()}
    print(f"[{tag}] launches in one train step on {tuple(images.shape[1:])}: "
          f"{launches}; collectives {calls['calls']}", flush=True)
    check(launches == TRAIN_COUNTS, f"expected {TRAIN_COUNTS} launches")
    cases = hold_records(tag, records)
    res.update(loss=float(met["loss"]), iou=float(met["iou"]), launches=launches,
               held=len(cases), collectives=calls["calls"],
               grad=_clipped_grad(state).cpu(),
               stats={k: v.cpu().clone() for k, v in fused.state_dict().items()
                      if "running" in k})
    del records, cases

    run = lambda: step(state, images, masks, inp["lr"])
    ts = []
    for _ in range(MESH_STEPS):
        mesh.barrier()
        torch.cuda.synchronize()
        t = time.perf_counter()
        run()
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t) * 1e3)
    mesh.barrier()
    with collectives(timed=True) as timed:
        run()
    res.update(step_ms=sorted(ts)[len(ts) // 2], issue_ms=host_issue_ms(run, 3),
               busy_ms=device_profile(run, 2, skip="nccl")[0], collective_ms=timed["ms"],
               collective_calls_timed=timed["calls"])
    print(f"[{tag}] fused step median {res['step_ms']:.3f} ms ({MESH_STEPS} steps), "
          f"host issue {res['issue_ms']:.3f} ms, device busy {res['busy_ms']:.3f} ms "
          f"(NCCL's kernels left out: they wait for the peer); "
          f"{timed['calls']} collectives a step, {timed['ms']:.3f} ms with the device "
          f"drained around each", flush=True)

    plain = create_model(classes=N_CLASSES, device=dev, dtype=torch.float32)
    plain.load_state_dict(inp["weights"])
    pstate, pstep = _mesh_steps(plain, mesh, pre)
    pstate, pmet = pstep(pstate, images, masks, inp["lr"])
    res.update(ploss=float(pmet["loss"]), pgrad=_clipped_grad(pstate).cpu())
    del plain, pstate, pstep, state, step, run
    torch.cuda.empty_cache()

    # ---- (b) sharded serving ------------------------------------------------
    fused.load_state_dict(inp["weights"])
    fused.eval()
    sw = make_sliding_window_fn(fused, ROI, N_CLASSES, preprocess=pre,
                                compute_dtype=torch.bfloat16, fuse_blend=True, mesh=mesh)
    sw(inp["frames"][:MESH_RANKS])   # warm-up
    fused_conv.launches = fused_conv_down.launches = 0
    mesh.barrier()
    torch.cuda.synchronize()
    t = time.perf_counter()
    local = sw(inp["frames"])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t
    res["serve_launches"] = {"K1": fused_conv.launches, "K2": fused_conv_down.launches}
    n_local = MESH_FRAMES // mesh.size
    print(f"[{tag}] served {n_local} of {MESH_FRAMES} frames in {dt * 1e3:.1f} ms; "
          f"launches {res['serve_launches']}", flush=True)
    check(res["serve_launches"] == {"K1": 21 * n_local, "K2": 2 * n_local},
          "a rank did not serve its frames through the kernels")
    check(tuple(local.shape) == (n_local, *FRAME, N_CLASSES)
          and bool(torch.isfinite(local).all()), "sharded logits")
    slowest = torch.tensor([dt], device=dev)
    dist.all_reduce(slowest, op=dist.ReduceOp.MAX)
    res["serve_s"] = slowest.item()
    every = gather_batch(mesh, local)
    del local
    if mesh.rank == 0:
        one = make_sliding_window_fn(fused, ROI, N_CLASSES, preprocess=pre,
                                     compute_dtype=torch.bfloat16, fuse_blend=True,
                                     device=dev)
        torch.cuda.synchronize()
        t = time.perf_counter()
        ref = one(inp["frames"])
        torch.cuda.synchronize()
        res["serve_one_s"] = time.perf_counter() - t
        agree = (every.argmax(-1) == ref.argmax(-1)).float().mean().item()
        within = bool(torch.allclose(every, ref, atol=0.25, rtol=0.05))
        res.update(serve_agree=agree, serve_within=within,
                   serve_max_abs=(every - ref).abs().max().item())
        print(f"[{tag}] {MESH_FRAMES} frames over {mesh.size} ranks vs one rank: "
              f"argmax agreement {agree:.5f}, max |dlogit| {res['serve_max_abs']:.3e}, "
              f"within atol .25/rtol .05: {within}", flush=True)
        del ref
    del every

    # ---- (d) Evaluate(mesh=): each rank adds its batches, the ranks' K7
    # totals are summed when the counts are read ----------------------------
    from mmr_tpu_torch.metrics.evaluate import Evaluate
    from mmr_tpu_torch.ops.confusion import confusion_stats

    gen = torch.Generator(device=dev).manual_seed(MESH_EVAL_SEED)
    batches = [(torch.randint(0, N_CLASSES, (MESH_EVAL_BATCH, *PATH_A_HW),
                              device=dev, generator=gen, dtype=torch.uint8),
                torch.randint(0, N_CLASSES, (MESH_EVAL_BATCH, *PATH_A_HW),
                              device=dev, generator=gen, dtype=torch.uint8))
               for _ in range(MESH_EVAL_BATCHES)]
    mine = batches[mesh.rank::mesh.size]
    ev = Evaluate(N_CLASSES, mesh=mesh)
    confusion_stats.launches = 0
    for pred, gt in mine:
        ev.add_batch(pred, gt)
    counts = np.stack([ev.tp, ev.fp, ev.fn])
    res.update(eval_counts=counts, eval_miou=ev.iou()[1],
               eval_launches=confusion_stats.launches, eval_batches=len(mine))
    if mesh.rank == 0:
        one = Evaluate(N_CLASSES)
        for pred, gt in batches:
            one.add_batch(pred, gt)
        res.update(eval_one_counts=np.stack([one.tp, one.fp, one.fn]),
                   eval_one_miou=one.iou()[1])
    print(f"[{tag}] Evaluate(mesh=): {len(mine)} of {MESH_EVAL_BATCHES} batches, "
          f"{res['eval_launches']} K7 launches on this rank; summed counts "
          f"{int(counts.sum())}, mean IoU {res['eval_miou']:.6f}", flush=True)
    torch.save(res, out / f"rank{mesh.rank}.pt")
    mesh.barrier()


def cli_rank(out: Path, args: list[str]) -> None:
    """One rank of phase 15 (c): ``train_path_a.main(args)`` under torchrun,
    its launch counts and exit code to ``out/cli_rank<r>.json``."""
    import os

    from mmr_tpu_torch.cli import train_path_a

    for kind in KERNELS:
        wrapper(kind).launches = 0
    rc = train_path_a.main(args)
    torch.cuda.synchronize()
    rank = int(os.environ["RANK"])
    (out / f"cli_rank{rank}.json").write_text(json.dumps(
        {"rc": rc, "launches": {k: wrapper(k).launches for k in KERNELS}}))


def mesh_phase(dev, seed, smi, inputs, path_a_k6) -> dict:
    """Phase 15: data parallelism over ``MESH_RANKS`` ranks (NCCL, one card
    each, where there are cards enough; else gloo, the ranks sharing the
    card). (a) The flagship's fused train step on phase 6's weights and
    B=8 512×640 batch split 4 + 4 (every launch of each rank held; the
    2-rank step against the 1-rank step on the global batch: loss rtol
    2e-2, the clipped gradient's cosine ≥ 0.99 and norm within 2 %, BN
    running statistics atol 1e-3 / rtol 1e-2; the plain f32 step: loss
    rtol 1e-5, gradient relative L2 < 1e-2), step times and collectives;
    (b) ``MESH_FRAMES`` full-HD frames through ``make_sliding_window_fn(
    mesh=)`` against one rank serving them all (phase 3's bounds), launches
    per rank, frames/s; (c) ``train_path_a`` under torchrun for one epoch
    on phase 11's PNG frames: exit 0, each file once, the K6a / K6b / K7
    launches each rank's table makes (``path_a_k6``: phase 7's
    ``k6_expected``); (d) ``Evaluate(mesh=)`` over
    ``MESH_EVAL_BATCHES`` batches split over the ranks, each rank's K7
    launches its own batches', the summed counts and the mean IoU equal to
    one rank's over every batch, exactly. Returns {kind: launches of rank
    0}."""
    import tempfile

    from mmr_tpu_torch.data.synthetic import render_frame
    from mmr_tpu_torch.models import create_model, get_preprocessing

    t_phase = time.perf_counter()
    backend = mesh_backend()
    print(f"[15] {MESH_RANKS} ranks over {backend} "
          f"({torch.cuda.device_count()} card(s) visible); {smi}", flush=True)
    weights, images, masks, lr = inputs
    pre = get_preprocessing("tu-mobilenetv3_small_100")
    ref = {}
    for name, kw in (("fused", {"fused": True, "fused_frontend": True}),
                     ("plain", {"dtype": torch.float32})):
        m = create_model(classes=N_CLASSES, device=dev, **kw)
        m.load_state_dict(weights)
        state, step = _mesh_steps(m, dev, pre)
        state, met = step(state, images, masks, lr)
        ref[name] = {"loss": float(met["loss"]), "grad": _clipped_grad(state),
                     "stats": {k: v.clone() for k, v in m.state_dict().items()
                               if "running" in k}}
        if name == "fused":
            images_d, masks_d = images.to(dev), masks.to(dev)
            ref["step_ms"] = _timed_steps(15, lambda: step(state, images_d, masks_d, lr),
                                          MESH_STEPS)
        del m, state, step
    rng = np.random.RandomState(seed + 15)
    frames = np.stack([(render_frame(rng, *FRAME, N_CLASSES - 1)[0] * 255.0 + 0.5)
                       .astype(np.uint8) for _ in range(MESH_FRAMES)])
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp)
        torch.save({"weights": {k: v.cpu() for k, v in weights.items()},
                    "images": images, "masks": masks, "lr": lr, "frames": frames},
                   out / "inputs.pt")
        t0 = time.perf_counter()
        torchrun(15, ["--mesh-rank", str(out)], "phase 15's ranks")
        print(f"[15] (a) + (b): {MESH_RANKS} ranks in {time.perf_counter() - t0:.1f} s "
              "(process start, build load and both parts)", flush=True)
        ranks = [torch.load(out / f"rank{r}.pt", weights_only=False)
                 for r in range(MESH_RANKS)]

        # ---- (a) against one rank on the global batch -------------------------
        r0 = ranks[0]
        for name, loss, grad, rtol in (("fused", r0["loss"], r0["grad"], 2e-2),
                                       ("plain f32", r0["ploss"], r0["pgrad"], 1e-5)):
            want = ref["fused" if name == "fused" else "plain"]
            g, w = grad.to(dev).double(), want["grad"].double()
            cos = (g @ w / (g.norm() * w.norm())).item()
            norm = (g.norm() / w.norm()).item()
            rel = ((g - w).norm() / w.norm()).item()
            print(f"[15] {name} step, {MESH_RANKS} ranks vs 1 on the global batch: loss "
                  f"{loss:.6f} vs {want['loss']:.6f}; clipped gradient cosine "
                  f"{cos:.6f}, norm ratio {norm:.5f}, relative L2 {rel:.3e}", flush=True)
            check(abs(loss - want["loss"]) <= rtol * abs(want["loss"]),
                  f"the {name} loss on {MESH_RANKS} ranks differs from one rank's")
            if name == "fused":
                check(cos >= 0.99 and abs(norm - 1.0) <= 0.02,
                      "the fused step's gradient on the ranks differs from one rank's")
            else:
                check(rel < 1e-2, "the plain f32 gradient on the ranks differs")
        worst = max(((r["stats"][k].to(dev) - v).abs().max().item(), k)
                    for r in ranks for k, v in ref["fused"]["stats"].items())
        for r in ranks:
            for k, v in ref["fused"]["stats"].items():
                check(torch.allclose(r["stats"][k].to(dev), v, atol=1e-3, rtol=1e-2),
                      f"BN statistic {k} on the ranks differs from one rank's")
        print(f"[15] BN running statistics vs one rank: worst max |Δ| {worst[0]:.3e} "
              f"({worst[1]})", flush=True)
        for rank, r in enumerate(ranks):
            check(r["launches"] == TRAIN_COUNTS and r["held"] == sum(TRAIN_COUNTS.values()),
                  f"rank {rank} did not launch and hold every kernel")
            print(f"[15] rank {rank}: step median {r['step_ms']:.3f} ms ({MESH_RANKS} ranks, "
                  f"B={TRAIN_BATCH // MESH_RANKS} each; one rank B={TRAIN_BATCH}: "
                  f"{ref['step_ms']:.3f} ms), host issue {r['issue_ms']:.3f} ms, device "
                  f"busy {r['busy_ms']:.3f} ms; {r['collectives']} collectives a step, "
                  f"{r['collective_ms']:.3f} ms with the device drained around each; "
                  f"{smi}", flush=True)

        # ---- (b) sharded serving ------------------------------------------------
        check(r0["serve_agree"] >= 0.99 and r0["serve_within"],
              "sharded serving disagrees with one rank serving every frame")
        print(f"[15] serving {MESH_FRAMES} full-HD frames: {MESH_RANKS} ranks "
              f"{MESH_FRAMES / r0['serve_s']:.2f} frames/s (slowest rank), one rank "
              f"{MESH_FRAMES / r0['serve_one_s']:.2f} frames/s; launches a rank "
              f"{[r['serve_launches'] for r in ranks]}; {smi}", flush=True)

        # ---- (d) Evaluate(mesh=): the ranks' summed K7 totals ----------------------
        for rank, r in enumerate(ranks):
            check(r["eval_launches"] == r["eval_batches"]
                  == MESH_EVAL_BATCHES // MESH_RANKS,
                  f"rank {rank} did not count its own batches on K7")
            check(np.array_equal(r["eval_counts"], r0["eval_one_counts"])
                  and r["eval_miou"] == r0["eval_one_miou"],
                  f"Evaluate(mesh=) on rank {rank} differs from one rank's counts")
        print(f"[15] Evaluate(mesh=): {MESH_EVAL_BATCHES} batches of "
              f"{MESH_EVAL_BATCH}x{PATH_A_HW[0]}x{PATH_A_HW[1]} uint8 ids, "
              f"{MESH_EVAL_BATCHES // MESH_RANKS} a rank on K7; the summed (3, "
              f"{N_CLASSES}) counts equal one rank's over every batch exactly on "
              f"each rank ({int(r0['eval_counts'].sum())} in all), mean IoU "
              f"{r0['eval_miou']:.9f} = {r0['eval_one_miou']:.9f}", flush=True)

        # ---- (c) Path A's CLI under torchrun ----------------------------------------
        root, run = out / "data", out / "run"
        write_path_a_pngs(root, seed)   # phase 11's frames
        t0 = time.perf_counter()
        torchrun(15, ["--cli-rank", str(out), "--",
                      "--data_dir", str(root), "--model", "smp_UNet++",
                      "--epochs", str(MESH_CLI_EPOCHS), "--trainBatchSize", str(CLI_BATCH),
                      "--valBatchSize", str(CLI_VAL_BATCH), "--save_dir", str(run),
                      "--seed", str(seed), "--resizedHeight", str(PATH_A_HW[0]),
                      "--resizedWidth", str(PATH_A_HW[1]), "--backend", backend,
                      "--device", str(dev)],
                 "train_path_a under torchrun")
        dt = time.perf_counter() - t0
        cli = [json.loads((out / f"cli_rank{r}.json").read_text()) for r in range(MESH_RANKS)]
        steps = MESH_CLI_EPOCHS * (CLI_TRAIN // CLI_BATCH)
        forwards = (MESH_CLI_EPOCHS + 1) * (CLI_VAL // CLI_VAL_BATCH)   # val, heavy metrics
        for rank, c in enumerate(cli):
            sample = 1 if rank == 0 else 0   # rank 0 predicts the triptych's batch
            want = _counts(**k6_step(path_a_k6, steps, forwards + sample))
            print(f"[15] train_path_a rank {rank}: exit {c['rc']}, launches "
                  f"{c['launches']}", flush=True)
            check(c["rc"] == 0 and c["launches"] == want,
                  f"train_path_a's rank {rank} launches are not the code's ({want})")
        files = sorted(p.name for p in run.iterdir())
        check(files == ["accuracy.png", "checkpoints", "epoch_1_samples.png", "loss.png",
                        "train.log"], f"train_path_a wrote {files}")
        log = (run / "train.log").read_text()
        check(log.count(f"epoch {MESH_CLI_EPOCHS}/{MESH_CLI_EPOCHS}") == 1
              and log.count("heavy metrics") == 1 and log.count(" done") == 1,
              "train.log does not hold each line once")
        print(f"[15] train_path_a under torchrun ({MESH_RANKS} ranks, {backend}): "
              f"{dt:.1f} s, files {files}, each log line once", flush=True)
    print(f"[15] phase 15 took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return {"backend": backend, "launches": r0["launches"],
            "cli_launches": cli[0]["launches"]}


# ------------------------------------------------- 16. Path B's data entry

FIXTURES = Path(__file__).resolve().parent / "tests" / "torch_fixtures"
CONVERT_VIDEOS = 2                   # inner video ZIPs made from the Motion-JPEG fixture
CONVERT_STEPS, CONVERT_VAL = 4, 1    # the train epoch on the converted stores
DECODE_REPS = 5                      # timed decodes of each fixture frame
STORE_READS = 20                     # timed whole-array reads a rate


def _sha256(a) -> str:
    import hashlib

    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def chunk_decode_rates(array_path, threads, reps=STORE_READS) -> dict:
    """{pool threads: MB/s of chunks decoded} for whole reads of the Zarr
    array at ``array_path`` (its chunk files in the page cache after a
    first read: warm), each chunk decoded on the pool into the output."""
    from mmr_tpu_torch.data import zarr_io

    arr = zarr_io.ZarrArray(array_path)
    n = math.prod(-(-s // c) for s, c in zip(arr.shape, arr.chunks))
    nbytes = n * math.prod(arr.chunks) * arr.dtype.itemsize
    out = {}
    for k in threads:
        zarr_io.set_pool_threads(k)
        arr[:]
        t0 = time.perf_counter()
        for _ in range(reps):
            arr[:]
        out[k] = reps * nbytes / 1e6 / (time.perf_counter() - t0)
    zarr_io.set_pool_threads(zarr_io.POOL_THREADS)
    return out


def gzip_copy(src: Path, dst: Path) -> Path:
    """The store at ``src`` written again by the port (``bytes`` + ``gzip``)
    in the same chunks, with its properties."""
    from mmr_tpu_torch.data import zarr_io

    s = zarr_io.VideoStore(src)
    t, h, w = s.shape
    d = zarr_io.VideoStore.create(dst, t, h, w, s.image.chunks[2:], image_dtype=s.image_dtype)
    img, mask = s.read_frames(0, t)
    d.image.write((slice(None),), img.transpose(3, 0, 1, 2))
    d.mask.write((slice(None),), mask)
    d.set_properties(s.properties)
    return dst


def fixture_masks(seed: int, n: int) -> list[np.ndarray]:
    """``n`` full-HD masks of the 9 tool classes (``render_frame``'s blobs)."""
    from mmr_tpu_torch.data.synthetic import render_frame

    rng = np.random.RandomState(seed)
    return [render_frame(rng, *FRAME, N_CLASSES - 1)[1] for _ in range(n)]


def native_data_phase(dev, seed, smi) -> dict:
    """Phase 16: Path B's entry on the card's machine — the host decoders
    (``csrc/host``, built by ``cc``) and ``mmr_torch_create_dataset``.
    (a) builds the library; (b) decodes every frame of the committed
    1080×1920 Motion-JPEG fixture (cv2's writer, 4:2:0): each frame's
    sha256 the recorded one (the port's decode, equal to PIL's where it was
    recorded), ms a frame, and ms a frame with OpenCV's chroma (the
    converter's decode); (c) reads the committed blosc-zstd stores (JAX's
    ``VideoStore``) through ``VideoStore`` and ``PatchSampler``: arrays and
    batches of the recorded sha256 (JAX's reads); writes the bitshuffled
    small stores and the two of one full-size (3, 1, 512, 640) chunk again
    as gzip stores and times whole-array reads of both (MB/s of chunks
    decoded, one thread and the pool's default); (d) a ZIP of
    ``CONVERT_VIDEOS`` inner ZIPs of the fixture video and ``png.write``
    masks through ``create_dataset.main`` at the flagship's defaults (9
    tool classes, the reference's ``n_classes`` beside the background;
    ``[512,640]``, float32, ``--write_split``): stores of the
    frames decoded with OpenCV's chroma and the masks, class locations; one
    ``train_model.main`` epoch of ``CONVERT_STEPS`` + ``CONVERT_VAL``
    batches on them (launches the code's), ``infer.main`` on the split's
    test video (exit 0, 21 K1 + 2 K2 a frame). Returns {kind: launches of
    the train epoch}."""
    import tempfile
    import zipfile

    from mmr_tpu_torch.cli import create_dataset, infer, train_model
    from mmr_tpu_torch.config import read_config
    from mmr_tpu_torch.data import hostlib, png, zarr_io
    from mmr_tpu_torch.data.patch_dataset import PatchSampler
    from mmr_tpu_torch.data.video import VideoReader

    t_phase = time.perf_counter()
    records = json.loads((FIXTURES / "records.json").read_text())
    # ---- (a) the host library --------------------------------------------------
    t0 = time.perf_counter()
    hostlib.library()   # prints its cc build's time where it builds
    print(f"[16] {smi}: host decoders {hostlib.build().name} ready in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    # ---- (b) Motion-JPEG frames ----------------------------------------------------
    avi = records["avi"]
    frames, times, cv_times = [], [], []
    with VideoReader(FIXTURES / avi["file"]) as video:
        check(video.frame_count == len(avi["frames"]) and video.fourcc == "MJPG"
              and (video.height, video.width) == FRAME, "the Motion-JPEG fixture's header")
        for t, want in enumerate(avi["frames"]):
            data = video.frame_bytes(t)
            frame = video.read(t)
            check(frame.shape == tuple(avi["shape"]) and _sha256(frame) == want,
                  f"frame {t} of {avi['file']} decoded to other samples than recorded")
            frames.append(frame)
            for _ in range(DECODE_REPS):
                t0 = time.perf_counter()
                hostlib.jpeg_decode(data)
                times.append((time.perf_counter() - t0) * 1e3)
                t0 = time.perf_counter()
                hostlib.jpeg_decode(data, fancy_upsampling=False)
                cv_times.append((time.perf_counter() - t0) * 1e3)
        check(video.read(len(frames)) is None, "a frame past the fixture's end was read")
    with VideoReader(FIXTURES / avi["file"], fancy_upsampling=False) as video:
        # the converter's decode (OpenCV's repeated chroma): what (d) stores
        converted = [video.read(t) for t in range(len(frames))]
    kb = (FIXTURES / avi["file"]).stat().st_size / 1e3 / len(frames)
    print(f"[16] {smi}: Motion-JPEG {FRAME[0]}x{FRAME[1]} 4:2:0, {len(frames)} frames "
          f"({kb:.1f} kB a frame) of the recorded sha256; decode median "
          f"{sorted(times)[len(times) // 2]:.2f} ms a frame, min {min(times):.2f} ms "
          f"({len(times)} decodes, one thread); with OpenCV's chroma (the converter's) "
          f"median {sorted(cv_times)[len(cv_times) // 2]:.2f} ms", flush=True)

    # ---- (c) the JAX-written blosc-zstd stores -----------------------------------
    for name, rec in records["stores"].items():
        store = zarr_io.VideoStore(FIXTURES / "blosc" / f"{name}.zarr")
        img, mask = store.read_frames(0, store.shape[0])
        check(_sha256(store.image[:]) == rec["image"] and _sha256(mask) == rec["mask"]
              and img.dtype == np.dtype(rec["dtype"]),
              f"the blosc store {name} reads other arrays than JAX's")
    smp = records["sampler"]
    for kind, want in smp["batches"].items():
        sampler = PatchSampler(
            [FIXTURES / "blosc" / f"{kind}_{ab}.zarr" for ab in "ab"], tuple(smp["patch"]),
            smp["batch"], smp["steps"],
            oversample_foreground_percent=smp["oversample_foreground_percent"],
            initial_patch_size=tuple(smp["initial_patch_size"]), seed=smp["seed"])
        got = [[_sha256(i), _sha256(m)] for i, m in sampler.epoch(epoch_seed=smp["epoch_seed"])]
        check(got == want, f"the {kind} PatchSampler's batches are not JAX's")
    print(f"[16] {len(records['stores'])} blosc-zstd stores and "
          f"{sum(map(len, smp['batches'].values()))} PatchSampler batches equal JAX's "
          f"reads (sha256)", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        threads = (1, zarr_io.POOL_THREADS)
        for name in ("f32_a", "u8_a", "f32_full", "u8_full"):
            src = FIXTURES / "blosc" / f"{name}.zarr"
            dst = gzip_copy(src, tmp / f"{name}.zarr")
            check(np.array_equal(zarr_io.VideoStore(dst).image[:], zarr_io.VideoStore(src).image[:]),
                  f"the gzip copy of {name} differs")
            arr = zarr_io.ZarrArray(src / "image")
            stored = [sum(f.stat().st_size for f in (p / "image" / "c").rglob("*")
                          if f.is_file()) / 1e6 for p in (src, dst)]
            blosc = chunk_decode_rates(src / "image", threads)
            gz = chunk_decode_rates(dst / "image", threads)
            print(f"[16] {smi}: {name} image {arr.shape}, chunks {arr.chunks} {arr.dtype} "
                  f"(stored {stored[0]:.3f} MB blosc-zstd, {stored[1]:.3f} MB gzip; warm "
                  "reads): " + "; ".join(f"{k} threads: blosc-zstd+bitshuffle {blosc[k]:.1f} "
                                         f"MB/s, gzip {gz[k]:.1f} MB/s" for k in threads),
                  flush=True)

        # ---- (d) mmr_torch_create_dataset, train, infer ------------------------------
        masks = fixture_masks(seed + 16, len(frames))
        outer = tmp / "videos.zip"
        with zipfile.ZipFile(outer, "w") as zo:
            for v in range(CONVERT_VIDEOS):
                inner = tmp / f"video_{v + 1:02d}.zip"
                with zipfile.ZipFile(inner, "w") as zi:
                    zi.write(FIXTURES / avi["file"], "video_left.avi")
                    for t, m in enumerate(masks):
                        zi.write(png.write(tmp / "m.png", m), f"segmentation/{t:09d}.png")
                zo.write(inner, inner.name)
        ds, run = tmp / "ds", tmp / "run"
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            rc = create_dataset.main([str(outer), str(ds), str(N_CLASSES - 1),
                                      f"[{ROI[0]},{ROI[1]}]", "--write_split"])
        dt = time.perf_counter() - t0
        stores = zarr_io.list_dataset_stores(ds)
        on_disk = sum(f.stat().st_size for f in ds.rglob("*") if f.is_file())
        print(f"[16] {smi}: mmr_torch_create_dataset: exit {rc} in {dt:.2f} s for "
              f"{CONVERT_VIDEOS} videos x {len(frames)} {FRAME[0]}x{FRAME[1]} frames "
              f"(float32, {on_disk / 1e6:.1f} MB on disk)", flush=True)
        check(rc == 0 and len(stores) == CONVERT_VIDEOS
              and (ds / "train_val_test_split.json").is_file(),
              "mmr_torch_create_dataset did not write the stores and the split")
        for p in stores:
            store = zarr_io.VideoStore(p)
            img, mask = store.read_frames(0, len(frames))
            check(img.dtype == np.float32 and store.shape == (len(frames), *FRAME)
                  and all(np.array_equal(img[t], converted[t].astype(np.float32) / 255.0)
                          and np.array_equal(mask[t], masks[t]) for t in range(len(frames)))
                  and all(len(c) for c in store.class_locations.values()),
                  f"{p.name} does not hold the decoded frames, masks and class locations")
        split = json.loads((ds / "train_val_test_split.json").read_text())
        argv = [str(ds), str(run), "train-val-test", str(N_CLASSES - 1),
                f"[{ROI[0]},{ROI[1]}]", "--device", str(dev)]
        _zero_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            rc = train_model.main(argv + [
                "--n_epochs", "1", "--steps_per_epoch", str(CONVERT_STEPS),
                "--val_steps_per_epoch", str(CONVERT_VAL), "--seed", str(seed)])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = _launches()
        config = read_config(run / "config.yaml")
        hist = json.loads((run / "training_metrics.json").read_text())
        print(f"[16] {smi}: mmr_torch_train_model on the converted stores: exit {rc} in "
              f"{dt:.1f} s; epoch {hist['epoch_time_s'][0]:.3f} s, "
              f"{hist['samples_per_sec'][0]:.2f} samples/s, train loss "
              f"{hist['train_loss'][0]:.5f}, val loss {hist['val_loss'][0]:.5f}; "
              f"launches {launches}", flush=True)
        check(rc == 0 and np.all(np.isfinite(hist["train_loss"] + hist["val_loss"])),
              "the train CLI on the converted stores failed")
        check(launches == trainer_counts(CONVERT_STEPS, CONVERT_VAL + (
            1 % config["val_plot_interval"] == 0)),
              "the train CLI's launches on the converted stores are not the code's")
        _zero_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            rc = infer.main([str(ds), str(run), "--infer_batch_size", "6",
                             "--device", str(dev)])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        served = _launches()
        report = json.loads((run / "inference_report.json").read_text())
        n_frames = len(split["test"]) * len(frames)
        print(f"[16] {smi}: mmr_torch_infer on {split['test']}: exit {rc} in {dt:.1f} s; "
              f"mean IoU {report['overall_mean_iou']:.4f}; launches {served}", flush=True)
        check(rc == 0 and sorted(report["videos"]) == sorted(split["test"])
              and np.isfinite(report["overall_mean_iou"]),
              "mmr_torch_infer on the converted stores did not report the test split")
        check(served == forward_counts(n_frames),
              "mmr_torch_infer's launches are not 21 K1 + 2 K2 a frame")
    print(f"[16] {smi}: phase 16 wall time {time.perf_counter() - t_phase:.1f} s", flush=True)
    torch.cuda.empty_cache()
    return launches


# ------------------------------------------- 17. the fused b1 pair

B1_TRAIN = {"K1": 1, "K2": 3, "K3": 1, "K4": 3}   # stem, b0_0, b1_0; b1_1
B1_EVAL = {"K1": 1, "K2": 3}
B1_REPS = 10                                     # timed runs of the pair


def _b1_time(phase, name, run) -> dict:
    """Median ms (host clock around a synchronized run), host issue and
    device busy of ``run``."""
    ts = []
    for _ in range(B1_REPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        run()
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t) * 1e3)
    med = sorted(ts)[len(ts) // 2]
    issue = host_issue_ms(run, 5)
    busy = device_profile(run, 3)[0]
    print(f"[{phase}] b1 pair, {name}: median {med:.3f} ms, host issue "
          f"{issue:.3f} ms, device busy {busy:.3f} ms", flush=True)
    return {"ms": med, "issue_ms": issue, "busy_ms": busy}


def b1_phase(dev, seed, smi) -> list[dict]:
    """Phase 17: the mbv3 encoder with ``fused_frontend=True, fused_b1=True``
    (``FusedIRBlock``: b1_0's depthwise 3×3/2 at C = 72 on K2 / K4 with dx,
    b1_1's 3×3/1 at C = 88 on the depthwise mode of K1 / K3) at B=8
    512×640, random weights from the seed (BN perturbed), against the
    plain encoder on the same weights: an eval forward and a train forward
    + backward (loss Σ f3·r), every launch recorded and held against its
    plain version at phase 6's bounds, the launch counts the code's; f3
    within 0.04 of the plain encoder's largest value and b1's BN running
    statistics atol 0.03 / rtol 0.1 (``test_packed_chain.py:411-477``); the
    four new launches timed beside their bound, plain version and library
    call and split by device kernel; the b1 pair fused against plain
    (eval forward; train forward + backward): median, host issue, device
    busy. Returns the new launches' kernel entries."""
    from mmr_tpu_torch.models.encoders import get_encoder
    from mmr_tpu_torch.models.factory import init_weights
    from mmr_tpu_torch.models.fused_blocks import as_array
    from mmr_tpu_torch.models.fused_encoder import fused_stem
    from mmr_tpu_torch.models import get_preprocessing
    from mmr_tpu_torch.models.layers import nchw, nhwc

    t_phase = time.perf_counter()
    spec = get_encoder("tu-mobilenetv3_small_100")
    gen = torch.Generator().manual_seed(seed + 17)
    fused = init_weights(spec.build(fused_frontend=True, fused_b1=True), gen)
    perturb(fused, gen)
    plain = spec.build()
    plain.load_state_dict(fused.state_dict())
    fused, plain = fused.to(dev), plain.to(dev)
    pre = get_preprocessing("tu-mobilenetv3_small_100")
    img = torch.rand(TRAIN_BATCH, *ROI, 3, generator=gen).to(dev)
    x = nchw(pre(img).to(torch.bfloat16)).contiguous(memory_format=torch.channels_last)
    r3 = torch.randn(TRAIN_BATCH, ROI[0] // 8, ROI[1] // 8, 24, generator=gen).to(dev)

    def f3_rel(got, want):
        return ((got.float() - want.float()).abs().max()
                / want.float().abs().max()).item()

    cases = []
    for train in (False, True):
        mode = "train" if train else "eval"
        fused.train(train)
        plain.train(train)
        with recording() as (records, recorders), torch.set_grad_enabled(train):
            f3 = fused(x)[2]
            if train:
                (nhwc(f3).float() * r3).sum().backward()
            torch.cuda.synchronize()
        launches = {k: r.launches for k, r in recorders.items() if r.launches}
        want = B1_TRAIN if train else B1_EVAL
        print(f"[17] {mode}: launches {launches}", flush=True)
        check(launches == want, f"b1 {mode}: expected {want} launches")
        held = hold_records(17, records)
        with torch.no_grad():
            ref = plain(x)[2]
        rel = f3_rel(f3, ref)
        print(f"[17] {mode}: f3 {tuple(f3.shape)} vs the plain encoder: max |Δ| / "
              f"max {rel:.3e}", flush=True)
        check(rel < 0.04 and bool(torch.isfinite(f3).all()),
              f"b1 {mode}: f3 differs from the plain encoder's")
        if train:
            worst = 0.0
            for blk in ("b1_0", "b1_1"):
                for bn in ("bn1", "bn2", "bn3"):
                    for stat in ("running_mean", "running_var"):
                        a = getattr(getattr(getattr(fused, blk), bn), stat)
                        b = getattr(getattr(getattr(plain, blk), bn), stat)
                        worst = max(worst, (a - b).abs().max().item())
                        check(torch.allclose(a, b, atol=0.03, rtol=0.1),
                              f"b1 {blk}.{bn}.{stat} differs from the plain encoder's")
            grads = [q.grad for n, q in fused.named_parameters() if n.startswith("b1_")]
            check(all(g is not None and bool(torch.isfinite(g).all()) for g in grads),
                  "b1: a missing or non-finite gradient")
            print(f"[17] train: b1's BN running statistics vs the plain encoder's: "
                  f"worst max |Δ| {worst:.3e}; {len(grads)} b1 gradients finite",
                  flush=True)
            cases = held

    # ---- the new launches timed; the b1 pair fused vs plain -------------------
    new = [c for c in cases
           if (c["kind"] in ("K2", "K4") and c["args"]["x"].c == 72)
           or (c["kind"] in ("K1", "K3") and c["args"].get("depthwise"))]
    check(len(new) == 4, f"{len(new)} b1 launches, expected 4")
    time_cases(17, new)
    names = {"K2": "fused_conv_down (depthwise C=72, b1_0)",
             "K4": "fused_conv_down_bwd (depthwise C=72 with dx, b1_0)",
             "K1": "fused_conv (depthwise stride 1, C=88, b1_1)",
             "K3": "fused_conv_bwd (depthwise stride 1, C=88, b1_1)"}
    per = (f"one launch of the b1 pair's train step (B={TRAIN_BATCH}, "
           f"{ROI[0]}x{ROI[1]} image; fused_b1, off by default)")
    entries = []
    for c in new:
        e = kernel_entry(c["kind"], [c], 1, per)
        e["name"] = names[c["kind"]]
        e["device_ms"] = device_split(17, [c], c["kind"])
        entries.append(e)

    fused.eval()
    plain.eval()
    with torch.no_grad():
        f2 = fused.b0_0.fused(fused_stem(fused, x))
        x2 = as_array(f2)
    fused.train()
    plain.train()
    r = torch.randn(TRAIN_BATCH, ROI[0] // 8, ROI[1] // 8, 24, device=dev)

    def pair(enc, train):
        run = ((lambda: enc.b1_1.fused(enc.b1_0.fused(f2)).raw) if enc is fused
               else (lambda: nhwc(enc.b1_1(enc.b1_0(x2)))))
        if not train:
            def go():
                with torch.no_grad():
                    run()
            return go
        return lambda: (run().float() * r).sum().backward()

    times = {}
    for train in (False, True):
        for name, enc in (("fused", fused), ("plain", plain)):
            enc.train(train)
            key = f"{name} {'train' if train else 'eval'}"
            times[key] = _b1_time(17, f"{key} ({smi})", pair(enc, train))
    for e in entries:
        e["b1_pair"] = times
    print(f"[17] phase 17 took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return entries


# ------------------------------------------------------ 18. K6's dispatch table

K6_HOLD_BATCH = 2   # images a key is held at


def k6_table_phase(dev, seed) -> dict:
    """Phase 18: K6's per-shape dispatch table (``ops/conv_table.json``).
    It must hold both directions of every bf16 Conv3x3 shape the phases run
    and of JAX's bench shapes (``k6_table_keys``). One line a key: its
    route, the table's alternated-pair medians, gain and spread, and K6a's
    forward and dx and K6b under ``_FORCE`` on B=2 inputs, held against
    their plain versions at phase 7's bounds (max|Δ| / max|ref| printed).
    Returns
    {"keys", "kernel_keys", "held"}."""
    from mmr_tpu_torch.ops import conv3x3_packed as k6
    from mmr_tpu_torch.ops import dispatch

    t_phase = time.perf_counter()
    table = dispatch.table()
    entries = table["shapes"]
    keys = k6_table_keys(dev)
    missing = sorted(dispatch.shape_key(*k) for k in keys
                     if dispatch.shape_key(*k) not in entries)
    print(f"[18] conv_table.json: {len(entries)} keys, measured on {table['card']} "
          f"at {table['commit']} by {table['measured_by']}; the phases and JAX's "
          f"bench shapes need {len(keys)}, missing {missing}", flush=True)
    check(not missing, "the committed table lacks keys that the phases run")
    g = torch.Generator(device=dev).manual_seed(seed + 18)
    bf16, held = torch.bfloat16, 0
    for (h, w, cin, cout), where in sorted(keys.items()):
        key = dispatch.shape_key(h, w, cin, cout)
        x = torch.randn(K6_HOLD_BATCH, h, w, cin, device=dev, generator=g).to(bf16)
        wt = torch.randn(3, 3, cin, cout, device=dev, generator=g) / (9 * cin) ** 0.5
        b = 0.5 * torch.randn(cout, device=dev, generator=g)
        gy = torch.randn(K6_HOLD_BATCH, h, w, cout, device=dev, generator=g).to(bf16)
        for t in (x, wt, b):
            t.requires_grad_()
        with conv3x3_forced(True), recording() as (records, recorders):
            y = k6.conv3x3p_bias_act(x, wt, b, False, *k6.routes(x, cout))
            y.backward(gy)
            torch.cuda.synchronize()
        launches = {k: r.launches for k, r in recorders.items()}
        check(launches == _counts(K6a=2, K6b=1), f"{key}: launches {launches} "
              "under _FORCE, not a K6a forward and dx and a K6b")
        rels = []
        for kind, args, out, backward in records:
            with torch.no_grad():
                rels.append(_hold(kind, out, plain(kind)(**args), backward)[1])
        held += len(records)
        e = entries[key]
        print(f"[18] {key} ({'; '.join(where)}): route "
              f"{'K6a / K6b' if e['kernel_wins'] else 'library'}; medians of "
              f"{e['pairs']} alternated pairs at B={e['batch']}: kernel fwd "
              f"{e['kernel_fwd_ms']:.4f} ms, fwd+bwd {e['kernel_fwdbwd_ms']:.4f}; "
              f"library fwd {e['library_fwd_ms']:.4f}, fwd+bwd "
              f"{e['library_fwdbwd_ms']:.4f}; fwd+bwd gain "
              f"{e['fwdbwd_gain_ms']:.4f}, spread {e['fwdbwd_spread_ms']:.4f}; "
              f"under _FORCE at B={K6_HOLD_BATCH} "
              f"K6a fwd / K6a dx / K6b rel-to-max "
              f"{' / '.join(f'{r:.2e}' for r in rels)} ok", flush=True)
        del records, x, wt, b, gy, y
    kernel_keys = sorted(k for k, e in entries.items() if e["kernel_wins"])
    print(f"[18] {len(keys)} keys held ({held} launches); the table sends "
          f"{len(kernel_keys)} to K6a / K6b: {kernel_keys}; phase 18 wall time "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    torch.cuda.empty_cache()
    return {"keys": len(keys), "kernel_keys": kernel_keys, "held": held}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the weights and the synthetic frames")
    ap.add_argument("--mesh-rank", type=Path, default=None,
                    help=argparse.SUPPRESS)   # phase 15's ranks (a), (b)
    ap.add_argument("--cli-rank", type=Path, default=None,
                    help=argparse.SUPPRESS)   # phase 15's ranks (c), CLI args after --
    args, cli_args = ap.parse_known_args()

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    if args.mesh_rank is not None:
        mesh_rank(args.mesh_rank)
        return 0
    if args.cli_rank is not None:
        cli_rank(args.cli_rank, cli_args[1:] if cli_args[:1] == ["--"] else cli_args)
        return 0
    if cli_args:
        ap.error(f"unrecognized arguments: {' '.join(cli_args)}")

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
    flagship_counts(model)
    print(f"[1] the table's K6 launches of the flagship: a train step "
          f"{ {k: TRAIN_COUNTS[k] for k in ('K6a', 'K6b')} }, a forward "
          f"{ {k: EVAL_COUNTS[k] for k in ('K6a', 'K6b')} }", flush=True)
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
    want = forward_counts(1)
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
    with torch.inference_mode(), conv3x3_forced(False):
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
    path_a, entries, path_a_k6 = path_a_train_phase(dev, args.seed)
    evals = path_a_eval_phase(path_a, dev, args.seed, path_a_k6)
    k7_hold_phase(dev, args.seed)
    if "K6a" in evals:
        entries["K6a"].update({f"eval_{k}": evals["K6a"][k] for k in K6_FIELDS})
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
    path_a_cli_phase(dev, args.seed, path_a_k6)
    # ---- 12. Path B's Trainer ------------------------------------------------
    trained = trainer_phase(dev, args.seed, smi)
    for e in kernels:
        kind = next((k for k in FLAGSHIP if KERNELS[k][1] == e["name"]), None)
        if kind is not None:
            e["trainer_launches"] = trained["launches"][kind]
    # ---- 13. the reference's best published models ------------------------------
    published = published_phase(dev, args.seed, smi)
    for e in kernels:
        kind = next((k for k in KERNELS if KERNELS[k][1] == e["name"]), None)
        for name, pub in published.items():
            if kind in pub and "(dense dx)" not in e["name"]:
                e.setdefault("published", {})[name] = {
                    k: v for k, v in pub[kind].items()
                    if k not in ("name", "route", "source", "replaces")}
    k6_main_path(entries, published)
    # ---- 14. Path B from Zarr stores through its CLIs ----------------------------
    zarr = zarr_phase(dev, args.seed, smi, trained)
    for e in kernels:
        kind = next((k for k in FLAGSHIP if KERNELS[k][1] == e["name"]), None)
        if kind is not None:
            e["zarr_cli_launches"] = zarr[kind]
    # ---- 15. data parallelism over two ranks -------------------------------------
    meshed = mesh_phase(dev, args.seed, smi, train["inputs"], path_a_k6)
    for e in kernels:
        kind = next((k for k in KERNELS if KERNELS[k][1] == e["name"]), None)
        if kind in FLAGSHIP:
            e["mesh_launches_per_rank"] = meshed["launches"][kind]
        elif kind in ("K6a", "K6b", "K7"):
            e["mesh_cli_launches_rank0"] = meshed["cli_launches"][kind]
    # ---- 16. Path B's data entry: host decoders, mmr_torch_create_dataset -------
    converted = native_data_phase(dev, args.seed, smi)
    for e in kernels:
        kind = next((k for k in FLAGSHIP if KERNELS[k][1] == e["name"]), None)
        if kind is not None:
            e["converted_cli_launches"] = converted[kind]
    # ---- 17. the fused b1 pair ----------------------------------------------------
    kernels += b1_phase(dev, args.seed, smi)
    # ---- 18. K6's dispatch table -------------------------------------------------
    table = k6_table_phase(dev, args.seed)
    for kind in ("K6a", "K6b"):
        entries[kind]["table_keys_held"] = table["keys"]
        entries[kind]["table_kernel_keys"] = table["kernel_keys"]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": 1}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
