#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``mmr_tpu_torch``) on one NVIDIA card.

The serving path of the UNet++/MobileNetV3 flagship at full width
(10 classes, 3,714,090 random weights from ``--seed``, BN perturbed away
from identity): full-HD 1080×1920 sliding-window inference, roi 512×640,
overlap 0.5, Gaussian blend, bf16, 6-frame temporal batches.

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

Prints a ``{"kernels": [...]}`` line, then, last,
``{"ok": true, "device": {...}}``. Any failed check exits non-zero with no
result line, as does a machine without CUDA. Run: ``python3 chip_smoke.py``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 tensor-core rate
PEAK_BYTES = 3.35e12       # H100 SXM HBM3 rate
ROI = (512, 640)
FRAME = (1080, 1920)
N_CLASSES = 10
VIDEOS, FRAMES, BATCH = 2, 12, 6   # serving: videos x frames, frames per chunk
REPS = 20                          # timed repetitions


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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the weights and the synthetic frames")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1

    import mmr_tpu_torch.models.fused_blocks as fb
    import mmr_tpu_torch.models.fused_encoder as fe
    from mmr_tpu_torch.data.synthetic import render_frame
    from mmr_tpu_torch.infer.evaluator import run_inference
    from mmr_tpu_torch.infer.sliding_window import (_window_starts,
                                                    make_sliding_window_fn)
    from mmr_tpu_torch.models import create_model, get_preprocessing
    from mmr_tpu_torch.ops import _build
    from mmr_tpu_torch.ops.resize import upsample2x
    from mmr_tpu_torch.ops.fused_conv import (activated, fused_conv,
                                              fused_conv_down,
                                              fused_conv_down_ref,
                                              fused_conv_ref)

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
    records = []

    def recorder(kind, fn):
        def wrapped(*a, **kw):
            y = fn(*a, **kw)
            records.append((kind, a, kw, y))
            return y
        return wrapped

    fused_conv.launches = fused_conv_down.launches = 0
    fb.fused_conv = recorder("K1", fused_conv)
    fe.fused_conv_down = recorder("K2", fused_conv_down)
    try:
        with torch.inference_mode():
            logits_f = model(windows)
        torch.cuda.synchronize()
    finally:
        fb.fused_conv, fe.fused_conv_down = fused_conv, fused_conv_down
    n1, n2 = fused_conv.launches, fused_conv_down.launches
    print(f"[3] launches per window-batch forward: K1 {n1}, K2 {n2}", flush=True)
    check(n1 == 21 and n2 == 2, f"expected 21 K1 and 2 K2 launches, got {n1}, {n2}")
    labels = {"K1": iter(k1_labels(model.packed_min_hw)),
              "K2": iter(["stem", "b0_0.conv_dw"])}

    cases = []
    with torch.inference_mode():
        for kind, a, kw, y in records:
            label = next(labels[kind])
            if kind == "K1":
                inputs, parts, bias = a
                ref = fused_conv_ref(inputs, parts, bias)
            else:
                ref = fused_conv_down_ref(*a, **kw)
            d = (y.float() - ref.float()).abs()
            max_abs = d.max().item()
            rel = max_abs / max(ref.float().abs().max().item(), 1e-6)
            ok = bool(torch.allclose(y.float(), ref.float(), atol=2e-2, rtol=2e-2))
            cases.append({"kind": kind, "label": label, "args": a, "kw": kw,
                          "y": y, "max_abs": max_abs, "rel_to_max": rel})
            shape = tuple(y.shape)
            print(f"[2] {kind} {label:14s} out {shape} max_abs {max_abs:.3e} "
                  f"max_abs/max|ref| {rel:.3e} {'ok' if ok else 'MISMATCH'}",
                  flush=True)
            check(ok, f"{kind} {label} disagrees with its plain version")

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
    def k1_library(inputs, parts, bias):
        xs = [activated(p) for p in inputs]
        xs = [upsample2x(x) if p.up2x else x for x, p in zip(xs, inputs)]
        x = torch.cat(xs, -1).to(torch.bfloat16).permute(0, 3, 1, 2)
        w = torch.cat(parts, 2).permute(3, 2, 0, 1).to(torch.bfloat16)
        w = w.contiguous(memory_format=torch.channels_last)
        b = None if bias is None else bias.to(torch.bfloat16)
        return lambda: F.conv2d(x, w, b, padding=1)

    def k2_library(x, w, bias=None, depthwise=False):
        a = activated(x).to(torch.bfloat16).permute(0, 3, 1, 2)
        wo = w.permute(3, 2, 0, 1).to(torch.bfloat16)
        wo = wo.contiguous(memory_format=torch.channels_last)
        return lambda: F.conv2d(a, wo, None, stride=2, padding=1,
                                groups=x.c if depthwise else 1)

    def work(c):
        y = c["y"]
        out_b = y.numel() * 2
        if c["kind"] == "K1":
            inputs, parts, bias = c["args"]
            cin = sum(p.c for p in inputs)
            flops = 2 * y.numel() * 9 * cin
            in_b = sum(p.raw.numel() * 2 + (8 * p.c if p.scale is not None else 0)
                       for p in inputs)
            w_b = 9 * cin * y.shape[-1] * 2 + (0 if bias is None else 4 * bias.numel())
        else:
            x, w = c["args"][:2]
            dwise = c["kw"].get("depthwise", False)
            flops = 2 * y.numel() * 9 * (1 if dwise else x.c)
            in_b = x.raw.numel() * 2 + (8 * x.c if x.scale is not None else 0)
            w_b = w.numel() * 2
        t_ops = flops / PEAK_BF16_FLOPS * 1e3
        t_bytes = (in_b + w_b + out_b) / PEAK_BYTES * 1e3
        return t_ops, t_bytes

    with torch.inference_mode():
        for c in cases:
            a, kw = c["args"], c["kw"]
            if c["kind"] == "K1":
                kern = lambda a=a: fused_conv(*a)
                plain = lambda a=a: fused_conv_ref(*a)
                lib = k1_library(*a)
            else:
                kern = lambda a=a, kw=kw: fused_conv_down(*a, **kw)
                plain = lambda a=a, kw=kw: fused_conv_down_ref(*a, **kw)
                lib = k2_library(*a, **kw)
            c["ms"] = cuda_ms(kern, REPS)
            c["plain_ms"] = cuda_ms(plain, max(3, REPS // 4))
            c["library_ms"] = cuda_ms(lib, REPS)
            t_ops, t_bytes = work(c)
            c["bound_ms"] = max(t_ops, t_bytes)
            c["ops_ms"], c["bytes_ms"] = t_ops, t_bytes
            c["bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
            print(f"[5] {c['kind']} {c['label']:14s} ms {c['ms']:.4f} plain "
                  f"{c['plain_ms']:.4f} library {c['library_ms']:.4f} bound "
                  f"{c['bound_ms']:.4f} ({c['bound_by']})", flush=True)

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

    kernels = []
    spec = {"K1": ("fused_conv", "mmr_tpu_torch/csrc/fused_conv.cu",
                   "mmr_tpu/ops/pallas/packed_chain.py:1070", s1),
            "K2": ("fused_conv_down", "mmr_tpu_torch/csrc/fused_conv_down.cu",
                   "mmr_tpu/ops/pallas/packed_chain.py:1786", s2)}
    for kind, (name, src, repl, launches) in spec.items():
        cs = [c for c in cases if c["kind"] == kind]
        tot = lambda k: sum(c[k] for c in cs)
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": repl,
            "launches": launches,
            "max_abs_err": max(c["max_abs"] for c in cs),
            "ms": tot("ms"), "plain_ms": tot("plain_ms"),
            "bound_ms": tot("bound_ms"),
            "bound_by": "operations" if tot("ops_ms") >= tot("bytes_ms") else "bytes",
            "library_ms": tot("library_ms"),
            "per": "sum over the launches of one 20-window forward"})
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
