#!/usr/bin/env python3
"""Time K5a, K7 and K8a of the port found under a tree, on one NVIDIA card.

    python3 chip_probe.py TREE [--only K5a|K7|K8a|eval|K2bits|epilogue|conv_table ...]
                          [--no-hold] [--write] [--commit SHA]

TREE holds an ``mmr_tpu_torch`` package: this checkout (``.``) or another
version of it unpacked beside (``git archive <commit> mmr_tpu_torch``), so
that two versions of the kernels are compared inside one process launch
each, on one card. ``chip_smoke.py``'s helpers (``_hold``, ``time_cases``,
``device_split``, ``graph_ms``, ``_k8_run``) come from this file's
directory. Measured:

- K5a (``head_loss_fwd``) at the flagship train step's launch: B = 8,
  512×640, 16 input channels (BN + ReLU pending), 10 classes, int64
  labels, with and without ``with_conf``: held against its plain version
  (unless ``--no-hold``: builds cut down to find what bounds a kernel
  compute wrong values), timed with its wrapper (CUDA events), from a CUDA
  graph's replays, and split by device kernel;
- K7 (``confusion_stats``) at phase 8's launch (4×256×256 int64 argmax
  ids against uint8 masks, 10 classes) and on a 1080×1920 pair of uint8
  ids against int64 masks: held exactly, timed with its wrapper, from a
  CUDA graph's replays, and split by device event (the counting kernel,
  and where a version has them its memset and its finalize kernel);
- K8a (``conv3x3_shift``, forward and dx under ``conv3x3_bias_act``) at
  ``chip_smoke.py``'s phase-10 shapes, held, timed, split and replayed
  from a CUDA graph;
- the Path-A eval batch (``eval``): ``evaluate_checkpoint`` of an
  ``smp_UNet++`` (random weights, BN perturbed) over one 4×256×256 batch
  with the blended loss: median, host issue, device busy and idle share
  (``chip_smoke.py``'s ``_timed_steps``).

- ``K2bits`` (asked for by name only): the sha256 of K2's depthwise outputs
  (y and its moments) and of K4's (dx, dW, d scale, d shift, dbias) at C
  = 8, 16, 32 and 64 on one seeded B=8 256×320 input each (hardswish
  prologue, a bias, the moments' cotangent), so that two trees' kernels
  show whether they compute the same bits.

- ``epilogue`` (asked for by name only): the device time of the two
  kernels other than K3 that run ``csrc/common.cuh``'s ``wg_epilogue``:
  K5b (``head_loss_bwd``) at the K5a probe's inputs, and K6a
  (``conv3x3``, forward) at four of ``smp_UNet++``'s decoder shapes (B=8,
  64² to 256², 128 → 64 down to 32 → 16 channels), so that two trees
  show what a change to the epilogue costs them.

- ``conv_table`` (asked for by name only): the tuner of K6's per-shape
  dispatch (``mmr_tpu_torch/ops/dispatch.py``). At every key of
  ``chip_smoke.py``'s ``k6_table_keys`` (both directions of every bf16
  ``Conv3x3`` shape the smoke phases run, and of JAX's
  ``bench_conv_kernel.py`` shapes) it times what a ``Conv3x3`` runs there
  with ReLU on, at B = 8: the forward (no grad) and the forward +
  backward (dx, dW, dbias), with ``conv3x3_packed._FORCE`` True (K6a /
  K6b) and False (the library conv). Each sample is the CUDA-event time of
  ``TUNE_REPS`` calls, wrapper included; the two routes are timed in
  ``TUNE_PAIRS`` pairs whose first call alternates. Each entry keeps the
  medians, the forward + backward gain (the median over the pairs of the
  library's sample less the kernel's), its spread (the interquartile range
  of those differences) and ``kernel_wins``: the kernel's forward +
  backward median below the library's, and the gain above its spread, so
  that a difference the pairs cannot tell from noise keeps the library
  conv. ``--write`` merges the entries into
  ``ops/conv_table.json`` with the card's name and power limit and
  ``--commit``, and lists the keys whose verdict differs from the table
  it replaces.

``--only`` picks what is timed (the first four by default).

A package older than the narrow tile (``head_loss.head_grid`` missing) has
its kernels named by their own device names (``head_loss_fwd_kernel``,
``conv_wg_kernel``). Prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time


def k7_probe(cs, tree, dev, no_hold):
    """K7 at phase 8's launch and on a full-HD pair: the masks rendered as
    ``chip_smoke.py`` renders them, the ids the masks with a tenth of the
    pixels redrawn in [0, nc]."""
    import numpy as np
    import torch

    from mmr_tpu_torch.data.synthetic import render_frame
    from mmr_tpu_torch.ops import confusion

    rng = np.random.RandomState(11)
    nc = cs.N_CLASSES

    def maps(n, h, w, pred_dt, gt_dt):
        gt = np.stack([render_frame(rng, h, w, nc - 1)[1] for _ in range(n)])
        pred = np.where(rng.rand(*gt.shape) < 0.1,
                        rng.randint(0, nc + 1, gt.shape), gt)
        return (torch.from_numpy(pred).to(dev, pred_dt),
                torch.from_numpy(gt).to(dev, gt_dt))

    for label, (pred, gt) in (
            ("phase 8", maps(cs.EVAL_BATCH, *cs.PATH_A_HW, torch.int64, torch.uint8)),
            ("1080x1920", maps(1, *cs.FRAME, torch.uint8, torch.int64))):
        kw = dict(pred_ids=pred, gt_ids=gt, num_classes=nc)
        out = confusion.confusion_stats(**kw)
        if not no_hold:
            cs._hold("K7", out, confusion.confusion_stats_ref(**kw))
        ops, nbytes, peak = cs._work("K7", kw, out)
        case = {"kind": "K7", "label": label, "args": kw, "max_abs": 0.0,
                "ops_ms": ops / peak * 1e3, "bytes_ms": nbytes / cs.PEAK_BYTES * 1e3}
        cs.time_cases("K7", [case])
        gms = cs.graph_ms(lambda: confusion.confusion_stats(**kw))
        print(f"[{tree}] K7 {label} {tuple(pred.shape)} {str(pred.dtype)[6:]} / "
              f"{str(gt.dtype)[6:]}: {case['ms']:.4f} ms with the wrapper, "
              f"{gms:.4f} ms a call from a CUDA graph", flush=True)
        cs.device_split("K7", [case], "K7")


def eval_probe(cs, tree, dev):
    """The Path-A eval batch, phase 8's timing of it."""
    import contextlib
    import functools
    import io

    import numpy as np
    import torch

    from mmr_tpu_torch.infer.evaluator import evaluate_checkpoint
    from mmr_tpu_torch.losses import blended_ce_dice_loss
    from mmr_tpu_torch.models import create_model

    gen = torch.Generator().manual_seed(1)
    model = create_model("smp_UNet++", classes=cs.N_CLASSES, device=dev, generator=gen)
    cs.perturb(model, gen)
    batch = cs._path_a_batch(np.random.RandomState(2), cs.EVAL_BATCH)
    loss_fn = functools.partial(blended_ce_dice_loss, dice_loss_factor=0.5)

    def run():
        with contextlib.redirect_stdout(io.StringIO()):
            evaluate_checkpoint(model, [batch], cs.N_CLASSES, loss_fn=loss_fn,
                                device=dev)

    run()
    med = cs._timed_steps(f"{tree} eval", run, 10)
    print(f"[{tree}] Path-A eval batch {cs.EVAL_BATCH}x{cs.PATH_A_HW[0]}x"
          f"{cs.PATH_A_HW[1]}: median {med:.3f} ms", flush=True)


def k2_bits(tree, dev):
    """Print the sha256 of K2's and K4's depthwise outputs at the widths
    before the tile took any multiple of 8 (see ``K2bits`` above)."""
    import hashlib

    import torch

    from mmr_tpu_torch.ops.fused_conv import (Pending, fused_conv_down,
                                              fused_conv_down_bwd)

    def digest(*ts):
        h = hashlib.sha256()
        for t in ts:
            h.update(t.detach().contiguous().view(-1).view(torch.uint8).cpu()
                     .numpy().tobytes())
        return h.hexdigest()[:16]

    for c in (8, 16, 32, 64):
        g = torch.Generator(device=dev).manual_seed(c)
        rand = lambda *shape: torch.randn(*shape, device=dev, generator=g)
        x = Pending(rand(8, 256, 320, c).to(torch.bfloat16),
                    torch.rand(c, device=dev, generator=g) + 0.5,
                    0.3 * rand(c), "hswish")
        w, b = 0.3 * rand(3, 3, 1, c), rand(c)
        y, mom = fused_conv_down(x, w, b, True, emit_moments=True)
        dy, dmom = rand(*y.shape).to(torch.bfloat16), 1e-3 * rand(2, c)
        dx, dw, dpro, db = fused_conv_down_bwd(x, w, y, dy, dmom, True, True, True)
        torch.cuda.synchronize()
        print(f"[{tree}] K2 depthwise C={c}: y and moments {digest(y, mom)}; "
              f"K4 dx, dW, dscale, dshift, dbias {digest(dx, dw, *dpro, db)}",
              flush=True)


EPILOGUE_K6A = [(8, 64, 64, 128, 64), (8, 128, 128, 128, 64),
               (8, 256, 256, 64, 32), (8, 256, 256, 32, 16)]   # B, H, W, Cin, Cout


def epilogue_probe(cs, tree, dev, x, wt, bias, labels):
    """Device time of K5b and K6a (see the module's docstring)."""
    import torch

    from mmr_tpu_torch.ops import head_loss as hl
    from mmr_tpu_torch.ops.conv3x3_packed import conv3x3

    g = torch.Generator(device=dev).manual_seed(11)
    logp, stats, _ = hl.head_loss_fwd(x, wt, bias, labels, True)
    kw = dict(x=x, w=wt, logp=logp, labels=labels,
              dstats=torch.randn(stats.shape, device=dev, generator=g))
    ms = cs.cuda_ms(lambda: hl.head_loss_bwd(**kw), cs.REPS)
    print(f"[{tree}] K5b: {ms:.4f} ms with the wrapper", flush=True)
    cs.device_split("K5b", [{"kind": "K5b", "label": "flagship", "args": kw,
                             "ms": ms}], "K5b")
    cases = []
    for b, h, w, ci, co in EPILOGUE_K6A:
        kw = dict(x=torch.randn(b, h, w, ci, device=dev, generator=g).to(
                      torch.bfloat16),
                  w=0.1 * torch.randn(3, 3, ci, co, device=dev, generator=g),
                  bias=0.1 * torch.randn(co, device=dev, generator=g), relu=True)
        ms = cs.cuda_ms(lambda: conv3x3(**kw), cs.REPS)
        cases.append({"kind": "K6a", "label": f"{h}x{w} {ci}->{co}",
                      "args": kw, "ms": ms})
        print(f"[{tree}] K6a {h}x{w} {ci}->{co}: {ms:.4f} ms with the wrapper",
              flush=True)
    cs.device_split("K6a", cases, "K6a")


TUNE_BATCH, TUNE_PAIRS, TUNE_REPS = 8, 16, 5


def tune_key(cs, dev, gen, h, w, cin, cout) -> dict:
    """One table entry: what a ``Conv3x3`` runs (``conv3x3_layer``, ReLU
    on) on both routes, forward and forward + backward, over alternated
    pairs (ms a call, wrapper included): the medians, the forward +
    backward gain and its spread, and the verdict."""
    import torch

    from mmr_tpu_torch.ops import conv3x3_packed as k6

    bf16 = torch.bfloat16
    x = torch.randn(TUNE_BATCH, h, w, cin, device=dev, generator=gen).to(bf16)
    x.requires_grad_()
    wt = torch.randn(cout, cin, 3, 3, device=dev, generator=gen) / (9 * cin) ** 0.5
    wt.requires_grad_()
    b = torch.zeros(cout, device=dev, requires_grad=True)
    gy = torch.randn(TUNE_BATCH, h, w, cout, device=dev, generator=gen).to(bf16)

    def fwd():
        with torch.no_grad():
            k6.conv3x3_layer(x, wt, b, True)

    def fwdbwd():
        torch.autograd.grad(k6.conv3x3_layer(x, wt, b, True), (x, wt, b), gy)

    times = {(r, p): [] for r in ("kernel", "library") for p in ("fwd", "fwdbwd")}
    try:
        for force in (True, False):
            k6._FORCE = force
            for _ in range(2):
                fwd(), fwdbwd()
        for i in range(TUNE_PAIRS):
            for part, fn in (("fwd", fwd), ("fwdbwd", fwdbwd)):
                for force in (True, False) if i % 2 == 0 else (False, True):
                    k6._FORCE = force
                    route = "kernel" if force else "library"
                    times[route, part].append(cs.cuda_ms(fn, TUNE_REPS, warmup=0))
    finally:
        k6._FORCE = None
    med = {k: sorted(v)[len(v) // 2] for k, v in times.items()}
    diff = sorted(lib - ker for ker, lib in zip(times["kernel", "fwdbwd"],
                                                times["library", "fwdbwd"]))
    gain = diff[len(diff) // 2]
    spread = diff[3 * len(diff) // 4] - diff[len(diff) // 4]
    entry = {"batch": TUNE_BATCH, "pairs": TUNE_PAIRS, "reps": TUNE_REPS}
    for (route, part), t in med.items():
        entry[f"{route}_{part}_ms"] = round(t, 5)
    entry["fwdbwd_gain_ms"] = round(gain, 5)
    entry["fwdbwd_spread_ms"] = round(spread, 5)
    entry["kernel_wins"] = (med["kernel", "fwdbwd"] < med["library", "fwdbwd"]
                            and gain > spread)
    return entry


def conv_table(cs, dev, smi, write, commit):
    """The ``conv_table`` tuner (module docstring)."""
    import torch

    from mmr_tpu_torch.ops import dispatch

    t0 = time.time()
    keys = cs.k6_table_keys(dev)
    print(f"[conv_table] {len(keys)} keys in {time.time() - t0:.1f} s", flush=True)
    old = dispatch.table()["shapes"]
    gen = torch.Generator(device=dev).manual_seed(17)
    results = {}
    for (h, w, cin, cout), where in sorted(keys.items()):
        key = dispatch.shape_key(h, w, cin, cout)
        entry = tune_key(cs, dev, gen, h, w, cin, cout)
        entry["where"] = where
        results[key] = entry
        print(f"[conv_table] {key}: kernel fwd {entry['kernel_fwd_ms']:.4f} ms, "
              f"fwd+bwd {entry['kernel_fwdbwd_ms']:.4f}; library fwd "
              f"{entry['library_fwd_ms']:.4f}, fwd+bwd "
              f"{entry['library_fwdbwd_ms']:.4f}; fwd+bwd gain "
              f"{entry['fwdbwd_gain_ms']:.4f} (spread "
              f"{entry['fwdbwd_spread_ms']:.4f}); kernel_wins "
              f"{entry['kernel_wins']} ({', '.join(where)})", flush=True)
        torch.cuda.empty_cache()
    flipped = sorted(k for k, e in results.items()
                     if k in old and old[k]["kernel_wins"] != e["kernel_wins"])
    wins = sorted(k for k, e in results.items() if e["kernel_wins"])
    print(f"[conv_table] {smi}: kernel wins at {len(wins)} of {len(results)} "
          f"keys: {wins}", flush=True)
    print(f"[conv_table] verdicts that differ from the table replaced "
          f"({len(flipped)}): {flipped}", flush=True)
    print(f"[conv_table] tuned in {time.time() - t0:.1f} s", flush=True)
    if write:
        dispatch.record(results, card=smi, commit=commit,
                        measured_by="chip_probe.py --only conv_table",
                        flipped_from_previous=flipped)
        print(f"[conv_table] written to {dispatch.TABLE_PATH}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("tree", help="directory holding the mmr_tpu_torch package")
    ap.add_argument("--only", nargs="+",
                    choices=("K5a", "K7", "K8a", "eval", "K2bits", "epilogue",
                             "conv_table"),
                    default=("K5a", "K7", "K8a", "eval"), help="what to time")
    ap.add_argument("--no-hold", action="store_true",
                    help="time without holding against the plain version")
    ap.add_argument("--write", action="store_true",
                    help="conv_table: merge the entries into ops/conv_table.json")
    ap.add_argument("--commit", default="not given",
                    help="conv_table: the commit measured, kept in the table")
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:0] = [tree, here]

    import torch

    if not torch.cuda.is_available():
        print("chip_probe: CUDA is not available", file=sys.stderr)
        return 1
    import chip_smoke as cs
    import mmr_tpu_torch
    from mmr_tpu_torch.ops import _build
    from mmr_tpu_torch.ops import head_loss as hl
    from mmr_tpu_torch.ops.fused_conv import Pending

    if not mmr_tpu_torch.__file__.startswith(tree):
        raise RuntimeError(f"imported {mmr_tpu_torch.__file__}, not {tree}")
    if not hasattr(hl, "head_grid"):   # the kernels before the narrow tile
        cs.PARTS["K5a"] = {"head_loss_fwd_kernel": "head"}
        cs.PARTS["K8a"] = {"conv_wg_kernel": None}
        cs.persistent_grid = lambda kind, a: None
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    t0 = time.time()
    _build.library()
    print(f"[{tree}] built in {time.time() - t0:.1f} s", flush=True)

    dev = torch.device("cuda")
    if "conv_table" in args.only:
        conv_table(cs, dev, smi, args.write, args.commit)
    g = torch.Generator(device=dev).manual_seed(3)
    b, h, w, c, nc = cs.TRAIN_BATCH, *cs.ROI, 16, cs.N_CLASSES
    x = Pending(torch.randn(b, h, w, c, device=dev, generator=g).to(torch.bfloat16),
                torch.rand(c, device=dev, generator=g) + 0.5,
                0.3 * torch.randn(c, device=dev, generator=g), "relu")
    wt = 0.3 * torch.randn(3, 3, c, nc, device=dev, generator=g)
    bias = 0.1 * torch.randn(nc, device=dev, generator=g)
    labels = torch.randint(0, nc, (b, h, w), device=dev, generator=g)
    for conf in (True, False) if "K5a" in args.only else ():
        kw = dict(x=x, w=wt, bias=bias, labels=labels, with_conf=conf)
        if not args.no_hold:
            with torch.no_grad():
                cs._hold("K5a", hl.head_loss_fwd(**kw), hl.head_loss_fwd_ref(**kw))
        ms = cs.cuda_ms(lambda: hl.head_loss_fwd(**kw), cs.REPS)
        gms = cs.graph_ms(lambda: hl.head_loss_fwd(**kw))
        print(f"[{tree}] K5a with_conf={conf}: {ms:.4f} ms with the wrapper, "
              f"{gms:.4f} ms a call from a CUDA graph", flush=True)
        cs.device_split("K5a", [{"kind": "K5a", "label": f"conf={conf}",
                                 "args": kw, "ms": ms}], "K5a")
    if "K2bits" in args.only:
        k2_bits(tree, dev)
    if "epilogue" in args.only:
        epilogue_probe(cs, tree, dev, x, wt, bias, labels)
    if "K7" in args.only:
        k7_probe(cs, tree, dev, args.no_hold)
    if "eval" in args.only:
        eval_probe(cs, tree, dev)
    gen = torch.Generator(device=dev).manual_seed(5)
    k8 = [(torch.bfloat16, cs.K8_SHAPE)] + cs.K8_EXTRA if "K8a" in args.only else []
    for dtype, shape in k8:
        recs, _ = cs._k8_run(dev, gen, dtype, shape)
        if args.no_hold:
            cases = []
            for kind, kw, out, backward in (r for r in recs if r[0] == "K8a"):
                ops, nbytes, peak = cs._work(kind, kw, out)
                cases.append({"kind": kind, "args": kw,
                              "label": f"#{len(cases) + 1}" + (" dx" if backward else ""),
                              "ops_ms": ops / peak * 1e3,
                              "bytes_ms": nbytes / cs.PEAK_BYTES * 1e3})
        else:
            cases = [cc for cc in cs.hold_records(10, recs) if cc["kind"] == "K8a"]
        del recs
        cs.time_cases(10, cases)
        print(f"[{tree}] K8a {str(dtype)[6:]} {shape}", flush=True)
        cs.device_split(10, cases, "K8a")
        for cc in cases:
            gms = cs.graph_ms(lambda: cs.wrapper("K8a")(**cc["args"]))
            print(f"[{tree}] K8a {cc['label']} {gms:.4f} ms a call from a "
                  "CUDA graph", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
