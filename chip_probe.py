#!/usr/bin/env python3
"""Time K5a and K8a of the port found under a tree, on one NVIDIA card.

    python3 chip_probe.py TREE [--k5-only] [--no-hold]

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
- K8a (``conv3x3_shift``, forward and dx under ``conv3x3_bias_act``) at
  ``chip_smoke.py``'s phase-10 shapes, held, timed, split and replayed
  from a CUDA graph (not with ``--k5-only``).

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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("tree", help="directory holding the mmr_tpu_torch package")
    ap.add_argument("--k5-only", action="store_true", help="K5a only")
    ap.add_argument("--no-hold", action="store_true",
                    help="time without holding against the plain version")
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
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    t0 = time.time()
    _build.library()
    print(f"[{tree}] built in {time.time() - t0:.1f} s", flush=True)

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(3)
    b, h, w, c, nc = cs.TRAIN_BATCH, *cs.ROI, 16, cs.N_CLASSES
    x = Pending(torch.randn(b, h, w, c, device=dev, generator=g).to(torch.bfloat16),
                torch.rand(c, device=dev, generator=g) + 0.5,
                0.3 * torch.randn(c, device=dev, generator=g), "relu")
    wt = 0.3 * torch.randn(3, 3, c, nc, device=dev, generator=g)
    bias = 0.1 * torch.randn(nc, device=dev, generator=g)
    labels = torch.randint(0, nc, (b, h, w), device=dev, generator=g)
    for conf in (True, False):
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
    if args.k5_only:
        return 0
    gen = torch.Generator(device=dev).manual_seed(5)
    for dtype, shape in [(torch.bfloat16, cs.K8_SHAPE)] + cs.K8_EXTRA:
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
