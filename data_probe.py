#!/usr/bin/env python3
"""Measure what sets the rate of the port's Path B data path, on one NVIDIA card.

    python3 data_probe.py [--steps 50] [--threads 1 4 8] [--epoch-threads N ...]
                          [--seed 0] [--fixture-only]

Writes ``chip_smoke.py``'s phase-14 dataset under a temporary directory
(``ZARR_VIDEOS`` uint8 videos and one float32 store of ``ZARR_FRAMES``
full-HD frames, 512×640 chunks, gzip level ``zarr_io.GZIP_LEVEL``; every
later read finds the files in the page cache, so the reads are warm),
then measures in one process:

1. inflate: one stored 512×640 image chunk of each dtype, decoded by
   ``zlib`` on one thread (MB/s of output, the best of 5 rounds of 8), and
   8 copies a thread decoded on the chunk pool at each ``--threads`` count
   (the pool's MB/s of output);
2. the ``PatchSampler`` alone at B=8, 512×640, the default augmentation's
   initial patch, each dtype, the chunk pool at each ``--threads`` count:
   samples/s over ``SAMPLER_BATCHES`` batches, and MB/s of chunks decoded
   (the bytes counted in a second, untimed pass);
3. the ``Trainer`` at the flagship's defaults (``get_default_config(9,
   (512, 640))``), the chunk pool at its default size: one epoch of
   ``--steps`` train + 2 val batches for each of a fixed pool of rendered
   512×640 frames (``chip_smoke.PoolSampler``), the uint8 stores, the
   float32 store and the fixed pool again, after a 2-step warm-up epoch:
   epoch s and samples/s (the monitor's), the host's time in the train
   step's calls; then, for each ``--epoch-threads`` count, the uint8 and
   float32 epochs again with the chunk pool held to that many threads;
4. blosc-zstd against gzip: the committed stores JAX's ``VideoStore``
   wrote (``tests/torch_fixtures/blosc``: blosc, zstd clevel 3,
   bitshuffle; float32 and uint8, the small 64×80-chunked pairs and one
   full-size (3, 1, 512, 640) chunk of a decoded Motion-JPEG frame each)
   and the port's gzip copies of the same arrays — MB/s of output of one
   image chunk decoded on one thread (the host decoder, and ``zlib`` for
   the copy; the best of 5 rounds of 8), of whole-array reads on the chunk
   pool at each ``--threads`` count (chunk files warm in the page cache),
   and the ``PatchSampler``'s samples/s over each (B=8; 64×64 patches, a
   whole chunk's 512×640 on the full-size stores). ``--fixture-only``
   runs this part alone.

Prints the card's name and power limit first and one JSON object of every
number last. Needs ``chip_smoke.py`` beside it and one card.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import tempfile
import time
import zlib
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

SAMPLER_BATCHES = 12   # batches timed per dtype and thread count
BLOSC_STORES = {       # part 4: the fixture's blosc-zstd stores of each kind
    "f32": ["f32_a", "f32_b"], "u8": ["u8_a", "u8_b"],
    "f32_full": ["f32_full"], "u8_full": ["u8_full"],
}
WARMUP_STEPS, VAL_STEPS = 2, 2


def inflate_rates(store: Path, threads) -> dict:
    """MB/s of output: one chunk on one thread, then on pools of ``threads``."""
    from mmr_tpu_torch.data import zarr_io

    arr = zarr_io.ZarrArray(store / "image")
    data = (store / "image" / "c" / "0" / "0" / "0" / "0").read_bytes()
    n = int(np.prod(arr.chunks)) * arr.dtype.itemsize
    best = min(_timed(lambda: [zlib.decompress(data, 31, n) for _ in range(8)])
               for _ in range(5))
    out = {"chunk_mb": n / 1e6, "stored_mb": len(data) / 1e6,
           "one_thread_mb_s": 8 * n / 1e6 / best, "pool_mb_s": {}}
    for k in threads:
        with ThreadPoolExecutor(k) as pool:
            list(pool.map(lambda _: zlib.decompress(data, 31, n), range(k)))   # warm
            dt = _timed(lambda: list(pool.map(lambda _: zlib.decompress(data, 31, n),
                                              range(8 * k))))
        out["pool_mb_s"][k] = 8 * k * n / 1e6 / dt
    return out


def _timed(fn) -> float:
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def sampler_rates(stores, initial, threads, seed) -> dict:
    """samples/s and MB/s of chunks decoded at each pool size."""
    import chip_smoke as cs
    from mmr_tpu_torch.data import zarr_io
    from mmr_tpu_torch.data.patch_dataset import PatchSampler

    sampler = PatchSampler(stores, cs.ROI, cs.TRAIN_BATCH, SAMPLER_BATCHES,
                           initial_patch_size=initial, seed=seed)
    decoded = cs.sampler_decoded_bytes(sampler, seed)
    out = {"mb_a_batch": decoded / 1e6 / SAMPLER_BATCHES, "samples_s": {}, "mb_s": {}}
    for k in threads:
        zarr_io.set_pool_threads(k)
        dt = _timed(lambda: [None for _ in sampler.epoch(epoch_seed=seed)])
        out["samples_s"][k] = SAMPLER_BATCHES * cs.TRAIN_BATCH / dt
        out["mb_s"][k] = decoded / 1e6 / dt
    zarr_io.set_pool_threads(zarr_io.POOL_THREADS)
    return out


def blosc_rates(tmp, threads, seed) -> dict:
    """Part 4: per dtype, the fixture's blosc-zstd stores against gzip
    copies: one chunk on one thread, whole reads on the pool, the sampler."""
    import chip_smoke as cs
    from mmr_tpu_torch.data import hostlib, zarr_io
    from mmr_tpu_torch.data.patch_dataset import PatchSampler

    out = {}
    for kind, names in BLOSC_STORES.items():
        src = [cs.FIXTURES / "blosc" / f"{name}.zarr" for name in names]
        dst = [cs.gzip_copy(p, Path(tmp) / "fixture_gzip" / p.name) for p in src]
        arr = zarr_io.ZarrArray(src[0] / "image")
        patch = tuple(arr.chunks[2:]) if kind.endswith("_full") else (64, 64)
        n = math.prod(arr.chunks) * arr.dtype.itemsize
        first = ("image", "c", "0", "0", "0", "0")
        blosc, gz = (p.joinpath(*first).read_bytes() for p in (src[0], dst[0]))
        buf = np.empty(n, np.uint8)
        one = {"blosc": lambda: hostlib.blosc_decompress_into(blosc, buf),
               "gzip": lambda: zlib.decompress(gz, 31, n)}
        r = out[kind] = {"chunk": list(arr.chunks), "chunk_mb": n / 1e6, "patch": list(patch),
                         "stored_mb": {"blosc": len(blosc) / 1e6, "gzip": len(gz) / 1e6},
                         "one_thread_mb_s": {}, "pool_mb_s": {}, "sampler_samples_s": {}}
        for codec, fn in one.items():
            best = min(_timed(lambda: [fn() for _ in range(8)]) for _ in range(5))
            r["one_thread_mb_s"][codec] = 8 * n / 1e6 / best
        for codec, paths in (("blosc", src), ("gzip", dst)):
            r["pool_mb_s"][codec] = cs.chunk_decode_rates(paths[0] / "image", threads)
            sampler = PatchSampler(paths, patch, cs.TRAIN_BATCH, SAMPLER_BATCHES, seed=seed)
            per = r["sampler_samples_s"][codec] = {}
            for k in threads:
                zarr_io.set_pool_threads(k)
                list(sampler.epoch(epoch_seed=seed))
                dt = _timed(lambda: [None for _ in sampler.epoch(epoch_seed=seed)])
                per[k] = SAMPLER_BATCHES * cs.TRAIN_BATCH / dt
        zarr_io.set_pool_threads(zarr_io.POOL_THREADS)
    return out


def trainer_epoch(dev, tmp, name, train_s, val_s, seed) -> dict:
    """One epoch of a fresh flagship ``Trainer`` over the given samplers."""
    import torch

    import chip_smoke as cs
    from mmr_tpu_torch.config import get_default_config
    from mmr_tpu_torch.train.engine import Trainer

    cfg = get_default_config(cs.N_CLASSES - 1, cs.ROI)
    cfg.update(results_path=f"{tmp}/{name}", patch_size=list(cs.ROI), n_epochs=1,
               seed=seed)
    tr = Trainer(cfg, device=dev)
    step, step_s = tr._train_step, []

    def timed_step(*a):   # the host's time in the step call, the issue included
        t0 = time.perf_counter()
        out = step(*a)
        step_s.append(time.perf_counter() - t0)
        return out

    tr._train_step = timed_step
    hist = tr.train(train_s, val_s)
    torch.cuda.synchronize()
    del tr
    torch.cuda.empty_cache()
    return {"epoch_s": hist["epoch_time_s"][0], "samples_s": hist["samples_per_sec"][0],
            "step_calls_s": sum(step_s), "train_loss": hist["train_loss"][0]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=50, help="train batches an epoch")
    ap.add_argument("--threads", type=int, nargs="+", default=[1, 4, 8],
                    help="chunk pool sizes for the inflate and sampler rates")
    ap.add_argument("--epoch-threads", type=int, nargs="*", default=[],
                    help="chunk pool sizes for further Zarr epochs")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--fixture-only", action="store_true",
                    help="run part 4 (blosc-zstd against gzip) alone")
    args = ap.parse_args()
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

    import torch

    if not torch.cuda.is_available():
        print("data_probe: CUDA is not available", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from mmr_tpu_torch.data import zarr_io
    from mmr_tpu_torch.data.augment import AugmentConfig
    from mmr_tpu_torch.data.patch_dataset import PatchSampler
    from mmr_tpu_torch.data.synthetic import make_synthetic_dataset, render_frame
    from mmr_tpu_torch.ops import _build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(f"host: {os.cpu_count()} cores, {len(os.sched_getaffinity(0))} usable; "
          f"chunk pool default {zarr_io.POOL_THREADS} threads", flush=True)
    dev = torch.device("cuda")
    result = {"card": smi}
    with tempfile.TemporaryDirectory() as tmp:
        r = result["blosc_vs_gzip"] = blosc_rates(tmp, args.threads, args.seed)
        for kind, x in r.items():
            print(f"{smi}: fixture {kind} image chunk {x['chunk']} ({x['chunk_mb']:.3f} MB; "
                  f"stored {x['stored_mb']['blosc']:.3f} MB blosc-zstd, "
                  f"{x['stored_mb']['gzip']:.3f} MB gzip), warm: one thread "
                  + ", ".join(f"{c} {v:.1f}" for c, v in x["one_thread_mb_s"].items())
                  + " MB/s; whole reads on the pool "
                  + "; ".join(f"{c} " + ", ".join(f"{k} threads {v:.1f}"
                                                  for k, v in x["pool_mb_s"][c].items())
                              for c in x["pool_mb_s"]) + " MB/s; PatchSampler (B="
                  f"{cs.TRAIN_BATCH}, {x['patch'][0]}x{x['patch'][1]}) "
                  + "; ".join(f"{c} " + ", ".join(f"{k} threads {v:.1f}"
                                                  for k, v in x["sampler_samples_s"][c].items())
                              for c in x["sampler_samples_s"]) + " samples/s", flush=True)
        if args.fixture_only:
            print(json.dumps(result), flush=True)
            return 0
        _build.library()
        t0 = time.perf_counter()
        ds = make_synthetic_dataset(f"{tmp}/ds", cs.ZARR_VIDEOS, cs.ZARR_FRAMES, *cs.FRAME,
                                    cs.N_CLASSES - 1, cs.ROI, args.seed + 14, np.uint8)
        f32 = make_synthetic_dataset(f"{tmp}/f32", 1, cs.ZARR_FRAMES, *cs.FRAME,
                                     cs.N_CLASSES - 1, cs.ROI, args.seed + 15, np.float32)
        print(f"datasets written in {time.perf_counter() - t0:.1f} s", flush=True)
        stores = {"uint8": zarr_io.list_dataset_stores(ds),
                  "float32": zarr_io.list_dataset_stores(f32)}
        initial = AugmentConfig(patch_size=cs.ROI, low_resolution=False).initial_patch_size

        for name, paths in stores.items():
            r = result[f"inflate_{name}"] = inflate_rates(paths[0], args.threads)
            print(f"{smi}: inflate, one {name} image chunk ({r['chunk_mb']:.2f} MB, "
                  f"{r['stored_mb']:.2f} MB stored): one thread "
                  f"{r['one_thread_mb_s']:.1f} MB/s; pool "
                  + ", ".join(f"{k} threads {v:.1f}" for k, v in r["pool_mb_s"].items())
                  + " MB/s", flush=True)
        for name, paths in stores.items():
            r = result[f"sampler_{name}"] = sampler_rates(paths, initial, args.threads,
                                                          args.seed)
            print(f"{smi}: PatchSampler ({name}, B={cs.TRAIN_BATCH}, {initial[0]}x"
                  f"{initial[1]}, {r['mb_a_batch']:.1f} MB of chunks a batch): "
                  + ", ".join(f"{k} threads {r['samples_s'][k]:.1f} samples/s "
                              f"({r['mb_s'][k]:.1f} MB/s)" for k in args.threads),
                  flush=True)

        rng = np.random.RandomState(args.seed + 12)
        frames = [render_frame(rng, *cs.ROI, cs.N_CLASSES - 1)
                  for _ in range(cs.TRAINER_POOL)]
        images = np.stack([(f[0] * 255.0 + 0.5).astype(np.uint8) for f in frames])
        masks = np.stack([f[1] for f in frames])

        def samplers(kind, steps):
            if kind == "pool":
                return (cs.PoolSampler(images, masks, steps),
                        cs.PoolSampler(images, masks, VAL_STEPS))
            return (PatchSampler(stores[kind], cs.ROI, cs.TRAIN_BATCH, steps,
                                 initial_patch_size=initial, seed=args.seed),
                    PatchSampler(stores[kind], cs.ROI, cs.TRAIN_BATCH, VAL_STEPS,
                                 oversample_foreground_percent=0.0, seed=args.seed + 1))

        trainer_epoch(dev, tmp, "warmup", *samplers("pool", WARMUP_STEPS), args.seed)
        runs = result["epochs"] = []
        plan = [(kind, zarr_io.POOL_THREADS)
                for kind in ("pool", "uint8", "float32", "pool")]
        plan += [(kind, n) for n in args.epoch_threads for kind in ("uint8", "float32")]
        for i, (kind, threads) in enumerate(plan):
            zarr_io.set_pool_threads(threads)
            r = trainer_epoch(dev, tmp, f"run{i}", *samplers(kind, args.steps), args.seed)
            runs.append(dict(r, source=kind, pool_threads=threads))
            print(f"{smi}: epoch of {args.steps} + {VAL_STEPS} batches from {kind}"
                  f"{'' if kind == 'pool' else f' ({threads} pool threads)'}: "
                  f"{r['epoch_s']:.3f} s, {r['samples_s']:.2f} samples/s; the train "
                  f"step calls {r['step_calls_s']:.3f} s of it; train loss "
                  f"{r['train_loss']:.5f}", flush=True)
        zarr_io.set_pool_threads(zarr_io.POOL_THREADS)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
