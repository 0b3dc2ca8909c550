"""Foreground-oversampled patch sampling over Zarr video stores
(counterpart of ``mmr_tpu/data/patch_dataset.py``): the training
distribution of the reference's ``SegTrainingDataset`` +
``CustomBatchSampler`` (``Pre_Process.py:538-1082``) as one host-side
sampler.

- a fixed ``steps_per_epoch`` whatever the dataset's size (250 train / 50
  val, ``Pre_Process.py:1131-1134``);
- every sample is visited once before any repeats (``:1032-1062``);
- foreground forcing is positional: the last 33 % of each batch is centred
  on a stored foreground voxel of a random class (nnU-Net style,
  ``:787-806``), or drawn per sample (``probabilistic``, ``:808-826``);
- the bbox math is ``get_bbox``'s (``:828-885``): pad-aware uniform corner,
  foreground-centred corners clamped into bounds;
- patch reads decode only the chunks a window touches.

The draws come from one ``np.random.RandomState`` in the JAX sampler's
order (the permutation, then per sample the probabilistic coin, the bbox
corner, the class and the voxel), so over the same stores and seeds the
batches are the JAX sampler's, bit for bit.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from mmr_tpu_torch.data.zarr_io import VideoStore


class PatchSampler:
    def __init__(
        self,
        store_paths: list[str | Path],
        patch_size: tuple[int, int],
        batch_size: int,
        steps_per_epoch: int,
        oversample_foreground_percent: float = 0.33,
        oversample_strategy: str = "deterministic",  # | 'probabilistic'
        initial_patch_size: tuple[int, int] | None = None,
        seed: int = 6210,
    ):
        if not store_paths:
            raise ValueError("no stores given")
        self.stores = [VideoStore(p) for p in store_paths]
        dtypes = {np.dtype(s.image_dtype) for s in self.stores}
        if len(dtypes) > 1:
            # the batch buffer takes stores[0]'s dtype: a mixed f32 / uint8
            # dataset would truncate or mis-scale the other stores
            raise ValueError(
                f"stores mix image dtypes {sorted(map(str, dtypes))}; "
                "reconvert the dataset with one --image_dtype")
        self.patch_size = tuple(int(p) for p in patch_size)
        self.initial_patch_size = tuple(int(p) for p in (initial_patch_size or patch_size))
        self.batch_size = int(batch_size)
        self.steps_per_epoch = int(steps_per_epoch)
        self.oversample_foreground_percent = float(oversample_foreground_percent)
        self.oversample_strategy = oversample_strategy
        self.rng = np.random.RandomState(seed)
        # (store_idx, frame_idx) global sample index
        self.samples = [
            (si, t) for si, s in enumerate(self.stores) for t in range(s.shape[0])
        ]
        self._perm: list[int] = []
        # each store's class_locations grouped by frame once, classes
        # sorted: a class draw is an index into this order
        self._class_locs: list[dict[int, dict[int, list]]] = []
        for s in self.stores:
            by_frame: dict[int, dict[int, list]] = {}
            for c, coords in s.class_locations.items():
                for (tt, y, x) in coords:
                    by_frame.setdefault(int(tt), {}).setdefault(
                        int(c), []).append((y, x))
            self._class_locs.append(
                {t: dict(sorted(d.items())) for t, d in by_frame.items()})

    # --------------------------------------------------------------- sampler
    def _next_sample_indices(self, n: int) -> list[int]:
        """Every sample used once before repetition (Pre_Process.py:1032-1062)."""
        out = []
        while len(out) < n:
            if not self._perm:
                self._perm = list(self.rng.permutation(len(self.samples)))
            out.append(self._perm.pop())
        return out

    def _force_fg(self, position_in_batch: int) -> bool:
        if self.oversample_foreground_percent <= 0:
            return False
        if self.oversample_strategy == "probabilistic":
            return bool(self.rng.uniform() < self.oversample_foreground_percent)
        # deterministic: the last 33 % of batch positions (Pre_Process.py:787-806)
        return position_in_batch >= round(
            self.batch_size * (1 - self.oversample_foreground_percent))

    def _get_bbox(self, data_shape, force_fg: bool, frame_locs) -> tuple[int, int]:
        """2-D ``get_bbox`` of nnU-Net (Pre_Process.py:828-885)."""
        dim = 2
        patch = self.initial_patch_size
        need_to_pad = [max(0, patch[d] - data_shape[d]) for d in range(dim)]
        lbs = [-need_to_pad[i] // 2 for i in range(dim)]
        ubs = [data_shape[i] + need_to_pad[i] // 2 + need_to_pad[i] % 2 - patch[i]
               for i in range(dim)]
        bbox = [int(self.rng.randint(lbs[i], ubs[i] + 1)) for i in range(dim)]
        if force_fg and frame_locs:
            eligible = [c for c, v in frame_locs.items() if len(v) > 0]
            if eligible:
                cls = eligible[self.rng.randint(len(eligible))]
                voxels = frame_locs[cls]
                vy, vx = voxels[self.rng.randint(len(voxels))]
                for i, v in enumerate((vy, vx)):
                    bbox[i] = max(lbs[i], min(int(v) - patch[i] // 2, ubs[i]))
        return bbox[0], bbox[1]

    def _frame_locations(self, store_idx: int, t: int) -> dict[int, list]:
        return self._class_locs[store_idx].get(int(t), {})

    # ----------------------------------------------------------------- epoch
    def epoch(self, epoch_seed: int | None = None, part: slice | None = None):
        """Yield ``steps_per_epoch`` batches of (images (B, h, w, 3) in the
        STORE dtype — uint8 0..255 for compact stores, f32 [0, 1] for the
        reference schema — masks (B, h, w) u8), (h, w) the initial patch.

        ``part`` (a data-parallel rank's ``local_batch_slice``): every
        draw of the global batch is made, in the same order, but only the
        windows of the batch positions in ``part`` are read, and the
        batches hold those samples alone.

        A batch's window reads all start before any is awaited, and the
        next batch's start before this one is yielded: their chunks decode
        and pad on the chunk pool (``zarr_io.set_pool_threads`` sizes it),
        which stands in for the reference's loader processes. An epoch
        read to its end leaves the sampler where JAX's leaves it; one left
        early has drawn one batch more."""
        if epoch_seed is not None:
            self.rng = np.random.RandomState(epoch_seed)
        iph, ipw = self.initial_patch_size
        keep = range(self.batch_size)[part or slice(None)]

        def start_batch():
            """Draw one batch's windows (every draw in order, on the
            caller's thread) and start the reads of those in ``part``."""
            finishers = []
            for pos, sample_idx in enumerate(self._next_sample_indices(self.batch_size)):
                si, t = self.samples[sample_idx]
                frame_locs = (self._frame_locations(si, t)
                              if self._force_fg(pos) else None)
                y0, x0 = self._get_bbox(self.stores[si].shape[1:],
                                        frame_locs is not None, frame_locs)
                if pos in keep:
                    finishers.append(self.stores[si].read_windows_async(
                        t, y0, x0, iph, ipw))
            return finishers

        pending = start_batch() if self.steps_per_epoch > 0 else None
        for step in range(self.steps_per_epoch):
            finishers = pending
            # the next batch's chunks decode while this one is assembled
            pending = start_batch() if step + 1 < self.steps_per_epoch else None
            imgs = np.empty((len(keep), iph, ipw, 3), self.stores[0].image_dtype)
            masks = np.empty((len(keep), iph, ipw), np.uint8)
            for pos, finish in enumerate(finishers):
                imgs[pos], masks[pos] = finish()
            yield imgs, masks

    def __len__(self):
        return self.steps_per_epoch
