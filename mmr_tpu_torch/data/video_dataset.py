"""Whole-video temporal batching for inference (counterpart of
``mmr_tpu/data/video_dataset.py``), the reference's ``SegTestDataset``
(``Pre_Process.py:1150-1293``): an index of ``(video, t0, t1)`` windows
of ``infer_batch_size`` consecutive frames per video; each item is a
full-resolution frame batch (T, H, W, 3) in the store dtype and its masks
(T, H, W). An item's chunks decode on the store's thread pool at once (a
full-HD frame at 512×640 chunks is 9 image and 9 mask chunks)."""

from __future__ import annotations

from pathlib import Path

from mmr_tpu_torch.data.zarr_io import VideoStore


class VideoFrameDataset:
    def __init__(self, store_paths: list[str | Path], infer_batch_size: int = 4):
        self.stores = [VideoStore(p) for p in store_paths]
        self.names = [Path(p).name.replace(".zarr", "") for p in store_paths]
        self.infer_batch_size = int(infer_batch_size)
        self.index: list[tuple[int, int, int]] = []
        for vi, s in enumerate(self.stores):
            n = s.shape[0]
            for t0 in range(0, n, self.infer_batch_size):
                self.index.append((vi, t0, min(t0 + self.infer_batch_size, n)))

    def __len__(self):
        return len(self.index)

    def __getitem__(self, i: int) -> dict:
        vi, t0, t1 = self.index[i]
        img, mask = self.stores[vi].read_frames(t0, t1)
        return {"id": self.names[vi], "t0": t0, "t1": t1, "image": img, "mask": mask}

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]
