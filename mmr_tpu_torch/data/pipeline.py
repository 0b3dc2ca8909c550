"""Host-to-device feeding with background prefetch (counterpart of
``mmr_tpu/data/pipeline.py``).

The reference overlaps CPU augmentation with GPU compute through
DataLoader workers and pinned memory (``Pre_Process.py:1137-1145``). Here
the augmentation runs on the device inside the train step, so the host
only assembles batches: :class:`PrefetchIterator` keeps ``depth`` of them
in flight on one thread, and :class:`DeviceTransfer` copies each through
pinned host memory on a side CUDA stream, so that the copy overlaps the
previous step's work.
"""

from __future__ import annotations

import logging
import queue
import threading
from typing import Callable, Iterable, Iterator

import numpy as np
import torch


class PrefetchIterator:
    """Wraps a host batch iterator; runs ``transfer`` on each batch ahead of
    use on a worker thread, and ``ready`` (if given) on the consumer's side
    before handing it out. An exception in the worker is raised to the
    consumer; :meth:`close` releases the worker and the staged batches."""

    _SENTINEL = object()

    def __init__(self, source: Iterable, transfer: Callable, depth: int = 2,
                 ready: Callable | None = None):
        self.source = iter(source)
        self.transfer = transfer
        self.ready = ready
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self._error = None
        self._closed = threading.Event()
        self.thread = threading.Thread(target=self._worker, daemon=True)
        self.thread.start()

    def _put(self, item) -> bool:
        """A bounded put that gives up once the iterator is closed (a
        consumer that stopped must not leave the worker blocked holding
        ``depth`` batches)."""
        while not self._closed.is_set():
            try:
                self.q.put(item, timeout=0.5)
                return True
            except queue.Full:
                continue
        return False

    def _worker(self):
        try:
            for item in self.source:
                if not self._put(self.transfer(item)):
                    return
        except BaseException as e:  # surfaced on the consumer's side
            self._error = e
        finally:
            self._put(self._SENTINEL)

    def close(self):
        """Release the worker thread and any staged batches."""
        self._closed.set()
        while True:  # drain so that a blocked put can finish
            try:
                self.q.get_nowait()
            except queue.Empty:
                break
        self.thread.join(timeout=5.0)
        while True:  # what the worker put before it saw the close
            try:
                self.q.get_nowait()
            except queue.Empty:
                break

    def __del__(self):
        self._closed.set()

    def __iter__(self) -> Iterator:
        while True:
            item = self.q.get()
            if item is self._SENTINEL:
                if self._error is not None:
                    raise self._error
                return
            yield self.ready(item) if self.ready is not None else item


class DeviceTransfer:
    """A host batch (a tuple of numpy arrays or CPU tensors) to ``device``.
    On CUDA, :meth:`__call__` (the worker's side) copies each array through
    pinned memory with ``non_blocking=True`` on a side stream and records an
    event; :meth:`ready` (the consumer's side) makes the current stream
    wait on that event and records the tensors on it, so that the caching
    allocator does not hand their memory out while the consumer's work
    still reads it. On the CPU the tensors are the arrays."""

    def __init__(self, device: str | torch.device):
        self.device = torch.device(device)
        self.stream = (torch.cuda.Stream(self.device)
                       if self.device.type == "cuda" else None)

    def __call__(self, item):
        host = tuple(torch.as_tensor(np.ascontiguousarray(a)) for a in item)
        if self.stream is None:
            return host, None
        with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
            out = tuple(t.pin_memory().to(self.device, non_blocking=True) for t in host)
            event = torch.cuda.Event()
            event.record(self.stream)
        return out, event

    def ready(self, staged):
        out, event = staged
        if event is not None:
            current = torch.cuda.current_stream(self.device)
            current.wait_event(event)
            for t in out:
                t.record_stream(current)
        return out


def microbatch_stacker(batch_iter: Iterable, n_accum: int):
    """Group ``n_accum`` sampler batches into one stacked (n_accum, B, ...)
    step input (the reference's grad-accumulation cadence,
    ``Main_MMR_SegModel.py:718``)."""
    imgs, masks = [], []
    for im, mk in batch_iter:
        imgs.append(im)
        masks.append(mk)
        if len(imgs) == n_accum:
            yield np.stack(imgs), np.stack(masks)
            imgs, masks = [], []
    if imgs:
        logging.getLogger("mmr_tpu_torch").warning(
            "microbatch_stacker dropped %d trailing sampler batch(es): "
            "steps_per_epoch %% grad_accumulate_step != 0", len(imgs))
