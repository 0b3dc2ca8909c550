"""The confusion kernel K7 (:func:`confusion_stats`): per-class tp, fp, fn
of two class-id maps, and its plain PyTorch version.

Counterpart of ``mmr_tpu/ops/pallas/confusion.py::confusion_stats`` (the
Pallas kernel behind ``metrics/evaluate.py::Evaluate.add_batch``). The
contract is the Pallas kernel's: an id outside ``[0, num_classes)`` counts
nowhere (its padding sentinels −1 / −2 are such ids). ``confusion_stats_xla``
is not followed: it would wrap such ids through negative indices.

The kernel (``mmr_tpu_torch/csrc/confusion.cu``) reads the maps in the
dtypes they come in (uint8, int32 or int64) and counts in integers, so the
result is exact and the same from run to run. It is one launch a call: its
scratch (an accumulator of counts and a ticket) is made once per device,
class count and stream, zeroed, and left zeroed by every launch. The wrapper launches it for CUDA tensors and runs the plain
version for CPU tensors; any other device raises.
``confusion_stats.launches`` counts launches.
"""

from __future__ import annotations

import torch

from mmr_tpu_torch.ops import _build
from mmr_tpu_torch.ops.fused_conv import _launch_device, _raise_on

MAX_CLASSES = 128
_KIND = {torch.uint8: 0, torch.int32: 1, torch.int64: 2}
# (device index, num_classes, stream) -> the kernel's scratch: 3·C counts
# and a ticket, u32, zero between launches. One per stream: launches on
# two streams may overlap, launches on one stream never do.
_SCRATCH: dict[tuple[int, int, int], torch.Tensor] = {}


def confusion_stats_ref(pred_ids: torch.Tensor, gt_ids: torch.Tensor,
                        num_classes: int, total: torch.Tensor | None = None):
    """Plain version of :func:`confusion_stats`: per-class compares of the
    flattened maps (the Pallas kernel's unrolled compare + reduce)."""
    classes = torch.arange(num_classes, device=pred_ids.device)
    p = pred_ids.reshape(-1, 1).long() == classes
    g = gt_ids.reshape(-1, 1).long() == classes
    tp = (p & g).sum(0)
    fp, fn = p.sum(0) - tp, g.sum(0) - tp
    if total is not None:
        total += torch.stack([tp, fp, fn])
        return total
    return tp.float(), fp.float(), fn.float()


def _scratch(device: torch.device, num_classes: int, stream: int) -> torch.Tensor:
    key = (device.index, num_classes, stream)
    if key not in _SCRATCH:
        _SCRATCH[key] = torch.zeros(3 * num_classes + 1, dtype=torch.int32,
                                    device=device)
    return _SCRATCH[key]


def confusion_stats(pred_ids: torch.Tensor, gt_ids: torch.Tensor,
                    num_classes: int, total: torch.Tensor | None = None):
    """Per-class ``(tp, fp, fn)``, each ``(num_classes,)`` f32, of two
    integer class-id maps of the same shape (uint8, int32 or int64).

    With ``total`` (int64 ``(3, num_classes)`` on the maps' device) the
    counts ``[tp; fp; fn]`` are added into it instead, and ``total`` is
    returned: no output is allocated and nothing is read back."""
    if pred_ids.shape != gt_ids.shape:
        raise ValueError(f"id maps differ in shape: {tuple(pred_ids.shape)} "
                         f"vs {tuple(gt_ids.shape)}")
    if not 1 <= num_classes <= MAX_CLASSES:
        raise ValueError(f"num_classes must be in [1, {MAX_CLASSES}]")
    for t in (pred_ids, gt_ids):
        if t.dtype not in _KIND:
            raise ValueError(f"id maps must be uint8, int32 or int64, got {t.dtype}")
    device = pred_ids.device
    if gt_ids.device != device:
        raise ValueError(f"id maps on {device} and {gt_ids.device}")
    if total is not None and (total.shape != (3, num_classes)
                              or total.dtype != torch.int64
                              or total.device != device
                              or not total.is_contiguous()):
        raise ValueError(f"total must be a contiguous int64 (3, {num_classes}) "
                         f"tensor on {device}")
    if not _launch_device(device):
        return confusion_stats_ref(pred_ids, gt_ids, num_classes, total)

    pred, gt = pred_ids.contiguous(), gt_ids.contiguous()
    stream = torch.cuda.current_stream(device).cuda_stream
    out = (torch.empty((3, num_classes), dtype=torch.float32, device=device)
           if total is None else None)
    err = _build.library().mmr_confusion(
        pred.data_ptr(), _KIND[pred.dtype], gt.data_ptr(), _KIND[gt.dtype],
        pred.numel(), num_classes, _scratch(device, num_classes, stream).data_ptr(),
        None if out is None else out.data_ptr(),
        None if total is None else total.data_ptr(), stream)
    _raise_on(err, "confusion_stats")
    confusion_stats.launches += 1
    return total if out is None else (out[0], out[1], out[2])


confusion_stats.launches = 0
