"""Sliding-window inference — MONAI ``sliding_window_inference`` semantics,
counterpart of ``mmr_tpu/infer/sliding_window.py``.

A MONAI dense window grid (interval roi·(1−overlap), last window flush with
the edge), a Gaussian (σ = 0.125·roi, min-clipped) or constant importance
map, and a weighted blend accumulated in f32 and divided by the weight sum,
which is input-independent and built on the host once per grid.
"""

from __future__ import annotations

import numpy as np
import torch

from mmr_tpu_torch.core.device import resolve_device
from mmr_tpu_torch.core.mesh import shard_batch


def _window_starts(image_size: int, roi: int, overlap: float) -> list[int]:
    """MONAI's dense_patch_slices start grid: interval = roi·(1-overlap),
    last window clamped flush with the image edge."""
    if roi >= image_size:
        return [0]
    interval = max(1, int(roi * (1.0 - overlap)))
    starts = [min(s, image_size - roi)
              for s in range(0, image_size - roi + interval, interval)]
    return sorted(set(starts))


def gaussian_importance_map(roi: tuple[int, int],
                            sigma_scale: float = 0.125) -> np.ndarray:
    """Centered 2-D Gaussian with σ = sigma_scale·roi, min-clipped to its
    smallest positive value."""
    h, w = roi
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    sy, sx = sigma_scale * h, sigma_scale * w
    yy = np.exp(-0.5 * ((np.arange(h) - cy) / sy) ** 2)
    xx = np.exp(-0.5 * ((np.arange(w) - cx) / sx) ** 2)
    m = np.outer(yy, xx).astype(np.float32)
    return np.clip(m, m[m > 0].min(), None)


def sliding_window_inference(inputs: torch.Tensor, predictor,
                             roi: tuple[int, int], num_classes: int,
                             sw_batch_size: int = 24, overlap: float = 0.5,
                             mode: str = "gaussian",
                             compute_dtype: torch.dtype = torch.float32,
                             fuse_blend: bool = False) -> torch.Tensor:
    """``inputs`` (N, H, W, C) -> blended logits (N, H, W, num_classes) f32.

    ``predictor``: ``(B, rh, rw, C) -> (B, rh, rw, num_classes)`` tensor.
    ``compute_dtype``: dtype the window logits are rounded to before the
    blend; the blend accumulates in f32 either way.

    ``fuse_blend``: each frame's whole window grid is one predictor batch,
    blended as soon as it returns. ``sw_batch_size`` is then ignored.
    Without it, the windows of all frames form one stream cut into
    ``sw_batch_size`` chunks (the last one padded by repeating its final
    window). Both give the same result for a batch-independent predictor.
    """
    n, h, w, c = inputs.shape
    rh, rw = min(roi[0], h), min(roi[1], w)
    coords = [(y, x) for y in _window_starts(h, rh, overlap)
              for x in _window_starts(w, rw, overlap)]
    if mode == "gaussian":
        imp_np = gaussian_importance_map((rh, rw))
    elif mode == "constant":
        imp_np = np.ones((rh, rw), np.float32)
    else:
        raise ValueError(f"unknown blend mode {mode!r}")
    wsum = np.zeros((h, w, 1), np.float32)
    for y, x in coords:
        wsum[y:y + rh, x:x + rw, 0] += imp_np
    dev = inputs.device
    inv_wsum = torch.from_numpy(1.0 / np.maximum(wsum, 1e-8)).to(dev)
    imp = torch.from_numpy(imp_np)[..., None].to(dev)

    def predict(windows):
        lg = predictor(windows)
        # the blend takes final logits only: a plain tensor of one logit
        # vector per window pixel (never a Pending raw surface)
        want = (windows.shape[0], rh, rw, num_classes)
        if not isinstance(lg, torch.Tensor) or tuple(lg.shape) != want:
            raise TypeError(f"predictor must return a {want} tensor, got "
                            f"{type(lg).__name__} {getattr(lg, 'shape', '')}")
        return lg.to(compute_dtype)

    def blend(lg):
        out = torch.zeros((h, w, num_classes), dtype=torch.float32, device=dev)
        for k, (y, x) in enumerate(coords):
            out[y:y + rh, x:x + rw] += lg[k].float() * imp
        return out * inv_wsum

    def windows_at(fyx):
        return torch.stack([inputs[f, y:y + rh, x:x + rw] for f, y, x in fyx])

    if fuse_blend:
        return torch.stack([blend(predict(windows_at([(i, y, x) for y, x in coords])))
                            for i in range(n)])

    stream = [(f, y, x) for f in range(n) for y, x in coords]
    n_total = len(stream)
    stream += stream[-1:] * (-n_total % sw_batch_size)
    logits = torch.cat([predict(windows_at(stream[i:i + sw_batch_size]))
                        for i in range(0, len(stream), sw_batch_size)])
    logits = logits[:n_total].reshape(n, len(coords), rh, rw, num_classes)
    return torch.stack([blend(logits[i]) for i in range(n)])


def make_sliding_window_fn(model, roi, num_classes: int,
                           sw_batch_size: int = 24, overlap: float = 0.5,
                           mode: str = "gaussian", preprocess=None,
                           compute_dtype: torch.dtype = torch.float32,
                           fuse_blend: bool = False, device=None, mesh=None):
    """Bind a model into a frame-batch predictor ``(N, H, W, 3) -> (N, H, W,
    num_classes)`` f32 logits on ``device`` (default CUDA). Frames may be a
    numpy array or a tensor; uint8 frames are scaled by 1/255 on the
    device.

    With a multi-rank ``mesh`` (in place of ``device``) the frame axis is
    split over the ranks (``sliding_window.py:275-290``): each rank takes
    its N / ranks frames of the N it is given (N must divide), blends its
    own frames' windows on ``mesh.device`` with no collective and returns
    its frames' logits; :func:`~mmr_tpu_torch.core.mesh.gather_batch`
    gives every frame's to a caller that needs them."""
    if mesh is not None and device is not None:
        raise ValueError("pass device or mesh, not both")
    dev = mesh.device if mesh is not None else resolve_device(device)

    @torch.inference_mode()
    def run(frames):
        x = (shard_batch(mesh, torch.as_tensor(frames)) if mesh is not None
             else torch.as_tensor(frames).to(dev))
        if x.dtype == torch.uint8:
            x = x.float() / 255.0
        if preprocess is not None:
            x = preprocess(x)
        return sliding_window_inference(
            x.to(compute_dtype), model, tuple(roi), num_classes,
            sw_batch_size=sw_batch_size, overlap=overlap, mode=mode,
            compute_dtype=compute_dtype, fuse_blend=fuse_blend)

    return run
