"""The fused segmentation head + DiceCE loss: K5a (:func:`head_loss_fwd`)
and its backward K5b (:func:`head_loss_bwd`), their plain PyTorch
versions, the autograd function that joins them
(:func:`fused_head_loss`) and :func:`assemble_dice_ce`.

Counterparts of ``mmr_tpu/ops/pallas/packed_chain.py::fused_head_loss``
(its custom VJP) and ``::assemble_dice_ce``. The head conv (3×3 + bias over
the BN + relu pending top feature) and the loss statistics run in one
kernel (``mmr_tpu_torch/csrc/head_loss.cu``; K5a on the narrow tile of
``csrc/narrow_tile.cuh``, its per-block rows added in a fixed order, so
the statistics are the same bits on every launch): the NHWC logits and
d(logits) never reach device memory, only the bf16 log-prob surface the
backward re-reads. Per sample and class the forward sums
``[Σp, Σonehot, Σp·onehot, Σce]`` (p the per-pixel-stabilized softmax, ce
= onehot·(lse − logit)) and, with ``with_conf``, the first-max argmax
confusion ``conf[pred, label]``; labels outside ``[0, nc)`` count in no
onehot and no confusion entry.

Wrappers launch for CUDA tensors, run the plain versions for CPU tensors
and count ``.launches``; the plain versions take ``dtype`` as in
:mod:`mmr_tpu_torch.ops.fused_conv`.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from mmr_tpu_torch.losses.dice_ce import SMOOTH
from mmr_tpu_torch.ops import _build
from mmr_tpu_torch.ops.fused_conv import (ACTS, BF16, Pending, _cached_pack,
                                          _check_bias, _check_grad,
                                          _check_pending, _dx_taps,
                                          _launch_device, _narrow_frags,
                                          _pack_taps, _raise_on, _round,
                                          _stream, _wg_tile, activated,
                                          fused_conv_bwd_ref)


def _onehot(labels: torch.Tensor, nc: int) -> torch.Tensor:
    classes = torch.arange(nc, device=labels.device)
    return (labels.long()[..., None] == classes).float()


# ------------------------------------------------------------------ K5a

# the label types K5a reads as they come (the C entry's label kinds)
LABEL_KINDS = {torch.uint8: 0, torch.int32: 1, torch.int64: 2}


def head_k16(c: int) -> int:
    """K5a's 16-channel K steps at ``c`` input channels: one stage of 16
    channels, or 32-channel chunks (two steps each) above 16."""
    return 1 if c <= 16 else 2 * -(-c // 32)


@functools.lru_cache(maxsize=64)
def head_grid(n: int, h: int, w: int, cin: int, nc: int, label_kind: int,
              device: int) -> dict:
    """The persistent grid of K5a at these shapes on the current card
    (``device``, its index, keys the cache), as its C entry sizes it from
    the SM count and the occupancy: blocks (the rows of block sums it
    writes), blocks a SM, SMs, dynamic shared memory (bytes), pixel tiles
    and rows a tile."""
    out = torch.zeros(6, dtype=torch.int32)
    err = _build.library().mmr_head_loss_fwd_grid(n, h, w, cin, nc,
                                                  label_kind, out.data_ptr())
    _raise_on(err, "head_loss_fwd grid")
    return dict(zip(("blocks", "per_sm", "sms", "smem", "tiles", "rows"),
                    out.tolist()))


def head_loss_fwd_ref(x: Pending, w: torch.Tensor, bias: torch.Tensor,
                      labels: torch.Tensor, with_conf: bool = True,
                      dtype: torch.dtype = BF16):
    """Plain version of :func:`head_loss_fwd`: the f32 logits of the
    rounded prologue'd input and rounded weights, then the loss statistics
    from a per-pixel-max softmax."""
    nc = w.shape[3]
    a = activated(x, dtype).permute(0, 3, 1, 2)
    logits = F.conv2d(a, _round(w, dtype).permute(3, 2, 0, 1), bias.float(),
                      padding=1).permute(0, 2, 3, 1)
    m = logits.amax(-1, keepdim=True)
    z = torch.exp(logits - m)
    sums = z.sum(-1, keepdim=True)
    probs = z / sums
    lse = torch.log(sums) + m
    onehot = _onehot(labels, nc)
    stats = torch.stack([probs.sum((1, 2)), onehot.sum((1, 2)),
                         (probs * onehot).sum((1, 2)),
                         (onehot * (lse - logits)).sum((1, 2))], dim=1)
    conf = logits.new_zeros((nc, nc))
    if with_conf:
        pred = F.one_hot(logits.argmax(-1), nc).float()   # first max on ties
        conf = torch.einsum("bhwi,bhwj->ij", pred, onehot)
    logp = torch.clamp_max(logits - lse, 0.0).to(dtype).contiguous()
    return logp, stats, conf


def _check_head(x: Pending, w: torch.Tensor, labels: torch.Tensor):
    device, batch = x.raw.device, x.raw.shape[0]
    _check_pending(x, device, batch)
    if x.up2x or x.scale is None:
        raise ValueError("the head takes a BN-pending, non-lazy input")
    nc = w.shape[-1]
    if w.shape != (3, 3, x.c, nc) or w.device != device or not 1 <= nc <= 16:
        raise ValueError(f"head weight {tuple(w.shape)} on {w.device}: want "
                         f"(3, 3, {x.c}, nc <= 16) on {device}")
    if (labels.shape != x.raw.shape[:3] or labels.device != device
            or labels.dtype.is_floating_point):
        raise ValueError(f"labels must be integer {tuple(x.raw.shape[:3])} "
                         f"on {device}")
    return device, batch, nc


def head_loss_fwd(x: Pending, w: torch.Tensor, bias: torch.Tensor,
                  labels: torch.Tensor, with_conf: bool = True):
    """K5a. ``x``: the top feature (raw NHWC bf16, BN + relu pending);
    ``w``: HWIO (3, 3, C, nc), nc ≤ 16; ``bias``: (nc,); ``labels``: (B, H,
    W) integer class ids. Returns ``(logp, stats, conf)``: the bf16 log-prob
    surface (B, H, W, nc), the f32 per-sample statistics (B, 4, nc) and the
    f32 confusion (nc, nc), zero without ``with_conf``."""
    device, batch, nc = _check_head(x, w, labels)
    _check_bias(bias, nc, device)
    if not _launch_device(device):
        return head_loss_fwd_ref(x, w, bias, labels, with_conf)

    h, wd = x.raw.shape[1], x.raw.shape[2]
    f32 = dict(dtype=torch.float32, device=device)
    k16 = head_k16(x.c)
    taps = _cached_pack(("K5a", k16), [w], lambda: _narrow_frags(
        w.reshape(9, x.c, nc), k16, 2))
    # uint8, int32 and int64 labels are read as they come; rarer integer
    # types take one conversion
    lab = labels if labels.dtype in LABEL_KINDS else labels.to(torch.int32)
    lab = lab.contiguous()
    kind = LABEL_KINDS[lab.dtype]
    grid = head_grid(batch, h, wd, x.c, nc, kind, device.index)
    part = torch.empty((grid["blocks"], batch * 64 + 256), **f32)
    logp = torch.empty((batch, h, wd, nc), dtype=BF16, device=device)
    stats = torch.empty((batch, 4, nc), **f32)
    conf = torch.empty((nc, nc), **f32)
    err = _build.library().mmr_head_loss_fwd(
        x.raw.data_ptr(), x.scale.data_ptr(), x.shift.data_ptr(), ACTS[x.act],
        x.c, taps.data_ptr(), bias.float().contiguous().data_ptr(),
        lab.data_ptr(), kind, logp.data_ptr(), part.data_ptr(),
        grid["blocks"], stats.data_ptr(), conf.data_ptr(), int(with_conf),
        batch, h, wd, nc, _stream())
    _raise_on(err, "head_loss_fwd")
    head_loss_fwd.launches += 1
    return logp, stats, conf


head_loss_fwd.launches = 0


# ------------------------------------------------------------------ K5b

def dlogits_ref(logp: torch.Tensor, labels: torch.Tensor,
                dstats: torch.Tensor) -> torch.Tensor:
    """d(logits) (f32 NHWC) from the log-probs, the labels and d(stats)
    (``packed_chain.py:2396-2412``): p = exp(logp), g = ds0 + ds2·onehot,
    p·(g − Σp·g) + ds3·(onehot ? expm1(logp) : p) — the CE term as the
    kernels form it, which is the gradient when ds3 is one value per sample
    (as ``assemble_dice_ce`` makes it)."""
    lp = logp.float()
    probs = torch.exp(lp)
    onehot = _onehot(labels, lp.shape[-1])
    ds = dstats.float()[:, :, None, None, :]
    g = ds[:, 0] + ds[:, 2] * onehot
    inner = (probs * g).sum(-1, keepdim=True)
    return probs * (g - inner) + ds[:, 3] * torch.where(
        onehot > 0, torch.expm1(lp), probs)


def head_loss_bwd_ref(x: Pending, w: torch.Tensor, logp: torch.Tensor,
                      labels: torch.Tensor, dstats: torch.Tensor,
                      dtype: torch.dtype = BF16):
    """Plain version of :func:`head_loss_bwd`: :func:`dlogits_ref`, then
    the conv backward of :func:`~mmr_tpu_torch.ops.fused_conv.fused_conv_bwd_ref`
    with a bias."""
    dy = dlogits_ref(logp, labels, dstats)
    dxs, dws, dpros, dbias = fused_conv_bwd_ref([x], [w], None, dy, None,
                                                True, dtype=dtype)
    return dxs[0], dws[0], dpros[0], dbias


def _max_blocks(device: torch.device) -> int:
    """Rows of K5b's per-block sums: four blocks a SM at most."""
    return 4 * torch.cuda.get_device_properties(device).multi_processor_count


def head_loss_bwd(x: Pending, w: torch.Tensor, logp: torch.Tensor,
                  labels: torch.Tensor, dstats: torch.Tensor):
    """K5b: from the forward's input, weights, log-prob surface and labels
    and the statistics' cotangent ``dstats`` (B, 4, nc) f32, returns ``(dx
    (bf16, like x.raw), dW (f32 HWIO), (d scale, d shift), dbias)``. The
    kernel takes a head input of at most 32 channels (the flagship's has
    16): a wider one on the card raises."""
    device, batch, nc = _check_head(x, w, labels)
    _check_grad("logp", logp, tuple(x.raw.shape[:3]) + (nc,), device)
    if dstats.shape != (batch, 4, nc) or dstats.device != device:
        raise ValueError(f"dstats must be ({batch}, 4, {nc}) on {device}")
    if not _launch_device(device):
        return head_loss_bwd_ref(x, w, logp, labels, dstats)
    if x.c > 32:
        raise ValueError(f"the head backward kernel takes at most 32 input "
                         f"channels, not {x.c}")

    h, wd = x.raw.shape[1], x.raw.shape[2]
    f32 = dict(dtype=torch.float32, device=device)
    ntile = _wg_tile(x.c)[0]
    wt_t = _cached_pack(("K5b", ntile), [w],
                        lambda: _pack_taps(_dx_taps(w), ntile))
    rows = _max_blocks(device)
    part = torch.empty((rows, 9 * ntile * 16 + 16 + 2 * ntile), **f32)
    lab = labels.to(torch.int32).contiguous()
    dx = torch.empty_like(x.raw)
    dscale, dshift = torch.empty(x.c, **f32), torch.empty(x.c, **f32)
    dw = torch.empty(w.shape, **f32)
    dbias = torch.empty(nc, **f32)
    err = _build.library().mmr_head_loss_bwd(
        x.raw.data_ptr(), x.scale.data_ptr(), x.shift.data_ptr(), ACTS[x.act],
        x.c, wt_t.data_ptr(), ntile, logp.data_ptr(), lab.data_ptr(),
        dstats.float().contiguous().data_ptr(), dx.data_ptr(),
        part.data_ptr(), rows, dw.data_ptr(), dscale.data_ptr(),
        dshift.data_ptr(), dbias.data_ptr(), batch, h, wd, nc, _stream())
    _raise_on(err, "head_loss_bwd")
    head_loss_bwd.launches += 1
    return dx, dw, (dscale, dshift), dbias


head_loss_bwd.launches = 0


class HeadLossFn(torch.autograd.Function):
    """K5a forward, K5b backward. ``forward(ctx, spec, raw, scale, shift, w,
    bias, labels)`` with ``spec = (act, with_conf)``; returns (logp, stats,
    conf). Gradients flow through ``stats`` only (logp and conf are
    residual / metrics)."""

    @staticmethod
    def forward(ctx, spec, raw, scale, shift, w, bias, labels):
        act, with_conf = spec
        logp, stats, conf = head_loss_fwd(Pending(raw, scale, shift, act), w,
                                          bias, labels, with_conf)
        ctx.act = act
        ctx.save_for_backward(raw, scale, shift, w, logp, labels)
        ctx.mark_non_differentiable(logp, conf)
        return logp, stats, conf

    @staticmethod
    def backward(ctx, dlogp, dstats, dconf):
        raw, scale, shift, w, logp, labels = ctx.saved_tensors
        dx, dw, (ds, dt), dbias = head_loss_bwd(
            Pending(raw, scale, shift, ctx.act), w, logp, labels, dstats)
        return None, dx, ds, dt, dw, dbias, None


def fused_head_loss(x: Pending, w: torch.Tensor, bias: torch.Tensor,
                    labels: torch.Tensor, with_conf: bool = True):
    """Differentiable head + loss statistics (K5a forward, K5b backward):
    ``(logp, stats, conf)`` as :func:`head_loss_fwd` returns them."""
    return HeadLossFn.apply((x.act, with_conf), x.raw, x.scale, x.shift, w,
                            bias, labels)


def assemble_dice_ce(stats: torch.Tensor, conf: torch.Tensor, n_pixels: int):
    """MONAI ``DiceCELoss(softmax=True)`` from the fused statistics
    (``packed_chain.py::assemble_dice_ce``): per-sample per-class dice
    ratios meaned over (B, C) plus CE meaned over ``n_pixels``. Returns
    (loss, the detached confusion)."""
    probs_sum, onehot_sum, inter = stats[:, 0], stats[:, 1], stats[:, 2]
    dice = 1.0 - (2.0 * inter + SMOOTH) / (probs_sum + onehot_sum + SMOOTH)
    loss = dice.mean() + stats[:, 3].sum() / n_pixels
    return loss, conf.detach()
