"""The round-1 shifted-GEMM 3×3 conv: K8a (:func:`conv3x3_shift`, conv +
bias (+ ReLU)), K8b (:func:`conv3x3_shift_dw`, its weight gradient), their
plain PyTorch versions, the library-conv fallback :func:`_lax_conv` and the
differentiable entry point :func:`conv3x3_bias_act`.

Counterpart of ``mmr_tpu/ops/pallas/conv3x3.py`` (``_conv3x3_pallas``,
``_conv3x3_dw_pallas``, ``_lax_conv``, ``conv3x3_bias_act`` and its custom
VJP). The TPU's channel-major lane-rolled canvas is not ported: tensors are
plain NHWC, and the kernels (``mmr_tpu_torch/csrc/conv3x3.cu``, f32 storage
as well as bf16) read x once and write y once: K8a on the narrow tile
(``csrc/narrow_tile.cuh``) at Cin ≤ 32 and Cout ≤ 32, its main shape 16 →
16 and that shape's dx, on K6a's kernel above; K8b on K6b's. Their weight
packs are cached per weight version, the dx taps against the forward's
weights too. No model calls this op, in JAX or here: it is an entry point
of its own, on the kernels only under ``_FORCE`` (``_FORCE_PALLAS``).

A wrapper launches its CUDA kernel for CUDA tensors and runs the plain
version for CPU tensors; any other device raises. ``<wrapper>.launches``
counts kernel launches.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch.nn.grad import conv2d_weight

from mmr_tpu_torch.ops import _build
from mmr_tpu_torch.ops.conv3x3_packed import launch_dw
from mmr_tpu_torch.ops.fused_conv import (BF16, _cached_pack, _check_bias,
                                          _launch_device, _narrow_frags,
                                          _pack_taps, _ptr, _raise_on, _stream,
                                          _wg_tile)

# True: conv3x3_bias_act runs K8a / K8b; False: the library conv
# (``conv3x3.py::_FORCE_PALLAS``)
_FORCE = False
STORAGE = (torch.float32, BF16)   # the types the kernels read and write


def _check_x(name: str, x: torch.Tensor):
    if x.dtype not in STORAGE or x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous NHWC f32 or bf16 "
                         f"(got {x.dtype}, shape {tuple(x.shape)}, "
                         f"contiguous={x.is_contiguous()})")


def _bf16(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bf16, as f32."""
    return t.to(BF16).float()


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _oihw(w: torch.Tensor) -> torch.Tensor:
    return w.permute(3, 2, 0, 1)


# ------------------------------------------------------------------ K8a

NARROW_MAX = 32   # channels in and out the narrow tile takes


def uses_narrow(cin: int, cout: int) -> bool:
    """Whether K8a runs on the narrow tile (``mmr_conv3x3_narrow``) at these
    channels, rather than on K6a's kernel."""
    return cin <= NARROW_MAX and cout <= NARROW_MAX


@functools.lru_cache(maxsize=256)
def narrow_grid(n: int, h: int, w: int, cin: int, cout: int, f32: bool,
                device: int) -> dict:
    """The persistent grid of K8a's narrow tile at these shapes on the
    current card (``device``, its index, keys the cache), as its C entry
    sizes it from the SM count and the occupancy: blocks, blocks a SM, SMs,
    dynamic shared memory (bytes), pixel tiles and rows a tile."""
    out = torch.zeros(6, dtype=torch.int32)
    err = _build.library().mmr_conv3x3_narrow_grid(n, h, w, cin, cout,
                                                   int(f32), out.data_ptr())
    _raise_on(err, "conv3x3_shift grid")
    return dict(zip(("blocks", "per_sm", "sms", "smem", "tiles", "rows"),
                    out.tolist()))


def conv3x3_shift_ref(x: torch.Tensor, w: torch.Tensor,
                      bias: torch.Tensor | None = None,
                      relu: bool = False) -> torch.Tensor:
    """Plain version of :func:`conv3x3_shift`: one f32 ``F.conv2d``
    (padding 1) of x and w rounded to bf16, + bias in f32, ReLU, cast to
    x's dtype. NHWC in, NHWC out."""
    y = F.conv2d(_nchw(_bf16(x)), _oihw(_bf16(w)),
                 None if bias is None else bias.float(), padding=1)
    if relu:
        y = torch.clamp_min(y, 0.0)
    return y.permute(0, 2, 3, 1).to(x.dtype).contiguous()


def conv3x3_shift(x: torch.Tensor, w: torch.Tensor,
                  bias: torch.Tensor | None = None,
                  relu: bool = False) -> torch.Tensor:
    """K8a: ``conv3x3_SAME(x, W) + bias`` (+ ReLU) for contiguous NHWC
    ``x`` (B, H, W, Cin) in f32 or bf16 storage, rounded to bf16 as the
    kernel stages it, and HWIO ``w`` (3, 3, Cin, Cout) rounded to bf16;
    ``bias`` (Cout,) or None, added in f32; f32 accumulation. Returns
    contiguous NHWC (B, H, W, Cout) in x's dtype. Not differentiable: see
    :func:`conv3x3_bias_act`."""
    _check_x("x", x)
    device = x.device
    batch, h, wd, cin = x.shape
    if w.dim() != 4 or w.shape[:3] != (3, 3, cin) or w.device != device:
        raise ValueError(f"weight {tuple(w.shape)} on {w.device} does not match "
                         f"input channels {cin} on {device}")
    cout = w.shape[3]
    _check_bias(bias, cout, device)
    if not _launch_device(device):
        return conv3x3_shift_ref(x, w, bias, relu)

    f32 = int(x.dtype == torch.float32)
    bias_f = None if bias is None else bias.float().contiguous()
    y = torch.empty((batch, h, wd, cout), dtype=x.dtype, device=device)
    if uses_narrow(cin, cout):
        k16, nf = (1 if cin <= 16 else 2), (2 if cout <= 16 else 4)
        taps = _cached_pack(("K8a", k16, nf), [w], lambda: _narrow_frags(
            w.reshape(9, cin, cout), k16, nf))
        err = _build.library().mmr_conv3x3_narrow(
            x.data_ptr(), f32, cin, taps.data_ptr(), _ptr(bias_f),
            y.data_ptr(), batch, h, wd, cout, int(relu), _stream())
    else:
        ntile, np_ = _wg_tile(cout)
        wt = _cached_pack(("K8a wide", np_), [w], lambda: _pack_taps(
            w.reshape(9, cin, cout), np_))
        err = _build.library().mmr_conv3x3(
            x.data_ptr(), f32, cin, wt.data_ptr(), _ptr(bias_f), y.data_ptr(),
            batch, h, wd, cout, np_, ntile, int(relu), _stream())
    _raise_on(err, "conv3x3_shift")
    conv3x3_shift.launches += 1
    return y


conv3x3_shift.launches = 0


# ------------------------------------------------------------------ K8b

def conv3x3_shift_dw_ref(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`conv3x3_shift_dw`: ``conv2d_weight`` in f32
    of x and dy rounded to bf16, HWIO out."""
    w_shape = (dy.shape[3], x.shape[3], 3, 3)
    return conv2d_weight(_nchw(_bf16(x)), w_shape, _nchw(_bf16(dy)),
                         padding=1).permute(2, 3, 1, 0).contiguous()


def conv3x3_shift_dw(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """K8b: the weight gradient of ``y = conv3x3_SAME(x, W)`` for the
    output gradient ``dy`` (contiguous NHWC (B, H, W, Cout)), x and dy in
    one storage type, f32 or bf16 (the VJP passes dy in x's dtype), rounded
    to bf16 as the kernel stages them:
    ``dW[ky, kx, ci, co] = Σ_p x(p + (ky, kx) − 1)[ci] · dy(p)[co]`` (zero
    outside the image), f32 HWIO (3, 3, Cin, Cout)."""
    _check_x("x", x)
    _check_x("dy", dy)
    if (dy.shape[:3] != x.shape[:3] or dy.device != x.device
            or dy.dtype != x.dtype):
        raise ValueError(f"dy {tuple(dy.shape)} {dy.dtype} on {dy.device} does "
                         f"not match x {tuple(x.shape)} {x.dtype} on {x.device}")
    if not _launch_device(x.device):
        return conv3x3_shift_dw_ref(x, dy)

    dw = launch_dw(x, dy, "conv3x3_shift_dw")
    conv3x3_shift_dw.launches += 1
    return dw


conv3x3_shift_dw.launches = 0


# ----------------------------------------------------- library fallback

def _lax_conv(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
              relu: bool) -> torch.Tensor:
    """The library conv of ``conv3x3.py::_lax_conv``: x and w in x's dtype,
    products accumulated in f32, + bias in f32, ReLU, cast to x's dtype."""
    y = F.conv2d(_nchw(x).float(), _oihw(w.to(x.dtype)).float(), padding=1)
    y = y + bias.float()[:, None, None]
    if relu:
        y = torch.clamp_min(y, 0.0)
    return y.permute(0, 2, 3, 1).to(x.dtype).contiguous()


def _lax_conv_dw(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The library weight gradient of the fallback's VJP: f32 products of
    x and g in x's dtype, HWIO out."""
    w_shape = (g.shape[3], x.shape[3], 3, 3)
    return conv2d_weight(_nchw(x).float(), w_shape, _nchw(g).float(),
                         padding=1).permute(2, 3, 1, 0)


# -------------------------------------------------------------- autograd

class Conv3x3BiasActFn(torch.autograd.Function):
    """``conv3x3.py::conv3x3_bias_act`` with its custom VJP (``_bwd``,
    :266-286): the ReLU mask from y, ``gin = g.to(x.dtype)``, dx = K8a on
    gin over flipped, transposed taps with no bias (JAX's zero bias), dW =
    K8b cast to w's dtype, dbias = Σg in f32. Each direction takes the
    kernels when ``_FORCE`` is set, the library conv otherwise. The
    flipped, transposed weights are cached per version of ``w`` (so is
    K8a's pack of them): a backward makes neither anew."""

    @staticmethod
    def forward(ctx, x, w, bias, relu):
        y = (conv3x3_shift if _FORCE else _lax_conv)(x, w, bias, relu)
        ctx.relu = relu
        ctx.save_for_backward(x, w, y if relu else None)
        return y

    @staticmethod
    def backward(ctx, gy):
        x, w, y = ctx.saved_tensors
        g = gy.float()
        if ctx.relu:
            g = torch.where(y > 0, g, 0.0)
        gin = g.to(x.dtype).contiguous()
        if _FORCE:
            w_t = _cached_pack(("K8a dx",), [w],
                               lambda: w.flip(0, 1).transpose(2, 3))
            dx = conv3x3_shift(gin, w_t, None, False)
            dw = conv3x3_shift_dw(x, gin)
        else:
            w_t = w.flip(0, 1).transpose(2, 3)
            zero_bias = torch.zeros(w.shape[2], dtype=torch.float32,
                                    device=w.device)
            dx = _lax_conv(gin, w_t, zero_bias, False)
            dw = _lax_conv_dw(x, gin)
        return dx.to(x.dtype), dw.to(w.dtype), g.sum((0, 1, 2)), None


def conv3x3_bias_act(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                     relu: bool = False) -> torch.Tensor:
    """3×3 stride-1 SAME conv + bias (+ ReLU), NHWC ``x`` (f32 or bf16 on
    the kernels), HWIO ``w``, ``bias`` (Cout,), differentiable in all
    three. Runs K8a (forward and dx) and K8b (dW) when ``_FORCE`` is set,
    else the library conv (:func:`_lax_conv`), as JAX's ``_use_pallas``
    dispatches; JAX's second clause, a feasible TPU row tile
    (``_row_tile``), describes the TPU layout only and is dropped. A kernel
    that fails to build or launch raises: nothing falls back."""
    return Conv3x3BiasActFn.apply(x.contiguous(), w, bias, relu)
