"""The standalone 3×3 stride-1 SAME conv: K6a (:func:`conv3x3`, conv +
bias (+ ReLU)), K6b (:func:`conv3x3_dw`, its weight gradient), their plain
PyTorch versions, the autograd op :func:`conv3x3p_bias_act` that joins them
and the dispatch predicate :func:`use_kernel`.

Counterpart of ``mmr_tpu/ops/pallas/conv3x3_packed.py`` (``_conv_packed``,
``_conv_packed_dw``, ``conv3x3p_bias_act`` and its custom VJP,
``_dispatch_packed``). The TPU's p-pixel block-Toeplitz lane packing is not
ported: tensors are plain NHWC, and the kernels
(``mmr_tpu_torch/csrc/conv3x3.cu``) read x once and write y once. So the
dispatch keeps the size clause of ``dispatch.py::use_packed`` (output
H·W ≥ 64·64) and drops its packing-waste clause, which has no meaning here.

A wrapper launches its CUDA kernel for CUDA tensors and runs the plain
version for CPU tensors; any other device raises. ``<wrapper>.launches``
counts kernel launches. The plain versions take ``dtype``: the storage type
whose rounding they reproduce (bf16, as the kernels).
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch.nn.grad import conv2d_weight

from mmr_tpu_torch.ops import _build
from mmr_tpu_torch.ops.fused_conv import (BF16, _check_bias, _check_grad,
                                          _launch_device, _pack_taps, _ptr,
                                          _raise_on, _round, _stream,
                                          _wg_tile)

# None: dispatch by size; True / False: every bf16 Conv3x3 takes / skips
# the kernel (tests and yardsticks; ``conv3x3_packed.py::_FORCE``)
_FORCE: bool | None = None
MIN_HW = 64 * 64


def use_kernel(x: torch.Tensor) -> bool:
    """Whether a ``Conv3x3`` on NHWC ``x`` runs through
    :func:`conv3x3p_bias_act`: a bf16 input whose H·W ≥ 64·64 (the size
    clause of ``dispatch.py::use_packed``), or any bf16 input under
    ``_FORCE``. f32 convs stay on the library conv, as in JAX."""
    if x.dtype != BF16:
        return False
    if _FORCE is not None:
        return _FORCE
    return x.shape[1] * x.shape[2] >= MIN_HW


def _check_x(x: torch.Tensor):
    if x.dtype != BF16 or x.dim() != 4 or not x.is_contiguous():
        raise ValueError("kernel inputs must be contiguous NHWC bf16 "
                         f"(got {x.dtype}, shape {tuple(x.shape)}, "
                         f"contiguous={x.is_contiguous()})")


# ------------------------------------------------------------------ K6a

def conv3x3_ref(x: torch.Tensor, w: torch.Tensor,
                bias: torch.Tensor | None = None, relu: bool = False,
                dtype: torch.dtype = BF16) -> torch.Tensor:
    """Plain version of :func:`conv3x3`: one f32 ``F.conv2d`` (padding 1)
    of x over weights rounded to ``dtype``, + bias in f32, ReLU, rounded to
    ``dtype``. NHWC in, NHWC out."""
    y = F.conv2d(x.float().permute(0, 3, 1, 2),
                 _round(w, dtype).permute(3, 2, 0, 1),
                 None if bias is None else bias.float(), padding=1)
    if relu:
        y = torch.clamp_min(y, 0.0)
    return y.permute(0, 2, 3, 1).to(dtype).contiguous()


def conv3x3(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor | None = None,
            relu: bool = False) -> torch.Tensor:
    """K6a: ``conv3x3_SAME(x, W) + bias`` (+ ReLU) for contiguous NHWC bf16
    ``x`` (B, H, W, Cin) and HWIO ``w`` (3, 3, Cin, Cout), rounded to bf16;
    ``bias`` (Cout,) or None, added in f32; f32 accumulation. Returns
    contiguous NHWC bf16 (B, H, W, Cout). Not differentiable: see
    :func:`conv3x3p_bias_act`."""
    _check_x(x)
    device = x.device
    batch, h, wd, cin = x.shape
    if w.dim() != 4 or w.shape[:3] != (3, 3, cin) or w.device != device:
        raise ValueError(f"weight {tuple(w.shape)} on {w.device} does not match "
                         f"input channels {cin} on {device}")
    cout = w.shape[3]
    _check_bias(bias, cout, device)
    if not _launch_device(device):
        return conv3x3_ref(x, w, bias, relu)

    ntile, np_ = _wg_tile(cout)
    wt = _pack_taps(w.reshape(9, cin, cout), np_)
    bias_f = None if bias is None else bias.float().contiguous()
    y = torch.empty((batch, h, wd, cout), dtype=BF16, device=device)
    err = _build.library().mmr_conv3x3(
        x.data_ptr(), 0, cin, wt.data_ptr(), _ptr(bias_f), y.data_ptr(),
        batch, h, wd, cout, np_, ntile, int(relu), _stream())
    _raise_on(err, "conv3x3")
    conv3x3.launches += 1
    return y


conv3x3.launches = 0


# ------------------------------------------------------------------ K6b

def conv3x3_dw_ref(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`conv3x3_dw`: ``conv2d_weight`` in f32 of the
    bf16 values, HWIO out."""
    w_shape = (g.shape[3], x.shape[3], 3, 3)
    return conv2d_weight(x.float().permute(0, 3, 1, 2), w_shape,
                         g.float().permute(0, 3, 1, 2),
                         padding=1).permute(2, 3, 1, 0).contiguous()


def conv3x3_dw(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """K6b: the weight gradient of ``y = conv3x3_SAME(x, W)`` for the output
    gradient ``g`` (contiguous NHWC bf16 (B, H, W, Cout)): ``dW[ky, kx, ci,
    co] = Σ_p x(p + (ky, kx) − 1)[ci] · g(p)[co]`` (zero outside the image),
    f32 HWIO (3, 3, Cin, Cout)."""
    _check_x(x)
    batch, h, wd, cin = x.shape
    cout = g.shape[-1]
    _check_grad("g", g, (batch, h, wd, cout), x.device)
    if not _launch_device(x.device):
        return conv3x3_dw_ref(x, g)

    dw = launch_dw(x, g, "conv3x3_dw")
    conv3x3_dw.launches += 1
    return dw


conv3x3_dw.launches = 0


@functools.lru_cache(maxsize=256)
def dw_grid(n: int, h: int, w: int, cin: int, cout: int, f32: bool,
            device: int) -> dict:
    """The persistent grid of K6b's / K8b's kernel (``conv3x3.cu``'s
    ``conv3x3_dw_kernel``) at these shapes on the current card (``device``,
    its index, keys the cache), as its C entry sizes it from the SM count
    and the occupancy: blocks, blocks a SM, SMs, dynamic shared memory
    (bytes), grid rows and the length of a row of block sums."""
    out = torch.zeros(6, dtype=torch.int32)
    err = _build.library().mmr_conv3x3_dw_grid(n, h, w, cin, cout, int(f32),
                                               out.data_ptr())
    _raise_on(err, "conv3x3_dw grid")
    return dict(zip(("blocks", "per_sm", "sms", "smem", "rows", "len"),
                    out.tolist()))


def launch_dw(x: torch.Tensor, g: torch.Tensor, name: str) -> torch.Tensor:
    """The launch of K6b and K8b for checked CUDA tensors x (B, H, W, Cin)
    and g (B, H, W, Cout) in one storage type, bf16 or f32: one persistent
    grid writes a row of block sums a grid row into scratch, a second kernel
    adds the rows in order into the f32 HWIO dW it returns (no atomics: the
    same bits on every launch)."""
    batch, h, wd, cin = x.shape
    cout = g.shape[-1]
    f32 = x.dtype == torch.float32
    grid = dw_grid(batch, h, wd, cin, cout, f32, torch.cuda.current_device())
    part = torch.empty((grid["rows"], grid["len"]), dtype=torch.float32,
                       device=x.device)
    dw = torch.empty((3, 3, cin, cout), dtype=torch.float32, device=x.device)
    err = _build.library().mmr_conv3x3_dw(
        x.data_ptr(), int(f32), cin, g.data_ptr(), cout, part.data_ptr(),
        grid["rows"], dw.data_ptr(), batch, h, wd, _stream())
    _raise_on(err, name)
    return dw


# -------------------------------------------------------------- autograd

class Conv3x3Fn(torch.autograd.Function):
    """K6a forward; backward (``conv3x3_packed.py::_bwd``): the ReLU mask
    when ``relu``, then K6a on the bf16 cotangent with flipped, transposed
    taps and no bias for dx, K6b for dW, and dbias = Σg in f32 when there
    is a bias."""

    @staticmethod
    def forward(ctx, x, w, bias, relu):
        y = conv3x3(x, w, bias, relu)
        ctx.relu = relu
        ctx.has_bias = bias is not None
        ctx.save_for_backward(x, w, y if relu else None)
        return y

    @staticmethod
    def backward(ctx, gy):
        x, w, y = ctx.saved_tensors
        g = gy.float()
        if ctx.relu:
            g = torch.where(y > 0, g, 0.0)
        gin = g.to(BF16).contiguous()
        dx = dw = dbias = None
        if ctx.needs_input_grad[0]:
            dx = conv3x3(gin, w.flip(0, 1).transpose(2, 3))
        if ctx.needs_input_grad[1]:
            dw = conv3x3_dw(x, gin).to(w.dtype)
        if ctx.has_bias and ctx.needs_input_grad[2]:
            dbias = g.sum((0, 1, 2))
        return dx, dw, dbias, None


def conv3x3p_bias_act(x: torch.Tensor, w: torch.Tensor,
                      bias: torch.Tensor | None = None,
                      relu: bool = False) -> torch.Tensor:
    """Differentiable :func:`conv3x3` (K6a forward; K6a dx and K6b dW
    backward): NHWC bf16 ``x``, HWIO ``w``, ``bias`` or None (no bias: no
    dbias reduction, as ``has_bias=False``)."""
    return Conv3x3Fn.apply(x, w, bias, relu)
