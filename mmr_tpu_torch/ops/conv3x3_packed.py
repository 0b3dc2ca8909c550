"""The standalone 3×3 stride-1 SAME conv: K6a (:func:`conv3x3`, conv +
bias (+ ReLU)), K6b (:func:`conv3x3_dw`, its weight gradient), their plain
PyTorch versions, the autograd op :func:`conv3x3p_bias_act` that joins them
(or the library conv, per direction) and the dispatch predicate
:func:`use_kernel`.

Counterpart of ``mmr_tpu/ops/pallas/conv3x3_packed.py`` (``_conv_packed``,
``_conv_packed_dw``, ``conv3x3p_bias_act`` and its custom VJP,
``_dispatch_packed``). The TPU's p-pixel block-Toeplitz lane packing is not
ported: tensors are plain NHWC, and the kernels
(``mmr_tpu_torch/csrc/conv3x3.cu``) read x once and write y once. Which
direction of a bf16 conv takes the kernels is decided per shape by
:mod:`mmr_tpu_torch.ops.dispatch` (the table measured on the card, else
output H·W ≥ 64·64): the forward at ``(h, w, cin, cout)``, the backward at
``(h, w, cout, cin)``, as JAX's ``_fwd`` and ``_bwd`` each call
``_dispatch_packed``.

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

from mmr_tpu_torch.ops import _build, dispatch
from mmr_tpu_torch.ops.fused_conv import (BF16, _check_bias, _check_grad,
                                          _launch_device, _pack_taps, _ptr,
                                          _raise_on, _round, _stream,
                                          _wg_tile)

# None: dispatch by the table; True / False: every bf16 Conv3x3 takes /
# skips the kernels in both directions (tests and yardsticks;
# ``conv3x3_packed.py::_FORCE``)
_FORCE: bool | None = None


def use_kernel(dtype: torch.dtype, h: int, w: int, cin: int, cout: int) -> bool:
    """Whether a 3×3 conv of an NHWC (B, h, w, cin) input of ``dtype`` to
    ``cout`` channels runs on K6: bf16 only (f32 convs stay on the library
    conv, as in JAX), every one under ``_FORCE``, else as
    :func:`mmr_tpu_torch.ops.dispatch.use_kernel` says for the key. The
    backward asks at ``(h, w, cout, cin)``."""
    if dtype != BF16:
        return False
    if _FORCE is not None:
        return _FORCE
    return dispatch.use_kernel(h, w, cin, cout)


def routes(x: torch.Tensor, cout: int) -> tuple[bool, bool]:
    """(forward, backward) on K6 for a conv of NHWC ``x`` to ``cout``
    channels, each asked at its own key."""
    _, h, w, cin = x.shape
    return (use_kernel(x.dtype, h, w, cin, cout),
            use_kernel(x.dtype, h, w, cout, cin))


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

def _library_fwd(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor | None,
                 relu: bool) -> torch.Tensor:
    """The library route of the forward: the library conv of NHWC ``x``
    over the HWIO weights and the bias cast to its dtype, as
    ``layers.Conv2d`` runs it, then ReLU; NHWC out. It rounds as the port's
    ``Conv2d`` does, not as JAX's ``_lax_conv``: the bias is rounded to bf16
    and added by the conv, where JAX adds it in f32 to the f32 product and
    rounds once."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1).to(x.dtype),
                 None if bias is None else bias.to(x.dtype), padding=1)
    if relu:
        y = torch.relu(y)
    return y.permute(0, 2, 3, 1)


def _library_bwd(x: torch.Tensor, w: torch.Tensor, gin: torch.Tensor,
                 need_dx: bool, need_dw: bool):
    """The library route of the backward: dx and dW of the bf16 cotangent
    ``gin`` by the library conv's own backward, bf16 in, f32 accumulation;
    (dx NHWC, dW HWIO). dW comes out rounded to bf16, as the port's
    ``Conv2d`` backward gives it, where K6b's and JAX's ``lax`` branch of
    ``_bwd`` (``preferred_element_type=f32``) keep f32."""
    dx, dw, _ = torch.ops.aten.convolution_backward(
        gin.permute(0, 3, 1, 2), x.permute(0, 3, 1, 2),
        w.permute(3, 2, 0, 1).to(gin.dtype), None, [1, 1], [1, 1], [1, 1],
        False, [0, 0], 1, [need_dx, need_dw, False])
    return (None if dx is None else dx.permute(0, 2, 3, 1).contiguous(),
            None if dw is None else dw.float().permute(2, 3, 1, 0))


class Conv3x3Fn(torch.autograd.Function):
    """Forward on K6a or the library conv (``fwd_kernel``); backward
    (``conv3x3_packed.py::_bwd``): the ReLU mask when ``relu``, then on
    ``bwd_kernel`` K6a on the bf16 cotangent with flipped, transposed taps
    and no bias for dx and K6b for dW, else both by the library conv on
    that same cotangent; dbias = Σg in f32 when there is a bias. The two
    routes are decided apart, each at its own key (:func:`routes`)."""

    @staticmethod
    def forward(ctx, x, w, bias, relu, fwd_kernel, bwd_kernel):
        y = (conv3x3 if fwd_kernel else _library_fwd)(x, w, bias, relu)
        ctx.relu = relu
        ctx.bwd_kernel = bwd_kernel
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
        need_dx, need_dw = ctx.needs_input_grad[:2]
        dx = dw = dbias = None
        if not ctx.bwd_kernel:
            dx, dw = _library_bwd(x, w, gin, need_dx, need_dw)
        else:
            if need_dx:
                dx = conv3x3(gin, w.flip(0, 1).transpose(2, 3))
            if need_dw:
                dw = conv3x3_dw(x, gin)
        if dw is not None:
            dw = dw.to(w.dtype)
        if ctx.has_bias and ctx.needs_input_grad[2]:
            dbias = g.sum((0, 1, 2))
        return dx, dw, dbias, None, None, None


def conv3x3p_bias_act(x: torch.Tensor, w: torch.Tensor,
                      bias: torch.Tensor | None = None, relu: bool = False,
                      fwd_kernel: bool = True,
                      bwd_kernel: bool = True) -> torch.Tensor:
    """Differentiable 3×3 SAME conv + bias (+ ReLU): NHWC bf16 ``x``, HWIO
    ``w``, ``bias`` or None (no bias: no dbias reduction, as
    ``has_bias=False``). The forward on K6a (``fwd_kernel``) or the library
    conv, the backward on K6a dx + K6b dW (``bwd_kernel``) or the library
    conv; :func:`conv3x3_layer` passes :func:`routes`."""
    return Conv3x3Fn.apply(x, w, bias, relu, fwd_kernel, bwd_kernel)


def conv3x3_layer(x: torch.Tensor, w: torch.Tensor,
                  bias: torch.Tensor | None = None,
                  relu: bool = False) -> torch.Tensor:
    """What ``models.layers.Conv3x3`` runs (and the table's tuner times):
    NHWC ``x``, OIHW ``w`` (the layer's f32 parameters), ``bias`` or None.
    :func:`conv3x3p_bias_act` on the :func:`routes` of ``x`` where either
    direction takes K6, else the library conv under torch's autograd
    (:func:`_library_fwd`, as ``layers.Conv2d``); NHWC out."""
    fwd, bwd = routes(x, w.shape[0])
    w = w.permute(2, 3, 1, 0)
    if fwd or bwd:
        return conv3x3p_bias_act(x.contiguous(), w, bias, relu, fwd, bwd)
    return _library_fwd(x, w, bias, relu)
