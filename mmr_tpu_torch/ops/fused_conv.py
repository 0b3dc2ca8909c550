"""The fused conv kernels K1 (:func:`fused_conv`) and K2
(:func:`fused_conv_down`), their plain PyTorch versions, and the
:class:`Pending` tensor they consume.

Counterparts of ``mmr_tpu/ops/pallas/packed_chain.py::fused_conv`` and
``::fused_conv_down`` (forward, eval: no BN moments, no dx threading). The
TPU packing (lane blocks, baked halos, Toeplitz taps, phase splits) is not
ported: tensors are plain NHWC bf16, and the kernels
(``mmr_tpu_torch/csrc/fused_conv.cu``, ``fused_conv_down.cu``) keep the
same things out of device memory — the concat of a node's inputs, the
BN-activated inputs and the ×2-upsampled inputs.

A wrapper launches its CUDA kernel for CUDA tensors and runs the plain
version for CPU tensors; any other device raises. ``<wrapper>.launches``
counts kernel launches.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch
import torch.nn.functional as F

from mmr_tpu_torch.ops import _build
from mmr_tpu_torch.ops.resize import upsample2x

ACTS = {"relu": 1, "hswish": 2, "linear": 3}


@dataclasses.dataclass(frozen=True)
class Pending:
    """A raw (pre-BN) NHWC bf16 tensor plus the per-channel prologue its
    consumer applies: ``act(scale * raw + shift)`` (f32 ``scale``/``shift``
    of shape (C,), or None for none), and ``up2x``: the tensor stands for
    its ×2-nearest upsample, which is never materialized. The layout-free
    part of ``mmr_tpu/models/packed_blocks.py::PackedT``."""

    raw: torch.Tensor
    scale: torch.Tensor | None = None
    shift: torch.Tensor | None = None
    act: str = "relu"
    up2x: bool = False

    @property
    def c(self) -> int:
        return self.raw.shape[-1]

    @property
    def hw(self) -> tuple[int, int]:
        """Spatial size of the tensor this stands for."""
        h, w = self.raw.shape[1], self.raw.shape[2]
        return (2 * h, 2 * w) if self.up2x else (h, w)


def apply_act(v: torch.Tensor, act: str) -> torch.Tensor:
    if act == "relu":
        return torch.clamp_min(v, 0.0)
    if act == "hswish":
        return v * torch.clamp(v + 3.0, 0.0, 6.0) * (1.0 / 6.0)
    if act == "linear":
        return v
    raise ValueError(f"unknown prologue act {act!r}")


def activated(p: Pending) -> torch.Tensor:
    """The prologue applied in f32 and rounded to bf16 (where the kernels
    round), returned as f32 at the raw tensor's resolution."""
    x = p.raw.float()
    if p.scale is not None:
        x = apply_act(x * p.scale + p.shift, p.act)
    return x.to(torch.bfloat16).float()


# ------------------------------------------------------------ validation

def _check_pending(p: Pending, device: torch.device, batch: int):
    x = p.raw
    if x.device != device:
        raise ValueError(f"input on {x.device}, expected {device}")
    if x.dtype != torch.bfloat16 or x.dim() != 4 or not x.is_contiguous():
        raise ValueError("kernel inputs must be contiguous NHWC bf16 "
                         f"(got {x.dtype}, shape {tuple(x.shape)}, "
                         f"contiguous={x.is_contiguous()})")
    if x.shape[0] != batch:
        raise ValueError("inputs disagree on the batch size")
    if (p.scale is None) != (p.shift is None):
        raise ValueError("scale and shift come together")
    if p.scale is not None:
        for v in (p.scale, p.shift):
            if (v.device != device or v.dtype != torch.float32
                    or v.shape != (p.c,) or not v.is_contiguous()):
                raise ValueError("prologue vectors must be contiguous f32 "
                                 f"({p.c},) on {device}")
        if p.act not in ACTS:
            raise ValueError(f"unknown prologue act {p.act!r}")


def _check_bias(bias, cout: int, device: torch.device):
    if bias is not None and (bias.shape != (cout,) or bias.device != device):
        raise ValueError(f"bias must be ({cout},) on {device}")


def _launch_device(device: torch.device) -> bool:
    """True: launch the CUDA kernel; False: run the plain version (CPU
    tensors only). Raises for any other device."""
    if device.type == "cuda":
        return True
    if device.type == "cpu":
        return False
    raise ValueError(f"no kernel and no plain version for device {device}")


def _ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def _stream() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def _raise_on(err: int, name: str):
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


# ------------------------------------------------------------------- K1

def fused_conv_ref(inputs: list[Pending], weights: list[torch.Tensor],
                   bias: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version of :func:`fused_conv`: prologues in f32 rounded to
    bf16, ×2 upsample by ``repeat_interleave``, ``torch.cat``, one f32
    ``F.conv2d`` (padding 1) over bf16-rounded weights, + bias, rounded to
    bf16. NHWC in, NHWC out."""
    xs = [activated(p) for p in inputs]
    xs = [upsample2x(x) if p.up2x else x for x, p in zip(xs, inputs)]
    x = torch.cat(xs, dim=-1).permute(0, 3, 1, 2)
    w = torch.cat([w.to(torch.bfloat16).float() for w in weights], dim=2)
    y = F.conv2d(x, w.permute(3, 2, 0, 1), None if bias is None else bias.float(),
                 padding=1)
    return y.permute(0, 2, 3, 1).to(torch.bfloat16).contiguous()


def _pack_weights(weights: list[torch.Tensor], cout: int, np_: int):
    """(3,3,c_j,cout) HWIO per input -> bf16 (chunks, 9, 16, np_): each
    input's channels padded to 16-channel chunks, cout padded to np_."""
    parts = []
    for w in weights:
        c = w.shape[2]
        nch = -(-c // 16)
        wp = F.pad(w.to(torch.bfloat16), (0, np_ - cout, 0, nch * 16 - c))
        parts.append(wp.reshape(9, nch, 16, np_).permute(1, 0, 2, 3))
    return torch.cat(parts).contiguous()


def fused_conv(inputs: list[Pending], weights: list[torch.Tensor],
               bias: torch.Tensor | None = None) -> torch.Tensor:
    """y = Σ_j conv3×3_SAME(act_j(s_j·x_j + t_j) [×2-nearest if up2x_j], W_j)
    + bias: one launch for all of a node's concat inputs.

    ``inputs``: the node's inputs in concat order; ``weights``: one HWIO
    (3, 3, C_j, Cout) slice per input; ``bias``: (Cout,) or None. Returns
    the raw y as contiguous NHWC bf16 at the inputs' (fine) resolution."""
    if not inputs or len(inputs) != len(weights):
        raise ValueError("one weight slice per input")
    if len(inputs) > 8:
        raise ValueError("fused_conv takes at most 8 inputs")
    x0 = inputs[0].raw
    device, batch = x0.device, x0.shape[0]
    h, w = inputs[0].hw
    cout = weights[0].shape[3]
    for p, wj in zip(inputs, weights):
        _check_pending(p, device, batch)
        if p.hw != (h, w):
            raise ValueError(f"inputs disagree on the resolution: {p.hw} vs {(h, w)}")
        if wj.shape != (3, 3, p.c, cout) or wj.device != device:
            raise ValueError(f"weight {tuple(wj.shape)} does not match input "
                             f"channels {p.c} / cout {cout} on {device}")
    _check_bias(bias, cout, device)
    if not _launch_device(device):
        return fused_conv_ref(inputs, weights, bias)

    nf = min(8, 1 << max(0, (-(-cout // 16) - 1).bit_length()))
    np_ = -(-cout // (16 * nf)) * 16 * nf
    wt = _pack_weights(weights, cout, np_)
    bias_f = None if bias is None else bias.float().contiguous()
    y = torch.empty((batch, h, w, cout), dtype=torch.bfloat16, device=device)
    n = len(inputs)
    ptrs = lambda vals: (ctypes.c_void_p * n)(*vals)
    ints = lambda vals: (ctypes.c_int * n)(*vals)
    xs = ptrs([p.raw.data_ptr() for p in inputs])
    scales = ptrs([_ptr(p.scale) for p in inputs])
    shifts = ptrs([_ptr(p.shift) for p in inputs])
    cs = ints([p.c for p in inputs])
    acts = ints([0 if p.scale is None else ACTS[p.act] for p in inputs])
    ups = ints([int(p.up2x) for p in inputs])
    err = _build.library().mmr_fused_conv(
        n, ctypes.cast(xs, ctypes.c_void_p), ctypes.cast(scales, ctypes.c_void_p),
        ctypes.cast(shifts, ctypes.c_void_p), ctypes.cast(cs, ctypes.c_void_p),
        ctypes.cast(acts, ctypes.c_void_p), ctypes.cast(ups, ctypes.c_void_p),
        wt.data_ptr(), _ptr(bias_f), y.data_ptr(), batch, h, w, cout, np_, nf,
        _stream())
    _raise_on(err, "fused_conv")
    fused_conv.launches += 1
    return y


fused_conv.launches = 0


# ------------------------------------------------------------------- K2

def fused_conv_down_ref(x: Pending, w: torch.Tensor,
                        bias: torch.Tensor | None = None,
                        depthwise: bool = False) -> torch.Tensor:
    """Plain version of :func:`fused_conv_down`: prologue in f32 rounded to
    bf16, one f32 ``F.conv2d`` (stride 2, padding 1, ``groups=C`` when
    depthwise) over bf16-rounded weights, + bias, rounded to bf16."""
    a = activated(x).permute(0, 3, 1, 2)
    wf = w.to(torch.bfloat16).float().permute(3, 2, 0, 1)
    y = F.conv2d(a, wf, None if bias is None else bias.float(), stride=2,
                 padding=1, groups=x.c if depthwise else 1)
    return y.permute(0, 2, 3, 1).to(torch.bfloat16).contiguous()


def fused_conv_down(x: Pending, w: torch.Tensor,
                    bias: torch.Tensor | None = None,
                    depthwise: bool = False) -> torch.Tensor:
    """3×3 stride-2 pad-(1,1) conv of ``act(s·x + t)`` (+ bias).

    ``w``: HWIO (3, 3, Cin, Cout), or (3, 3, 1, C) with ``depthwise`` (a
    true per-channel conv). Returns raw y as contiguous NHWC bf16 at
    ((H+1)//2, (W+1)//2)."""
    if x.up2x:
        raise ValueError("fused_conv_down does not take a lazily upsampled input")
    device, batch = x.raw.device, x.raw.shape[0]
    _check_pending(x, device, batch)
    cin = x.c
    want = (3, 3, 1, cin) if depthwise else (3, 3, cin, w.shape[-1])
    if w.shape != want or w.device != device:
        raise ValueError(f"weight {tuple(w.shape)} on {w.device}, expected "
                         f"{want} on {device}")
    cout = cin if depthwise else w.shape[3]
    if not depthwise and 9 * cin * cout * 4 > 48 * 1024:
        raise ValueError("the dense stride-2 kernel holds its weights in 48 KB "
                         "of shared memory: Cin*Cout must be <= 1365")
    _check_bias(bias, cout, device)
    if not _launch_device(device):
        return fused_conv_down_ref(x, w, bias, depthwise)

    h, wd = x.raw.shape[1], x.raw.shape[2]
    wt = w.to(torch.bfloat16).reshape(9, cin * (1 if depthwise else cout))
    wt = wt.contiguous()
    bias_f = None if bias is None else bias.float().contiguous()
    y = torch.empty((batch, (h + 1) // 2, (wd + 1) // 2, cout),
                    dtype=torch.bfloat16, device=device)
    act = 0 if x.scale is None else ACTS[x.act]
    err = _build.library().mmr_fused_conv_down(
        x.raw.data_ptr(), _ptr(x.scale), _ptr(x.shift), act, wt.data_ptr(),
        _ptr(bias_f), y.data_ptr(), batch, h, wd, cin, cout, int(depthwise),
        _stream())
    _raise_on(err, "fused_conv_down")
    fused_conv_down.launches += 1
    return y


fused_conv_down.launches = 0
