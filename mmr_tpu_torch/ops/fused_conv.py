"""The fused conv kernels K1 (:func:`fused_conv`), K2
(:func:`fused_conv_down`), their backward kernels K3
(:func:`fused_conv_bwd`) and K4 (:func:`fused_conv_down_bwd`), their plain
PyTorch versions, the autograd functions that join them, and the
:class:`Pending` tensor they consume.

Counterparts of ``mmr_tpu/ops/pallas/packed_chain.py::fused_conv`` and
``::fused_conv_down`` with their custom VJPs, BN moments and the ``thru``
dx threading included: a surface read by several fused nodes is handed
from consumer to consumer (:func:`fused_conv_ad`'s ``thru``), and each
consumer's K3 adds the cotangent its later consumers summed while it
writes its own dx (``daccs``), so autograd sums none of them. K1 and K3
also run the stride-1 depthwise conv of the mbv3 b1 block
(``depthwise=True``) on the depthwise tile of K2 and K4. The TPU packing
(lane blocks, baked halos, Toeplitz taps, phase splits) is not ported:
tensors are plain NHWC bf16, and the kernels
(``mmr_tpu_torch/csrc/fused_conv*.cu``) keep the same things out of device
memory — the concat of a node's inputs, the BN-activated inputs and the
×2-upsampled inputs.

A wrapper launches its CUDA kernel for CUDA tensors and runs the plain
version for CPU tensors; any other device raises. ``<wrapper>.launches``
counts kernel launches. The plain backward versions are explicit functions
(not autograd of the plain forward), so the card can hold the backward
kernels against them. Every plain version takes ``dtype``: the storage
type whose rounding it reproduces (bf16, as the kernels); ``torch.float32``
drops the roundings, for checks against autograd.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch
import torch.nn.functional as F
from torch.nn.grad import conv2d_input, conv2d_weight

from mmr_tpu_torch.ops import _build
from mmr_tpu_torch.ops.resize import upsample2x

ACTS = {"relu": 1, "hswish": 2, "linear": 3}
BF16 = torch.bfloat16


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


def act_grad(v: torch.Tensor, act: str) -> torch.Tensor:
    """d act / dv (``packed_chain.py::_act_grad``): hardswish takes 0 at
    v ≤ −3 and 1 at v ≥ 3."""
    if act == "relu":
        return (v > 0.0).float()
    if act == "hswish":
        return torch.where(v <= -3.0, 0.0,
                           torch.where(v >= 3.0, 1.0, (2.0 * v + 3.0) / 6.0))
    if act == "linear":
        return torch.ones_like(v)
    raise ValueError(f"unknown prologue act {act!r}")


def _round(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return x.to(dtype).float()


def activated(p: Pending, dtype: torch.dtype = BF16) -> torch.Tensor:
    """The prologue applied in f32 and rounded to ``dtype`` (where the
    kernels round), returned as f32 at the raw tensor's resolution."""
    x = p.raw.float()
    if p.scale is not None:
        x = apply_act(x * p.scale + p.shift, p.act)
    return _round(x, dtype)


def moments(y: torch.Tensor) -> torch.Tensor:
    """(2, C) f32: Σy and Σy² over every pixel of an NHWC tensor."""
    y = y.float()
    return torch.stack([y.sum((0, 1, 2)), (y * y).sum((0, 1, 2))])


def _corrected_dy(dy, y, dmom):
    """dy + dm0 + 2·y·dm1 in f32: the moments' cotangent folded into dy
    (``packed_chain.py:808-814``)."""
    g = dy.float()
    if dmom is not None:
        g = g + dmom[0] + 2.0 * y.float() * dmom[1]
    return g


def _prologue_bwd(ga: torch.Tensor, p: Pending):
    """Backward through act(s·x + t) (``packed_chain.py::_prologue_bwd``):
    (d raw in f32, (d scale, d shift) or None)."""
    if p.scale is None:
        return ga, None
    x = p.raw.float()
    gm = ga * act_grad(x * p.scale + p.shift, p.act)
    return gm * p.scale, ((gm * x).sum((0, 1, 2)), gm.sum((0, 1, 2)))


# ------------------------------------------------------------ validation

def _check_pending(p: Pending, device: torch.device, batch: int):
    x = p.raw
    if x.device != device:
        raise ValueError(f"input on {x.device}, expected {device}")
    if x.dtype != BF16 or x.dim() != 4 or not x.is_contiguous():
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


def _check_grad(name: str, t: torch.Tensor, shape, device: torch.device):
    if (t.shape != shape or t.device != device or t.dtype != BF16
            or not t.is_contiguous()):
        raise ValueError(f"{name} must be contiguous bf16 {tuple(shape)} on "
                         f"{device} (got {t.dtype} {tuple(t.shape)})")


def _check_dmom(dmom, cout: int, device: torch.device):
    if dmom is not None and (dmom.shape != (2, cout) or dmom.device != device
                             or dmom.dtype != torch.float32):
        raise ValueError(f"dmom must be f32 (2, {cout}) on {device}")


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


def _arr(ctype, vals):
    return ctypes.cast((ctype * len(vals))(*vals), ctypes.c_void_p)


# Weight packs are built once per weight version: the key holds each
# weight's address, shape, strides, dtype and device, the entry its
# autograd version counters, which every in-place update bumps (the
# optimizer's step; a view of a flat buffer shares its base's counter), and
# the weights themselves, so no other tensor can take their memory while
# the entry lives.
_PACKS: dict = {}
_PACKS_MAX = 64


def _cached_pack(tag, weights: list[torch.Tensor], make):
    """``make()``, built once per version of ``weights`` (every call for an
    inference tensor, which keeps no version counter)."""
    if any(w.is_inference() for w in weights):
        return make()
    key = (tag,) + tuple((w.data_ptr(), tuple(w.shape), w.stride(), w.dtype,
                          w.device) for w in weights)
    version = tuple(w._version for w in weights)
    hit = _PACKS.get(key)
    if hit is not None and hit[0] == version:
        return hit[1]
    if hit is None and len(_PACKS) >= _PACKS_MAX:
        _PACKS.pop(next(iter(_PACKS)))
    pack = make()
    _PACKS[key] = (version, pack, list(weights))
    return pack


# The Hopper kernels (``common.cuh``'s cp.async + wgmma mainloops: K3's dx
# and dW, K6, K8a wider than the narrow tile) take their taps in one pack
# layout and write dW in another.

def _wg_tile(n: int, cap: int = 64) -> tuple[int, int]:
    """(N, np): the Hopper kernels' output-channel tile for ``n`` channels
    (16, 32 or 64, at most ``cap``: the wgmma N; the dW kernel takes 32 at
    most) and ``n`` padded to a multiple of it."""
    tile = min(cap, 16 if n <= 16 else 32 if n <= 32 else 64)
    return tile, -(-n // tile) * tile


def _pack_taps(taps: torch.Tensor, np_: int) -> torch.Tensor:
    """(T, K, N) tap matrices -> the Hopper kernels' bf16 pack (K chunks of
    16, T, 2, np_, 8): ``pack[k, t, g, n, i] = taps[t, 16k + 8g + i, n]``,
    zero beyond K and N. Each (n, 8 channels) row is 16 bytes: the K-major
    B operand of a wgmma, one 16-channel chunk a ring stage."""
    t, k, n = taps.shape
    nch = -(-k // 16)
    wp = F.pad(taps.to(BF16), (0, np_ - n, 0, nch * 16 - k))
    return wp.reshape(t, nch, 2, 8, np_).permute(1, 0, 2, 4, 3).contiguous()


def _concat_taps(weights: list[torch.Tensor]) -> torch.Tensor:
    """HWIO (3, 3, c_j, cout) per input -> the taps (9, K, cout) of K1's
    K loop: the inputs' channels in concat order, each input's padded to a
    multiple of 16 (its chunks start on a chunk)."""
    return torch.cat([F.pad(w.reshape(9, w.shape[2], w.shape[3]),
                            (0, 0, 0, -w.shape[2] % 16)) for w in weights], 1)


def _dx_taps(w: torch.Tensor) -> torch.Tensor:
    """HWIO (3, 3, c, cout) -> the 9 dx taps (9, cout, c) of a forward-style
    conv over dy: flipped and transposed."""
    return w.flip(0, 1).transpose(2, 3).reshape(9, w.shape[3], w.shape[2])


# per axis: the flipped taps (columns) that sum into the combined tap at
# fine offset -1, 0, 1, 2 (rows) of a lazily x2-upsampled input's dx
_UP2 = ((1.0, 0.0, 0.0), (1.0, 1.0, 0.0), (0.0, 1.0, 1.0), (0.0, 0.0, 1.0))


def _up2_taps(w: torch.Tensor) -> torch.Tensor:
    """HWIO (3, 3, c, cout) -> the taps (32, cout, c) f32 of the
    source-resolution dx of a lazily ×2-upsampled input: the 2×2 sum of the
    fine transposed conv is one 4×4 stride-2 correlation over the fine dy,
    ``dx(Y, X) = Σ_{oy, ox ∈ −1..2} dy(2Y + oy, 2X + ox) · C[oy, ox]`` with
    ``C[oy, ox] = Σ_{ky, kx} A[oy, ky] A[ox, kx] Wf[ky, kx]`` over the
    flipped, transposed weights Wf rounded to bf16 (per axis (Wf0, Wf0+Wf1,
    Wf1+Wf2, Wf2)), summed in f32. Taps 0..15 are the sums rounded to bf16
    (``hi``), 16..31 what that rounding dropped (``lo``, rounded by
    :func:`_pack_taps`): the kernel multiplies both, so the summed taps are
    not rounded as JAX's ``toeplitz_up`` rounds them."""
    wf = w.to(BF16).float().flip(0, 1).transpose(2, 3)
    a = torch.tensor(_UP2, device=w.device)
    c = torch.einsum("ay,bx,yxkn->abkn", a, a, wf).reshape(
        16, w.shape[3], w.shape[2])
    hi = c.to(BF16).float()
    return torch.cat([hi, c - hi])


def _dx_packs(inputs: list[Pending], weights: list[torch.Tensor]):
    """K3's dx tap packs and their (N, np), per input: a lazily ×2-upsampled
    input's own pack of :func:`_up2_taps`; the other inputs share one pack,
    their :func:`_dx_taps` side by side in input order, each input's
    channels padded to 8 (one launch writes all their dx)."""
    same = [(p, w) for p, w in zip(inputs, weights) if not p.up2x]
    if same:
        taps = torch.cat([F.pad(_dx_taps(w), (0, -(-p.c // 8) * 8 - p.c))
                          for p, w in same], dim=2)
        tile = _wg_tile(taps.shape[2])
        shared = _pack_taps(taps, tile[1])
    packs, tiles = [], []
    for p, w in zip(inputs, weights):
        if p.up2x:
            tiles.append(_wg_tile(p.c))
            packs.append(_pack_taps(_up2_taps(w), tiles[-1][1]))
        else:
            tiles.append(tile)
            packs.append(shared)
    return packs, tiles


def _unpack_dw_wg(dwp: torch.Tensor, row0: int, c: int, cout: int):
    """(9, cpad, np) f32 Hopper dW output -> one input's HWIO dW: its rows
    from ``row0`` (the inputs' channels one after another, each input's
    padded to a multiple of 8)."""
    return dwp[:, row0:row0 + c, :cout].reshape(3, 3, c, cout)


# ------------------------------------------------------------------- K1

# K1's output-channel tile (the wgmma N: 16, 32 or 64) by cout, where it
# differs from the widest that fits (``_wg_tile``): chosen by an A/B of the
# tiles inside one chip run (``chip_smoke.py``'s ``k1_tile_ab``)
K1_TILE: dict[int, int] = {24: 16}


def fused_conv_ref(inputs: list[Pending], weights: list[torch.Tensor],
                   bias: torch.Tensor | None = None,
                   emit_moments: bool = False, dtype: torch.dtype = BF16,
                   depthwise: bool = False):
    """Plain version of :func:`fused_conv`: prologues in f32 rounded to
    ``dtype``, ×2 upsample by ``repeat_interleave``, ``torch.cat``, one f32
    ``F.conv2d`` (padding 1) over rounded weights, + bias; moments from the
    f32 result, y rounded to ``dtype``. NHWC in, NHWC out. ``depthwise``:
    the grouped conv (``groups=C``) of the one input."""
    if depthwise:
        return fused_conv_down_ref(inputs[0], weights[0], bias, True,
                                   emit_moments, dtype, stride=1)
    xs = [activated(p, dtype) for p in inputs]
    xs = [upsample2x(x) if p.up2x else x for x, p in zip(xs, inputs)]
    x = torch.cat(xs, dim=-1).permute(0, 3, 1, 2)
    w = torch.cat([_round(w, dtype) for w in weights], dim=2)
    y = F.conv2d(x, w.permute(3, 2, 0, 1), None if bias is None else bias.float(),
                 padding=1).permute(0, 2, 3, 1)
    out = y.to(dtype).contiguous()
    return (out, moments(y)) if emit_moments else out


def fused_conv(inputs: list[Pending], weights: list[torch.Tensor],
               bias: torch.Tensor | None = None, emit_moments: bool = False,
               depthwise: bool = False):
    """y = Σ_j conv3×3_SAME(act_j(s_j·x_j + t_j) [×2-nearest if up2x_j], W_j)
    + bias: one launch for all of a node's concat inputs.

    ``inputs``: the node's inputs in concat order; ``weights``: one HWIO
    (3, 3, C_j, Cout) slice per input; ``bias``: (Cout,) or None. Returns
    the raw y as contiguous NHWC bf16 at the inputs' (fine) resolution, and
    with ``emit_moments`` also its (2, Cout) f32 moments [Σy, Σy²] taken
    before the bf16 rounding. Not differentiable: see :func:`fused_conv_ad`.

    ``depthwise``: one input and a (3, 3, 1, C) weight, a true per-channel
    conv (the mbv3 b1_1 block's, ``packed_encoder.py:258-266``): the
    stride-1 instance of the depthwise tile of ``csrc/down_tile.cuh``
    (``fused_conv_down.cu``), C a multiple of 8 up to
    :data:`DEPTHWISE_MAX_C` on the card."""
    if depthwise:
        if len(inputs) != 1 or len(weights) != 1 or inputs[0].up2x:
            raise ValueError("the depthwise mode takes one input, not "
                             "lazily upsampled, and one weight")
        x = inputs[0]
        device, _, cout = _check_down(x, weights[0], bias, True)
        if not _launch_device(device):
            return fused_conv_ref(inputs, weights, bias, emit_moments,
                                  depthwise=True)
        out = _down_fwd_launch(x, weights[0], bias, True, emit_moments, 1)
        fused_conv.launches += 1
        return out
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
        return fused_conv_ref(inputs, weights, bias, emit_moments)

    ntile = K1_TILE.get(cout, _wg_tile(cout)[0])
    np_ = -(-cout // ntile) * ntile
    wt = _cached_pack(("K1", np_), weights,
                      lambda: _pack_taps(_concat_taps(weights), np_))
    bias_f = None if bias is None else bias.float().contiguous()
    y = torch.empty((batch, h, w, cout), dtype=BF16, device=device)
    mom = (torch.zeros((2, cout), dtype=torch.float32, device=device)
           if emit_moments else None)
    P, I = ctypes.c_void_p, ctypes.c_int
    err = _build.library().mmr_fused_conv(
        len(inputs), _arr(P, [p.raw.data_ptr() for p in inputs]),
        _arr(P, [_ptr(p.scale) for p in inputs]),
        _arr(P, [_ptr(p.shift) for p in inputs]),
        _arr(I, [p.c for p in inputs]),
        _arr(I, [0 if p.scale is None else ACTS[p.act] for p in inputs]),
        _arr(I, [int(p.up2x) for p in inputs]),
        wt.data_ptr(), _ptr(bias_f), y.data_ptr(), _ptr(mom), batch, h, w,
        cout, np_, ntile, _stream())
    _raise_on(err, "fused_conv")
    fused_conv.launches += 1
    return (y, mom) if emit_moments else y


fused_conv.launches = 0


# ------------------------------------------------------------------- K3

def fused_conv_bwd_ref(inputs: list[Pending], weights: list[torch.Tensor],
                       y: torch.Tensor | None, dy: torch.Tensor,
                       dmom: torch.Tensor | None = None,
                       has_bias: bool = False,
                       daccs: list[torch.Tensor | None] | None = None,
                       depthwise: bool = False, dtype: torch.dtype = BF16):
    """Plain version of :func:`fused_conv_bwd`, written out: dye = dy +
    dm0 + 2·y·dm1 (f32; dbias = Σdye), rounded to ``dtype``; per input the
    weight gradient ``conv2d_weight`` and the input gradient
    ``conv2d_input`` (f32) of the forward's rounded prologue'd input (×2
    upsampled for a lazy input, whose gradient is then 2×2-summed back to
    source resolution), then the prologue backward, then input j's addend
    ``daccs[j]`` (f32) before the one rounding of dx_j. ``depthwise``: the
    grouped versions (``groups=C``) of both products."""
    if depthwise:
        dx, dw, dpro, dbias = fused_conv_down_bwd_ref(
            inputs[0], weights[0], y, dy, dmom, has_bias, True, True, dtype,
            stride=1)
        return [dx], [dw], [dpro], dbias
    g = _corrected_dy(dy, y, dmom)
    dbias = g.sum((0, 1, 2)) if has_bias else None
    g = _round(g, dtype).permute(0, 3, 1, 2)
    dxs, dws, dpros = [], [], []
    for j, (p, w) in enumerate(zip(inputs, weights)):
        a = activated(p, dtype)
        if p.up2x:
            a = upsample2x(a)
        a = a.permute(0, 3, 1, 2)
        wr = _round(w, dtype).permute(3, 2, 0, 1)
        dws.append(conv2d_weight(a, wr.shape, g, padding=1).permute(2, 3, 1, 0))
        ga = conv2d_input(a.shape, wr, g, padding=1).permute(0, 2, 3, 1)
        if p.up2x:
            b, h, w2, c = ga.shape
            ga = ga.reshape(b, h // 2, 2, w2 // 2, 2, c).sum((2, 4))
        dx, dpro = _prologue_bwd(ga, p)
        if daccs is not None and daccs[j] is not None:
            dx = dx + daccs[j].float()
        dxs.append(dx.to(p.raw.dtype).contiguous())
        dpros.append(dpro)
    return dxs, dws, dpros, dbias


def fused_conv_bwd(inputs: list[Pending], weights: list[torch.Tensor],
                   y: torch.Tensor | None, dy: torch.Tensor,
                   dmom: torch.Tensor | None = None, has_bias: bool = False,
                   daccs: list[torch.Tensor | None] | None = None,
                   depthwise: bool = False):
    """K1's backward (K3): from the forward's inputs and weights, its bf16
    output ``y`` (read only with ``dmom``), the output gradient ``dy``
    (contiguous NHWC bf16) and the moments cotangent ``dmom`` (2, Cout) f32
    or None, returns ``(dxs, dws, dpros, dbias)``: per input the bf16
    gradient of the raw tensor (at source resolution for a lazy ×2 input),
    the f32 HWIO weight gradient and (d scale, d shift) f32 or None; the
    f32 bias gradient when ``has_bias``.

    ``daccs``: per input None or its ``thru`` addend, a contiguous bf16
    tensor of the raw input's shape (the cotangent its surface's later
    consumers summed), added to dx_j in f32 in the kernel before dx_j's
    rounding; d scale / d shift stay this consumer's own share
    (``packed_chain.py:693 _fused_bwd_kernel``'s ``thru_mask``).
    ``depthwise``: the backward of :func:`fused_conv`'s depthwise mode
    (dx always), the stride-1 instance of K4's depthwise tile."""
    x0 = inputs[0].raw
    device, batch = x0.device, x0.shape[0]
    h, w = inputs[0].hw
    cout = weights[0].shape[3]
    if depthwise:
        if (len(inputs) != 1 or inputs[0].up2x
                or (daccs is not None and daccs[0] is not None)):
            raise ValueError("the depthwise backward takes one input, not "
                             "lazily upsampled, and no addend")
        _check_down(inputs[0], weights[0], None, True)
    _check_grad("dy", dy, (batch, h, w, cout), device)
    if dmom is not None:
        _check_grad("y", y, (batch, h, w, cout), device)
    _check_dmom(dmom, cout, device)
    for j, p in enumerate(inputs):
        _check_pending(p, device, batch)
        if daccs is not None and daccs[j] is not None:
            _check_grad("dacc", daccs[j], tuple(p.raw.shape), device)
    if not _launch_device(device):
        return fused_conv_bwd_ref(inputs, weights, y, dy, dmom, has_bias,
                                  daccs, depthwise)
    if depthwise:
        dx, dw, dpro, dbias = _down_bwd_launch(inputs[0], weights[0], y, dy,
                                               dmom, has_bias, True, True, 1)
        fused_conv_bwd.launches += 1
        return [dx], [dw], [dpro], dbias

    f32 = dict(dtype=torch.float32, device=device)
    ntile, np_ = _wg_tile(cout, 32)
    rows = [-(-p.c // 8) * 8 for p in inputs]   # dW rows: channels, to 8
    dwp = torch.zeros((9, -(-sum(rows) // 64) * 64, np_), **f32)
    packs, tiles = _dx_packs(inputs, weights)
    dxs = [torch.empty_like(p.raw) for p in inputs]
    dpros = [None if p.scale is None else (torch.zeros(p.c, **f32),
                                           torch.zeros(p.c, **f32))
             for p in inputs]
    dbias = torch.zeros(cout, **f32) if has_bias else None
    dye = torch.empty_like(dy) if dmom is not None else None
    dmom_c = None if dmom is None else dmom.contiguous()
    P, I = ctypes.c_void_p, ctypes.c_int
    err = _build.library().mmr_fused_conv_bwd(
        len(inputs), _arr(P, [p.raw.data_ptr() for p in inputs]),
        _arr(P, [_ptr(p.scale) for p in inputs]),
        _arr(P, [_ptr(p.shift) for p in inputs]),
        _arr(I, [p.c for p in inputs]),
        _arr(I, [0 if p.scale is None else ACTS[p.act] for p in inputs]),
        _arr(I, [int(p.up2x) for p in inputs]),
        _arr(P, [k.data_ptr() for k in packs]),
        _arr(I, [t[0] for t in tiles]), _arr(I, [t[1] for t in tiles]),
        _arr(P, [d.data_ptr() for d in dxs]),
        _arr(P, [None if d is None else d[0].data_ptr() for d in dpros]),
        _arr(P, [None if d is None else d[1].data_ptr() for d in dpros]),
        _arr(P, [None if daccs is None else _ptr(daccs[j])
                 for j in range(len(inputs))]),
        dy.data_ptr(), _ptr(y), _ptr(dmom_c), _ptr(dye), _ptr(dbias),
        dwp.data_ptr(), ntile, np_, batch, h, w, cout, _stream())
    _raise_on(err, "fused_conv_bwd")
    fused_conv_bwd.launches += 1
    starts = [sum(rows[:j]) for j in range(len(inputs))]
    dws = [_unpack_dw_wg(dwp, s0, p.c, cout) for s0, p in zip(starts, inputs)]
    return dxs, dws, dpros, dbias


fused_conv_bwd.launches = 0


def _grad_bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(BF16).contiguous()


class FusedConvFn(torch.autograd.Function):
    """K1 forward, K3 backward. ``forward(ctx, spec, *tensors)`` with
    ``spec = (n_inputs, acts, ups, has_bias, emit_moments, thru,
    depthwise)`` and ``tensors`` = raws, scales, shifts, weights (n each;
    None where absent), bias. Returns (y, moments or an empty tensor, the
    raw of every input flagged in ``thru``, unchanged).

    A returned raw is the ``thru`` pass-through of
    ``packed_chain.py:1235-1252``: autograd hands it back as a view with
    this function as its source, so a later consumer that reads it (and
    not the input) sends its cotangent here, and K3 adds it to the input's
    dx in the kernel (``daccs``) instead of autograd summing two surfaces.
    A raw whose cotangent never arrives (``None``: nothing read it) is not
    threaded (``packed_chain.py:1096-1102``)."""

    @staticmethod
    def forward(ctx, spec, *tensors):
        n, acts, ups, has_bias, emit, thru, depthwise = spec
        inputs = [Pending(r, s, t, a, u) for r, s, t, a, u
                  in zip(tensors[:n], tensors[n:2 * n], tensors[2 * n:3 * n],
                         acts, ups)]
        weights, bias = list(tensors[3 * n:4 * n]), tensors[4 * n]
        extra = {"depthwise": True} if depthwise else {}
        out = fused_conv(inputs, weights, bias, emit_moments=emit, **extra)
        y, mom = out if emit else (out, None)
        ctx.spec = spec
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(*tensors[:4 * n], y)
        if mom is None:
            mom = y.new_zeros((0,), dtype=torch.float32)
            ctx.mark_non_differentiable(mom)
        return (y, mom, *[r for r, t in zip(tensors[:n], thru) if t])

    @staticmethod
    def backward(ctx, dy, dmom, *dthru):
        n, acts, ups, has_bias, emit, thru, depthwise = ctx.spec
        saved = ctx.saved_tensors
        inputs = [Pending(r, s, t, a, u) for r, s, t, a, u
                  in zip(saved[:n], saved[n:2 * n], saved[2 * n:3 * n],
                         acts, ups)]
        weights, y = list(saved[3 * n:4 * n]), saved[4 * n]
        if dy is None:
            dy = torch.zeros_like(y)
        it, daccs = iter(dthru), []
        for t in thru:
            d = next(it) if t else None
            daccs.append(None if d is None else _grad_bf16(d))
        dxs, dws, dpros, dbias = fused_conv_bwd(
            inputs, weights, y, _grad_bf16(dy), dmom if emit else None,
            has_bias, daccs, depthwise)
        ds = [None if d is None else d[0] for d in dpros]
        dt = [None if d is None else d[1] for d in dpros]
        return (None, *dxs, *ds, *dt, *dws, dbias)


def fused_conv_ad(inputs: list[Pending], weights: list[torch.Tensor],
                  bias: torch.Tensor | None = None,
                  emit_moments: bool = False,
                  thru: list[bool] | None = None, depthwise: bool = False):
    """Differentiable :func:`fused_conv` (K1 forward, K3 backward): the
    gradients reach every raw input, prologue vector, weight slice and the
    bias, the moments' cotangent included. Returns ``(out, raws)``: out is
    y, or (y, moments); ``raws[j]`` is input j's raw tensor handed back
    unchanged where ``thru[j]`` is set, else None.

    ``thru[j]`` threads input j's dx (``packed_chain.py:939-946``
    ``FusedCfg.thru``; none by default). The surface's later consumers
    must read ``raws[j]``, never the raw they would have read, so that
    their summed cotangent reaches this launch's K3 as its addend.
    ``depthwise``: :func:`fused_conv`'s depthwise mode."""
    flags = tuple(bool(t) for t in (thru or [False] * len(inputs)))
    spec = (len(inputs), tuple(p.act for p in inputs),
            tuple(p.up2x for p in inputs), bias is not None, emit_moments,
            flags, depthwise)
    y, mom, *passed = FusedConvFn.apply(
        spec, *[p.raw for p in inputs], *[p.scale for p in inputs],
        *[p.shift for p in inputs], *weights, bias)
    it = iter(passed)
    return ((y, mom) if emit_moments else y,
            [next(it) if t else None for t in flags])


# ------------------------------------------------------------------- K2

def fused_conv_down_ref(x: Pending, w: torch.Tensor,
                        bias: torch.Tensor | None = None,
                        depthwise: bool = False, emit_moments: bool = False,
                        dtype: torch.dtype = BF16, stride: int = 2):
    """Plain version of :func:`fused_conv_down`: prologue in f32 rounded to
    ``dtype``, one f32 ``F.conv2d`` (stride 2, padding 1, ``groups=C`` when
    depthwise) over rounded weights, + bias; moments from the f32 result,
    y rounded to ``dtype``. ``stride=1``: the plain version of
    :func:`fused_conv`'s depthwise mode."""
    a = activated(x, dtype).permute(0, 3, 1, 2)
    wf = _round(w, dtype).permute(3, 2, 0, 1)
    y = F.conv2d(a, wf, None if bias is None else bias.float(), stride=stride,
                 padding=1, groups=x.c if depthwise else 1).permute(0, 2, 3, 1)
    out = y.to(dtype).contiguous()
    return (out, moments(y)) if emit_moments else out


# K2's and K4's output tiles (``csrc/down_tile.cuh``): 4 output rows by 64
# (dense) or 32 (depthwise) output columns — 16 for a stride-2 depthwise
# tile above 64 channels, whose 9 × 33 source values a channel must fit
# shared memory —; the channels the kernels take (the plain versions take
# any): dense Cin <= 16 and Cout <= 32, depthwise C a multiple of 8 up to
# DEPTHWISE_MAX_C, at stride 2 (K2, K4) or 1 (K1's and K3's depthwise mode)
DOWN_TILE = {False: (4, 64), True: (4, 32)}
DENSE_MAX_CIN, DENSE_MAX_COUT = 16, 32
DEPTHWISE_MAX_C = 96


def _tile_cols(depthwise: bool, c: int = 8, stride: int = 2) -> int:
    """Output columns of the stride-2 pair's tile for these channels."""
    if depthwise and stride == 2 and c > 64:
        return 16
    return DOWN_TILE[depthwise][1]


def _check_down(x: Pending, w: torch.Tensor, bias, depthwise: bool):
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
    _check_bias(bias, cout, device)
    return device, batch, cout


def _check_down_kernel(cin: int, cout: int, depthwise: bool):
    """The kernels' channels (a launch; the plain versions take any)."""
    if depthwise and (cin % 8 or not 8 <= cin <= DEPTHWISE_MAX_C):
        raise ValueError("the depthwise kernels take C a multiple of 8 up to "
                         f"{DEPTHWISE_MAX_C} (got {cin})")
    if not depthwise and (cin > DENSE_MAX_CIN or cout > DENSE_MAX_COUT):
        raise ValueError("the dense stride-2 kernels take Cin <= "
                         f"{DENSE_MAX_CIN} and Cout <= {DENSE_MAX_COUT}")


def _down_tiles(batch: int, h: int, w: int, depthwise: bool, c: int = 8,
                stride: int = 2) -> int:
    """The stride-2 pair's tiles of a (batch, h, w) input (``stride=1``:
    the depthwise mode of K1 / K3), in (image, tile row, tile column)
    order; block i of a grid of B blocks (B ≤ the tiles) takes tiles i,
    i + B, ... and writes row i of the block sums."""
    th, tw = DOWN_TILE[depthwise][0], _tile_cols(depthwise, c, stride)
    ho, wo = -(-h // stride), -(-w // stride)
    return batch * -(-ho // th) * -(-wo // tw)


def down_grid(x: Pending, w: torch.Tensor, depthwise: bool = False,
              backward: bool = False, need_dx: bool = False,
              stride: int = 2) -> dict:
    """The persistent grid K2 (or K4, ``backward``) launches for these
    arguments on the current card, as its C entry sizes it: blocks, blocks
    a SM, SMs and dynamic shared memory (bytes). ``stride=1``: the
    depthwise mode of K1 (K3)."""
    n, h, wd, cin = x.raw.shape
    cout = cin if depthwise else w.shape[3]
    _check_down_kernel(cin, cout, depthwise)
    out = torch.zeros(4, dtype=torch.int32)
    lib = _build.library()
    err = (lib.mmr_fused_conv_down_bwd_grid(n, h, wd, cin, cout,
                                            int(depthwise), int(need_dx),
                                            stride, out.data_ptr())
           if backward else
           lib.mmr_fused_conv_down_grid(n, h, wd, cin, cout, int(depthwise),
                                        stride, out.data_ptr()))
    _raise_on(err, "down_grid")
    return dict(zip(("blocks", "per_sm", "sms", "smem"), out.tolist()))


def _down_weights(w: torch.Tensor) -> torch.Tensor:
    """HWIO -> bf16 (9·cin·cout,) or, depthwise, (9·C,): tap-major."""
    return w.to(BF16).reshape(-1).contiguous()


def _stem_frags(w: torch.Tensor) -> torch.Tensor:
    """HWIO (3, 3, cin, cout) -> the dense K2's mma.sync B fragments
    (ks, nt, 32, 4) bf16, ks = ⌈9·cin / 16⌉, nt = ⌈cout / 8⌉: lane 4g + q
    of (ks, nt) holds ``Wk[16·ks + 2q + (0, 1, 8, 9), 8·nt + g]``, Wk the
    weights as (9·cin, cout) patch columns (tap-major), zero beyond."""
    cin, cout = w.shape[2], w.shape[3]
    k, ks, nt = 9 * cin, -(-9 * cin // 16), -(-cout // 8)
    wk = F.pad(w.reshape(k, cout).to(BF16), (0, 8 * nt - cout, 0, 16 * ks - k))
    return wk.reshape(ks, 2, 4, 2, nt, 8).permute(0, 4, 5, 2, 1, 3).reshape(
        ks, nt, 32, 4)


def _narrow_frags(taps: torch.Tensor, k16: int, nf: int) -> torch.Tensor:
    """(9, K, N) tap matrices -> the narrow tile's mma.sync B fragments
    (k16, 9, 32, nf, 4) bf16 (``csrc/narrow_tile.cuh``), K padded to 16·k16
    channels and N to 8·nf: lane 4g + q of (ks, tap) holds, for each n
    fragment f, ``taps[tap, 16·ks + 2q + (0, 1, 8, 9), 8·f + g]`` — its
    fragments of every f in 8·nf contiguous bytes."""
    t, k, n = taps.shape
    wk = F.pad(taps.to(BF16), (0, 8 * nf - n, 0, 16 * k16 - k))
    return wk.reshape(t, k16, 2, 4, 2, nf, 8).permute(1, 0, 6, 3, 5, 2, 4) \
        .reshape(k16, t, 32, nf, 4).contiguous()


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy where its data is not 16-byte aligned (the
    stride-2 kernels copy and load 16 bytes at a time)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _down_fwd_launch(x: Pending, w: torch.Tensor, bias, depthwise: bool,
                     emit_moments: bool, stride: int):
    """One launch of ``csrc/fused_conv_down.cu`` on checked CUDA tensors:
    K2 (stride 2) or K1's depthwise mode (stride 1)."""
    batch, h, wd, cout = (*x.raw.shape[:3], x.c if depthwise else w.shape[3])
    _check_down_kernel(x.c, cout, depthwise)
    device = x.raw.device
    raw = _aligned(x.raw)
    wt = (_cached_pack(("down", True), [w], lambda: _down_weights(w))
          if depthwise else
          _cached_pack(("K2 frags",), [w], lambda: _stem_frags(w)))
    bias_f = None if bias is None else bias.float().contiguous()
    rows = _down_tiles(batch, h, wd, depthwise, x.c, stride)
    y = torch.empty((batch, -(-h // stride), -(-wd // stride), cout),
                    dtype=BF16, device=device)
    part = mom = None
    if emit_moments:
        part = torch.empty((rows, 2 * cout), dtype=torch.float32,
                           device=device)
        mom = torch.empty((2, cout), dtype=torch.float32, device=device)
    act = 0 if x.scale is None else ACTS[x.act]
    err = _build.library().mmr_fused_conv_down(
        raw.data_ptr(), _ptr(x.scale), _ptr(x.shift), act, wt.data_ptr(),
        _ptr(bias_f), y.data_ptr(), _ptr(part), _ptr(mom), rows, batch, h,
        wd, x.c, cout, int(depthwise), stride, _stream())
    _raise_on(err, "fused_conv" if stride == 1 else "fused_conv_down")
    return (y, mom) if emit_moments else y


def fused_conv_down(x: Pending, w: torch.Tensor,
                    bias: torch.Tensor | None = None,
                    depthwise: bool = False, emit_moments: bool = False):
    """3×3 stride-2 pad-(1,1) conv of ``act(s·x + t)`` (+ bias).

    ``w``: HWIO (3, 3, Cin, Cout), or (3, 3, 1, C) with ``depthwise`` (a
    true per-channel conv); the kernel takes Cin ≤ 16 and Cout ≤ 32, or C a
    multiple of 8 up to 96 (the plain version any). Returns raw y as
    contiguous NHWC bf16 at ((H+1)//2, (W+1)//2), and with
    ``emit_moments`` its (2, Cout) f32 moments (the blocks' sums added in a
    fixed order: the same on every run). Not differentiable: see
    :func:`fused_conv_down_ad`."""
    device, _, _ = _check_down(x, w, bias, depthwise)
    if not _launch_device(device):
        return fused_conv_down_ref(x, w, bias, depthwise, emit_moments)
    out = _down_fwd_launch(x, w, bias, depthwise, emit_moments, 2)
    fused_conv_down.launches += 1
    return out


fused_conv_down.launches = 0


# ------------------------------------------------------------------- K4

def fused_conv_down_bwd_ref(x: Pending, w: torch.Tensor,
                            y: torch.Tensor | None, dy: torch.Tensor,
                            dmom: torch.Tensor | None = None,
                            has_bias: bool = False, depthwise: bool = False,
                            need_dx: bool = True, dtype: torch.dtype = BF16,
                            stride: int = 2):
    """Plain version of :func:`fused_conv_down_bwd`, written out: dye (f32;
    dbias = Σdye) rounded to ``dtype``; ``conv2d_weight`` and
    ``conv2d_input`` (stride 2, padding 1, grouped when depthwise) of the
    rounded prologue'd input; the prologue backward. ``stride=1``: the
    plain backward of :func:`fused_conv`'s depthwise mode."""
    g = _corrected_dy(dy, y, dmom)
    dbias = g.sum((0, 1, 2)) if has_bias else None
    g = _round(g, dtype).permute(0, 3, 1, 2)
    a = activated(x, dtype).permute(0, 3, 1, 2)
    wr = _round(w, dtype).permute(3, 2, 0, 1)
    groups = x.c if depthwise else 1
    dw = conv2d_weight(a, wr.shape, g, stride=stride, padding=1,
                       groups=groups).permute(2, 3, 1, 0)
    dx = dpro = None
    if need_dx:
        ga = conv2d_input(a.shape, wr, g, stride=stride, padding=1,
                          groups=groups).permute(0, 2, 3, 1)
        dx, dpro = _prologue_bwd(ga, x)
        dx = dx.to(x.raw.dtype).contiguous()
    return dx, dw, dpro, dbias


def _down_bwd_launch(x: Pending, w: torch.Tensor, y, dy, dmom, has_bias: bool,
                     depthwise: bool, need_dx: bool, stride: int):
    """One launch of ``csrc/fused_conv_down_bwd.cu`` on checked CUDA
    tensors: K4 (stride 2) or K3's depthwise mode (stride 1)."""
    batch, h, wd, c = x.raw.shape
    cout = c if depthwise else w.shape[3]
    _check_down_kernel(c, cout, depthwise)
    device = x.raw.device
    f32 = dict(dtype=torch.float32, device=device)
    wt = _cached_pack(("down", depthwise), [w], lambda: _down_weights(w))
    nw = w.numel()
    length = nw + cout + 2 * c
    rows = _down_tiles(batch, h, wd, depthwise, c, stride)
    part = torch.empty((rows, length), **f32)
    out = torch.empty(length, **f32)
    dx = torch.empty_like(x.raw) if need_dx else None
    # the aligned inputs and dmom stay referenced until the launch
    raw, dy = _aligned(x.raw), _aligned(dy)
    y = None if dmom is None else _aligned(y)
    dmom = None if dmom is None else dmom.contiguous()
    act = 0 if x.scale is None else ACTS[x.act]
    err = _build.library().mmr_fused_conv_down_bwd(
        raw.data_ptr(), _ptr(x.scale), _ptr(x.shift), act, wt.data_ptr(),
        dy.data_ptr(), _ptr(y), _ptr(dmom), _ptr(dx), part.data_ptr(), rows,
        out.data_ptr(), batch, h, wd, c, cout, int(depthwise), stride,
        _stream())
    _raise_on(err, "fused_conv_bwd" if stride == 1 else "fused_conv_down_bwd")
    dpro = ((out[nw + cout:nw + cout + c], out[nw + cout + c:])
            if need_dx and x.scale is not None else None)
    dbias = out[nw:nw + cout] if has_bias else None
    return dx, out[:nw].view(w.shape), dpro, dbias


def fused_conv_down_bwd(x: Pending, w: torch.Tensor, y: torch.Tensor | None,
                        dy: torch.Tensor, dmom: torch.Tensor | None = None,
                        has_bias: bool = False, depthwise: bool = False,
                        need_dx: bool = True):
    """K2's backward (K4): returns ``(dx or None, dW (f32 HWIO), (d scale,
    d shift) or None, dbias or None)``, dx through the prologue's backward
    when ``need_dx``. One kernel launch and the fixed-order addition of its
    blocks' sums: every output is the same on every run."""
    device, batch, cout = _check_down(x, w, None, depthwise)
    h, wd = x.raw.shape[1], x.raw.shape[2]
    shape = (batch, (h + 1) // 2, (wd + 1) // 2, cout)
    _check_grad("dy", dy, shape, device)
    if dmom is not None:
        _check_grad("y", y, shape, device)
    _check_dmom(dmom, cout, device)
    if not _launch_device(device):
        return fused_conv_down_bwd_ref(x, w, y, dy, dmom, has_bias,
                                       depthwise, need_dx)
    out = _down_bwd_launch(x, w, y, dy, dmom, has_bias, depthwise, need_dx, 2)
    fused_conv_down_bwd.launches += 1
    return out


fused_conv_down_bwd.launches = 0


class FusedConvDownFn(torch.autograd.Function):
    """K2 forward, K4 backward. ``forward(ctx, spec, raw, scale, shift, w,
    bias)`` with ``spec = (act, depthwise, emit_moments)``; returns (y,
    moments or an empty tensor). dx is computed only when the raw input
    needs a gradient."""

    @staticmethod
    def forward(ctx, spec, raw, scale, shift, w, bias):
        act, depthwise, emit = spec
        x = Pending(raw, scale, shift, act)
        out = fused_conv_down(x, w, bias, depthwise, emit_moments=emit)
        y, mom = out if emit else (out, None)
        ctx.spec = spec
        ctx.has_bias = bias is not None
        ctx.save_for_backward(raw, scale, shift, w, y)
        if mom is None:
            mom = y.new_zeros((0,), dtype=torch.float32)
            ctx.mark_non_differentiable(mom)
        return y, mom

    @staticmethod
    def backward(ctx, dy, dmom):
        act, depthwise, emit = ctx.spec
        raw, scale, shift, w, y = ctx.saved_tensors
        need_dx = any(ctx.needs_input_grad[1:4])
        dx, dw, dpro, dbias = fused_conv_down_bwd(
            Pending(raw, scale, shift, act), w, y, _grad_bf16(dy),
            dmom if emit else None, ctx.has_bias, depthwise, need_dx)
        ds, dt = dpro if dpro is not None else (None, None)
        return None, dx, ds, dt, dw, dbias


def fused_conv_down_ad(x: Pending, w: torch.Tensor,
                       bias: torch.Tensor | None = None,
                       depthwise: bool = False, emit_moments: bool = False):
    """Differentiable :func:`fused_conv_down` (K2 forward, K4 backward).
    Returns y, or (y, moments)."""
    y, mom = FusedConvDownFn.apply((x.act, depthwise, emit_moments), x.raw,
                                   x.scale, x.shift, w, bias)
    return (y, mom) if emit_moments else y
