"""MixVisionTransformer (SegFormer) encoder, the ``mit_b*`` family;
counterpart of ``mmr_tpu/models/encoders/mix_transformer.py``.

Overlapping patch embeddings (kernel, stride, pad) = (7, 4, 3) then (3,
2, 1), efficient self-attention with a spatial-reduction conv and
LayerNorm where ``sr_ratio > 1``, Mix-FFN with a 3×3 depthwise conv; four
stages at strides 4/8/16/32, so the pyramid is ``[None, s4, s8, s16,
s32]``. Tokens are (B, H·W, C), the NHWC bytes; module names mirror the
flax tree.

The attention keeps JAX's rounding points (``mix_transformer.py:47-50``):
``q·scale`` in the compute dtype, the logits as an f32 product of the
compute-dtype values (``preferred_element_type=float32``), an f32
softmax rounded to the compute dtype, the PV product in f32 rounded once.
A product in bf16 would round the logits before the softmax, and
``scaled_dot_product_attention`` rounds where JAX does not: both are other
functions. These products are XLA in JAX, so plain torch ops here.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from mmr_tpu_torch.models.encoders.convnext import pad_same
from mmr_tpu_torch.models.layers import Conv2d, LayerNorm, Linear, nchw, nhwc


class EfficientAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, sr_ratio: int):
        super().__init__()
        self.num_heads, self.sr_ratio = num_heads, sr_ratio
        self.q = Linear(dim, dim)
        if sr_ratio > 1:
            self.sr = Conv2d(dim, dim, sr_ratio, sr_ratio)
            self.sr_norm = LayerNorm(dim)
        self.k = Linear(dim, dim)
        self.v = Linear(dim, dim)
        self.proj = Linear(dim, dim)

    def forward(self, x, hw):
        b, n, c = x.shape
        heads, sr = self.num_heads, self.sr_ratio
        q = self.q(x)
        kv = x
        if sr > 1:
            xs = self.sr(pad_same(nchw(x.reshape(b, *hw, c)), sr, sr))
            kv = self.sr_norm(nhwc(xs).reshape(b, -1, c))
        k, v = self.k(kv), self.v(kv)
        split = lambda t: t.reshape(b, -1, heads, c // heads).transpose(1, 2)
        q, k, v = split(q), split(k), split(v)
        scale = (c // heads) ** -0.5
        attn = torch.matmul((q * scale).float(), k.float().transpose(-1, -2))
        attn = torch.softmax(attn, -1).to(x.dtype)
        out = torch.matmul(attn.float(), v.float()).to(x.dtype)
        return self.proj(out.transpose(1, 2).reshape(b, n, c))


class MixFFN(nn.Module):
    def __init__(self, dim: int, expand: int = 4):
        super().__init__()
        hidden = dim * expand
        self.fc1 = Linear(dim, hidden)
        self.dwconv = Conv2d(hidden, hidden, 3, 1, 1, groups=hidden)
        self.fc2 = Linear(hidden, dim)

    def forward(self, x, hw):
        b, n, _ = x.shape
        y = self.fc1(x)
        y = nhwc(self.dwconv(nchw(y.reshape(b, *hw, -1)))).reshape(b, n, -1)
        return self.fc2(F.gelu(y))


class MiTBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, sr_ratio: int):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.attn = EfficientAttention(dim, num_heads, sr_ratio)
        self.norm2 = LayerNorm(dim)
        self.mlp = MixFFN(dim)

    def forward(self, x, hw):
        x = x + self.attn(self.norm1(x), hw)
        return x + self.mlp(self.norm2(x), hw)


PATCH = [(7, 4, 3), (3, 2, 1), (3, 2, 1), (3, 2, 1)]   # (kernel, stride, pad)


class MixVisionTransformerEncoder(nn.Module):
    """``forward``: NCHW (channels_last) image -> ``[None, s4, s8, s16,
    s32]``. No BN, no dropout; no fused front end and no output stride."""

    def __init__(self, dims=(64, 128, 320, 512), depths=(3, 4, 6, 3),
                 num_heads=(1, 2, 5, 8), sr_ratios=(8, 4, 2, 1),
                 fused_frontend: bool = False):
        super().__init__()
        if fused_frontend:
            raise NotImplementedError(
                "the fused front-end exists for the MobileNetV3 stem only")
        self.depths = tuple(depths)
        cin = 3
        for i, (dim, depth) in enumerate(zip(dims, depths)):
            k, s, p = PATCH[i]
            self.add_module(f"patch_embed{i + 1}", Conv2d(cin, dim, k, s, p))
            self.add_module(f"patch_norm{i + 1}", LayerNorm(dim))
            for blk in range(depth):
                self.add_module(f"stage{i + 1}_block{blk}",
                                MiTBlock(dim, num_heads[i], sr_ratios[i]))
            self.add_module(f"norm{i + 1}", LayerNorm(dim))
            cin = dim

    def forward(self, x):
        feats = [None]
        for i, depth in enumerate(self.depths):
            x = getattr(self, f"patch_embed{i + 1}")(x)
            b, c, h, w = x.shape
            t = getattr(self, f"patch_norm{i + 1}")(nhwc(x).reshape(b, h * w, c))
            for blk in range(depth):
                t = getattr(self, f"stage{i + 1}_block{blk}")(t, (h, w))
            t = getattr(self, f"norm{i + 1}")(t)
            x = nchw(t.reshape(b, h, w, c))
            feats.append(x)
        return feats
