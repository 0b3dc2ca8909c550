"""The wrapper-side arithmetic of the Hopper kernels (``common.cuh``'s
cp.async + wgmma mainloops under K1, K3's dx and dW, K5b, K6 and K8): the
tap pack (``_pack_taps``; one pack shared by the inputs of one K3 dx
launch, ``_dx_packs``; K1's over the concat of its inputs' 16-channel
chunks, ``_concat_taps``), the 16 combined taps of a lazily ×2-upsampled
input's source-resolution dx as bf16 pairs hi + lo (``_up2_taps``), the dW
layout (``_unpack_dw_wg``), K5b's per-block sums and their reduction, and
the packs' cache per weight version (``_cached_pack``), each held against
the HWIO math or the plain version it replaces.

The kernels run only on the card; here torch emulates what they compute
from the packs: the stride-1 conv as 9 shifted products, the
source-resolution dx as one 4×4 stride-2 correlation of the fine dy at
fine offsets −1..2, dW as 9 shifted products into the (9, cpad, np)
buffer. Bounds: f32 at 1e-5 of the largest value where nothing is rounded
(weights chosen bf16-representable, so the pack's rounding is exact);
with the combined taps as the kernel reads them (the pair's lo half
rounded to bf16), max|Δ|/max|ref| and ‖Δ‖/‖ref‖ < 1e-2, the card's bound
for backward outputs, on dx, d scale and d shift. The emulation is checked
once against JAX's interpreted K3, whose ``toeplitz_up`` rounds the summed
taps to bf16.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F
import jax
import jax.numpy as jnp

import mmr_tpu.ops.pallas.packed_chain as pc
from mmr_tpu_torch.ops.conv3x3_packed import conv3x3_dw_ref, conv3x3_ref
from mmr_tpu_torch.ops.fused_conv import (BF16, Pending, _cached_pack,
                                          _concat_taps, _dx_packs, _dx_taps,
                                          _pack_taps, _prologue_bwd,
                                          _unpack_dw_wg, _up2_taps, _wg_tile,
                                          activated, fused_conv_bwd_ref,
                                          fused_conv_ref, moments)
from mmr_tpu_torch.ops.head_loss import dlogits_ref, head_loss_bwd_ref
from mmr_tpu_torch.ops.resize import upsample2x
from tests.test_torch_train_modules import few_torch_threads  # noqa: F401

F32 = torch.float32


def _bf16_valued(a) -> torch.Tensor:
    """numpy -> f32 tensor of bf16-representable values."""
    return torch.from_numpy(np.asarray(a, np.float32)).to(BF16).float()


def _unpack_taps(pack, k, n):
    """The pack's (T, K, N) taps, read back by its layout."""
    t, np_ = pack.shape[1], pack.shape[3]
    return pack.permute(1, 0, 2, 4, 3).reshape(t, -1, np_)[:, :k, :n].float()


def _conv_taps(x, taps):
    """y(p) = Σ_t x(p + t − 1) · taps[t], t = 3·ky + kx: the stride-1
    kernel's product over its tap pack (zero outside the image)."""
    b, h, w, _ = x.shape
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    return sum(xp[:, ky:ky + h, kx:kx + w] @ taps[3 * ky + kx]
               for ky in range(3) for kx in range(3))


def _up2_dx(g, taps):
    """The source-resolution dx kernel: Σ over fine offsets oy, ox ∈ −1..2
    of g(2Y + oy, 2X + ox) · (hi + lo)[4·(oy + 1) + (ox + 1)], with taps
    (32, K, N) = 16 hi then 16 lo."""
    k, n = taps.shape[1:]
    w = (taps[:16] + taps[16:]).reshape(4, 4, k, n).permute(3, 2, 0, 1)
    return F.conv2d(F.pad(g.permute(0, 3, 1, 2), (1, 1, 1, 1)), w,
                    stride=2).permute(0, 2, 3, 1)


def _rel(got, want):
    d = (got - want).abs()
    return (d.max() / want.abs().max()).item(), (d.norm() / want.norm()).item()


def test_pack_taps_layout(rng):
    taps = torch.from_numpy(rng.randn(9, 40, 20).astype(np.float32))
    tile, np_ = _wg_tile(20)
    assert (tile, np_) == (32, 32)
    assert _wg_tile(10) == (16, 16) and _wg_tile(200) == (64, 256)
    assert _wg_tile(200, 32) == (32, 224)
    pack = _pack_taps(taps, np_)
    assert pack.shape == (3, 9, 2, np_, 8) and pack.dtype == BF16
    k, t, g, n, i = np.meshgrid(*map(np.arange, pack.shape), indexing="ij")
    ci = 16 * k + 8 * g + i
    inside = (ci < 40) & (n < 20)
    want = np.zeros(pack.shape, np.float32)
    ref = taps.to(BF16).float().numpy()
    want[inside] = ref[t[inside], ci[inside], n[inside]]
    np.testing.assert_array_equal(pack.float().numpy(), want)


@pytest.mark.parametrize("cin,cout", [(24, 10), (40, 72)])
def test_conv_and_dx_packs_match_hwio(rng, cin, cout):
    """K6a's forward pack and the dx pack (flipped, transposed taps) of K6a
    and K3 reproduce the HWIO conv and its input gradient."""
    x = torch.from_numpy(rng.randn(2, 9, 12, cin).astype(np.float32))
    w = _bf16_valued(rng.randn(3, 3, cin, cout) * 0.2)
    g = torch.from_numpy(rng.randn(2, 9, 12, cout).astype(np.float32))
    np_ = _wg_tile(cout)[1]
    y = _conv_taps(x, _unpack_taps(_pack_taps(w.reshape(9, cin, cout), np_),
                                   cin, cout))
    ref = conv3x3_ref(x, w, dtype=F32)
    assert _rel(y, ref)[0] < 1e-5
    dx = _conv_taps(g, _unpack_taps(_pack_taps(_dx_taps(w), _wg_tile(cin)[1]),
                                    cout, cin))
    ref = fused_conv_bwd_ref([Pending(x)], [w], None, g, dtype=F32)[0][0]
    assert _rel(dx, ref)[0] < 1e-5


def test_shared_dx_pack_matches_hwio(rng):
    """K3's one dx launch for the inputs that are not lazily upsampled: the
    shared pack's columns (each input's channels padded to 8, in input
    order) reproduce each input's dx; a lazily ×2 input keeps its own."""
    cs, cout = (16, 5, 24), 12
    xs = [torch.from_numpy(rng.randn(2, 6, 10, c).astype(np.float32))
          for c in cs]
    ws = [_bf16_valued(rng.randn(3, 3, c, cout) * 0.2) for c in cs]
    g = torch.from_numpy(rng.randn(2, 6, 10, cout).astype(np.float32))
    up = Pending(torch.zeros(2, 3, 5, 8), up2x=True)
    inputs = [Pending(xs[0]), up, Pending(xs[1]), Pending(xs[2])]
    weights = [ws[0], torch.zeros(3, 3, 8, cout), ws[1], ws[2]]
    packs, tiles = _dx_packs(inputs, weights)
    assert packs[0] is packs[2] is packs[3] and tiles[0] == (64, 64)
    assert packs[1].shape[1] == 32 and tiles[1] == (16, 16)
    y = _conv_taps(g, _unpack_taps(packs[0], cout, 64))
    ref = fused_conv_bwd_ref([Pending(x) for x in xs], ws, None, g,
                             dtype=F32)[0]
    for col, c, want in zip((0, 16, 24), cs, ref):
        assert _rel(y[..., col:col + c], want)[0] < 1e-5


def test_dw_layout_matches_hwio(rng):
    """K3's dW over three inputs (their channels padded to 8: rows from 0,
    40 and 48 of the (9, cpad, np) buffer) and K6b's, unpacked, equal the
    HWIO weight gradients."""
    xs = [torch.from_numpy(rng.randn(2, 8, 10, c).astype(np.float32))
          for c in (40, 5, 24)]
    g = torch.from_numpy(rng.randn(2, 8, 10, 20).astype(np.float32))
    np_ = _wg_tile(20)[1]
    starts = (0, 40, 48)
    dwp = torch.zeros(9, 128, np_)
    for x, row0 in zip(xs, starts):
        xp = F.pad(x, (0, 0, 1, 1, 1, 1))
        for t in range(9):
            a = xp[:, t // 3:t // 3 + 8, t % 3:t % 3 + 10]
            dwp[t, row0:row0 + x.shape[3], :20] = torch.einsum(
                "bhwc,bhwn->cn", a, g)
    ws = [torch.zeros(3, 3, x.shape[3], 20) for x in xs]
    ref = fused_conv_bwd_ref([Pending(x) for x in xs], ws, None, g,
                             dtype=F32)[1]
    for x, row0, want in zip(xs, starts, ref):
        got = _unpack_dw_wg(dwp, row0, x.shape[3], 20)
        assert _rel(got, want)[0] < 1e-5
        assert _rel(got, conv3x3_dw_ref(x, g))[0] < 1e-5


def test_up2_taps_f32(rng):
    """Unrounded combined taps: the 4×4 stride-2 correlation equals the
    fine transposed conv summed 2×2 (the plain K3), at 1e-5."""
    c, cout = 12, 20
    x = torch.from_numpy(rng.randn(2, 5, 7, c).astype(np.float32))
    w = _bf16_valued(rng.randn(3, 3, c, cout) * 0.2)
    g = torch.from_numpy(rng.randn(2, 10, 14, cout).astype(np.float32))
    got = _up2_dx(g, _up2_taps(w))
    ref = fused_conv_bwd_ref([Pending(x, up2x=True)], [w], None, g,
                             dtype=F32)[0][0]
    assert got.shape == ref.shape == (2, 5, 7, c)
    assert _rel(got, ref)[0] < 1e-5


@pytest.mark.parametrize("c,cout", [(21, 16), (40, 72)])
def test_up2_dx_packed_taps(rng, c, cout):
    """The combined taps as the kernel reads them (bf16 hi + lo pairs,
    through the pack) and its prologue backward, against the plain K3 (bf16
    weights, fine products, 2×2 sum): within the card's backward bound."""
    x = torch.from_numpy(rng.randn(2, 6, 8, c).astype(np.float32)).to(BF16)
    s = torch.from_numpy(rng.rand(c).astype(np.float32) + 0.5)
    t = torch.from_numpy(rng.randn(c).astype(np.float32) * 0.3)
    w = torch.from_numpy(rng.randn(3, 3, c, cout).astype(np.float32) * 0.2)
    dy = torch.from_numpy(rng.randn(2, 12, 16, cout).astype(np.float32))
    dy = dy.to(BF16)
    p = Pending(x, s, t, "relu", up2x=True)
    pack = _pack_taps(_up2_taps(w), _wg_tile(c)[1])
    ga = _up2_dx(dy.float(), _unpack_taps(pack, cout, c))
    dx, (ds, dt) = _prologue_bwd(ga, p)
    dxs, _, dpros, _ = fused_conv_bwd_ref([p], [w], None, dy)
    for got, want in ((dx.to(BF16).float(), dxs[0].float()), (ds, dpros[0][0]),
                      (dt, dpros[0][1])):
        rel, l2 = _rel(got, want)
        assert rel < 1e-2 and l2 < 1e-2, (rel, l2)


def test_up2_dx_matches_jax_interpreted(rng, monkeypatch):
    """The emulated source-resolution dx of one lazily ×2-upsampled input
    with a relu prologue vs JAX's K3 (``packed_chain.fused_conv``'s VJP,
    Pallas interpreted) at the geometry of ``TestFusedUpsample``."""
    monkeypatch.setattr(pc, "_INTERPRET", True)
    g_src, g_dst = pc.RowGeom(4, 64, 8, 8, 16), pc.RowGeom(8, 128, 8, 16, 24)
    c, cout = 5, 6
    xs = rng.randn(2, g_src.h, g_src.w, c).astype(np.float32)
    w = (rng.randn(3, 3, c, cout) * 0.1).astype(np.float32)
    s = (rng.rand(c) + 0.5).astype(np.float32)
    t = (rng.randn(c) * 0.3).astype(np.float32)
    gy = rng.randn(2, g_dst.h, g_dst.w, cout).astype(np.float32)
    cfg = pc.FusedCfg(
        geom=g_dst, l_list=(g_src.lanes(c),), lo=g_dst.lanes(cout),
        pro_mask=("relu",), has_bias=False, emit_moments=False,
        up_spec=(pc.up_spec_for(g_src, g_dst, c),))
    lanes = lambda v: jnp.tile(jnp.pad(v, (0, g_src.cp(c) - c)), g_src.p)

    def loss(xs):
        y = pc.fused_conv(cfg, (pc.to_packed(xs, g_src),), (jnp.asarray(w),),
                          (jnp.stack([lanes(s), lanes(t)]),), None)[0]
        return jnp.sum(pc.from_packed(y, g_dst, cout).astype(jnp.float32) * gy)

    want = torch.from_numpy(np.asarray(jax.grad(loss)(jnp.asarray(xs))))
    p = Pending(torch.from_numpy(xs).to(BF16), torch.from_numpy(s),
                torch.from_numpy(t), "relu", up2x=True)
    taps = _unpack_taps(_pack_taps(_up2_taps(torch.from_numpy(w)), 16), cout, c)
    assert taps.shape == (32, cout, c)
    dy = torch.from_numpy(gy).to(BF16).float()
    dx = _prologue_bwd(_up2_dx(dy, taps), p)[0].to(BF16).float()
    rel, l2 = _rel(dx, want)
    assert rel < 1e-2 and l2 < 1e-2, (rel, l2)


def _k1_emulated(inputs, weights, bias, np_):
    """K1 as ``pending_conv_kernel`` computes it from its pack: the K loop
    over the 16-channel chunks of all inputs in concat order (input j's
    chunks from chunk0 = the chunks before it), each chunk's A the input's
    prologue'd channels [16k, 16k + 16) (bf16, at fine resolution: a lazy
    input's pixel (y, x) is its source pixel (y/2, x/2)), zero beyond its
    channels; the f32 products with the chunk's 9 taps, + bias. Returns the
    f32 y and its moments."""
    cout = weights[0].shape[3]
    k = sum(-(-p.c // 16) * 16 for p in inputs)
    taps = _unpack_taps(_pack_taps(_concat_taps(weights), np_), k, cout)
    y, chunk0 = bias.float().clone(), 0
    for p in inputs:
        a = activated(p)
        a = F.pad(upsample2x(a) if p.up2x else a, (0, -p.c % 16))
        for ch in range(a.shape[3] // 16):
            y = y + _conv_taps(a[..., 16 * ch:16 * ch + 16],
                               taps[:, 16 * (chunk0 + ch):16 * (chunk0 + ch + 1)])
        chunk0 += a.shape[3] // 16
    return y, moments(y)


def test_k1_concat_pack_matches_hwio(rng):
    """K1's pack over three inputs of 24, 5 and 48 channels (chunks padded
    to 16) and no prologue, bf16-valued: its chunked K loop equals the HWIO
    conv of their concat at 1e-5."""
    cs, cout = (24, 5, 48), 40
    ins = [Pending(_bf16_valued(rng.randn(2, 7, 9, c))) for c in cs]
    ws = [_bf16_valued(rng.randn(3, 3, c, cout) * 0.2) for c in cs]
    bias = _bf16_valued(rng.randn(cout))
    y, _ = _k1_emulated(ins, ws, bias, _wg_tile(cout)[1])
    assert _rel(y, fused_conv_ref(ins, ws, bias, dtype=F32))[0] < 1e-5


def test_k1_staging_matches_plain_version(rng):
    """The staging K1 does in registers — each input's prologue (relu,
    hswish, linear, none) in f32 rounded to bf16, the lazy ×2 of a
    32-channel input, 24- and 48-channel skips — against
    ``fused_conv_ref``: moments within 1e-5 of the largest, y within one
    bf16 rounding."""
    spec = [(32, True, "relu"), (24, False, "hswish"), (48, False, "linear"),
            (24, False, None)]
    cout, (h, w) = 24, (8, 12)
    ins, ws = [], []
    for c, up, act in spec:
        x = torch.from_numpy(rng.randn(2, h // 2 if up else h,
                                       w // 2 if up else w, c)).to(BF16)
        s = torch.from_numpy(rng.rand(c).astype(np.float32) + 0.5)
        t = torch.from_numpy(rng.randn(c).astype(np.float32) * 0.3)
        ins.append(Pending(x, up2x=up) if act is None
                   else Pending(x, s, t, act, up))
        ws.append(torch.from_numpy(rng.randn(3, 3, c, cout).astype(np.float32) * 0.1))
    bias = torch.from_numpy(rng.randn(cout).astype(np.float32))
    y, mom = _k1_emulated(ins, ws, bias, _wg_tile(cout)[1])
    y_ref, mom_ref = fused_conv_ref(ins, ws, bias, emit_moments=True)
    assert (mom - mom_ref).abs().max() <= 1e-5 * mom_ref.abs().max()
    assert _within_bf16(y.to(BF16), y_ref)


def _within_bf16(got, want):
    """Equal up to one bf16 rounding: |Δ| ≤ 2⁻⁷·|want| + 1e-6."""
    d = (got.float() - want.float()).abs()
    return bool((d <= 2 ** -7 * want.float().abs() + 1e-6).all())


def _k5b_rows(x, w, logp, labels, dstats, blocks):
    """K5b's block sums: block b takes tiles b, b + blocks, ... (4 rows x 64
    pixels, in (sample, row, column) order) and sums over its tiles' own
    pixels dW (the prologue'd bf16 input at p + t - 1 times the bf16
    d(logits) at p), dbias (the f32 d(logits)) and dscale, dshift (the
    prologue's backward of dx), into a row of 9*N*16 + 16 + 2N; also the
    whole dx. N: the input's channels padded to the 16 or 32 tile."""
    n, h, wd, c = x.raw.shape
    nc, np_ = w.shape[3], _wg_tile(x.c)[0]
    dl = dlogits_ref(logp, labels, dstats)
    dlb = dl.to(BF16).float()
    a = F.pad(activated(x), (0, 0, 1, 1, 1, 1))
    ga = _conv_taps(dlb, _dx_taps(w.to(BF16).float()))
    dx, _ = _prologue_bwd(ga, x)
    gm = ga * (x.raw.float() * x.scale + x.shift > 0)
    tiles = [(b, r, q) for b in range(n) for r in range(0, h, 4)
             for q in range(0, wd, 64)]
    rows = torch.zeros(blocks, 9 * np_ * 16 + 16 + 2 * np_, dtype=torch.float64)
    for i, (b, r, q) in enumerate(tiles):
        row, sl = rows[i % blocks], (b, slice(r, r + 4), slice(q, q + 64))
        d = F.pad(dlb[sl], (0, 16 - nc)).double()
        for t in range(9):
            at = a[b, r + t // 3:r + t // 3 + 4, q + t % 3:q + t % 3 + 64]
            at = F.pad(at[:, :d.shape[1]], (0, np_ - c)).double()
            row[t * np_ * 16:(t + 1) * np_ * 16] += torch.einsum(
                "yxc,yxk->ck", at[:d.shape[0]], d).reshape(-1)
        tail = row[9 * np_ * 16:]
        tail[:nc] += dl[sl].double().sum((0, 1))
        tail[16:16 + c] += (gm[sl] * x.raw[sl].float()).double().sum((0, 1))
        tail[16 + np_:16 + np_ + c] += gm[sl].double().sum((0, 1))
    return rows, dx.to(BF16)


def test_k5b_block_sums_reduce_to_plain(rng):
    """K5b's per-block sums on a ragged image (H = 9, W = 70: tiles cut by
    both edges), reduced in block order and decoded as
    ``head_bwd_reduce_kernel`` does, give ``head_loss_bwd_ref``'s dW,
    dbias, dscale and dshift (1e-5 of the largest) and its dx."""
    n, h, wd, c, nc = 2, 9, 70, 16, 10
    x = Pending(torch.from_numpy(rng.randn(n, h, wd, c)).to(BF16),
                torch.from_numpy(rng.rand(c).astype(np.float32) + 0.5),
                torch.from_numpy(rng.randn(c).astype(np.float32) * 0.3), "relu")
    w = torch.from_numpy(rng.randn(3, 3, c, nc).astype(np.float32) * 0.3)
    labels = torch.from_numpy(rng.randint(-1, nc, (n, h, wd)))
    logp = torch.log_softmax(torch.from_numpy(rng.randn(n, h, wd, nc)) * 2, -1)
    logp = logp.to(BF16)
    dstats = torch.from_numpy(rng.randn(n, 4, nc).astype(np.float32) * 1e-3)
    rows, dx = _k5b_rows(x, w, logp, labels, dstats, blocks=3)
    s, np_ = rows.sum(0).float(), 16
    dw = s[:9 * np_ * 16].reshape(3, 3, np_, 16)[:, :, :c, :nc]
    tail = s[9 * np_ * 16:]
    got = [dw, tail[:nc], tail[16:16 + c], tail[16 + np_:16 + np_ + c]]
    dx_r, dw_r, (ds_r, dt_r), db_r = head_loss_bwd_ref(x, w, logp, labels,
                                                       dstats)
    for g, want in zip(got, [dw_r, db_r, ds_r, dt_r]):
        assert _rel(g, want)[0] < 1e-5
    assert _within_bf16(dx, dx_r)


def test_pack_cache_follows_weight_versions(rng):
    """A pack is built once per weight version: the same weights give the
    same pack object; an in-place change of a weight, or of the flat buffer
    a weight is a view of (as the optimizer's step is), gives a new pack
    of the new values; an inference tensor is packed anew every call."""
    built = []

    def pack(ws):
        return _cached_pack(("test", 16), ws, lambda: built.append(1) or
                            _pack_taps(_concat_taps(ws), 16))

    w = torch.from_numpy(rng.randn(3, 3, 8, 16).astype(np.float32))
    p1 = pack([w])
    assert pack([w]) is p1 and len(built) == 1
    w.mul_(2.0)
    p2 = pack([w])
    assert p2 is not p1 and len(built) == 2
    assert torch.equal(p2.float(), 2 * p1.float())
    flat = torch.from_numpy(rng.randn(2 * 3 * 3 * 8 * 16).astype(np.float32))
    parts = [v.view(3, 3, 8, 16) for v in flat.split(3 * 3 * 8 * 16)]
    p3 = pack(parts)
    assert pack(parts) is p3
    flat.add_(1.0)
    p4 = pack(parts)
    assert p4 is not p3
    assert torch.equal(p4, pack([v.clone() for v in parts]))
    with torch.inference_mode():
        wi = w.clone()
        n = len(built)
        pack([wi]), pack([wi])
    assert len(built) == n + 2
