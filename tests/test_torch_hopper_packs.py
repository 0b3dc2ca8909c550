"""The wrapper-side arithmetic of the Hopper kernels (``common.cuh``'s
cp.async + wgmma mainloops under K1, K3's dx and dW, K5b, K6 and K8): the
tap pack (``_pack_taps``; one pack shared by the inputs of one K3 dx
launch, ``_dx_packs``; K1's over the concat of its inputs' 16-channel
chunks, ``_concat_taps``), the 16 combined taps of a lazily ×2-upsampled
input's source-resolution dx as bf16 pairs hi + lo (``_up2_taps``), the dW
layout of K3 (``_unpack_dw_wg``), K6b's and K8b's own dW partition
(``conv3x3.cu``'s ``conv3x3_dw_kernel``), K5b's per-block sums and their
reduction, the narrow tile's mma.sync B fragments (``_narrow_frags``) and
K5a's per-block statistics and their reduction, the
stride-2 pair's tiles (``_down_tiles``), dense K2's mma.sync B fragments
(``_stem_frags``) and patch matrix, and K2's and K4's per-block sums and
their reduction, and the packs' cache per weight version
(``_cached_pack``), each held against the HWIO math or the plain version
it replaces.

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
from mmr_tpu_torch.ops.fused_conv import (BF16, DOWN_TILE, Pending,
                                          _cached_pack, _concat_taps,
                                          _corrected_dy, _down_tiles,
                                          _dx_packs, _dx_taps, _narrow_frags,
                                          _pack_taps, _prologue_bwd,
                                          _stem_frags,
                                          _unpack_dw_wg, _up2_taps, _wg_tile,
                                          act_grad, activated,
                                          fused_conv_bwd_ref,
                                          fused_conv_down_bwd_ref,
                                          fused_conv_down_ref, fused_conv_ref,
                                          moments)
from mmr_tpu_torch.ops.head_loss import (dlogits_ref, head_loss_bwd_ref,
                                         head_loss_fwd_ref)
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
    40 and 48 of the (9, cpad, np) buffer), unpacked by ``_unpack_dw_wg``,
    equals the HWIO weight gradients of ``fused_conv_bwd_ref`` and of the
    standalone conv's plain dW (K6b writes HWIO itself and does not come
    here: ``test_dw_kernel_partition_matches_plain``)."""
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


def _dw_cfg(cin, cout):
    """``conv3x3.cu``'s ``DwCfg`` for these channels: (x channels a block,
    output channels a block N, rows of a pixel tile, warps splitting the K
    steps of a tile)."""
    mode = 0 if cin <= 16 else 1 if cin <= 32 else 2
    n = 16 if cout <= 16 else 32 if cout <= 32 else 64
    groups = 8 if mode == 2 else 2 * (mode + 1)

    def fits(r):   # 2 stages of r tile rows in the narrow modes' 113 KB
        halo = -(-(r + 2) * 66 // 8) * 8
        return 2 * 16 * (groups * halo + n // 8 * r * 64) <= 113 * 1024

    rows = 3 if mode == 2 else next((r for r in (12, 8, 4) if fits(r)), 2)
    kg = 1 if mode == 2 else 8 // (n // (8 * (2 // (mode + 1))))
    return 8 * groups, n, rows, kg


def _dw_rows(x, g, grid_rows):
    """``conv3x3_dw_kernel``'s block sums: grid row r takes pixel tiles r,
    r + grid_rows, ... (tile rows x 64 pixels, in (image, row, column)
    order); its x tile is the (rows + 2) x 66 halo, flattened to one
    16-byte row a pixel, its channels padded to the block's M (16 or 32:
    the mma.sync fragments; a 64-channel chunk on wgmma); each 16-pixel K
    step multiplies x at tap t's shift ((rr + t // 3) * 66 + px + t % 3)
    by g, into the sums of warp ks % kKG; the warps' sums are added in
    order. Returns (grid_rows, 9, cpad, np)."""
    n, h, w, cin = x.shape
    cout = g.shape[3]
    m, nt, tr, kg = _dw_cfg(cin, cout)
    cpad, np_ = m * -(-cin // m), nt * -(-cout // nt)
    ty, tx = -(-h // tr), -(-w // 64)
    xp = F.pad(x, (0, cpad - cin, 1, tx * 64 + 1 - w, 1, ty * tr + 1 - h))
    gp = F.pad(g, (0, np_ - cout, 0, tx * 64 - w, 0, ty * tr - h))
    acc = torch.zeros(grid_rows, kg, 9, cpad, np_)
    for t in range(n * ty * tx):
        b, r = divmod(t, ty * tx)
        py0, px0 = r // tx * tr, r % tx * 64
        halo = xp[b, py0:py0 + tr + 2, px0:px0 + 66].reshape(-1, cpad)
        gt = gp[b, py0:py0 + tr, px0:px0 + 64].reshape(-1, np_)
        for ks in range(tr * 4):
            rr, px = ks // 4, ks % 4 * 16
            gk = gt[rr * 64 + px:rr * 64 + px + 16]
            for tap in range(9):
                u0 = (rr + tap // 3) * 66 + px + tap % 3
                acc[t % grid_rows, ks % kg, tap] += halo[u0:u0 + 16].T @ gk
    part = acc[:, 0]
    for k in range(1, kg):
        part = part + acc[:, k]
    return part


@pytest.mark.parametrize("cin,cout,grid_rows", [(5, 10, 3), (24, 64, 5),
                                                (72, 80, 4), (16, 16, 2),
                                                (40, 16, 3)])
def test_dw_kernel_partition_matches_plain(rng, cin, cout, grid_rows):
    """K6b's and K8b's kernel partition on a ragged image (H = 9, W = 70:
    tiles cut by both edges): narrow M (cin 5 and 16 in one 16-channel
    fragment, tiles of 12 rows; 24 in two; 40 and 72 in one and two
    64-channel chunks, tiles of 3 rows), the block walk over pixel
    tiles, the warps' sums and the grid rows added in order, read back in
    HWIO as ``dw_rows_reduce_kernel`` does, equal ``conv3x3_dw_ref`` (1e-5
    of the largest value)."""
    x = _bf16_valued(rng.randn(2, 9, 70, cin))
    g = _bf16_valued(rng.randn(2, 9, 70, cout))
    part = _dw_rows(x, g, grid_rows)
    dw = part[0]
    for r in range(1, grid_rows):
        dw = dw + part[r]
    got = dw[:, :cin, :cout].reshape(3, 3, cin, cout)
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


def _seq_sum(t, dim):
    """Sum over ``dim`` in index order, one f32 addition at a time."""
    acc = torch.zeros_like(t.select(dim, 0))
    for i in range(t.shape[dim]):
        acc = acc + t.select(dim, i)
    return acc


def _tree_sum(t):
    """The xor-shuffle butterfly over the last dim (8 lanes): pairwise."""
    while t.shape[-1] > 1:
        t = t[..., 0::2] + t[..., 1::2]
    return t[..., 0]


def _k5a_rows(logits, labels, blocks, rows=12):
    """K5a's block rows (``narrow_head_kernel`` at cin <= 16): tiles of 12
    rows x 64 pixels, in (sample, row, column) order, block i taking tiles
    i, i + blocks, ...; warp w the 16-pixel column segment w % 4 of tile
    rows 6 (w // 4) .. 6 (w // 4) + 5; lane 4g + q classes 2q, 2q + 1, 8 +
    2q, 9 + 2q of pixels g, g + 8 of each m-tile. Per pixel the quad's sum of
    exponentials (each lane's 4 in order, then the quad pairwise); per lane
    its classes' sums over the tile (m-tiles, then the two pixels, in
    order), pairwise over the 8 pixel lanes, the 8 warps in order, into the
    sample's row: (blocks, n, 4, 16) f32. Also the block's confusion counts
    (blocks, 16, 16)."""
    n, h, wd, nc = logits.shape
    v = F.pad(logits, (0, 16 - nc))
    on = torch.arange(16) < nc
    m = v.masked_fill(~on, -torch.inf).amax(-1, keepdim=True)
    z = torch.where(on, torch.exp(v - m), 0.0)
    lanes = torch.stack([_seq_sum(z[..., [2 * q, 2 * q + 1, 8 + 2 * q, 9 + 2 * q]], -1)
                         for q in range(4)], -1)
    tot = ((lanes[..., 0] + lanes[..., 1]) + (lanes[..., 2] + lanes[..., 3]))[..., None]
    lse = torch.log(tot) + m
    pr = torch.where(on, z / tot, 0.0)
    oh = labels.long()[..., None] == torch.arange(16)
    vals = torch.stack([pr, oh.float(), pr * oh, torch.where(oh, lse - v, 0.0)], -2)
    ty, tx = -(-h // rows), -(-wd // 64)
    vals = F.pad(vals, (0, 0, 0, 0, 0, 64 * tx - wd, 0, rows * ty - h))
    # (n, ty, wr, i, tx, seg, h, g, 4, 16): tile row (rows / 2) wr + i,
    # column 16 seg + 8 h + g
    vals = vals.reshape(n, ty, 2, rows // 2, tx, 4, 2, 8, 4, 16)
    # each lane: its m-tiles in order, the two pixels of each in order
    lane = _seq_sum(vals.permute(0, 1, 2, 4, 5, 7, 8, 9, 3, 6).reshape(
        n, ty, 2, tx, 4, 8, 4, 16, rows), -1)
    lane = lane.permute(0, 1, 3, 2, 4, 6, 7, 5)       # (n, ty, tx, wr, seg, 4, 16, g)
    warp = _tree_sum(lane).reshape(n, ty, tx, 8, 4, 16)
    tile = _seq_sum(warp, 3)                          # the warps in order
    pred = v.masked_fill(~on, -torch.inf).argmax(-1)
    ok = (labels >= 0) & (labels < nc)
    out = torch.zeros(blocks, n, 4, 16)
    conf = torch.zeros(blocks, 16, 16, dtype=torch.int64)
    t = 0
    for b in range(n):
        for y in range(ty):
            for x in range(tx):
                out[t % blocks, b] = out[t % blocks, b] + tile[b, y, x]
                sl = (b, slice(rows * y, rows * y + rows), slice(64 * x, 64 * x + 64))
                conf[t % blocks].index_put_((pred[sl][ok[sl]], labels[sl][ok[sl]].long()),
                                            torch.tensor(1), accumulate=True)
                t += 1
    return out, conf


def test_k5a_block_rows_reduce_to_plain(rng):
    """K5a's per-block rows on a ragged image (H = 29, W = 150: tiles cut by
    both edges), from the plain version's logits, added over the rows in
    ``head_rows_reduce_kernel``'s order (row phases, each in row order,
    then the phases in order), give ``head_loss_fwd_ref``'s statistics
    within 1e-5 of the largest and its confusion exactly."""
    n, h, wd, c, nc, blocks = 2, 29, 150, 16, 10, 5
    x = Pending(torch.from_numpy(rng.randn(n, h, wd, c)).to(BF16),
                torch.from_numpy(rng.rand(c).astype(np.float32) + 0.5),
                torch.from_numpy(rng.randn(c).astype(np.float32) * 0.3), "relu")
    w = torch.from_numpy(rng.randn(3, 3, c, nc).astype(np.float32) * 0.3)
    bias = torch.from_numpy(rng.randn(nc).astype(np.float32) * 0.1)
    labels = torch.from_numpy(rng.randint(-1, nc + 1, (n, h, wd)))
    logits = F.conv2d(activated(x).permute(0, 3, 1, 2),
                      w.to(BF16).float().permute(3, 2, 0, 1), bias,
                      padding=1).permute(0, 2, 3, 1)
    rows, conf = _k5a_rows(logits, labels, blocks)
    phases = 1
    while phases < 32 and blocks > 16 * phases:
        phases *= 2
    stats = _seq_sum(torch.stack([_seq_sum(rows[k::phases], 0)
                                  for k in range(phases)]), 0)[:, :, :nc]
    _, stats_r, conf_r = head_loss_fwd_ref(x, w, bias, labels)
    assert (stats - stats_r).abs().max() <= 1e-5 * stats_r.abs().max()
    assert torch.equal(conf.sum(0)[:nc, :nc].float(), conf_r)


@pytest.mark.parametrize("cin,cout", [(3, 16), (16, 10), (24, 32), (48, 16)])
def test_narrow_frags_layout(rng, cin, cout):
    """The narrow tile's B fragments (``_narrow_frags``) read back lane by
    lane give the tap matrices, zero padded; their conv (9 shifted
    products) is ``conv3x3_ref``'s."""
    k16 = 1 if cin <= 16 else 2 * -(-cin // 32)
    nf = 2 if cout <= 16 else 4
    w = _bf16_valued(rng.randn(3, 3, cin, cout))
    frags = _narrow_frags(w.reshape(9, cin, cout), k16, nf)
    assert frags.shape == (k16, 9, 32, nf, 4) and frags.dtype == BF16
    taps = torch.zeros(9, 16 * k16, 8 * nf)
    for lane in range(32):
        g, q = divmod(lane, 4)
        for f in range(nf):
            for j, dk in enumerate((0, 1, 8, 9)):
                taps[:, torch.arange(k16) * 16 + 2 * q + dk, 8 * f + g] = \
                    frags[:, :, lane, f, j].T.float()
    assert torch.equal(taps[:, :cin, :cout], w.reshape(9, cin, cout))
    assert not taps[:, cin:].any() and not taps[:, :, cout:].any()
    x = _bf16_valued(rng.randn(2, 9, 13, cin))
    got = _conv_taps(x, taps[:, :cin, :cout])
    assert (got - conv3x3_ref(x.to(BF16), w, dtype=F32)).abs().max() <= \
        1e-5 * got.abs().max()


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


# ------------------------------------------------------------ K2 + K4

def _down_tile_list(n, h, w, depthwise):
    """The stride-2 kernels' output tiles (b, r0, c0), in block order."""
    th, tw = DOWN_TILE[depthwise]
    return [(b, r, c) for b in range(n) for r in range(0, (h + 1) // 2, th)
            for c in range(0, (w + 1) // 2, tw)]


def _src_tile(a, b, r0, c0, tw):
    """A tile's staged source values: rows 2·r0 − 1 .. 2·r0 + 7, columns
    2·c0 − 1 .. 2·c0 + 2·tw − 1 of ``a``, zero outside the image."""
    h, w = a.shape[1:3]
    t = torch.zeros(9, 2 * tw + 1, a.shape[3], dtype=a.dtype)
    y0, x0 = 2 * r0 - 1, 2 * c0 - 1
    ys, xs = slice(max(0, y0), min(h, y0 + 9)), slice(max(0, x0), min(w, x0 + 2 * tw + 1))
    t[ys.start - y0:ys.stop - y0, xs.start - x0:xs.stop - x0] = a[b, ys, xs]
    return t


def _frags_matrix(frags):
    """The (16·ks, 8·nt) matrix the mma.sync B fragments stand for, read
    back lane by lane: lane 4g + q holds rows 2q, 2q + 1, 2q + 8, 2q + 9 of
    column g."""
    ks, nt = frags.shape[:2]
    m = torch.zeros(16 * ks, 8 * nt)
    rows, cols = torch.arange(ks)[:, None] * 16, torch.arange(nt)[None, :] * 8
    for lane in range(32):
        g, q = divmod(lane, 4)
        for j, dk in enumerate((0, 1, 8, 9)):
            m[rows + 2 * q + dk, cols + g] = frags[:, :, lane, j].float()
    return m


def _patches(tile, tw, ks):
    """The dense kernels' patch matrix of a tile: one row per output pixel
    (4 × tw), column k = tap·cin + ci gathered from the flattened tile at
    the pixel's window plus the offset table's entry (zero at k ≥ 9·cin)."""
    cin = tile.shape[2]
    flat, row = tile.reshape(-1), (2 * tw + 1) * cin
    k = torch.arange(16 * ks)
    koff = torch.where(k < 9 * cin, (k // cin // 3) * row
                       + (k // cin % 3) * cin + k % cin, -1)
    oyl, oxl = torch.meshgrid(torch.arange(4), torch.arange(tw), indexing="ij")
    base = (2 * oyl * row + 2 * oxl * cin).reshape(-1, 1)
    return torch.where(koff >= 0, flat[base + koff.clamp(min=0)], 0.0)


def _down_case(rng, n, h, w, cin, cout, depthwise):
    x = Pending(torch.from_numpy(rng.randn(n, h, w, cin)).to(BF16),
                torch.from_numpy(rng.rand(cin).astype(np.float32) + 0.5),
                torch.from_numpy(rng.randn(cin).astype(np.float32) * 0.3),
                "hswish")
    wt = _bf16_valued(rng.randn(3, 3, 1 if depthwise else cin, cout) * 0.3)
    bias = _bf16_valued(rng.randn(cout))
    return x, wt, bias


@pytest.mark.parametrize("depthwise,cin,cout", [(False, 3, 16), (False, 4, 5),
                                                (True, 16, 16)])
def test_k2_tiles_and_block_sums_match_plain(rng, depthwise, cin, cout):
    """K2 as its kernels compute it, on an image cut by both tile edges (H
    9, W 150: a 5 × 75 output): per tile the staged, prologue'd source
    values; dense, the patch matrix (through the offset table) times the
    weights read back from the mma.sync B fragments (``_stem_frags``);
    depthwise, the 9 taps' products per channel; + bias. Gives the plain
    f32 conv (1e-5 of the largest); the blocks' rows of Σy, Σy² (block i
    of 3 takes tiles i, i + 3, ...), added in block order, its moments;
    ``_down_tiles`` counts the tiles."""
    n, h, w = 2, 9, 150
    x, wt, bias = _down_case(rng, n, h, w, cin, cout, depthwise)
    a = activated(x)
    tw = DOWN_TILE[depthwise][1]
    ho, wo = (h + 1) // 2, (w + 1) // 2
    wmat = None if depthwise else _frags_matrix(_stem_frags(wt)).double()
    y = torch.zeros(n, ho, wo, cout, dtype=torch.float64)
    tiles = _down_tile_list(n, h, w, depthwise)
    rows = torch.zeros(3, 2 * cout, dtype=torch.float64)
    for i, (b, r0, c0) in enumerate(tiles):
        src = _src_tile(a, b, r0, c0, tw).double()
        if depthwise:
            out = sum(src[ky:ky + 8:2, kx:kx + 2 * tw:2] * wt[ky, kx, 0].double()
                      for ky in range(3) for kx in range(3))
        else:
            out = (_patches(src, tw, wmat.shape[0] // 16) @ wmat)[:, :cout]
            out = out.reshape(4, tw, cout)
        out = (out + bias.double())[:min(4, ho - r0), :min(tw, wo - c0)]
        y[b, r0:r0 + out.shape[0], c0:c0 + out.shape[1]] = out
        rows[i % 3] += torch.cat([out.sum((0, 1)), (out * out).sum((0, 1))])
    assert len(tiles) == _down_tiles(n, h, w, depthwise) > 3
    want = F.conv2d(a.permute(0, 3, 1, 2), wt.permute(3, 2, 0, 1), bias,
                    stride=2, padding=1, groups=cin if depthwise else 1)
    want = want.permute(0, 2, 3, 1)
    assert _rel(y.float(), want)[0] < 1e-5
    assert _rel(rows.sum(0).float().reshape(2, cout), moments(want))[0] < 1e-5
    assert torch.equal(fused_conv_down_ref(x, wt, bias, depthwise),
                       want.to(BF16))


def _covering(s):
    """(tap, output offset) pairs whose stride-2 window covers owned source
    offset s of a tile."""
    return [(1, s // 2)] if s % 2 == 0 else [(0, (s + 1) // 2), (2, (s - 1) // 2)]


def _k4_rows(x, w, y, dy, dmom, depthwise, blocks):
    """K4's block rows: block i takes tiles i, i + blocks, ... and sums
    over its tiles' own output pixels dW (the staged prologue'd source
    values times dye rounded to bf16) and dbias (the f32 dye), and over
    its tiles' own source pixels (rows 2·r0 .. 2·r0 + 7, columns 2·c0 ..
    2·c0 + 2·tw − 1) dscale and dshift: each source pixel gathers its ≤ 4
    covering taps from the tile's dye with its halo row and column, then
    the prologue's backward. A row: dW (HWIO order), dbias, dscale,
    dshift. Also the whole dx."""
    n, h, wd, cin = x.raw.shape
    cout, nw = w.shape[3], w.numel()
    ho, wo = (h + 1) // 2, (wd + 1) // 2
    th, tw = DOWN_TILE[depthwise]
    g = _corrected_dy(dy, y, dmom).double()
    gb, a = g.to(BF16).double(), activated(x).double()
    wr, xr = w.to(BF16).double(), x.raw.double()
    s, t = x.scale.double(), x.shift.double()
    rows = torch.zeros(blocks, nw + cout + 2 * cin, dtype=torch.float64)
    dx = torch.zeros(n, h, wd, cin, dtype=torch.float64)
    for i, (b, r0, c0) in enumerate(_down_tile_list(n, h, wd, depthwise)):
        row = rows[i % blocks]
        d = torch.zeros(th + 1, tw + 1, cout, dtype=torch.float64)
        part = gb[b, r0:r0 + th + 1, c0:c0 + tw + 1]
        d[:part.shape[0], :part.shape[1]] = part
        src = _src_tile(a, b, r0, c0, tw)
        for tap in range(9):
            at = src[tap // 3:tap // 3 + 2 * th:2, tap % 3:tap % 3 + 2 * tw:2]
            prod = (at * d[:th, :tw]).sum((0, 1)) if depthwise else torch.einsum(
                "yxc,yxk->ck", at, d[:th, :tw]).reshape(-1)
            row[tap * prod.numel():(tap + 1) * prod.numel()] += prod
        row[nw:nw + cout] += g[b, r0:r0 + th, c0:c0 + tw].sum((0, 1))
        for syl in range(min(2 * th, h - 2 * r0)):
            for sxl in range(min(2 * tw, wd - 2 * c0)):
                ga = 0
                for ky, oy in _covering(syl):
                    for kx, ox in _covering(sxl):
                        ga = ga + (d[oy, ox] * wr[ky, kx, 0] if depthwise
                                   else wr[ky, kx] @ d[oy, ox])
                sy, sx = 2 * r0 + syl, 2 * c0 + sxl
                v = xr[b, sy, sx]
                gm = ga * act_grad(v * s + t, x.act).double()
                dx[b, sy, sx] = gm * s
                row[nw + cout:nw + cout + cin] += gm * v
                row[nw + cout + cin:] += gm
    return rows, dx


@pytest.mark.parametrize("depthwise,cin,cout", [(False, 4, 5), (True, 16, 16)])
def test_k4_block_sums_reduce_to_plain(rng, depthwise, cin, cout):
    """K4's per-block sums on a ragged image (H 9, W 70: tiles cut by both
    edges), with a hswish prologue, the moments' cotangent and dx, reduced
    in block order and decoded as ``down_rows_reduce_kernel``'s output is,
    give ``fused_conv_down_bwd_ref``'s dW, dbias, dscale and dshift (1e-5 of
    the largest) and its dx (within one bf16 rounding)."""
    n, h, w = 2, 9, 70
    x, wt, _ = _down_case(rng, n, h, w, cin, cout, depthwise)
    y = fused_conv_down_ref(x, wt, depthwise=depthwise)
    dy = torch.from_numpy(rng.randn(*y.shape)).to(BF16)
    dmom = torch.from_numpy(rng.randn(2, cout).astype(np.float32) * 1e-2)
    rows, dx = _k4_rows(x, wt, y, dy, dmom, depthwise, blocks=3)
    total, nw = rows.sum(0).float(), wt.numel()
    got = [total[:nw].view(wt.shape), total[nw:nw + cout],
           total[nw + cout:nw + cout + cin], total[nw + cout + cin:]]
    dx_r, dw_r, (ds_r, dt_r), db_r = fused_conv_down_bwd_ref(
        x, wt, y, dy, dmom, True, depthwise, True)
    for g, want in zip(got, [dw_r, db_r, ds_r, dt_r]):
        assert _rel(g, want)[0] < 1e-5
    assert _within_bf16(dx.to(BF16), dx_r)
