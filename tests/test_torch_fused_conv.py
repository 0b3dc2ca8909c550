"""The port's fused conv kernels K1/K2 (``mmr_tpu_torch.ops.fused_conv``)
held against the JAX ``packed_chain.fused_conv`` / ``fused_conv_down``.

On the CPU the wrappers run their plain versions; the JAX side runs its
Pallas kernels in interpret mode (as ``tests/test_packed_chain.py`` does),
packing and unpacking with ``to_packed``/``from_packed``. The same
seeded-numpy inputs and weights go to both. Geometries are those of
``tests/test_packed_chain.py``.

Tolerance, unless a case says otherwise: ``atol=0.05, rtol=0.02``. Both
sides take the same bf16 inputs, round the prologue to bf16 at the same
place and accumulate in f32, so what is left is accumulation order and one
bf16 rounding of y (≤ 1 ulp = 0.4 % of |y|), plus, for lazily upsampled
inputs, the JAX kernel's bf16 rounding of summed tap weights (~0.2 % of a
tap).

The CUDA kernels themselves are held against these plain versions on the
card by ``tests/test_torch_gpu.py``.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import mmr_tpu.ops.pallas.packed_chain as pc
from mmr_tpu.ops.pallas.conv3x3_packed import _toeplitz
from mmr_tpu_torch.ops.fused_conv import (Pending, fused_conv,
                                          fused_conv_down, fused_conv_down_bwd,
                                          fused_conv_down_bwd_ref,
                                          fused_conv_down_ref, fused_conv_ref)
from tests.test_torch_train_modules import few_torch_threads  # noqa: F401

ATOL, RTOL = 0.05, 0.02


@pytest.fixture(autouse=True)
def interpret(monkeypatch):
    monkeypatch.setattr(pc, "_INTERPRET", True)


def _bf16(a):
    """numpy f32 -> (bf16 torch NHWC, bf16 jax) with identical values."""
    t = torch.from_numpy(np.ascontiguousarray(a)).to(torch.bfloat16)
    return t, jnp.asarray(t.float().numpy(), jnp.bfloat16)


def _pro_lanes(v, g, c):
    return jnp.tile(jnp.pad(jnp.asarray(v), (0, g.cp(c) - c)), g.p)


def _affine(rng, c):
    return (rng.rand(c).astype(np.float32) + 0.5,
            (rng.randn(c) * 0.3).astype(np.float32))


def _pending(t, s=None, sh=None, act="relu", up2x=False):
    st = None if s is None else torch.from_numpy(s)
    tt = None if sh is None else torch.from_numpy(sh)
    return Pending(t, st, tt, act, up2x)


def _close(got_torch, want_jax, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(got_torch.float().numpy(),
                               np.asarray(want_jax, np.float32),
                               atol=atol, rtol=rtol)


def _jax_fused(g, xs, cins, ws, cout, pros, acts, bias=None, ups=None):
    """JAX packed fused_conv over NHWC inputs (``ups[j]``: source geometry
    of a lazily upsampled input, else None)."""
    ups = ups or [None] * len(xs)
    datas, tees, specs, lanes, pl = [], [], [], [], []
    for x, c, w, pro, gs in zip(xs, cins, ws, pros, ups):
        gi = gs or g
        datas.append(pc.to_packed(x, gi))
        lanes.append(gi.lanes(c))
        if gs is None:
            tees.append(_toeplitz(jnp.asarray(w), g.p, g.cp(c), g.cp(cout)))
            specs.append(None)
        else:
            tees.append(jnp.asarray(w))
            specs.append(pc.up_spec_for(gs, g, c))
        pl.append(None if pro is None else jnp.stack(
            [_pro_lanes(pro[0], gi, c), _pro_lanes(pro[1], gi, c)]))
    cfg = pc.FusedCfg(geom=g, l_list=tuple(lanes), lo=g.lanes(cout),
                      pro_mask=tuple(a if p is not None else None
                                     for a, p in zip(acts, pros)),
                      has_bias=bias is not None, emit_moments=False,
                      up_spec=tuple(specs))
    bl = None if bias is None else pc.bias_lanes(jnp.asarray(bias), g.p,
                                                 g.cp(cout))
    y, _ = pc.fused_conv(cfg, tuple(datas), tuple(tees), tuple(pl), bl)
    return pc.from_packed(y, g, cout)


class TestFusedConvVsJax:
    def test_single_input(self, rng):
        B, H, W, C, CO = 2, 16, 32, 8, 8
        g = pc.row_geom(H, W)
        xt, xj = _bf16(rng.randn(B, H, W, C).astype(np.float32))
        w = (rng.randn(3, 3, C, CO) * 0.1).astype(np.float32)
        got = fused_conv([Pending(xt)], [torch.from_numpy(w)])
        assert got.shape == (B, H, W, CO) and got.dtype == torch.bfloat16
        _close(got, _jax_fused(g, [xj], [C], [w], CO, [None], [None]))

    def test_multi_input(self, rng):
        B, H, W, CO = 2, 8, 32, 16
        cins = [8, 16]
        g = pc.row_geom(H, W)
        pairs = [_bf16(rng.randn(B, H, W, c).astype(np.float32)) for c in cins]
        ws = [(rng.randn(3, 3, c, CO) * 0.1).astype(np.float32) for c in cins]
        got = fused_conv([Pending(t) for t, _ in pairs],
                         [torch.from_numpy(w) for w in ws])
        _close(got, _jax_fused(g, [j for _, j in pairs], cins, ws, CO,
                               [None, None], [None, None]))

    @pytest.mark.parametrize("act", ["relu", "hswish", "linear"])
    def test_prologue_and_bias(self, rng, act):
        """The prologue's shift makes act(0·s + t) ≠ 0: SAME padding must
        stay zero after it (the border pixels check that)."""
        B, H, W, C, CO = 1, 8, 32, 8, 8
        g = pc.row_geom(H, W)
        xt, xj = _bf16(rng.randn(B, H, W, C).astype(np.float32))
        w = (rng.randn(3, 3, C, CO) * 0.1).astype(np.float32)
        s, t = _affine(rng, C)
        bias = rng.randn(CO).astype(np.float32)
        got = fused_conv([_pending(xt, s, t, act)], [torch.from_numpy(w)],
                         torch.from_numpy(bias))
        _close(got, _jax_fused(g, [xj], [C], [w], CO, [(s, t)], [act],
                               bias=bias))

    @pytest.mark.parametrize("r_b", [1, 2])
    def test_lazy_upsample_with_skip(self, rng, r_b):
        """Lazy ×2-nearest input (relu prologue at source resolution) +
        a plain skip, in the two geometry regimes of
        ``TestFusedUpsample`` (r_b 1: p halves across the scale; r_b 2:
        same p)."""
        if r_b == 1:
            g_src, g_dst = pc.RowGeom(8, 16, 2, 8, 16), pc.RowGeom(16, 32, 4, 8, 16)
        else:
            g_src, g_dst = pc.RowGeom(4, 64, 8, 8, 16), pc.RowGeom(8, 128, 8, 16, 24)
        B, C_up, C_sk, CO = 2, 5, 7, 6
        ut, uj = _bf16(rng.randn(B, g_src.h, g_src.w, C_up).astype(np.float32))
        kt, kj = _bf16(rng.randn(B, g_dst.h, g_dst.w, C_sk).astype(np.float32))
        w_up = (rng.randn(3, 3, C_up, CO) * 0.1).astype(np.float32)
        w_sk = (rng.randn(3, 3, C_sk, CO) * 0.1).astype(np.float32)
        s, t = _affine(rng, C_up)
        got = fused_conv([_pending(ut, s, t, "relu", up2x=True), Pending(kt)],
                         [torch.from_numpy(w_up), torch.from_numpy(w_sk)])
        want = _jax_fused(g_dst, [uj, kj], [C_up, C_sk], [w_up, w_sk], CO,
                          [(s, t), None], ["relu", None], ups=[g_src, None])
        _close(got, want)


def _jax_down(g_src, g_dst, xj, w, cin, cout, pro=None, act=None):
    cfg = pc.DownCfg(g_src=g_src, g_dst=g_dst, l_in=g_src.lanes(cin),
                     lo=g_dst.lanes(cout), pro=act if pro else None,
                     has_bias=False, emit_moments=False, need_dx=False)
    pl = None if pro is None else jnp.stack(
        [_pro_lanes(pro[0], g_src, cin), _pro_lanes(pro[1], g_src, cin)])
    y, _ = pc.fused_conv_down(cfg, pc.to_packed(xj, g_src), jnp.asarray(w),
                              pl, None)
    return pc.from_packed(y, g_dst, cout)


class TestFusedConvDownVsJax:
    def test_stem_phases2(self, rng):
        """The stem's exact configuration: Cin 3 -> 16, no prologue, the
        phases=2 geometry of ``TestFusedConvDownPhases2``."""
        h, w = 16, 64
        g_src = pc.RowGeom(h, w, 32, w // 32, pc._round_up(w // 32 + 2, 8))
        g_dst = pc.RowGeom(h // 2, w // 2, 8, w // 16,
                           pc._round_up(w // 16 + 2, 8))
        xt, xj = _bf16(rng.randn(2, h, w, 3).astype(np.float32))
        wk = (rng.randn(3, 3, 3, 16) * 0.3).astype(np.float32)
        got = fused_conv_down(Pending(xt), torch.from_numpy(wk))
        assert got.shape == (2, h // 2, w // 2, 16)
        _close(got, _jax_down(g_src, g_dst, xj, wk, 3, 16))

    @pytest.mark.parametrize("act", ["relu", "hswish", "linear"])
    def test_dense_with_prologue(self, rng, act):
        g_src, g_dst = pc.RowGeom(16, 64, 8, 8, 16), pc.RowGeom(8, 32, 4, 8, 16)
        CIN, CO = 5, 6
        xt, xj = _bf16(rng.randn(2, 16, 64, CIN).astype(np.float32))
        wk = (rng.randn(3, 3, CIN, CO) * 0.3).astype(np.float32)
        s, t = _affine(rng, CIN)
        got = fused_conv_down(_pending(xt, s, t, act), torch.from_numpy(wk))
        _close(got, _jax_down(g_src, g_dst, xj, wk, CIN, CO, (s, t), act))

    def test_depthwise_b0_0(self, rng):
        """b0_0: a true depthwise conv (C = 16) with the stem's hswish
        prologue; JAX runs it as a diagonal-expanded dense conv."""
        g_src, g_dst = pc.RowGeom(16, 64, 8, 8, 16), pc.RowGeom(8, 32, 4, 8, 16)
        C = 16
        xt, xj = _bf16(rng.randn(2, 16, 64, C).astype(np.float32))
        dw = (rng.randn(3, 3, 1, C) * 0.4).astype(np.float32)
        s, t = _affine(rng, C)
        got = fused_conv_down(_pending(xt, s, t, "hswish"), torch.from_numpy(dw),
                              depthwise=True)
        w_dense = dw * np.eye(C, dtype=np.float32)[None, None]
        _close(got, _jax_down(g_src, g_dst, xj, w_dense, C, C, (s, t), "hswish"))


class TestWrapperContract:
    def test_cpu_runs_plain_version_without_launching(self, rng):
        x = torch.randn(1, 8, 16, 8).to(torch.bfloat16)
        w = torch.randn(3, 3, 8, 4)
        before = (fused_conv.launches, fused_conv_down.launches)
        assert torch.equal(fused_conv([Pending(x)], [w]),
                           fused_conv_ref([Pending(x)], [w]))
        assert torch.equal(fused_conv_down(Pending(x), w),
                           fused_conv_down_ref(Pending(x), w))
        assert (fused_conv.launches, fused_conv_down.launches) == before

    @pytest.mark.parametrize("depthwise,cin,cout", [
        (False, 64, 64), (True, 24, 24), (True, 128, 128)])
    def test_cpu_stride2_takes_channels_beyond_the_kernels(self, depthwise,
                                                           cin, cout):
        """The kernels' channel limits hold on the card only: on the CPU the
        stride-2 pair runs its plain versions at any channels."""
        g = torch.Generator().manual_seed(0)
        x = torch.randn(1, 6, 10, cin, generator=g).to(torch.bfloat16)
        p = Pending(x, torch.rand(cin, generator=g) + 0.5,
                    torch.randn(cin, generator=g), "relu")
        w = torch.randn(3, 3, 1 if depthwise else cin, cout, generator=g)
        y = fused_conv_down(p, w, depthwise=depthwise)
        assert torch.equal(y, fused_conv_down_ref(p, w, depthwise=depthwise))
        dy = torch.randn(y.shape, generator=g).to(torch.bfloat16)
        got = fused_conv_down_bwd(p, w, None, dy, depthwise=depthwise)
        want = fused_conv_down_bwd_ref(p, w, None, dy, depthwise=depthwise)
        for a, b in [(got[0], want[0]), (got[1], want[1]), *zip(got[2], want[2])]:
            assert torch.equal(a, b)

    @pytest.mark.parametrize("bad", ["dtype", "layout", "device", "weight"])
    def test_rejects(self, bad):
        x = torch.zeros(1, 8, 16, 8, dtype=torch.bfloat16)
        w = torch.zeros(3, 3, 8, 4)
        if bad == "dtype":
            x = x.float()
        elif bad == "layout":
            x = x.permute(0, 2, 1, 3)   # not contiguous NHWC
        elif bad == "device":
            x = x.to("meta")            # neither a kernel nor a plain version
            w = w.to("meta")
        else:
            w = torch.zeros(3, 3, 7, 4)
        with pytest.raises(ValueError):
            fused_conv([Pending(x)], [w])
        with pytest.raises(ValueError):
            fused_conv_down(Pending(x), w)

