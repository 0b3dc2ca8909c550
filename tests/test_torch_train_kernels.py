"""The port's training kernels — K1 with BN moments, K3 (its backward), K2
with moments, K4 (its backward), K5a/K5b (the fused head + DiceCE loss) —
held against the JAX ``packed_chain`` kernels on the same inputs.

On the CPU the wrappers run their plain versions and the autograd
functions run the plain backward versions; the JAX side runs its Pallas
kernels in interpret mode and differentiates them through their custom
VJPs. Setups are those of ``tests/test_packed_chain.py``
(``TestFusedBackward``, ``TestFusedUpsample::test_forward_and_grads``,
``TestFusedConvDownPhases2``, ``TestFusedHeadLoss``). Bounds, as that
suite's: outputs atol 0.05 / rtol 0.02 (the same bf16 inputs and
roundings; f32 summation order and one bf16 rounding remain), moments and
losses rtol 2e-2, log-probs atol 0.05 / rtol 0.02, gradients max|Δ| /
max|ref| < 0.08 (both sides round dy and the prologue'd inputs to bf16,
but the JAX kernels also round pair-summed upsample taps), confusion atol
2.0 (argmax flips of near-tied pixels).

Each plain backward is also held against torch autograd of its plain
forward with every rounding dropped (``dtype=torch.float32``), at 1e-4 of
the largest gradient: the written-out backward is the forward's exact
derivative (f32 summation order only).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import mmr_tpu.ops.pallas.packed_chain as pc
from mmr_tpu.ops.pallas.conv3x3_packed import _toeplitz
from mmr_tpu_torch.ops.fused_conv import (Pending, fused_conv_ad,
                                          fused_conv_bwd_ref,
                                          fused_conv_down_ad,
                                          fused_conv_down_bwd_ref,
                                          fused_conv_down_ref, fused_conv_ref)
from mmr_tpu_torch.ops.head_loss import (assemble_dice_ce, fused_head_loss,
                                         head_loss_bwd_ref, head_loss_fwd_ref)
from tests.test_torch_train_modules import few_torch_threads  # noqa: F401

GRAD_REL = 0.08


@pytest.fixture(autouse=True)
def interpret(monkeypatch):
    monkeypatch.setattr(pc, "_INTERPRET", True)


def _t(a, grad=False, dtype=torch.float32):
    t = torch.from_numpy(np.ascontiguousarray(a)).to(dtype)
    return t.requires_grad_(grad)


def _bf16_leaf(a):
    """numpy -> a bf16 leaf tensor that collects its gradient."""
    return _t(a, grad=True, dtype=torch.bfloat16)


def _lanes(v, g, c):
    return jnp.tile(jnp.pad(v, (0, g.cp(c) - c)), g.p)


def _pro(s, t, g, c):
    return jnp.stack([_lanes(s, g, c), _lanes(t, g, c)])


def _fold(mom, g, c):
    """(2, lanes) per-lane moments -> (2, C) per channel."""
    return mom.reshape(2, g.p, g.cp(c)).sum(1)[:, :c]


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.abs(got - want).max() / (np.abs(want).max() + 1e-8)


def _assert_grads(names, got, want):
    for n, a, b in zip(names, got, want):
        err = _rel(a, b)
        assert err < GRAD_REL, (n, err)


def _np(t):
    return t.detach().float().numpy()


# ------------------------------------------------------------ K1 + K3

class TestFusedConvTrainVsJax:
    def test_lazy_upsample_and_skip(self, rng):
        """``TestFusedUpsample::test_forward_and_grads`` (r_b 2) with the
        prologue: a lazily ×2-upsampled input with a relu prologue (its dx
        2×2-summed at source resolution) and a plain skip, the moments and
        their cotangent (the BN-statistics path of dy). The r_b 1 geometry
        and ``TestFusedBackward``'s single input differ only in the JAX
        packing."""
        g_src, g_dst = pc.RowGeom(4, 64, 8, 8, 16), pc.RowGeom(8, 128, 8, 16, 24)
        B, C_up, C_sk, CO = 2, 5, 7, 6
        xs = rng.randn(B, g_src.h, g_src.w, C_up).astype(np.float32)
        xk = rng.randn(B, g_dst.h, g_dst.w, C_sk).astype(np.float32)
        w_up = (rng.randn(3, 3, C_up, CO) * 0.1).astype(np.float32)
        w_sk = (rng.randn(3, 3, C_sk, CO) * 0.1).astype(np.float32)
        s = (rng.rand(C_up) + 0.5).astype(np.float32)
        t = (rng.randn(C_up) * 0.3).astype(np.float32)
        gy = rng.randn(B, g_dst.h, g_dst.w, CO).astype(np.float32)
        q = rng.randn(2, CO).astype(np.float32) * 0.01
        cfg = pc.FusedCfg(
            geom=g_dst, l_list=(g_src.lanes(C_up), g_dst.lanes(C_sk)),
            lo=g_dst.lanes(CO), pro_mask=("relu", None), has_bias=False,
            emit_moments=True, up_spec=(pc.up_spec_for(g_src, g_dst, C_up), None))

        def jax_loss(xs, xk, w_up, w_sk, s, t):
            y_p, mom = pc.fused_conv(
                cfg, (pc.to_packed(xs, g_src), pc.to_packed(xk, g_dst)),
                (w_up, _toeplitz(w_sk, g_dst.p, g_dst.cp(C_sk), g_dst.cp(CO))),
                (_pro(s, t, g_src, C_up), None), None)
            y = pc.from_packed(y_p, g_dst, CO).astype(jnp.float32)
            m = _fold(mom, g_dst, CO)
            return jnp.sum(y * gy) + jnp.sum(m * q), (y, m)

        (_, (y_j, m_j)), g_j = jax.value_and_grad(
            jax_loss, argnums=tuple(range(6)), has_aux=True)(
            *map(jnp.asarray, (xs, xk, w_up, w_sk, s, t)))

        leaves = [_bf16_leaf(xs), _bf16_leaf(xk), _t(w_up, True),
                  _t(w_sk, True), _t(s, True), _t(t, True)]
        xst, xkt, wut, wst, st, tt = leaves
        (y, mom), _ = fused_conv_ad(
            [Pending(xst, st, tt, "relu", up2x=True), Pending(xkt)],
            [wut, wst], emit_moments=True)
        ((y.float() * _t(gy)).sum() + (mom * _t(q)).sum()).backward()
        np.testing.assert_allclose(_np(y), np.asarray(y_j), atol=0.05, rtol=0.02)
        np.testing.assert_allclose(_np(mom), np.asarray(m_j), rtol=2e-2, atol=0.5)
        _assert_grads(["dx_src", "dx_skip", "dw_up", "dw_skip", "dscale",
                       "dshift"], [_np(v.grad) for v in leaves], g_j)


@pytest.mark.parametrize("act", ["relu", "hswish", "linear"])
def test_fused_conv_bwd_ref_is_the_forward_derivative(rng, act):
    """Two inputs (one lazily upsampled, both with prologues), a bias and
    moments: the written-out backward vs autograd of the plain forward, f32."""
    B, CO = 2, 5
    f32 = torch.float32
    raws = [_t(rng.randn(B, 4, 6, 3), True), _t(rng.randn(B, 8, 12, 4), True)]
    ss = [_t(rng.rand(c) + 0.5, True) for c in (3, 4)]
    ts = [_t(rng.randn(c) * 0.5, True) for c in (3, 4)]
    ws = [_t(rng.randn(3, 3, c, CO) * 0.3, True) for c in (3, 4)]
    bias = _t(rng.randn(CO), True)
    gy, q = _t(rng.randn(B, 8, 12, CO)), _t(rng.randn(2, CO) * 0.1)
    inputs = [Pending(raws[0], ss[0], ts[0], act, up2x=True),
              Pending(raws[1], ss[1], ts[1], act)]
    y, mom = fused_conv_ref(inputs, ws, bias, emit_moments=True, dtype=f32)
    ((y * gy).sum() + (mom * q).sum()).backward()
    det = [Pending(p.raw.detach(), p.scale.detach(), p.shift.detach(), p.act,
                   p.up2x) for p in inputs]
    dxs, dws, dpros, dbias = fused_conv_bwd_ref(
        det, [w.detach() for w in ws], y.detach(), gy, q, True, dtype=f32)
    got = dxs + dws + [d for dp in dpros for d in dp] + [dbias]
    want = raws + ws + [v for pair in zip(ss, ts) for v in pair] + [bias]
    for a, b in zip(got, want):
        assert _rel(_np(a), _np(b.grad)) < 1e-4


# ------------------------------------------------------------ K2 + K4

class TestFusedConvDownTrainVsJax:
    def _geoms(self, h=16, w=64):
        wbs, wbd = w // 32, w // 16
        return (pc.RowGeom(h, w, 32, wbs, pc._round_up(wbs + 2, 8)),
                pc.RowGeom(h // 2, w // 2, 8, wbd, pc._round_up(wbd + 2, 8)))

    def test_stem_moments_and_dw(self, rng):
        """``TestFusedConvDownPhases2::test_stem_config_fwd_moments_dw``:
        Cin 3 -> 16, no prologue, moments with a cotangent, dW only."""
        g_src, g_dst = self._geoms()
        B, CIN, CO = 2, 3, 16
        x = rng.randn(B, g_src.h, g_src.w, CIN).astype(np.float32)
        w3 = (rng.randn(3, 3, CIN, CO) * 0.3).astype(np.float32)
        r = rng.randn(B, g_dst.h, g_dst.w, CO).astype(np.float32)
        q = rng.randn(2, CO).astype(np.float32)
        cfg = pc.DownCfg(g_src=g_src, g_dst=g_dst, l_in=g_src.lanes(CIN),
                         lo=g_dst.lanes(CO), pro=None, has_bias=False,
                         emit_moments=True, need_dx=False)

        def jax_loss(w3):
            y_p, mom = pc.fused_conv_down(cfg, pc.to_packed(x, g_src), w3,
                                          None, None)
            y = pc.from_packed(y_p, g_dst, CO).astype(jnp.float32)
            m = _fold(mom, g_dst, CO)
            return (y * r).sum() + (m * q).sum(), (y, m)

        (_, (y_j, m_j)), g_j = jax.value_and_grad(jax_loss, has_aux=True)(
            jnp.asarray(w3))
        wt = _t(w3, True)
        y, mom = fused_conv_down_ad(Pending(_t(x, dtype=torch.bfloat16)), wt,
                                    emit_moments=True)
        ((y.float() * _t(r)).sum() + (mom * _t(q)).sum()).backward()
        np.testing.assert_allclose(_np(y), np.asarray(y_j), atol=0.05, rtol=0.02)
        np.testing.assert_allclose(_np(mom), np.asarray(m_j), rtol=2e-2, atol=0.5)
        assert _rel(_np(wt.grad), g_j) < GRAD_REL

    @pytest.fixture(scope="class")
    def dense_dx_case(self):
        """``TestFusedConvDownPhases2::test_full_bwd_with_pro_and_dx``'s
        case, a dense Cin 4 -> 5 conv with a bias and a relu or hswish
        prologue: the inputs and JAX's y and gradients for both prologues,
        from one jitted program."""
        rng = np.random.RandomState(7)
        g_src, g_dst = self._geoms()
        B, CIN, CO = 2, 4, 5
        x = rng.randn(B, g_src.h, g_src.w, CIN).astype(np.float32)
        w3 = (rng.randn(3, 3, CIN, CO) * 0.3).astype(np.float32)
        s = (rng.rand(CIN) + 0.5).astype(np.float32)
        t = (rng.randn(CIN) * 0.3).astype(np.float32)
        bias = rng.randn(CO).astype(np.float32)
        acts = ("relu", "hswish")

        def jax_loss(act, x, w3, s, t, bias):
            cfg = pc.DownCfg(g_src=g_src, g_dst=g_dst, l_in=g_src.lanes(CIN),
                             lo=g_dst.lanes(CO), pro=act, has_bias=True,
                             emit_moments=False, need_dx=True)
            y_p, _ = pc.fused_conv_down(
                cfg, pc.to_packed(x, g_src), w3, _pro(s, t, g_src, CIN),
                pc.bias_lanes(bias, g_dst.p, g_dst.cp(CO)))
            y = pc.from_packed(y_p, g_dst, CO).astype(jnp.float32)
            return (y ** 2).sum(), y

        grads = jax.value_and_grad(jax_loss, argnums=(1, 2, 3, 4, 5),
                                   has_aux=True)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(pc, "_INTERPRET", True)
            out = jax.jit(lambda *a: [grads(act, *a) for act in acts])(
                *map(jnp.asarray, (x, w3, s, t, bias)))
        return (x, w3, s, t, bias), dict(zip(acts, out))

    @pytest.mark.parametrize("act", ["relu", "hswish"])
    def test_dense_full_bwd_with_pro_and_dx(self, dense_dx_case, act):
        """K4's dense ``need_dx`` (the plain version on the CPU): dx
        through the prologue, dW, dscale, dshift and dbias vs JAX's
        interpreted ``_down_bwd_call`` with ``need_dx``."""
        inputs, jax_out = dense_dx_case
        (_, y_j), g_j = jax_out[act]
        leaves = [_bf16_leaf(inputs[0])] + [_t(v, True) for v in inputs[1:]]
        xt, wt, st, tt, bt = leaves
        y = fused_conv_down_ad(Pending(xt, st, tt, act), wt, bt)
        (y.float() ** 2).sum().backward()
        np.testing.assert_allclose(_np(y), np.asarray(y_j), atol=0.05, rtol=0.02)
        _assert_grads(["dx", "dw", "dscale", "dshift", "dbias"],
                      [_np(v.grad) for v in leaves], g_j)

    def test_depthwise_b0_0_full_bwd(self, rng):
        """b0_0: a depthwise stride-2 conv through the stem's pending BN +
        hardswish, moments with a cotangent, every gradient; JAX runs it as
        a diagonal-expanded dense conv (``PackedDSBlock``)."""
        act = "hswish"
        g_src, g_dst = pc.RowGeom(16, 64, 8, 8, 16), pc.RowGeom(8, 32, 4, 8, 16)
        B, C = 2, 16
        x = rng.randn(B, 16, 64, C).astype(np.float32)
        dw = (rng.randn(3, 3, 1, C) * 0.4).astype(np.float32)
        s = (rng.rand(C) + 0.5).astype(np.float32)
        t = (rng.randn(C) * 0.3).astype(np.float32)
        r = rng.randn(B, 8, 32, C).astype(np.float32)
        q = rng.randn(2, C).astype(np.float32) * 0.1
        cfg = pc.DownCfg(g_src=g_src, g_dst=g_dst, l_in=g_src.lanes(C),
                         lo=g_dst.lanes(C), pro=act, has_bias=False,
                         emit_moments=True, need_dx=True)

        def jax_loss(x, dw, s, t):
            w_dense = dw[:, :, 0, :][..., None, :] * jnp.eye(C)[None, None]
            y_p, mom = pc.fused_conv_down(cfg, pc.to_packed(x, g_src), w_dense,
                                          _pro(s, t, g_src, C), None)
            y = pc.from_packed(y_p, g_dst, C).astype(jnp.float32)
            return (y * r).sum() + (_fold(mom, g_dst, C) * q).sum(), y

        (_, y_j), g_j = jax.value_and_grad(
            jax_loss, argnums=(0, 1, 2, 3), has_aux=True)(
            *map(jnp.asarray, (x, dw, s, t)))
        leaves = [_bf16_leaf(x), _t(dw, True), _t(s, True), _t(t, True)]
        xt, wt, st, tt = leaves
        y, mom = fused_conv_down_ad(Pending(xt, st, tt, act), wt,
                                    depthwise=True, emit_moments=True)
        ((y.float() * _t(r)).sum() + (mom * _t(q)).sum()).backward()
        np.testing.assert_allclose(_np(y), np.asarray(y_j), atol=0.05, rtol=0.02)
        _assert_grads(["dx", "dw", "dscale", "dshift"],
                      [_np(v.grad) for v in leaves], g_j)


@pytest.mark.parametrize("depthwise", [False, True])
def test_fused_conv_down_bwd_ref_is_the_forward_derivative(rng, depthwise):
    """Odd sizes (the stride-2 transposed conv's output padding), hswish
    prologue, bias and moments; written-out backward vs autograd, f32."""
    B, CIN, H, W = 2, 4, 9, 14
    CO = CIN if depthwise else 6
    f32 = torch.float32
    raw = _t(rng.randn(B, H, W, CIN), True)
    s, t = _t(rng.rand(CIN) + 0.5, True), _t(rng.randn(CIN) * 0.5, True)
    w = _t(rng.randn(3, 3, 1 if depthwise else CIN, CO) * 0.3, True)
    bias = _t(rng.randn(CO), True)
    x = Pending(raw, s, t, "hswish")
    y, mom = fused_conv_down_ref(x, w, bias, depthwise, True, dtype=f32)
    gy, q = _t(rng.randn(*y.shape)), _t(rng.randn(2, CO) * 0.1)
    ((y * gy).sum() + (mom * q).sum()).backward()
    det = Pending(raw.detach(), s.detach(), t.detach(), "hswish")
    dx, dw, (ds, dt), dbias = fused_conv_down_bwd_ref(
        det, w.detach(), y.detach(), gy, q, True, depthwise, True, dtype=f32)
    for a, b in zip([dx, dw, ds, dt, dbias], [raw, w, s, t, bias]):
        assert _rel(_np(a), _np(b.grad)) < 1e-4


# ------------------------------------------------------------ K5a + K5b

class TestFusedHeadLossVsJax:
    def _setup(self, rng):
        g = pc.RowGeom(16, 32, 4, 8, 16)
        B, CIN, NC = 2, 5, 3
        x = rng.randn(B, g.h, g.w, CIN).astype(np.float32)
        w3 = (rng.randn(3, 3, CIN, NC) * 0.5).astype(np.float32)
        bias = (rng.randn(NC) * 0.1).astype(np.float32)
        s = (rng.rand(CIN) + 0.5).astype(np.float32)
        t = (rng.randn(CIN) * 0.3).astype(np.float32)
        masks = rng.randint(0, NC, (B, g.h, g.w))
        return g, B, CIN, NC, x, w3, bias, s, t, masks

    def _jax(self, g, CIN, NC, x, w3, bias, s, t, masks, with_conf=True):
        spec = pc.HeadLossSpec(geom=g, l_in=g.lanes(CIN), nc=NC,
                               with_conf=with_conf)
        n = masks.size

        def loss(x, w3, s, t, bias):
            y, stats, conf = pc.fused_head_loss(
                spec, pc.to_packed(x, g), _toeplitz(w3, g.p, g.cp(CIN), g.cp(NC)),
                _pro(s, t, g, CIN), pc.bias_lanes(bias, g.p, g.cp(NC)),
                pc.pack_labels(jnp.asarray(masks), g, NC))
            l, conf_c = pc.assemble_dice_ce(spec, stats, conf, n)
            return l, (conf_c, pc.from_packed(y, g, NC))

        return jax.value_and_grad(loss, argnums=(0, 1, 2, 3, 4), has_aux=True)(
            *map(jnp.asarray, (x, w3, s, t, bias)))

    def _port(self, x, w3, bias, s, t, masks, with_conf=True):
        leaves = [_bf16_leaf(x), _t(w3, True), _t(s, True), _t(t, True),
                  _t(bias, True)]
        xt, wt, st, tt, bt = leaves
        labels = torch.from_numpy(masks)
        logp, stats, conf = fused_head_loss(Pending(xt, st, tt, "relu"), wt, bt,
                                            labels, with_conf)
        loss, conf = assemble_dice_ce(stats, conf, labels.numel())
        loss.backward()
        return float(loss.detach()), _np(conf), _np(logp), [_np(v.grad) for v in
                                                   (xt, wt, st, tt, bt)]

    def test_loss_logprobs_grads_confusion(self, rng):
        g, B, CIN, NC, x, w3, bias, s, t, masks = self._setup(rng)
        (l_j, (c_j, lp_j)), g_j = self._jax(g, CIN, NC, x, w3, bias, s, t, masks)
        loss, conf, logp, grads = self._port(x, w3, bias, s, t, masks)
        np.testing.assert_allclose(loss, float(l_j), rtol=2e-2)
        np.testing.assert_allclose(conf, np.asarray(c_j), atol=2.0)
        np.testing.assert_allclose(logp, np.asarray(lp_j, np.float32),
                                   atol=0.05, rtol=0.02)
        _assert_grads(["dx", "dw", "dscale", "dshift", "dbias"], grads, g_j)

    @staticmethod
    def _oracle(x, w3, bias, s, t, masks):
        """``TestFusedHeadLoss``'s unfused JAX oracle: ``dice_ce_loss`` of
        the lax.conv logits, and its gradients w.r.t. x and w."""
        from mmr_tpu.losses.dice_ce import dice_ce_loss

        def loss(x, w3):
            a = jnp.maximum(x.astype(jnp.bfloat16).astype(jnp.float32) * s + t, 0)
            logits = jax.lax.conv_general_dilated(
                a.astype(jnp.bfloat16).astype(jnp.float32), w3, (1, 1),
                [(1, 1), (1, 1)], dimension_numbers=("NHWC", "HWIO", "NHWC"))
            return dice_ce_loss(logits + bias, jnp.asarray(masks))

        return jax.value_and_grad(loss, argnums=(0, 1))(jnp.asarray(x),
                                                         jnp.asarray(w3))

    def test_per_pixel_stabilization_large_spread(self, rng):
        """Rows with huge activations (logit spread ~1e3 in one tile): every
        pixel keeps its softmax statistics (Σp = number of pixels)."""
        g, B, CIN, NC, x, w3, bias, s, t, masks = self._setup(rng)
        x[0, :2] *= 400.0
        l_j, _ = self._oracle(x, w3, bias, s, t, masks)
        p = Pending(_t(x, dtype=torch.bfloat16), _t(s), _t(t), "relu")
        _, stats, conf = fused_head_loss(p, _t(w3), _t(bias),
                                         torch.from_numpy(masks))
        loss, _ = assemble_dice_ce(stats, conf, masks.size)
        assert np.isfinite(float(loss))
        np.testing.assert_allclose(float(loss), float(l_j), rtol=2e-2)
        assert float(stats[:, 0].sum()) == pytest.approx(masks.size, rel=1e-3)

    def test_confident_pixel_ce_grad_survives_bf16(self, rng):
        """Saturated softmax with every label the predicted class: the CE
        gradient at the label (−(1 − p) ≈ −1e-4) survives the bf16 log-prob
        residual through expm1."""
        g, B, CIN, NC, x, w3, bias, s, t, masks = self._setup(rng)
        w3 = w3 * 8.0
        a = np.maximum(x * s + t, 0.0)
        logits = jax.lax.conv_general_dilated(
            jnp.asarray(a, jnp.bfloat16).astype(jnp.float32), jnp.asarray(w3),
            (1, 1), [(1, 1), (1, 1)], dimension_numbers=("NHWC", "HWIO", "NHWC"))
        masks = np.array(jnp.argmax(logits + bias, axis=-1))
        l_j, g_j = self._oracle(x, w3, bias, s, t, masks)
        loss, _, _, grads = self._port(x, w3, bias, s, t, masks)
        np.testing.assert_allclose(loss, float(l_j), rtol=2e-2)
        for n, a_, b_ in zip(["dx", "dw"], grads[:2], g_j[:2]):
            assert np.abs(np.asarray(b_)).max() > 0
            assert _rel(a_, b_) < GRAD_REL, n

    def test_all_equal_logits_argmax_first_class(self, rng):
        """Zero weights and bias: all logits tie, torch's argmax takes class
        0, so the confusion puts every pixel in row 0."""
        g, B, CIN, NC, x, w3, bias, s, t, masks = self._setup(rng)
        p = Pending(_t(x, dtype=torch.bfloat16), _t(s), _t(t), "relu")
        _, _, conf = fused_head_loss(p, torch.zeros(3, 3, CIN, NC),
                                     torch.zeros(NC), torch.from_numpy(masks))
        want = np.zeros((NC, NC))
        for c in range(NC):
            want[0, c] = (masks == c).sum()
        np.testing.assert_array_equal(_np(conf), want)

    def test_with_conf_false_same_loss_zero_conf(self, rng):
        g, B, CIN, NC, x, w3, bias, s, t, masks = self._setup(rng)
        l1, c1, _, g1 = self._port(x, w3, bias, s, t, masks, True)
        l0, c0, _, g0 = self._port(x, w3, bias, s, t, masks, False)
        assert l0 == pytest.approx(l1, rel=1e-6)
        assert np.abs(c0).max() == 0.0 and np.abs(c1).sum() > 0.0
        for a, b in zip(g0, g1):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


def test_head_loss_bwd_ref_is_the_forward_derivative(rng):
    """dstats with one CE cotangent per sample (as assemble_dice_ce makes
    it); written-out backward vs autograd of the plain forward, f32."""
    B, H, W, CIN, NC = 2, 6, 10, 4, 5
    f32 = torch.float32
    raw = _t(rng.randn(B, H, W, CIN), True)
    s, t = _t(rng.rand(CIN) + 0.5, True), _t(rng.randn(CIN) * 0.5, True)
    w, bias = _t(rng.randn(3, 3, CIN, NC) * 0.5, True), _t(rng.randn(NC), True)
    labels = torch.from_numpy(rng.randint(0, NC, (B, H, W)))
    x = Pending(raw, s, t, "relu")
    logp, stats, _ = head_loss_fwd_ref(x, w, bias, labels, dtype=f32)
    ds = _t(rng.randn(B, 4, NC))
    ds[:, 3] = _t(rng.randn(B, 1)).expand(B, NC)
    (stats * ds).sum().backward()
    det = Pending(raw.detach(), s.detach(), t.detach(), "relu")
    dx, dw, (dsc, dsh), dbias = head_loss_bwd_ref(det, w.detach(), logp, labels,
                                                  ds, dtype=f32)
    for a, b in zip([dx, dw, dsc, dsh, dbias], [raw, w, s, t, bias]):
        assert _rel(_np(a), _np(b.grad)) < 1e-4
