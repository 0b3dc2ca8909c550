"""The Path-A kernels' plain versions held against the JAX package's Pallas
kernels, run in interpret mode as ``tests/test_conv3x3_kernel.py`` runs
them: K6a (``conv3x3_packed.py::_conv_packed``), K6b (``_conv_packed_dw``),
the port's autograd op against the VJP of JAX's ``conv3x3p_bias_act``, and
K7 (``confusion.py::confusion_stats``), its running total included; then the per-shape dispatch
(``ops/dispatch.py``): the committed table over the 256×256 Path-A plan,
its fallback and ``_FORCE``, and a conv whose forward and backward take
different routes against JAX's VJP. Inputs are bf16 values made with
seeded numpy.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from mmr_tpu_torch.models.layers import Conv3x3
from mmr_tpu_torch.ops import conv3x3_packed as k6
from mmr_tpu_torch.ops.confusion import confusion_stats
from tests.test_torch_train_modules import few_torch_threads  # noqa: F401

BF16 = torch.bfloat16


@pytest.fixture
def pallas(monkeypatch):
    """JAX's conv3x3_packed with its kernel forced and interpreted."""
    from mmr_tpu.ops.pallas import conv3x3_packed as kj

    monkeypatch.setattr(kj, "_INTERPRET", True)
    monkeypatch.setattr(kj, "_FORCE", True)
    return kj


def _bf16(a: np.ndarray) -> np.ndarray:
    """f32 values that bf16 holds exactly."""
    return np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _case(rng, shape, cout):
    x = _bf16(rng.randn(*shape).astype(np.float32))
    w = (rng.randn(3, 3, shape[-1], cout) / np.sqrt(9 * shape[-1])).astype(np.float32)
    b = (0.5 * rng.randn(cout)).astype(np.float32)
    return x, w, b


def _rel_to_max(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


# (B, H, W, Cin), Cout, relu, bias: shapes the JAX plan accepts (p = 4, 2, 2)
CONVS = [((2, 8, 64, 32), 10, False, True),    # the head's Cout
         ((2, 8, 32, 64), 16, True, True),
         ((1, 16, 32, 20), 64, True, False)]   # ragged Cin


@pytest.mark.parametrize("shape,cout,relu,with_bias", CONVS)
def test_k6a_plain_matches_pallas(pallas, rng, shape, cout, relu, with_bias):
    """K6a's plain version vs ``_conv_packed``: the same bf16 inputs and
    bf16-rounded weights, f32 accumulation on both sides; only the order of
    the sums differs, so the bf16 outputs agree within one ulp (atol = rtol
    = 1e-2)."""
    x, w, b = _case(rng, shape, cout)
    if not with_bias:
        b = np.zeros_like(b)
    want = pallas._conv_packed(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w),
                               jnp.asarray(b), relu)
    got = k6.conv3x3(torch.from_numpy(x).to(BF16), torch.from_numpy(w),
                     torch.from_numpy(b) if with_bias else None, relu)
    assert got.dtype == BF16 and got.shape == shape[:3] + (cout,)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=1e-2, rtol=1e-2)


@pytest.mark.parametrize("shape,cout", [((2, 8, 64, 32), 10), ((1, 16, 32, 20), 64)])
def test_k6b_plain_matches_pallas(pallas, rng, shape, cout):
    """K6b's plain version vs ``_conv_packed_dw``: exact bf16 products
    summed in f32 in two orders, max|Δ| / max|ref| < 1e-3."""
    x, _, _ = _case(rng, shape, cout)
    g = _bf16(rng.randn(*shape[:3], cout).astype(np.float32))
    want = np.asarray(pallas._conv_packed_dw(jnp.asarray(x, jnp.bfloat16),
                                             jnp.asarray(g, jnp.bfloat16)))
    got = k6.conv3x3_dw(torch.from_numpy(x).to(BF16), torch.from_numpy(g).to(BF16))
    assert got.dtype == torch.float32 and got.shape == (3, 3, shape[-1], cout)
    assert _rel_to_max(got.numpy(), want) < 1e-3


@pytest.mark.parametrize("relu,with_bias", [(True, True), (False, False)])
def test_autograd_op_matches_jax_vjp(pallas, rng, relu, with_bias):
    """``conv3x3p_bias_act``'s backward (ReLU mask, K6a with flipped,
    transposed taps for dx, K6b for dW, Σg for dbias) vs the VJP of JAX's
    op with its kernels interpreted, on the same bf16 cotangent: dx, dW and
    dbias within max|Δ| / max|ref| < 1e-2 (sums in other orders; a y near
    0 may round to the other side of the ReLU mask)."""
    x, w, b = _case(rng, (2, 8, 32, 16), 32)
    if not with_bias:
        b = np.zeros_like(b)
    g = _bf16(rng.randn(2, 8, 32, 32).astype(np.float32))
    y_j, vjp = jax.vjp(lambda x_, w_, b_: pallas.conv3x3p_bias_act(
        x_, w_, b_, relu, with_bias), jnp.asarray(x, jnp.bfloat16),
        jnp.asarray(w), jnp.asarray(b))
    dx_j, dw_j, db_j = vjp(jnp.asarray(g, jnp.bfloat16))

    xt = torch.from_numpy(x).to(BF16).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    bt = torch.from_numpy(b).requires_grad_() if with_bias else None
    y = k6.conv3x3p_bias_act(xt, wt, bt, relu)
    np.testing.assert_allclose(y.detach().float().numpy(),
                               np.asarray(y_j, np.float32), atol=1e-2, rtol=1e-2)
    y.backward(torch.from_numpy(g).to(BF16))
    assert xt.grad.dtype == BF16 and wt.grad.dtype == torch.float32
    assert _rel_to_max(xt.grad.float().numpy(), np.asarray(dx_j, np.float32)) < 1e-2
    assert _rel_to_max(wt.grad.numpy(), np.asarray(dw_j)) < 1e-2
    if with_bias:
        assert _rel_to_max(bt.grad.numpy(), np.asarray(db_j)) < 1e-2


@pytest.mark.parametrize("gt_dtype", [np.int64, np.uint8])
def test_k7_plain_matches_pallas(rng, gt_dtype):
    """K7's plain version vs ``confusion_stats(..., interpret=True)``,
    exactly: the padding sentinels −1 / −2 and ids ≥ C count nowhere (an
    int64 argmax map against an int64 or a uint8 mask)."""
    from mmr_tpu.ops.pallas.confusion import confusion_stats as confusion_j

    nc = 10
    pred = rng.randint(-2, nc + 3, (3, 40, 50)).astype(np.int64)
    lo = -2 if gt_dtype is np.int64 else 0
    gt = rng.randint(lo, nc + 3, (3, 40, 50))
    gt[0, :5] = 255 if gt_dtype is np.uint8 else -1
    gt[1, :5] = pred[1, :5]            # agreements, out-of-range ids included
    gt = gt.astype(gt_dtype)
    want = confusion_j(jnp.asarray(pred.astype(np.int32)),
                       jnp.asarray(gt.astype(np.int32)), nc, interpret=True)
    got = confusion_stats(torch.from_numpy(pred), torch.from_numpy(gt), nc)
    for a, b in zip(got, want):
        assert a.dtype == torch.float32 and a.shape == (nc,)
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert float(got[0].sum() + got[2].sum()) < pred.size   # some ids counted nowhere


def test_k7_running_total_matches_pallas(rng):
    """K7's accumulating entry (CPU: its plain version) adds ``[tp; fp; fn]``
    of each batch into an int64 (3, C) total, exactly the sum of the
    Pallas kernel's counts over the batches (``Evaluate.add_batch``'s
    path); the total is returned and updated in place."""
    from mmr_tpu.ops.pallas.confusion import confusion_stats as confusion_j

    nc = 10
    total = torch.full((3, nc), 7, dtype=torch.int64)
    want = np.full((3, nc), 7, np.int64)
    for _ in range(2):
        pred = rng.randint(-2, nc + 3, (2, 24, 40)).astype(np.int64)
        gt = rng.randint(0, nc + 3, (2, 24, 40)).astype(np.uint8)
        gt[:, :3] = pred[:, :3].clip(0, 255)
        assert confusion_stats(torch.from_numpy(pred), torch.from_numpy(gt), nc,
                               total=total) is total
        want += np.stack([np.asarray(a, np.int64) for a in confusion_j(
            jnp.asarray(pred.astype(np.int32)), jnp.asarray(gt.astype(np.int32)),
            nc, interpret=True)])
    np.testing.assert_array_equal(total.numpy(), want)
    with pytest.raises(ValueError, match="int64"):
        confusion_stats(torch.from_numpy(pred), torch.from_numpy(gt), nc,
                        total=total.float())


def test_dispatch_over_the_path_a_plan(monkeypatch):
    """Which Conv3x3s of the UNet++/ResNet-18 plan at 256×256 take K6, and
    in which direction: the committed table (``ops/conv_table.json``) has
    both keys of each of the 23 convs, and a bf16 conv reaches the op
    exactly when the table sends its forward (h, w, cin, cout) or its
    backward (h, w, cout, cin) to the kernels, with those two routes;
    under ``_FORCE`` all 23 take both; f32 convs never. Shapes only: the
    model runs on the meta device with the op counted, not computed."""
    from mmr_tpu_torch.models import create_model
    from mmr_tpu_torch.ops import dispatch

    calls, seen = [], []

    def counted(x, w, bias=None, relu=False, fwd_kernel=True, bwd_kernel=True):
        calls.append((tuple(x.shape), tuple(w.shape), fwd_kernel, bwd_kernel))
        return x.new_empty(x.shape[:3] + (w.shape[3],))

    monkeypatch.setattr(k6, "conv3x3p_bias_act", counted)
    x = torch.empty(8, 256, 256, 3, device="meta")
    model = create_model("smp_UNet++", classes=10, device="cpu",
                         dtype=torch.float32).to("meta")
    with torch.no_grad():
        model(x)
    assert not calls
    model = create_model("smp_UNet++", classes=10, device="cpu").to("meta")
    convs = [m for m in model.modules() if isinstance(m, Conv3x3)]
    assert len(convs) == 23
    for m in convs:
        m.register_forward_pre_hook(lambda m, a: seen.append(
            (a[0].shape[2], a[0].shape[3], m.in_channels, m.out_channels)))
    entries = dispatch.table()["shapes"]
    want = []
    for force in (None, True):
        monkeypatch.setattr(k6, "_FORCE", force)
        calls.clear(), seen.clear()
        with torch.no_grad():
            assert model(x).shape == (8, 256, 256, 10)
        assert len(seen) == 23
        if force is None:
            for h, w, cin, cout in seen:
                fwd = entries[dispatch.shape_key(h, w, cin, cout)]["kernel_wins"]
                bwd = entries[dispatch.shape_key(h, w, cout, cin)]["kernel_wins"]
                if fwd or bwd:
                    want.append(((8, h, w, cin), (3, 3, cin, cout), fwd, bwd))
        else:
            want = [((8, h, w, cin), (3, 3, cin, cout), True, True)
                    for h, w, cin, cout in seen]
        assert calls == want


def test_dispatch_table_and_fallback(monkeypatch, tmp_path):
    """``dispatch.use_kernel`` follows the committed table's verdict at a
    key it has (JAX's ``bench_conv_kernel.py`` shapes, both directions,
    measured on the card it names) and the size clause elsewhere (H·W ≥
    64·64); ``conv3x3_packed.use_kernel`` keeps f32 on the library conv and
    obeys ``_FORCE``; ``record`` merges entries and fields and clears the
    cache."""
    import importlib.util

    from mmr_tpu_torch.ops import dispatch

    spec = importlib.util.spec_from_file_location(
        "bench_conv_kernel", "benchmarks/bench_conv_kernel.py")
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    assert dispatch.BENCH_SHAPES == bench.SHAPES
    table = dispatch.table()
    assert "H100" in table["card"] and table["commit"]
    for hw, cin, cout in dispatch.BENCH_SHAPES:
        for a, b in ((cin, cout), (cout, cin)):
            e = table["shapes"][dispatch.shape_key(hw, hw, a, b)]
            assert dispatch.use_kernel(hw, hw, a, b) == e["kernel_wins"]
            assert e["kernel_wins"] == (e["kernel_fwdbwd_ms"] < e["library_fwdbwd_ms"])
            assert e["batch"] == 8
    assert dispatch.shape_key(64, 80, 3, 7) == "64x80x3->7"
    assert dispatch.use_kernel(64, 64, 3, 7) and dispatch.use_kernel(32, 128, 3, 7)
    assert not dispatch.use_kernel(63, 64, 3, 7)
    assert not k6.use_kernel(torch.float32, 512, 512, 3, 7)
    for force in (True, False):
        monkeypatch.setattr(k6, "_FORCE", force)
        assert k6.use_kernel(BF16, 8, 8, 3, 7) == force
        assert not k6.use_kernel(torch.float32, 8, 8, 3, 7)
    monkeypatch.setattr(dispatch, "TABLE_PATH", tmp_path / "t.json")
    dispatch.table.cache_clear()
    try:
        assert dispatch.table() == {"shapes": {}}
        dispatch.record({"8x8x3->7": {"kernel_wins": True}}, card="c")
        dispatch.record({"8x8x7->3": {"kernel_wins": False}}, commit="x")
        assert dispatch.table() == {"card": "c", "commit": "x", "shapes": {
            "8x8x3->7": {"kernel_wins": True}, "8x8x7->3": {"kernel_wins": False}}}
        monkeypatch.setattr(k6, "_FORCE", None)
        assert k6.routes(torch.empty(1, 8, 8, 3, dtype=BF16), 7) == (True, False)
    finally:
        dispatch.table.cache_clear()


@pytest.mark.parametrize("fwd,bwd", [(True, False), (False, True)])
def test_routes_apart_match_jax_vjp(monkeypatch, rng, fwd, bwd):
    """A patched table sends a ``Conv3x3``'s forward to one route and its
    backward to the other: the counted calls show K6a's / the library
    conv's forward and K6a + K6b's / the library conv's backward, and y,
    dx, dW and dbias equal the VJP of JAX's ``conv3x3p_bias_act`` (its
    ``lax`` branch on the CPU) on the same bf16 cotangent within max|Δ| /
    max|ref| < 1e-2 (y: atol = rtol = 1e-2). No ReLU, as a Conv3x3 runs it:
    the library forward adds the bias rounded to bf16, as the port's
    ``Conv2d`` does, and JAX adds it in f32, so a fused ReLU could mask a y
    near 0 on one side only."""
    from mmr_tpu.ops.pallas import conv3x3_packed as kj
    from mmr_tpu_torch.ops import dispatch

    h, w, cin, cout = 8, 32, 16, 24
    monkeypatch.setattr(dispatch, "table", lambda: {"shapes": {
        dispatch.shape_key(h, w, cin, cout): {"kernel_wins": fwd},
        dispatch.shape_key(h, w, cout, cin): {"kernel_wins": bwd}}})
    names = ("conv3x3", "conv3x3_dw", "_library_fwd", "_library_bwd")
    calls = dict.fromkeys(names, 0)
    for name in names:
        def count(*a, _fn=getattr(k6, name), _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(k6, name, count)
    x, wt, b = _case(rng, (2, h, w, cin), cout)
    g = _bf16(rng.randn(2, h, w, cout).astype(np.float32))
    y_j, vjp = jax.vjp(lambda x_, w_, b_: kj.conv3x3p_bias_act(x_, w_, b_, False, True),
                       jnp.asarray(x, jnp.bfloat16), jnp.asarray(wt), jnp.asarray(b))
    dx_j, dw_j, db_j = vjp(jnp.asarray(g, jnp.bfloat16))

    layer = Conv3x3(cin, cout)
    with torch.no_grad():
        layer.weight.copy_(torch.from_numpy(wt).permute(3, 2, 0, 1))
        layer.bias.copy_(torch.from_numpy(b))
    xt = torch.from_numpy(x).to(BF16).requires_grad_()
    y = layer(xt.permute(0, 3, 1, 2))
    y.backward(torch.from_numpy(g).to(BF16).permute(0, 3, 1, 2))
    assert calls == {"conv3x3": fwd + bwd, "conv3x3_dw": int(bwd),
                     "_library_fwd": int(not fwd), "_library_bwd": int(not bwd)}
    np.testing.assert_allclose(y.detach().permute(0, 2, 3, 1).float().numpy(),
                               np.asarray(y_j, np.float32), atol=1e-2, rtol=1e-2)
    assert _rel_to_max(xt.grad.float().numpy(), np.asarray(dx_j, np.float32)) < 1e-2
    assert _rel_to_max(layer.weight.grad.permute(2, 3, 1, 0).numpy(),
                       np.asarray(dw_j)) < 1e-2
    assert _rel_to_max(layer.bias.grad.numpy(), np.asarray(db_j)) < 1e-2
