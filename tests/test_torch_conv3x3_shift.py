"""The round-1 shifted-GEMM conv in the port (``mmr_tpu_torch/ops/conv3x3.py``)
held against the JAX package: K8a's and K8b's plain versions against the
Pallas kernels ``_conv3x3_pallas`` / ``_conv3x3_dw_pallas`` run in
interpret mode, as ``tests/test_conv3x3_kernel.py`` runs them (its shapes
and its bounds), and the differentiable ``conv3x3_bias_act`` against JAX's
custom VJP, on the library path and on the kernels' path. Inputs are made
with seeded numpy.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from mmr_tpu_torch.ops import conv3x3 as k8
from tests.test_torch_train_modules import few_torch_threads  # noqa: F401

BF16 = torch.bfloat16
SHAPES = [((2, 16, 12, 8), 8), ((1, 32, 30, 16), 24), ((2, 64, 30, 8), 16)]


@pytest.fixture
def pallas(monkeypatch):
    """JAX's conv3x3 with its kernel forced and interpreted."""
    import mmr_tpu.ops.pallas.conv3x3 as kj

    monkeypatch.setattr(kj, "_FORCE_PALLAS", True)
    monkeypatch.setattr(kj, "_INTERPRET", True)
    return kj


def _case(rng, shape, cout):
    x = rng.randn(*shape).astype(np.float32)
    w = (rng.randn(3, 3, shape[-1], cout) * 0.1).astype(np.float32)
    b = rng.randn(cout).astype(np.float32)
    return x, w, b


def _dtypes(dtype):
    return (jnp.bfloat16, BF16) if dtype == "bf16" else (jnp.float32, torch.float32)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("shape,cout", SHAPES)
def test_k8a_plain_matches_pallas(pallas, rng, shape, cout, dtype):
    """K8a's plain version vs ``_conv3x3_pallas`` (x rounded to bf16 on
    chip, f32 accumulation, y in x's dtype): atol 0.05, the JAX suite's
    bound."""
    jd, td = _dtypes(dtype)
    x, w, b = _case(rng, shape, cout)
    want = pallas._conv3x3_pallas(jnp.asarray(x, jd), jnp.asarray(w),
                                  jnp.asarray(b), True)
    got = k8.conv3x3_shift(torch.from_numpy(x).to(td), torch.from_numpy(w),
                           torch.from_numpy(b), True)
    assert got.dtype == td and want.dtype == jd
    assert got.shape == shape[:3] + (cout,)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=0.05)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_k8b_plain_matches_pallas(pallas, rng, dtype):
    """K8b's plain version (x and dy in one storage type, rounded to
    bf16) vs ``_conv3x3_dw_pallas`` (dy read as f32): within 1e-2 of
    max|ref|, the JAX suite's bound for this kernel."""
    jd, td = _dtypes(dtype)
    x = rng.randn(2, 32, 30, 8).astype(np.float32)
    dy = rng.randn(2, 32, 30, 16).astype(np.float32)
    want = np.asarray(pallas._conv3x3_dw_pallas(jnp.asarray(x, jd), jnp.asarray(dy)))
    got = k8.conv3x3_shift_dw(torch.from_numpy(x).to(td),
                              torch.from_numpy(dy).to(td))
    assert got.dtype == torch.float32 and got.shape == (3, 3, 8, 16)
    assert np.abs(got.numpy() - want).max() <= 0.01 * np.abs(want).max()


def _vjp_both(rng, relu, shape=(1, 16, 12, 8), cout=8):
    """(y, dx, dw, db) of JAX's ``conv3x3_bias_act`` and of the port's, on
    the same f32 inputs and cotangent."""
    import mmr_tpu.ops.pallas.conv3x3 as kj

    x, w, b = _case(rng, shape, cout)
    g = rng.randn(*shape[:3], cout).astype(np.float32)
    y_j, vjp = jax.vjp(lambda x_, w_, b_: kj.conv3x3_bias_act(x_, w_, b_, relu),
                       jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    want = [y_j, *vjp(jnp.asarray(g))]
    xt, wt, bt = (torch.from_numpy(a).requires_grad_() for a in (x, w, b))
    y = k8.conv3x3_bias_act(xt, wt, bt, relu)
    y.backward(torch.from_numpy(g))
    got = [y.detach(), xt.grad, wt.grad, bt.grad]
    return [t.numpy() for t in got], [np.asarray(a) for a in want]


@pytest.mark.parametrize("relu", [True, False])
def test_bias_act_library_path_matches_jax_vjp(rng, monkeypatch, relu):
    """``_FORCE`` off on both sides: ``_lax_conv`` forward and the custom
    VJP's library dx / dW and Σg, f32: rtol = atol = 1e-4."""
    import mmr_tpu.ops.pallas.conv3x3 as kj

    monkeypatch.setattr(kj, "_FORCE_PALLAS", False)
    monkeypatch.setattr(k8, "_FORCE", False)
    got, want = _vjp_both(rng, relu)
    for name, a, b in zip("y dx dw db".split(), got, want):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4, err_msg=name)


def test_bias_act_kernel_path_matches_jax_vjp(pallas, rng, monkeypatch):
    """``_FORCE`` on both sides: K8a forward and dx, K8b dW (their plain
    versions here) vs the Pallas kernels interpreted, f32 storage: y and
    dx atol 0.05, dW within 1e-2 of max|ref| (the bounds above), dbias
    rtol 1e-4 (f32 sums)."""
    monkeypatch.setattr(k8, "_FORCE", True)
    (y, dx, dw, db), (y_j, dx_j, dw_j, db_j) = _vjp_both(rng, True)
    np.testing.assert_allclose(y, y_j, atol=0.05)
    np.testing.assert_allclose(dx, dx_j, atol=0.05)
    assert np.abs(dw - dw_j).max() <= 0.01 * np.abs(dw_j).max()
    np.testing.assert_allclose(db, db_j, rtol=1e-4, atol=1e-4)


def test_wrappers_count_launches_and_raise_elsewhere(rng, monkeypatch):
    """On the CPU a wrapper runs its plain version and counts no launch,
    under ``conv3x3_bias_act`` too; it takes f32 or bf16 storage only
    (K8b: x and dy in one type), and a tensor on another device (meta) raises: no kernel, no plain
    version, no fallback."""
    monkeypatch.setattr(k8, "_FORCE", True)
    x, w, b = (torch.from_numpy(a) for a in _case(rng, (1, 8, 8, 4), 4))
    counts = lambda: (k8.conv3x3_shift.launches, k8.conv3x3_shift_dw.launches)
    before = counts()
    xg = x.clone().requires_grad_()
    k8.conv3x3_bias_act(xg, w, b, True).sum().backward()
    k8.conv3x3_shift_dw(x.to(BF16), x.to(BF16))
    assert counts() == before and xg.grad is not None
    with pytest.raises(ValueError):
        k8.conv3x3_shift(x.half(), w, b)
    with pytest.raises(ValueError):
        k8.conv3x3_shift_dw(x, x.to(BF16))
    with pytest.raises(ValueError):
        k8.conv3x3_shift(x.to("meta"), w.to("meta"), b.to("meta"))
    with pytest.raises(ValueError):
        k8.conv3x3_shift_dw(x.to("meta"), x.to("meta"))
    assert counts() == before
