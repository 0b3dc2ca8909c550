"""The fused chain's last two parts of the kernels' contract, on the CPU
(the kernels' plain versions):

- K3's ``thru`` addend: the plain backward with an addend is the one
  without it plus the addend, added before the one rounding of dx.
- The depthwise mode of K1 / K3 (the mbv3 b1_1's stride-1 3×3): its plain
  versions against the grouped conv and against autograd.
- ``FusedIRBlock``, the fused b1 pair (``fused_b1``, JAX's ``packed_b1``),
  against JAX's XLA ``InvertedResidual`` pair on the same variables, as
  ``tests/test_packed_chain.py::TestPackedFrontend::
  test_packed_b1_feature_and_grads`` holds ``PackedIRBlock``, with its
  bounds: f3 max|Δ| / max < 0.04, b1's BN statistics atol 0.03 / rtol
  0.1, every b1 gradient within 1.5× the bf16 XLA path's deviation from
  the f32 XLA path, + 0.02·(max + 1); and the weight conversion round trip.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F
import jax
import jax.numpy as jnp

from mmr_tpu_torch.models.convert import from_jax_variables, to_jax_variables
from mmr_tpu_torch.models.encoders import get_encoder
from mmr_tpu_torch.models.layers import nhwc
from mmr_tpu_torch.ops.fused_conv import (BF16, Pending, fused_conv,
                                          fused_conv_ad, fused_conv_bwd_ref,
                                          fused_conv_ref)
from tests.test_torch_models import _fill
from tests.test_torch_train_modules import few_torch_threads  # noqa: F401

F32 = torch.float32


def _bf16(rng, *shape, scale=1.0):
    return torch.from_numpy(rng.randn(*shape).astype(np.float32) * scale).to(BF16)


def _pending(rng, b, h, w, c, act, up=False, dtype=BF16):
    return Pending(_bf16(rng, b, h, w, c).to(dtype),
                   torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32)),
                   torch.from_numpy((0.3 * rng.randn(c)).astype(np.float32)),
                   act, up)


def test_k3_addend_added_before_the_rounding(rng):
    """Two inputs (a lazily ×2-upsampled one, whose addend is at source
    resolution) with prologues: dx_j with addend a_j is ``(dx_j in f32 +
    a_j).to(bf16)`` bit for bit, the f32 dx_j from the same launch on
    f32-stored copies of the bf16 inputs; dW, d scale, d shift and dbias
    equal the launch without addends."""
    ins = [_pending(rng, 2, 4, 8, 16, "relu", up=True),
           _pending(rng, 2, 8, 16, 24, "hswish")]
    ws = [torch.from_numpy(rng.randn(3, 3, p.c, 16).astype(np.float32) * 0.1)
          for p in ins]
    y = fused_conv_ref(ins, ws)
    dy = _bf16(rng, 2, 8, 16, 16)
    daccs = [_bf16(rng, *p.raw.shape) for p in ins]
    got = fused_conv_bwd_ref(ins, ws, y, dy, None, True, daccs)
    none = fused_conv_bwd_ref(ins, ws, y, dy, None, True)
    wide = [Pending(p.raw.float(), p.scale, p.shift, p.act, p.up2x) for p in ins]
    own = fused_conv_bwd_ref(wide, ws, y, dy, None, True)[0]
    for j, a in enumerate(daccs):
        assert got[0][j].dtype == BF16
        assert torch.equal(got[0][j], (own[j] + a.float()).to(BF16))
        assert not torch.equal(got[0][j], none[0][j])
        assert torch.equal(got[1][j], none[1][j])
        assert all(torch.equal(u, v) for u, v in zip(got[2][j], none[2][j]))
    assert torch.equal(got[3], none[3])


def test_depthwise_mode_plain_versions(rng):
    """K1's depthwise mode (3×3 stride 1, one (3, 3, 1, C) weight) is the
    grouped conv of the prologue'd input (bf16-rounded as the kernels
    round), moments from the f32 result; K3's is autograd of it at f32
    storage (dx, dW, d scale, d shift, dbias within 1e-5 of the largest),
    reached through ``fused_conv_ad``; a second input or a lazy one
    raises."""
    c = 24
    p = _pending(rng, 2, 9, 13, c, "relu")
    w = torch.from_numpy(rng.randn(3, 3, 1, c).astype(np.float32) * 0.3)
    bias = torch.from_numpy(rng.randn(c).astype(np.float32))
    y, mom = fused_conv([p], [w], bias, emit_moments=True, depthwise=True)
    a = torch.relu(p.raw.float() * p.scale + p.shift).to(BF16).float()
    want = F.conv2d(a.permute(0, 3, 1, 2), w.to(BF16).float().permute(3, 2, 0, 1),
                    bias, padding=1, groups=c).permute(0, 2, 3, 1)
    assert torch.equal(y, want.to(BF16))
    torch.testing.assert_close(mom, torch.stack([want.sum((0, 1, 2)),
                                                 (want * want).sum((0, 1, 2))]))

    leaves = [p.raw.float().requires_grad_(), p.scale.clone().requires_grad_(),
              p.shift.clone().requires_grad_(), w.clone().requires_grad_(),
              bias.clone().requires_grad_()]
    pf = Pending(*leaves[:3], "relu")
    r = torch.from_numpy(rng.randn(*y.shape).astype(np.float32))
    (fused_conv_ref([pf], [leaves[3]], leaves[4], dtype=F32,
                    depthwise=True) * r).sum().backward()
    dx, dw, dpro, dbias = fused_conv_bwd_ref([pf], [w], None, r, None, True,
                                             depthwise=True, dtype=F32)
    for got, ref in zip((dx[0], *dpro[0], dw[0], dbias), leaves):
        assert ((got - ref.grad).abs().max() / ref.grad.abs().max()) < 1e-5

    pg = Pending(p.raw.clone().requires_grad_(), p.scale, p.shift, "relu")
    (fused_conv_ad([pg], [w], depthwise=True)[0].float() * r).sum().backward()
    assert torch.equal(pg.raw.grad, fused_conv_bwd_ref(
        [p], [w], None, (r.to(BF16)).contiguous(), depthwise=True)[0][0])
    with pytest.raises(ValueError):
        fused_conv([p, p], [w, w], depthwise=True)
    with pytest.raises(ValueError):
        fused_conv([Pending(p.raw, up2x=True)], [w], depthwise=True)


@pytest.fixture(scope="module")
def b1_case():
    """JAX's XLA encoder (bf16, and f32 as the oracle) on one 256×256 image
    (the reference test's: at 64×128 the b1 BNs see 512 and 128 values a
    channel, and b1_0's depthwise kernel gradient of every bf16 path —
    JAX's XLA one, the port's plain and fused ones — swings with the draw,
    the fused one once 1.01× over the bound, the plain one 2× under it on
    another draw) in train mode: f3, the updated BN statistics and the
    gradients of an f3-level loss Σ f3·r3, one jitted program each."""
    from mmr_tpu.models.encoders import get_encoder as get_encoder_j

    rng = np.random.RandomState(1600)
    spec = get_encoder_j("tu-mobilenetv3_small_100")
    enc_s = spec.build(jnp.bfloat16, "encoder")
    enc_f = spec.build(jnp.float32, "encoder")
    x = rng.rand(1, 256, 256, 3).astype(np.float32)
    shapes = jax.eval_shape(lambda k: enc_s.init(k, jnp.asarray(x), train=False),
                            jax.random.key(0))
    variables = _fill(shapes, rng)
    r3 = rng.randn(1, 32, 32, 24).astype(np.float32)

    def f3_loss(params, enc):
        out, mut = enc.apply({"params": params,
                              "batch_stats": variables["batch_stats"]},
                             jnp.asarray(x), train=True, mutable=["batch_stats"])
        return (out[2].astype(jnp.float32) * r3).sum(), (out[2], mut)

    res = {}
    for name, enc in (("bf16", enc_s), ("f32", enc_f)):
        (_, (f3, mut)), g = jax.jit(jax.value_and_grad(
            lambda p, e=enc: f3_loss(p, e), has_aux=True))(
            jax.tree_util.tree_map(jnp.asarray, variables["params"]))
        res[name] = (np.asarray(f3, np.float32),
                     jax.tree_util.tree_map(np.asarray, mut["batch_stats"]),
                     jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), g))
    return {"variables": variables, "x": x, "r3": r3, **res}


def _leaves(tree, path=()):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield "/".join(path + (k,)), v


def test_fused_b1_matches_jax(b1_case):
    """The fused b1 pair (``fused_frontend=True, fused_b1=True``; the
    kernels' plain versions, bf16) against JAX's XLA encoder on the same
    variables and image, train mode: f3, b1's updated BN statistics, and
    every b1 gradient (18 leaves) at ``test_packed_chain.py:411-477``'s
    bounds; f3 is returned as a plain tensor."""
    enc = get_encoder("tu-mobilenetv3_small_100").build(fused_frontend=True,
                                                        fused_b1=True)
    enc.load_state_dict(from_jax_variables(b1_case["variables"]))
    enc.train()
    x = torch.from_numpy(b1_case["x"]).permute(0, 3, 1, 2)
    f3 = enc(x)[2]
    assert isinstance(f3, torch.Tensor) and f3.dtype == BF16
    (nhwc(f3).float() * torch.from_numpy(b1_case["r3"])).sum().backward()

    f3_s, stats_s, g_s = b1_case["bf16"]
    _, _, g_f = b1_case["f32"]
    got = nhwc(f3).float().detach().numpy()
    assert np.abs(got - f3_s).max() / np.abs(f3_s).max() < 0.04
    tree = to_jax_variables(dict(enc.state_dict()))["batch_stats"]
    grads = to_jax_variables({n: p.grad for n, p in enc.named_parameters()
                              if n.startswith("b1_")})["params"]
    n = 0
    for blk in ("b1_0", "b1_1"):
        for bn in ("bn1", "bn2", "bn3"):
            for stat in ("mean", "var"):
                np.testing.assert_allclose(tree[blk][bn][stat],
                                           stats_s[blk][bn][stat],
                                           atol=0.03, rtol=0.1,
                                           err_msg=f"{blk}/{bn}/{stat}")
        for (name, f), (_, b), (_, p) in zip(_leaves(g_f[blk]), _leaves(g_s[blk]),
                                             _leaves(grads[blk])):
            dev_p, dev_x = np.abs(p - f).max(), np.abs(b - f).max()
            assert dev_p <= 1.5 * dev_x + 0.02 * (np.abs(f).max() + 1.0), \
                (blk, name, dev_p, dev_x)
            n += 1
    assert n == 18


def test_fused_b1_converts_and_needs_the_front_end(b1_case):
    """``from_jax_variables`` fills the fused-b1 encoder from JAX's tree
    unchanged (strict load; ``to_jax_variables`` gives the tree back), the
    parameter tree being the plain encoder's; ``fused_b1`` without
    ``fused_frontend`` raises, as JAX's ``packed_b1`` needs
    ``packed_frontend``; off by default."""
    spec = get_encoder("tu-mobilenetv3_small_100")
    enc = spec.build(fused_frontend=True, fused_b1=True)
    enc.load_state_dict(from_jax_variables(b1_case["variables"]), strict=True)
    back = to_jax_variables(enc.state_dict())
    for coll in ("params", "batch_stats"):
        for (n, a), (m, b) in zip(_leaves(back[coll]),
                                  _leaves(b1_case["variables"][coll])):
            assert n == m and np.array_equal(a, b), n
    assert list(enc.state_dict()) == list(spec.build().state_dict())
    assert not spec.build().fused_b1
    with pytest.raises(ValueError, match="fused_frontend"):
        spec.build(fused_b1=True)
