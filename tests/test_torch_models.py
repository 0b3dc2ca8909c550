"""The port's UNet++/MobileNetV3 flagship held against the JAX
``UnetPlusPlusModel`` on the same weights.

The variables follow the JAX model's own tree (``jax.eval_shape`` of its
init) and are filled from seeded numpy — with BN scale, bias and running
mean/var perturbed away from identity, so a BN-fold error shows — then
reach the port through ``from_jax_variables``.
"""

import ast
from collections.abc import Mapping
from pathlib import Path

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from mmr_tpu_torch.models import create_model
from mmr_tpu_torch.models.convert import from_jax_variables
from tests.test_torch_train_modules import few_torch_threads  # noqa: F401

NC = 10
REPO = Path(__file__).resolve().parents[1]


def _fill(tree, rng):
    """Seeded-numpy values for a tree of shapes (conv kernels lecun-normal
    with a small gain, BN away from identity)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out[k] = _fill(v, rng)
            continue
        shape = tuple(v.shape)
        if k == "kernel":
            a = rng.randn(*shape) * 1.1 / np.sqrt(np.prod(shape[:-1]))
        elif k == "scale":
            a = rng.uniform(0.9, 1.3, shape)
        elif k == "mean":
            a = rng.randn(*shape) * 0.1
        elif k == "var":
            a = rng.uniform(0.6, 1.4, shape)
        else:  # conv and BN biases
            a = rng.randn(*shape) * 0.1
        out[k] = a.astype(np.float32)
    return out


@pytest.fixture(scope="module")
def jax_variables():
    from mmr_tpu.models.decoders import UnetPlusPlusModel

    m = UnetPlusPlusModel(num_classes=NC, dtype=jnp.float32)
    shapes = jax.eval_shape(lambda k, x: m.init(k, x, train=False),
                            jax.random.key(0), jnp.zeros((1, 64, 128, 3)))
    return _fill(shapes, np.random.RandomState(1234))


def _jax_logits(variables, x, dtype):
    from mmr_tpu.models.decoders import UnetPlusPlusModel

    m = UnetPlusPlusModel(num_classes=NC, dtype=dtype)
    f = jax.jit(lambda v, a: m.apply(v, a, train=False))
    return np.asarray(f(jax.tree_util.tree_map(jnp.asarray, variables),
                        jnp.asarray(x)), np.float32)


def _port(variables, dtype, **kw):
    model = create_model("UnetPlusPlus", "tu-mobilenetv3_small_100",
                         classes=NC, dtype=dtype, device="cpu", **kw)
    model.load_state_dict(from_jax_variables(variables))
    return model


def test_param_count_and_keys(jax_variables):
    sd = from_jax_variables(jax_variables)
    model = create_model(classes=NC, device="cpu")
    own = model.state_dict()
    assert set(sd) == set(own)
    for k, v in own.items():
        assert sd[k].shape == v.shape, k
    assert sum(p.numel() for p in model.parameters()) == 3_714_090
    # the plain and fused paths share one state_dict
    fused = create_model(classes=NC, device="cpu", fused=True,
                         fused_frontend=True)
    assert set(fused.state_dict()) == set(own)


def test_plain_f32_matches_jax(jax_variables, rng):
    """f32 on both sides: only summation order differs (1e-3)."""
    x = rng.rand(2, 64, 128, 3).astype(np.float32)
    want = _jax_logits(jax_variables, x, jnp.float32)
    with torch.no_grad():
        got = _port(jax_variables, torch.float32)(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 64, 128, NC) and got.dtype == np.float32
    assert np.abs(want).max() > 0.5  # logits big enough for the bound to bite
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)


def test_fused_bf16_matches_jax(jax_variables, rng):
    """Every node, the head, the stem and b0_0 on the fused kernels' plain
    versions (``packed_min_hw=0``), bf16, vs the JAX XLA path in bf16 —
    the bounds of ``TestPackedUnetPP`` (bf16 rounds at different places
    in the two graphs)."""
    x = rng.rand(1, 128, 256, 3).astype(np.float32)
    want = _jax_logits(jax_variables, x, jnp.bfloat16)
    model = _port(jax_variables, torch.bfloat16, fused=True,
                  fused_frontend=True, packed_min_hw=0)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=0.25, rtol=0.05)
    assert (got.argmax(-1) == want.argmax(-1)).mean() > 0.99


def test_fused_default_split_matches_plain(jax_variables, rng):
    """At the default ``packed_min_hw`` the coarse nodes stay on the plain
    path and hand their outputs to fused nodes (and back): same result as
    the all-plain bf16 model within bf16 drift."""
    x = torch.from_numpy(rng.rand(1, 128, 256, 3).astype(np.float32))
    plain = _port(jax_variables, torch.bfloat16)
    fused = _port(jax_variables, torch.bfloat16, fused=True,
                  fused_frontend=True)
    with torch.no_grad():
        a, b = plain(x).numpy(), fused(x).numpy()
    np.testing.assert_allclose(b, a, atol=0.25, rtol=0.05)
    assert (a.argmax(-1) == b.argmax(-1)).mean() > 0.99


def test_entry_points_refuse_cpu_fallback():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        create_model(classes=NC)


def test_unported_options_raise():
    with pytest.raises(ValueError, match="unknown encoder"):
        create_model(encoder_name="mit_b3", device="cpu")   # JAX has none either
    with pytest.raises(NotImplementedError, match="MobileNetV3 stem"):
        create_model(encoder_name="resnet18", device="cpu", fused=True,
                     fused_frontend=True)
    from mmr_tpu_torch.losses import dice_ce_loss
    from mmr_tpu_torch.train.optim import build_optimizer
    from mmr_tpu_torch.train.steps import make_train_step

    with pytest.raises(ValueError, match="unknown optimizer"):
        build_optimizer("adagrad")   # no such optimizer in the JAX package either
    model = create_model(classes=NC, device="cpu")
    with pytest.raises(TypeError, match="AugmentConfig or a callable"):
        make_train_step(model, build_optimizer("adamw"), dice_ce_loss, NC,
                        augment=object(), device="cpu")


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_port_imports_no_jax():
    """Every module of the port (``cli/``, ``monitor/``, ``data/`` and
    ``core/`` included) and ``chip_smoke.py`` import no JAX and nothing of
    the JAX package, and none of the libraries the card's machine lacks
    or the package rule forbids (cv2, matplotlib, orbax, yaml, psutil, tqdm,
    tensorstore, sklearn, PIL, zarr, numcodecs, zstandard, blosc)."""
    files = sorted((REPO / "mmr_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 15
    for sub in ("cli/train_path_a.py", "cli/eval_path_a.py", "monitor/plots.py",
                "data/png.py", "data/png_dataset.py", "core/prng.py",
                "config/config.py", "train/engine.py", "data/pipeline.py",
                "core/precision.py", "data/zarr_io.py", "data/patch_dataset.py",
                "data/video_dataset.py", "data/splits.py", "data/synthetic.py",
                "data/convert.py", "ops/onehot.py", "ops/padcrop.py",
                "cli/train_model.py", "cli/infer.py", "cli/visualize.py",
                "core/mesh.py", "models/layers.py", "train/optim.py",
                "train/steps.py", "metrics/evaluate.py", "infer/sliding_window.py",
                "data/augment.py", "monitor/monitor.py"):
        assert REPO / "mmr_tpu_torch" / sub in files
    for f in files:
        bad = _imported_roots(f) & {"jax", "flax", "mmr_tpu", "jaxlib", "cv2",
                                    "matplotlib", "orbax", "yaml", "psutil",
                                    "tqdm", "tensorstore", "sklearn", "PIL",
                                    "zarr", "numcodecs", "zstandard", "blosc"}
        assert not bad, f"{f.relative_to(REPO)} imports {bad}"
