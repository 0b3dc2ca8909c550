"""The port's public surface against the JAX package's: the metric
functions over confusion stats (``metrics/iou.py``) in every reduction,
``list_models`` and the constants, the names every package ``__init__``
exports (read from JAX's sources by ``ast``), and ``mmr_torch_export_weights``
against ``mmr_export_weights`` on one seeded ``.pth``.
"""

import ast
import importlib
import json
from pathlib import Path

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import mmr_tpu_torch
from mmr_tpu_torch.metrics import iou
from tests.test_torch_train_modules import few_torch_threads  # noqa: F401

REDUCTIONS = [None, "none", "micro", "macro", "micro-imagewise", "macro-imagewise"]
JAX = Path(__file__).resolve().parents[1] / "mmr_tpu"


@pytest.fixture(scope="module")
def stats():
    """Seeded (images, classes) tp, fp, fn, tn counts, with classes absent
    from an image and one absent everywhere (zero denominators)."""
    rng = np.random.RandomState(7)
    tp, fp, fn, tn = (rng.randint(0, 50, (4, 6)) for _ in range(4))
    tp[1, 2] = fp[1, 2] = fn[1, 2] = 0
    tp[:, 5] = fp[:, 5] = fn[:, 5] = 0
    fp[0, 3] = 0
    return tp, fp, fn, tn


@pytest.mark.parametrize("reduction", REDUCTIONS)
@pytest.mark.parametrize("name", ["iou_score", "f1_score", "precision", "recall"])
def test_metric_matches_jax(stats, name, reduction):
    """Each metric in each reduction, ``zero_division`` 1 (the default) and
    0, equal to JAX's in f32 (rtol 1e-6)."""
    import mmr_tpu.metrics.iou as iou_j

    for zd in (1.0, 0.0):
        got = getattr(iou, name)(*(torch.from_numpy(a).float() for a in stats),
                                 reduction=reduction, zero_division=zd)
        want = getattr(iou_j, name)(*(jnp.asarray(a, jnp.float32) for a in stats),
                                    reduction=reduction, zero_division=zd)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def test_list_models_and_constants():
    """``list_models`` and the constants equal JAX's."""
    from mmr_tpu.core import prng as prng_j
    from mmr_tpu.models import factory as factory_j
    from mmr_tpu_torch.core import DEFAULT_SPLIT_SEED
    from mmr_tpu_torch.models import IMAGENET_MEAN, IMAGENET_STD, list_models

    assert list_models() == factory_j.list_models()
    assert DEFAULT_SPLIT_SEED == prng_j.DEFAULT_SPLIT_SEED
    np.testing.assert_array_equal(np.asarray(IMAGENET_MEAN, np.float32),
                                  factory_j.IMAGENET_MEAN)
    np.testing.assert_array_equal(np.asarray(IMAGENET_STD, np.float32),
                                  factory_j.IMAGENET_STD)


def _public_names(path: Path) -> set[str]:
    """Names a module binds at its top level by import, def, class or
    assignment (its public surface, read without importing it)."""
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.ImportFrom):
            names |= {a.asname or a.name for a in node.names}
        elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names |= {t.id for t in node.targets if isinstance(t, ast.Name)}
    return {n for n in names if not n.startswith("_") and n != "annotations"}


def test_package_exports_match_jax():
    """Every name a JAX package ``__init__`` imports is exported by the
    port's package of the same name, or listed in
    ``mmr_tpu_torch.NOT_PORTED`` with its reason; every listed name is a
    public name of the JAX module it names, and not exported by the port."""
    missing = []
    for init in sorted(JAX.glob("*/__init__.py")):
        pkg = init.parent.name
        port = importlib.import_module(f"mmr_tpu_torch.{pkg}")
        for name in _public_names(init):
            if not hasattr(port, name) and f"{pkg}.{name}" not in mmr_tpu_torch.NOT_PORTED:
                missing.append(f"{pkg}.{name}")
    assert not missing
    for dotted, reason in mmr_tpu_torch.NOT_PORTED.items():
        pkg, *module, name = dotted.split(".")
        src = JAX / pkg / (f"{module[0]}.py" if module else "__init__.py")
        assert name in _public_names(src) and reason, dotted
        assert not hasattr(importlib.import_module(f"mmr_tpu_torch.{pkg}"), name)


def test_export_weights_matches_jax(tmp_path, monkeypatch, capsys):
    """``--state_dict`` on one seeded torchvision ResNet-18 ``.pth``: the
    port's CLI and JAX's write stores with the same leaves, bit for bit,
    both verified against the committed manifest; without it and without
    timm (not installed here) the port returns 2, as JAX does."""
    from mmr_tpu.cli import export_weights as export_j
    from mmr_tpu_torch.cli import export_weights
    from tests import test_models as oracles
    from tests.test_torch_pretrained import _random_sd

    pth = tmp_path / "resnet18.pth"
    torch.save(_random_sd(oracles._TorchResNet18Encoder, seed=3), pth)
    lines, stores = [], []
    for main, sub in ((export_j.main, "jax"), (export_weights.main, "port")):
        monkeypatch.setenv("MMR_TPU_WEIGHTS_DIR", str(tmp_path / sub))
        assert main(["--encoder", "resnet18", "--state_dict", str(pth)]) == 0
        line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        lines.append(line)
        stores.append(dict(np.load(line["store"])))
    assert lines[0]["n_leaves"] == lines[1]["n_leaves"] == len(stores[0]) == 100
    assert stores[0].keys() == stores[1].keys()
    for k, v in stores[0].items():
        np.testing.assert_array_equal(stores[1][k], v)
    assert export_weights.main(["--encoder", "resnet18"]) == 2
    assert "timm is not installed" in capsys.readouterr().err
