"""The port's pretrained-weight importers, weight store and manifest
(``mmr_tpu_torch/models/pretrained.py``, ``weight_manifest.py``) held
against the JAX package's. No JAX program runs: JAX's importers are
numpy.

Random torch ``state_dict``s in the reference's naming (torchvision
ResNet, timm MobileNetV3 and ConvNeXt(-V2), the official MiT, smp's
UNet++, Unet, DeepLabV3+, MAnet and Segformer) come from the torch
oracles of ``tests/test_models.py``, built on the meta device and filled
from a seeded generator.
"""

import numpy as np
import pytest
import torch

import mmr_tpu.models.pretrained as pj
import mmr_tpu_torch.models.pretrained as pt
from mmr_tpu_torch.models import create_model
from mmr_tpu_torch.models.convert import from_jax_variables, to_jax_variables
from mmr_tpu_torch.models.weight_manifest import (build_manifest, load_manifest,
                                                  verify_store)
from tests import test_models as oracles
from tests.test_torch_train_modules import few_torch_threads  # noqa: F401
from tests.test_torch_train_step import _pairs

NC = 10


def _random_sd(make, seed=0):
    """The state_dict names and shapes of ``make()`` (built on the meta
    device) with seeded normal values."""
    with torch.device("meta"):
        names = make().state_dict()
    g = torch.Generator().manual_seed(seed)
    return {k: torch.randn(v.shape, generator=g) for k, v in names.items()}


def _mbv3_sd():
    """timm ``mobilenetv3_small_100`` names (``blocks.{s}.{b}``,
    ``blocks.5.0.conv`` / ``bn1``) from the port's encoder tree, as
    ``tests/test_models.py::test_mobilenetv3_import_structure`` builds them."""
    from mmr_tpu_torch.models.encoders import get_encoder

    with torch.device("meta"):
        sd = get_encoder("tu-mobilenetv3_small_100").build().state_dict()
    g = torch.Generator().manual_seed(1)
    out = {}
    for name, v in sd.items():
        parts = name.split(".")
        if parts[0].startswith("b5_0_"):
            parts = ["blocks", "5", "0", parts[0][len("b5_0_"):]] + parts[1:]
        elif parts[0][0] == "b" and parts[0][1].isdigit():
            stage, blk = parts[0][1:].split("_")
            parts = ["blocks", stage, blk] + parts[1:]
        out[".".join(parts)] = torch.randn(v.shape, generator=g)
    return out


class _SmpUnet(torch.nn.Module):
    """smp ``Unet`` names over the timm ConvNeXt-V2 oracle: ``encoder.*``,
    ``decoder.blocks.{i}.conv{1,2}.{0,1}``, ``segmentation_head.0``."""

    def __init__(self, dec=(256, 128, 64, 32, 16)):
        super().__init__()
        self.encoder = oracles._TorchConvNeXtEncoder(use_grn=True)
        skips, cin = [384, 192, 96, 0, 0], 768
        self.decoder = torch.nn.Module()
        blocks = []
        for i, co in enumerate(dec):
            blocks.append(oracles._TorchSmpDecoderBlock(cin, skips[i], co))
            cin = co
        self.decoder.blocks = torch.nn.ModuleList(blocks)
        self.segmentation_head = torch.nn.Sequential(
            torch.nn.Conv2d(dec[-1], NC, 3, 1, 1))


ENCODERS = {
    "resnet18": lambda: _random_sd(oracles._TorchResNet18Encoder),
    "tu-mobilenetv3_small_100": _mbv3_sd,
    "mit_b0": lambda: _random_sd(oracles._TorchMiTEncoder),
    "mit_b2": lambda: _random_sd(lambda: oracles._TorchMiTEncoder(
        (64, 128, 320, 512), (3, 4, 6, 3))),
    "tu-convnext_tiny": lambda: _random_sd(
        lambda: oracles._TorchConvNeXtEncoder(use_grn=False)),
    "tu-convnextv2_tiny": lambda: _random_sd(
        lambda: oracles._TorchConvNeXtEncoder(use_grn=True)),
}


def _assert_trees_equal(got, want):
    pairs = list(_pairs(got, want))
    assert len(pairs) == len(list(_pairs(want, want)))
    assert set(got) == set(want)
    for n, a, b in pairs:
        assert a.shape == b.shape and a.dtype == np.asarray(b).dtype, n
        np.testing.assert_array_equal(a, b, err_msg=n)


def _load_meta(model_fn, sd):
    """``sd`` loads strictly (names and shapes) into the port's model."""
    with torch.device("meta"):
        model = model_fn()
    model.load_state_dict(sd, strict=True, assign=True)


@pytest.mark.parametrize("enc", sorted(ENCODERS))
def test_encoder_importer_matches_jax(enc):
    """``import_torch_state_dict``: the port's trees equal JAX's leaf for
    leaf, bit for bit, and load strictly into the port's encoder."""
    from mmr_tpu_torch.models.encoders import get_encoder

    sd = ENCODERS[enc]()
    params, stats = pt.import_torch_state_dict(sd, enc)
    want_p, want_s = pj.import_torch_state_dict(sd, enc)
    _assert_trees_equal(params, want_p)
    _assert_trees_equal(stats, want_s)
    _load_meta(get_encoder(enc).build, from_jax_variables(
        {"params": params, "batch_stats": stats}))


SMP = {
    "unetpp": ("UnetPlusPlus", "resnet18", lambda: oracles._TorchSmpUnetPP(NC)),
    "unet": ("Unet", "tu-convnextv2_tiny", _SmpUnet),
    "deeplabv3plus": ("DeepLabV3Plus", "resnet18",
                      lambda: oracles._TorchSmpDeepLabV3Plus(NC)),
    "manet": ("MAnet", "resnet18", lambda: oracles._TorchSmpMAnet(NC)),
    "segformer": ("Segformer", "mit_b0", lambda: oracles._TorchSmpSegformer(NC)),
}


@pytest.mark.parametrize("kind", sorted(SMP))
def test_smp_importer_matches_jax(kind):
    """``import_smp_<kind>_state_dict`` on a whole smp model: the port's
    ``state_dict`` equals ``from_jax_variables`` of JAX's trees exactly
    and loads strictly into the port's model of that arch and encoder."""
    arch, enc, make = SMP[kind]
    sd = _random_sd(make, seed=2)
    got = getattr(pt, f"import_smp_{kind}_state_dict")(sd, enc)
    params, stats = getattr(pj, f"import_smp_{kind}_state_dict")(sd, enc)
    want = from_jax_variables({"params": params, "batch_stats": stats})
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    _load_meta(lambda: create_model(arch, encoder_name=enc, classes=NC,
                                    device="meta"), got)


def test_manifest_matches_committed_json():
    """``build_manifest`` from the port's encoders (meta device) equals the
    committed ``weights_manifest.json``, which JAX's writes, for every
    encoder in it: leaf paths, shapes, dtypes and parameter counts."""
    committed = load_manifest()
    assert sorted(committed["encoders"]) == sorted([*ENCODERS, "resnet34"])
    for enc, entry in committed["encoders"].items():
        assert build_manifest(enc) == entry, enc


def _store_of(model, seed):
    """A random store-shaped tree of ``model.encoder`` (flax layout)."""
    tree = to_jax_variables(model.encoder.state_dict(), model.encoder)
    rng = np.random.RandomState(seed)
    fill = lambda t: {k: fill(v) if isinstance(v, dict) else
                      rng.uniform(0.01, 0.2, v.shape).astype(np.float32)
                      for k, v in t.items()}
    return fill(tree["params"]), fill(tree["batch_stats"])


@pytest.mark.parametrize("arch,enc", [("UnetPlusPlus", "tu-mobilenetv3_small_100"),
                                      ("Segformer", "mit_b0")])
def test_weight_store_round_trip(tmp_path, monkeypatch, arch, enc):
    """``save_weight_store`` under ``$MMR_TPU_WEIGHTS_DIR``, then
    ``create_model(encoder_weights="imagenet")``: the encoder's weights and
    BN statistics come back bit-equal, the rest of the model is the random
    init of the same seed; the store verifies against the manifest, and
    JAX's loader reads the same store into the same tree."""
    monkeypatch.setenv("MMR_TPU_WEIGHTS_DIR", str(tmp_path))
    plain = create_model(arch, encoder_name=enc, classes=NC, device="cpu")
    params, stats = _store_of(plain, 3)
    path = pt.save_weight_store(enc, params, stats)
    assert path == tmp_path / f"{enc}.imagenet.npz"
    assert verify_store(enc, path)["n_leaves"] == len(
        list(_pairs(params, params))) + len(list(_pairs(stats, stats)))
    model = create_model(arch, encoder_name=enc, classes=NC, device="cpu",
                         encoder_weights="imagenet")
    back = to_jax_variables(model.encoder.state_dict(), model.encoder)
    _assert_trees_equal(back["params"], params)
    if stats:
        _assert_trees_equal(back["batch_stats"], stats)
    head = {k: v for k, v in model.state_dict().items()
            if not k.startswith("encoder.")}
    for k, v in head.items():
        assert torch.equal(v, plain.state_dict()[k]), k
    jax_vars = pj.load_encoder_weights(
        {c: {"encoder": t} for c, t in to_jax_variables(
            plain.encoder.state_dict()).items() if t}, enc, "imagenet")
    _assert_trees_equal(jax_vars["params"]["encoder"], back["params"])


def test_checkpoint_source_and_missing_store(tmp_path, monkeypatch, caplog):
    """A ``.pth`` of the bare encoder (official MiT names) loads through
    ``import_torch_state_dict`` as JAX's would; a missing store warns and
    keeps the random init, as JAX's ``init_hook``."""
    monkeypatch.setenv("MMR_TPU_WEIGHTS_DIR", str(tmp_path))
    sd = ENCODERS["mit_b0"]()
    torch.save(sd, tmp_path / "mit_b0.pth")
    model = create_model("Segformer", encoder_name="mit_b0", classes=NC,
                         device="cpu")
    pt.load_encoder_weights(model, "mit_b0", str(tmp_path / "mit_b0.pth"))
    params, _ = pj.import_torch_state_dict(sd, "mit_b0")
    _assert_trees_equal(to_jax_variables(model.encoder.state_dict())["params"],
                        params)
    plain = create_model("Segformer", encoder_name="mit_b0", classes=NC,
                         device="cpu")
    with caplog.at_level("WARNING"):
        missing = create_model("Segformer", encoder_name="mit_b0", classes=NC,
                               device="cpu", encoder_weights="imagenet")
    assert "not found locally" in caplog.text
    for k, v in missing.state_dict().items():
        assert torch.equal(v, plain.state_dict()[k]), k


def test_wrong_store_raises(tmp_path, monkeypatch):
    """A store whose leaf has another shape, or that names a leaf the
    encoder lacks, is refused with the leaf named (``_graft``), and
    ``verify_store`` refuses it too."""
    monkeypatch.setenv("MMR_TPU_WEIGHTS_DIR", str(tmp_path))
    model = create_model("Segformer", encoder_name="mit_b0", classes=NC,
                         device="cpu")
    params, stats = _store_of(model, 4)
    params["patch_embed1"]["kernel"] = params["patch_embed1"]["kernel"][:, :, :, :8]
    path = pt.save_weight_store("mit_b0", params, stats)
    with pytest.raises(ValueError, match="shape mismatch at params/patch_embed1/kernel"):
        pt.load_encoder_weights(model, "mit_b0", "imagenet")
    with pytest.raises(ValueError, match="shape mismatch"):
        verify_store("mit_b0", path)
    params, stats = _store_of(model, 4)
    params["extra"] = {"kernel": np.zeros((3,), np.float32)}
    pt.save_weight_store("mit_b0", params, stats, tag="extra")
    with pytest.raises(KeyError, match="extra"):
        pt.load_encoder_weights(model, "mit_b0", "extra")
