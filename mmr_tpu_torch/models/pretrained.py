"""Pretrained weights: torch checkpoints and the offline weight store
(counterpart of ``mmr_tpu/models/pretrained.py``).

The reference takes ImageNet encoders from torchvision / timm at run time
(smp ``encoder_weights='imagenet'``). Without network access the weights
come from an offline store, as in JAX:

1. :func:`import_torch_state_dict` renames a torch ``state_dict``
   (torchvision resnet18/34, timm mobilenetv3_small_100, the official
   MiT / smp ``mit_b*``, timm convnext(v2)) into the JAX encoder's
   ``(params, batch_stats)`` trees (numpy, flax layout), with its own copy
   of JAX's name tables; the ``import_smp_*_state_dict`` importers rename
   a whole smp model (UNet++, Unet, DeepLabV3+, MAnet, Segformer) and
   return the port's ``state_dict`` (``from_jax_variables`` of that tree).
2. :func:`save_weight_store` / :func:`load_weight_store` keep an encoder's
   trees as ``<encoder>.<tag>.npz`` under ``$MMR_TPU_WEIGHTS_DIR`` (default
   ``~/.cache/mmr_tpu/weights``), JAX's layout: one converted store serves
   both packages. :func:`load_encoder_weights` grafts a store (or a
   ``.pth`` / ``.pt`` / ``.bin`` checkpoint of the bare encoder) onto a
   model's encoder, every leaf's shape checked.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Any, Mapping

import numpy as np
import torch

from mmr_tpu_torch.models.convert import from_jax_variables, to_jax_variables


def _np(t) -> np.ndarray:
    try:  # torch tensor
        return t.detach().cpu().numpy()
    except AttributeError:
        return np.asarray(t)


def _conv(w) -> np.ndarray:
    """torch conv (O, I, H, W) → flax (H, W, I, O)."""
    return _np(w).transpose(2, 3, 1, 0)


def _dwconv(w) -> np.ndarray:
    """torch depthwise conv (O, 1, H, W), groups=O → flax (H, W, 1, O)."""
    return _np(w).transpose(2, 3, 1, 0)


def _bn(sd: Mapping[str, Any], prefix: str) -> tuple[dict, dict]:
    params = {"scale": _np(sd[f"{prefix}.weight"]), "bias": _np(sd[f"{prefix}.bias"])}
    stats = {"mean": _np(sd[f"{prefix}.running_mean"]), "var": _np(sd[f"{prefix}.running_var"])}
    return params, stats


def _resnet_tree(sd: Mapping[str, Any], stage_sizes) -> tuple[dict, dict]:
    params: dict = {"conv1": {"kernel": _conv(sd["conv1.weight"])}}
    stats: dict = {}
    params["bn1"], stats["bn1"] = _bn(sd, "bn1")
    for i, n_blocks in enumerate(stage_sizes):
        for b in range(n_blocks):
            t = f"layer{i + 1}.{b}"
            name = f"layer{i + 1}_{b}"
            p: dict = {
                "conv1": {"kernel": _conv(sd[f"{t}.conv1.weight"])},
                "conv2": {"kernel": _conv(sd[f"{t}.conv2.weight"])},
            }
            s: dict = {}
            p["bn1"], s["bn1"] = _bn(sd, f"{t}.bn1")
            p["bn2"], s["bn2"] = _bn(sd, f"{t}.bn2")
            if f"{t}.downsample.0.weight" in sd:
                p["downsample_conv"] = {"kernel": _conv(sd[f"{t}.downsample.0.weight"])}
                p["downsample_bn"], s["downsample_bn"] = _bn(sd, f"{t}.downsample.1")
            params[name] = p
            stats[name] = s
    return params, stats


def _mbv3_block(sd: Mapping[str, Any], t: str, kind: str) -> tuple[dict, dict]:
    """kind: 'ds' (DepthwiseSeparable) or 'ir' (InvertedResidual)."""
    p: dict = {}
    s: dict = {}
    if kind == "ds":
        p["conv_dw"] = {"kernel": _dwconv(sd[f"{t}.conv_dw.weight"])}
        p["bn1"], s["bn1"] = _bn(sd, f"{t}.bn1")
        p["conv_pw"] = {"kernel": _conv(sd[f"{t}.conv_pw.weight"])}
        p["bn2"], s["bn2"] = _bn(sd, f"{t}.bn2")
    else:
        has_pw = f"{t}.conv_pw.weight" in sd
        if has_pw:
            p["conv_pw"] = {"kernel": _conv(sd[f"{t}.conv_pw.weight"])}
            p["bn1"], s["bn1"] = _bn(sd, f"{t}.bn1")
        p["conv_dw"] = {"kernel": _dwconv(sd[f"{t}.conv_dw.weight"])}
        p["bn2"], s["bn2"] = _bn(sd, f"{t}.bn2")
        p["conv_pwl"] = {"kernel": _conv(sd[f"{t}.conv_pwl.weight"])}
        p["bn3"], s["bn3"] = _bn(sd, f"{t}.bn3")
    if f"{t}.se.conv_reduce.weight" in sd:
        p["se"] = {
            "conv_reduce": {"kernel": _conv(sd[f"{t}.se.conv_reduce.weight"]),
                            "bias": _np(sd[f"{t}.se.conv_reduce.bias"])},
            "conv_expand": {"kernel": _conv(sd[f"{t}.se.conv_expand.weight"]),
                            "bias": _np(sd[f"{t}.se.conv_expand.bias"])},
        }
    return p, s


_MBV3_LAYOUT = [  # (timm blocks index, per-stage block kinds, our name prefix)
    (0, ["ds"], "b0"),
    (1, ["ir", "ir"], "b1"),
    (2, ["ir", "ir", "ir"], "b2"),
    (3, ["ir", "ir"], "b3"),
    (4, ["ir", "ir", "ir"], "b4"),
]


def _mobilenetv3_tree(sd: Mapping[str, Any]) -> tuple[dict, dict]:
    params: dict = {"conv_stem": {"kernel": _conv(sd["conv_stem.weight"])}}
    stats: dict = {}
    params["bn1"], stats["bn1"] = _bn(sd, "bn1")
    for idx, kinds, prefix in _MBV3_LAYOUT:
        for b, kind in enumerate(kinds):
            p, s = _mbv3_block(sd, f"blocks.{idx}.{b}", kind)
            params[f"{prefix}_{b}"] = p
            stats[f"{prefix}_{b}"] = s
    # timm blocks[5]: ConvBnAct 96->576 (the stride-32 feature's 1x1 head)
    params["b5_0_conv"] = {"kernel": _conv(sd["blocks.5.0.conv.weight"])}
    params["b5_0_bn1"], stats["b5_0_bn1"] = _bn(sd, "blocks.5.0.bn1")
    return params, stats


def import_torch_state_dict(sd: Mapping[str, Any], encoder_name: str) -> tuple[dict, dict]:
    """→ (params, batch_stats) trees matching our encoder module names."""
    name = encoder_name.replace("tu-", "")
    if name in ("resnet18",):
        return _resnet_tree(sd, (2, 2, 2, 2))
    if name in ("resnet34",):
        return _resnet_tree(sd, (3, 4, 6, 3))
    if name.startswith("mobilenetv3_small"):
        return _mobilenetv3_tree(sd)
    if name.startswith("mit_b"):
        depths = {"mit_b0": (2, 2, 2, 2), "mit_b2": (3, 4, 6, 3)}[name]
        return _mit_tree(sd, depths)
    if name.startswith("convnext"):
        return _convnext_tree(sd, (3, 3, 9, 3),
                              use_grn="v2" in name)
    raise ValueError(f"no torch import mapping for encoder {encoder_name!r}")


# ---------------------------------------------------------------- weight store

def weights_dir() -> Path:
    return Path(os.environ.get("MMR_TPU_WEIGHTS_DIR",
                               Path.home() / ".cache" / "mmr_tpu" / "weights"))


def _flatten(tree: dict, prefix="") -> dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flatten(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def _unflatten(flat: Mapping[str, np.ndarray]) -> dict:
    tree: dict = {}
    for key, v in flat.items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def save_weight_store(encoder_name: str, params: dict, batch_stats: dict,
                      tag: str = "imagenet") -> Path:
    d = weights_dir()
    d.mkdir(parents=True, exist_ok=True)
    path = d / f"{encoder_name}.{tag}.npz"
    flat = {f"params/{k}": v for k, v in _flatten(params).items()}
    flat.update({f"batch_stats/{k}": v for k, v in _flatten(batch_stats).items()})
    np.savez(path, **flat)
    return path


def load_weight_store(encoder_name: str, tag: str = "imagenet") -> tuple[dict, dict]:
    path = weights_dir() / f"{encoder_name}.{tag}.npz"
    if not path.exists():
        raise FileNotFoundError(str(path))
    flat = dict(np.load(path))
    params = _unflatten({k[len("params/"):]: v for k, v in flat.items() if k.startswith("params/")})
    stats = _unflatten({k[len("batch_stats/"):]: v for k, v in flat.items() if k.startswith("batch_stats/")})
    return params, stats


def _graft(dst: dict, src: dict, path=""):
    """Copy src leaves into dst (must exist with same shapes)."""
    for k, v in src.items():
        if k not in dst:
            raise KeyError(f"imported weight {path}/{k} has no destination in model")
        if isinstance(v, dict):
            _graft(dst[k], v, f"{path}/{k}")
        else:
            if tuple(dst[k].shape) != tuple(np.shape(v)):
                raise ValueError(
                    f"shape mismatch at {path}/{k}: model {tuple(dst[k].shape)} "
                    f"vs import {tuple(np.shape(v))}")
            dst[k] = np.asarray(v, dtype=np.float32)


def load_encoder_weights(model: torch.nn.Module, encoder_name: str | None,
                         source: str) -> torch.nn.Module:
    """Load stored pretrained weights into ``model.encoder`` in place and
    return ``model``. ``source``: a tag in the weight store (e.g.
    ``'imagenet'``) or a path to a torch ``.pth`` / ``.pt`` / ``.bin``
    checkpoint of the bare encoder. Raises ``FileNotFoundError`` when the
    model has no generic encoder or the weights are not on disk, and
    ``KeyError`` / ``ValueError`` (from :func:`_graft`) when they do not
    fit the encoder."""
    if encoder_name is None or getattr(model, "encoder", None) is None:
        raise FileNotFoundError("model has no generic encoder to load into")
    if source.endswith((".pth", ".pt", ".bin")):
        sd = torch.load(source, map_location="cpu", weights_only=True)
        if isinstance(sd, dict) and "state_dict" in sd:
            sd = sd["state_dict"]
        params, stats = import_torch_state_dict(sd, encoder_name)
    else:
        params, stats = load_weight_store(encoder_name, source)
    enc = model.encoder
    tree = to_jax_variables(enc.state_dict(), enc)
    _graft(tree["params"], params, "params")
    if stats:
        _graft(tree["batch_stats"], stats, "batch_stats")
    enc.load_state_dict(from_jax_variables(tree, enc))
    return model


def _state_dict(params: dict, stats: dict) -> dict[str, torch.Tensor]:
    return from_jax_variables({"params": params, "batch_stats": stats})


# ------------------------------------------------- full smp UNet++ importer

def import_smp_unetpp_state_dict(sd: Mapping[str, Any], encoder_name: str
                                 ) -> dict[str, torch.Tensor]:
    """Convert a *complete* smp ``UnetPlusPlus`` state dict (encoder +
    decoder + segmentation head; the reference's ``best_model.pth`` contents,
    ``Main_MMR_SegModel.py:919-956``) into our
    :class:`~mmr_tpu_torch.models.decoders.UnetPlusPlusModel` state_dict.

    smp naming: ``encoder.[model.]...`` (timm encoders sit under ``.model``),
    ``decoder.blocks.x_{d}_{l}.conv{1,2}.{0,1}.*`` (Conv2dReLU =
    Sequential[conv, bn, relu]) and ``segmentation_head.0.{weight,bias}``.
    """
    enc_sd = {k[len("encoder."):]: v for k, v in sd.items()
              if k.startswith("encoder.")}
    if any(k.startswith("model.") for k in enc_sd):
        enc_sd = {k[len("model."):]: v for k, v in enc_sd.items()
                  if k.startswith("model.")}
    enc_params, enc_stats = import_torch_state_dict(enc_sd, encoder_name)
    params: dict = {"encoder": enc_params}
    stats: dict = {"encoder": enc_stats}

    node_names = sorted({k.split(".")[2] for k in sd
                         if k.startswith("decoder.blocks.")})
    for node in node_names:
        p_node: dict = {}
        s_node: dict = {}
        for conv in ("conv1", "conv2"):
            base = f"decoder.blocks.{node}.{conv}"
            p_node[conv] = {
                "conv": {"kernel": _conv(sd[f"{base}.0.weight"])}}
            bn_p, bn_s = _bn(sd, f"{base}.1")
            p_node[conv]["bn"] = bn_p
            s_node[conv] = {"bn": bn_s}
        params[node] = p_node
        stats[node] = s_node

    params["head"] = {"conv": {
        "kernel": _conv(sd["segmentation_head.0.weight"]),
        "bias": _np(sd["segmentation_head.0.bias"]),
    }}
    return _state_dict(params, stats)


def import_smp_unet_state_dict(sd: Mapping[str, Any], encoder_name: str
                               ) -> dict[str, torch.Tensor]:
    """Convert a complete smp ``Unet`` state dict into our
    :class:`~mmr_tpu_torch.models.decoders.UnetDecoderModel` state_dict
    (PKG-INFO Example 3's architecture: ``Unet + tu-convnextv2_tiny``).

    smp naming: ``encoder.[model.]...``, ``decoder.blocks.{i}.conv{1,2}.
    {0,1}.*`` (Conv2dReLU = Sequential[conv, bn, relu]) and
    ``segmentation_head.0.{weight,bias}`` — the same Conv2dReLU layout the
    proven UNet++ importer maps (``import_smp_unetpp_state_dict``)."""
    enc_sd = {k[len("encoder."):]: v for k, v in sd.items()
              if k.startswith("encoder.")}
    if any(k.startswith("model.") for k in enc_sd):
        enc_sd = {k[len("model."):]: v for k, v in enc_sd.items()
                  if k.startswith("model.")}
    enc_params, enc_stats = import_torch_state_dict(enc_sd, encoder_name)
    params: dict = {"encoder": enc_params}
    stats: dict = {"encoder": enc_stats}

    idxs = sorted({int(k.split(".")[2]) for k in sd
                   if k.startswith("decoder.blocks.")})
    for i in idxs:
        p_node: dict = {}
        s_node: dict = {}
        for conv in ("conv1", "conv2"):
            base = f"decoder.blocks.{i}.{conv}"
            p_node[conv] = {"conv": {"kernel": _conv(sd[f"{base}.0.weight"])}}
            bn_p, bn_s = _bn(sd, f"{base}.1")
            p_node[conv]["bn"] = bn_p
            s_node[conv] = {"bn": bn_s}
        params[f"block{i}"] = p_node
        stats[f"block{i}"] = s_node

    params["head"] = {"conv": {
        "kernel": _conv(sd["segmentation_head.0.weight"]),
        "bias": _np(sd["segmentation_head.0.bias"]),
    }}
    return _state_dict(params, stats)


def _ln(sd: Mapping[str, Any], prefix: str) -> dict:
    return {"scale": _np(sd[f"{prefix}.weight"]).reshape(-1),
            "bias": _np(sd[f"{prefix}.bias"]).reshape(-1)}


def _dense(sd: Mapping[str, Any], prefix: str) -> dict:
    """torch Linear (O, I) -> flax Dense kernel (I, O)."""
    out = {"kernel": _np(sd[f"{prefix}.weight"]).T}
    if f"{prefix}.bias" in sd:
        out["bias"] = _np(sd[f"{prefix}.bias"])
    return out


def _mit_tree(sd: Mapping[str, Any], depths) -> tuple[dict, dict]:
    """Official Segformer / smp ``mit_b*`` naming -> our
    MixVisionTransformerEncoder tree. The fused ``attn.kv`` Linear splits
    into our separate k/v Dense layers."""
    params: dict = {}
    for i in range(4):
        st = i + 1
        params[f"patch_embed{st}"] = {
            "kernel": _conv(sd[f"patch_embed{st}.proj.weight"]),
            "bias": _np(sd[f"patch_embed{st}.proj.bias"])}
        params[f"patch_norm{st}"] = _ln(sd, f"patch_embed{st}.norm")
        for b in range(depths[i]):
            t = f"block{st}.{b}"
            kv_w = _np(sd[f"{t}.attn.kv.weight"])  # (2*dim, dim)
            kv_b = _np(sd[f"{t}.attn.kv.bias"])
            dim = kv_w.shape[1]
            attn = {
                "q": _dense(sd, f"{t}.attn.q"),
                "k": {"kernel": kv_w[:dim].T, "bias": kv_b[:dim]},
                "v": {"kernel": kv_w[dim:].T, "bias": kv_b[dim:]},
                "proj": _dense(sd, f"{t}.attn.proj"),
            }
            if f"{t}.attn.sr.weight" in sd:
                attn["sr"] = {"kernel": _conv(sd[f"{t}.attn.sr.weight"]),
                              "bias": _np(sd[f"{t}.attn.sr.bias"])}
                attn["sr_norm"] = _ln(sd, f"{t}.attn.norm")
            params[f"stage{st}_block{b}"] = {
                "norm1": _ln(sd, f"{t}.norm1"),
                "norm2": _ln(sd, f"{t}.norm2"),
                "attn": attn,
                "mlp": {
                    "fc1": _dense(sd, f"{t}.mlp.fc1"),
                    "dwconv": {"kernel": _dwconv(sd[f"{t}.mlp.dwconv.dwconv.weight"]),
                               "bias": _np(sd[f"{t}.mlp.dwconv.dwconv.bias"])},
                    "fc2": _dense(sd, f"{t}.mlp.fc2"),
                },
            }
        params[f"norm{st}"] = _ln(sd, f"norm{st}")
    return params, {}


def _convnext_tree(sd: Mapping[str, Any], depths, use_grn: bool) -> tuple[dict, dict]:
    """timm ``convnext(v2)_*`` naming -> our ConvNeXtEncoder tree."""
    params: dict = {
        "stem_conv": {"kernel": _conv(sd["stem.0.weight"]),
                      "bias": _np(sd["stem.0.bias"])},
        "stem_norm": _ln(sd, "stem.1"),
    }
    for i in range(4):
        if i > 0:
            params[f"downsample_norm{i}"] = _ln(sd, f"stages.{i}.downsample.0")
            params[f"downsample_conv{i}"] = {
                "kernel": _conv(sd[f"stages.{i}.downsample.1.weight"]),
                "bias": _np(sd[f"stages.{i}.downsample.1.bias"])}
        for b in range(depths[i]):
            t = f"stages.{i}.blocks.{b}"
            blk = {
                "dwconv": {"kernel": _dwconv(sd[f"{t}.conv_dw.weight"]),
                           "bias": _np(sd[f"{t}.conv_dw.bias"])},
                "norm": _ln(sd, f"{t}.norm"),
                "pwconv1": _dense(sd, f"{t}.mlp.fc1"),
                "pwconv2": _dense(sd, f"{t}.mlp.fc2"),
            }
            if use_grn:
                blk["grn"] = {"gamma": _np(sd[f"{t}.mlp.grn.weight"]).reshape(-1),
                              "beta": _np(sd[f"{t}.mlp.grn.bias"]).reshape(-1)}
            else:
                blk["gamma"] = _np(sd[f"{t}.gamma"]).reshape(-1)
            params[f"stage{i}_block{b}"] = blk
    return params, {}


# ------------------------------------- full smp DeepLabV3+ / MAnet importers

def _split_encoder(sd: Mapping[str, Any]) -> dict:
    enc_sd = {k[len("encoder."):]: v for k, v in sd.items()
              if k.startswith("encoder.")}
    if any(k.startswith("model.") for k in enc_sd):
        enc_sd = {k[len("model."):]: v for k, v in enc_sd.items()
                  if k.startswith("model.")}
    return enc_sd


def _sep(sd: Mapping[str, Any], base: str) -> tuple[dict, dict]:
    """smp SeparableConv2d+BN: ``{base}.0.0`` depthwise, ``{base}.0.1``
    pointwise, ``{base}.1`` BN → our SeparableConvBNReLU {dw, pw, bn}."""
    bn_p, bn_s = _bn(sd, f"{base}.1")
    return ({"dw": {"kernel": _dwconv(sd[f"{base}.0.0.weight"])},
             "pw": {"kernel": _conv(sd[f"{base}.0.1.weight"])},
             "bn": bn_p},
            {"bn": bn_s})


def import_smp_deeplabv3plus_state_dict(sd: Mapping[str, Any],
                                        encoder_name: str = "resnet18"
                                        ) -> dict[str, torch.Tensor]:
    """Convert a complete ``smp.DeepLabV3Plus`` state dict (the reference's
    ``smp_DeepLabV3+`` zoo entry, ``ModelTraining.py:263-269``) into our
    :class:`~mmr_tpu_torch.models.decoders.DeepLabV3PlusModel` state_dict.

    smp naming: ``decoder.aspp.0`` = ASPP (convs.0 1×1+BN, convs.1-3
    ASPPSeparableConv, convs.4 ASPPPooling, project), ``decoder.aspp.1/.2`` =
    post SeparableConv2d+BN, ``decoder.block1/block2``, and
    ``segmentation_head.0`` (1×1 conv, bias).
    """
    enc_params, enc_stats = import_torch_state_dict(_split_encoder(sd),
                                                    encoder_name)
    params: dict = {"encoder": enc_params}
    stats: dict = {"encoder": enc_stats}

    aspp_p: dict = {"c0_conv": {"kernel": _conv(sd["decoder.aspp.0.convs.0.0.weight"])}}
    aspp_s: dict = {}
    aspp_p["c0_bn"], aspp_s["c0_bn"] = _bn(sd, "decoder.aspp.0.convs.0.1")
    for i in (1, 2, 3):
        aspp_p[f"c{i}"], aspp_s[f"c{i}"] = _sep(sd, f"decoder.aspp.0.convs.{i}")
    aspp_p["pool_conv"] = {"kernel": _conv(sd["decoder.aspp.0.convs.4.1.weight"])}
    aspp_p["pool_bn"], aspp_s["pool_bn"] = _bn(sd, "decoder.aspp.0.convs.4.2")
    aspp_p["proj_conv"] = {"kernel": _conv(sd["decoder.aspp.0.project.0.weight"])}
    aspp_p["proj_bn"], aspp_s["proj_bn"] = _bn(sd, "decoder.aspp.0.project.1")
    params["aspp"], stats["aspp"] = aspp_p, aspp_s

    post_p = {"dw": {"kernel": _dwconv(sd["decoder.aspp.1.0.weight"])},
              "pw": {"kernel": _conv(sd["decoder.aspp.1.1.weight"])}}
    post_p["bn"], post_bn_s = _bn(sd, "decoder.aspp.2")
    params["post"], stats["post"] = post_p, {"bn": post_bn_s}

    params["block1_conv"] = {"kernel": _conv(sd["decoder.block1.0.weight"])}
    params["block1_bn"], stats["block1_bn"] = _bn(sd, "decoder.block1.1")
    params["block2"], stats["block2"] = _sep(sd, "decoder.block2")

    params["head_conv"] = {"kernel": _conv(sd["segmentation_head.0.weight"]),
                           "bias": _np(sd["segmentation_head.0.bias"])}
    return _state_dict(params, stats)


def import_smp_manet_state_dict(sd: Mapping[str, Any],
                                encoder_name: str = "resnet18"
                                ) -> dict[str, torch.Tensor]:
    """Convert a complete ``smp.MAnet`` state dict (the reference's
    ``smp_MANet`` zoo entry, ``ModelTraining.py:270-278``) into our
    :class:`~mmr_tpu_torch.models.decoders.MAnetModel` state_dict.

    smp naming: ``decoder.center`` = PAB (top/center/bottom/out convs),
    ``decoder.blocks.{i}`` = MFAB (hl_conv.{0,1} Conv2dReLU pairs, SE_hl/
    SE_ll Sequentials at indices 1/3, conv1/conv2) or a plain DecoderBlock
    (conv1/conv2 only) when the block has no skip, and
    ``segmentation_head.0`` (3×3 conv, bias).
    """
    enc_params, enc_stats = import_torch_state_dict(_split_encoder(sd),
                                                    encoder_name)
    params: dict = {"encoder": enc_params}
    stats: dict = {"encoder": enc_stats}

    c = "decoder.center"
    params["center"] = {
        name: {"kernel": _conv(sd[f"{c}.{name}.weight"]),
               "bias": _np(sd[f"{c}.{name}.bias"])}
        for name in ("top_conv", "center_conv", "bottom_conv", "out_conv")}

    idxs = sorted({int(k.split(".")[2]) for k in sd
                   if k.startswith("decoder.blocks.")})
    for i in idxs:
        base = f"decoder.blocks.{i}"
        p_node: dict = {}
        s_node: dict = {}
        if f"{base}.hl_conv.0.0.weight" in sd:  # MFAB
            for j, name in ((0, "hl_conv1"), (1, "hl_conv2")):
                p_node[name] = {"conv": {"kernel": _conv(sd[f"{base}.hl_conv.{j}.0.weight"])}}
                p_node[name]["bn"], bn_s = _bn(sd, f"{base}.hl_conv.{j}.1")
                s_node[name] = {"bn": bn_s}
            for se, ours in (("SE_hl", "se_hl"), ("SE_ll", "se_ll")):
                p_node[f"{ours}_reduce"] = {
                    "kernel": _conv(sd[f"{base}.{se}.1.weight"]),
                    "bias": _np(sd[f"{base}.{se}.1.bias"])}
                p_node[f"{ours}_expand"] = {
                    "kernel": _conv(sd[f"{base}.{se}.3.weight"]),
                    "bias": _np(sd[f"{base}.{se}.3.bias"])}
        for conv in ("conv1", "conv2"):
            p_node[conv] = {"conv": {"kernel": _conv(sd[f"{base}.{conv}.0.weight"])}}
            p_node[conv]["bn"], bn_s = _bn(sd, f"{base}.{conv}.1")
            s_node[conv] = {"bn": bn_s}
        params[f"block{i}"] = p_node
        stats[f"block{i}"] = s_node

    params["head"] = {"conv": {
        "kernel": _conv(sd["segmentation_head.0.weight"]),
        "bias": _np(sd["segmentation_head.0.bias"]),
    }}
    return _state_dict(params, stats)


def import_smp_segformer_state_dict(sd: Mapping[str, Any],
                                    encoder_name: str = "mit_b2"
                                    ) -> dict[str, torch.Tensor]:
    """Convert a complete ``smp.Segformer`` state dict (PKG-INFO Example 2's
    architecture: ``Segformer + mit_b2``) into our
    :class:`~mmr_tpu_torch.models.decoders.SegformerModel` state_dict.

    smp naming: ``decoder.mlp_stage.{i}.linear`` (i=0 is the DEEPEST level;
    ours are ``linear_c{4..1}`` shallowest-first), ``decoder.fuse_stage.0/.1``
    (Conv2dReLU), ``segmentation_head.0`` (3×3 conv + ×4 UpsamplingBilinear2d).
    """
    enc_params, enc_stats = import_torch_state_dict(_split_encoder(sd),
                                                    encoder_name)
    params: dict = {"encoder": enc_params}
    stats: dict = {"encoder": enc_stats}

    n_lvls = len({int(k.split(".")[2]) for k in sd
                  if k.startswith("decoder.mlp_stage.")})
    for i in range(n_lvls):  # mlp_stage.0 == deepest == our linear_c{n}
        params[f"linear_c{n_lvls - i}"] = _dense(sd, f"decoder.mlp_stage.{i}.linear")

    fuse_p = {"conv": {"kernel": _conv(sd["decoder.fuse_stage.0.weight"])}}
    fuse_p["bn"], fuse_bn_s = _bn(sd, "decoder.fuse_stage.1")
    params["fuse"], stats["fuse"] = fuse_p, {"bn": fuse_bn_s}

    params["head"] = {"conv": {
        "kernel": _conv(sd["segmentation_head.0.weight"]),
        "bias": _np(sd["segmentation_head.0.bias"]),
    }}
    return _state_dict(params, stats)
