"""``mmr_torch_export_weights`` — the offline pretrained-encoder converter
(counterpart of ``mmr_tpu/cli/export_weights.py``, ``mmr_export_weights``).

``--state_dict <checkpoint.pth>`` converts a torch state dict already on
disk through :func:`~mmr_tpu_torch.models.pretrained.import_torch_state_dict`,
writes the ``.npz`` store under ``$MMR_TPU_WEIGHTS_DIR``
(:func:`~mmr_tpu_torch.models.pretrained.save_weight_store`), checks it
leaf by leaf against the committed ``weights_manifest.json``
(:func:`~mmr_tpu_torch.models.weight_manifest.verify_store`) and prints
one JSON line: encoder, store, sha256, leaves. Without ``--state_dict`` it
asks timm for the ImageNet checkpoint, which needs timm and a network; where
timm is missing it says so and returns 2. The store is the one
``create_model(encoder_weights="imagenet")`` loads, in either package.

    mmr_torch_export_weights --encoder resnet18 --state_dict resnet18.pth
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="convert ImageNet encoder weights into the weight store "
                    "(a local --state_dict, or a timm download: needs network "
                    "+ timm)")
    parser.add_argument("--encoder", required=True,
                        help="registry name, e.g. tu-mobilenetv3_small_100")
    parser.add_argument("--timm_name", default=None,
                        help="override the timm model name (default: encoder "
                             "name minus any 'tu-' prefix)")
    parser.add_argument("--state_dict", default=None,
                        help="path to an already-downloaded torch state dict "
                             "(.pth) instead of a timm download (the only "
                             "option for mit_b*, whose official checkpoints "
                             "are not on timm's hub under these names)")
    parser.add_argument("--tag", default="imagenet")
    args = parser.parse_args(argv)

    import torch

    from mmr_tpu_torch.models.pretrained import (import_torch_state_dict,
                                                 save_weight_store)
    from mmr_tpu_torch.models.weight_manifest import sha256_file, verify_store

    if args.state_dict:
        sd = torch.load(args.state_dict, map_location="cpu", weights_only=True)
        if isinstance(sd, dict) and "state_dict" in sd:
            sd = sd["state_dict"]
    else:
        try:
            import timm
        except ImportError:
            print("timm is not installed — pip install timm, or pass "
                  "--state_dict <checkpoint.pth>", file=sys.stderr)
            return 2
        name = args.timm_name or args.encoder.removeprefix("tu-")
        sd = timm.create_model(name, pretrained=True).state_dict()

    params, stats = import_torch_state_dict(sd, args.encoder)
    path = save_weight_store(args.encoder, params, stats, tag=args.tag)
    try:
        report = verify_store(args.encoder, path)
    except (FileNotFoundError, KeyError):
        report = {"sha256": sha256_file(path),
                  "n_leaves": "unverified (encoder not in manifest)"}
    print(json.dumps({"encoder": args.encoder, "store": str(path), **report}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
