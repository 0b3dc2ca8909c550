"""``mmr_torch_create_dataset`` — Path B's converter CLI (counterpart of
``mmr_tpu/cli/create_dataset.py``; ``Data_Loader.py:629-695``):
``mmr_torch_create_dataset <zip|dir> <out> <n_classes> "[H,W]"``.

Motion-JPEG AVI and PNG masks → per-video Zarr stores on the host; no
card is used.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="SAR-RARP50 ZIP → Zarr dataset (PyTorch port)")
    parser.add_argument("zip_path", type=str,
                        help="challenge ZIP (nested per-video zips) or a "
                             "directory of video folders")
    parser.add_argument("out_path", type=str)
    parser.add_argument("n_classes", type=int)
    parser.add_argument("patch_size", type=str, help='e.g. "[512,640]"')
    parser.add_argument("--n_videos", type=int, default=None,
                        help="convert only the first N videos (mini-dataset "
                             "workflow, Mini_Dataset_ZarrFile.ipynb)")
    parser.add_argument("--image_dtype", type=str, default="float32",
                        choices=["float32", "uint8"],
                        help="uint8: compact store (lossless for 8-bit video"
                             " sources, 4x less decode/transfer)")
    parser.add_argument("--write_split", action="store_true",
                        help="write a hand-made train/val split JSON over "
                             "the converted videos (mini-dataset workflow)")
    args = parser.parse_args(argv)

    import numpy as np

    from mmr_tpu_torch.config.config import safe_eval
    from mmr_tpu_torch.data.convert import convert_zip_dataset

    out = convert_zip_dataset(args.zip_path, args.out_path, args.n_classes,
                              safe_eval(args.patch_size), n_videos=args.n_videos,
                              write_split=args.write_split,
                              image_dtype=np.dtype(args.image_dtype))
    print(f"Dataset written to {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
