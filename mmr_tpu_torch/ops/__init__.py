from mmr_tpu_torch.ops.onehot import ids_to_rgb, one_hot, rgb_to_ids
from mmr_tpu_torch.ops.padcrop import center_pad_bbox_crop, pad_to
from mmr_tpu_torch.ops.resize import resize, resize_bilinear, resize_nearest

__all__ = ["resize_bilinear", "resize_nearest", "resize", "one_hot", "rgb_to_ids",
           "ids_to_rgb", "pad_to", "center_pad_bbox_crop"]
