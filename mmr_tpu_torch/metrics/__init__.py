from mmr_tpu_torch.metrics.confusion import segmentation_stats
from mmr_tpu_torch.metrics.iou import iou_score

__all__ = ["segmentation_stats", "iou_score"]
