from mmr_tpu_torch.metrics.confusion import segmentation_stats
from mmr_tpu_torch.metrics.dice import binary_dice
from mmr_tpu_torch.metrics.evaluate import Evaluate
from mmr_tpu_torch.metrics.hausdorff import capped_hausdorff, hausdorff_distance
from mmr_tpu_torch.metrics.iou import f1_score, iou_score, precision, recall

__all__ = ["segmentation_stats", "iou_score", "f1_score", "precision", "recall",
           "Evaluate", "binary_dice", "capped_hausdorff", "hausdorff_distance"]
