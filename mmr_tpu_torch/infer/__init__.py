from mmr_tpu_torch.infer.evaluator import evaluate_checkpoint, run_inference
from mmr_tpu_torch.infer.sliding_window import (make_sliding_window_fn,
                                                sliding_window_inference)

__all__ = ["sliding_window_inference", "make_sliding_window_fn", "run_inference",
           "evaluate_checkpoint"]
