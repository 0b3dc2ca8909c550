from mmr_tpu_torch.monitor.monitor import (ProfilerTrace, TrainingMonitor,
                                          device_memory_stats, get_logger,
                                          model_summary)
from mmr_tpu_torch.monitor.plots import (save_accuracy_curves, save_dashboard,
                                        save_losses, save_triptychs)

__all__ = ["get_logger", "TrainingMonitor", "ProfilerTrace", "model_summary",
           "device_memory_stats", "save_losses", "save_accuracy_curves",
           "save_dashboard", "save_triptychs"]
