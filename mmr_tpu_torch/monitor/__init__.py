from mmr_tpu_torch.monitor.monitor import get_logger
from mmr_tpu_torch.monitor.plots import save_accuracy_curves, save_losses, save_triptychs

__all__ = ["get_logger", "save_losses", "save_accuracy_curves", "save_triptychs"]
