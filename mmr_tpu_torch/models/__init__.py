from mmr_tpu_torch.models.factory import create_model, get_preprocessing

__all__ = ["create_model", "get_preprocessing"]
