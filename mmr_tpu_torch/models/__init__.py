from mmr_tpu_torch.models.decoders import (DeepLabV3PlusModel, MAnetModel,
                                           UnetDecoderModel, UnetPlusPlusModel)
from mmr_tpu_torch.models.factory import (IMAGENET_MEAN, IMAGENET_STD, create_model,
                                          get_preprocessing, list_models)
from mmr_tpu_torch.models.resnet_unet import ResNetUNet
from mmr_tpu_torch.models.segnet import SegNet
from mmr_tpu_torch.models.unet import UNet

__all__ = ["create_model", "get_preprocessing", "list_models", "IMAGENET_MEAN",
           "IMAGENET_STD", "UNet", "SegNet", "ResNetUNet", "UnetDecoderModel",
           "UnetPlusPlusModel", "DeepLabV3PlusModel", "MAnetModel"]
