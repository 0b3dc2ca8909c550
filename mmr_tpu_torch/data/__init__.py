from mmr_tpu_torch.data.patch_dataset import PatchSampler
from mmr_tpu_torch.data.splits import create_split_files, get_data_ids
from mmr_tpu_torch.data.synthetic import make_synthetic_dataset
from mmr_tpu_torch.data.video_dataset import VideoFrameDataset
from mmr_tpu_torch.data.zarr_io import VideoStore, list_dataset_stores

__all__ = ["VideoStore", "list_dataset_stores", "create_split_files",
           "get_data_ids", "PatchSampler", "VideoFrameDataset",
           "make_synthetic_dataset"]
