from mmr_tpu_torch.core.mesh import (MeshSpec, create_mesh, local_batch_slice,
                                     shard_batch)
from mmr_tpu_torch.core.precision import DEFAULT_PRECISION, Precision
from mmr_tpu_torch.core.prng import DEFAULT_SPLIT_SEED, RngStream, seed_everything

__all__ = ["MeshSpec", "create_mesh", "shard_batch", "local_batch_slice",
           "Precision", "DEFAULT_PRECISION", "RngStream", "seed_everything",
           "DEFAULT_SPLIT_SEED"]
