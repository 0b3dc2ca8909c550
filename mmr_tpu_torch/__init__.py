"""mmr_tpu_torch — the PyTorch/CUDA port of ``mmr_tpu`` for NVIDIA Hopper.

The JAX package ``mmr_tpu`` is the reference; this package imports torch,
numpy and the standard library only. Its subpackages mirror ``mmr_tpu``
and export the names of its package ``__init__``s, but those in
:data:`NOT_PORTED`.
"""

# public names of the reference with no counterpart in the port, and why
_PACKING = ("the TPU's lane-packed row geometry (``models/packed_blocks.py``, "
            "``packed_encoder.py``); the port's fused nodes read plain NHWC")
NOT_PORTED = {
    "core.batch_sharding": "a jax NamedSharding over the batch axis; one process a "
                           "rank has none, ``core.mesh.shard_batch`` cuts the batch",
    "core.replicated_sharding": "a replicated jax NamedSharding; a rank's tensors "
                                "are whole on its card (``core.mesh.broadcast_module``)",
    **{f"models.packed_blocks.{n}": _PACKING for n in (
        "PackedT", "pack_plain", "pack_up_lazy", "pack_into", "as_packed",
        "choose_row_geom", "upsample_packed")},
    **{f"models.packed_encoder.{n}": _PACKING for n in (
        "image_geom", "stem_geom", "down_geom", "best_geom")},
}
