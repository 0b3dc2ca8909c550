"""mmr_tpu_torch — the PyTorch/CUDA port of ``mmr_tpu`` for NVIDIA Hopper.

The JAX package ``mmr_tpu`` is the reference; this package imports torch,
numpy and the standard library only. Its subpackages mirror ``mmr_tpu``.
"""
