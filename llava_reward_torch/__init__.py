"""PyTorch / CUDA port of llava_reward_tpu for NVIDIA Hopper (H100).

Mirrors the JAX package's module names; imports ``torch`` and never ``jax``
or ``llava_reward_tpu``. The attention kernels of the serving path are
hand-written CUDA in ``csrc/``, built at first use (``ops/cuda_lib.py``).
"""
