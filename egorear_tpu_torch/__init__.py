"""PyTorch/CUDA port of the egorear_tpu framework (NVIDIA Hopper).

Mirrors the JAX package's ``ops/`` and ``models/`` layout, module for module,
and never imports JAX or the JAX package. Entry point: :mod:`egorear_tpu_torch.entry`.
"""
