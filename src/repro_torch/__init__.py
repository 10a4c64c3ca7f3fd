"""PyTorch/CUDA port of the distributed DPMM sampler (``repro``).

Runs on an NVIDIA GPU through hand-written CUDA kernels (``csrc/``), or on
the CPU through their plain PyTorch versions when asked to. Imports
``torch`` and numpy, never ``jax`` or the JAX package.
"""
