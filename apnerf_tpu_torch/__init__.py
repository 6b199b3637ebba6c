"""apnerf_tpu_torch — the PyTorch and CUDA port of ``apnerf_tpu``.

Files sit at the same relative paths as their JAX counterparts and keep
their function names. The package imports ``torch`` and never ``jax``;
the JAX package stays beside it as the reference the port is tested
against. Hand-written CUDA kernels live in ``csrc/`` and are bound in
``ops/cuda/``.
"""

__version__ = "0.1.0"
