"""apnerf_tpu_torch — the PyTorch and CUDA port of ``apnerf_tpu``.

Files sit at the same relative paths as their JAX counterparts and keep
their function names. The package imports ``torch``, never ``jax``, and
nothing of ``apnerf_tpu``: it keeps its own copies of the host-only
modules it needs. The JAX package stays beside it as the reference the
port is tested against. Hand-written CUDA kernels live in ``csrc/`` and
are bound in ``ops/cuda/``.
"""

__version__ = "0.1.0"
