"""PyTorch / CUDA port of the H^2 matrix package (``repro``).

The JAX package ``repro`` stays the reference; this package mirrors its
layout module for module and runs on one NVIDIA H100.  Every entry point
takes an explicit ``device`` (default ``"cuda"``) and a ``backend``:

- ``"cuda"`` (default): the hand-written CUDA kernels in ``csrc/`` on CUDA
  tensors; on CPU tensors the plain PyTorch versions in ``kernels/ref.py``.
- ``"torch"``: the plain PyTorch versions on any device (the counterpart of
  the reference's ``"jnp"``).

This package imports neither ``jax`` nor ``repro``.
"""
