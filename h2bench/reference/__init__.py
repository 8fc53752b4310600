"""The plain reference of the benchmark: NumPy and plain PyTorch only.

It imports neither ``jax``, nor the JAX package, nor anything of the port.
It works out again whatever the port derives from the benchmark's inputs
(the kernels' exact rows and blocks, in ``kernels/<name>.py``, found by
the name a configuration gives) and reads the port's outputs only to
judge them (the product of a recompressed operator from its arrays).
Every routine runs in float64, in blocks of rows, so that it fits beside
the program's outputs.
"""
