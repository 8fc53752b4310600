"""Hand-written CUDA kernels (``csrc/``), their ctypes wrappers, the plain
PyTorch versions (``ref.py``) and the backend dispatch (``ops.py``)."""
