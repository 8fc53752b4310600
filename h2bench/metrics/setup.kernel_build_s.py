"""Host seconds of the set-up in ``kernels/build``: the check of the
built CUDA libraries and, on a fresh checkout, ``nvcc``."""
from h2bench.spans import host_seconds


def read(ctx):
    return host_seconds(["kernels/build"])
