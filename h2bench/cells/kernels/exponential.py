"""The port's exponential covariance kernel, for ``construct_h2``."""


def kernel(spec: dict):
    from repro_torch.core import kernels_fn
    return kernels_fn.exponential_kernel(float(spec["length"]))
