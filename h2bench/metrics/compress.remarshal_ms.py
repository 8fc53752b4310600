"""Device milliseconds a recompression of the plan's regathering of the
marshaled coupling blocks: the operations launched under the two
``compress/remarshal`` spans (after the orthogonalization and after the
truncation), per call."""
from h2bench.spans import device_ms_per_call


def read(ctx):
    return device_ms_per_call(ctx, "compress/remarshal")
