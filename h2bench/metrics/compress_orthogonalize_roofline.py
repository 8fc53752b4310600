"""Share of the roofline of the recompression's orthogonalization (QR of
the leaf bases and stacked transfers): its counted work over the device
time under ``compress/orthogonalize``."""
from h2bench.readers import roofline_share


def read(ctx):
    return roofline_share(ctx, "compress/orthogonalize")
