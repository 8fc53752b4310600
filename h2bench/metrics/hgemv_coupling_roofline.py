"""Share of the roofline of the HGEMV's coupling phase (``coupling_mv`` at
every level): its counted work over the device time of the operations
under ``hgemv/coupling-gemm``."""
from h2bench.readers import roofline_share


def read(ctx):
    return roofline_share(ctx, "hgemv/coupling-gemm")
