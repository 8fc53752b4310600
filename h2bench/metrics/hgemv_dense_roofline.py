"""Share of the roofline of the HGEMV's dense phase (``coupling_mv`` on the
dense leaves): its counted work over the device time under
``hgemv/dense``."""
from h2bench.readers import roofline_share


def read(ctx):
    return roofline_share(ctx, "hgemv/dense")
