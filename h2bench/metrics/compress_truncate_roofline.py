"""Share of the roofline of the recompression's truncation upsweep (the
SVDs and projections of ``truncate_by_tol``): its counted work over the
device time under ``compress/truncate``."""
from h2bench.readers import roofline_share


def read(ctx):
    return roofline_share(ctx, "compress/truncate")
