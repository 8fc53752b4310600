"""Device operations per recompression in the trace (under
``h2bench/compress-call``)."""
from h2bench.readers import ops_per_call


def read(ctx):
    return ops_per_call(ctx)
