"""Device operations per HGEMV call in the trace (kernels, copies and
fills launched under ``h2bench/hgemv-call``)."""
from h2bench.readers import ops_per_call


def read(ctx):
    return ops_per_call(ctx)
