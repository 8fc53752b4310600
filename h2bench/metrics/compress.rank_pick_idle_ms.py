"""Milliseconds a recompression that the device idles while the host
reads the rank pick's singular values: the traced window's idle gaps that
began inside ``compress/rank-pick``, per call."""
from h2bench.spans import idle_ms_per_call


def read(ctx):
    return idle_ms_per_call(ctx, "compress/rank-pick")
