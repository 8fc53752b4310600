"""Idle share of the device over the traced window of back-to-back
HGEMVs."""
from h2bench.readers import idle_share


def read(ctx):
    return idle_share(ctx)
