"""Host seconds of the construction's cluster tree
(``construct/cluster-tree``: the host's median splits)."""
from h2bench.spans import host_seconds


def read(ctx):
    return host_seconds(["construct/cluster-tree"])
