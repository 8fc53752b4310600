"""Host seconds of the construction's block structure
(``construct/block-structure``: the host's dual-tree traversal)."""
from h2bench.spans import host_seconds


def read(ctx):
    return host_seconds(["construct/block-structure"])
