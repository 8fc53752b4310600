"""Host seconds of the construction's marshalling (``construct/marshal``:
the coupling plan, the index uploads and the gathers of ``remarshal``)."""
from h2bench.spans import host_seconds


def read(ctx):
    return host_seconds(["construct/marshal"])
