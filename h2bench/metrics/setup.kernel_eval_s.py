"""Host seconds of the construction's kernel evaluations on the device:
``construct/bases``, ``construct/coupling`` and ``construct/dense``
(host time: queued device work lands in the first span that waits)."""
from h2bench.spans import host_seconds


def read(ctx):
    return host_seconds(["construct/bases", "construct/coupling",
                         "construct/dense"])
