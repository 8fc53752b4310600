"""Device-to-host reads of a recompression's rank pick, per call: the
``compress/rank-pick`` spans of ``truncate_by_tol`` (the scale, then two
counts at each level) in the traced window over the calls of
``h2bench/compress-call``; 0 once the rank pick reads nothing back.  It
counts the reads the program names with that span, not every sync of the
call."""
from h2bench.spans import count_per_call


def read(ctx):
    return count_per_call(ctx, "compress/rank-pick")
