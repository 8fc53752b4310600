"""Share of the roofline of a whole HGEMV call: the least work of the call
(``work.hgemv_call``) over the device time of every operation under the
call's span, the permutations and the final sum included."""
from h2bench.readers import roofline_share


def read(ctx):
    return roofline_share(ctx, "h2bench/hgemv-call")
