"""Device microseconds a frame spends in radix-sort kernels: the depth
argsort and the sort of the pairs' keys.  A time, not a share: a sort has
no floor that holds whatever implements it."""

def read(ctx):
    s = ctx.kernel_s("RadixSort")
    return s * 1e6 if s else None
