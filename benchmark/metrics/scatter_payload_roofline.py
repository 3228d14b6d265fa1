"""``scatter_payload``'s share of its roofline (``csrc/frame_glue.cu``, the
gather's backward).  Bytes a splat: its index (8 B) and the 10 cotangent
rows (40 B) read, the 10 rows of its gradient (40 B) written."""

from harness.roofline import share


def read(ctx):
    t = ctx.kernel_s("scatter_payload_kernel")
    if not t or not ctx.counts:
        return None
    return share(88.0 * ctx.counts["splats"], 0.0, t)
