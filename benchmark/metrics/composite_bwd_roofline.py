"""The backward compositor's share of its roofline (``csrc/composite_bwd.cu``).
Operations: 49 float operations for each pixel update with alpha != 0 of
the walked pairs (``utils/sol.py``'s BWD_FLOPS), counted by the reference
at the traced step's frame; bytes: the image cotangent read, a walked
pair's index read and its 9 gradient words written."""

from harness.roofline import share


def read(ctx):
    t = ctx.kernel_s("composite_bwd_kernel")
    if not t or not ctx.counts:
        return None
    c, r = ctx.counts, ctx.render
    nbytes = 40.0 * c["pairs_walked"] + 16.0 * int(r["width"]) * int(r["height"])
    return share(nbytes, 49.0 * c["live_pixel_updates"], t)
