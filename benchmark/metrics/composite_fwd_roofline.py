"""The forward compositor's share of its roofline (``csrc/composite_fwd.cu``).
Operations: 24 float operations for each pixel update with alpha != 0 among
the pairs walked before each tile's early stop, an FMA counted as two
(``utils/sol.py``'s FWD_FLOPS), counted by the reference at the traced
pose; bytes: the walked pairs' indices and the RGBA image written."""

from harness.roofline import share


def read(ctx):
    t = ctx.kernel_s("composite_fwd_kernel")
    if not t or not ctx.counts:
        return None
    c, r = ctx.counts, ctx.render
    nbytes = 4.0 * c["pairs_walked"] + 16.0 * int(r["width"]) * int(r["height"])
    return share(nbytes, 24.0 * c["live_pixel_updates"], t)
