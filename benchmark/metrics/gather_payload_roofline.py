"""``gather_payload``'s share of its roofline (``csrc/frame_glue.cu``).
Bytes a splat: its depth-order index (8 B) and 13 field rows (52 B) read;
the packed payload (32 B) and three binning operands (12 B) written."""

from harness.roofline import share


def read(ctx):
    t = ctx.kernel_s("gather_payload_kernel")
    if not t or not ctx.counts:
        return None
    return share(104.0 * ctx.counts["splats"], 0.0, t)
