"""``project_bwd``'s share of its roofline (``csrc/projection.cu``, the
training step's masked form, SH degree 3, tight footprint).  Bytes: pos,
orient, scale, opacity, colour and SH read (236 B), 14 cotangent rows read
(56 B), the gradients of pos, orient, scale, opacity, colour and SH written
(236 B): 528 B a splat."""

from harness.roofline import share


def read(ctx):
    t = ctx.kernel_s("project_bwd_kernel")
    if not t or not ctx.counts:
        return None
    n = ctx.counts["splats"]
    return share(528.0 * n, 0.0, t)
