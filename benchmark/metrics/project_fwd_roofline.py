"""``project_fwd``'s share of its roofline (``csrc/projection.cu``, the
serving frame's payload form).  Bytes: each splat's inputs read once (pos,
orient, scale, opacity 44 B, colour 12 B, the SH rows of the degree) and its
64-byte field column written once; operations: 250 float operations a
splat."""

from harness.roofline import share

SH_BYTES = (0, 36, 96, 180)


def read(ctx):
    t = ctx.kernel_s("project_fwd_kernel")
    if not t or not ctx.counts:
        return None
    n = ctx.counts["splats"]
    return share(n * (44 + 12 + SH_BYTES[int(ctx.render["sh_order"])] + 64), 250.0 * n, t)
