"""The segment sum's share of its roofline (``csrc/segsum.cu``): each walked
pair's 9 gradient words (36 B) and its slot (4 B) read, each splat's 9
sums (36 B) written."""

from harness.roofline import share


def read(ctx):
    t = ctx.kernel_s("segsum_kernel")
    if not t or not ctx.counts:
        return None
    c = ctx.counts
    return share(40.0 * c["pairs_walked"] + 36.0 * c["splats"], 0.0, t)
