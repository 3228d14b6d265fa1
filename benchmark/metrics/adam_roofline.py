"""The optimizer's share of its roofline: Adam reads each element's
parameter, gradient and two moments and writes the parameter and the
moments, 28 B an element, over the 59 float32 elements of a splat's six
leaves, whatever implements it.  The time is every Adam kernel's a step:
``torch.optim.Adam``'s multi-tensor kernels, or the port's update
(``csrc/adam.cu``) and its step counter."""

from harness.roofline import share

ELEMENTS_PER_SPLAT = 59


def read(ctx):
    t = ctx.kernel_s("multi_tensor_apply_kernel", "fused_adam_kernel", "adam_count_kernel")
    if not t or not ctx.counts:
        return None
    return share(28.0 * ELEMENTS_PER_SPLAT * ctx.counts["splats"], 0.0, t)
