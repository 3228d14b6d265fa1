"""Device microseconds a training step spends in the capturable Adam's
multi-tensor kernels (``torch.optim.Adam``)."""

def read(ctx):
    s = ctx.kernel_s("multi_tensor_apply_kernel")
    return s * 1e6 if s else None
