"""Device microseconds a training step spends in the SSIM filter's
convolution kernels (``train/loss.py``, a depthwise conv2d)."""

def read(ctx):
    s = ctx.kernel_s("conv_depthwise2d")
    return s * 1e6 if s else None
