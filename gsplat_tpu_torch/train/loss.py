"""Image losses for splat fitting: L1 + DSSIM, the standard 3DGS objective
(counterpart of ``gsplat_tpu.train.loss``), and SSIM over row strips sharded
across ranks (``ssim_strip``, with its halo exchange).

The separable 11-tap Gaussian filter of SSIM is a depthwise
``torch.nn.functional.conv2d`` (the JAX package leaves it to XLA's
convolution, outside any kernel).  On the card cuDNN would run a float32
convolution in TF32 (about three decimal digits) by default, so the filter
switches ``torch.backends.cudnn.allow_tf32`` off around its calls, in the
forward and in its own backward (the adjoint of a SAME-padded filter with a
symmetric window is the same filter with the padding mirrored), and the loss
stays float32 throughout.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def l1_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(pred - target))


@functools.lru_cache(maxsize=4)
def _gaussian_window(size: int, sigma: float) -> np.ndarray:
    x = np.arange(size, dtype=np.float32) - (size - 1) / 2.0
    g = np.exp(-(x**2) / (2.0 * sigma**2))
    return g / np.sum(g)


def _conv_hw(x: torch.Tensor, window: torch.Tensor, pad_lo: int, pad_hi: int) -> torch.Tensor:
    """(C, H, W) filtered by ``window`` along H, then along W; full float32."""
    c = x.shape[0]
    k = window.shape[0]
    kh = window.reshape(1, 1, k, 1).expand(c, 1, k, 1)
    kw = window.reshape(1, 1, 1, k).expand(c, 1, 1, k)
    with torch.backends.cudnn.flags(allow_tf32=False):
        y = F.conv2d(F.pad(x[None], (0, 0, pad_lo, pad_hi)), kh, groups=c)
        y = F.conv2d(F.pad(y, (pad_lo, pad_hi, 0, 0)), kw, groups=c)
    return y[0]


class _Filter2dSeparable(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, window):
        k = window.shape[0]
        ctx.save_for_backward(window)
        return _conv_hw(x, window, (k - 1) // 2, k // 2)

    @staticmethod
    def backward(ctx, g):
        (window,) = ctx.saved_tensors
        k = window.shape[0]
        return _conv_hw(g.contiguous(), torch.flip(window, (0,)), k // 2, (k - 1) // 2), None


def _filter2d_separable(img: torch.Tensor, window: torch.Tensor) -> torch.Tensor:
    """Depthwise separable 2-D convolution, SAME (zero) padding.  img: (H, W, C)."""
    return _Filter2dSeparable.apply(img.permute(2, 0, 1).contiguous(), window).permute(1, 2, 0)


def ssim(
    pred: torch.Tensor,
    target: torch.Tensor,
    window_size: int = 11,
    sigma: float = 1.5,
    c1: float = 0.01**2,
    c2: float = 0.03**2,
) -> torch.Tensor:
    """Mean SSIM over an (H, W, C) image pair in [0, 1]."""
    return torch.mean(_ssim_map(pred, target, window_size, sigma, c1, c2))


@functools.lru_cache(maxsize=8)
def _window_on(size: int, sigma: float, device: torch.device) -> torch.Tensor:
    """The window as a tensor on ``device``, made once: a copy from host
    memory a call would be a host step inside a captured training step."""
    return torch.from_numpy(_gaussian_window(size, sigma)).to(device)


def _ssim_map(p, t, window_size, sigma, c1, c2):
    w = _window_on(window_size, sigma, p.device)
    mu_p = _filter2d_separable(p, w)
    mu_t = _filter2d_separable(t, w)
    mu_pp = mu_p * mu_p
    mu_tt = mu_t * mu_t
    mu_pt = mu_p * mu_t
    var_p = _filter2d_separable(p * p, w) - mu_pp
    var_t = _filter2d_separable(t * t, w) - mu_tt
    cov = _filter2d_separable(p * t, w) - mu_pt
    num = (2.0 * mu_pt + c1) * (2.0 * cov + c2)
    den = (mu_pp + mu_tt + c1) * (var_p + var_t + c2)
    return num / den


def _halo_exchange(x: torch.Tensor, group, n_strips: int, halo: int) -> torch.Tensor:
    """Extend a row strip with ``halo`` rows from each neighbour over the
    group.  The first and last strips receive zeros — the same zero padding
    the full-image filter applies at the frame's top and bottom.
    Differentiable: a halo row's gradient goes back to its owner."""
    from ..parallel.collectives import ppermute

    up = ppermute(x[-halo:], group, [(i, i + 1) for i in range(n_strips - 1)])
    dn = ppermute(x[:halo], group, [(i + 1, i) for i in range(n_strips - 1)])
    return torch.cat([up, x, dn], dim=0)


def ssim_strip_map(
    pred: torch.Tensor,
    target: torch.Tensor,
    group,
    n_strips: int,
    window_size: int = 11,
    sigma: float = 1.5,
    c1: float = 0.01**2,
    c2: float = 0.03**2,
) -> torch.Tensor:
    """The SSIM map of this rank's horizontal strip of an image whose row
    strips are spread over ``group`` (one strip a rank, in rank order): the
    11×11 windows near a strip's edge read 5 rows of the neighbours, sent by
    :func:`_halo_exchange`.  Its rows equal the full image's map rows."""
    if n_strips == 1:
        return _ssim_map(pred, target, window_size, sigma, c1, c2)
    halo = window_size // 2
    p = _halo_exchange(pred, group, n_strips, halo)
    t = _halo_exchange(target, group, n_strips, halo)
    return _ssim_map(p, t, window_size, sigma, c1, c2)[halo:-halo]


def ssim_strip(
    pred: torch.Tensor,
    target: torch.Tensor,
    group,
    n_strips: int,
    window_size: int = 11,
    sigma: float = 1.5,
    c1: float = 0.01**2,
    c2: float = 0.03**2,
) -> torch.Tensor:
    """Per-strip mean SSIM under row-strip sharding (every rank of ``group``
    calls it with its strip).  The mean of the per-strip means over equal
    strips is the full image's mean SSIM (to float rounding); with
    ``n_strips == 1`` this is :func:`ssim`."""
    return torch.mean(ssim_strip_map(pred, target, group, n_strips, window_size, sigma, c1, c2))


def render_loss(
    pred_rgb: torch.Tensor,
    target_rgb: torch.Tensor,
    lambda_dssim: float = 0.2,
    use_ssim: bool = True,
) -> torch.Tensor:
    """The 3DGS objective: (1−λ)·L1 + λ·(1−SSIM)."""
    loss = (1.0 - lambda_dssim) * l1_loss(pred_rgb, target_rgb)
    if use_ssim and lambda_dssim > 0.0:
        loss = loss + lambda_dssim * (1.0 - ssim(pred_rgb, target_rgb))
    return loss


def psnr(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    mse = torch.mean(torch.square(pred - target))
    return -10.0 * torch.log10(torch.clamp(mse, min=1e-12))
