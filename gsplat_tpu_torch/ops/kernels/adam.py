"""Adam's update over every leaf of a step in one pass.

``fused_adam`` launches the hand-written CUDA kernel in ``csrc/adam.cu``.
It replaces no TPU kernel: the JAX package leaves ``optax.adam``
(``gsplat_tpu/train/trainer.py``, ``default_optimizer``) to XLA's fusion
under ``jax.jit``.  On the card it takes the place of ``torch.optim.Adam``'s
capturable multi-tensor path, whose eight passes (``lerp_``, ``mul_``,
``addcmul_``, a ``sqrt`` into a temporary the size of the parameters,
``div_``, ``add_``, ``div_``, ``addcdiv_``) move about 80 bytes an element.

What bounds it: bytes, 28 an element (the parameter, the gradient and the
two moments read, the parameter and the moments written), against a dozen
float operations.  The kernel moves each of those bytes once: one launch
covers up to :data:`MAX_LEAVES` leaves (a table of pointers, lengths and
hyper-parameters passed by value), 16-byte streaming loads and stores, a
scalar loop for the ragged or unaligned rest, nothing allocated.  A second,
one-warp launch before it advances each leaf's step tensor on the device.

Arithmetic: float32, in the order and rounding of torch's capturable
formula (``torch/optim/adam.py``, ``_multi_tensor_adam``), with ``t`` read
from the leaf's step tensor after it is advanced::

    m <- m + (1 - b1) (g - m)
    v <- b2 v + (1 - b2) g g
    p <- p + m / ((sqrt(v) / sqrt(1 - b2^t) + eps) / (-lr / (1 - b1^t)))

:func:`fused_adam_plain` is the same arithmetic in PyTorch operations.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from . import _build, register

# Leaves one launch takes (csrc/adam.cu's MAX_LEAVES); more are launched in
# groups of this many.
MAX_LEAVES = 8

# Wrapper launches of the update kernel (each preceded by the step counter's
# one-warp launch).
launches = 0
register("adam", __name__, "launches", kernel="fused_adam_kernel")

_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = _build.load("adam")
        p = ctypes.c_void_p
        lib.gsplat_fused_adam.argtypes = [ctypes.c_int, p, p, p, p, p, p, p, p]
        lib.gsplat_fused_adam.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(params, grads, exp_avgs, exp_avg_sqs, steps, hyper):
    k = len(params)
    if not (len(grads) == len(exp_avgs) == len(exp_avg_sqs) == len(steps) == len(hyper) == k):
        raise ValueError("fused_adam: one grad, exp_avg, exp_avg_sq, step and (lr, beta1, beta2, eps) a leaf")
    for i, (p, g, m, v, s) in enumerate(zip(params, grads, exp_avgs, exp_avg_sqs, steps)):
        for name, a in (("param", p), ("grad", g), ("exp_avg", m), ("exp_avg_sq", v), ("step", s)):
            if a.dtype != torch.float32:
                raise TypeError(f"fused_adam leaf {i}: {name} is {a.dtype}, expected float32")
            if a.device != p.device:
                raise ValueError(f"fused_adam leaf {i}: {name} on {a.device}, its param on {p.device}")
            if not a.is_contiguous():
                raise ValueError(f"fused_adam leaf {i}: {name} must be contiguous")
        for name, a in (("grad", g), ("exp_avg", m), ("exp_avg_sq", v)):
            if a.shape != p.shape:
                raise ValueError(f"fused_adam leaf {i}: {name} of shape {tuple(a.shape)}, param {tuple(p.shape)}")
        if s.dim() != 0:
            raise ValueError(f"fused_adam leaf {i}: step must be a 0-dim tensor, got {tuple(s.shape)}")
        if g.is_sparse:
            raise TypeError(f"fused_adam leaf {i}: sparse gradients are not supported")
    if k and any(p.device != params[0].device for p in params):
        raise ValueError("fused_adam: all leaves must live on one device")


def fused_adam_plain(params, grads, exp_avgs, exp_avg_sqs, steps, hyper) -> None:
    """Plain PyTorch version, in place: each leaf's step advanced by one,
    then the update in the kernel's order of operations."""
    _check(params, grads, exp_avgs, exp_avg_sqs, steps, hyper)
    for p, g, m, v, s, (lr, beta1, beta2, eps) in zip(params, grads, exp_avgs, exp_avg_sqs, steps, hyper):
        s.add_(1.0)
        # -lr / (1 - b1^t); lr as a tensor, so that both devices divide (ATen
        # may multiply by the reciprocal of a Python number)
        step_size = torch.reciprocal((torch.pow(beta1, s) - 1.0) / torch.full_like(s, lr))
        bc2_sqrt = torch.sqrt(-(torch.pow(beta2, s) - 1.0))
        m.lerp_(g, 1.0 - beta1)
        v.mul_(beta2).addcmul_(g, g, value=1.0 - beta2)
        p.addcdiv_(m, (v.sqrt() / bc2_sqrt + eps) / step_size)


def fused_adam(
    params: Sequence[torch.Tensor],
    grads: Sequence[torch.Tensor],
    exp_avgs: Sequence[torch.Tensor],
    exp_avg_sqs: Sequence[torch.Tensor],
    steps: Sequence[torch.Tensor],
    hyper: Sequence[Tuple[float, float, float, float]],
) -> None:
    """One Adam step of every leaf, in place.

    Args:
      params, grads, exp_avgs, exp_avg_sqs: float32, contiguous, one shape a
        leaf.
      steps: each leaf's 0-dim float32 step count, on the leaves' device;
        advanced by one.
      hyper: each leaf's ``(lr, beta1, beta2, eps)``.

    On CUDA tensors this launches the kernels (or raises); on CPU tensors it
    takes :func:`fused_adam_plain`.
    """
    global launches
    _check(params, grads, exp_avgs, exp_avg_sqs, steps, hyper)
    if not params or not params[0].is_cuda:
        fused_adam_plain(params, grads, exp_avgs, exp_avg_sqs, steps, hyper)
        return
    lib = _library()
    with torch.cuda.device(params[0].device):
        stream = torch.cuda.current_stream().cuda_stream
        for lo in range(0, len(params), MAX_LEAVES):
            group = slice(lo, lo + MAX_LEAVES)
            k = len(params[group])
            ptrs = [(ctypes.c_void_p * k)(*(t.data_ptr() for t in ts[group]))
                    for ts in (params, grads, exp_avgs, exp_avg_sqs, steps)]
            numels = (ctypes.c_longlong * k)(*(p.numel() for p in params[group]))
            rows = [(lr, b1, b2, 1.0 - b1, 1.0 - b2, eps) for lr, b1, b2, eps in hyper[group]]
            flat = (ctypes.c_float * (6 * k))(*(float(x) for row in rows for x in row))
            err = lib.gsplat_fused_adam(k, *ptrs, numels, flat, stream)
            if err != 0:
                raise RuntimeError(f"gsplat_fused_adam launch failed: CUDA error {err}")
            launches += 1
