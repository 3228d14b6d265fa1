"""Projection: world splats → the ``(16, N)`` screen-space field matrix, as
one forward and one backward kernel.

``ProjectSplats`` runs ``project_splats`` (``ops/projection.py``) through the
hand-written CUDA kernels of ``csrc/projection.cu``.  It replaces no TPU
kernel: the JAX package writes the projection as elementwise XLA ops
(``gsplat_tpu/ops/projection.py:142``), and ``jax.jit`` fuses them, and
their VJP, into a few loops over the splats.  Run eagerly, PyTorch launches
each of those ops as a kernel of its own — some 480 passes over (N,) floats
forward and more backward.  The two kernels are the port's counterpart of
that fusion: one thread a splat reads its column of the six splat fields and
writes its column of the field matrix (``project_fwd``); the backward
(``project_bwd``) reads the same column, less what the gradient does not
need, and the cotangent's rows that carry a gradient back through the
geometry or the SH; it recomputes the forward's intermediates in registers
and writes the gradients of pos, orient, scale, colour and SH, so autograd
keeps nothing of size (N,) but the inputs.  The opacity's gradient is
cotangent row 9 and, at ``sh_order`` 0, the colour's is rows 6..8: the
wrapper returns those rows as views and the kernel neither reads nor writes
them.

What bounds both: bytes.  The forward reads 236 B a splat at ``sh_order`` 3
(pos 12, orient 16, scale 12, opacity 4, colour 12, SH 180) and writes 64 B;
the backward reads 232 B of those (the opacity only with
``tight_footprint``) and 52 B of the cotangent (13 rows) and writes 232 B of
gradients (``utils/sol.py`` ``projection_bytes``).  A few hundred float
operations a splat sit far below the card's rate for that traffic.

The forward kernel is held bit for bit against :func:`project_fields_plain`
on the card, so it repeats ATen's rounding op for op (no FMA contraction; a
division by a Python float is a multiplication by its reciprocal, taken in
double and rounded to float, as ATen's CUDA kernel computes it; ``1.0 / t``
a reciprocal; ``torch.clamp`` and ``torch.minimum`` propagate NaN).

The backward's plain version :func:`project_fields_bwd_plain` is the
analytic VJP in the kernel's order; it follows autograd's branch rules
(``torch.where`` sends zero to the branch not taken, ``torch.clamp`` passes
the gradient inside its bounds, bounds included, ``max0`` halves it at a
tie, ``torch.minimum`` splits it at a tie, ``abs`` gives 0 at 0, the
footprint radius ``rho`` is detached).  From the quad basis back to the 2D
covariance (:func:`_axes_vjp`) it repeats autograd's own operations in the
order autograd's engine adds them, bit for bit: near an axis-aligned
eigenvector that section cancels terms of ~1e5·|g|, and another order
rounds them to another result (a reordered VJP moved the sharded renderer's
scale gradient 2.8e-4 of its max from the single-device one, against
autograd's 1.4e-4 and a gate of 2e-4).

The camera's ``view``, ``proj`` and position are read through device
pointers, never as host floats in the launch, so a CUDA graph replay that
copies a new camera into those tensors projects for the new camera.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch
from torch.autograd.function import once_differentiable

from ..covariance import (
    ALPHA_CUTOFF,
    AXIS_MAX_PX,
    COV2D_DILATION,
    FOV_CLAMP,
    LAMBDA2_MIN,
    QUAD_EXTENT,
)
from ..sh import SH_C1, SH_C2, SH_C3, max0
from . import _build, register

N_FIELDS = 16

# Wrapper calls that launched each kernel.
launches_fwd = 0
launches_bwd = 0
# Those forward launches that also sanitized and quantized the fields.
launches_fwd_payload = 0
register("project_fwd", __name__, "launches_fwd", kernel="project_fwd_kernel")
register("project_fwd_payload", __name__, "launches_fwd_payload")
register("project_bwd", __name__, "launches_bwd", kernel="project_bwd_kernel")

# project_fwd's payload policies (csrc/projection.cu): none (the raw fields),
# or sanitized and rounded to the payload dtype.
PAYLOAD_CODE = {None: 0, "float32": 1, "packed": 2, "bfloat16": 3}

_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = _build.load("projection")
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.gsplat_project_fwd.argtypes = [p, p, p, p, p, p, p, p, p, p, ctypes.c_longlong, i, i, i, i, i, i, p]
        lib.gsplat_project_fwd.restype = i
        lib.gsplat_project_bwd.argtypes = [p, p, p, p, p, p, p, p, p, p,
                                           p, p, p, p, p, p, ll, ll, ll, i, i, i, i, i, i, p]
        lib.gsplat_project_bwd.restype = i
        _lib = lib
    return _lib


# ----------------------------------------------------------------- plain forward

def _rotation_scale_rows(orient: torch.Tensor, scale: torch.Tensor):
    """M = S·R entries as 9 (N,) expressions."""
    # unbind, not row indexing: one stack in the backward instead of a
    # full-size zero tensor and an accumulation per row
    qx, qy, qz, qw = orient.unbind(0)
    sx, sy, sz = scale.unbind(0)
    one = 1.0
    m00 = sx * (one - 2.0 * (qy * qy + qz * qz))
    m01 = sx * (2.0 * (qx * qy + qw * qz))
    m02 = sx * (2.0 * (qx * qz - qw * qy))
    m10 = sy * (2.0 * (qx * qy - qw * qz))
    m11 = sy * (one - 2.0 * (qx * qx + qz * qz))
    m12 = sy * (2.0 * (qy * qz + qw * qx))
    m20 = sz * (2.0 * (qx * qz + qw * qy))
    m21 = sz * (2.0 * (qy * qz - qw * qx))
    m22 = sz * (one - 2.0 * (qx * qx + qy * qy))
    return ((m00, m01, m02), (m10, m11, m12), (m20, m21, m22))


def _sigma_components(m):
    """Σ = MᵀM upper triangle as 6 (N,) expressions."""

    def s(i, j):
        return m[0][i] * m[0][j] + m[1][i] * m[1][j] + m[2][i] * m[2][j]

    return s(0, 0), s(0, 1), s(0, 2), s(1, 1), s(1, 2), s(2, 2)


# σ (k, l) → index of its stored upper-triangle component
_SIG = {(0, 0): 0, (0, 1): 1, (0, 2): 2, (1, 0): 1, (1, 1): 3, (1, 2): 4, (2, 0): 2, (2, 1): 4, (2, 2): 5}
# the six C entries (i, j) the projection uses
_C_ENTRIES = ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))


def _sh_bases(dxn, dyn, dzn, sh_order):
    """The SH basis values of bands 1..sh_order, each with its coefficient
    index j (rows 3j..3j+2 of ``sh``), and the products they share."""
    terms = [(-SH_C1 * dyn, 0), (SH_C1 * dzn, 1), (-SH_C1 * dxn, 2)]
    prods = None
    if sh_order >= 2:
        xx, yy, zz = dxn * dxn, dyn * dyn, dzn * dzn
        xy, yz, xz = dxn * dyn, dyn * dzn, dxn * dzn
        prods = (xx, yy, zz, xy, yz, xz)
        terms += [
            (SH_C2[0] * xy, 3),
            (SH_C2[1] * yz, 4),
            (SH_C2[2] * (2.0 * zz - xx - yy), 5),
            (SH_C2[3] * xz, 6),
            (SH_C2[4] * (xx - yy), 7),
        ]
        if sh_order >= 3:
            terms += [
                (SH_C3[0] * dyn * (3.0 * xx - yy), 8),
                (SH_C3[1] * xy * dzn, 9),
                (SH_C3[2] * dyn * (4.0 * zz - xx - yy), 10),
                (SH_C3[3] * dzn * (2.0 * zz - 3.0 * xx - 3.0 * yy), 11),
                (SH_C3[4] * dxn * (4.0 * zz - xx - yy), 12),
                (SH_C3[5] * dzn * (xx - yy), 13),
                (SH_C3[6] * dxn * (xx - 3.0 * yy), 14),
            ]
    return terms, prods


_T = torch.Tensor
_OptT = Optional[torch.Tensor]


class _Intermediates(NamedTuple):
    """What the plain backward reads of the forward, by stage."""

    # centre
    valid: _T
    safe_w: _T
    ndc_x: _T
    ndc_y: _T
    # covariance
    m: tuple
    lim_x: _T
    lim_y: _T
    vz_: _T
    vzc: _T
    tx_: _T
    ty_: _T
    vxc: _T
    vyc: _T
    focal: _T
    c00: _T
    c01: _T
    c02: _T
    c11: _T
    c12: _T
    c22: _T
    inv_z: _T
    a_: _T
    gx_: _T
    gy_: _T
    cu0_0: _T
    cu0_2: _T
    cu1_1: _T
    cu1_0: _T
    cu1_2: _T
    cov_a: _T
    cov_b: _T
    cov_c: _T
    # eigen decomposition and quad axes
    hd: _T
    rr: _T
    radius: _T
    l2raw: _T
    ex: _T
    ey: _T
    safe: _T
    inv_norm: _T
    dx_: _T
    dy_: _T
    s1: _T
    s2: _T
    len1: _T
    len2: _T
    v1x: _T
    v1y: _T
    v2x: _T
    v2y: _T
    inv_l1: _T
    inv_l2: _T
    rho: _OptT
    # depth key and SH colour (None at sh_order 0)
    tx: _T
    ty: _T
    tz: _T
    depth_sq: _T
    inv_n: _OptT
    dirs: Optional[tuple]
    terms: Optional[list]
    prods: Optional[tuple]
    pre: Optional[tuple]


def _project(pos, orient, scale, opacity, color, sh, view, proj, cam_pos, width, height,
             sh_order, tight_footprint, only_sh):
    """The projection's body: the (16, N) field matrix and the intermediates
    the backward recomputes from."""
    px_, py_, pz_ = pos.unbind(0)

    # --- center projection + viewport ---
    def xform3(m, x, y, z):
        out = []
        for i in range(3):
            e = m[i, 0] * x + m[i, 1] * y + m[i, 2] * z
            e = e + m[i, 3]
            out.append(e)
        return out

    vx_, vy_, vz_ = xform3(view, px_, py_, pz_)
    cx_, cy_, _cz = xform3(proj, vx_, vy_, vz_)
    cw_ = proj[3, 0] * vx_ + proj[3, 1] * vy_ + proj[3, 2] * vz_ + proj[3, 3]
    valid = cw_ > 0.0
    safe_w = torch.where(valid, cw_, 1.0)
    ndc_x = cx_ / safe_w
    ndc_y = cy_ / safe_w
    mean_x = (ndc_x + 1.0) * (0.5 * width)
    mean_y = (1.0 - ndc_y) * (0.5 * height)

    # --- EWA covariance projection ---
    m = _rotation_scale_rows(orient, scale)
    sig6 = _sigma_components(m)
    p00 = proj[0, 0]
    p11 = proj[1, 1]
    aspect = p00 / p11
    lim_x = FOV_CLAMP / p00
    lim_y = FOV_CLAMP / (p11 * aspect)
    # clamp vz away from 0 so behind-camera splats stay finite (masked later)
    vzc = torch.clamp(vz_, max=-1e-6)
    tx_ = vx_ / vzc
    ty_ = vy_ / vzc
    vxc = torch.clamp(tx_, min=-lim_x, max=lim_x) * vzc
    vyc = torch.clamp(ty_, min=-lim_y, max=lim_y) * vzc
    focal = width * p00 / 2.0

    # C = Rv Σ Rvᵀ, entries as scalar-coefficient combinations of the 6 σ.
    rv = view[:3, :3]

    def c_entry(i, j):
        acc = None
        for k in range(3):
            for l in range(3):
                term = (rv[i, k] * rv[j, l]) * sig6[_SIG[(k, l)]]
                acc = term if acc is None else acc + term
        return acc

    c00, c01, c02, c11, c12, c22 = (c_entry(i, j) for i, j in _C_ENTRIES)

    inv_z = 1.0 / vzc
    a_ = focal * inv_z
    gx_ = -focal * vxc * inv_z * inv_z
    gy_ = -focal * vyc * inv_z * inv_z
    # u0 = (a, 0, gx), u1 = (0, a, gy):  cov2d_mn = u_m · C · u_n
    cu0_0 = a_ * c00 + gx_ * c02
    cu0_2 = a_ * c02 + gx_ * c22
    cu1_1 = a_ * c11 + gy_ * c12
    cu1_0 = a_ * c01 + gy_ * c02
    cu1_2 = a_ * c12 + gy_ * c22
    cov_a = a_ * cu0_0 + gx_ * cu0_2 + COV2D_DILATION
    cov_b = a_ * cu1_0 + gx_ * cu1_2
    cov_c = a_ * cu1_1 + gy_ * cu1_2 + COV2D_DILATION

    # --- 2×2 eigen decomposition → quad axes ---
    mid = 0.5 * (cov_a + cov_c)
    hd = (cov_a - cov_c) / 2.0
    rr = torch.square(hd) + torch.square(cov_b)
    radius = torch.sqrt(torch.clamp(rr, min=1e-18))
    lambda1 = mid + radius
    l2raw = mid - radius
    lambda2 = torch.clamp(l2raw, min=LAMBDA2_MIN)
    ex = cov_b
    ey = lambda1 - cov_a
    norm_sq = ex * ex + ey * ey
    safe = norm_sq > 1e-24
    inv_norm = torch.where(safe, torch.rsqrt(torch.where(safe, norm_sq, 1.0)), 0.0)
    dx_ = torch.where(safe, ex * inv_norm, 1.0)
    dy_ = -torch.where(safe, ey * inv_norm, 0.0)  # image-space y-flip
    s1 = torch.sqrt(2.0 * lambda1)
    s2 = torch.sqrt(2.0 * lambda2)
    len1 = torch.clamp(s1, max=AXIS_MAX_PX)
    len2 = torch.clamp(s2, max=AXIS_MAX_PX)
    v1x = len1 * dx_
    v1y = len1 * dy_
    v2x = len2 * dy_
    v2y = -len2 * dx_
    inv_l1 = 1.0 / (len1 * len1)
    inv_l2 = 1.0 / (len2 * len2)
    ax_ = v1x * inv_l1
    ay_ = v1y * inv_l1
    bx_ = v2x * inv_l2
    by_ = v2y * inv_l2
    rho = None
    if tight_footprint:
        # A pixel survives the hard fragment discard only if
        # α = exp(−(qx²+qy²))·op ≥ ALPHA_CUTOFF  AND  |qx|,|qy| ≤ QUAD_EXTENT,
        # i.e. the live region in quad space is square(QUAD_EXTENT) ∩ disc(ρ)
        # with ρ = √ln(op/cutoff).  Screen-space AABB of the square is the L1
        # combination of the quad axes; of the disc, the L2 combination.
        # min() of the two bounds the intersection, so the bbox never clips a
        # live pixel.  Detached: the footprint is binning-only, and √x at x=0
        # would otherwise inject inf·0 = NaN into the gradient.
        rho = torch.sqrt(
            torch.clamp(torch.log(torch.clamp(opacity, min=1e-20) / ALPHA_CUTOFF), min=0.0)
        ).detach()
        half_x = torch.minimum(
            QUAD_EXTENT * (torch.abs(v1x) + torch.abs(v2x)),
            rho * torch.sqrt(v1x * v1x + v2x * v2x),
        )
        half_y = torch.minimum(
            QUAD_EXTENT * (torch.abs(v1y) + torch.abs(v2y)),
            rho * torch.sqrt(v1y * v1y + v2y * v2y),
        )
    else:
        half_x = QUAD_EXTENT * (torch.abs(v1x) + torch.abs(v2x))
        half_y = QUAD_EXTENT * (torch.abs(v1y) + torch.abs(v2y))

    # --- depth key + SH color ---
    tx = px_ - cam_pos[0]
    ty = py_ - cam_pos[1]
    tz = pz_ - cam_pos[2]
    depth_sq = tx * tx + ty * ty + tz * tz
    if only_sh:
        grey = torch.full_like(color[0], 0.5)
        r_, g_, b_ = grey, grey, grey
    else:
        r_, g_, b_ = color.unbind(0)
    inv_n = dirs = terms = prods = pre = None
    if sh_order > 0:
        inv_n = torch.rsqrt(torch.clamp(depth_sq, min=1e-24))
        dirs = (tx * inv_n, ty * inv_n, tz * inv_n)
        # (45, N) → 45 rows by one unbind: indexing row by row would cost the
        # backward a (45, N) zero tensor and a (45, N) add for every row used
        shr = sh.unbind(0)
        terms, prods = _sh_bases(*dirs, sh_order)
        for basis, j in terms:
            r_ = r_ + basis * shr[3 * j + 0]
            g_ = g_ + basis * shr[3 * j + 1]
            b_ = b_ + basis * shr[3 * j + 2]
        pre = (r_, g_, b_)
        r_ = max0(r_)
        g_ = max0(g_)
        b_ = max0(b_)

    zeros = torch.zeros_like(opacity)
    fields = torch.stack(
        [
            mean_x, mean_y,
            ax_, ay_, bx_, by_,
            r_, g_, b_,
            opacity,
            depth_sq,
            valid.to(torch.float32),
            half_x, half_y,
            -vz_, zeros,
        ],
        dim=0,
    )
    saved = _Intermediates(
        valid=valid, safe_w=safe_w, ndc_x=ndc_x, ndc_y=ndc_y,
        m=m, lim_x=lim_x, lim_y=lim_y, vz_=vz_, vzc=vzc, tx_=tx_, ty_=ty_, vxc=vxc, vyc=vyc, focal=focal,
        c00=c00, c01=c01, c02=c02, c11=c11, c12=c12, c22=c22,
        inv_z=inv_z, a_=a_, gx_=gx_, gy_=gy_, cu0_0=cu0_0, cu0_2=cu0_2, cu1_1=cu1_1, cu1_0=cu1_0, cu1_2=cu1_2,
        cov_a=cov_a, cov_b=cov_b, cov_c=cov_c,
        hd=hd, rr=rr, radius=radius, l2raw=l2raw, ex=ex, ey=ey, safe=safe, inv_norm=inv_norm, dx_=dx_, dy_=dy_,
        s1=s1, s2=s2, len1=len1, len2=len2, v1x=v1x, v1y=v1y, v2x=v2x, v2y=v2y, inv_l1=inv_l1, inv_l2=inv_l2,
        rho=rho,
        tx=tx, ty=ty, tz=tz, depth_sq=depth_sq, inv_n=inv_n, dirs=dirs, terms=terms, prods=prods, pre=pre,
    )
    return fields, saved


def project_fields_plain(pos, orient, scale, opacity, color, sh, view, proj, cam_pos, width, height,
                         sh_order=3, tight_footprint=False, only_sh=False) -> torch.Tensor:
    """Plain PyTorch version of the forward kernel: ``(16, N)`` float32 (the
    row layout of ``ops/projection.py``).  Inputs float32: the splat fields
    as ``GaussianSplats`` holds them ((3, N), (4, N), (3, N), (N,), (3, N),
    (45, N)), ``view`` and ``proj`` (4, 4), ``cam_pos`` (3,)."""
    return _project(pos, orient, scale, opacity, color, sh, view, proj, cam_pos, width, height,
                    sh_order, tight_footprint, only_sh)[0]


# ----------------------------------------------------------------- plain backward

def _split_min(a, b, g):
    """``torch.minimum``'s gradient: to the smaller input, half each at a tie
    (and the whole to both when one is NaN, as autograd's masks give)."""
    tie = a == b
    half = 0.5 * g
    ga = torch.where(tie, half, torch.where(a > b, 0.0, g))
    gb = torch.where(tie, half, torch.where(a < b, 0.0, g))
    return ga, gb


def _max0_grad(x, g):
    """``max0``'s gradient: half at a tie, whole above 0, none below (and
    none for NaN)."""
    return torch.where(x == 0.0, 0.5 * g, torch.where(x >= 0.0, g, 0.0))


def _sh_direction_grads(t, d_basis, sh_order):
    """The SH bases' gradients carried to the view direction (dxn, dyn, dzn)."""
    x, y, z = t.dirs
    d_x = -SH_C1 * d_basis[2]
    d_y = -SH_C1 * d_basis[0]
    d_z = SH_C1 * d_basis[1]
    if sh_order < 2:
        return d_x, d_y, d_z
    xx, yy, zz, xy, yz, xz = t.prods
    d_xy = SH_C2[0] * d_basis[3]
    d_yz = SH_C2[1] * d_basis[4]
    e = SH_C2[2] * d_basis[5]
    d_zz = 2.0 * e
    d_xx = -e
    d_yy = -e
    d_xz = SH_C2[3] * d_basis[6]
    e = SH_C2[4] * d_basis[7]
    d_xx = d_xx + e
    d_yy = d_yy - e
    if sh_order >= 3:
        # b8 = (C·y)·(3xx − yy)
        e = d_basis[8] * (SH_C3[0] * y)
        d_y = d_y + SH_C3[0] * (d_basis[8] * (3.0 * xx - yy))
        d_xx = d_xx + 3.0 * e
        d_yy = d_yy - e
        # b9 = (C·xy)·z
        d_xy = d_xy + SH_C3[1] * (d_basis[9] * z)
        d_z = d_z + d_basis[9] * (SH_C3[1] * xy)
        # b10 = (C·y)·(4zz − xx − yy)
        e = d_basis[10] * (SH_C3[2] * y)
        d_y = d_y + SH_C3[2] * (d_basis[10] * (4.0 * zz - xx - yy))
        d_zz = d_zz + 4.0 * e
        d_xx = d_xx - e
        d_yy = d_yy - e
        # b11 = (C·z)·(2zz − 3xx − 3yy)
        e = d_basis[11] * (SH_C3[3] * z)
        d_z = d_z + SH_C3[3] * (d_basis[11] * (2.0 * zz - 3.0 * xx - 3.0 * yy))
        d_zz = d_zz + 2.0 * e
        d_xx = d_xx - 3.0 * e
        d_yy = d_yy - 3.0 * e
        # b12 = (C·x)·(4zz − xx − yy)
        e = d_basis[12] * (SH_C3[4] * x)
        d_x = d_x + SH_C3[4] * (d_basis[12] * (4.0 * zz - xx - yy))
        d_zz = d_zz + 4.0 * e
        d_xx = d_xx - e
        d_yy = d_yy - e
        # b13 = (C·z)·(xx − yy)
        e = d_basis[13] * (SH_C3[5] * z)
        d_z = d_z + SH_C3[5] * (d_basis[13] * (xx - yy))
        d_xx = d_xx + e
        d_yy = d_yy - e
        # b14 = (C·x)·(xx − 3yy)
        e = d_basis[14] * (SH_C3[6] * x)
        d_x = d_x + SH_C3[6] * (d_basis[14] * (xx - 3.0 * yy))
        d_xx = d_xx + e
        d_yy = d_yy - 3.0 * e
    d_x = d_x + 2.0 * x * d_xx + y * d_xy + z * d_xz
    d_y = d_y + 2.0 * y * d_yy + x * d_xy + z * d_yz
    d_z = d_z + 2.0 * z * d_zz + y * d_yz + x * d_xz
    return d_x, d_y, d_z


def _axes_vjp(t, g, tight_footprint):
    """Rows 2..5 (the quad basis) and 12..13 (the footprint) of the
    cotangent ``g`` carried back to the 2D covariance (cov_a, cov_b, cov_c)
    through the eigen decomposition, with autograd's own operations and its
    sums in the order its engine adds them: near an axis-aligned eigenvector
    inv_norm reaches ~1e5 and the terms below cancel, so any other order
    rounds to other ulps of inv_norm·|g|, which the sharded renderer's
    gradient gate sees."""
    def footprint(gh, v1, v2):
        """Rows 12/13's contributions to (v1, v2), each sum in order."""
        if tight_footprint:
            l1 = QUAD_EXTENT * (torch.abs(v1) + torch.abs(v2))
            sq = torch.sqrt(v1 * v1 + v2 * v2)
            l2 = t.rho * sq
            tie_g = torch.where(l1 == l2, gh / 2, gh)
            g_l1 = torch.where(l1 > l2, 0.0, tie_g)
            g_l2 = torch.where(l1 < l2, 0.0, tie_g)
            d_q = (g_l2 * t.rho) / (2 * sq)
            s_g = g_l1 * QUAD_EXTENT
            return (d_q * v1 + d_q * v1 + s_g * torch.sign(v1), d_q * v2 + d_q * v2 + s_g * torch.sign(v2))
        s_g = gh * QUAD_EXTENT
        return s_g * torch.sign(v1), s_g * torch.sign(v2)

    fx1, fx2 = footprint(g[12], t.v1x, t.v2x)
    fy1, fy2 = footprint(g[13], t.v1y, t.v2y)
    d_v1x = fx1 + g[2] * t.inv_l1
    d_v1y = fy1 + g[3] * t.inv_l1
    d_v2x = fx2 + g[4] * t.inv_l2
    d_v2y = fy2 + g[5] * t.inv_l2
    d_il1 = g[3] * t.v1y + g[2] * t.v1x
    d_il2 = g[5] * t.v2y + g[4] * t.v2x
    len1, len2, dx_, dy_ = t.len1, t.len2, t.dx_, t.dy_
    nl2 = -len2
    # 1/(len·len) is reciprocal(len·len)·1.0
    d_ll1 = -(d_il1 * 1.0) * (t.inv_l1 * t.inv_l1)
    d_ll2 = -(d_il2 * 1.0) * (t.inv_l2 * t.inv_l2)
    d_len1 = d_ll1 * len1 + d_ll1 * len1 + d_v1y * dy_ + d_v1x * dx_
    d_nl2 = d_v2y * dx_
    d_dx = d_v2y * nl2 + d_v1x * len1
    d_len2 = d_ll2 * len2 + d_ll2 * len2 + (-d_nl2) + d_v2x * dy_
    d_dy = d_v2x * len2 + d_v1y * len1
    d_t1 = torch.where(t.s1 <= AXIS_MAX_PX, d_len1, 0.0) / (2.0 * t.s1)
    d_t2 = torch.where(t.s2 <= AXIS_MAX_PX, d_len2, 0.0) / (2.0 * t.s2)
    d_l2 = d_t2 * 2.0
    safe, inv_norm, ex, ey = t.safe, t.inv_norm, t.ex, t.ey
    d_eyn = torch.where(safe, -d_dy, 0.0)
    d_exn = torch.where(safe, d_dx, 0.0)
    d_inv = torch.where(safe, d_eyn * ey + d_exn * ex, 0.0)
    r = torch.where(safe, inv_norm, 1.0)  # rsqrt(where(safe, norm_sq, 1))
    d_nsq = torch.where(safe, (-0.5 * d_inv) * (r * r * r), 0.0)
    d_ey = d_eyn * inv_norm + d_nsq * ey + d_nsq * ey
    d_l2raw = torch.where(t.l2raw >= LAMBDA2_MIN, d_l2, 0.0)
    d_l1 = d_t1 * 2.0 + d_ey
    d_mid = d_l2raw + d_l1
    d_rad = (-d_l2raw) + d_l1
    d_rr = torch.where(t.rr >= 1e-18, d_rad / (2.0 * t.radius), 0.0)
    d_hd2 = d_rr * (2.0 * t.hd)
    d_ac = d_hd2 / 2.0
    d_sac = d_mid * 0.5
    d_cov_a = (-d_ey) + d_ac + d_sac
    d_cov_b = d_exn * inv_norm + d_nsq * ex + d_nsq * ex + d_rr * (2.0 * t.cov_b)
    d_cov_c = (-d_ac) + d_sac
    return d_cov_a, d_cov_b, d_cov_c


def project_fields_bwd_plain(pos, orient, scale, opacity, color, sh, view, proj, cam_pos, width, height,
                             sh_order, tight_footprint, only_sh, grad, masked=False):
    """Plain PyTorch version of the backward kernel: the analytic VJP of
    :func:`project_fields_plain` for the ``(16, N)`` cotangent ``grad``, in
    the kernel's order.  Returns ``(d_pos, d_orient, d_scale, d_opacity,
    d_color, d_sh)``; ``d_color`` is None with ``only_sh`` and ``d_sh`` None
    at ``sh_order`` 0 (the forward does not read them).  ``d_opacity`` is a
    view of row 9 of ``grad``, and ``d_color`` at ``sh_order`` 0 a view of
    rows 6..8: the forward passes those through unchanged.

    ``masked``: ``grad`` is the cotangent of the sanitized fields (the
    forward's payload form), and sanitize's VJP zeroes an invalid splat's
    column of it first."""
    _, t = _project(pos, orient, scale, opacity, color, sh, view, proj, cam_pos, width, height,
                    sh_order, tight_footprint, only_sh)
    if masked:
        grad = torch.where(t.valid, grad, 0.0)
    g = grad.unbind(0)
    zero = torch.zeros_like(opacity)

    # --- colour (rows 6..8) and the depth key (row 10) ---
    gc = [g[6], g[7], g[8]]
    d_t = [zero, zero, zero]
    d_sh = None
    d_depth = g[10]
    if sh_order > 0:
        gc = [_max0_grad(x, gi) for x, gi in zip(t.pre, gc)]
        shr = sh.unbind(0)
        rows = [zero] * 45
        d_basis = [zero] * 15
        for basis, j in t.terms:
            for c in range(3):
                rows[3 * j + c] = basis * gc[c]
            d_basis[j] = shr[3 * j] * gc[0] + shr[3 * j + 1] * gc[1] + shr[3 * j + 2] * gc[2]
        d_sh = torch.stack(rows)
        d_x, d_y, d_z = _sh_direction_grads(t, d_basis, sh_order)
        inv_n = t.inv_n
        d_inv_n = d_x * t.tx + d_y * t.ty + d_z * t.tz
        d_t = [d_x * inv_n, d_y * inv_n, d_z * inv_n]
        d_dsq_c = -0.5 * d_inv_n * (inv_n * inv_n * inv_n)
        d_depth = d_depth + torch.where(t.depth_sq >= 1e-24, d_dsq_c, 0.0)
    d_color = None if only_sh else torch.stack(gc) if sh_order > 0 else grad[6:9]
    d_pos_t = [d_t[0] + 2.0 * t.tx * d_depth, d_t[1] + 2.0 * t.ty * d_depth, d_t[2] + 2.0 * t.tz * d_depth]

    # --- quad basis (rows 2..5), footprint (rows 12..13) → 2D covariance ---
    d_cov_a, d_cov_b, d_cov_c = _axes_vjp(t, g, tight_footprint)

    # --- EWA: 2D covariance → (a, gx, gy) and C ---
    a_, gx_, gy_ = t.a_, t.gx_, t.gy_
    d_cu00 = d_cov_a * a_
    d_cu02 = d_cov_a * gx_
    d_cu10 = d_cov_b * a_
    d_cu12 = d_cov_b * gx_ + d_cov_c * gy_
    d_cu11 = d_cov_c * a_
    d_a = (d_cov_a * t.cu0_0 + d_cov_b * t.cu1_0 + d_cov_c * t.cu1_1
           + d_cu00 * t.c00 + d_cu02 * t.c02 + d_cu11 * t.c11 + d_cu10 * t.c01 + d_cu12 * t.c12)
    d_gx = d_cov_a * t.cu0_2 + d_cov_b * t.cu1_2 + d_cu00 * t.c02 + d_cu02 * t.c22
    d_gy = d_cov_c * t.cu1_2 + d_cu11 * t.c12 + d_cu10 * t.c02 + d_cu12 * t.c22
    d_c = {
        (0, 0): d_cu00 * a_,
        (0, 1): d_cu10 * a_,
        (0, 2): d_cu00 * gx_ + d_cu02 * a_ + d_cu10 * gy_,
        (1, 1): d_cu11 * a_,
        (1, 2): d_cu11 * gy_ + d_cu12 * a_,
        (2, 2): d_cu02 * gx_ + d_cu12 * gy_,
    }
    # a = f·iz, gx = ((−f·vxc)·iz)·iz, gy likewise
    inv_z, vzc, focal = t.inv_z, t.vzc, t.focal
    d_inv_z = focal * d_a - 2.0 * inv_z * (focal * (d_gx * t.vxc + d_gy * t.vyc))
    iz2 = inv_z * inv_z
    d_vxc = -focal * (d_gx * iz2)
    d_vyc = -focal * (d_gy * iz2)
    d_vzc = -d_inv_z * iz2
    # vxc = clamp(vx/vzc)·vzc
    d_vxy = []
    for d_vc, tq, lim in ((d_vxc, t.tx_, t.lim_x), (d_vyc, t.ty_, t.lim_y)):
        inside = (tq >= -lim) & (tq <= lim)
        d_tq = torch.where(inside, d_vc * vzc, 0.0)
        d_vzc = d_vzc + d_vc * torch.clamp(tq, min=-lim, max=lim) - d_tq * tq / vzc
        d_vxy.append(d_tq / vzc)
    d_vx, d_vy = d_vxy
    d_vz = torch.where(t.vz_ <= -1e-6, d_vzc, 0.0) - g[14]

    # C = Rv Σ Rvᵀ → the six σ
    rv = view[:3, :3]
    d_sig = [zero] * 6
    for i, j in _C_ENTRIES:
        for k in range(3):
            for l in range(3):
                s = _SIG[(k, l)]
                d_sig[s] = d_sig[s] + (rv[i, k] * rv[j, l]) * d_c[(i, j)]
    # Σ = MᵀM → M
    m = t.m
    d_m = [[None] * 3 for _ in range(3)]
    for r in range(3):
        for i in range(3):
            acc = None
            for j in range(3):
                s = _SIG[(i, j)]
                term = (2.0 * m[r][i] if i == j else m[r][j]) * d_sig[s]
                acc = term if acc is None else acc + term
            d_m[r][i] = acc
    # M = S·R → scale and the rotation entries
    qx, qy, qz, qw = orient.unbind(0)
    sx, sy, sz = scale.unbind(0)
    rot = (
        (1.0 - 2.0 * (qy * qy + qz * qz), 2.0 * (qx * qy + qw * qz), 2.0 * (qx * qz - qw * qy)),
        (2.0 * (qx * qy - qw * qz), 1.0 - 2.0 * (qx * qx + qz * qz), 2.0 * (qy * qz + qw * qx)),
        (2.0 * (qx * qz + qw * qy), 2.0 * (qy * qz - qw * qx), 1.0 - 2.0 * (qx * qx + qy * qy)),
    )
    d_scale = torch.stack([d_m[r][0] * rot[r][0] + d_m[r][1] * rot[r][1] + d_m[r][2] * rot[r][2]
                           for r in range(3)])
    d_r = [[d_m[r][i] * s for i in range(3)] for r, s in enumerate((sx, sy, sz))]
    d_qx = 2.0 * (qy * (d_r[0][1] + d_r[1][0]) + qz * (d_r[0][2] + d_r[2][0]) + qw * (d_r[1][2] - d_r[2][1])
                  - 2.0 * qx * (d_r[1][1] + d_r[2][2]))
    d_qy = 2.0 * (qx * (d_r[0][1] + d_r[1][0]) + qz * (d_r[1][2] + d_r[2][1]) + qw * (d_r[2][0] - d_r[0][2])
                  - 2.0 * qy * (d_r[0][0] + d_r[2][2]))
    d_qz = 2.0 * (qx * (d_r[0][2] + d_r[2][0]) + qy * (d_r[1][2] + d_r[2][1]) + qw * (d_r[0][1] - d_r[1][0])
                  - 2.0 * qz * (d_r[0][0] + d_r[1][1]))
    d_qw = 2.0 * (qx * (d_r[1][2] - d_r[2][1]) + qy * (d_r[2][0] - d_r[0][2]) + qz * (d_r[0][1] - d_r[1][0]))
    d_orient = torch.stack([d_qx, d_qy, d_qz, d_qw])

    # --- center: mean (rows 0..1) → clip → view ---
    hw, hh = 0.5 * width, 0.5 * height
    safe_w = t.safe_w
    d_ndc_x = g[0] * hw
    d_ndc_y = -(g[1] * hh)
    d_cx = d_ndc_x / safe_w
    d_cy = d_ndc_y / safe_w
    d_cw = torch.where(t.valid, -(d_cx * t.ndc_x + d_cy * t.ndc_y), 0.0)
    d_v = [None, None, None]
    for c, d_extra in enumerate((d_vx, d_vy, d_vz)):
        d_v[c] = proj[0, c] * d_cx + proj[1, c] * d_cy + proj[3, c] * d_cw + d_extra
    d_pos = torch.stack([
        view[0, c] * d_v[0] + view[1, c] * d_v[1] + view[2, c] * d_v[2] + d_pos_t[c] for c in range(3)
    ])
    return d_pos, d_orient, d_scale, g[9], d_color, d_sh


# ----------------------------------------------------------------- kernels

_SPLAT_ROWS = (("pos", 3), ("orient", 4), ("scale", 3), ("opacity", None), ("color", 3), ("sh", 45))


def _check(tensors, view, proj, cam_pos, sh_order):
    """Shapes, dtypes and devices of the inputs (float32 throughout)."""
    if not 0 <= sh_order <= 3:
        raise ValueError(f"sh_order must be in [0, 3], got {sh_order}")
    n = tensors[0].shape[-1]
    dev = tensors[0].device
    named = [(name, t, (n,) if rows is None else (rows, n)) for (name, rows), t in zip(_SPLAT_ROWS, tensors)]
    named += [("view", view, (4, 4)), ("proj", proj, (4, 4)), ("cam_pos", cam_pos, (3,))]
    for name, t, shape in named:
        if tuple(t.shape) != shape or t.dtype != torch.float32:
            raise TypeError(f"{name}: expected {shape} float32, got {tuple(t.shape)} {t.dtype}")
        if t.device != dev:
            raise ValueError("all projection inputs must live on one device")
    return n


def payload_fields_plain(fields: torch.Tensor, payload_dtype: str) -> torch.Tensor:
    """Plain PyTorch version of ``project_fwd``'s payload policy:
    ``sanitize_projected`` then ``quantize_payload`` (``ops/rasterize_ref.py``)
    of a ``(16, N)`` field matrix."""
    # imported here: ops/rasterize_ref.py imports ops/projection.py, which
    # imports this module
    from ...utils.config import RenderConfig
    from ..projection import ProjectedSplats
    from ..rasterize_ref import quantize_payload, sanitize_projected

    p = sanitize_projected(ProjectedSplats(fields=fields))
    return quantize_payload(p, RenderConfig(payload_dtype=payload_dtype)).fields


def project_fields(pos, orient, scale, opacity, color, sh, view, proj, cam_pos, width, height,
                   sh_order=3, tight_footprint=False, only_sh=False, payload_dtype=None) -> torch.Tensor:
    """The ``(16, N)`` field matrix (``ops/projection.py``'s rows).

    ``payload_dtype`` (``"float32"``, ``"packed"`` or ``"bfloat16"``): the fields
    come back sanitized (an invalid column holds ``_BENIGN``'s values, its
    depth +inf) and quantized to that payload precision, as
    :func:`payload_fields_plain` makes them (:class:`ProjectSplats`
    differentiates them).
    On the card this form is splat-major in memory (the transposed view of
    an ``(N, 16)`` matrix: a column's 16 words are contiguous), the layout
    ``gather_payload`` reads fastest.

    On CUDA tensors this launches ``project_fwd`` (or raises); on CPU tensors
    it takes :func:`project_fields_plain` (and :func:`payload_fields_plain`)."""
    global launches_fwd, launches_fwd_payload
    if payload_dtype not in PAYLOAD_CODE:
        raise ValueError(f"payload_dtype must be one of {tuple(PAYLOAD_CODE)}, got {payload_dtype!r}")
    inputs = (pos, orient, scale, opacity, color, sh)
    n = _check(inputs, view, proj, cam_pos, sh_order)
    if not pos.is_cuda:
        out = project_fields_plain(*inputs, view, proj, cam_pos, width, height, sh_order, tight_footprint, only_sh)
        return out if payload_dtype is None else payload_fields_plain(out, payload_dtype)
    if payload_dtype is None:
        out = torch.empty((N_FIELDS, n), dtype=torch.float32, device=pos.device)
    else:
        out = torch.empty((n, N_FIELDS), dtype=torch.float32, device=pos.device).T
    if n == 0:
        return out
    args = [t.contiguous() for t in inputs + (view, proj, cam_pos)]
    lib = _library()
    with torch.cuda.device(pos.device):
        err = lib.gsplat_project_fwd(
            *[t.data_ptr() for t in args], out.data_ptr(), n, int(width), int(height), int(sh_order),
            int(bool(tight_footprint)), int(bool(only_sh)), PAYLOAD_CODE[payload_dtype],
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"gsplat_project_fwd launch failed: CUDA error {err}")
    launches_fwd += 1
    launches_fwd_payload += int(payload_dtype is not None)
    return out


def project_fields_bwd(pos, orient, scale, opacity, color, sh, view, proj, cam_pos, width, height,
                       sh_order, tight_footprint, only_sh, grad, masked=False):
    """The six input gradients for the ``(16, N)`` cotangent ``grad``
    (:func:`project_fields_bwd_plain`'s outputs: the opacity's, and the
    colour's at ``sh_order`` 0, are views of ``grad``'s rows, but with
    ``masked``).  ``masked``: ``grad`` is the cotangent of the sanitized
    fields, zeroed in an invalid splat's column (sanitize's VJP); the kernel
    then also reads it splat-major, as ``scatter_payload`` writes it.

    On CUDA tensors this launches ``project_bwd`` (or raises); on CPU tensors
    it takes :func:`project_fields_bwd_plain`."""
    global launches_bwd
    inputs = (pos, orient, scale, opacity, color, sh)
    n = _check(inputs, view, proj, cam_pos, sh_order)
    if tuple(grad.shape) != (N_FIELDS, n) or grad.dtype != torch.float32 or grad.device != pos.device:
        raise TypeError(f"grad: expected ({N_FIELDS}, {n}) float32 on {pos.device}, got "
                        f"{tuple(grad.shape)} {grad.dtype} on {grad.device}")
    if not pos.is_cuda:
        return project_fields_bwd_plain(*inputs, view, proj, cam_pos, width, height, sh_order,
                                        tight_footprint, only_sh, grad, masked)
    if not (masked and grad.stride() == (1, N_FIELDS)):
        grad = grad.contiguous()

    def new(rows):  # row-major whatever the strides of the input it matches
        return torch.empty((rows, n), dtype=torch.float32, device=pos.device)

    d_color = None if only_sh else new(3) if sh_order > 0 or masked else grad[6:9]
    d_sh = new(45) if sh_order > 0 else None
    d_opacity = new(1)[0] if masked else grad[9]
    outs = (new(3), new(4), new(3), d_opacity, d_color, d_sh)
    if n == 0:
        return outs
    written = [o.data_ptr() for o in outs[:3]] + [
        None if o is None or (k == 0 and sh_order == 0 and not masked) else o.data_ptr()
        for k, o in enumerate(outs[4:])] + [d_opacity.data_ptr() if masked else None]
    args = [t.contiguous() for t in inputs + (view, proj, cam_pos)] + [grad]
    lib = _library()
    with torch.cuda.device(pos.device):
        err = lib.gsplat_project_bwd(
            *[t.data_ptr() for t in args], *written, n, grad.stride(0), grad.stride(1),
            int(width), int(height), int(sh_order), int(bool(tight_footprint)), int(bool(only_sh)),
            int(bool(masked)), torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"gsplat_project_bwd launch failed: CUDA error {err}")
    launches_bwd += 1
    return outs


class ProjectSplats(torch.autograd.Function):
    """Differentiable projection through the two kernels (on CPU tensors
    through their plain versions, the same structure up to the launch).
    Autograd saves only the inputs: the backward recomputes the forward's
    intermediates.  Gradients flow to the six splat fields; the camera takes
    none.  With a ``payload_dtype`` the forward writes the sanitized,
    quantized fields (:func:`project_fields`), and the backward is
    sanitize's VJP (an invalid column's cotangent zeroed, the ``masked``
    form of :func:`project_fields_bwd`) after quantize's, the identity."""

    @staticmethod
    def forward(ctx, pos, orient, scale, opacity, color, sh, view, proj, cam_pos, width, height,
                sh_order, tight_footprint, only_sh, payload_dtype=None):
        ctx.static = (width, height, sh_order, tight_footprint, only_sh)
        ctx.masked = payload_dtype is not None
        ctx.save_for_backward(pos, orient, scale, opacity, color, sh, view, proj, cam_pos)
        return project_fields(pos, orient, scale, opacity, color, sh, view, proj, cam_pos, *ctx.static,
                              payload_dtype=payload_dtype)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        saved = ctx.saved_tensors
        g = g.to(torch.float32)
        # the payload form's cotangent may come splat-major (scatter_payload)
        grads = project_fields_bwd(*saved, *ctx.static, g if ctx.masked else g.contiguous(), masked=ctx.masked)
        return (*grads, None, None, None, None, None, None, None, None, None)

