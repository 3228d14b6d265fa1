"""Plain PyTorch reference of one frame of a Gaussian-splat scene.

It states the frame the renderer under test promises, and imports nothing of
that renderer:

* projection: EWA splatting of each splat's 3D covariance with a +0.3 px
  low-pass, the 2x2 eigen axes, the quad basis A = v1/|v1|^2, B = v2/|v2|^2,
  the opacity-tight binning footprint, the squared distance to the camera
  as the depth key and the view-dependent colour of SH degree <= 3;
* payload precision: colour and opacity rounded to bfloat16 when the
  configuration's payload is ``packed``;
* order: one stable sort of the squared distance, front to back;
* tiles: 32x32 pixels; a splat covers the tiles its footprint's box
  touches, less the tiles a separating-axis test proves it cannot light
  (below 2^22 splats); each tile's pairs in depth order, laid end to end
  in tile order;
* compositing: alpha = min(exp(-(qx^2 + qy^2)) * opacity, 0.99), kept only
  where max(qx^2, qy^2) <= 4 and alpha >= 1/255, blended front to back into
  premultiplied RGBA.  A tile stops once every pixel's transmittance is at
  or below ``transmittance_eps``, tested after each step of ``chunk`` pair
  positions of the pair array, the steps aligned to multiples of ``chunk``
  from the array's start: the early stop is part of the frame's contract.

Every operation is a separately rounded PyTorch operation in the order the
contract writes it, so the same arithmetic on the same card gives the same
float32 words.  Differentiable by autograd (the compositing steps are
recomputed in the backward, so memory stays bounded).  ``dtype`` runs the
whole chain in another floating type: the benchmark's lower-precision
control.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

FOV_CLAMP = 1.3
COV2D_DILATION = 0.3
LAMBDA2_MIN = 0.1
AXIS_MAX_PX = 4096.0
QUAD_EXTENT = 2.0
ALPHA_CUTOFF = 1.0 / 255.0
MAX_ALPHA = 0.99
TILE = 32
# The separating-axis cull is skipped above this many splats (the renderer's
# documented default, GSPLAT_SAT_MAX_N).
SAT_MAX_N = 4_194_304

SH_C1 = 0.4886025
SH_C2 = (1.0925484, -1.0925484, 0.3153916, -1.0925484, 0.5462742)
SH_C3 = (-0.5900436, 2.8906114, -0.4570458, 0.3731763, -0.4570458, 1.4453057, -0.5900436)

# Values of a splat behind the camera: far off screen, no colour, +inf depth.
BENIGN = (-1e7, -1e7, 1.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0, float("inf"), 0.0, 0.0, 0.0, 0.0, 0.0)


# The keys of a configuration's ``render`` entry, each with the values this
# frame states (None: any).  The tile capacity and the pair budget leave the
# image as it is wherever they drop no pair; a frame that drops one is the
# run's to count as failed.
SETTINGS = {
    "width": None, "height": None, "sh_order": (0, 1, 2, 3), "chunk": None, "transmittance_eps": None,
    "payload_dtype": ("float32", "packed"),
    "tile_capacity": None, "pairs_per_splat": None, "pair_budget_override": None, "warn_on_drop": None,
    "max_alpha": (MAX_ALPHA,), "tile_h": (TILE,), "tile_w": (TILE,),
    "soft_cutoff": (False,), "only_sh": (False,), "wireframe": (False,), "depth_test": (False,),
}


def settings(cfg: Dict) -> Dict:
    """``cfg``, a configuration's ``render`` entry, where this frame states
    every key and value of it; otherwise ValueError."""
    for key, value in cfg.items():
        if key not in SETTINGS:
            raise ValueError(f"the reference states no render setting {key!r}")
        allowed = SETTINGS[key]
        if allowed is not None and value not in allowed:
            raise ValueError(f"the reference states {key} only as one of {allowed}, not {value!r}")
    return cfg


class Frame(NamedTuple):
    image: torch.Tensor              # (H, W, 4) premultiplied RGBA
    counts: Dict[str, int]           # work of the frame (see composite)


def max0(x):
    """max(x, 0) whose gradient at x == 0 is halved."""
    return torch.where(x == 0.0, 0.5 * x, torch.clamp(x, min=0.0))


def round_bf16(x):
    """Round to bfloat16 and back, with the identity as its gradient."""
    return x + (x.to(torch.bfloat16).to(x.dtype) - x).detach()


def project(pos, orient, scale, opacity, color, sh, view, proj, cam_pos, width, height, sh_order=3):
    """(16, N) fields: cx, cy, Ax, Ay, Bx, By, r, g, b, opacity, depth_sq,
    valid, half_x, half_y, view_z, 0.  Splat tensors as (3, N), (4, N) xyzw,
    (3, N), (N,), (3, N), (45, N); view, proj (4, 4); cam_pos (3,)."""
    px_, py_, pz_ = pos.unbind(0)

    def xform3(m, x, y, z):
        return [m[i, 0] * x + m[i, 1] * y + m[i, 2] * z + m[i, 3] for i in range(3)]

    vx_, vy_, vz_ = xform3(view, px_, py_, pz_)
    cx_, cy_, _ = xform3(proj, vx_, vy_, vz_)
    cw_ = proj[3, 0] * vx_ + proj[3, 1] * vy_ + proj[3, 2] * vz_ + proj[3, 3]
    valid = cw_ > 0.0
    safe_w = torch.where(valid, cw_, 1.0)
    mean_x = (cx_ / safe_w + 1.0) * (0.5 * width)
    mean_y = (1.0 - cy_ / safe_w) * (0.5 * height)

    # M = S R from the quaternion, Sigma = M^T M
    qx, qy, qz, qw = orient.unbind(0)
    sx, sy, sz = scale.unbind(0)
    m = ((sx * (1.0 - 2.0 * (qy * qy + qz * qz)), sx * (2.0 * (qx * qy + qw * qz)), sx * (2.0 * (qx * qz - qw * qy))),
         (sy * (2.0 * (qx * qy - qw * qz)), sy * (1.0 - 2.0 * (qx * qx + qz * qz)), sy * (2.0 * (qy * qz + qw * qx))),
         (sz * (2.0 * (qx * qz + qw * qy)), sz * (2.0 * (qy * qz - qw * qx)), sz * (1.0 - 2.0 * (qx * qx + qy * qy))))

    def s(i, j):
        return m[0][i] * m[0][j] + m[1][i] * m[1][j] + m[2][i] * m[2][j]

    sig = {(0, 0): s(0, 0), (0, 1): s(0, 1), (0, 2): s(0, 2), (1, 1): s(1, 1), (1, 2): s(1, 2), (2, 2): s(2, 2)}
    sig[(1, 0)], sig[(2, 0)], sig[(2, 1)] = sig[(0, 1)], sig[(0, 2)], sig[(1, 2)]

    p00, p11 = proj[0, 0], proj[1, 1]
    aspect = p00 / p11
    lim_x = FOV_CLAMP / p00
    lim_y = FOV_CLAMP / (p11 * aspect)
    vzc = torch.clamp(vz_, max=-1e-6)
    vxc = torch.clamp(vx_ / vzc, min=-lim_x, max=lim_x) * vzc
    vyc = torch.clamp(vy_ / vzc, min=-lim_y, max=lim_y) * vzc
    focal = width * p00 / 2.0

    # C = Rv Sigma Rv^T
    rv = view[:3, :3]

    def c_entry(i, j):
        acc = None
        for k in range(3):
            for l in range(3):
                term = (rv[i, k] * rv[j, l]) * sig[(k, l)]
                acc = term if acc is None else acc + term
        return acc

    c00, c01, c02, c11, c12, c22 = (c_entry(i, j) for i, j in ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2)))
    inv_z = 1.0 / vzc
    a_ = focal * inv_z
    gx_ = -focal * vxc * inv_z * inv_z
    gy_ = -focal * vyc * inv_z * inv_z
    cu0_0 = a_ * c00 + gx_ * c02
    cu0_2 = a_ * c02 + gx_ * c22
    cu1_1 = a_ * c11 + gy_ * c12
    cu1_0 = a_ * c01 + gy_ * c02
    cu1_2 = a_ * c12 + gy_ * c22
    cov_a = a_ * cu0_0 + gx_ * cu0_2 + COV2D_DILATION
    cov_b = a_ * cu1_0 + gx_ * cu1_2
    cov_c = a_ * cu1_1 + gy_ * cu1_2 + COV2D_DILATION

    # eigen axes of the 2D covariance, y flipped into image space
    mid = 0.5 * (cov_a + cov_c)
    hd = (cov_a - cov_c) / 2.0
    radius = torch.sqrt(torch.clamp(torch.square(hd) + torch.square(cov_b), min=1e-18))
    lambda1 = mid + radius
    lambda2 = torch.clamp(mid - radius, min=LAMBDA2_MIN)
    ex = cov_b
    ey = lambda1 - cov_a
    norm_sq = ex * ex + ey * ey
    safe = norm_sq > 1e-24
    inv_norm = torch.where(safe, torch.rsqrt(torch.where(safe, norm_sq, 1.0)), 0.0)
    dx_ = torch.where(safe, ex * inv_norm, 1.0)
    dy_ = -torch.where(safe, ey * inv_norm, 0.0)
    len1 = torch.clamp(torch.sqrt(2.0 * lambda1), max=AXIS_MAX_PX)
    len2 = torch.clamp(torch.sqrt(2.0 * lambda2), max=AXIS_MAX_PX)
    v1x, v1y = len1 * dx_, len1 * dy_
    v2x, v2y = len2 * dy_, -len2 * dx_
    inv_l1 = 1.0 / (len1 * len1)
    inv_l2 = 1.0 / (len2 * len2)

    # the box of the live region: the quad's box, tightened to the disc of
    # radius rho = sqrt(ln(opacity / cutoff)) outside which alpha < 1/255
    rho = torch.sqrt(torch.clamp(torch.log(torch.clamp(opacity, min=1e-20) / ALPHA_CUTOFF), min=0.0)).detach()
    half_x = torch.minimum(QUAD_EXTENT * (torch.abs(v1x) + torch.abs(v2x)), rho * torch.sqrt(v1x * v1x + v2x * v2x))
    half_y = torch.minimum(QUAD_EXTENT * (torch.abs(v1y) + torch.abs(v2y)), rho * torch.sqrt(v1y * v1y + v2y * v2y))

    tx, ty, tz = px_ - cam_pos[0], py_ - cam_pos[1], pz_ - cam_pos[2]
    depth_sq = tx * tx + ty * ty + tz * tz
    r_, g_, b_ = color.unbind(0)
    if sh_order > 0:
        inv_n = torch.rsqrt(torch.clamp(depth_sq, min=1e-24))
        x, y, z = tx * inv_n, ty * inv_n, tz * inv_n
        terms = [(-SH_C1 * y, 0), (SH_C1 * z, 1), (-SH_C1 * x, 2)]
        if sh_order >= 2:
            xx, yy, zz, xy, yz, xz = x * x, y * y, z * z, x * y, y * z, x * z
            terms += [(SH_C2[0] * xy, 3), (SH_C2[1] * yz, 4), (SH_C2[2] * (2.0 * zz - xx - yy), 5),
                      (SH_C2[3] * xz, 6), (SH_C2[4] * (xx - yy), 7)]
            if sh_order >= 3:
                terms += [(SH_C3[0] * y * (3.0 * xx - yy), 8), (SH_C3[1] * xy * z, 9),
                          (SH_C3[2] * y * (4.0 * zz - xx - yy), 10),
                          (SH_C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy), 11),
                          (SH_C3[4] * x * (4.0 * zz - xx - yy), 12), (SH_C3[5] * z * (xx - yy), 13),
                          (SH_C3[6] * x * (xx - 3.0 * yy), 14)]
        shr = sh.unbind(0)
        for basis, j in terms:
            r_ = r_ + basis * shr[3 * j]
            g_ = g_ + basis * shr[3 * j + 1]
            b_ = b_ + basis * shr[3 * j + 2]
        r_, g_, b_ = max0(r_), max0(g_), max0(b_)
    return torch.stack([mean_x, mean_y, v1x * inv_l1, v1y * inv_l1, v2x * inv_l2, v2y * inv_l2, r_, g_, b_, opacity,
                        depth_sq, valid.to(pos.dtype), half_x, half_y, -vz_, torch.zeros_like(opacity)], dim=0)


def payload(fields, packed):
    """Splats behind the camera take the benign values; with a packed
    payload, colour and opacity are rounded to bfloat16."""
    benign = torch.tensor(BENIGN, dtype=fields.dtype, device=fields.device)[:, None]
    f = torch.where(fields[11:12] > 0.5, fields, benign)
    if packed:
        f = torch.cat([f[:6], round_bf16(f[6:10]), f[10:]], dim=0)
    return f


def _floor_i32(x):
    return torch.clamp(torch.floor(x), -float(1 << 30), float(1 << 30)).to(torch.int32)


def bin_tiles(f, width, height, sat_cull):
    """Pairs of the depth-ordered fields ``f``: ``(rank, start, count)``
    with ``rank`` (P,) the depth rank of each pair, tile-major and front to
    back within a tile, and ``start``/``count`` (T,) each tile's segment."""
    dev = f.device
    nty, ntx = -(-height // TILE), -(-width // TILE)
    num_tiles = nty * ntx
    n = f.shape[1]
    f32 = f.float()

    def axis(lo, hi, nt):
        g0, g1 = _floor_i32(lo / float(TILE)), _floor_i32(hi / float(TILE))
        empty = (g1 < g0) | (g1 < 0) | (g0 > nt - 1)
        return torch.clamp(g0, 0, nt - 1), torch.clamp(g1, 0, nt - 1), empty

    tx0, tx1, ex = axis(f32[0] - f32[12], f32[0] + f32[12], ntx)
    ty0, ty1, ey = axis(f32[1] - f32[13], f32[1] + f32[13], nty)
    cull = (f32[11] < 0.5) | (f32[9] < ALPHA_CUTOFF) | ex | ey
    nx = torch.where(cull, 0, tx1 - tx0 + 1)
    ny = torch.where(cull, 0, ty1 - ty0 + 1)
    counts = (nx * ny).long()
    rank = torch.repeat_interleave(torch.arange(n, device=dev), counts)
    r = torch.arange(rank.numel(), device=dev) - torch.repeat_interleave(torch.cumsum(counts, 0) - counts, counts)
    nx_r = nx.long().clamp(min=1)[rank]
    dty = torch.div(r, nx_r, rounding_mode="floor")
    dtx = r - dty * nx_r
    tyy = ty0.long()[rank] + dty
    txx = tx0.long()[rank] + dtx
    tile = tyy * ntx + txx
    if sat_cull:
        # Separating axes: the tile's pixel-centre rectangle against the
        # quad |q|_inf <= min(2, rho), rho rounded up to 8 bits, with a
        # margin for rounding; a separated pair lights no pixel.
        q = f32[:, rank]
        pcx = txx.to(torch.float32) * float(TILE) + TILE * 0.5 - q[0]
        pcy = tyy.to(torch.float32) * float(TILE) + TILE * 0.5 - q[1]
        h = (TILE - 1.0) * 0.5
        qxc = q[2] * pcx + q[3] * pcy
        qyc = q[4] * pcx + q[5] * pcy
        e1 = h * torch.abs(q[2]) + h * torch.abs(q[3])
        e2 = h * torch.abs(q[4]) + h * torch.abs(q[5])
        rho = torch.sqrt(torch.log(torch.clamp(q[9], min=ALPHA_CUTOFF) / ALPHA_CUTOFF))
        thr = torch.clamp(torch.ceil(torch.clamp(rho, max=QUAD_EXTENT) * (255.0 / QUAD_EXTENT)), max=255.0)
        thr = thr * (QUAD_EXTENT / 255.0)
        err1 = 1e-3 + 1e-6 * (torch.abs(q[2] * pcx) + torch.abs(q[3] * pcy))
        err2 = 1e-3 + 1e-6 * (torch.abs(q[4] * pcx) + torch.abs(q[5] * pcy))
        keep = ~((torch.abs(qxc) > thr + err1 + e1) | (torch.abs(qyc) > thr + err2 + e2))
        rank, tile = rank[keep], tile[keep]
    tile, perm = torch.sort(tile, stable=True)
    rank = rank[perm]
    count = torch.bincount(tile, minlength=num_tiles)
    start = torch.cumsum(count, 0) - count
    return rank, start, count


def _chunk_step(g, ok, px, py, trans, acc, max_alpha):
    """One chunk step of a block of B tiles: ``g`` (rows, B, C) the fields
    of the step's C pair positions, ``ok`` (B, C) whether a position is its
    tile's, ``px``/``py`` (B, 1024) the pixel centres; returns the
    transmittance (B, 1024) and colour (B, 3, 1024) after the step, each
    product and sum taken position by position, and the count of pixel
    updates with alpha != 0."""
    op = torch.where(ok, g[9], 0.0)
    dx = px[:, None, :] - g[0][:, :, None]
    dy = py[:, None, :] - g[1][:, :, None]
    qx = dx * g[2][:, :, None] + dy * g[3][:, :, None]
    qy = dx * g[4][:, :, None] + dy * g[5][:, :, None]
    qx2, qy2 = qx * qx, qy * qy
    alpha = torch.minimum(torch.exp(-(qx2 + qy2)) * op[:, :, None], max_alpha)
    inside = torch.maximum(qx2, qy2) <= QUAD_EXTENT * QUAD_EXTENT
    alpha = torch.where(inside & (alpha >= ALPHA_CUTOFF), alpha, 0.0)
    color = g[6:9].permute(1, 2, 0)                                     # (B, C, 3)
    t_all = torch.cumprod(torch.cat([trans[:, None], 1.0 - alpha], dim=1), dim=1)
    w = alpha * t_all[:, :-1]
    terms = w[:, :, None, :] * color[:, :, :, None]                     # (B, C, 3, 1024)
    acc_all = torch.cumsum(torch.cat([acc[:, None], terms], dim=1), dim=1)
    return t_all[:, -1], acc_all[:, -1], (alpha.detach() != 0).sum()


def composite(f, rank, start, count, width, height, chunk, eps, block_elems=1 << 25, grad=False):
    """Front-to-back compositing of the depth-ordered fields ``f`` over the
    binned pairs.  Returns the image and the frame's work: ``pairs`` (all
    binned), ``pairs_walked`` (positions of its own tile a tile walked before
    it stopped), ``live_pixel_updates`` (of those, the pixel updates with
    alpha != 0)."""
    dev, dt = f.device, f.dtype
    nty, ntx = -(-height // TILE), -(-width // TILE)
    num_tiles = nty * ntx
    phi = start % chunk
    base = start - phi
    span = torch.where(count > 0, phi + count, 0)
    nchunks = torch.div(span + chunk - 1, chunk, rounding_mode="floor")
    p_len = rank.numel()
    tid = torch.arange(num_tiles, device=dev)
    ox = ((tid % ntx) * TILE).to(dt)
    oy = (torch.div(tid, ntx, rounding_mode="floor") * TILE).to(dt)
    iota = torch.arange(TILE, dtype=dt, device=dev) + 0.5
    pxs = (ox[:, None, None] + iota[None, None, :]).expand(num_tiles, TILE, TILE).reshape(num_tiles, TILE * TILE)
    pys = (oy[:, None, None] + iota[None, :, None]).expand(num_tiles, TILE, TILE).reshape(num_tiles, TILE * TILE)
    max_alpha = torch.full((), MAX_ALPHA, dtype=dt, device=dev)

    trans = torch.ones((num_tiles, TILE * TILE), dtype=dt, device=dev)
    acc = torch.zeros((num_tiles, 3, TILE * TILE), dtype=dt, device=dev)
    alive = nchunks > 0
    walked = torch.zeros((), dtype=torch.long, device=dev)
    live = torch.zeros((), dtype=torch.long, device=dev)
    block = max(1, block_elems // (chunk * TILE * TILE))
    offs = torch.arange(chunk, device=dev)
    ci = 0
    while True:
        active = torch.nonzero(alive & (nchunks > ci)).flatten()
        if active.numel() == 0:
            break
        for b0 in range(0, active.numel(), block):
            t = active[b0:b0 + block]
            pos = ci * chunk + offs[None, :]                                     # (B, C)
            ok = (phi[t, None] <= pos) & (span[t, None] > pos)
            g = f[:, rank[torch.clamp(base[t, None] + pos, max=p_len - 1)]]      # (rows, B, C)
            args = (g, ok, pxs[t], pys[t], trans[t], acc[t], max_alpha)
            if grad:
                t_out, a_out, n_live = checkpoint(_chunk_step, *args, use_reentrant=False)
                trans, acc = trans.index_copy(0, t, t_out), acc.index_copy(0, t, a_out)
            else:
                t_out, a_out, n_live = _chunk_step(*args)
                trans.index_copy_(0, t, t_out)
                acc.index_copy_(0, t, a_out)
            walked = walked + ok.sum()
            live = live + n_live
            del g, args, t_out, a_out
        still = trans.detach().amax(dim=1) > eps
        alive = alive.clone()
        alive[active] = still[active]
        ci += 1
    rgba = torch.cat([acc, (1.0 - trans)[:, None]], dim=1)                      # (T, 4, 1024)
    image = rgba.reshape(nty, ntx, 4, TILE, TILE).permute(0, 3, 1, 4, 2).reshape(nty * TILE, ntx * TILE, 4)
    counts = {"pairs": int(p_len), "pairs_walked": int(walked), "live_pixel_updates": int(live)}
    return image[:height, :width], counts


def render(splats, view, proj, cam_pos, width, height, cfg, dtype=torch.float32, grad=False) -> Frame:
    """The frame of ``splats`` (dict of the six fields) seen through the
    camera, under the render settings ``cfg`` (a configuration's
    ``render`` dict).  ``grad``: keep the autograd graph to the splat
    tensors."""
    settings(cfg)
    sp = {k: v.to(dtype) for k, v in splats.items()}
    view, proj, cam_pos = view.to(dtype), proj.to(dtype), cam_pos.to(dtype)
    fields = project(sp["pos"], sp["orient"], sp["scale"], sp["opacity"], sp["color"], sp["sh"], view, proj,
                     cam_pos, width, height, cfg["sh_order"])
    f = payload(fields, cfg["payload_dtype"] == "packed")
    order = torch.argsort(f[10].detach(), stable=True)
    f = f[:, order]
    n = f.shape[1]
    rank, start, count = bin_tiles(f.detach(), width, height, sat_cull=n <= SAT_MAX_N)
    image, counts = composite(f, rank, start, count, width, height, cfg["chunk"], cfg["transmittance_eps"],
                              grad=grad)
    counts["splats"] = n
    return Frame(image=image, counts=counts)


def look_at(eye, target, up=(0.0, 1.0, 0.0)):
    """World-to-view matrix (OpenGL: the camera looks down -z), float32."""
    import numpy as np

    eye, target, up = (np.asarray(v, dtype=np.float64) for v in (eye, target, up))
    fwd = (target - eye) / np.linalg.norm(target - eye)
    right = np.cross(fwd, up)
    right = right / np.linalg.norm(right)
    true_up = np.cross(right, fwd)
    m = np.eye(4)
    m[0, :3], m[1, :3], m[2, :3] = right, true_up, -fwd
    m[:3, 3] = -m[:3, :3] @ eye
    return m.astype(np.float32)


def perspective(fov_y_deg, width, height, near=0.01, far=100.0):
    """OpenGL perspective projection, float32."""
    import numpy as np

    f = 1.0 / math.tan(math.radians(fov_y_deg) / 2.0)
    m = np.zeros((4, 4), dtype=np.float32)
    m[0, 0] = f / (width / height)
    m[1, 1] = f
    m[2, 2] = (far + near) / (near - far)
    m[2, 3] = 2.0 * far * near / (near - far)
    m[3, 2] = -1.0
    return m


def camera_position(view):
    """-R^T t of a view matrix (numpy, float32)."""
    import numpy as np

    return np.asarray(-view[:3, :3].T @ view[:3, 3], np.float32)


def gap(image, ref) -> Dict[str, float]:
    """The numbers compared between an image and the reference's; infinite
    where the image holds a value that is not finite."""
    d = (image.double() - ref.double()).abs()
    if not bool(torch.isfinite(d).all()):
        return {"max_abs": math.inf, "mean_abs": math.inf}
    return {"max_abs": float(d.max()), "mean_abs": float(d.mean())}
