"""The port's CUDA kernels against their plain versions, on the card.

These need one CUDA card and nvcc, so they carry the ``gpu`` marker and skip
where there is none (the decision is taken inside the fixture, never while
the module is imported).  Run them on a machine with a card:

    python -m pytest tests/test_torch_cuda_kernels.py -q

``python3 chip_smoke.py`` makes the same comparisons at more shapes.
"""

import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import gsplat_tpu_torch as gt
from gsplat_tpu_torch.ops.kernels import composite as kcomp
from gsplat_tpu_torch.ops.kernels import scan as kscan

pytestmark = pytest.mark.gpu


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU build")
    return "cuda"


@pytest.mark.parametrize("kind", ["add", "max"])
@pytest.mark.parametrize("n", [1, 1023, 4097, 300_001])
def test_scan_kernel_bit_equal(card, kind, n):
    g = torch.Generator(device=card).manual_seed(n)
    hi = 40 if kind == "add" else 2**31 - 1
    lo = 0 if kind == "add" else -(2**31)
    x = torch.randint(lo, hi, (n,), generator=g, device=card, dtype=torch.int64).to(torch.int32)
    before = kscan.launches
    got = kscan.scan_i32(x, kind)
    assert kscan.launches == before + 1
    assert torch.equal(got, kscan.scan_i32_plain(x, kind))


@pytest.mark.parametrize("payload", ["float32", "packed"])
@pytest.mark.parametrize("eps", [0.0, 1e-3])
def test_render_kernel_path_matches_plain_renderers(card, payload, eps):
    g = torch.Generator(device=card).manual_seed(0)
    splats = gt.random_splats(g, 5000, extent=0.8, scale_range=(0.01, 0.05), sh_scale=0.2, device=card)
    cam = gt.make_camera([0.2, 0.4, 3.0], [0, 0, 0], 200, 120, device=card)
    cfg = gt.RenderConfig(payload_dtype=payload, transmittance_eps=eps, pairs_per_splat=8.0)
    before = (kscan.launches, kcomp.launches)
    main = gt.render(splats, cam, cfg, backend="auto")
    assert (kscan.launches, kcomp.launches) == (before[0] + 2, before[1] + 1)
    tiles = gt.render(splats, cam, cfg, backend="tiles")
    tol = 1e-5 if eps == 0.0 else 2 * eps  # the tiled oracle never stops early
    assert float((main - tiles).abs().max()) < tol


def _backward_case(card, payload, eps, soft=False, eye=(0.2, 0.4, 3.0)):
    from gsplat_tpu_torch.ops import binning
    from gsplat_tpu_torch.ops.projection import project_splats
    from gsplat_tpu_torch.ops.rasterize_ref import quantize_payload, sanitize_projected
    from gsplat_tpu_torch.ops.rasterize_tiles import sort_by_depth

    g = torch.Generator(device=card).manual_seed(1)
    splats = gt.random_splats(g, 5000, extent=0.8, scale_range=(0.01, 0.05), sh_scale=0.2, device=card)
    cam = gt.make_camera(list(eye), [0, 0, 0], 200, 120, device=card)
    cfg = gt.RenderConfig(payload_dtype=payload, transmittance_eps=eps, pairs_per_splat=8.0, soft_cutoff=soft)
    p = project_splats(splats, cam, cfg.sh_order, tight_footprint=not soft)
    p = sort_by_depth(quantize_payload(sanitize_projected(p), cfg))
    b = binning.bin_splats(p, cam.width, cam.height, cfg, with_tiles=False, with_grad_map=True)
    nty, ntx = binning.tile_grid(cam.width, cam.height, 32, 32)
    pay = kcomp.pack_payload(p.fields) if payload == "packed" else p.fields[:10].contiguous()
    fwd = (pay, b.pair_splat, b.tile_base, b.tile_phi, b.tile_span, nty, ntx, cam.height, cam.width, cfg)
    d_out = torch.randn((cam.height, cam.width, 4), generator=g, device=card)
    g_pad = binning.grad_pad_size(b.dest_of_exp.shape[0], nty * ntx, cfg.chunk)
    return fwd, b, d_out, g_pad


def _nine_rows(gspace, packed):
    """The pair-major space, (G, 9) float32 or (G, 8) int32, as nine float32
    rows (9, G)."""
    if not packed:
        return gspace.t()
    cg, cb = kcomp.unpack2(gspace[:, 6])
    return torch.cat([gspace[:, 0:6].view(torch.float32).t(), cg[None], cb[None],
                      gspace[:, 7:8].view(torch.float32).t()])


@pytest.mark.parametrize("payload", ["float32", "packed"])
@pytest.mark.parametrize("eps", [0.0, 1e-3])
def test_checkpoint_variant_is_bit_equal_and_backward_matches_plain(card, payload, eps):
    from gsplat_tpu_torch.ops.kernels import segsum as ksegsum

    fwd, b, d_out, g_pad = _backward_case(card, payload, eps)
    packed = payload == "packed"
    before = (kcomp.launches, kcomp.launches_checkpoint, kcomp.launches_bwd, ksegsum.launches)
    image, used = kcomp.composite_splats(*fwd)
    image_c, used_c, tchk = kcomp.composite_splats(*fwd, checkpoint=True)
    assert torch.equal(image, image_c) and torch.equal(used, used_c)
    args = fwd[:5] + (used_c, b.grad_base, d_out, tchk, g_pad) + fwd[5:]
    got = kcomp.composite_bwd(*args)
    m = ksegsum.segsum_by_splat(got, b.dest_of_exp, b.exp_offsets, b.exp_counts, packed=packed)
    after = (kcomp.launches, kcomp.launches_checkpoint, kcomp.launches_bwd, ksegsum.launches)
    assert after == (before[0] + 2, before[1] + 1, before[2] + 1, before[3] + 1)
    want = kcomp.composite_bwd_plain(*args)
    a, w = _nine_rows(got, packed), _nine_rows(want, packed)
    for r in range(9):
        scale = float(w[r].abs().max())
        if packed and r in (6, 7):  # bf16 halves: one step of an 8-bit mantissa
            assert bool(((a[r] - w[r]).abs() <= w[r].abs() * 2.0 ** -7 + 1e-5 * scale).all()), r
        else:  # the same 1024 terms added in another order
            assert float((a[r] - w[r]).abs().max()) <= 1e-5 * scale, r
    m_plain = ksegsum.segsum_by_splat_plain(got, b.dest_of_exp, b.exp_offsets, b.exp_counts, packed=packed)
    for r in range(9):
        assert float((m[r] - m_plain[r]).abs().max()) <= 1e-6 * float(m_plain[r].abs().max()), r
    assert torch.equal(m, ksegsum.segsum_by_splat(got, b.dest_of_exp, b.exp_offsets, b.exp_counts, packed=packed))


@pytest.mark.parametrize("payload", ["float32", "packed"])
def test_segsum_on_the_pair_major_space_matches_plain(card, payload):
    """A random pair-major space over real windows: within 1e-6 of the
    plain version, two runs bit-equal, the storage order the rank order
    permuted, empty ranks exact zeros, the (R, G) orientation refused."""
    from gsplat_tpu_torch.ops.kernels import segsum as ksegsum

    _, b, _, g_pad = _backward_case(card, payload, 0.0, eye=(0.2, 0.4, 1.0))  # close: some splats off screen
    packed = payload == "packed"
    g = torch.Generator(device=card).manual_seed(3)
    space = torch.randn((g_pad, 9), generator=g, device=card)
    if packed:
        space = torch.cat([space[:, :6].view(torch.int32), kcomp.pack2(space[:, 6:7], space[:, 7:8]),
                           space[:, 8:9].view(torch.int32)], dim=1)
    args = (space, b.dest_of_exp, b.exp_offsets, b.exp_counts)
    before = ksegsum.launches
    got = ksegsum.segsum_by_splat(*args, packed=packed)
    assert ksegsum.launches == before + 1
    want = ksegsum.segsum_by_splat_plain(*args, packed=packed)
    for r in range(9):
        assert float((got[r] - want[r]).abs().max()) <= 1e-6 * float(want[r].abs().max()), r
    assert torch.equal(got, ksegsum.segsum_by_splat(*args, packed=packed))
    order = torch.randperm(b.exp_counts.shape[0], generator=g, device=card)
    assert torch.equal(ksegsum.segsum_by_splat(*args, order=order, packed=packed)[:, order], got)
    empty = b.exp_counts == 0
    assert bool(empty.any()) and float(got[:, empty].abs().max()) == 0.0
    with pytest.raises(TypeError):
        ksegsum.segsum_by_splat(space.t().contiguous(), *args[1:], packed=packed)


@pytest.mark.parametrize("payload", ["float32", "packed"])
def test_render_gradients_through_kernels_match_tiled_autograd(card, payload):
    import dataclasses

    g = torch.Generator(device=card).manual_seed(2)
    splats = gt.random_splats(g, 1500, extent=0.8, sh_scale=0.2, device=card)
    cam = gt.make_camera([0.2, 0.4, 3.0], [0, 0, 0], 200, 120, device=card)
    cfg = gt.RenderConfig(tile_capacity=1024, transmittance_eps=0.0, payload_dtype=payload)
    weights = torch.randn((120, 200, 4), generator=g, device=card)
    fields = ("pos", "orient", "scale", "opacity", "color", "sh")

    def grads(backend):
        leaves = {f: getattr(splats, f).clone().requires_grad_(True) for f in fields}
        (gt.render(dataclasses.replace(splats, **leaves), cam, cfg, backend=backend) * weights).sum().backward()
        return {f: leaves[f].grad for f in fields}

    main, tiles = grads("auto"), grads("tiles")
    for f in fields:
        tol = 2e-2 if (payload == "packed" and f in ("color", "sh")) else 2e-4
        scale = max(1.0, float(tiles[f].abs().max()))
        assert float((main[f] - tiles[f]).abs().max()) <= tol * scale, f


def test_training_steps_on_the_card_launch_every_kernel(card):
    from gsplat_tpu_torch.ops.kernels import segsum as ksegsum

    g = torch.Generator(device=card).manual_seed(3)
    splats = gt.random_splats(g, 20000, extent=0.8, scale_range=(0.01, 0.03), sh_scale=0.1, device=card)
    cam = gt.make_camera([0.2, 0.4, 3.0], [0, 0, 0], 320, 200, device=card)
    cfg = gt.RenderConfig(payload_dtype="packed", transmittance_eps=1e-3, pairs_per_splat=8.0)
    with torch.no_grad():
        img = gt.render(splats, cam, cfg)
    target = torch.clamp(img[..., :3] + (1.0 - img[..., 3:4]) + 0.1, 0.0, 1.0)
    params = gt.params_from_splats(splats)
    step = gt.make_train_step(gt.default_optimizer(params), cam, cfg)
    before = (kscan.launches, kcomp.launches_checkpoint, kcomp.launches_bwd, ksegsum.launches)
    losses = [float(step(params, target)) for _ in range(4)]
    after = (kscan.launches, kcomp.launches_checkpoint, kcomp.launches_bwd, ksegsum.launches)
    assert after == (before[0] + 16, before[1] + 4, before[2] + 4, before[3] + 4)
    assert all(x == x for x in losses) and losses[-1] < losses[0]


@pytest.mark.parametrize("soft", [False, True], ids=["hard", "soft"])
def test_depth_test_forward_and_backward_match_plain(card, soft):
    import dataclasses

    from gsplat_tpu_torch.ops.projection import project_splats
    from gsplat_tpu_torch.ops.rasterize_tiles import sort_by_depth
    from gsplat_tpu_torch.ops.rasterize_ref import sanitize_projected

    # _backward_case's scene and binning; its payload with the view-z row
    fwd, b, d_out, g_pad = _backward_case(card, "float32", 1e-3, soft=soft)
    g = torch.Generator(device=card).manual_seed(1)
    splats = gt.random_splats(g, 5000, extent=0.8, scale_range=(0.01, 0.05), sh_scale=0.2, device=card)
    cam = gt.make_camera([0.2, 0.4, 3.0], [0, 0, 0], 200, 120, device=card)
    p = sort_by_depth(sanitize_projected(project_splats(splats, cam, 3, tight_footprint=not soft)), 15)
    pay = torch.cat([p.fields[:10], p.fields[14:15]]).contiguous()
    assert torch.equal(pay[:10], fwd[0])
    fwd = (pay,) + fwd[1:-1] + (dataclasses.replace(fwd[-1], depth_test=True),)
    xs = torch.linspace(0, 1, 200, device=card)[None, :]
    bgd = ((2.0 + 1.5 * xs) * torch.ones((120, 1), device=card)).contiguous()
    bgd[60] = float("nan")
    before = (kcomp.launches_depth, kcomp.launches_bwd_depth)
    img, used = kcomp.composite_splats(*fwd, bg_depth=bgd)
    img_p, used_p = kcomp.composite_splats_plain(*fwd, bg_depth=bgd)
    assert float((img - img_p).abs().max()) < 1e-5 and torch.equal(used, used_p)
    _, used_c, tchk = kcomp.composite_splats(*fwd, checkpoint=True, bg_depth=bgd)
    args = fwd[:5] + (used_c, b.grad_base, d_out, tchk, g_pad) + fwd[5:]
    got = kcomp.composite_bwd(*args, bg_depth=bgd)
    want = kcomp.composite_bwd_plain(*args, bg_depth=bgd)
    assert (kcomp.launches_depth, kcomp.launches_bwd_depth) == (before[0] + 2, before[1] + 1)
    for r in range(9):
        assert float((got[r] - want[r]).abs().max()) <= 1e-5 * float(want[r].abs().max()), r
    assert float(img[60].abs().max()) == 0.0  # the NaN row is killed


def test_wireframe_kernel_matches_plain_and_oracle(card):
    from gsplat_tpu_torch.ops import wireframe as wire

    g = torch.Generator(device=card).manual_seed(4)
    splats = gt.random_splats(g, 3000, extent=0.8, sh_scale=0.2, device=card)
    cam = gt.make_camera([0.2, 0.4, 3.0], [0, 0, 0], 200, 120, device=card)
    # a soft-cutoff config runs the same band test (the band reads no cutoff)
    for line_px, soft in ((1.0, False), (2.5, False), (1.0, True)):
        cfg = gt.RenderConfig(pairs_per_splat=12.0, soft_cutoff=soft)
        args, b = wire._wireframe_inputs(splats, cam, cfg, line_px)
        before = kcomp.launches_wire
        img, used = kcomp.composite_splats(*args)
        assert kcomp.launches_wire == before + 1 and int(b.dropped_pairs) == 0
        img_p, used_p = kcomp.composite_splats_plain(*args)
        assert float((img - img_p).abs().max()) < 1e-5 and torch.equal(used, used_p)
        assert float(img[..., 3].mean()) > 0.01


def test_probes_match_plain(card):
    from gsplat_tpu_torch.ops.kernels import probes

    g = torch.Generator(device=card).manual_seed(5)
    x = torch.rand((132 * 256 + 7,), generator=g, device=card) * 0.5 + 0.25
    for variant in probes.ALU_VARIANTS:
        got = probes.alu_probe(x, 64, variant)
        want = probes.alu_probe_plain(x, 64, variant)
        if variant == "expf":
            assert float(((got - want).abs() / want.abs()).max()) <= 1e-6, variant
        else:  # the float32 chains bit for bit
            assert torch.equal(got, want), variant
        # one link fewer moves (nearly) every value, and the chains keep their start
        assert float((probes.alu_probe(x, 63, variant) == got).float().mean()) < 1e-3, variant
        assert torch.unique(got).numel() > x.numel() // 2, variant
    mat = torch.randn((16, 1 << 16), generator=g, device=card)
    idx = torch.randint(0, 1 << 16, (100_003,), generator=g, device=card, dtype=torch.int32)
    for access in ("contiguous", "column", "row"):
        m = mat.t().contiguous() if access == "row" else mat
        got = float(probes.gather_probe(m, idx, access))
        want = float(probes.gather_probe_plain(m, idx, access))
        assert abs(got - want) <= 1e-9 * float(probes.gather_probe_plain(m.abs(), idx, access)), access
    assert torch.equal(probes.gather_probe(torch.zeros_like(mat), idx, "column_write"),
                       probes.gather_probe_plain(torch.zeros_like(mat), idx, "column_write"))


@pytest.mark.parametrize("queries", ["one", "past_a_tile", "calibrate"])
def test_gather_probe_column_sweep_matches_plain(card, queries):
    """The column read and the column write (staged tiles swept row by row)
    at one query, at a block span one past the staging tile, and at the
    calibrate phase's shape: the read within 1e-9 of the summed magnitudes
    and bit-equal between two runs, the write exactly."""
    from gsplat_tpu_torch.ops.kernels import probes
    from gsplat_tpu_torch.utils import sol_calibrate

    n_cols = {"one": 1000, "past_a_tile": 1 << 16, "calibrate": sol_calibrate.N_COLS}[queries]
    p = {"one": 1, "past_a_tile": probes.GATHER_TILE * probes.gather_blocks(card, "column") + 1,
         "calibrate": sol_calibrate.SORT_PAIRS}[queries]
    g = torch.Generator(device=card).manual_seed(6)
    mat = torch.randn((16, n_cols), generator=g, device=card)
    idx = torch.randint(0, n_cols, (p,), generator=g, device=card, dtype=torch.int32)
    before = (probes.launches["column"], probes.launches["column_write"])
    got = probes.gather_probe(mat, idx, "column")
    assert torch.equal(got, probes.gather_probe(mat, idx, "column"))
    want = float(probes.gather_probe_plain(mat, idx, "column"))
    assert abs(float(got) - want) <= 1e-9 * float(probes.gather_probe_plain(mat.abs(), idx, "column"))
    assert torch.equal(probes.gather_probe(torch.zeros_like(mat), idx, "column_write"),
                       probes.gather_probe_plain(torch.zeros_like(mat), idx, "column_write"))
    assert (probes.launches["column"], probes.launches["column_write"]) == (before[0] + 2, before[1] + 1)


# (strides, offsets in tiles): the cyclic grids of the sharded renderer and a
# contiguous strip at a row offset
STRIDED_CASES = [((2, 2), (0, 0)), ((2, 2), (1, 1)), ((1, 4), (0, 3)), ((4, 1), (3, 0)), ((1, 1), (17, 0))]


@pytest.mark.parametrize("strides,offsets", STRIDED_CASES,
                         ids=["2x2-0-0", "2x2-1-1", "1x4-0-3", "4x1-3-0", "rows-17"])
def test_strided_tile_mapping_matches_plain(card, strides, offsets):
    from gsplat_tpu_torch.ops import binning
    from gsplat_tpu_torch.ops.projection import project_splats
    from gsplat_tpu_torch.ops.rasterize_ref import quantize_payload, sanitize_projected
    from gsplat_tpu_torch.ops.rasterize_tiles import sort_by_depth

    g = torch.Generator(device=card).manual_seed(6)
    splats = gt.random_splats(g, 20000, extent=0.8, scale_range=(0.01, 0.05), sh_scale=0.2, device=card)
    width, height = 320, 704  # 10 x 22 tiles
    cam = gt.make_camera([0.2, 0.4, 3.0], [0, 0, 0], width, height, device=card)
    dy, dx = strides
    if strides == (1, 1):
        strip_h, strip_w = 4 * 32, width  # tile rows 17..20
    else:
        strip_h = -(-height // (dy * 32)) * 32
        strip_w = -(-width // (dx * 32)) * 32
    cfg = gt.RenderConfig(payload_dtype="packed", transmittance_eps=1e-3, pairs_per_splat=8.0,
                          row_stride=dy, col_stride=dx)
    p = sort_by_depth(quantize_payload(sanitize_projected(project_splats(splats, cam, 3)), cfg))
    b = binning.bin_splats(p, strip_w, strip_h, cfg, row_offset=offsets[0], col_offset=offsets[1],
                           with_tiles=False, with_grad_map=True)
    nty, ntx = binning.tile_grid(strip_w, strip_h, 32, 32)
    fwd = (kcomp.pack_payload(p.fields), b.pair_splat, b.tile_base, b.tile_phi, b.tile_span,
           nty, ntx, strip_h, strip_w, cfg)
    before = (kcomp.launches_strided, kcomp.launches_bwd_strided)
    img, used = kcomp.composite_splats(*fwd, offsets=offsets)
    img_p, used_p = kcomp.composite_splats_plain(*fwd, offsets=offsets)
    assert torch.equal(img, img_p) and torch.equal(used, used_p)
    img_c, used_c, tchk = kcomp.composite_splats(*fwd, checkpoint=True, offsets=offsets)
    assert torch.equal(img_c, img) and torch.equal(used_c, used)
    d_out = torch.randn((strip_h, strip_w, 4), generator=g, device=card)
    g_pad = binning.grad_pad_size(b.dest_of_exp.shape[0], nty * ntx, cfg.chunk)
    args = fwd[:5] + (used_c, b.grad_base, d_out, tchk, g_pad) + fwd[5:]
    a = _nine_rows(kcomp.composite_bwd(*args, offsets=offsets), True)
    w = _nine_rows(kcomp.composite_bwd_plain(*args, offsets=offsets), True)
    assert (kcomp.launches_strided, kcomp.launches_bwd_strided) == (before[0] + 2, before[1] + 1)
    for r in range(9):
        scale = float(w[r].abs().max())
        if r in (6, 7):  # bf16 halves: one step of an 8-bit mantissa
            assert bool(((a[r] - w[r]).abs() <= w[r].abs() * 2.0 ** -7 + 1e-5 * scale).all()), r
        else:
            assert float((a[r] - w[r]).abs().max()) <= 1e-5 * scale, r
    assert float(img[..., 3].max()) > 0.5 and float(w.abs().max()) > 0.0


def test_scan_back_to_back_calls_after_poisoned_scratch(card):
    """200 calls on one stream with no host wait, kind and length
    alternating, the scratch poisoned with random words before them and
    every 25 calls: each bit-equal to its plain version, one launch each."""
    g = torch.Generator(device=card).manual_seed(8)
    lengths = (1, 4095, 4096, 4097, 1 << 20, 2_359_296, (1 << 24) + 3)
    inputs = {}
    for kind in kscan.KINDS:
        for n in lengths:
            hi, lo = (40, 0) if kind == "add" else (2**31 - 1, -(2**31))
            inputs[(kind, n)] = torch.randint(lo, hi, (n,), generator=g, device=card,
                                              dtype=torch.int64).to(torch.int32)
    want = {key: kscan.scan_i32_plain(x, key[0]) for key, x in inputs.items()}
    kscan.scan_i32(inputs[("add", lengths[-1])], "add")
    before = kscan.launches
    got = []
    for i in range(200):
        if i % 25 == 0:
            for buf in kscan._scratch.values():
                buf.copy_(torch.randint(-(2**63), 2**63 - 1, buf.shape, generator=g, device=card,
                                        dtype=torch.int64))
        key = (kscan.KINDS[i % 2], lengths[(i // 2) % len(lengths)])
        got.append((key, kscan.scan_i32(inputs[key], key[0])))
    assert kscan.launches == before + 200
    for key, out in got:
        assert torch.equal(out, want[key]), key


def test_scan_refuses_cuda_graph_capture(card):
    """A capture must not allocate the scan's scratch (the zeroing would be
    replayed): on a capture stream no eager call has sized, the scan raises,
    counts nothing, and works again after it; once an eager call on that
    stream has sized it, the same capture replays bit-equal (each replay
    takes a fresh epoch on the device)."""
    x = torch.arange(10_000, dtype=torch.int32, device=card)
    side = torch.cuda.Stream()
    before = kscan.launches
    graph = torch.cuda.CUDAGraph()
    with pytest.raises(RuntimeError, match="capture"):
        with torch.cuda.graph(graph, stream=side):
            kscan.scan_i32(x, "add")
    assert kscan.launches == before
    assert torch.equal(kscan.scan_i32(x, "max"), x)
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        kscan.scan_i32(x, "add")
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        out = kscan.scan_i32(x, "add")
    for _ in range(3):
        graph.replay()
        assert torch.equal(out, kscan.scan_i32_plain(x, "add"))


@pytest.mark.parametrize("case", ["float32", "packed", "depth", "strided"])
def test_backward_reach_test_audit_and_determinism(card, case):
    """The reach test skips no pixel with α != 0 (the audit instance counts
    0 and writes the same gradient space), two runs are bit-equal, and the
    rows agree with the plain version."""
    import dataclasses

    payload = "packed" if case in ("packed", "strided") else "float32"
    fwd, b, d_out, g_pad = _backward_case(card, payload, 1e-3)
    bgd, offsets = None, (0, 0)
    if case == "depth":
        from gsplat_tpu_torch.ops.projection import project_splats
        from gsplat_tpu_torch.ops.rasterize_ref import sanitize_projected
        from gsplat_tpu_torch.ops.rasterize_tiles import sort_by_depth

        g = torch.Generator(device=card).manual_seed(1)
        splats = gt.random_splats(g, 5000, extent=0.8, scale_range=(0.01, 0.05), sh_scale=0.2, device=card)
        cam = gt.make_camera([0.2, 0.4, 3.0], [0, 0, 0], 200, 120, device=card)
        p = sort_by_depth(sanitize_projected(project_splats(splats, cam, 3, tight_footprint=True)), 15)
        assert torch.equal(p.fields[:10], fwd[0])
        fwd = (torch.cat([p.fields[:10], p.fields[14:15]]).contiguous(),) + fwd[1:-1] + (
            dataclasses.replace(fwd[-1], depth_test=True),)
        bgd = ((2.0 + 1.5 * torch.linspace(0, 1, 200, device=card)[None, :]) *
               torch.ones((120, 1), device=card)).contiguous()
    if case == "strided":
        from gsplat_tpu_torch.ops import binning
        from gsplat_tpu_torch.ops.projection import project_splats
        from gsplat_tpu_torch.ops.rasterize_ref import quantize_payload, sanitize_projected
        from gsplat_tpu_torch.ops.rasterize_tiles import sort_by_depth

        g = torch.Generator(device=card).manual_seed(6)
        splats = gt.random_splats(g, 20000, extent=0.8, scale_range=(0.01, 0.05), sh_scale=0.2, device=card)
        cam = gt.make_camera([0.2, 0.4, 3.0], [0, 0, 0], 320, 704, device=card)
        cfg = gt.RenderConfig(payload_dtype="packed", transmittance_eps=1e-3, pairs_per_splat=8.0,
                              row_stride=2, col_stride=2)
        p = sort_by_depth(quantize_payload(sanitize_projected(project_splats(splats, cam, 3)), cfg))
        offsets = (1, 1)
        b = binning.bin_splats(p, 160, 352, cfg, row_offset=1, col_offset=1, with_tiles=False, with_grad_map=True)
        fwd = (kcomp.pack_payload(p.fields), b.pair_splat, b.tile_base, b.tile_phi, b.tile_span, 11, 5, 352, 160, cfg)
        d_out = torch.randn((352, 160, 4), generator=g, device=card)
        g_pad = binning.grad_pad_size(b.dest_of_exp.shape[0], 55, cfg.chunk)
    _, used, tchk = kcomp.composite_splats(*fwd, checkpoint=True, bg_depth=bgd, offsets=offsets)
    args = fwd[:5] + (used, b.grad_base, d_out, tchk, g_pad) + fwd[5:]
    got = kcomp.composite_bwd(*args, bg_depth=bgd, offsets=offsets)
    assert torch.equal(got, kcomp.composite_bwd(*args, bg_depth=bgd, offsets=offsets))
    audited, skipped = kcomp.composite_bwd_audit(*args, bg_depth=bgd, offsets=offsets)
    assert skipped == 0 and torch.equal(audited, got)
    packed = payload == "packed"
    a, w = _nine_rows(got, packed), _nine_rows(kcomp.composite_bwd_plain(*args, bg_depth=bgd, offsets=offsets),
                                               packed)
    for r in range(9):
        scale = float(w[r].abs().max())
        if packed and r in (6, 7):  # bf16 halves: one step of an 8-bit mantissa
            assert bool(((a[r] - w[r]).abs() <= w[r].abs() * 2.0 ** -7 + 1e-5 * scale).all()), r
        else:
            assert float((a[r] - w[r]).abs().max()) <= 1e-5 * scale, r
    assert float(w.abs().max()) > 0.0


def test_scan_growth_over_a_block_holding_the_next_epochs_tags(card):
    """The scratch is zeroed at every growth: twice, a freed block of the
    size the growth requests holds the next call's tags (tile counter
    (epoch << 32) | 5, every status word (2 * epoch) << 32) and is handed
    back by the allocator, and the scan stays bit-equal to torch.cumsum /
    cummax (chip_smoke.scan_growth_probe).  In a child process under a
    timeout of its own, since a scratch that trusted such a block could
    leave the look-back spinning."""
    code = "import sys, chip_smoke; sys.exit(chip_smoke.scan_growth_probe())"
    res = subprocess.run([sys.executable, "-c", code], cwd=Path(__file__).resolve().parents[1],
                         capture_output=True, text=True, timeout=180)
    assert res.returncode == 0, (res.stdout[-2000:], res.stderr[-2000:])
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert [r["kind"] for r in out] == ["add", "max"]
    assert all(r["block_handed_back"] and r["bit_equal"] for r in out), out


def _forward_case(card, case):
    """Compositor inputs of one mode: (fwd args, scene depth, offsets)."""
    import dataclasses

    from gsplat_tpu_torch.ops import binning
    from gsplat_tpu_torch.ops import wireframe as wire
    from gsplat_tpu_torch.ops.projection import project_splats
    from gsplat_tpu_torch.ops.rasterize_ref import quantize_payload, sanitize_projected
    from gsplat_tpu_torch.ops.rasterize_tiles import sort_by_depth

    g = torch.Generator(device=card).manual_seed(2)
    splats = gt.random_splats(g, 8000, extent=0.8, scale_range=(0.01, 0.05), sh_scale=0.2, device=card)
    width, height = (320, 704) if case == "strided" else (200, 120)
    cam = gt.make_camera([0.2, 0.4, 3.0], [0, 0, 0], width, height, device=card)
    cfg = gt.RenderConfig(payload_dtype="packed" if case in ("packed", "strided") else "float32",
                          soft_cutoff=case == "soft_depth", depth_test=case in ("depth", "soft_depth"),
                          transmittance_eps=1e-3, pairs_per_splat=8.0)
    if case == "wire":
        return wire._wireframe_inputs(splats, cam, cfg, 1.5)[0], None, (0, 0)
    offsets, strip_w, strip_h = (0, 0), width, height
    if case == "strided":
        cfg = dataclasses.replace(cfg, row_stride=2, col_stride=2)
        offsets, strip_w, strip_h = (1, 1), 160, 352
    p = project_splats(splats, cam, 3, tight_footprint=not cfg.soft_cutoff)
    p = sort_by_depth(quantize_payload(sanitize_projected(p), cfg), 15 if cfg.depth_test else 14)
    b = binning.bin_splats(p, strip_w, strip_h, cfg, row_offset=offsets[0], col_offset=offsets[1],
                           with_tiles=False)
    nty, ntx = binning.tile_grid(strip_w, strip_h, 32, 32)
    bgd = None
    if cfg.payload_dtype == "packed":
        pay = kcomp.pack_payload(p.fields)
    elif cfg.depth_test:
        pay = torch.cat([p.fields[:10], p.fields[14:15]]).contiguous()
        bgd = ((2.0 + 1.5 * torch.linspace(0, 1, width, device=card)[None, :]) *
               torch.ones((height, 1), device=card)).contiguous()
        bgd[height // 2] = float("nan")
    else:
        pay = p.fields[:10].contiguous()
    return (pay, b.pair_splat, b.tile_base, b.tile_phi, b.tile_span, nty, ntx, strip_h, strip_w, cfg), bgd, offsets


@pytest.mark.parametrize("case", ["float32", "packed", "depth", "soft_depth", "wire", "strided"])
def test_forward_warp_mask_audit_and_determinism(card, case):
    """The forward with its warp mask: image within 1e-5 of the plain
    version's and stop counters equal; the checkpoints within 1e-5 on the
    chunks walked; the audit instance counts 0 pixels with α != 0 in the
    warps it skipped, writes the same image and keeps exactly the plain
    mask's (pair, warp) couples; two runs bit-equal."""
    fwd, bgd, offsets = _forward_case(card, case)
    img, used = kcomp.composite_splats(*fwd, bg_depth=bgd, offsets=offsets)
    img2, used2 = kcomp.composite_splats(*fwd, bg_depth=bgd, offsets=offsets)
    assert torch.equal(img, img2) and torch.equal(used, used2)
    img_p, used_p = kcomp.composite_splats_plain(*fwd, bg_depth=bgd, offsets=offsets)
    assert float((img - img_p).abs().max()) < 1e-5 and torch.equal(used, used_p)
    a_img, a_used, skipped, kept = kcomp.composite_splats_audit(*fwd, bg_depth=bgd, offsets=offsets)
    pay, pair_splat, tile_base, tile_phi, _, nty, ntx, _, _, cfg = fwd
    counts = kcomp.walked_pair_counts(pay, pair_splat, tile_base, tile_phi, used, nty, ntx, cfg, bgd, offsets)
    assert skipped == 0 and torch.equal(a_img, img) and torch.equal(a_used, used)
    assert kept == counts["kept_warps"] and counts["live_warps"] <= kept
    if case != "soft_depth":  # the mask drops something
        assert kept < 8 * counts["pairs"]
    if case != "wire":
        img_c, used_c, tchk = kcomp.composite_splats(*fwd, checkpoint=True, bg_depth=bgd, offsets=offsets)
        _, _, tchk_p = kcomp.composite_splats_plain(*fwd, checkpoint=True, bg_depth=bgd, offsets=offsets)
        assert torch.equal(img_c, img) and torch.equal(used_c, used)
        walked = torch.arange(tchk.shape[1], device=card)[None, :] < ((used + cfg.chunk - 1) // cfg.chunk)[:, None]
        assert float(torch.where(walked[:, :, None], (tchk - tchk_p).abs(), 0.0).max()) < 1e-5
    assert float(img[..., 3].max()) > 0.5


def test_projection_kernels_match_plain(card):
    from gsplat_tpu_torch.ops.kernels import projection as kproj

    g = torch.Generator(device=card).manual_seed(8)
    splats = gt.random_splats(g, 257, extent=1.5, sh_scale=0.3, device=card)
    fields = ("pos", "orient", "scale", "opacity", "color", "sh")
    # in front of the camera, and with the camera in the cloud (half behind it)
    for eye, target in (([0.2, 0.4, 3.0], [0, 0, 0]), ([0.0, 0.0, 0.0], [0, 0, -1])):
        cam = gt.make_camera(eye, target, 96, 64, device=card)
        for sh_order in range(4):
            for tight in (False, True):
                args = [getattr(splats, f) for f in fields] + [cam.view, cam.proj, cam.position, 96, 64,
                                                               sh_order, tight, False]
                before = (kproj.launches_fwd, kproj.launches_bwd)
                out = kproj.project_fields(*args)
                want = kproj.project_fields_plain(*args)
                assert torch.equal(out.view(torch.int32), want.view(torch.int32))  # bit for bit
                cot = torch.randn((16, 257), generator=g, device=card)
                got = kproj.project_fields_bwd(*args, cot)
                assert (kproj.launches_fwd, kproj.launches_bwd) == (before[0] + 1, before[1] + 1)
                for a, b in zip(got, kproj.project_fields_bwd_plain(*args, cot)):
                    if b is None:
                        assert a is None
                        continue
                    assert float((a - b).abs().max()) <= 1e-6 * float(b.abs().max())
                # the masked form (the payload form's backward): an invalid
                # splat's gradient is zero, the opacity's written by the kernel
                invalid = want[11] < 0.5
                got = kproj.project_fields_bwd(*args, cot, masked=True)
                assert kproj.launches_bwd == before[1] + 2
                for a, b in zip(got, kproj.project_fields_bwd_plain(*args, cot, masked=True)):
                    if b is None:
                        assert a is None
                        continue
                    assert not bool(a[..., invalid].any())
                    assert float((a - b).abs().max()) <= 1e-6 * float(b.abs().max())
                # a splat-major cotangent (as scatter_payload writes it) is read as it is
                for a, b in zip(kproj.project_fields_bwd(*args, cot.T.contiguous().T, masked=True), got):
                    assert (a is None and b is None) or torch.equal(a, b)
    # project_splats on CUDA tensors goes through the kernels
    before = kproj.launches_fwd
    gt.project_splats(splats, cam)
    assert kproj.launches_fwd == before + 1
    # dense but transposed fields (e.g. pos given as an (N, 3) tensor's .T):
    # the gradients equal those of contiguous fields, whatever the strides
    weights = torch.linspace(-1.0, 1.0, 16, device=card)[:, None]
    grads = []
    for transposed in (False, True):
        flip = (lambda x: x.T if x.dim() == 2 else x) if transposed else (lambda x: x)
        leaves = {f: flip(getattr(splats, f)).clone(memory_format=torch.contiguous_format)
                  .requires_grad_(True) for f in fields}
        views = {f: flip(x) for f, x in leaves.items()}
        assert transposed == (not views["pos"].is_contiguous())
        out = gt.project_splats(dataclasses.replace(splats, **views), cam, tight_footprint=True).fields
        (out * weights).sum().backward()
        grads.append({f: flip(x.grad) for f, x in leaves.items()})
    for f in fields:
        assert torch.equal(grads[0][f], grads[1][f]), f


def _glue_scene(card, n=3000, w=200, h=120):
    g = torch.Generator(device=card).manual_seed(n)
    splats = gt.random_splats(g, n, extent=1.5, scale_range=(0.01, 0.1), sh_scale=0.2, device=card)
    return splats, gt.make_camera([0.0, 0.3, 2.0], [0, 0, 0], w, h, device=card)


GLUE_MODES = (dict(payload_dtype="packed"), dict(), dict(payload_dtype="bfloat16"), dict(depth_test=True),
              dict(wireframe=True), dict(soft_cutoff=True), dict(row_stride=2, col_stride=3))


def test_project_fwd_payload_form_matches_plain(card):
    """project_fwd writing sanitized, quantized fields (the serving frame's
    form) bit for bit against the plain sanitize and quantize of the plain
    forward, the camera in the cloud so that half the splats are invalid."""
    from gsplat_tpu_torch.ops.kernels import projection as kproj

    splats, _ = _glue_scene(card, n=257)
    cam = gt.make_camera([0.0, 0.0, 0.0], [0, 0, -1], 96, 64, device=card)
    args = [getattr(splats, f) for f in ("pos", "orient", "scale", "opacity", "color", "sh")]
    args += [cam.view, cam.proj, cam.position, 96, 64, 3, True, False]
    raw = kproj.project_fields_plain(*args)
    assert not bool((raw[11] > 0.5).all())
    for payload in ("float32", "packed", "bfloat16"):
        before = kproj.launches_fwd_payload
        out = kproj.project_fields(*args, payload_dtype=payload)
        assert kproj.launches_fwd_payload == before + 1
        want = kproj.payload_fields_plain(raw, payload)
        assert torch.equal(out.view(torch.int32), want.view(torch.int32)), payload


def test_gather_payload_matches_plain(card):
    """gather_payload's payload and binning operands bit for bit against its
    plain version in every payload layout and binning mode."""
    from gsplat_tpu_torch.ops import binning
    from gsplat_tpu_torch.ops.kernels import frame_glue as kglue

    splats, cam = _glue_scene(card)
    for kw in GLUE_MODES:
        cfg = gt.RenderConfig(**kw)
        offsets = (1, 2) if cfg.row_stride != 1 else (0, 0)
        fields = gt.project_splats(splats, cam, tight_footprint=not cfg.soft_cutoff,
                                   payload_dtype=cfg.payload_dtype).fields
        order = torch.argsort(fields[10], stable=True)
        _, rho_ok = binning.sat_flags(splats.count, cam.width, cam.height, cfg)
        before = kglue.launches_gather
        got = kglue.gather_payload(fields, order, cam.width, cam.height, cfg, rho_ok, *offsets)
        assert kglue.launches_gather == before + 1
        want = kglue.gather_payload_plain(fields, order, cam.width, cam.height, cfg, rho_ok, *offsets)
        assert torch.equal(got.payload.view(torch.int32), want.payload.view(torch.int32)), kw
        for name in ("counts", "nx", "tile0", "thr_q"):
            a, b = getattr(got.operands, name), getattr(want.operands, name)
            assert (a is None and b is None) or torch.equal(a, b), (kw, name)


def test_scatter_payload_matches_plain(card):
    """scatter_payload (the gather's gradient) bit for bit against its plain
    version, for the float32 rows with and without the view-z row, and
    GatherPayload's backward on the card equal to it."""
    from gsplat_tpu_torch.ops.kernels import frame_glue as kglue

    splats, cam = _glue_scene(card)
    cfg = gt.RenderConfig(payload_dtype="packed")
    fields = gt.project_splats(splats, cam, tight_footprint=True, payload_dtype="packed").fields
    order = torch.argsort(fields[10], stable=True)
    g = torch.Generator(device=card).manual_seed(9)
    for rows in (10, 11):
        d_payload = torch.randn((rows, splats.count), generator=g, device=card)
        before = kglue.launches_scatter
        got = kglue.scatter_payload(d_payload, order)
        assert kglue.launches_scatter == before + 1
        assert torch.equal(got.view(torch.int32), kglue.scatter_payload_plain(d_payload, order).view(torch.int32))
    leaf = fields.detach().clone().requires_grad_(True)  # clone keeps the splat-major layout
    glue = kglue.gather_payload_diff(leaf, order, cam.width, cam.height, cfg, False)
    want = kglue.gather_payload_plain(fields, order, cam.width, cam.height, cfg, False, float_rows=True)
    assert torch.equal(glue.payload.detach().view(torch.int32), want.payload.view(torch.int32))
    glue.payload.backward(d_payload[:10])
    assert torch.equal(leaf.grad, kglue.scatter_payload_plain(d_payload[:10], order))


def test_mark_owners_matches_plain(card):
    """mark_owners' offsets and marks bit for bit against its plain version
    (the atomic max is the same in any order), at a budget that holds every
    pair, one that drops half of them and one slot."""
    from gsplat_tpu_torch.ops.kernels import frame_glue as kglue

    splats, cam = _glue_scene(card)
    cfg = gt.RenderConfig()
    fields = gt.project_splats(splats, cam, tight_footprint=True, payload_dtype="float32").fields
    ops = kglue.gather_payload(fields, torch.argsort(fields[10], stable=True), cam.width, cam.height, cfg,
                               False).operands
    cum = torch.cumsum(ops.counts, 0, dtype=torch.int32)
    for budget in (cfg.pair_budget(splats.count), max(1, int(cum[-1]) // 2), 1):
        before = kglue.launches_marks
        got = kglue.mark_owners(cum, ops.counts, budget)
        assert kglue.launches_marks == before + 1
        for a, b in zip(got, kglue.mark_owners_plain(cum, ops.counts, budget)):
            assert torch.equal(a, b), budget


def test_expand_pairs_matches_plain(card, monkeypatch):
    """expand_pairs bit for bit against its plain version: the SAT cull on
    and off, a budget that drops pairs, a (tile, rank) key too wide for 31
    bits, the gradient map's ranks, and bin_splats through the kernel equal
    to bin_splats through the plain version in the order= form."""
    from gsplat_tpu_torch.ops import binning
    from gsplat_tpu_torch.ops.kernels import frame_glue as kglue

    splats, cam = _glue_scene(card)
    n = splats.count
    nty, ntx = binning.tile_grid(cam.width, cam.height, 32, 32)
    for kw in GLUE_MODES:
        cfg = gt.RenderConfig(**kw)
        offsets = (1, 2) if cfg.row_stride != 1 else (0, 0)
        fields = gt.project_splats(splats, cam, tight_footprint=not cfg.soft_cutoff,
                                   payload_dtype=cfg.payload_dtype).fields
        order = torch.argsort(fields[10], stable=True)
        sat_cull, rho_ok = binning.sat_flags(n, cam.width, cam.height, cfg)
        ops = kglue.gather_payload(fields, order, cam.width, cam.height, cfg, rho_ok, *offsets).operands
        cum = torch.cumsum(ops.counts, 0, dtype=torch.int32)
        offs = cum - ops.counts
        for budget in (cfg.pair_budget(n), max(1, int(cum[-1]) // 2)):
            marks = torch.zeros((budget + 1,), dtype=torch.int32, device=card)
            marks.scatter_reduce_(0, torch.clamp(offs, max=budget).long(),
                                  torch.arange(1, n + 1, dtype=torch.int32, device=card), "amax")
            smax = torch.cummax(marks[:budget], 0).values.contiguous()
            for num_tiles in (nty * ntx, 1 << 28):
                args = (smax, cum, offs, ops, budget, num_tiles, ntx, cfg, *offsets, sat_cull, rho_ok, True)
                before = kglue.launches_expand
                got = kglue.expand_pairs(*args)
                assert kglue.launches_expand == before + 1
                want = kglue.expand_pairs_plain(*args)
                assert (got.key is None) == (num_tiles != nty * ntx)
                for name in ("key", "tile", "rank", "exp_rank"):
                    a, b = getattr(got, name), getattr(want, name)
                    assert (a is None and b is None) or torch.equal(a, b), (kw, budget, num_tiles, name)
    # bin_splats' order= form with the gradient map, kernel against plain
    cfg = gt.RenderConfig()
    p = gt.project_splats(splats, cam, tight_footprint=True, payload_dtype="float32")
    order = torch.argsort(p.fields[10], stable=True)
    got = binning.bin_splats(p, cam.width, cam.height, cfg, order=order, with_grad_map=True)
    monkeypatch.setattr(kglue, "expand_pairs", kglue.expand_pairs_plain)
    want = binning.bin_splats(p, cam.width, cam.height, cfg, order=order, with_grad_map=True)
    for name in ("pair_splat", "pair_tile", "tile_start", "tile_count", "dest_of_exp", "exp_rank", "dropped_pairs"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
