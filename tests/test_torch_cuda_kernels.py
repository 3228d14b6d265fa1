"""The port's CUDA kernels against their plain versions, on the card.

These need one CUDA card and nvcc, so they carry the ``gpu`` marker and skip
where there is none (the decision is taken inside the fixture, never while
the module is imported).  Run them on a machine with a card:

    python -m pytest tests/test_torch_cuda_kernels.py -q

``python3 chip_smoke.py`` makes the same comparisons at more shapes.
"""

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
