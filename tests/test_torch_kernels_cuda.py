"""The port's CUDA kernels against their plain PyTorch versions, on the
card. They have no CPU mode, so without CUDA every test here skips.

This file imports only torch, numpy and the port, so it runs where JAX
is absent; skip the suite's JAX conftest there:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py
"""

import numpy as np
import pytest
import torch

from nerfdet_tpu_torch.ops import pointnet, render, voxel

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _cameras(rng, v):
    intrinsic = np.array([[288.0, 0, 160.0], [0, 288.0, 120.0],
                          [0, 0, 1]], np.float32)
    extr = []
    for i in range(v):
        a = 2 * np.pi * i / v + rng.uniform(-0.1, 0.1)
        pos = np.array([3.5 * np.cos(a), 3.5 * np.sin(a), 1.5])
        fwd = -pos / np.linalg.norm(pos)
        right = np.cross(fwd, [0, 0, 1.0])
        right /= np.linalg.norm(right)
        c2w = np.eye(4)
        c2w[:3, 0], c2w[:3, 1] = right, np.cross(fwd, right)
        c2w[:3, 2], c2w[:3, 3] = fwd, pos
        extr.append(np.linalg.inv(c2w))
    return intrinsic, np.asarray(extr, np.float32)


def _pix(dev, v=6, nvox=(20, 20, 8), fh=60, fw=80):
    intrinsic, extr = _cameras(np.random.RandomState(0), v)
    points = voxel.get_points(nvox, (0.32, 0.32, 0.4), (0, 0, 0.5),
                              dev).reshape(-1, 3)
    proj = voxel.compute_projection(intrinsic, extr, 4.0, dev)
    x, y, _, valid = voxel.project_points(points, proj, fh - 1, fw)
    return voxel.pixel_index(x, y, valid, fw).contiguous()


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mapped", [False, True])
@pytest.mark.parametrize("c", [64, 256])
def test_fusion_carry_matches_plain(dev, dtype, mapped, c):
    pix = _pix(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    feats = torch.randn((pix.shape[0], 60, 80, c), generator=gen,
                        device=dev).to(dtype)
    w = b = None
    if mapped:
        w = torch.randn((c, 32), generator=gen, device=dev) / c ** 0.5
        b = torch.randn((32,), generator=gen, device=dev)
    before = voxel.fusion_carry.launches
    got = voxel.fusion_carry(feats, pix, w, b)
    want = voxel.fusion_carry_plain(feats, pix, w, b)
    torch.cuda.synchronize()
    assert voxel.fusion_carry.launches == before + 1
    assert int((pix >= 0).sum()) > 0
    # counts exact; s1 and s2 use the plain version's rounding in view
    # order; s2m differs in the order of its C-long dot products
    assert torch.equal(got[2], want[2])
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1])
    if mapped:
        assert _rel(got[3], want[3]) <= 1e-5
    else:
        assert got[3] is None


def test_fusion_carry_rejects_what_it_cannot_take(dev):
    pix = _pix(dev, v=2)
    with pytest.raises(ValueError, match="C % 32"):
        voxel.fusion_carry(torch.zeros((2, 60, 80, 40), device=dev), pix)
    with pytest.raises(ValueError, match="pix"):
        voxel.fusion_carry(torch.zeros((2, 60, 80, 64), device=dev),
                           pix.long())


def _cloud(dev, n, c, seed, dup=False):
    """A room-sized cloud (8 x 8 x 3 m), or half of one repeated."""
    rng = np.random.RandomState(seed)
    m = n // 2 if dup else n
    pts = rng.uniform(0, 1, (m, c)).astype(np.float32) * np.float32(8)
    pts[:, 2] *= np.float32(3 / 8)
    if dup:
        pts = np.concatenate([pts, pts])
    return torch.from_numpy(pts).to(dev)


@pytest.mark.parametrize("n,c,s,dup", [
    (40000, 3, 2048, False), (2048, 3, 1024, False), (1024, 3, 512, False),
    (512, 3, 256, False), (1024, 3, 256, False),  # VoteNet's five calls
    (4096, 19, 512, False), (40000, 3, 2048, True),  # F-FPS; ties
    (100, 3, 100, False), (1000, 3, 1, False), (1001, 3, 64, False),
    (46, 5, 20, True),
])
def test_furthest_point_sample_matches_plain(dev, n, c, s, dup):
    pts = _cloud(dev, n, c, n + c + s, dup)
    before = pointnet.furthest_point_sample.launches
    got = pointnet.furthest_point_sample(pts, s)
    want = pointnet.furthest_point_sample_plain(pts, s)
    torch.cuda.synchronize()
    assert pointnet.furthest_point_sample.launches == before + 1
    assert got.dtype == torch.int32 and got.device == pts.device
    assert torch.equal(got, want)
    if not dup:
        assert int(torch.unique(got).numel()) == s


def test_furthest_point_sample_rejects_what_it_cannot_take(dev):
    pts = _cloud(dev, 1000, 3, 0)
    with pytest.raises(ValueError, match="unsupported device"):
        pointnet.furthest_point_sample(pts.to("meta"), 10)
    with pytest.raises(TypeError, match="float32"):
        pointnet.furthest_point_sample(pts.double(), 10)
    with pytest.raises(ValueError, match="n_samples"):
        pointnet.furthest_point_sample(pts, 1001)
    with pytest.raises(ValueError, match="shared memory"):
        pointnet.furthest_point_sample(_cloud(dev, 60000, 3, 0), 10)


def _ray_inputs(dev, v, r, s, c, seed=0):
    """Sample points over a room (some above it, behind every camera:
    the cameras look down), 240x320 images, 59x80 feature maps, and the
    cameras of ``_cameras`` at 239x320."""
    rng = np.random.RandomState(seed)
    intrinsic, extr = _cameras(rng, v)
    pts = rng.uniform([-3, -3, -0.5], [3, 3, 3], (r, s, 3))
    pts[: r // 8, :, 2] += 50.0
    images = rng.uniform(0, 1, (v, 240, 320, 3))
    feats = rng.randn(v, 59, 80, c)
    proj = render.view_projection(intrinsic, extr, 1.0, dev)
    return [torch.from_numpy(a.astype(np.float32)).to(dev)
            for a in (pts, images, feats)] + [proj]


@pytest.mark.parametrize("v,r,s,c", [
    (50, 2048, 64, 32),  # one chunk of the render path
    (3, 37, 5, 8), (5, 100, 64, 1), (1, 1, 1, 32),
])
def test_ray_view_carry_matches_plain(dev, v, r, s, c):
    pts, images, feats, proj = _ray_inputs(dev, v, r, s, c, seed=v + r)
    before = render.ray_view_carry.launches
    got = render.ray_view_carry(pts, images, feats, proj, (239, 320))
    want = render.ray_view_carry_plain(pts, images, feats, proj, (239, 320))
    torch.cuda.synchronize()
    assert render.ray_view_carry.launches == before + 1
    assert [tuple(t.shape) for t in got] == [tuple(t.shape) for t in want]
    # counts exact; the sums follow the plain version's rounding in view
    # order (tolerance 1e-5 relative)
    assert torch.equal(got[3], want[3])
    for a, b in zip(got[:3], want[:3]):
        assert _rel(a, b) <= 1e-5
    if r >= 8:
        assert int((got[3] == 0).sum()) > 0 and float(got[3].max()) >= 2


def test_ray_view_carry_rejects_what_it_cannot_take(dev):
    pts, images, feats, proj = _ray_inputs(dev, 2, 16, 4, 32)
    with pytest.raises(TypeError, match="float32"):
        render.ray_view_carry(pts.double(), images, feats, proj, (239, 320))
    with pytest.raises(ValueError, match="feature channels"):
        render.ray_view_carry(pts, images, torch.cat([feats, feats], -1),
                              proj, (239, 320))
    with pytest.raises(ValueError, match="contiguous"):
        render.ray_view_carry(pts, images, feats[:, :, :40], proj,
                              (239, 320))
    with pytest.raises(ValueError, match="unsupported device"):
        render.ray_view_carry(pts.to("meta"), images, feats, proj,
                              (239, 320))


def test_entry_device_turns_tf32_off(dev):
    from nerfdet_tpu_torch.device import resolve_device

    torch.backends.cudnn.allow_tf32 = True
    assert resolve_device("cuda").type == "cuda"
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.backends.cuda.matmul.allow_tf32 is False
