"""The port's CUDA kernels against their plain PyTorch versions, on the
card. They have no CPU mode, so without CUDA every test here skips.

This file imports only torch, numpy and the port, so it runs where JAX
is absent; skip the suite's JAX conftest there:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py
"""

import numpy as np
import pytest
import torch

from nerfdet_tpu_torch.ops import voxel

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


def test_entry_device_turns_tf32_off(dev):
    from nerfdet_tpu_torch.device import resolve_device

    torch.backends.cudnn.allow_tf32 = True
    assert resolve_device("cuda").type == "cuda"
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.backends.cuda.matmul.allow_tf32 is False
