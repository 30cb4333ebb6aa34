"""K1 (view-streaming voxel fusion) of the port against the JAX package.

On the CPU the wrapper runs the plain PyTorch version; its carry (sums,
squared sums, counts, mapped squared sums) is held against sums over the
JAX package's own back-projected (V, N, C) volume, and the fused
mean / exp(-var) against ``nerfdet_tpu.ops.voxel.fused_mean_cov``.
Tolerances: counts exact; sums 1e-5 relative (only the summation order
differs); mean and cov 1e-4 absolute (the variance cancels
``s2 - 2*mean*s1 + V*mean^2``). The CUDA kernel itself is held against
the plain version on the card in ``test_torch_kernels_cuda.py``.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from nerfdet_tpu.ops import voxel as jvox
from nerfdet_tpu_torch.ops import voxel as tvox


@pytest.fixture(autouse=True, scope="module")
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _scene(seed=0, v=3, fh=8, fw=10, c=64, m=8, nvox=(8, 8, 4)):
    rng = np.random.RandomState(seed)
    feats = rng.randn(v, fh, fw, c).astype(np.float32)
    intrinsic = np.array([[144.0, 0, 80.0], [0, 144.0, 64.0], [0, 0, 1]],
                         np.float32)
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
    extr = np.asarray(extr, np.float32)
    points = tvox.get_points(nvox, (0.8, 0.8, 0.8), (0, 0, 0.5)).reshape(
        -1, 3).numpy()
    proj = tvox.compute_projection(intrinsic, extr, 128 / (31 / 4)).numpy()
    w_map = (rng.randn(c, m) / np.sqrt(c)).astype(np.float32)
    b_map = rng.randn(m).astype(np.float32)
    n = points.shape[0]
    rgb = (rng.rand(n, 3).astype(np.float32) * v,
           rng.rand(n, 3).astype(np.float32) * v)
    return feats, points, proj, w_map, b_map, rgb


def _rel(a, b):
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-12)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_carry_matches_jax_volume_sums(dtype):
    feats, points, proj, w_map, b_map, _ = _scene()
    image_hw = (7, 10)
    jf = jnp.asarray(feats).astype(dtype)
    vol, valid = jvox.backproject_volume(jf, jnp.asarray(points),
                                         jnp.asarray(proj),
                                         image_hw=image_hw)
    vol = np.asarray(vol.astype(jnp.float32), np.float64)
    valid = np.asarray(valid)
    mapped = vol @ w_map.astype(np.float64) + b_map  # invalid rows -> b

    tf = torch.from_numpy(feats).to(getattr(torch, dtype))
    x, y, _, tvalid = tvox.project_points(torch.from_numpy(points),
                                          torch.from_numpy(proj), *image_hw)
    pix = tvox.pixel_index(x, y, tvalid, feats.shape[2])
    before = tvox.fusion_carry.launches
    s1, s2, count, s2m = tvox.fusion_carry(
        tf, pix, torch.from_numpy(w_map), torch.from_numpy(b_map))
    assert tvox.fusion_carry.launches == before  # CPU: plain version

    np.testing.assert_array_equal(count.numpy(), valid.sum(0))
    assert _rel(s1.numpy(), vol.sum(0)) <= 1e-5
    assert _rel(s2.numpy(), (vol * vol).sum(0)) <= 1e-5
    assert _rel(s2m.numpy(), (mapped * mapped).sum(0)) <= 1e-5


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mapped", [False, True])
def test_fused_mean_cov_matches_jax(dtype, mapped):
    feats, points, proj, w_map, b_map, rgb = _scene(seed=1)
    image_hw = (7, 10)
    kw_j, kw_t = {}, {}
    if mapped:
        kw_j = dict(mapped_kernel=jnp.asarray(w_map),
                    mapped_bias=jnp.asarray(b_map),
                    precomputed_extra=tuple(jnp.asarray(r) for r in rgb))
        kw_t = dict(mapped_kernel=torch.from_numpy(w_map),
                    mapped_bias=torch.from_numpy(b_map),
                    precomputed_extra=tuple(torch.from_numpy(r)
                                            for r in rgb))
    out_j = jvox.fused_mean_cov(jnp.asarray(feats).astype(dtype),
                                jnp.asarray(points), jnp.asarray(proj),
                                image_hw=image_hw, **kw_j)
    out_t = tvox.fused_mean_cov(
        torch.from_numpy(feats).to(getattr(torch, dtype)),
        torch.from_numpy(points), torch.from_numpy(proj),
        image_hw=image_hw, **kw_t)
    assert len(out_j) == len(out_t) == (5 if mapped else 3)
    np.testing.assert_array_equal(out_t[2].numpy(), np.asarray(out_j[2]))
    assert out_t[2].numpy().max() >= 2  # voxels seen by several views
    for k in (0, 1) + ((3, 4) if mapped else ()):
        a, b = out_t[k].numpy(), np.asarray(out_j[k])
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4)


def test_unported_forms_raise():
    feats, points, proj, *_ = _scene()
    args = (torch.from_numpy(feats), torch.from_numpy(points),
            torch.from_numpy(proj))
    with pytest.raises(NotImplementedError, match="depth_sp"):
        tvox.fused_mean_cov(*args, depth=torch.zeros(3, 31, 40))
    with pytest.raises(NotImplementedError, match="depth_sp"):
        tvox.fused_mean_cov(*args, extra_features=torch.zeros(3, 31, 40, 3))
