"""Port geometry against the JAX package: voxel grid, projection,
nearest-pixel rounding (with half-pixel ties) and the featmap crop
bounds. Pixel indices and view counts must be identical."""

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


def _random_cameras(rng, v, h, w):
    intrinsic = np.array([[0.9 * w, 0, w / 2, 0], [0, 0.9 * w, h / 2, 0],
                          [0, 0, 1, 0], [0, 0, 0, 1]], np.float32)
    extr = []
    for i in range(v):
        a = 2 * np.pi * i / v + rng.uniform(-0.1, 0.1)
        c, s = np.cos(a), np.sin(a)
        # camera on a circle looking at the origin (+z forward)
        pos = np.array([3.5 * c, 3.5 * s, 1.5])
        fwd = -pos / np.linalg.norm(pos)
        right = np.cross(fwd, [0, 0, 1.0])
        right /= np.linalg.norm(right)
        down = np.cross(fwd, right)
        c2w = np.eye(4)
        c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, down, fwd, pos
        extr.append(np.linalg.inv(c2w))
    return intrinsic, np.asarray(extr, np.float32)


def _tie_cameras(v):
    """Axis-aligned cameras with dyadic geometry: voxel centers land on
    exact half pixels, where one ulp would flip the rounding."""
    intrinsic = np.array([[4.0, 0, 8.0, 0], [0, 4.0, 6.0, 0],
                          [0, 0, 1, 0], [0, 0, 0, 1]], np.float32)
    extr = np.tile(np.eye(4, dtype=np.float32), (v, 1, 1))
    for i in range(v):
        extr[i, :3, 3] = [0.125 * i, -0.25 * i, 4.0 + 0.5 * i]
    return intrinsic, extr


def test_get_points_bitwise():
    for n_vox, vsz, origin in (((8, 8, 4), (0.8, 0.8, 0.8), (0, 0, 0.5)),
                               ((40, 40, 16), (0.16, 0.16, 0.2),
                                (0.1, -0.3, 0.5))):
        a = np.asarray(jvox.get_points(n_vox, vsz, origin))
        b = tvox.get_points(n_vox, vsz, origin).numpy()
        assert a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("ratio", [1.0, 968 / (239 / 4), 4.0])
def test_compute_projection(ratio):
    rng = np.random.RandomState(0)
    intrinsic, extr = _random_cameras(rng, 5, 31, 40)
    a = np.asarray(jvox.compute_projection(intrinsic, extr, ratio))
    b = tvox.compute_projection(intrinsic, extr, ratio).numpy()
    np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-6)


def _project_both(points, intrinsic, extr, ratio, h, w):
    pj = jvox.compute_projection(intrinsic, extr, ratio)
    xj, yj, zj, vj = (np.asarray(t) for t in jvox.project_points(
        jnp.asarray(points), pj, h, w))
    pt = tvox.compute_projection(intrinsic, extr, ratio)
    xt, yt, zt, vt = tvox.project_points(torch.from_numpy(points), pt, h, w)
    return (xj, yj, zj, vj), (xt.numpy(), yt.numpy(), zt.numpy(),
                              vt.numpy())


def test_project_points_scene():
    rng = np.random.RandomState(1)
    intrinsic, extr = _random_cameras(rng, 6, 128, 160)
    points = tvox.get_points((12, 12, 6), (0.5, 0.5, 0.4),
                             (0, 0, 0.5)).reshape(-1, 3).numpy()
    (xj, yj, zj, vj), (xt, yt, zt, vt) = _project_both(
        points, intrinsic, extr, 128 / (31 / 4), 7, 10)
    assert vj.sum() > 100
    np.testing.assert_array_equal(vt, vj)
    np.testing.assert_array_equal(xt[vj], xj[vj])
    np.testing.assert_array_equal(yt[vj], yj[vj])
    np.testing.assert_allclose(zt, zj, rtol=1e-6, atol=1e-6)


def test_project_points_half_pixel_ties():
    intrinsic, extr = _tie_cameras(3)
    points = tvox.get_points((8, 8, 4), (0.5, 0.5, 0.5),
                             (0, 0, 0)).reshape(-1, 3).numpy()
    (xj, yj, _, vj), (xt, yt, _, vt) = _project_both(
        points, intrinsic, extr, 1.0, 12, 16)
    # the scene has ties: exact .5 pixel coordinates among valid voxels
    p = tvox.compute_projection(intrinsic, extr, 1.0).numpy()
    cam = np.einsum("vij,nj->vin", p.astype(np.float64),
                    np.concatenate([points, np.ones_like(points[:, :1])],
                                   axis=1).astype(np.float64))
    u = cam[:, 0] / cam[:, 2]
    ties = (np.abs(u - np.floor(u) - 0.5) == 0) & vj
    assert ties.sum() > 20
    np.testing.assert_array_equal(vt, vj)
    np.testing.assert_array_equal(xt, xj)
    np.testing.assert_array_equal(yt, yj)
    # half to even: a tie at 2.5 goes to 2, at 3.5 to 4
    assert np.all(xt[ties] % 2 == 0)


def test_pixel_index_crop_bounds():
    """Validity uses image_hw (img_shape // stride), not the padded map:
    row 7 of an 8-row map lies outside a 31-row image at stride 4."""
    rng = np.random.RandomState(2)
    intrinsic, extr = _random_cameras(rng, 4, 128, 160)
    points = tvox.get_points((16, 16, 6), (0.4, 0.4, 0.4),
                             (0, 0, 0.5)).reshape(-1, 3)
    proj = tvox.compute_projection(intrinsic, extr, 128 / (31 / 4))
    x, y, _, valid = tvox.project_points(points, proj, 7, 10)
    _, y_pad, _, valid_pad = tvox.project_points(points, proj, 8, 10)
    assert (valid_pad & ~valid).sum() > 0  # the crop matters here
    assert int(y[valid].max()) <= 6
    pix = tvox.pixel_index(x, y, valid, 10).numpy()
    xn, yn, vn = x.numpy(), y.numpy(), valid.numpy()
    np.testing.assert_array_equal(pix[vn], (yn * 10 + xn)[vn])
    assert np.all(pix[~vn] == -1)
    # the JAX package bounds the same way
    _, _, _, vj = jvox.project_points(
        jnp.asarray(points.numpy()),
        jvox.compute_projection(intrinsic, extr, 128 / (31 / 4)), 7, 10)
    np.testing.assert_array_equal(vn, np.asarray(vj))
