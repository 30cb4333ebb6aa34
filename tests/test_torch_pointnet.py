"""The port's PointNet++ point ops against the JAX package, on the CPU.

K3's wrapper takes its plain version for a CPU tensor; its indices must
equal both the XLA twin (``_furthest_point_sample_xla``) and the
interpreted Pallas kernel (``fps_pallas(..., interpret=True)``) index for
index, on the cases of ``tests/test_pallas_fps.py``. Ball query indices
are exact too, fill semantics included; the float ops agree within 1e-6.
Inputs come from numpy seeds.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from nerfdet_tpu.ops import pointnet as jp
from nerfdet_tpu.ops.pallas_fps import fps_pallas

from nerfdet_tpu_torch.ops import pointnet as tp


def _t(x):
    return torch.tensor(np.asarray(x, np.float32))


def _duplicated():
    base = np.random.RandomState(3).randn(40, 3).astype(np.float32)
    return np.concatenate([base, base], axis=0)


@pytest.mark.parametrize("case", [
    ("normal", 97, 3, 16), ("normal", 128, 3, 32), ("normal", 500, 3, 64),
    ("normal", 200, 19, 24), ("duplicated", 80, 3, 12),
], ids=lambda c: f"{c[0]}-{c[1]}x{c[2]}-s{c[3]}")
def test_furthest_point_sample_matches_jax(case):
    kind, n, c, s = case
    pts = (_duplicated() if kind == "duplicated" else
           np.random.RandomState(n + c).randn(n, c).astype(np.float32))
    before = tp.furthest_point_sample.launches
    got = tp.furthest_point_sample(_t(pts), s)
    assert tp.furthest_point_sample.launches == before  # plain on the CPU
    assert got.dtype == torch.int32 and got.shape == (s,)
    xla = np.asarray(jp._furthest_point_sample_xla(jnp.asarray(pts), s))
    pallas = np.asarray(fps_pallas(jnp.asarray(pts), s, interpret=True))
    np.testing.assert_array_equal(got.numpy(), xla)
    np.testing.assert_array_equal(got.numpy(), pallas)
    if kind == "normal":
        assert len(set(got.tolist())) == s


def test_furthest_point_sample_edges():
    """S=1 returns [0]; S=N visits every point once."""
    pts = np.random.RandomState(11).randn(37, 3).astype(np.float32)
    assert tp.furthest_point_sample(_t(pts), 1).tolist() == [0]
    got = tp.furthest_point_sample(_t(pts), 37)
    want = np.asarray(jp._furthest_point_sample_xla(jnp.asarray(pts), 37))
    np.testing.assert_array_equal(got.numpy(), want)
    assert sorted(got.tolist()) == list(range(37))


def test_square_distance():
    rng = np.random.RandomState(5)
    a = rng.uniform(-3, 3, (60, 3)).astype(np.float32)
    b = rng.uniform(-3, 3, (90, 3)).astype(np.float32)
    want = np.asarray(jp.square_distance(jnp.asarray(a), jnp.asarray(b)))
    got = tp.square_distance(_t(a), _t(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert (got >= 0).all()


@pytest.mark.parametrize("radius,k", [(0.2, 64), (0.4, 32), (0.8, 16),
                                      (1.2, 16), (0.5, 300)])
def test_ball_query_matches_jax(radius, k):
    """Indices equal, fill included: the first centers have a few hits
    (slots repeat the first hit), the last one none (all zeros). K=300
    exceeds the 250 points."""
    rng = np.random.RandomState(int(radius * 10) + k)
    pts = rng.uniform(-2, 2, (250, 3)).astype(np.float32)
    centers = np.concatenate([
        pts[rng.choice(250, 40, replace=False)],
        pts[:1] + np.float32(radius) * 0.1,      # close to point 0
        np.full((1, 3), 50.0, np.float32),       # no hit at all
    ])
    want = np.asarray(jp.ball_query(jnp.asarray(centers), jnp.asarray(pts),
                                    radius, k))
    got = tp.ball_query(_t(centers), _t(pts), radius, k)
    assert got.dtype == torch.int32 and got.shape == (42, k)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want[-1] == 0).all()
    hits = (np.asarray(jp.square_distance(jnp.asarray(centers),
                                          jnp.asarray(pts)))
            < radius * radius).sum(1)
    assert (hits[:-1] < k).any(), "no partially filled row"


def test_gather_and_group_points():
    rng = np.random.RandomState(8)
    pts = rng.uniform(-1, 1, (120, 3)).astype(np.float32)
    feats = rng.randn(120, 5).astype(np.float32)
    idx = np.asarray(jp.furthest_point_sample(jnp.asarray(pts), 20))
    gi = np.asarray(jp.ball_query(jnp.asarray(pts[idx]), jnp.asarray(pts),
                                  0.5, 8))
    np.testing.assert_array_equal(
        tp.gather_points(_t(feats), torch.tensor(idx)).numpy(),
        np.asarray(jp.gather_points(jnp.asarray(feats), jnp.asarray(idx))))
    for use_xyz in (True, False):
        for f in (feats, None):
            want = np.asarray(jp.group_points(
                jnp.asarray(pts), None if f is None else jnp.asarray(f),
                jnp.asarray(idx), jnp.asarray(gi), use_xyz=use_xyz))
            got = tp.group_points(_t(pts), None if f is None else _t(f),
                                  torch.tensor(idx),
                                  torch.tensor(gi), use_xyz=use_xyz)
            np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_three_nn_ties_and_interpolate():
    """Integer grids give exact distance ties; the lower index wins, as
    ``lax.top_k`` breaks them. Inside its jit XLA may fuse the expansion
    ``|a|^2 - 2 a.b + |b|^2`` into a multiply-add that rounds once where
    torch rounds twice, so the squared distances may differ by a few
    ulps of the expansion's terms (up to 2 * 27 here); the indices and,
    on the same inputs, the weights and the interpolation agree within
    1e-6."""
    g = np.arange(4, dtype=np.float32)
    known = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    rng = np.random.RandomState(9)
    unknown = np.concatenate([
        known[rng.choice(len(known), 10, replace=False)] + 0.5,  # 8-way ties
        rng.uniform(0, 3, (30, 3)).astype(np.float32)])
    jd, ji = jp.three_nn(jnp.asarray(unknown), jnp.asarray(known))
    td, ti = tp.three_nn(_t(unknown), _t(known))
    assert ti.dtype == torch.int32
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    terms = np.float32(2 * 27.0)
    np.testing.assert_allclose(td.numpy() ** 2, np.asarray(jd) ** 2, rtol=0,
                               atol=4 * np.spacing(terms))
    feats = rng.randn(len(known), 6).astype(np.float32)
    jw = jp.interpolation_weights(jd)
    tw = tp.interpolation_weights(_t(np.asarray(jd)))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=0,
                               atol=1e-6)
    want = np.asarray(jp.three_interpolate(jnp.asarray(feats), ji, jw))
    got = tp.three_interpolate(_t(feats), ti, _t(np.asarray(jw))).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
