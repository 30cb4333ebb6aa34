"""The passes of K1's and K2's backwards on bfloat16 maps, as plain
twins on the CPU, composed against the whole plain versions bit for bit.

On the card each backward runs as passes (``ops/render.py``: pass 0
``_backward_keys``, the index preparation ``_window_rank_launch``, pass
1a ``_pair_df``, pass 1b ``_window_sums_bf16``, pass 2 ``_unpack``;
``ops/voxel.py``: ``pixel_order`` then pass 1 ``_pixel_sums``). Each pass
has a plain twin of the same signature (``backward_keys_plain``,
``window_rank_plain``, ``pair_df_plain``, ``window_sums_bf16_plain``,
``unpack_plain``; ``pixel_order_plain``, ``pixel_sums_plain``), which
the card tests in ``test_torch_kernels_cuda.py`` hold each kernel to.
Here the twins, chained as the kernels are, give exactly
``_backward_plain_bf16`` and ``_pair_cotangents_bf16``, which
``test_torch_bf16.py`` holds bit for bit to ``jax.grad`` of the JAX
scans. Toy shapes, no JAX: light on time and memory.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from nerfdet_tpu_torch.ops import render, voxel

IMG = (239, 320)


@pytest.fixture(autouse=True, scope="module")
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


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


def _k2_inputs(case, v=5, r=40, s=16, c=8, seed=3):
    """K2's backward arguments on bfloat16 maps from the plain forward:
    points over a room ("border": pushed to the maps' edge band, where
    windows clamp and weights are partial; "interior": near the centre,
    so windows hold many pairs; "behind": behind every camera, so every
    pair is dropped) and a random cotangent."""
    rng = np.random.RandomState(seed)
    intrinsic, extr = _cameras(rng, v)
    pts = rng.uniform([-3, -3, -0.5], [3, 3, 3], (r, s, 3))
    pts = {"scene": pts, "border": pts * 2.5, "interior": pts * 0.3,
           "behind": pts + [0.0, 0.0, 60.0]}[case]
    pts = torch.from_numpy(pts.astype(np.float32))
    feats = torch.from_numpy(rng.randn(v, 59, 80, c).astype(
        np.float32)).bfloat16()
    proj = render.view_projection(intrinsic, extr, 1.0)
    gf, _ = render.streaming_sample_mean_var_plain(pts, None, proj, IMG,
                                                   feats)
    carry = render.ray_view_carry_plain(pts, None, feats, proj, IMG)
    g = torch.from_numpy(rng.randn(*gf.shape).astype(np.float32))
    return pts, proj, IMG, feats, g, gf, carry[0], carry[3]


@pytest.mark.parametrize("case", ["scene", "border", "interior", "behind"])
def test_k2_bf16_twins_compose_to_the_plain_backward(case):
    """keys -> rank -> df at the slots -> window sums -> unpack, each a
    plain twin, give ``_backward_plain_bf16``'s d featmaps bit for bit;
    pass 0 writes no cotangent rows on bfloat16 maps; every kept pair
    has a slot and its weights, and the slots past them stay zero."""
    args = _k2_inputs(case)
    feats = args[3]
    v, fh, fw, _ = feats.shape
    keys, coef = render.backward_keys_plain(*args)
    assert coef is None and keys.dtype == torch.int32
    rank, off = render.window_rank(keys, v * fh * fw)
    df, wts = render.pair_df_plain(*args, rank)
    packed = render.window_sums_bf16_plain(df, wts, off, feats)
    got = render.unpack_plain(packed, off, feats)
    want = render._backward_plain_bf16(*args)
    assert got.dtype == want.dtype == torch.bfloat16
    assert torch.equal(got, want)
    kept = int(off[-1])
    assert kept == int((keys < v * fh * fw).sum())
    assert bool((wts[:kept].float() != 0).any(-1).all())
    assert not df[kept:].float().any() and not wts[kept:].float().any()
    if case == "behind":
        assert kept == 0 and not got.float().any()
    else:
        assert kept > 0 and got.float().abs().max() > 0


def test_k2_float32_keys_twin_matches_the_plain_cotangents():
    """On float32 maps pass 0's twin also gives the points' cotangent
    rows (d s1u + d s1m, d s1u, d s2u), and its keys are the bfloat16
    maps' keys: both dtypes key a pair by the same window."""
    args = list(_k2_inputs("scene"))
    keys_bf, _ = render.backward_keys_plain(*args)
    args[3] = args[3].float()
    keys, coef = render.backward_keys_plain(*args)
    d_s1u, d_s2u, d_s1m = render._point_cotangents(
        args[4], args[5], args[6], args[7], args[3].shape[0])
    assert torch.equal(keys, keys_bf)
    assert torch.equal(coef, torch.stack([d_s1u + d_s1m, d_s1u, d_s2u], 1))


@settings(max_examples=30, deadline=None)
@given(st.tuples(st.integers(1, 5), st.integers(1, 300), st.integers(1, 40),
                 st.floats(0.0, 1.0), st.integers(0, 2 ** 31 - 1)))
def test_window_rank_inverts_window_order(case):
    """The rank of each kept pair is its place in ``window_order``'s
    order (rank[order[j]] = j), -1 for a dropped pair; ``off`` is the
    order's."""
    v, n, hw, drop, seed = case
    rng = np.random.RandomState(seed)
    keys = rng.randint(0, hw, (v, n)) + (np.arange(v) * hw)[:, None]
    keys[rng.rand(v, n) < drop] = v * hw
    keys = torch.from_numpy(keys.astype(np.int32))
    order, off = render.window_order(keys, v * hw)
    rank, off_r = render.window_rank(keys, v * hw)
    kept = int(off[-1])
    assert rank.dtype == torch.int32 and torch.equal(off_r, off)
    assert torch.equal(rank[order[:kept].long()],
                       torch.arange(kept, dtype=torch.int32))
    dropped = keys.reshape(-1) >= v * hw
    assert bool((rank[dropped] == -1).all())
    assert bool((rank[~dropped] >= 0).all())


def _k1_inputs(case, mapped, with_g2, seed=0):
    """K1's backward arguments on bfloat16 maps: 4 views of 6x8 rows, C =
    32, 300 voxels, many on one pixel (so a row holds more pairs than a
    kernel's group, and groups straddle rows); "blind view": view 1 sees
    no voxel."""
    rng = np.random.RandomState(seed)
    v, h, w, c, m, n = 4, 6, 8, 32, 8, 300
    pix = rng.randint(0, h * w, (v, n))
    pix[rng.rand(v, n) < 0.2] = -1
    pix[:, :20] = 17  # 20 voxels on one pixel of every view
    if case == "blind view":
        pix[1] = -1
    t = {"pix": torch.from_numpy(pix.astype(np.int32)),
         "feats": torch.from_numpy(rng.randn(v, h, w, c).astype(
             np.float32)).bfloat16(),
         "g1": torch.from_numpy(rng.randn(n, c).astype(np.float32)),
         "g2": (torch.from_numpy(rng.randn(n, c).astype(np.float32))
                if with_g2 else None),
         "w": None, "b": None, "gm": None, "mapped": None}
    if mapped:
        t["w"] = torch.from_numpy(rng.randn(c, m).astype(np.float32) / 6)
        t["b"] = torch.from_numpy(rng.randn(m).astype(np.float32))
        t["gm"] = torch.from_numpy(rng.randn(n, m).astype(np.float32))
        t["mapped"] = voxel.mapped_rows_plain(t["feats"], t["w"], t["b"])
    return t


@pytest.mark.parametrize("with_g2", [False, True])
@pytest.mark.parametrize("mapped", [False, True])
@pytest.mark.parametrize("case", ["scene", "blind view"])
def test_k1_bf16_twins_compose_to_the_plain_pair_cotangents(case, mapped,
                                                            with_g2):
    """``pixel_order`` -> pass 1's twin gives ``_pair_cotangents_bf16``'s
    d features bit for bit (each pair rounded, then summed in voxel
    order), zeros on rows no voxel maps to; its dY, summed as pass 2 sums
    it (x^T dY), is the plain backward's dW."""
    t = _k1_inputs(case, mapped, with_g2)
    feats, pix = t["feats"], t["pix"]
    v, h, w, c = feats.shape
    order, off, _, _ = voxel.pixel_order(pix, h * w)
    got, dy = voxel.pixel_sums_plain(feats, order, off, t["g1"], t["g2"],
                                     t["gm"], t["mapped"], t["w"])
    x = feats.float().reshape(v, h * w, c)
    want = voxel._pair_cotangents_bf16(x, pix, t["g1"], t["g2"], t["gm"],
                                       t["w"], t["mapped"])
    assert got.dtype == torch.bfloat16 and got.shape == feats.shape
    assert torch.equal(got.float().reshape(v, h * w, c), want)
    if case == "blind view":
        assert not got[1].float().any()
    count = (pix >= 0).float().sum(0)
    full = voxel.fusion_carry_backward_plain(
        feats, pix, count, t["g1"], t["g2"], t["gm"], t["w"], t["b"],
        t["mapped"])
    assert torch.equal(got, full[0])
    if mapped:
        d_w = torch.einsum("vpc,vpm->cm", x, dy)
        assert float((d_w - full[1]).abs().max()) <= 1e-5 * float(
            full[1].abs().max())
    else:
        assert dy is None and full[1] is None
