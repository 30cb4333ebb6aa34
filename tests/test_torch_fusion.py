"""K1 (view-streaming voxel fusion) of the port against the JAX package.

On the CPU the wrapper runs the plain PyTorch version; its carry (sums,
squared sums, counts, mapped squared sums) is held against sums over the
JAX package's own back-projected (V, N, C) volume, and the fused
mean / exp(-var) against ``nerfdet_tpu.ops.voxel.fused_mean_cov``.
Tolerances: counts exact; sums 1e-5 relative (only the summation order
differs); mean and cov 1e-4 absolute (the variance cancels
``s2 - 2*mean*s1 + V*mean^2``). The kernel's factoring of the mapped
stream (phase A maps each pixel once, ``mapped_rows_plain``; phase B
gathers the mapped rows, the bias where a view does not see the voxel)
is held against the JAX scan's per-voxel product, 1e-5 relative. The
CUDA kernel itself is held against the plain version on the card in
``test_torch_kernels_cuda.py``.
"""

import numpy as np
import pytest

import jax
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
    """``invalid_fill`` and the rgb stream without the mapped one (the
    JAX function's concatenated form, which no model runs) are not
    ported; the depth gate and the in-scan rgb stream are held to JAX in
    ``test_torch_depth.py``. The rgb stream comes one way at a time, and
    the global volume takes both streams."""
    feats, points, proj, w_map, b_map, rgb = _scene()[:6]
    args = (torch.from_numpy(feats), torch.from_numpy(points),
            torch.from_numpy(proj))
    with pytest.raises(NotImplementedError, match="invalid_fill"):
        tvox.fused_mean_cov(*args, invalid_fill=torch.zeros(64))
    images = torch.zeros(3, 31, 40, 3)
    host = tuple(torch.from_numpy(r) for r in rgb)
    mapped = dict(mapped_kernel=torch.from_numpy(w_map),
                  mapped_bias=torch.from_numpy(b_map))
    with pytest.raises(ValueError, match="not both"):
        tvox.fused_mean_cov(*args, extra_features=images,
                            extra_projection=args[2], precomputed_extra=host,
                            **mapped)
    with pytest.raises(ValueError, match="together"):
        tvox.fused_mean_cov(*args, **mapped)
    with pytest.raises(ValueError, match="together"):
        tvox.fused_mean_cov(*args, precomputed_extra=host)
    with pytest.raises(ValueError, match="together"):
        tvox.fused_mean_cov(*args, extra_features=images,
                            extra_projection=args[2])


def _blind(proj, view):
    """``proj`` with ``view``'s pixels moved 1e4 to the right: the view
    sees no voxel."""
    proj = proj.copy()
    proj[view, 0] += np.float32(1e4) * proj[view, 2]
    return proj


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mapped_rows_plain_matches_jax_product(dtype):
    feats, _, _, w_map, b_map, _ = _scene(seed=2)
    v, fh, fw, c = feats.shape
    rows = jnp.asarray(feats).astype(dtype).astype(jnp.float32)
    want = np.asarray(rows.reshape(v, fh * fw, c) @ jnp.asarray(w_map)
                      + jnp.asarray(b_map))
    got = tvox.mapped_rows_plain(
        torch.from_numpy(feats).to(getattr(torch, dtype)),
        torch.from_numpy(w_map), torch.from_numpy(b_map))
    assert tuple(got.shape) == want.shape == (v, fh * fw, w_map.shape[1])
    assert got.dtype == torch.float32
    assert _rel(got.numpy(), want) <= 1e-5


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_per_pixel_factoring_matches_jax_s2m(dtype):
    """s2m as K1 computes it: the mapped rows once per pixel, gathered by
    ``pix``, the bias for an invalid pair, squares summed in view order;
    against the JAX scan body's ``contrib @ w + b`` per voxel and view."""
    feats, points, proj, w_map, b_map, _ = _scene(seed=3)
    proj = _blind(proj, 1)
    image_hw = (7, 10)
    jf = jnp.asarray(feats).astype(dtype)
    vol, _ = jvox.backproject_volume(jf, jnp.asarray(points),
                                     jnp.asarray(proj), image_hw=image_hw)
    want = jnp.zeros((points.shape[0], w_map.shape[1]), jnp.float32)
    for view in vol.astype(jnp.float32):
        mapped = view @ jnp.asarray(w_map) + jnp.asarray(b_map)
        want = want + mapped * mapped

    x, y, _, valid = tvox.project_points(torch.from_numpy(points),
                                         torch.from_numpy(proj), *image_hw)
    pix = tvox.pixel_index(x, y, valid, feats.shape[2])
    assert int((pix[1] >= 0).sum()) == 0  # the blind view
    seen = [torch.unique(p[p >= 0]).numel() for p in pix]
    assert sum(seen) < int((pix >= 0).sum())  # voxels share pixels
    b = torch.from_numpy(b_map)
    rows = tvox.mapped_rows_plain(
        torch.from_numpy(feats).to(getattr(torch, dtype)),
        torch.from_numpy(w_map), b)
    got = torch.zeros(tuple(want.shape))
    for p, r in zip(pix, rows):
        mapped = torch.where(p[:, None] >= 0, r[p.clamp(min=0).long()], b)
        got += mapped * mapped
    assert _rel(got.numpy(), np.asarray(want)) <= 1e-5


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("c", tvox.K1_CHANNELS)
def test_k1_shared_memory_fits_an_h100_block(c, itemsize):
    """Phase A's shared memory at every width K1 takes is within the
    232,448 bytes an H100 block may opt into."""
    assert tvox.fusion_smem_bytes(c, itemsize) <= 232448


def test_k1_main_path_holds_two_blocks_an_sm():
    """At the main path's C = 256 two phase A blocks share an SM's 228
    KB (1 KB of each block's is the system's)."""
    assert 2 * (tvox.fusion_smem_bytes(256, 4) + 1024) <= 228 * 1024


def test_k1_bf16_phase_a_holds_two_blocks_an_sm_and_every_width():
    """On bfloat16 maps phase A holds W's three bfloat16 pieces beside its
    ring: at the main path's C = 256 two blocks share an SM's 228 KB, and
    every width K1 takes fits a block (the ring has 3 stages at C =
    1024)."""
    assert 2 * (tvox.fusion_smem_bytes(256, 2) + 1024) <= 228 * 1024
    assert max(tvox.fusion_smem_bytes(c, 2)
               for c in tvox.K1_CHANNELS) <= 232448


@pytest.mark.parametrize("c,width", [(1, 32), (8, 32), (16, 32), (32, 32),
                                     (40, 64), (96, 128), (1024, 1024)])
def test_k1_runs_any_width_up_to_1024_padded_to_its_widths(c, width):
    """K1 takes C from 1 to 1024 on the card: the wrappers zero-pad the
    channels to ``k1_width(C)``, the least of ``K1_CHANNELS`` at or
    above it, and cut the outputs back (``test_fusion_carry_off_its_
    widths_runs_padded`` holds the kernels so on the card); the plain
    version's s1 at C is its padded s1's first C channels, bit for bit,
    and the padding sums zeros."""
    assert tvox.k1_width(c) == width
    rng = np.random.RandomState(c)
    feats = torch.from_numpy(rng.randn(2, 6, 10, c).astype(np.float32))
    padded = tvox._pad_channels(feats, width)
    assert padded.shape == (2, 6, 10, width) and padded.is_contiguous()
    pix = torch.from_numpy(rng.randint(-1, 60, (2, 50)).astype(np.int32))
    narrow = tvox.fusion_carry_plain(feats, pix)
    wide = tvox.fusion_carry_plain(padded, pix)
    assert torch.equal(wide[0][:, :c], narrow[0])
    assert torch.equal(wide[1][:, :c], narrow[1])
    assert float(wide[0][:, c:].abs().sum()) == 0.0


@pytest.mark.parametrize("c", [0, 1025])
def test_k1_refuses_widths_past_1024(c):
    with pytest.raises(ValueError, match="1 to 1024 channels"):
        tvox.k1_width(c)


def _shared_pixel_scene(seed, c=32, m=8):
    """The card tests' scene at C channels, M mapped outputs and 3 views;
    its pixel indices put several voxels on one pixel of each view."""
    feats, points, proj, w_map, b_map, rgb = _scene(seed=seed, c=c, m=m)
    x, y, _, valid = tvox.project_points(torch.from_numpy(points),
                                         torch.from_numpy(proj), 7, 10)
    pix = tvox.pixel_index(x, y, valid, feats.shape[2])
    seen = [torch.unique(p[p >= 0]).numel() for p in pix]
    assert sum(seen) < int((pix >= 0).sum())  # voxels share pixels
    return feats, points, proj, w_map, b_map, rgb, pix


def test_fused_mean_cov_gradients_match_jax():
    """d features, dW and db of every output (mean, cov, g_mean, g_cov)
    under random cotangents, through the port's K1 Function (the plain
    backward on the CPU), against ``jax.grad`` of the JAX scan; 1e-4 x
    max |g| (float32, other summation orders)."""
    feats, points, proj, w_map, b_map, rgb, _ = _shared_pixel_scene(4)
    image_hw = (7, 10)
    rng = np.random.RandomState(5)
    n, c, m = points.shape[0], feats.shape[-1], w_map.shape[1]
    cots = [rng.randn(n, c), rng.randn(n, c), rng.randn(n, 3 + m),
            rng.randn(n, 3 + m)]
    cots = [a.astype(np.float32) for a in cots]

    def jloss(f, w, b):
        out = jvox.fused_mean_cov(
            f, jnp.asarray(points), jnp.asarray(proj), image_hw=image_hw,
            mapped_kernel=w, mapped_bias=b,
            precomputed_extra=tuple(jnp.asarray(r) for r in rgb))
        return sum(jnp.sum(o * jnp.asarray(t))
                   for o, t in zip(out[:2] + out[3:], cots))

    want = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(feats), jnp.asarray(w_map), jnp.asarray(b_map))
    f = torch.tensor(feats, requires_grad=True)
    w = torch.tensor(w_map, requires_grad=True)
    b = torch.tensor(b_map, requires_grad=True)
    out = tvox.fused_mean_cov(
        f, torch.from_numpy(points), torch.from_numpy(proj),
        image_hw=image_hw, mapped_kernel=w, mapped_bias=b,
        precomputed_extra=tuple(torch.from_numpy(r) for r in rgb))
    assert not out[2].requires_grad  # count
    sum((o * torch.from_numpy(t)).sum()
        for o, t in zip(out[:2] + out[3:], cots)).backward()
    for got, ref in zip((f.grad, w.grad, b.grad), want):
        ref = np.asarray(ref)
        assert got.shape == ref.shape
        assert np.abs(got.numpy() - ref).max() <= 1e-4 * np.abs(ref).max()


@pytest.mark.parametrize("mapped", [False, True])
@pytest.mark.parametrize("with_g2", [False, True])
def test_backward_plain_equals_autograd_through_plain(mapped, with_g2):
    """``fusion_carry_backward_plain`` against torch autograd through
    ``fusion_carry_plain`` (1e-5 x max |g|): the per-pixel factoring,
    the unseen views' bias term and a None g2 (the mean volume)."""
    feats, _, proj, w_map, b_map, _, pix = _shared_pixel_scene(6)
    pix[1, :] = -1  # a view that sees no voxel
    rng = np.random.RandomState(7)
    n, c, m = pix.shape[1], feats.shape[-1], w_map.shape[1]
    g1 = torch.from_numpy(rng.randn(n, c).astype(np.float32))
    g2 = torch.from_numpy(rng.randn(n, c).astype(np.float32))
    gm = torch.from_numpy(rng.randn(n, m).astype(np.float32))
    f = torch.tensor(feats, requires_grad=True)
    w = torch.tensor(w_map, requires_grad=True) if mapped else None
    b = torch.tensor(b_map, requires_grad=True) if mapped else None
    s1, s2, count, s2m = tvox.fusion_carry_plain(f, pix, w, b)
    outs, cots = [s1], [g1]
    if with_g2:
        outs, cots = outs + [s2], cots + [g2]
    if mapped:
        outs, cots = outs + [s2m], cots + [gm]
    inputs = [f] + ([w, b] if mapped else [])
    want = torch.autograd.grad(outs, inputs, cots)
    got = tvox.fusion_carry_backward_plain(
        f.detach(), pix, count, g1, g2 if with_g2 else None,
        gm if mapped else None, w, b)
    if not mapped:
        assert got[1] is None and got[2] is None
    for a, r in zip(got, want):
        assert np.abs((a - r).numpy()).max() <= 1e-5 * float(r.abs().max())


def test_fusion_carry_function_wiring():
    """The autograd Function on the CPU: count takes no gradient, a
    missing mapped stream gives no gradient to W and b, the backward
    counter does not move (the plain version runs), bfloat16 maps take a
    bfloat16 gradient, and float16 maps are refused."""
    feats, _, _, w_map, b_map, _, pix = _shared_pixel_scene(8)
    f = torch.tensor(feats, requires_grad=True)
    before = tvox.fusion_carry_backward.launches
    s1, s2, count, s2m = tvox.fusion_carry(f, pix)
    assert s2m is None and not count.requires_grad
    s1.sum().backward()
    want = tvox.fusion_carry_backward_plain(
        f.detach(), pix, count, torch.ones_like(s1))[0]
    assert torch.equal(f.grad, want)
    assert tvox.fusion_carry_backward.launches == before
    fb = f.detach().bfloat16().requires_grad_()
    tvox.fusion_carry(fb, pix)[0].sum().backward()
    assert fb.grad.dtype == torch.bfloat16
    assert tvox.fusion_carry_backward.launches == before
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tvox.fusion_carry(f.detach().half().requires_grad_(), pix)
    with torch.no_grad():
        out = tvox.fusion_carry(f.bfloat16(), pix, torch.from_numpy(w_map),
                                torch.from_numpy(b_map))
    assert out[3].dtype == torch.float32
