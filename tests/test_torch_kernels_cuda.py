"""The port's CUDA kernels against their plain PyTorch versions, on the
card. They have no CPU mode, so without CUDA every test here skips.

This file imports only torch, numpy and the port, so it runs where JAX
is absent; skip the suite's JAX conftest there:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py
"""

import numpy as np
import pytest
import torch

from nerfdet_tpu_torch.device import resolve_device
from nerfdet_tpu_torch.ops import pointnet, render, voxel

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    """The card as the port takes it: ``resolve_device`` turns TF32 off,
    so cuDNN convs and matmuls on both sides of a comparison are float32."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return resolve_device("cuda")


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


def _unaligned(t):
    """A contiguous copy of ``t`` one element off a 16-byte boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    assert out.is_contiguous() and out.data_ptr() % 16 != 0
    return out


def _fusion_case(dev, case):
    """K1's pixel indices for one case: the card tests' scene; N = 315, a
    multiple of no phase B tile; view 2 seeing no voxel; half the voxels
    on one pixel in every view."""
    if case == "ragged N":
        return _pix(dev, nvox=(7, 9, 5))
    pix = _pix(dev)
    if case == "blind view":
        pix[2] = -1
    elif case == "one pixel":
        pix[:, ::2] = 1234
    return pix


@pytest.mark.parametrize("case", ["scene", "ragged N", "blind view",
                                  "one pixel", "unaligned map"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mapped", [False, True])
@pytest.mark.parametrize("c", [32, 64, 256])
def test_fusion_carry_matches_plain(dev, dtype, mapped, c, case):
    pix = _fusion_case(dev, case)
    gen = torch.Generator(device=dev).manual_seed(0)
    feats = torch.randn((pix.shape[0], 60, 80, c), generator=gen,
                        device=dev).to(dtype)
    if case == "unaligned map":  # both phases take narrow loads
        feats = _unaligned(feats)
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
    if case == "blind view":
        assert int((pix[2] >= 0).sum()) == 0
    # counts exact; s1 and s2 use the plain version's rounding in view
    # order; s2m differs in the order of its C-long dot products
    assert torch.equal(got[2], want[2])
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1])
    if mapped:
        assert _rel(got[3], want[3]) <= 1e-5
    else:
        assert got[3] is None


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,m,hw,aligned", [
    (256, 32, (60, 80), True),  # the main path's maps
    (32, 32, (7, 9), True),  # 63 rows a view: tiles straddle views
    (64, 8, (5, 13), True),  # M < 32, not a multiple of 4 rows
    (256, 5, (60, 80), True),  # M % 4 != 0
    (128, 32, (6, 10), False),  # staged element by element
])
def test_mapped_rows_match_plain(dev, dtype, c, m, hw, aligned):
    """K1's phase A against ``mapped_rows_plain`` (1e-5 relative: the
    C-long dot products run in another order)."""
    gen = torch.Generator(device=dev).manual_seed(c + m)
    feats = torch.randn((3,) + hw + (c,), generator=gen,
                        device=dev).to(dtype)
    if not aligned:
        feats = _unaligned(feats)
    w = torch.randn((c, m), generator=gen, device=dev) / c ** 0.5
    b = torch.randn((m,), generator=gen, device=dev)
    got = voxel._mapped_rows_launch(feats, w, b)
    want = voxel.mapped_rows_plain(feats, w, b)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (3, hw[0] * hw[1], m)
    assert _rel(got, want) <= 1e-5


def _w_case(case, c, m, gen, dev):
    """The mapped stream's W for a phase A case: seeded (std 1/sqrt(C)),
    or entries of random sign within 10% of 1e4 or of 1e-6."""
    w = torch.randn((c, m), generator=gen, device=dev) / c ** 0.5
    for tag, scale in (("1e4", 1e4), ("1e-6", 1e-6)):
        if case.endswith(tag):
            mag = 1 + 0.1 * torch.rand((c, m), generator=gen, device=dev)
            w = torch.sign(w) * mag * scale
    return w


@pytest.mark.parametrize("case", ["seeded", "unaligned", "W near 1e4",
                                  "W near 1e-6"])
@pytest.mark.parametrize("m", [1, 7, 8, 31, 32])
@pytest.mark.parametrize("c", voxel.K1_CHANNELS)
def test_mapped_rows_bf16_tensor_cores_match_plain(dev, c, m, case):
    """K1's phase A on bfloat16 maps (W split into three bfloat16 pieces,
    mma.sync on the tensor cores) at every width it takes: P and the
    carry's s2m within 1e-5 relative of the plain version, count, s1 and
    s2 bitwise. 3 views of 59x81 (14,337 rows, no multiple of the
    128-row tile); "unaligned" maps one element off 16 bytes are staged
    without cp.async."""
    gen = torch.Generator(device=dev).manual_seed(c * 100 + m)
    feats = torch.randn((3, 59, 81, c), generator=gen,
                        device=dev).bfloat16()
    if case == "unaligned":
        feats = _unaligned(feats)
    w = _w_case(case, c, m, gen, dev)
    b = torch.randn((m,), generator=gen, device=dev)
    got = voxel._mapped_rows_launch(feats, w, b)
    want = voxel.mapped_rows_plain(feats, w, b)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (3, 59 * 81, m)
    assert bool(torch.isfinite(got).all())
    assert _rel(got, want) <= 1e-5
    pix = _pix(dev, v=3, nvox=(7, 9, 5), fh=59, fw=81)
    got = voxel.fusion_carry(feats, pix, w, b)
    want = voxel.fusion_carry_plain(feats, pix, w, b)
    torch.cuda.synchronize()
    for g, p in zip(got[:3], want[:3]):
        assert torch.equal(g, p)
    assert _rel(got[3], want[3]) <= 1e-5


def _exact_bf16x3_case(dev, c, m, seed):
    """Phase A inputs whose product is exact in float32 in any order, and
    whose W has three nonzero bfloat16 pieces: rows of bfloat16 maps with
    at most 3 entries of +-1, W = +-(h +- 3 * 2^-10 +- 2^-18) with h in
    {1.25, 1.5, 1.75} (hi = h, mid = +-3 * 2^-10, lo = +-2^-18) and b in
    {-0.5, 0, 0.5}: every partial sum lies below 2^3 on a grid of 2^-18."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    rows = 3 * 59 * 81
    flat = torch.zeros((rows, c), device=dev)
    idx = torch.randint(0, c, (rows, 3), generator=gen, device=dev)
    sign = torch.randint(0, 2, (rows, 3), generator=gen, device=dev) * 2 - 1
    flat.scatter_(1, idx, sign.float())
    feats = flat.reshape(3, 59, 81, c).bfloat16()

    def pm(*shape):
        return (torch.randint(0, 2, shape, generator=gen, device=dev)
                * 2 - 1).float()

    h = 1.25 + 0.25 * torch.randint(0, 3, (c, m), generator=gen, device=dev)
    w = pm(c, m) * (h + pm(c, m) * 3 * 2.0 ** -10 + pm(c, m) * 2.0 ** -18)
    b = 0.5 * torch.randint(-1, 2, (m,), generator=gen, device=dev).float()
    return feats, w, b


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("m", [7, 32])
@pytest.mark.parametrize("c", voxel.K1_CHANNELS)
def test_mapped_rows_bf16_three_pieces_are_exact(dev, c, m, aligned):
    """Phase A on bfloat16 maps at exact inputs (``_exact_bf16x3_case``):
    P bit for bit the plain version's. The product by W's first two
    pieces alone differs from it, so a kernel that lost the third piece
    (or any) on its way to the tensor cores would fail."""
    feats, w, b = _exact_bf16x3_case(dev, c, m, seed=c + m)
    if not aligned:
        feats = _unaligned(feats)
    pieces = voxel.split_bf16x3_plain(w)
    assert all(bool((p != 0).all()) for p in pieces)
    got = voxel._mapped_rows_launch(feats, w, b)
    want = voxel.mapped_rows_plain(feats, w, b)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    x = feats.double().reshape(3, -1, c)
    two = (x @ (pieces[0].double() + pieces[1].double()) + b.double())
    assert not torch.equal(two.float(), want)


def test_fusion_carry_rejects_what_it_cannot_take(dev):
    pix = _pix(dev, v=2)
    with pytest.raises(ValueError, match="1 to 1024 channels"):
        voxel.fusion_carry(torch.zeros((2, 60, 80, 1025), device=dev), pix)
    with pytest.raises(ValueError, match="pix"):
        voxel.fusion_carry(torch.zeros((2, 60, 80, 64), device=dev),
                           pix.long())


@pytest.mark.parametrize("c", [1025, 2048])
def test_fusion_carry_refuses_c_off_its_widths(dev, c):
    """Phase B keeps C / 32 channels a lane in registers, compiled for
    C = 32 x a power of two up to 1024; a narrower map runs padded to the
    next of them, a wider one is refused."""
    pix = _pix(dev, v=2)
    with pytest.raises(ValueError, match="1 to 1024 channels"):
        voxel.fusion_carry(torch.zeros((2, 60, 80, c), device=dev), pix)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mapped", [False, True])
@pytest.mark.parametrize("c", [1, 8, 16, 40, 96])
def test_fusion_carry_off_its_widths_runs_padded(dev, c, mapped, dtype):
    """K1 at C off ``K1_CHANNELS`` (the smoke ImVoxelNet's FPN 8): the
    wrappers pad the channels to ``k1_width(C)`` with zeros and launch
    (once, counted); count, s1 and s2 bitwise the plain version's at C,
    s2m within 1e-5 relative. The backward (g1, g2 and with the mapped
    stream gm) within ``test_fusion_backward_matches_plain``'s
    tolerances on float32 maps, bitwise without the mapped stream on
    bfloat16 maps; a second run bitwise."""
    pix = _fusion_case(dev, "scene")
    gen = torch.Generator(device=dev).manual_seed(c)
    n = pix.shape[1]
    feats = torch.randn((pix.shape[0], 60, 80, c), generator=gen,
                        device=dev).to(dtype)
    w = b = gm = rows = None
    if mapped:
        w = torch.randn((c, 32), generator=gen, device=dev) / c ** 0.5
        b = torch.randn((32,), generator=gen, device=dev)
        gm = torch.randn((n, 32), generator=gen, device=dev)
        rows = voxel.mapped_rows_plain(feats, w, b)
    before = voxel.fusion_carry.launches
    got = voxel.fusion_carry(feats, pix, w, b)
    want = voxel.fusion_carry_plain(feats, pix, w, b)
    torch.cuda.synchronize()
    assert voxel.fusion_carry.launches == before + 1
    assert got[0].shape == (n, c) and got[0].is_contiguous()
    assert all(torch.equal(x, y) for x, y in zip(got[:3], want[:3]))
    if mapped:
        assert _rel(got[3], want[3]) <= 1e-5
        assert _rel(voxel._mapped_rows_launch(feats, w, b), rows) <= 1e-5
    g1 = torch.randn((n, c), generator=gen, device=dev)
    g2 = torch.randn((n, c), generator=gen, device=dev)
    count = want[2]
    args = (feats, pix, count, g1, g2, gm, w, b, rows)
    got = voxel.fusion_carry_backward(*args)
    again = voxel.fusion_carry_backward(*args)
    want = voxel.fusion_carry_backward_plain(*args)
    torch.cuda.synchronize()
    assert got[0].shape == feats.shape and got[0].dtype == dtype
    if dtype == torch.bfloat16 and not mapped:
        assert torch.equal(got[0], want[0])
    elif dtype == torch.bfloat16:
        assert _bf16_ulps(got[0], want[0]) <= 2
    else:
        assert _close(got[0], want[0], 1e-5)
    if mapped:
        assert got[1].shape == (c, 32)
    assert _close(got[1], want[1], 1e-4) and _close(got[2], want[2], 1e-4)
    for x, y in zip(got, again):
        assert (x is None and y is None) or torch.equal(x, y)


def _indoor_pix(dev, v):
    """K1's pixel indices at the indoor ImVoxelNet's shapes: 480x640
    views (120x160 stride-4 maps, bounds 119x160 of the 478x640 image)
    into its 80x80x32 volume at 0.08 m (204,800 voxels)."""
    intrinsic, extr = _family_cameras(np.random.RandomState(v), v)
    points = voxel.get_points((80, 80, 32), (0.08, 0.08, 0.08),
                              (0, 0, 0.5), dev).reshape(-1, 3)
    proj = voxel.compute_projection(intrinsic, extr, 4.0, dev)
    x, y, _, valid = voxel.project_points(points, proj, 119, 160)
    return voxel.pixel_index(x, y, valid, 160).contiguous()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_indoor_plain_mean_fusion_matches_plain(dev, dtype):
    """K1's plain-mean form (no mapped stream) at the indoor ImVoxelNet's
    test shape, 50 views of (120, 160, 64) maps into the 80x80x32 volume:
    count, s1 and s2 bitwise the plain version's."""
    pix = _indoor_pix(dev, 50)
    gen = torch.Generator(device=dev).manual_seed(50)
    feats = torch.randn((50, 120, 160, 64), generator=gen,
                        device=dev).to(dtype)
    got = voxel.fusion_carry(feats, pix)
    want = voxel.fusion_carry_plain(feats, pix)
    torch.cuda.synchronize()
    assert got[3] is None and want[3] is None
    assert all(torch.equal(x, y) for x, y in zip(got[:3], want[:3]))
    assert float(got[2].max()) >= 2 and int((got[2] == 0).sum()) > 0


def _sunrgbd_pix(dev, n_voxels, voxel_size):
    """K1's pixel indices at the SUN RGB-D ImVoxelNet's shapes: one
    530x730 view resized to 465x640 (stride-4 bounds 116x160 of the
    120x160 padded maps), its camera at the world origin looking along +y
    (the dataset's extrinsic for an identity ``Rt``), the volume at the
    fixed origin (0, 3, -1)."""
    intrinsic = np.array([[529.5, 0, 365.0], [0, 529.5, 265.0], [0, 0, 1]],
                         np.float32)
    extr = np.eye(4, dtype=np.float32)
    extr[:3, :3] = [[1, 0, 0], [0, 0, -1], [0, 1, 0]]
    points = voxel.get_points(n_voxels, voxel_size, (0, 3, -1),
                              dev).reshape(-1, 3)
    proj = voxel.compute_projection(intrinsic, extr[None], 530 / (465 / 4),
                                    dev)
    x, y, _, valid = voxel.project_points(points, proj, 116, 160)
    return voxel.pixel_index(x, y, valid, 160).contiguous()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c, n_voxels, size", [
    (64, (80, 80, 32), 0.08), (256, (40, 40, 16), 0.16)],
    ids=["sunrgbd", "sunrgbd_fast"])
def test_one_view_plain_mean_fusion_matches_plain(dev, dtype, c, n_voxels,
                                                  size):
    """K1's plain-mean form at one view (SUN RGB-D: a partial group of
    phase B's bfloat16 walk, which takes views 4 at a time), (1, 120, 160,
    C) maps into ``imvoxelnet_sunrgbd.py``'s 80x80x32 volume and
    ``_fast``'s 40x40x16: count, s1 and s2 bitwise the plain version's."""
    pix = _sunrgbd_pix(dev, n_voxels, (size,) * 3)
    gen = torch.Generator(device=dev).manual_seed(c)
    feats = torch.randn((1, 120, 160, c), generator=gen,
                        device=dev).to(dtype)
    got = voxel.fusion_carry(feats, pix)
    want = voxel.fusion_carry_plain(feats, pix)
    torch.cuda.synchronize()
    assert got[3] is None and want[3] is None
    assert all(torch.equal(x, y) for x, y in zip(got[:3], want[:3]))
    assert float(got[2].max()) == 1 and 0 < int((got[2] == 0).sum()) < \
        pix.shape[1]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_indoor_fusion_backward_g1_matches_plain(dev, dtype):
    """K1's backward with the s1 cotangent alone (the plain-mean volume
    trains only it) at the indoor training shape, 20 views of 480x640
    into the 80x80x32 volume, C = 64: d features within 1e-5 x max on
    float32 maps (``test_fusion_backward_matches_plain``'s tolerance),
    bitwise on bfloat16 maps; a second run bitwise."""
    pix = _indoor_pix(dev, 20)
    gen = torch.Generator(device=dev).manual_seed(20)
    feats = torch.randn((20, 120, 160, 64), generator=gen,
                        device=dev).to(dtype)
    g1 = torch.randn((pix.shape[1], 64), generator=gen, device=dev)
    count = (pix >= 0).float().sum(0)
    args = (feats, pix, count, g1)
    got = voxel.fusion_carry_backward(*args)
    again = voxel.fusion_carry_backward(*args)
    want = voxel.fusion_carry_backward_plain(*args)
    torch.cuda.synchronize()
    assert got[1] is None and got[2] is None
    if dtype == torch.bfloat16:
        assert torch.equal(got[0], want[0])
    else:
        assert _close(got[0], want[0], 1e-5)
    assert torch.equal(got[0], again[0])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c, n_voxels, size", [
    (64, (80, 80, 32), 0.08), (256, (40, 40, 16), 0.16)],
    ids=["sunrgbd", "sunrgbd_fast"])
def test_one_view_fusion_backward_g1_matches_plain(dev, dtype, c, n_voxels,
                                                   size):
    """K1's backward with the s1 cotangent alone at one view (SUN RGB-D
    training: one pixel bucket a referenced pixel, most of the 19,200
    empty), (1, 120, 160, C) maps from ``imvoxelnet_sunrgbd.py``'s
    80x80x32 and ``_fast``'s 40x40x16: d features within 1e-6 x max on
    float32 maps, bitwise on bfloat16 maps; a second run bitwise."""
    pix = _sunrgbd_pix(dev, n_voxels, (size,) * 3)
    gen = torch.Generator(device=dev).manual_seed(c + 1)
    feats = torch.randn((1, 120, 160, c), generator=gen,
                        device=dev).to(dtype)
    g1 = torch.randn((pix.shape[1], c), generator=gen, device=dev)
    count = (pix >= 0).float().sum(0)
    args = (feats, pix, count, g1)
    got = voxel.fusion_carry_backward(*args)
    again = voxel.fusion_carry_backward(*args)
    want = voxel.fusion_carry_backward_plain(*args)
    torch.cuda.synchronize()
    assert got[1] is None and got[2] is None
    assert got[0].shape == feats.shape and got[0].dtype == dtype
    if dtype == torch.bfloat16:
        assert torch.equal(got[0], want[0])
    else:
        assert _close(got[0], want[0], 1e-6)
    assert torch.equal(got[0], again[0])
    # pixels no voxel references get exactly 0
    seen = torch.zeros(120 * 160, dtype=torch.bool, device=dev)
    seen[pix[0][pix[0] >= 0].long()] = True
    assert 0 < int(seen.sum()) < seen.numel()
    assert not bool(got[0].reshape(-1, c)[~seen].any())


def test_fusion_carry_refuses_more_than_32_mapped_channels(dev):
    pix = _pix(dev, v=2)
    feats = torch.zeros((2, 60, 80, 64), device=dev)
    w = torch.zeros((64, 33), device=dev)
    with pytest.raises(ValueError, match="mapped channels"):
        voxel.fusion_carry(feats, pix, w, torch.zeros((33,), device=dev))


def test_fusion_carry_refuses_a_bfloat16_mapped_kernel(dev):
    pix = _pix(dev, v=2)
    feats = torch.zeros((2, 60, 80, 64), device=dev)
    w = torch.zeros((64, 32), device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="float32"):
        voxel.fusion_carry(feats, pix, w, torch.zeros((32,), device=dev))


def test_mapped_rows_launcher_refuses_more_shared_memory_than_the_card_has(
        dev):
    """The launcher sizes phase A's blocks itself: at C = 2048 a float32
    block would need more shared memory than any card lets a block opt
    into, and is refused; at C = 64 it launches."""
    m, lib = 32, voxel._lib()
    for c, refused in ((2048, True), (64, False)):
        feats = torch.randn((2, 6, 10, c), device=dev)
        w = torch.randn((c, m), device=dev)
        b = torch.randn((m,), device=dev)
        out = torch.zeros((2, 60, m), device=dev)
        err = lib.fused_mean_cov_mapped_rows(
            feats.data_ptr(), 0, w.data_ptr(), b.data_ptr(), out.data_ptr(),
            120, c, m, torch.cuda.current_stream(dev).cuda_stream)
        assert (err != 0) == refused
    torch.cuda.synchronize()
    assert _rel(out, voxel.mapped_rows_plain(feats, w, b)) <= 1e-5


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("c", voxel.K1_CHANNELS)
def test_mapped_rows_smem_is_what_fusion_smem_bytes_states(dev, c,
                                                           itemsize):
    """The shared memory the launcher gives a phase A block is the layout
    ``fusion_smem_bytes`` states for the CPU tests."""
    got = voxel._lib().fused_mean_cov_mapped_rows_smem(int(itemsize == 2), c)
    assert got == voxel.fusion_smem_bytes(c, itemsize)


def _k1_pix(dev, case):
    pix = _pix(dev)
    if case == "blind view":
        pix[2] = -1
    elif case.endswith("voxels on one pixel"):
        pix[:, :int(case.split()[0])] = 1234
    elif case == "single view":
        pix = pix[:1].contiguous()
    elif case == "no valid voxel":
        pix[:] = -1
    return pix


def _backward_case(dev, case, c, mapped, with_g2, seed=0):
    """K1's backward inputs on the card tests' scene (6 views, 3200
    voxels, 60x80 maps): its pixel indices (view 2 seeing no voxel, 64 or
    100 voxels on one pixel of every view, one view, or no valid voxel),
    f32 maps, W and b, and seeded cotangents."""
    pix = _k1_pix(dev, case)
    gen = torch.Generator(device=dev).manual_seed(seed)
    n, m = pix.shape[1], 32
    feats = torch.randn((pix.shape[0], 60, 80, c), generator=gen, device=dev)
    w = b = gm = None
    if mapped:
        w = torch.randn((c, m), generator=gen, device=dev) / c ** 0.5
        b = torch.randn((m,), generator=gen, device=dev)
        gm = torch.randn((n, m), generator=gen, device=dev)
    g1 = torch.randn((n, c), generator=gen, device=dev)
    g2 = torch.randn((n, c), generator=gen, device=dev) if with_g2 else None
    count = (pix >= 0).float().sum(0)
    return feats, pix, count, g1, g2, gm, w, b


def _close(got, want, tol):
    if want is None:
        return got is None
    return float((got - want).abs().max()) <= tol * float(want.abs().max())


@pytest.mark.parametrize("case", ["scene", "blind view",
                                  "64 voxels on one pixel", "single view",
                                  "no valid voxel"])
@pytest.mark.parametrize("with_g2", [False, True])
@pytest.mark.parametrize("mapped", [False, True])
@pytest.mark.parametrize("c", [32, 1024])
def test_fusion_backward_matches_plain(dev, c, mapped, with_g2, case):
    """K1's backward kernel against ``fusion_carry_backward_plain``:
    d features within 1e-5 x max (sums of a pixel's voxels in another
    order), dW and db within 1e-4 x max (sums over every referenced
    row)."""
    feats, pix, count, g1, g2, gm, w, b = _backward_case(
        dev, case, c, mapped, with_g2)
    mapped_rows = voxel.mapped_rows_plain(feats, w, b) if mapped else None
    before = voxel.fusion_carry_backward.launches
    got = voxel.fusion_carry_backward(feats, pix, count, g1, g2, gm, w, b,
                                      mapped_rows)
    want = voxel.fusion_carry_backward_plain(feats, pix, count, g1, g2, gm,
                                             w, b, mapped_rows)
    torch.cuda.synchronize()
    assert voxel.fusion_carry_backward.launches == before + 1
    assert got[0].shape == feats.shape
    if case == "no valid voxel":
        assert float(got[0].abs().max()) == 0.0
        assert not mapped or float(got[1].abs().max()) == 0.0
    else:
        assert _close(got[0], want[0], 1e-5)
    assert _close(got[1], want[1], 1e-4) and _close(got[2], want[2], 1e-4)
    if case == "blind view":
        assert float(got[0][2].abs().max()) == 0.0
    # bitwise the same on a second run: a fixed summation order
    again = voxel.fusion_carry_backward(feats, pix, count, g1, g2, gm, w, b,
                                        mapped_rows)
    for x, y in zip(got, again):
        assert (x is None and y is None) or torch.equal(x, y)



@pytest.mark.parametrize("m", [5, 32])
def test_fusion_backward_takes_unaligned_maps_and_any_mapped_width(dev, m):
    """Maps off a 16-byte boundary and M % 4 != 0 take the backward's
    4-byte loads and copies; the results match the plain version as the
    aligned ones do."""
    feats, pix, count, g1, g2, _, _, _ = _backward_case(dev, "scene", 64,
                                                        False, True)
    gen = torch.Generator(device=dev).manual_seed(2)
    w = torch.randn((64, m), generator=gen, device=dev) / 8.0
    b = torch.randn((m,), generator=gen, device=dev)
    gm = torch.randn((pix.shape[1], m), generator=gen, device=dev)
    shifted = _unaligned(feats)
    assert shifted.data_ptr() % 16 != 0
    rows = voxel.mapped_rows_plain(shifted, w, b)
    got = voxel.fusion_carry_backward(shifted, pix, count, g1, g2, gm, w, b,
                                      rows)
    want = voxel.fusion_carry_backward_plain(shifted, pix, count, g1, g2, gm,
                                             w, b, rows)
    torch.cuda.synchronize()
    assert _close(got[0], want[0], 1e-5)
    assert _close(got[1], want[1], 1e-4) and _close(got[2], want[2], 1e-4)

@pytest.mark.parametrize("mapped", [False, True])
def test_fusion_carry_gradient_is_the_kernels(dev, mapped):
    """Through ``fusion_carry`` on the card, autograd takes K1's backward
    kernel (one counted launch), and its gradients agree with autograd
    through the plain forward (1e-5 x max for the maps, 1e-4 for W and
    b)."""
    feats, pix, _, g1, g2, gm, w, b = _backward_case(dev, "scene", 256,
                                                     mapped, True, seed=1)

    def grads(fn):
        f = feats.clone().requires_grad_()
        wr = None if w is None else w.clone().requires_grad_()
        br = None if b is None else b.clone().requires_grad_()
        s1, s2, _, s2m = fn(f, pix, wr, br)
        loss = (s1 * g1).sum() + (s2 * g2).sum()
        if mapped:
            loss = loss + (s2m * gm).sum()
        loss.backward()
        return f.grad, None if wr is None else wr.grad, \
            None if br is None else br.grad

    before = voxel.fusion_carry_backward.launches
    got = grads(voxel.fusion_carry)
    assert voxel.fusion_carry_backward.launches == before + 1
    want = grads(voxel.fusion_carry_plain)
    torch.cuda.synchronize()
    assert _close(got[0], want[0], 1e-5)
    assert _close(got[1], want[1], 1e-4) and _close(got[2], want[2], 1e-4)


def test_fusion_carry_refuses_float16_maps(dev):
    """float32 and bfloat16 maps take K1 and its backward; any other
    dtype is refused, with or without a gradient."""
    pix = _pix(dev, v=2)
    feats = torch.randn((2, 60, 80, 64), device=dev).half()
    with pytest.raises(TypeError, match="bfloat16"):
        voxel.fusion_carry(feats.requires_grad_(), pix)
    with torch.no_grad(), pytest.raises(TypeError, match="bfloat16"):
        voxel.fusion_carry(feats, pix)


def test_fusion_carry_takes_bfloat16_maps_under_grad(dev):
    """bfloat16 maps that need a gradient take K1's forward and, through
    autograd, its backward kernel (one counted launch each), and the
    gradient is bfloat16."""
    feats, pix, _, g1, _, gm, w, b = _backward_case(dev, "scene", 256, True,
                                                    False, seed=1)
    f = feats.bfloat16().requires_grad_()
    before = (voxel.fusion_carry.launches,
              voxel.fusion_carry_backward.launches)
    s1, _, _, s2m = voxel.fusion_carry(f, pix, w, b)
    ((s1 * g1).sum() + (s2m * gm).sum()).backward()
    torch.cuda.synchronize()
    assert (voxel.fusion_carry.launches,
            voxel.fusion_carry_backward.launches) == (before[0] + 1,
                                                      before[1] + 1)
    assert f.grad.dtype == torch.bfloat16 and float(f.grad.abs().max()) > 0


def _bf16_ulps(got, want):
    """|got - want| in bfloat16 ulps of the largest |want| (2^-7 of the
    power of two at or below it)."""
    top = float(want.float().abs().max())
    ulp = 2.0 ** (np.floor(np.log2(top)) - 7) if top > 0 else 1.0
    return float((got.float() - want.float()).abs().max()) / ulp


@pytest.mark.parametrize("case", ["scene", "blind view",
                                  "64 voxels on one pixel", "single view"])
@pytest.mark.parametrize("with_g2", [False, True])
@pytest.mark.parametrize("mapped", [False, True])
@pytest.mark.parametrize("c", [32, 256])
def test_fusion_backward_bf16_matches_plain(dev, c, mapped, with_g2, case):
    """K1's backward on bfloat16 maps against its plain version: bit for
    bit without the mapped stream; with it, each pair's product with W^T
    sums its M terms in another order (a sequential fma here, a matmul in
    the plain version), which can move a pair's cotangent across a
    bfloat16 rounding boundary: within 2 bfloat16 ulps of the largest
    d feature, at under 1% of the elements. dW and db as float32 maps'
    (1e-4 x max). Bitwise the same on a second run."""
    feats, pix, count, g1, g2, gm, w, b = _backward_case(
        dev, case, c, mapped, with_g2)
    feats = feats.bfloat16()
    rows = voxel.mapped_rows_plain(feats, w, b) if mapped else None
    before = voxel.fusion_carry_backward.launches
    got = voxel.fusion_carry_backward(feats, pix, count, g1, g2, gm, w, b,
                                      rows)
    want = voxel.fusion_carry_backward_plain(feats, pix, count, g1, g2, gm,
                                             w, b, rows)
    torch.cuda.synchronize()
    assert voxel.fusion_carry_backward.launches == before + 1
    assert got[0].dtype == torch.bfloat16 and got[0].shape == feats.shape
    if mapped:
        assert _bf16_ulps(got[0], want[0]) <= 2
        assert float((got[0] != want[0]).float().mean()) < 0.01
    else:
        assert torch.equal(got[0], want[0])
    assert _close(got[1], want[1], 1e-4) and _close(got[2], want[2], 1e-4)
    if case == "blind view":
        assert float(got[0][2].float().abs().max()) == 0.0
    again = voxel.fusion_carry_backward(feats, pix, count, g1, g2, gm, w, b,
                                        rows)
    for x, y in zip(got, again):
        assert (x is None and y is None) or torch.equal(x, y)


@pytest.mark.parametrize("case", ["scene", "100 voxels on one pixel",
                                  "3 voxels a pixel", "unaligned map"])
@pytest.mark.parametrize("with_g2", [False, True])
@pytest.mark.parametrize("c", [32, 256, 1024])
def test_fusion_backward_bf16_pair_groups_are_bitwise(dev, c, with_g2,
                                                      case):
    """K1's backward on bfloat16 maps with the mapped stream, on small
    integer inputs whose products and sums are exact in float32 in any
    order: d features bit for bit equal to the plain version. Pass 1
    takes the pairs a group at a time across rows: here groups straddle
    rows of 3 pairs, a row holds more pairs than a group and than a warp
    loads at once (100), and the maps start off a 16-byte boundary. dW
    and db as float32 maps' (1e-4 x max)."""
    pix = _pix(dev)
    if case == "100 voxels on one pixel":
        pix[:, :100] = 1234
    elif case == "3 voxels a pixel":
        pix[:, :1500] = torch.arange(1500, device=dev,
                                     dtype=torch.int32) // 3 + 100
    gen = torch.Generator(device=dev).manual_seed(c)
    v, n, m = pix.shape[0], pix.shape[1], 32

    def ints(shape, lo, hi):
        return torch.randint(lo, hi, shape, generator=gen,
                             device=dev).float()

    feats = ints((v, 60, 80, c), -4, 5).bfloat16()
    if case == "unaligned map":
        feats = _unaligned(feats)
    w, b = ints((c, m), -4, 5), ints((m,), -4, 5)
    g1 = ints((n, c), -8, 9)
    g2 = ints((n, c), -8, 9) if with_g2 else None
    gm, mapped = ints((n, m), -8, 9), ints((v, 60 * 80, m), -8, 9)
    count = (pix >= 0).float().sum(0)
    args = (feats, pix, count, g1, g2, gm, w, b, mapped)
    got = voxel.fusion_carry_backward(*args)
    want = voxel.fusion_carry_backward_plain(*args)
    torch.cuda.synchronize()
    assert got[0].dtype == torch.bfloat16 and torch.equal(got[0], want[0])
    assert float(want[0].float().abs().max()) > 0
    assert _close(got[1], want[1], 1e-4) and _close(got[2], want[2], 1e-4)


@pytest.mark.parametrize("with_g2", [False, True])
@pytest.mark.parametrize("case", ["scene", "blind view",
                                  "100 voxels on one pixel"])
def test_fusion_backward_bf16_pass1_matches_its_twin(dev, case, with_g2):
    """K1's backward pass 1 on bfloat16 maps without the mapped stream
    (no product, so no order of its terms to differ) against
    ``pixel_sums_plain`` from the same index preparation: bit for bit."""
    feats, pix, _, g1, g2, _, _, _ = _backward_case(dev, case, 256, False,
                                                    with_g2)
    feats = feats.bfloat16()
    order, off, _, _ = voxel.pixel_order(pix, 4800)
    got, dy = voxel._pixel_sums(feats, order, off, g1, g2)
    want, _ = voxel.pixel_sums_plain(feats, order, off, g1, g2)
    torch.cuda.synchronize()
    assert dy is None and torch.equal(got, want)


def _rgb_case(dev, case, v):
    """The rgb stream's inputs: (V, 240, 320, 3) images and the pixel
    indices of a 40x40x16 volume at the images' projection, with a
    depth-gate-like shell dropping most pairs; view 1 sees nothing; in
    "all gated" no pair is kept; "ragged N" has 7 x 9 x 5 voxels."""
    gen = torch.Generator(device=dev).manual_seed(v)
    intrinsic, extr = _cameras(np.random.RandomState(v), v)
    nvox = (7, 9, 5) if case == "ragged N" else (40, 40, 16)
    points = voxel.get_points(nvox, (0.16, 0.16, 0.2), (0, 0, 0.5),
                              dev).reshape(-1, 3)
    proj = voxel.compute_projection(intrinsic, extr, 1.0, dev)
    x, y, z, valid = voxel.project_points(points, proj, 239, 320)
    shell = (z - 3.5).abs() < 0.2  # a +-0.2 m shell, as the gate keeps
    pix = voxel.pixel_index(x, y, valid & shell, 320)
    pix[1:2] = -1
    if case == "all gated":
        pix.fill_(-1)
    images = torch.rand((v, 240, 320, 3), generator=gen, device=dev)
    return images, pix.contiguous()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["shell", "ragged N", "all gated"])
@pytest.mark.parametrize("v", [3, 48, 100])
def test_rgb_carry_matches_plain_bitwise(dev, v, case, dtype):
    images, pix = _rgb_case(dev, case, v)
    images = images.to(dtype)
    kept = int((pix >= 0).sum())
    assert (kept == 0) == (case == "all gated")
    before = voxel.rgb_carry.launches
    s1, s2 = voxel.rgb_carry(images, pix)
    torch.cuda.synchronize()
    assert voxel.rgb_carry.launches == before + 1
    p1, p2 = voxel.rgb_carry_plain(images, pix)
    assert torch.equal(s1, p1) and torch.equal(s2, p2)
    if case == "all gated":
        assert not bool(s1.any()) and not bool(s2.any())


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["ragged N", "none kept", "all kept"])
@pytest.mark.parametrize("v", [1, 31, 32, 33, 100, 110])
def test_rgb_carry_any_views_bitwise(dev, v, case, dtype, aligned):
    """The rgb stream's tiles (32 voxels a block, 64 views a pass) at view
    counts around a warp's and a pass's, N = 315 (no multiple of the
    tile), with no pair kept or every pair kept, on images aligned or one
    element off 16 bytes: bitwise equal to the plain version."""
    images, pix = _rgb_case(dev, "ragged N", v)
    if case == "none kept":
        pix.fill_(-1)
    elif case == "all kept":
        gen = torch.Generator(device=dev).manual_seed(v)
        pix = torch.randint(0, 240 * 320, pix.shape, generator=gen,
                            device=dev, dtype=torch.int32)
    images = images.to(dtype)
    if not aligned:
        images = _unaligned(images)
    s1, s2 = voxel.rgb_carry(images, pix)
    p1, p2 = voxel.rgb_carry_plain(images, pix)
    torch.cuda.synchronize()
    assert torch.equal(s1, p1) and torch.equal(s2, p2)
    assert bool((pix >= 0).any()) == (case != "none kept")


def test_rgb_carry_rejects_what_it_cannot_take(dev):
    images, pix = _rgb_case(dev, "ragged N", 3)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        voxel.rgb_carry(images.double(), pix)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        voxel.rgb_carry(images.half(), pix)
    with pytest.raises(ValueError, match="images"):
        voxel.rgb_carry(images[..., :2].contiguous(), pix)
    with pytest.raises(ValueError, match="int32"):
        voxel.rgb_carry(images, pix.long())
    with pytest.raises(ValueError, match="int32"):
        voxel.rgb_carry(images, pix[:2].contiguous())
    with pytest.raises(ValueError, match="no gradient"):
        voxel.rgb_carry(images.clone().requires_grad_(), pix)


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
    (46, 5, 20, True), (40001, 3, 2048, False), (8191, 3, 4096, False),
    (231000, 3, 64, False),  # the most a 16-CTA cluster holds at C = 3
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


@pytest.mark.parametrize("cluster", [1, 2, 4, 8, 16])
def test_furthest_point_sample_any_cluster_matches_plain(dev, cluster):
    """Every cluster size gives the plain version's indices, ties
    included (the duplicated half lies in other slices): a cloud of
    2048 points a CTA takes ``cluster`` CTAs."""
    n = 2048 * cluster
    assert pointnet.fps_plan(n, 3)[0] == cluster
    pts = _cloud(dev, n, 3, cluster, dup=True)
    got = pointnet.furthest_point_sample(pts, 512)
    want = pointnet.furthest_point_sample_plain(pts, 512)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_fps_launcher_refuses_more_shared_memory_than_the_card_has(dev):
    n, c, s = 1000, 3, 10
    planes = _cloud(dev, n, c, 0).t().contiguous()
    out = torch.empty((s,), dtype=torch.int32, device=dev)
    lib = pointnet._lib()
    # 1 MiB a block is above any card's opt-in shared memory
    for smem, refused in ((1 << 20, True), (pointnet.fps_smem_bytes(c, n),
                                            False)):
        err = lib.furthest_point_sample(
            planes.data_ptr(), out.data_ptr(), n, c, s, 1, n, smem,
            torch.cuda.current_stream(dev).cuda_stream)
        assert (err != 0) == refused
    torch.cuda.synchronize()
    assert torch.equal(out, pointnet.furthest_point_sample_plain(
        planes.t().contiguous(), s))


def test_furthest_point_sample_rejects_what_it_cannot_take(dev):
    pts = _cloud(dev, 1000, 3, 0)
    with pytest.raises(ValueError, match="unsupported device"):
        pointnet.furthest_point_sample(pts.to("meta"), 10)
    with pytest.raises(TypeError, match="float32"):
        pointnet.furthest_point_sample(pts.double(), 10)
    with pytest.raises(ValueError, match="n_samples"):
        pointnet.furthest_point_sample(pts, 1001)
    with pytest.raises(ValueError, match="16-CTA cluster"):
        pointnet.furthest_point_sample(_cloud(dev, 240000, 3, 0), 10)


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
    (7, 64, 64, 32),  # views not a multiple of the 4 projected a round
    (4, 33, 3, 32),  # R * S = 99, not a multiple of the 64-point tile
    (6, 50, 13, 30),  # C % 4 != 0: one channel a lane
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_streaming_sample_mean_var_matches_plain(dev, v, r, s, c, dtype):
    pts, images, feats, proj = _ray_inputs(dev, v, r, s, c, seed=v + r)
    args = (pts, images.to(dtype), proj, (239, 320), feats.to(dtype))
    before = render.streaming_sample_mean_var.launches
    got = render.streaming_sample_mean_var(*args)
    want = render.streaming_sample_mean_var_plain(*args)
    torch.cuda.synchronize()
    assert render.streaming_sample_mean_var.launches == before + 1
    assert [tuple(t.shape) for t in got] == [tuple(t.shape) for t in want]
    assert got[1].dtype == torch.bool
    # the mask exact; globalfeat follows the plain version's rounding
    # (tolerance 1e-5 relative; bfloat16 maps, bit for bit)
    assert torch.equal(got[1], want[1])
    assert _rel(got[0], want[0]) <= 1e-5
    if dtype == torch.bfloat16:
        assert torch.equal(got[0], want[0])
    if r >= 8:
        cnt = render.ray_view_carry_plain(pts, images, feats, proj,
                                          (239, 320))[3]
        assert int((cnt == 0).sum()) > 0 and float(cnt.max()) >= 2


def test_streaming_sample_mean_var_takes_an_unaligned_map(dev):
    """C % 4 == 0 but the map starts off a 16-byte boundary: the launch
    takes 4-byte taps and still equals the plain version."""
    pts, images, feats, proj = _ray_inputs(dev, 5, 40, 16, 32, seed=1)
    buf = torch.empty(feats.numel() + 1, device=dev)
    shifted = buf[1:].view(feats.shape)
    shifted.copy_(feats)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 != 0
    args = (pts, images, proj, (239, 320), shifted)
    got = render.streaming_sample_mean_var(*args)
    want = render.streaming_sample_mean_var_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(got[1], want[1])
    assert _rel(got[0], want[0]) <= 1e-5


def _offset(t, elements):
    """A contiguous copy of ``t`` starting ``elements`` elements past an
    allocation's (512-byte aligned) start."""
    buf = torch.empty(t.numel() + elements, dtype=t.dtype, device=t.device)
    out = buf[elements:].view(t.shape)
    out.copy_(t)
    assert out.data_ptr() % 512 == elements * t.element_size()
    return out


@pytest.mark.parametrize("offset", [0, 1, 4])
@pytest.mark.parametrize("c", [3, 8, 16, 32])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("form", ["eval", "training"])
def test_streaming_sample_mean_var_lane_forms_bitwise(dev, form, dtype, c,
                                                      offset):
    """Every lane mapping of K2 (16-byte loads: 4 float32 or 8 bfloat16
    channels a lane; 8-byte loads of 4 bfloat16; one channel a lane) in
    both forms, bit for bit against the plain twins: globalfeat, the
    mask, and under grad s1u and the count. N = 37 x 5 = 185 points, not
    a multiple of the 64-point tile; maps offset by 0, 1 or 4 elements
    from a 16-byte boundary, so the shape and the alignment pick the
    form."""
    pts, images, feats, proj = _ray_inputs(dev, 7, 37, 5, c, seed=c)
    images = images.to(dtype)
    feats = _offset(feats.to(dtype), offset)
    host = _host_rgb(pts, images, proj) if form == "training" else None
    args = (pts, None if host else images, proj, (239, 320), feats, host)
    got = render._k2_launch(*args, for_grad=True)
    want = render.streaming_sample_mean_var_plain(*args)
    carry = render.ray_view_carry_plain(pts, None if host else images,
                                        feats, proj, (239, 320))
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(got[2], carry[0][..., -c:])
    want_cnt = host[3] if host else carry[3]
    assert torch.equal(got[3], want_cnt)
    assert float(want[1].float().mean()) > 0


def test_streaming_sample_mean_var_rejects_what_it_cannot_take(dev):
    pts, images, feats, proj = _ray_inputs(dev, 2, 16, 4, 32)
    fused = render.streaming_sample_mean_var
    with pytest.raises(TypeError, match="float32"):
        fused(pts.double(), images, proj, (239, 320), feats)
    with pytest.raises(ValueError, match="feature channels"):
        fused(pts, images, proj, (239, 320), torch.cat([feats, feats], -1))
    with pytest.raises(ValueError, match="contiguous"):
        fused(pts, images, proj, (239, 320), feats[:, :, :40])
    with pytest.raises(ValueError, match="images"):
        fused(pts, images[..., :2].contiguous(), proj, (239, 320), feats)
    with pytest.raises(ValueError, match="unsupported device"):
        fused(pts.to("meta"), images, proj, (239, 320), feats)


def _host_rgb(pts, images, proj):
    """The training form's host rgb sums and count: the plain carry's rgb
    channels (they equal ``data/ray_stats.host_ray_rgb_stats``'s)."""
    carry = render.ray_view_carry_plain(pts, images, images[..., :1], proj,
                                        (239, 320))
    return tuple(t[..., :3].contiguous() for t in carry[:3]) + (carry[3],)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("v,r,s,c", [
    (50, 2048, 64, 32),  # the training path's shape
    (3, 37, 5, 8), (7, 64, 64, 32), (6, 50, 13, 30),
])
def test_streaming_sample_mean_var_training_form_matches_plain(dev, v, r, s,
                                                               c, dtype):
    """K2 with the host rgb sums (the training form) against its plain
    version: the mask exact, globalfeat 1e-5 relative, and under grad the
    feature channels' s1u and the host count as the carry has them."""
    pts, images, feats, proj = _ray_inputs(dev, v, r, s, c, seed=v + s)
    images, feats = images.to(dtype), feats.to(dtype)
    host = _host_rgb(pts, images, proj)
    args = (pts, None, proj, (239, 320), feats, host)
    before = render.streaming_sample_mean_var.launches
    got = render._k2_launch(*args, for_grad=True)
    render.streaming_sample_mean_var(*args)
    want = render.streaming_sample_mean_var_plain(*args)
    carry = render.ray_view_carry_plain(pts, None, feats, proj, (239, 320))
    torch.cuda.synchronize()
    assert render.streaming_sample_mean_var.launches == before + 1
    assert torch.equal(got[1], want[1])
    assert _rel(got[0], want[0]) <= 1e-5
    assert _rel(got[2], carry[0]) <= 1e-5
    if dtype == torch.bfloat16:
        assert torch.equal(got[0], want[0]) and torch.equal(got[2], carry[0])
    assert got[3] is host[3]
    # the eval form under grad writes its own count
    ev = render._k2_launch(pts, images, proj, (239, 320), feats,
                           for_grad=True)
    torch.cuda.synchronize()
    assert torch.equal(ev[3], render.ray_view_carry_plain(
        pts, images, feats, proj, (239, 320))[3])


@pytest.mark.parametrize("offset", [0, 1, 4])
@pytest.mark.parametrize("v,r,s,c", [
    (50, 2048, 64, 32),  # a render chunk's and a train step's shape
    (7, 37, 5, 3), (7, 37, 5, 8), (4, 33, 3, 16), (25, 64, 16, 32),
    (1, 1, 1, 32)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("form", ["eval", "training"])
def test_streaming_sample_sums_bitwise(dev, form, dtype, v, r, s, c, offset):
    """K2's sums form (the views-sharded path: the rank's raw sums, no
    epilogue) bit for bit against its plain version in every lane mapping
    (the shape and the maps' alignment pick it): s1u, s2u, s1m over 3 + C
    channels and the count in the eval form, over the C feature channels
    alone in the training form (no count). One counted launch; the
    unsharded forms' epilogue on the same sums gives their globalfeat."""
    pts, images, feats, proj = _ray_inputs(dev, v, r, s, c, seed=v + c)
    images = images.to(dtype)
    feats = _offset(feats.to(dtype), offset)
    host = form == "training"
    args = (pts, images, proj, (239, 320), feats, host)
    before = render.streaming_sample_sums.launches
    got = render.streaming_sample_sums(*args)
    want = render.streaming_sample_sums_plain(*args)
    torch.cuda.synchronize()
    assert render.streaming_sample_sums.launches == before + 1
    cs = c if host else 3 + c
    for a, b in zip(got[:3], want[:3]):
        assert a.shape == (r, s, cs) and torch.equal(a, b)
    if host:
        assert got[3] is None and want[3] is None
    else:
        assert torch.equal(got[3], want[3])
        gf, mask = render.sample_stats(*got, v)
        full = render.streaming_sample_mean_var_plain(
            pts, images, proj, (239, 320), feats)
        assert torch.equal(gf, full[0]) and torch.equal(mask, full[1])


def test_streaming_sample_sums_rejects_what_it_cannot_take(dev):
    pts, images, feats, proj = _ray_inputs(dev, 2, 16, 4, 32)
    sums = render.streaming_sample_sums
    with pytest.raises(TypeError, match="float32"):
        sums(pts.double(), images, proj, (239, 320), feats)
    with pytest.raises(ValueError, match="feature channels"):
        sums(pts, images, proj, (239, 320), torch.cat([feats, feats], -1))
    with pytest.raises(ValueError, match="needs the images"):
        sums(pts, None, proj, (239, 320), feats)


def _backward_inputs(dev, case, v, r, s, c, seed, dtype=torch.float32):
    """K2's backward inputs: the forward's globalfeat, s1u and count at
    ``_ray_inputs`` points and a random cotangent. "border": every point
    pushed to the maps' edge band, where windows clamp and weights are
    partial; "interior": points near the room's centre; "one point":
    every sample at one point, so each view's pairs share one window;
    "behind": every point behind every camera, so every pair is
    dropped."""
    pts, images, feats, proj = _ray_inputs(dev, v, r, s, c, seed=seed)
    if case == "border":
        pts = pts * 2.5
    elif case == "interior":
        pts = pts * 0.3
    elif case == "one point":
        pts = pts[-1:, -1:].expand_as(pts).contiguous() * 0.3
    elif case == "behind":
        pts = pts + torch.tensor([0.0, 0.0, 60.0], device=dev)
    host = _host_rgb(pts, images, proj)
    feats = feats.to(dtype)
    gf, _, s1u, cnt = render._k2_launch(pts, None, proj, (239, 320), feats,
                                        host, for_grad=True)
    gen = torch.Generator(device=dev).manual_seed(seed)
    g = torch.randn(gf.shape, generator=gen, device=dev)
    return pts, proj, feats, g, gf, s1u, cnt


def _k2_backward_cases():
    """Each shape with each case, except "one point" at the training
    path's 131,072 points: its one window a view sums 131,072 terms, and
    two float32 sums of that many terms in different orders (the kernel's
    point order, the plain version's atomic ``index_add_`` on the card)
    differ by more than 1e-5 of the max. The smaller shapes hold the skew;
    ``test_streaming_sample_mean_var_backward_sums_in_point_order`` holds
    it bit for bit."""
    shapes = [(50, 2048, 64, 32), (5, 300, 16, 8), (4, 33, 3, 32),
              (6, 50, 13, 30), (5, 100, 16, 1), (1, 64, 16, 32)]
    return [pytest.param(case, *shape, id="-".join(map(str, shape + (case,))))
            for case in ("scene", "border", "interior", "one point",
                         "behind") for shape in shapes
            if not (case == "one point" and shape[1] * shape[2] > 10 ** 5)]


@pytest.mark.parametrize("case", ["scene", "border", "interior", "behind"])
@pytest.mark.parametrize("v,r,s,c", [(50, 2048, 64, 32), (5, 300, 16, 8),
                                     (6, 50, 13, 30), (1, 64, 16, 32)])
def test_streaming_sample_mean_var_backward_bf16_matches_plain(dev, case, v,
                                                               r, s, c):
    """K2's backward on bfloat16 maps against its plain version, which
    rounds as JAX's transpose does: the same cotangents in the same
    order, so bit for bit, and bitwise the same on a second run."""
    pts, proj, feats, g, gf, s1u, cnt = _backward_inputs(
        dev, case, v, r, s, c, seed=v + r + c, dtype=torch.bfloat16)
    before = render.streaming_sample_mean_var_backward.launches
    got = render.streaming_sample_mean_var_backward(
        pts, proj, (239, 320), feats, g, gf, s1u, cnt)
    want = render.streaming_sample_mean_var_backward_plain(
        pts, proj, (239, 320), feats, g, gf, s1u, cnt)
    torch.cuda.synchronize()
    assert render.streaming_sample_mean_var_backward.launches == before + 1
    assert got.shape == feats.shape and got.dtype == torch.bfloat16
    assert torch.equal(got, want)
    if case != "behind":
        assert float(want.float().abs().max()) > 0
    again = render.streaming_sample_mean_var_backward(
        pts, proj, (239, 320), feats, g, gf, s1u, cnt)
    assert torch.equal(got, again)


@pytest.mark.parametrize("case,v,r,s,c", [
    ("scene", 50, 2048, 64, 32),  # the training path's shape
    ("scene", 5, 300, 16, 8), ("border", 6, 50, 13, 30),
    ("interior", 5, 300, 16, 32), ("behind", 2, 64, 16, 32),
    ("one point", 4, 33, 3, 32), ("one point", 3, 40, 16, 1),
    ("unaligned map", 5, 100, 16, 32),
])
def test_streaming_sample_mean_var_backward_bf16_passes_match_twins(
        dev, case, v, r, s, c):
    """Each pass of K2's backward on bfloat16 maps against its plain twin
    on the same inputs, bit for bit: pass 0's keys (no cotangent rows),
    the index preparation's ``off`` and every kept pair's rank, pass 1a's
    df and weights at the kept slots, pass 1b's windows that hold a pair,
    pass 2's texels, and the whole against the plain backward. "one
    point" puts every pair of a view in one window (more than 32 pairs);
    "unaligned map" starts the maps off a 16-byte boundary."""
    pts, proj, feats, g, gf, s1u, cnt = _backward_inputs(
        dev, "scene" if case == "unaligned map" else case, v, r, s, c,
        seed=v + r + c, dtype=torch.bfloat16)
    if case == "unaligned map":
        feats = _unaligned(feats)
    args = (pts, proj, (239, 320), feats, g, gf, s1u, cnt)
    n_win = v * feats.shape[1] * feats.shape[2]
    keys, coef = render._backward_keys(*args)
    want_keys, want_coef = render.backward_keys_plain(*args)
    assert coef is None and want_coef is None
    assert torch.equal(keys, want_keys)
    rank, off = render.window_rank(keys, n_win)
    want_rank, want_off = render.window_rank_plain(keys, n_win)
    kept = int(want_off[-1])
    sel = want_rank >= 0
    assert torch.equal(off, want_off) and torch.equal(rank[sel],
                                                      want_rank[sel])
    df, wts = render._pair_df(*args, rank)
    want_df, want_wts = render.pair_df_plain(*args, want_rank)
    assert torch.equal(df[:kept], want_df[:kept])
    assert torch.equal(wts[:kept], want_wts[:kept])
    packed = render._window_sums_bf16(df, wts, off, feats)
    want_packed = render.window_sums_bf16_plain(df, wts, off, feats)
    held = off[1:] > off[:-1]
    assert packed.dtype == torch.bfloat16
    assert torch.equal(packed[held], want_packed[held])
    got = render._unpack(packed, off, feats)
    assert torch.equal(got, render.unpack_plain(packed, off, feats))
    whole = render.streaming_sample_mean_var_backward(*args)
    torch.cuda.synchronize()
    assert torch.equal(whole, got)
    assert torch.equal(got, render.streaming_sample_mean_var_backward_plain(
        *args))
    if case == "one point":
        assert int((off[1:] - off[:-1]).max()) > 32
    if case != "behind":
        assert kept > 0 and float(got.float().abs().max()) > 0


@pytest.mark.parametrize("case,v,r,s,c", _k2_backward_cases())
def test_streaming_sample_mean_var_backward_matches_plain(dev, case, v, r,
                                                          s, c):
    """K2's backward kernel against its plain version (``index_add_`` in
    point order): within 1e-5 x max (the texel sums run in another
    order), and bitwise the same on a second run."""
    pts, proj, feats, g, gf, s1u, cnt = _backward_inputs(
        dev, case, v, r, s, c, seed=v + r + c)
    before = render.streaming_sample_mean_var_backward.launches
    got = render.streaming_sample_mean_var_backward(
        pts, proj, (239, 320), feats, g, gf, s1u, cnt)
    want = render.streaming_sample_mean_var_backward_plain(
        pts, proj, (239, 320), feats, g, gf, s1u, cnt)
    torch.cuda.synchronize()
    assert render.streaming_sample_mean_var_backward.launches == before + 1
    assert got.shape == feats.shape and got.dtype == torch.float32
    if case == "behind":
        assert float(got.abs().max()) == float(want.abs().max()) == 0.0
    else:
        assert float(want.abs().max()) > 0
        assert _rel(got, want) <= 1e-5
    again = render.streaming_sample_mean_var_backward(
        pts, proj, (239, 320), feats, g, gf, s1u, cnt)
    assert torch.equal(got, again)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case,v,r,s,c,n_views", [
    ("scene", 25, 2048, 64, 32, 50),  # half the train path's views
    ("scene", 5, 300, 16, 8, 15), ("border", 6, 50, 13, 30, 12),
    ("interior", 3, 300, 16, 32, 7), ("behind", 2, 64, 16, 32, 4)])
def test_streaming_sample_mean_var_backward_at_a_global_view_count(
        dev, dtype, case, v, r, s, c, n_views):
    """K2's backward on a rank's share of a scene's views: its loop runs
    over the V maps given, the statistics' cotangents take the scene's
    ``n_views`` != V. Against the plain version at the same ``n_views``:
    float32 within 1e-5 x max (the test above), bfloat16 bit for bit, with
    pass 0's cotangent rows and pass 1a's df their twins' bit for bit; and
    unlike the backward at V."""
    pts, proj, feats, g, gf, s1u, cnt = _backward_inputs(
        dev, case, v, r, s, c, seed=v + r + c, dtype=dtype)
    args = (pts, proj, (239, 320), feats, g, gf, s1u, cnt)
    got = render.streaming_sample_mean_var_backward(*args, n_views=n_views)
    want = render.streaming_sample_mean_var_backward_plain(
        *args, n_views=n_views)
    at_v = render.streaming_sample_mean_var_backward_plain(*args)
    torch.cuda.synchronize()
    assert got.shape == feats.shape and got.dtype == dtype
    if case == "behind":
        assert float(got.float().abs().max()) == 0.0
        return
    assert not torch.equal(want, at_v)
    if dtype == torch.bfloat16:
        assert torch.equal(got, want)
        keys, _ = render._backward_keys(*args, n_views)
        rank, _ = render.window_rank(keys, v * feats.shape[1]
                                     * feats.shape[2])
        want_rank, off = render.window_rank_plain(keys, v * feats.shape[1]
                                                  * feats.shape[2])
        kept = int(off[-1])
        df, wts = render._pair_df(*args, rank, n_views)
        want_df, _ = render.pair_df_plain(*args, want_rank, n_views)
        assert torch.equal(df[:kept], want_df[:kept])
    else:
        assert _rel(got, want) <= 1e-5
        _, coef = render._backward_keys(*args, n_views)
        _, want_coef = render.backward_keys_plain(*args, n_views)
        assert torch.equal(coef, want_coef)


@pytest.mark.parametrize("form", ["training", "eval"])
def test_streaming_sample_mean_var_gradient_is_the_kernels(dev, form):
    """Through ``streaming_sample_mean_var`` on the card, autograd takes
    K2's backward kernel (one counted launch), and the gradient agrees
    with autograd through the plain version (1e-5 x max)."""
    pts, images, feats, proj = _ray_inputs(dev, 8, 256, 32, 32, seed=3)
    host = _host_rgb(pts, images, proj) if form == "training" else None
    g = torch.randn((256, 32, 70), device=dev)

    def grad(fn):
        f = feats.clone().requires_grad_()
        gf, _ = fn(pts, images, proj, (239, 320), f, host)
        (gf * g).sum().backward()
        return f.grad

    before = render.streaming_sample_mean_var_backward.launches
    got = grad(render.streaming_sample_mean_var)
    assert render.streaming_sample_mean_var_backward.launches == before + 1
    want = grad(render.streaming_sample_mean_var_plain)
    torch.cuda.synchronize()
    assert _rel(got, want) <= 1e-5


def test_streaming_sample_mean_var_backward_refuses_what_it_cannot_take(dev):
    pts, proj, feats, g, gf, s1u, cnt = _backward_inputs(
        dev, "scene", 2, 16, 4, 32, seed=0)
    bwd = render.streaming_sample_mean_var_backward
    args = (pts, proj, (239, 320))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        render.streaming_sample_mean_var(
            pts, None, proj, (239, 320),
            feats.half().requires_grad_(), _host_rgb(
                pts, torch.rand((2, 240, 320, 3), device=dev), proj))
    with pytest.raises(TypeError, match="float32"):
        bwd(*args, feats.half(), g, gf, s1u, cnt)
    wide = torch.cat([feats, feats[..., :1]], -1)
    with pytest.raises(ValueError, match="feature channels"):
        bwd(*args, wide, g, gf, s1u, cnt)
    with pytest.raises(ValueError, match="g must be"):
        bwd(*args, feats, g[..., :-1], gf, s1u, cnt)
    with pytest.raises(ValueError, match="unsupported device"):
        bwd(pts.to("meta"), proj, (239, 320), feats, g, gf, s1u, cnt)


# ---- the backwards' index preparation and summation order -----------------


def _window_keys(dev, case, v, n, hw, seed):
    """Pair keys as K2's pass 0 writes them: v hw + window, v hw the
    dropped pairs' key."""
    rng = np.random.RandomState(seed)
    win = rng.randint(0, hw, (v, n))
    if case == "few windows":  # most windows hold no pair
        win = (rng.randint(0, 5, (v, n)) * 7) % hw
    elif case == "one window":
        win[:] = hw // 2
    keys = win + (np.arange(v) * hw)[:, None]
    if case == "dropped":
        keys[rng.rand(v, n) < 0.36] = v * hw
    elif case == "all dropped":
        keys[:] = v * hw
    return torch.from_numpy(keys.astype(np.int32)).to(dev)


@pytest.mark.parametrize("case", ["dropped", "few windows", "one window",
                                  "all dropped"])
@pytest.mark.parametrize("v,n,hw", [
    (50, 20000, 4720),  # three tiles a view
    (1, 2 * 8192 + 5, 4720), (3, 100, 12), (2, 1, 7),
])
def test_window_order_kernel_equals_plain(dev, case, v, n, hw):
    """K2's index preparation (a counting sort by hand) gives exactly
    the plain version's ``off`` and, up to ``off[-1]``, its ``order``;
    two runs bitwise equal."""
    keys = _window_keys(dev, case, v, n, hw, seed=v + n)
    order, off = render.window_order(keys, v * hw)
    want_order, want_off = render.window_order_plain(keys, v * hw)
    again = render.window_order(keys, v * hw)
    torch.cuda.synchronize()
    assert order.dtype == off.dtype == torch.int32
    assert torch.equal(off, want_off) and torch.equal(again[1], off)
    kept = int(want_off[-1])
    assert torch.equal(order[:kept], want_order[:kept])
    assert torch.equal(again[0][:kept], order[:kept])


@pytest.mark.parametrize("case", ["scene", "blind view",
                                  "100 voxels on one pixel", "single view",
                                  "no valid voxel", "training path"])
def test_pixel_order_kernel_equals_plain(dev, case):
    """K1's index preparation (a counting sort by hand) gives exactly the
    plain version's order, off, referenced rows and their counts."""
    if case == "training path":  # 50 views, 25,600 voxels: four tiles
        pix = _pix(dev, v=50, nvox=(40, 40, 16))
    else:
        pix = _k1_pix(dev, case)
    got = voxel.pixel_order(pix, 4800)
    want = voxel.pixel_order_plain(pix, 4800)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


def _k1_in_voxel_order(feats, pix, g1, g2):
    """K1's d features without the mapped stream, summed in torch op by op
    in the order the kernel keeps: each pixel's voxels ascending."""
    v, h, w, c = feats.shape
    order, off, _, _ = voxel.pixel_order_plain(pix, h * w)
    x = feats.reshape(v, h * w, c)
    a1, a2 = torch.zeros_like(x), torch.zeros_like(x)
    cnt = off[:, 1:] - off[:, :-1]
    for k in range(int(cnt.max())):
        vi, pi = torch.nonzero(cnt > k, as_tuple=True)
        n = order[vi, off[vi, pi] + k].long()
        a1[vi, pi] = a1[vi, pi] + g1[n]
        if g2 is not None:
            a2[vi, pi] = a2[vi, pi] + g2[n]
    if g2 is not None:
        a1 = a1 + (2.0 * x) * a2
    return torch.where((cnt > 0)[..., None], a1, 0.0).reshape(v, h, w, c)


@pytest.mark.parametrize("case", ["scene", "100 voxels on one pixel"])
@pytest.mark.parametrize("with_g2", [False, True])
@pytest.mark.parametrize("c", [32, 256])
def test_fusion_backward_sums_each_pixel_in_voxel_order(dev, c, with_g2,
                                                        case):
    """K1's d features bitwise equal to its pixels' voxels summed in
    ascending voxel order (the order of the design before this one)."""
    feats, pix, count, g1, g2, _, _, _ = _backward_case(dev, case, c, False,
                                                        with_g2)
    got = voxel.fusion_carry_backward(feats, pix, count, g1, g2)[0]
    want = _k1_in_voxel_order(feats, pix, g1, g2)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def _k2_in_point_order(pts, proj, feats, coef, keys):
    """K2's backward from pass 0's keys and cotangents, summed in torch op
    by op in the order the kernel keeps: each window's pairs in ascending
    point order, then the fixed unpack."""
    from nerfdet_tpu_torch.ops.grid_sample import _window

    v, fh, fw, c = feats.shape
    n, dev = coef.shape[0], feats.device
    xyz = pts.reshape(-1, 3)
    order, off = render.window_order_plain(keys, v * fh * fw)
    kept = int(off[-1])
    order = order[:kept].long()
    win = torch.repeat_interleave(torch.arange(v * fh * fw, device=dev),
                                  (off[1:] - off[:-1]).long())
    rank = torch.arange(kept, device=dev) - off[:-1].long()[win]
    wts = torch.empty((v, n, 4), device=dev)
    dfs = torch.empty((v, n, c), device=dev)
    for i in range(v):
        px, py, m = render._view_pixels(xyz, proj[i:i + 1], (239, 320))
        px, py = px * render._scale(fw, 320), py * render._scale(fh, 239)
        f = render.grid_sample_2d_packed(render.pack_bilinear(feats[i]),
                                         px, py)
        # the kernel's df: (d s1u + m d s1m) + (2 f) d s2u, from pass 0's
        # rows d s1u + d s1m, d s1u and d s2u
        dfs[i] = torch.where(m > 0, coef[:, 0], coef[:, 1]) + (
            2.0 * f) * coef[:, 2]
        _, wx0, wx1 = _window(px, fw)
        _, wy0, wy1 = _window(py, fh)
        wts[i] = torch.stack([wy0 * wx0, wy0 * wx1, wy1 * wx0, wy1 * wx1], -1)
    df, w = dfs[order // n, order % n], wts[order // n, order % n]
    acc = torch.zeros((v * fh * fw, 4, c), device=dev)
    for k in range(int(rank.max()) + 1 if kept else 0):
        sel = rank == k
        acc[win[sel]] = acc[win[sel]] + w[sel][:, :, None] * df[sel][:, None]
    acc = acc.reshape(v, fh, fw, 4, c)
    out = acc[..., 0, :].clone()
    out[:, :, 1:] = out[:, :, 1:] + acc[:, :, :-1, 1]
    out[:, 1:] = out[:, 1:] + acc[:, :-1, :, 2]
    out[:, 1:, 1:] = out[:, 1:, 1:] + acc[:, :-1, :-1, 3]
    return out


@pytest.mark.parametrize("case", ["scene", "border", "one point"])
@pytest.mark.parametrize("v,r,s,c", [(5, 100, 64, 8), (3, 40, 16, 1),
                                     (4, 33, 3, 30)])
def test_streaming_sample_mean_var_backward_sums_in_point_order(dev, case, v,
                                                                r, s, c):
    """K2's backward bitwise equal to its windows' pairs summed in
    ascending point order and unpacked in the fixed order (the order of
    the design before this one)."""
    pts, proj, feats, g, gf, s1u, cnt = _backward_inputs(
        dev, case, v, r, s, c, seed=v + r + c)
    bargs = (pts, proj, (239, 320), feats, g, gf, s1u, cnt)
    got = render.streaming_sample_mean_var_backward(*bargs)
    keys, coef = render._backward_keys(*bargs)
    want = _k2_in_point_order(pts, proj, feats, coef, keys)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_k2_backward_refuses_more_windows_than_shared_memory_holds(dev):
    pts, proj, feats, g, gf, s1u, cnt = _backward_inputs(
        dev, "scene", 2, 16, 4, 1, seed=0)
    big = torch.zeros((2, 250, 240, 1), device=dev)
    with pytest.raises(ValueError, match="shared memory"):
        render.streaming_sample_mean_var_backward(
            pts, proj, (239, 320), big, g, gf, s1u, cnt)


# ---- the fast_cov family's shapes: 480x640 scenes, M = 16, C = 16 ---------

FAMILY_IMG = (478, 640)  # img_shape of the family's 640x480 Resize


def _family_cameras(rng, v):
    """``_cameras`` at the family's 640x480 images (twice the focal)."""
    intrinsic, extr = _cameras(rng, v)
    intrinsic = intrinsic.copy()
    intrinsic[:2] *= 2.0
    return intrinsic, extr


def _family_pix(dev, v):
    """K1's pixel indices at the family's stride-4 maps (120x160, bounds
    119x160) for the exemplar's 40x40x16 volume at 0.2 m."""
    intrinsic, extr = _family_cameras(np.random.RandomState(v), v)
    points = voxel.get_points((40, 40, 16), (0.2, 0.2, 0.2), (0, 0, 0.5),
                              dev).reshape(-1, 3)
    proj = voxel.compute_projection(intrinsic, extr, 4.0, dev)
    x, y, _, valid = voxel.project_points(points, proj, 119, 160)
    return voxel.pixel_index(x, y, valid, 160).contiguous()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_family_mapped_rows_m16_and_carry_match_plain(dev, dtype):
    """K1 at ``squeeze_scale`` 8 (M = 16) on the family's 51 views of
    (120, 160, 256) maps: phase A's rows within 1e-5 relative of
    ``mapped_rows_plain`` (on bfloat16 maps W in three pieces on the
    tensor cores), the carry's count, s1 and s2 bitwise and s2m 1e-5."""
    gen = torch.Generator(device=dev).manual_seed(16)
    feats = torch.randn((51, 120, 160, 256), generator=gen,
                        device=dev).to(dtype)
    w = torch.randn((256, 16), generator=gen, device=dev) / 16.0
    b = torch.randn((16,), generator=gen, device=dev)
    got = voxel._mapped_rows_launch(feats, w, b)
    want = voxel.mapped_rows_plain(feats, w, b)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (51, 120 * 160, 16)
    assert _rel(got, want) <= 1e-5
    del got, want
    pix = _family_pix(dev, 51)
    k = voxel.fusion_carry(feats, pix, w, b)
    p = voxel.fusion_carry_plain(feats, pix, w, b)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(k[:3], p[:3]))
    assert _rel(k[3], p[3]) <= 1e-5
    assert float(k[2].max()) >= 2 and int((k[2] == 0).sum()) > 0


@pytest.mark.parametrize("mapped", [False, True])
def test_family_fusion_backward_with_g2_matches_plain(dev, mapped):
    """K1's backward with the s2 cotangent (kG2: a ``cov`` volume trains
    it) at the exemplar's training shape, 30 views of 480x640 (120x160
    maps), C = 256, M = 32: d features within 1e-5 x max, dW and db 1e-4 x
    max, a second run bitwise (``test_fusion_backward_matches_plain``'s
    tolerances)."""
    pix = _family_pix(dev, 30)
    gen = torch.Generator(device=dev).manual_seed(30)
    n, c, m = pix.shape[1], 256, 32
    feats = torch.randn((30, 120, 160, c), generator=gen, device=dev)
    w = b = gm = rows = None
    if mapped:
        w = torch.randn((c, m), generator=gen, device=dev) / c ** 0.5
        b = torch.randn((m,), generator=gen, device=dev)
        gm = torch.randn((n, m), generator=gen, device=dev)
        rows = voxel.mapped_rows_plain(feats, w, b)
    g1 = torch.randn((n, c), generator=gen, device=dev)
    g2 = torch.randn((n, c), generator=gen, device=dev)
    count = (pix >= 0).float().sum(0)
    args = (feats, pix, count, g1, g2, gm, w, b, rows)
    got = voxel.fusion_carry_backward(*args)
    want = voxel.fusion_carry_backward_plain(*args)
    again = voxel.fusion_carry_backward(*args)
    torch.cuda.synchronize()
    assert _close(got[0], want[0], 1e-5)
    assert _close(got[1], want[1], 1e-4) and _close(got[2], want[2], 1e-4)
    for x, y in zip(got, again):
        assert (x is None and y is None) or torch.equal(x, y)


def _family_rays(dev, v, r, s, c, seed):
    """``_ray_inputs`` at the family's size: 480x640 images, 119x160
    feature maps of C channels, the cameras at 478x640."""
    rng = np.random.RandomState(seed)
    intrinsic, extr = _family_cameras(rng, v)
    pts = rng.uniform([-3, -3, -0.5], [3, 3, 3], (r, s, 3))
    pts[: r // 8, :, 2] += 50.0
    images = rng.uniform(0, 1, (v, 480, 640, 3))
    feats = rng.randn(v, 119, 160, c)
    proj = render.view_projection(intrinsic, extr, 1.0, dev)
    return [torch.from_numpy(a.astype(np.float32)).to(dev)
            for a in (pts, images, feats)] + [proj]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("form", ["eval", "training"])
def test_family_k2_c16_forms_and_backward_match_plain(dev, form, dtype):
    """K2 at C = 16 (``squeeze_scale`` 8) at the squeeze-8 config's
    training shape, 40 views of 480x640 and 4096 rays of 64 samples, in
    the eval form (the family trains through it, under grad) and the
    training form: the mask exact, globalfeat 1e-5 relative (bfloat16 bit
    for bit); then K2's backward on a random cotangent against its plain
    version, 1e-5 x max (bfloat16 bit for bit), a second run bitwise."""
    pts, images, feats, proj = _family_rays(dev, 40, 4096, 64, 16, seed=16)
    images, feats = images.to(dtype), feats.to(dtype)
    host = None
    if form == "training":
        carry = render.ray_view_carry_plain(pts, images, images[..., :1],
                                            proj, FAMILY_IMG)
        host = tuple(t[..., :3].contiguous() for t in carry[:3]) + (
            carry[3],)
        del carry
    args = (pts, None if host else images, proj, FAMILY_IMG, feats, host)
    gf, mask, s1u, cnt = render._k2_launch(*args, for_grad=True)
    want = render.streaming_sample_mean_var_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(mask, want[1])
    assert 0 < float(mask.float().mean()) < 1
    assert _rel(gf, want[0]) <= 1e-5
    if dtype == torch.bfloat16:
        assert torch.equal(gf, want[0])
    gen = torch.Generator(device=dev).manual_seed(40)
    g = torch.randn(gf.shape, generator=gen, device=dev)
    bargs = (pts, proj, FAMILY_IMG, feats, g, gf, s1u, cnt)
    d = render.streaming_sample_mean_var_backward(*bargs)
    again = render.streaming_sample_mean_var_backward(*bargs)
    d_want = render.streaming_sample_mean_var_backward_plain(*bargs)
    torch.cuda.synchronize()
    assert torch.equal(d, again)
    assert float(d_want.float().abs().max()) > 0
    if dtype == torch.bfloat16:
        assert torch.equal(d, d_want)
    else:
        assert _rel(d, d_want) <= 1e-5


def test_entry_device_turns_tf32_off(dev):
    from nerfdet_tpu_torch.device import resolve_device

    torch.backends.cudnn.allow_tf32 = True
    assert resolve_device("cuda").type == "cuda"
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.backends.cuda.matmul.allow_tf32 is False


def test_jpeg_fixtures_decode_to_their_hashes(dev):
    """The JAX writer's JPEG views under ``tests/data/torch_jpeg`` decode
    to the SHA-256 of ``cv2.imread``'s RGB output recorded beside them,
    on the card's machine (no cv2, the decoder's entropy stage built with
    its host compiler)."""
    import hashlib
    import json
    import os

    from nerfdet_tpu_torch.data import pipeline

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                        "torch_jpeg")
    with open(os.path.join(root, "meta.json")) as f:
        meta = json.load(f)
    for part in meta.values():
        for view in part["views"]:
            rgb = pipeline.imread(os.path.join(root, view["file"]))
            assert rgb.shape == tuple(part["hw"]) + (3,)
            assert hashlib.sha256(rgb.tobytes()).hexdigest() == \
                view["sha256"], view["file"]


# ---------------------------------------------------------------------
# data parallel on the card (``parallel/dist.py``): the toy joint step
# of ``tests/test_torch_ddp.py``, random weights, ``loss_depth`` on
# ---------------------------------------------------------------------

DDP_TIMEOUT = 300.0


def _ddp_toy(dev):
    from nerfdet_tpu_torch.models.nerfdet import NerfDet, SceneMeta

    model = NerfDet(
        fpn_out_channels=64, neck3d_out_channels=16,
        neck3d_n_blocks=(1, 1, 1), n_classes=5, n_scales=3,
        n_voxels=(8, 8, 4), voxel_size=(0.8, 0.8, 0.8), n_samples=16,
        n_rand=24, near_far_range=(0.2, 8.0), nerf_density=True,
        meta=SceneMeta(ori_shape=(128, 160), img_shape=(31, 40),
                       pad_shape=(32, 40)))
    model.init_weights(torch.Generator().manual_seed(0))
    return model.to(dev)


def _ddp_scene(seed):
    from nerfdet_tpu_torch.data.ray_stats import prepare_rays
    from nerfdet_tpu_torch.data.rgb_stats import host_rgb_stats
    from nerfdet_tpu_torch.data.synthetic import make_synthetic_scene

    s = make_synthetic_scene(seed=seed, n_views=3, n_targets=1, hw=(31, 40),
                             pad_hw=(32, 40), n_rand=24, n_boxes=2, max_gt=4,
                             margin=2)
    s["intrinsic"] = s["intrinsic"].copy()
    s["intrinsic"][:2] *= np.float32(128 / 31)
    s1, s2 = host_rgb_stats(s["denorm_images"], s["intrinsic"],
                            s["extrinsics"], s["origin"], (8, 8, 4),
                            (0.8, 0.8, 0.8), (128, 160), (31, 40))
    return prepare_rays(dict(s, rgb_s1=s1, rgb_s2=s2),
                        np.random.RandomState(11 + seed), 24, (0.2, 8.0), 16,
                        (128, 160), (31, 40))


def _ddp_step(dev, seeds, group=None):
    """One joint step of the toy on the scenes of ``seeds``: metrics, the
    gradients the update read, the state after it, on the host."""
    from nerfdet_tpu_torch import api
    from nerfdet_tpu_torch.device import resolve_device
    from nerfdet_tpu_torch.train.optim import build_optimizer
    from nerfdet_tpu_torch.train.step import make_train_step

    dev = resolve_device(dev)  # TF32 off, as every entry point sets it
    torch.backends.cudnn.deterministic = True
    model = _ddp_toy(dev)
    opt = build_optimizer(model, dict(type="AdamW", lr=2e-4,
                                      weight_decay=1e-4),
                          grad_clip=dict(max_norm=35.0))
    step = make_train_step(model, opt, depth_supervise=True,
                           process_group=group)
    metrics = step(api.train_batch(model, [_ddp_scene(s) for s in seeds]))
    return dict(metrics={k: v.cpu() for k, v in metrics.items()},
                grads={n: p.grad.cpu() for n, p in model.named_parameters()},
                state={k: v.cpu() for k, v in model.state_dict().items()})


def _ddp_rank(rank, world, port, backend, out):
    import os

    import torch.distributed as dist

    from nerfdet_tpu_torch.parallel import dist as pdist

    if backend == "gloo":  # every rank on the one card
        os.environ["LOCAL_RANK"] = "0"
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                                world_size=world, rank=rank)
    with pdist.process_group("cuda", f"localhost:{port}", world, rank) as (
            dev, group):
        got = _ddp_step(dev, [3 + rank], group)
        if world == 1:
            got = dict(group=got, none=_ddp_step(dev, [3]))
    if backend == "gloo":
        dist.destroy_process_group()
    torch.save(got, os.path.join(out, f"rank{rank}.pt"))


def _ddp_spawn(world, backend, out):
    import socket
    import time

    import torch.multiprocessing as mp

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_ddp_rank, args=(r, world, port, backend,
                                                 str(out)))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + DDP_TIMEOUT
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
        p.join()
    assert not alive, f"ranks still running after {DDP_TIMEOUT} s, killed"
    assert [p.exitcode for p in procs] == [0] * world
    return [torch.load(out / f"rank{r}.pt") for r in range(world)]


def test_ddp_nccl_group_of_one_is_bitwise_no_group(dev, tmp_path):
    """NCCL at world 1: the step of a group of one is the step of no
    group, bit for bit, K1, K2 and their backwards on the card."""
    (got,) = _ddp_spawn(1, "nccl", tmp_path)
    for part in ("metrics", "grads", "state"):
        assert set(got["group"][part]) == set(got["none"][part])
        for k, v in got["none"][part].items():
            assert torch.equal(got["group"][part][k], v), (part, k)


def test_ddp_two_gloo_ranks_on_the_card_match_one_process(dev, tmp_path):
    """Two ranks on the one card over gloo (CUDA tensors), a scene each,
    against one process stepping both: loss terms and grad_norm within
    1e-6 relative, every gradient within 1e-6 of its tensor's max, the
    running statistics within 1e-6 and the parameters within 1e-6 where
    the gradient is signal (``tests/test_torch_ddp.py``'s rule), the
    ranks' parameters bitwise equal."""
    ranks = _ddp_spawn(2, "gloo", tmp_path)
    one = _ddp_step(dev, [3, 4])
    for r in ranks:
        for k, v in one["metrics"].items():
            assert abs(float(r["metrics"][k]) - float(v)) <= 1e-6 * max(
                abs(float(v)), 1e-30), k
        for n, g in one["grads"].items():
            assert _rel(r["grads"][n], g) <= 1e-6, n
        for k, v in one["state"].items():
            err = (r["state"][k].double() - v.double()).abs()
            if k not in one["grads"]:
                assert float(err.max()) <= 1e-6 * max(
                    float(v.abs().max()), 1.0), k
                continue
            g = one["grads"][k].abs()
            strong = g >= 1e-3 * float(g.max())
            if bool(strong.any()):
                assert float(err[strong].max()) <= 1e-6, k
            assert float(err.max()) <= 2 * 2e-4 + 1e-6, k
    for k, v in ranks[0]["state"].items():
        assert torch.equal(v, ranks[1]["state"][k]), k
    assert float(one["metrics"]["loss_depth"]) > 0
