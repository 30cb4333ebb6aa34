"""The port's modules one by one against the JAX package, on one toy
NeRF-Det carried over with ``from_jax_variables``: backbone + FPN
(1e-4), the nerf density MLP, the 3D neck + head (1e-3, with the
transposed conv's kernel flip), the antialiased ``resize_valid``
(exact), candidate decoding (1e-3) and host NMS (identical picks)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
import torch.nn.functional as F
from flax import linen as fnn

from nerfdet_tpu.core.nms import aligned_3d_nms as jax_nms
from nerfdet_tpu.models.nerfdet import NerfDet as JaxNerfDet
from nerfdet_tpu.nn import heads as jheads
from nerfdet_tpu.nn import nerf_mlp as jmlp

from nerfdet_tpu_torch.core.nms import aligned_3d_nms
from nerfdet_tpu_torch.nn import heads as theads
from nerfdet_tpu_torch.nn import nerf_mlp as tmlp
from nerfdet_tpu_torch.utils.weight_convert import conv_transpose3d_weight

from tests.test_torch_nerfdet import FPN_OUT, N_CLS, N_VOX, build_toy


@pytest.fixture(scope="module")
def toy():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield build_toy()
    torch.set_num_threads(n)


def test_backbone_fpn(toy):
    jmodel, variables, model, scene = toy
    want = np.asarray(jax.jit(lambda v, x: jmodel.apply(
        v, x, method=JaxNerfDet.extract_2d))(variables, scene["imgs"]))
    with torch.inference_mode():
        got = model.extract_2d(torch.from_numpy(scene["imgs"])).numpy()
    assert got.shape == want.shape == (3, 8, 10, FPN_OUT)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_nerf_density(toy):
    jmodel, variables, model, _ = toy
    rng = np.random.RandomState(1)
    pts = rng.uniform(-3, 3, (50, 3)).astype(np.float32)
    feats = rng.rand(50, FPN_OUT // 4 + 6).astype(np.float32)
    want = np.asarray(jmodel.apply(
        variables, pts, feats,
        method=lambda m, p, f: m.nerf_mlp.query_density(p, f)))
    with torch.inference_mode():
        got = model.nerf_mlp.query_density(torch.from_numpy(pts),
                                           torch.from_numpy(feats)).numpy()
    assert got.shape == want.shape == (50, 1)
    # sin(x * 2^9) of the encoding differs by ~1e-5 between XLA and
    # torch, and four 256-wide layers amplify it: the head's 1e-3 bound
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


def test_sinusoidal_encode():
    x = np.random.RandomState(2).uniform(-4, 4, (7, 3)).astype(np.float32)
    want = np.asarray(jmlp.sinusoidal_encode(jnp.asarray(x), 0, 10))
    got = tmlp.sinusoidal_encode(torch.from_numpy(x), 0, 10).numpy()
    assert got.shape == (7, tmlp.encoded_dim(3, 0, 10)) == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_neck3d_head(toy):
    jmodel, variables, model, _ = toy
    vol = np.random.RandomState(3).rand(*N_VOX, FPN_OUT).astype(np.float32)
    want = jax.jit(lambda v, x: jmodel.apply(
        v, x, method=JaxNerfDet.detect))(variables, vol)
    with torch.inference_mode():
        got = model.detect(torch.from_numpy(vol))
    assert len(got) == len(want) == 3
    for s, (g, w) in enumerate(zip(got, want)):
        for a, b in zip(g, w):
            b = np.asarray(b)
            assert a.shape == b.shape, s
            assert np.abs(a.numpy() - b).max() <= 1e-3, s


def test_conv_transpose_kernel_flip():
    """flax ConvTranspose correlates with a mirrored kernel; the
    conversion flips it back, and without the flip the outputs differ."""
    rng = np.random.RandomState(4)
    x = rng.randn(1, 4, 3, 2, 5).astype(np.float32)
    conv = fnn.ConvTranspose(6, (2, 2, 2), strides=(2, 2, 2), use_bias=False)
    kernel = rng.randn(2, 2, 2, 5, 6).astype(np.float32)
    want = np.asarray(conv.apply({"params": {"kernel": kernel}}, x))
    xt = torch.from_numpy(x).permute(0, 4, 1, 2, 3)
    got = F.conv_transpose3d(xt, conv_transpose3d_weight(kernel), stride=2)
    got = got.permute(0, 2, 3, 4, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    unflipped = torch.from_numpy(np.transpose(kernel, (3, 4, 0, 1, 2)).copy())
    wrong = F.conv_transpose3d(xt, unflipped, stride=2).permute(
        0, 2, 3, 4, 1).numpy()
    assert np.abs(wrong - want).max() > 1e-2


@pytest.mark.parametrize("shape", [(20, 20, 8), (10, 10, 4), (4, 4, 2),
                                   (40, 40, 16)])
def test_resize_valid_antialias(shape):
    """Exact against jax.image.resize's antialiased trilinear, which
    F.interpolate(mode="trilinear") does not reproduce when shrinking."""
    rng = np.random.RandomState(5)
    src = (40, 40, 16) if shape[0] > 4 else (8, 8, 4)
    valid = rng.randint(0, 8, src).astype(np.float32)
    valid[rng.rand(*src) < 0.5] = 0
    want = np.asarray(jheads.resize_valid(jnp.asarray(valid), shape))
    got = theads.resize_valid(torch.from_numpy(valid), shape).numpy()
    np.testing.assert_array_equal(got, want)
    if src != shape and src == (40, 40, 16):
        plain = F.interpolate(torch.from_numpy(valid)[None, None], shape,
                              mode="trilinear")[0, 0]
        assert (((torch.round(plain) > 0).numpy()) != want).sum() > 0


def test_candidates(toy):
    jmodel, _, _, scene = toy
    rng = np.random.RandomState(6)
    head = []
    for i in range(3):
        dims = tuple(v // 2 ** i for v in N_VOX)
        head.append((rng.randn(*dims, 1).astype(np.float32),
                     rng.rand(*dims, 6).astype(np.float32),
                     rng.randn(*dims, N_CLS).astype(np.float32)))
    valid = rng.randint(0, 3, N_VOX).astype(np.float32)
    mlvl_j = jmodel.mlvl_points(jnp.asarray(scene["origin"]))
    mlvl_t = [torch.tensor(np.asarray(p)) for p in mlvl_j]
    for nms_pre in (40, 1000):
        bj, sj = jheads.get_candidate_bboxes(
            [tuple(jnp.asarray(t) for t in h) for h in head],
            jnp.asarray(valid), mlvl_j, nms_pre, N_CLS)
        bt, st = theads.get_candidate_bboxes(
            [tuple(torch.from_numpy(t) for t in h) for h in head],
            torch.from_numpy(valid), mlvl_t, nms_pre, N_CLS)
        assert bt.shape == bj.shape and st.shape == sj.shape
        assert np.abs(bt.numpy() - np.asarray(bj)).max() <= 1e-3
        assert np.abs(st.numpy() - np.asarray(sj)).max() <= 1e-3


def test_nms_picks():
    rng = np.random.RandomState(7)
    lo = rng.uniform(-3, 3, (300, 3)).astype(np.float32)
    boxes = np.concatenate(
        [lo, lo + rng.uniform(0.2, 1.5, (300, 3)).astype(np.float32)], 1)
    scores = rng.rand(300).astype(np.float32)
    classes = rng.randint(0, 4, 300)
    got = aligned_3d_nms(boxes, scores, classes, 0.25)
    assert 10 < len(got) < 300
    np.testing.assert_array_equal(got, jax_nms(boxes, scores, classes, 0.25))
