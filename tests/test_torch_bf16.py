"""bfloat16 compute (the JAX package's ``--bf16`` path): the plain
versions of the port's kernels and its layers against JAX, on the CPU.

JAX runs compiled with ``xla_allow_excess_precision`` off, so every op
rounds to bfloat16 where the program says so. With it on (XLA's
default), the CPU compiler drops the conversion pair float32 -> bfloat16
-> float32 of the feature taps inside K2's compiled training-form scan,
and the taps keep float32 precision there; the port rounds as the
program is written, as JAX also does op by op (``jax.disable_jit``).
What XLA's CPU backend computes, which the port reproduces: a bfloat16
conv or dot accumulates in float32 and rounds once; an elementwise op
rounds once; a bfloat16 scatter-add rounds its updates and then every
running sum, in update order (``ops/bf16.py``).

Bars, each with its cause where it is not bit for bit:

* the bfloat16 scatter-add, K1's d features, K2's d featmaps in both
  forms, the rgb stream's sums and the host ray stream: bit for bit;
* K1's and K2's float32 outputs (mean, exp(-var), globalfeat): their
  float32 epilogues sum in other orders, as in the float32 tests (1e-4,
  2e-5 absolute); dW and db 1e-4 x max (sums over pixels, another order);
* the layers: a conv's float32 accumulation order differs from XLA's,
  which moves an output across a bfloat16 rounding boundary now and
  then: within one bfloat16 ulp of the output's largest value, at under
  1% of the elements (a 3x3x3 volume conv, a ResNet bottleneck); the
  BatchNorm's float32 statistics likewise (one ulp, under 1%); Dense and
  the sinusoidal encoding bit for bit.

The whole slice (detection, rendering, the joint step) is held against
JAX in ``tests/test_torch_bf16_slice.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from nerfdet_tpu.nn.nerf_mlp import sinusoidal_encode as jax_encode
from nerfdet_tpu.nn.resnet import Bottleneck as JaxBottleneck
from nerfdet_tpu.ops import render as jrender
from nerfdet_tpu.ops import voxel as jvox
from nerfdet_tpu.ops.conv3d import Conv3x3x3 as JaxConv3x3x3

from nerfdet_tpu_torch.data import ray_stats
from nerfdet_tpu_torch.nn import compute
from nerfdet_tpu_torch.nn.neck3d import BatchNorm3d
from nerfdet_tpu_torch.nn.nerf_mlp import sinusoidal_encode
from nerfdet_tpu_torch.nn.resnet import Bottleneck
from nerfdet_tpu_torch.ops import render as trender
from nerfdet_tpu_torch.ops import voxel as tvox
from nerfdet_tpu_torch.ops.bf16 import scatter_add_bf16

from tests.test_torch_fusion import _shared_pixel_scene
from tests.test_torch_render import _jax_intrinsics
from tests.test_torch_train_nvs import (IMG, NEAR_FAR, N_SAMPLES, RATIO,
                                        _k2_case, _raw_scene, _stream_args)

BF16 = jnp.bfloat16


@pytest.fixture(autouse=True, scope="module")
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _compiled(fn, *args):
    """``fn(*args)`` compiled without excess precision (see above)."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args)


def _np(x):
    return np.array(jnp.asarray(x).astype(jnp.float32))


def _t(x):
    """A JAX array as a torch tensor of its dtype (bfloat16 kept)."""
    t = torch.from_numpy(_np(x))
    return t.bfloat16() if jnp.asarray(x).dtype == BF16 else t


def _ulp_share(got, want):
    """(max |got - want| in bfloat16 ulps of max |want|, share of the
    elements that differ)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    top = np.abs(want).max()
    ulp = 2.0 ** (np.floor(np.log2(top)) - 7)
    return np.abs(got - want).max() / ulp, float((got != want).mean())


# ---------------------------------------------------------------------
# rounding rules
# ---------------------------------------------------------------------

@pytest.mark.parametrize("compiled", [False, True])
def test_scatter_add_bf16_is_xlas_bfloat16_scatter(compiled):
    rng = np.random.RandomState(0)
    idx = rng.randint(0, 9, 3000)
    val = rng.normal(size=(3000, 5)).astype(np.float32)

    def scatter(i, u):
        return jnp.zeros((9, 5), BF16).at[i].add(u.astype(BF16))

    args = (jnp.asarray(idx), jnp.asarray(val))
    want = _compiled(scatter, *args) if compiled else scatter(*args)
    got = scatter_add_bf16(9, torch.from_numpy(idx), torch.from_numpy(val))
    np.testing.assert_array_equal(got.numpy(), _np(want))
    # and not a float32 sum rounded once
    once = torch.zeros(9, 5).index_add_(0, torch.from_numpy(idx),
                                        torch.from_numpy(val).bfloat16()
                                        .float()).bfloat16().float()
    assert not torch.equal(got, once)


# ---------------------------------------------------------------------
# K1: the fusion carry under grad, its VJP, the rgb stream
# ---------------------------------------------------------------------

@pytest.mark.parametrize("with_g2", [False, True])
def test_k1_bf16_gradient_matches_jax(with_g2):
    """d features (bfloat16) bit for bit against ``jax.grad`` of the JAX
    scan on bfloat16 maps; dW, db and the outputs as stated above."""
    feats, points, proj, w_map, b_map, rgb, _ = _shared_pixel_scene(4)
    image_hw = (7, 10)
    rng = np.random.RandomState(5)
    n, c, m = points.shape[0], feats.shape[-1], w_map.shape[1]
    cots = [rng.randn(n, c), rng.randn(n, c) if with_g2 else
            np.zeros((n, c)), rng.randn(n, 3 + m), rng.randn(n, 3 + m)]
    cots = [a.astype(np.float32) for a in cots]
    fb = jnp.asarray(feats).astype(BF16)

    def jout(f, w, b):
        return jvox.fused_mean_cov(
            f, jnp.asarray(points), jnp.asarray(proj), image_hw=image_hw,
            mapped_kernel=w, mapped_bias=b,
            precomputed_extra=tuple(jnp.asarray(r) for r in rgb))

    def jloss(f, w, b):
        out = jout(f, w, b)
        used = out[:2] + out[3:] if with_g2 else out[:1] + out[3:]
        ct = cots if with_g2 else cots[:1] + cots[2:]
        return sum(jnp.sum(o * jnp.asarray(t)) for o, t in zip(used, ct))

    args = (fb, jnp.asarray(w_map), jnp.asarray(b_map))
    want = _compiled(jax.grad(jloss, argnums=(0, 1, 2)), *args)
    outs = _compiled(jout, *args)

    f = _t(fb).requires_grad_()
    w = torch.tensor(w_map, requires_grad=True)
    b = torch.tensor(b_map, requires_grad=True)
    out = tvox.fused_mean_cov(
        f, torch.from_numpy(points), torch.from_numpy(proj),
        image_hw=image_hw, mapped_kernel=w, mapped_bias=b,
        precomputed_extra=tuple(torch.from_numpy(r) for r in rgb))
    used = out[:2] + out[3:] if with_g2 else out[:1] + out[3:]
    ct = cots if with_g2 else cots[:1] + cots[2:]
    sum((o * torch.from_numpy(t)).sum() for o, t in zip(used, ct)).backward()
    assert f.grad.dtype == torch.bfloat16
    np.testing.assert_array_equal(f.grad.float().numpy(), _np(want[0]))
    for got, ref in ((w.grad, want[1]), (b.grad, want[2])):
        ref = np.asarray(ref)
        assert np.abs(got.numpy() - ref).max() <= 1e-4 * np.abs(ref).max()
    for got, ref in zip(out, outs):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                                   rtol=0, atol=1e-4)


def test_rgb_stream_bf16_sums_match_jax():
    """The density volume's rgb stream on bfloat16 images: the plain
    version's sums (``rgb_carry`` on the CPU) against the JAX scan's,
    through g_mean of the rgb channels (s1e over the count, so the sums
    bit for bit) and g_cov (exp(-var): the variance cancels, so its
    float32 epilogue in another order is held to 1e-4 absolute, as in
    ``tests/test_torch_fusion.py``)."""
    feats, points, proj, w_map, b_map, _, _ = _shared_pixel_scene(2)
    rng = np.random.RandomState(3)
    images = (rng.rand(feats.shape[0], 31, 40, 3) * 255).astype(np.float32)
    ib = jnp.asarray(images).astype(BF16)
    rgb_proj = proj.copy()  # the maps' projection at the images' scale
    rgb_proj[:, :2] *= 4.0

    def jout(f, im):
        return jvox.fused_mean_cov(
            f, jnp.asarray(points), jnp.asarray(proj), image_hw=(7, 10),
            extra_features=im, extra_projection=jnp.asarray(rgb_proj),
            extra_image_hw=(31, 40), mapped_kernel=jnp.asarray(w_map),
            mapped_bias=jnp.asarray(b_map))

    want = _compiled(jout, jnp.asarray(feats).astype(BF16), ib)
    with torch.no_grad():
        got = tvox.fused_mean_cov(
            _t(jnp.asarray(feats).astype(BF16)), torch.from_numpy(points),
            torch.from_numpy(proj), image_hw=(7, 10),
            extra_features=_t(ib), extra_projection=torch.from_numpy(rgb_proj),
            extra_image_hw=(31, 40), mapped_kernel=torch.from_numpy(w_map),
            mapped_bias=torch.from_numpy(b_map))
    # g_mean, g_cov: the rgb channels come first
    np.testing.assert_array_equal(got[3][:, :3].numpy(),
                                  np.asarray(want[3])[:, :3])
    np.testing.assert_allclose(got[4][:, :3].numpy(),
                               np.asarray(want[4])[:, :3], rtol=0, atol=1e-4)
    assert float(got[2].max()) >= 2 and float(got[3][:, :3].max()) > 0


# ---------------------------------------------------------------------
# K2: both forms, forward and VJP
# ---------------------------------------------------------------------

def _k2_jax_and_port(case, form):
    pts, scene, feats, host = _k2_case(case)
    images = scene["denorm_images"]
    g = np.random.RandomState(6).randn(
        *pts.shape[:2], 2 * (3 + feats.shape[-1])).astype(np.float32)
    pre_j = (tuple(jnp.asarray(h) for h in host) if form == "training"
             else None)
    ib, fb = (jnp.asarray(x).astype(BF16) for x in (images, feats))

    def jax_loss(f):
        gf, mask = jrender.streaming_sample_mean_var(
            jnp.asarray(pts), ib, _jax_intrinsics(scene["intrinsic"], 3),
            jnp.asarray(scene["extrinsics"]), IMG, featmaps=f,
            precomputed_rgb=pre_j)
        return jnp.sum(gf * g), (gf, mask)

    (_, (gf_j, mask_j)), grad_j = _compiled(
        jax.value_and_grad(jax_loss, has_aux=True), fb)
    proj = trender.view_projection(scene["intrinsic"], scene["extrinsics"],
                                   RATIO)
    pre_t = (tuple(torch.from_numpy(h) for h in host)
             if form == "training" else None)
    f = _t(fb).requires_grad_()
    gf_t, mask_t = trender.streaming_sample_mean_var(
        torch.from_numpy(pts), _t(ib), proj, IMG, f, pre_t)
    (gf_t * torch.from_numpy(g)).sum().backward()
    return (gf_t.detach(), mask_t, f.grad), (gf_j, mask_j, grad_j)


@pytest.mark.parametrize("form", ["training", "eval"])
@pytest.mark.parametrize("case", ["rays", "edges"])
def test_k2_bf16_matches_jax(case, form):
    """K2's plain version on bfloat16 maps (and images) against the JAX
    function: the mask exact, globalfeat 2e-5 (its float32 epilogue),
    d featmaps (bfloat16) bit for bit. Taps that round differently would
    move globalfeat by ~1e-2 here (bfloat16 against float32: 7e-3 to
    0.1)."""
    (gf, mask, grad), (gf_j, mask_j, grad_j) = _k2_jax_and_port(case, form)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(mask_j))
    np.testing.assert_allclose(gf.numpy(), np.asarray(gf_j), rtol=0,
                               atol=2e-5)
    assert grad.dtype == torch.bfloat16
    np.testing.assert_array_equal(grad.float().numpy(), _np(grad_j))
    assert float(grad.float().abs().max()) > 0


def test_k2_bf16_taps_round_as_written():
    """The feature taps' bfloat16 rounding is what the comparison above
    sees: a plain version that keeps the taps in float32 misses JAX's
    globalfeat by far more than 2e-5."""
    pts, scene, feats, host = _k2_case("rays")
    proj = trender.view_projection(scene["intrinsic"], scene["extrinsics"],
                                   RATIO)
    fb = torch.from_numpy(feats).bfloat16()
    args = (torch.from_numpy(pts), None, proj, IMG)
    pre = tuple(torch.from_numpy(h) for h in host)
    rounded = trender.streaming_sample_mean_var_plain(*args, fb, pre)[0]
    wide = trender.streaming_sample_mean_var_plain(*args, fb.float(), pre)[0]
    assert float((rounded - wide).abs().max()) > 1e-3


# ---------------------------------------------------------------------
# the host ray stream
# ---------------------------------------------------------------------

def test_host_ray_rgb_stats_bf16_is_jaxs_bit_for_bit():
    scene = _raw_scene(1, n_rand=64)
    z = jrender.host_sample_z(np.random.RandomState(2), 64, *NEAR_FAR,
                              N_SAMPLES)
    got = ray_stats.host_ray_rgb_stats(*_stream_args(scene, z),
                                       compute_dtype="bfloat16")
    want = jrender.host_ray_rgb_stats(*_stream_args(scene, z),
                                      compute_dtype=BF16)
    f32 = ray_stats.host_ray_rgb_stats(*_stream_args(scene, z))
    for a, b, c in zip(got, want, f32):
        assert a.dtype == np.float32 and a.shape == b.shape
        np.testing.assert_array_equal(a, np.asarray(b, np.float32))
    assert not np.array_equal(got[0], f32[0])  # the rounding shows
    # torch.bfloat16 names it as well
    again = ray_stats.host_ray_rgb_stats(*_stream_args(scene, z),
                                         compute_dtype=torch.bfloat16)
    np.testing.assert_array_equal(again[1], got[1])


# ---------------------------------------------------------------------
# the layers at compute_dtype bfloat16
# ---------------------------------------------------------------------

@pytest.mark.parametrize("cin,cout,stride", [
    (16, 16, 1),  # the z-tap decomposition: three convs, each rounded
    (16, 32, 2),  # z taps at stride 2
    (128, 6, 1),  # a shape JAX convolves in one piece
])
def test_conv3x3x3_bf16_matches_jax(cin, cout, stride):
    rng = np.random.RandomState(cin + cout)
    x = rng.randn(1, 6, 5, 4, cin).astype(np.float32)
    mod = JaxConv3x3x3(cout, strides=(stride,) * 3, use_bias=True,
                       dtype=BF16)
    params = mod.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    params = {"kernel": params["kernel"],
              "bias": jnp.asarray(rng.randn(cout).astype(np.float32))}
    want = _compiled(lambda p, a: mod.apply({"params": p}, a), params,
                     jnp.asarray(x))
    conv = torch.nn.Conv3d(cin, cout, 3, stride, 1)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(_np(params["kernel"])).permute(
            4, 3, 0, 1, 2))
        conv.bias.copy_(torch.from_numpy(_np(params["bias"])))
        got = compute.conv3x3x3(conv, torch.from_numpy(x).permute(
            0, 4, 1, 2, 3), torch.bfloat16)
    assert got.dtype == torch.bfloat16
    ulps, share = _ulp_share(got.float().permute(0, 2, 3, 4, 1).numpy(),
                             _np(want))
    assert ulps <= 1 and share < 0.01, (ulps, share)


def test_bottleneck_bf16_matches_jax():
    """A strided ResNet bottleneck with its downsample: five convs, four
    frozen affines (``x * scale + bias``, two roundings each)."""
    rng = np.random.RandomState(0)
    x = rng.randn(2, 12, 16, 64).astype(np.float32)
    mod = JaxBottleneck(mid=32, stride=2, dtype=BF16)
    params = mod.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"]
    params = jax.tree_util.tree_map(
        lambda a: a + 0.1 * jnp.asarray(rng.randn(*a.shape), a.dtype),
        params)
    want = _compiled(lambda p, a: mod.apply({"params": p}, a), params,
                     jnp.asarray(x))
    block = Bottleneck(64, 32, 2, dtype=torch.bfloat16)
    with torch.no_grad():
        for name, conv in (("conv1", block.conv1), ("conv2", block.conv2),
                           ("conv3", block.conv3),
                           ("downsample_conv", block.downsample[0])):
            conv.weight.copy_(torch.from_numpy(_np(
                params[name]["kernel"])).permute(3, 2, 0, 1))
        for name, bn in (("bn1", block.bn1), ("bn2", block.bn2),
                         ("bn3", block.bn3),
                         ("downsample_bn", block.downsample[1])):
            bn.scale.copy_(torch.from_numpy(_np(params[name]["scale"])))
            bn.bias.copy_(torch.from_numpy(_np(params[name]["bias"])))
        got = block(torch.from_numpy(x).permute(0, 3, 1, 2).bfloat16())
    assert got.dtype == torch.bfloat16
    ulps, share = _ulp_share(got.float().permute(0, 2, 3, 1).numpy(),
                             _np(want))
    assert ulps <= 1 and share < 0.01, (ulps, share)


@pytest.mark.parametrize("train", [False, True])
def test_batchnorm_bf16_matches_flax(train):
    """flax ``BatchNorm(dtype=bfloat16)``: float32 statistics, one rounding
    of the output; the running statistics in float32."""
    rng = np.random.RandomState(1)
    x = (rng.randn(1, 4, 5, 3, 8) * 3 + 1).astype(np.float32)
    xb = jnp.asarray(x).astype(BF16)
    mod = fnn.BatchNorm(use_running_average=not train, momentum=0.9,
                        epsilon=1e-5, dtype=BF16)
    variables = mod.init(jax.random.PRNGKey(0), xb)
    scale = rng.uniform(0.5, 1.5, 8).astype(np.float32)
    bias = rng.randn(8).astype(np.float32)
    mean, var = rng.randn(8).astype(np.float32), rng.uniform(
        0.5, 2, 8).astype(np.float32)
    variables = {"params": {"scale": jnp.asarray(scale),
                            "bias": jnp.asarray(bias)},
                 "batch_stats": {"mean": jnp.asarray(mean),
                                 "var": jnp.asarray(var)}}
    want, upd = _compiled(lambda v, a: mod.apply(
        v, a, mutable=["batch_stats"]), variables, xb)
    bn = BatchNorm3d(8).train(train)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
        bn.running_mean.copy_(torch.from_numpy(mean))
        bn.running_var.copy_(torch.from_numpy(var))
        got = bn(_t(xb).permute(0, 4, 1, 2, 3))
    assert got.dtype == torch.bfloat16
    ulps, share = _ulp_share(got.float().permute(0, 2, 3, 4, 1).numpy(),
                             _np(want))
    assert ulps <= 1 and share < 0.01, (ulps, share)
    for key, run in (("mean", bn.running_mean), ("var", bn.running_var)):
        np.testing.assert_allclose(run.numpy(),
                                   np.asarray(upd["batch_stats"][key]),
                                   rtol=1e-6, atol=1e-6)


def test_dense_and_encoding_bf16_match_jax():
    """flax ``Dense(dtype=bfloat16)`` (the product rounded, then the bias
    added and rounded) and the sinusoidal encoding (pi / 2 rounded to
    bfloat16 first, as JAX's weak scalar): bit for bit."""
    rng = np.random.RandomState(2)
    x = rng.randn(64, 63).astype(np.float32)
    mod = fnn.Dense(32, dtype=BF16)
    params = {"kernel": jnp.asarray(rng.randn(63, 32).astype(np.float32)),
              "bias": jnp.asarray(rng.randn(32).astype(np.float32))}
    want = _compiled(lambda p, a: mod.apply({"params": p}, a), params,
                     jnp.asarray(x))
    lin = torch.nn.Linear(63, 32)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(_np(params["kernel"])).t())
        lin.bias.copy_(torch.from_numpy(_np(params["bias"])))
        got = compute.linear(lin, torch.from_numpy(x), torch.bfloat16)
    np.testing.assert_array_equal(got.float().numpy(), _np(want))

    pts = jnp.asarray(rng.uniform(-4, 4, (256, 3)).astype(np.float32))
    enc_j = _compiled(lambda p: jax_encode(p.astype(BF16), 0, 10), pts)
    enc_t = sinusoidal_encode(_t(pts).bfloat16(), 0, 10)
    np.testing.assert_array_equal(enc_t.float().numpy(), _np(enc_j))


# ---------------------------------------------------------------------
# what stays refused
# ---------------------------------------------------------------------

def test_a_third_dtype_is_refused():
    """float32 and bfloat16 only: float16 maps, images and streams raise
    before any kernel or plain version runs."""
    _, _, _, _, _, _, pix = _shared_pixel_scene(8)
    half = torch.zeros((3, 7, 10, 32), dtype=torch.float16)
    with pytest.raises(TypeError, match="bfloat16"):
        tvox.fusion_carry(half, pix)
    with pytest.raises(TypeError, match="bfloat16"):
        tvox.rgb_carry(torch.zeros((3, 7, 10, 3), dtype=torch.float16), pix)
    pts, scene, feats, host = _k2_case("rays")
    proj = trender.view_projection(scene["intrinsic"], scene["extrinsics"],
                                   RATIO)
    with pytest.raises(TypeError, match="bfloat16"):
        trender.streaming_sample_mean_var(
            torch.from_numpy(pts), None, proj, IMG,
            torch.from_numpy(feats).half(),
            tuple(torch.from_numpy(h) for h in host))
    z = np.ones((8, 2), np.float32)
    with pytest.raises(TypeError, match="bfloat16"):
        ray_stats.host_ray_rgb_stats(*_stream_args(_raw_scene(1), z),
                                     compute_dtype="float16")
