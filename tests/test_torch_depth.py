"""The depth_sp path of the port (NeRF-Det-R50* / R101*) against the JAX
package, on the CPU, in float32.

* ``resize_depth`` / ``depth_gate`` against ``jax.image.resize`` and
  ``nerfdet_tpu.ops.voxel.depth_gate``, at a shrinking non-integer ratio
  and at the identity: the gate's mask exact, the resized depth within
  1e-6 (the two frameworks sum the triangle taps in other orders);
* the in-scan rgb stream: ``rgb_carry_plain`` (and the wrapper, which
  takes it for a CPU tensor) against the JAX scan body's s1e / s2e,
  computed with the JAX package's own projection, gate and gather,
  within 1e-6;
* ``fused_mean_cov`` of the global volume (the mapped stream and the
  in-scan rgb stream), with and without the depth gate, against the JAX
  function: counts exact, statistics within 1e-5;
* the gated fusion's gradients in the features and the mapped stream's
  kernel and bias against ``jax.grad``, within 1e-3 x the max |gradient|;
* a toy NeRF-Det-R101 (32x40 images, three views with depth maps, an
  8x8x4 volume) through ``from_jax_variables``: view counts exact, head
  outputs within 1e-3, as ``tests/test_torch_nerfdet.py`` holds R50;
* a toy depth_sp train step (R50, one scene with depth maps and 24 rays
  with their depths, ``depth_supervise=True``) against the loss terms
  and gradients of JAX's step on a batch of one (``scene_loss_terms``,
  ``reduce_loss_terms``), compiled, at seeds that keep the 3D neck's
  ReLU inputs 3e-6 from 0 (``tests/test_torch_train.py`` runs JAX op by
  op for seeds that do not): loss terms (``loss_depth`` included) and
  grad_norm 1e-4 relative, every gradient within 1e-3 x its max.

The intrinsic is scaled to ``ori_shape``, so the sensed depth and the
voxels' camera depths agree and the gate keeps some pairs and drops
others.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nerfdet_tpu.data.synthetic import make_synthetic_scene
from nerfdet_tpu.models.nerfdet import NerfDet as JaxNerfDet
from nerfdet_tpu.models.nerfdet import SceneMeta as JaxSceneMeta
from nerfdet_tpu.ops import voxel as jvox
from nerfdet_tpu.train.step import reduce_loss_terms as jax_reduce
from nerfdet_tpu.train.step import scene_loss_terms as jax_scene_terms

from nerfdet_tpu_torch import api
from nerfdet_tpu_torch.data import ray_stats
from nerfdet_tpu_torch.models.nerfdet import NerfDet, SceneMeta
from nerfdet_tpu_torch.ops import voxel as tvox
from nerfdet_tpu_torch.train import optim as toptim
from nerfdet_tpu_torch.train.step import make_train_step
from nerfdet_tpu_torch.utils.weight_convert import from_jax_variables

from tests.test_torch_nerfdet import _perturb
from tests.test_torch_session_cache import computed_once
from tests.test_torch_train import OPTIMIZER, _port_tree, _ReluMargin, _rel

ORI, IMG, PAD = (128, 160), (31, 40), (32, 40)
RATIO = ORI[0] / IMG[0]
STRIDE = 4
FEAT_HW = (IMG[0] // STRIDE, IMG[1] // STRIDE)
N_VOX, VOX = (8, 8, 4), (0.8, 0.8, 0.8)
FPN_OUT, NECK3D_OUT, N_CLS, N_SCALES = 64, 16, 5, 3
N_RAND, N_SAMPLES, NEAR_FAR = 24, 16, (0.2, 8.0)


@pytest.fixture(autouse=True, scope="module")
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _scene(seed, n_rand=8):
    """A synthetic scene with depth maps, its intrinsic at ``ori_shape``."""
    s = make_synthetic_scene(seed=seed, n_views=3, n_targets=1, hw=IMG,
                             pad_hw=PAD, n_rand=n_rand, n_boxes=2,
                             max_gt=4, margin=2, with_depth=True)
    s["intrinsic"] = s["intrinsic"].copy()
    s["intrinsic"][:2] *= np.float32(RATIO)
    return s


def _fusion_inputs(seed=0, c=64, m=8):
    """The fusion's inputs at the toy model's geometry: random maps at
    the stride-4 extent, the scene's images and depth, both projections,
    and a random mapped stream."""
    s = _scene(seed)
    rng = np.random.RandomState(seed + 100)
    v = s["imgs"].shape[0]
    feats = rng.randn(v, PAD[0] // STRIDE, PAD[1] // STRIDE, c).astype(
        np.float32)
    points = tvox.get_points(N_VOX, VOX, s["origin"]).reshape(-1, 3)
    proj = tvox.compute_projection(s["intrinsic"], s["extrinsics"],
                                   ORI[0] / (IMG[0] / STRIDE))
    proj_e = tvox.compute_projection(s["intrinsic"], s["extrinsics"], RATIO)
    w_map = (rng.randn(c, m) / np.sqrt(c)).astype(np.float32)
    b_map = rng.randn(m).astype(np.float32)
    return dict(feats=feats, points=points.numpy(), proj=proj.numpy(),
                proj_e=proj_e.numpy(), images=s["denorm_images"],
                depth=s["depth"], w=w_map, b=b_map)


# ---------------------------------------------------------------------
# the depth gate
# ---------------------------------------------------------------------

@pytest.mark.parametrize("hw", [(7, 10), (29, 40)], ids=["shrink", "same"])
def test_depth_gate_matches_jax(hw):
    h, w = hw
    rng = np.random.RandomState(1)
    v, n = 3, 2000
    depth = (rng.rand(v, 29, 40) * 4 + 0.5).astype(np.float32)
    want_d = np.asarray(jax.image.resize(jnp.asarray(depth), (v, h, w),
                                         "bilinear"))
    got_d = tvox.resize_depth(torch.from_numpy(depth), h, w).numpy()
    assert got_d.shape == want_d.shape
    np.testing.assert_allclose(got_d, want_d, rtol=0, atol=1e-6)
    if hw == (29, 40):
        np.testing.assert_array_equal(got_d, depth)

    x = rng.randint(-2, w + 2, (v, n)).astype(np.int32)
    y = rng.randint(-2, h + 2, (v, n)).astype(np.int32)
    z = rng.uniform(0.3, 5.0, (v, n)).astype(np.float32)
    valid = (rng.rand(v, n) < 0.8) & (x >= 0) & (y >= 0) & (x < w) & (y < h)
    want = np.asarray(jvox.depth_gate(
        jnp.asarray(z), jnp.asarray(x), jnp.asarray(y), jnp.asarray(valid),
        jnp.asarray(depth), h, w, 0.2))
    got = tvox.depth_gate(torch.from_numpy(z), torch.from_numpy(x),
                          torch.from_numpy(y), torch.from_numpy(valid),
                          torch.from_numpy(depth), h, w, 0.2).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < want.sum() < valid.sum()  # the gate keeps some, drops some


# ---------------------------------------------------------------------
# the in-scan rgb stream
# ---------------------------------------------------------------------

def _jax_rgb_scan(d):
    """s1e / s2e of the JAX scan body's rgb branch (nerfdet_tpu/ops/
    voxel.py, ``fused_mean_cov``), with its projection, gate and
    gather."""
    h, w = IMG
    xe, ye, ze, ve = jvox.project_points(jnp.asarray(d["points"]),
                                         jnp.asarray(d["proj_e"]), h, w)
    ve = jvox.depth_gate(ze, xe, ye, ve, jnp.asarray(d["depth"]), h, w,
                         VOX[2])

    def body(carry, view):
        e = jvox._gather_view(*view).astype(jnp.float32)
        return (carry[0] + e, carry[1] + e * e), None

    n = d["points"].shape[0]
    zero = jnp.zeros((n, 3), jnp.float32)
    (s1, s2), _ = jax.lax.scan(body, (zero, zero),
                               (jnp.asarray(d["images"]), xe, ye, ve))
    return np.asarray(s1), np.asarray(s2), np.asarray(ve)


def _port_rgb_pix(d):
    h, w = IMG
    xe, ye, ze, ve = tvox.project_points(torch.from_numpy(d["points"]),
                                         torch.from_numpy(d["proj_e"]), h, w)
    ve = tvox.depth_gate(ze, xe, ye, ve, torch.from_numpy(d["depth"]), h,
                         w, VOX[2])
    return tvox.pixel_index(xe, ye, ve, PAD[1]), ve


def test_rgb_carry_plain_matches_the_jax_scan():
    d = _fusion_inputs()
    s1_j, s2_j, valid_j = _jax_rgb_scan(d)
    pix, valid = _port_rgb_pix(d)
    np.testing.assert_array_equal(valid.numpy(), valid_j)
    # the gate drops pairs the image bounds keep
    h, w = IMG
    _, _, _, seen = jvox.project_points(jnp.asarray(d["points"]),
                                        jnp.asarray(d["proj_e"]), h, w)
    assert 0 < valid_j.sum() < np.asarray(seen).sum()
    images = torch.from_numpy(d["images"])
    s1, s2 = tvox.rgb_carry_plain(images, pix)
    np.testing.assert_allclose(s1.numpy(), s1_j, rtol=0, atol=1e-6)
    np.testing.assert_allclose(s2.numpy(), s2_j, rtol=0, atol=1e-6)
    before = tvox.rgb_carry.launches
    again = tvox.rgb_carry(images, pix)
    assert tvox.rgb_carry.launches == before  # the CPU takes the plain one
    assert torch.equal(again[0], s1) and torch.equal(again[1], s2)


def test_rgb_carry_refuses_images_that_require_grad():
    d = _fusion_inputs()
    pix, _ = _port_rgb_pix(d)
    images = torch.from_numpy(d["images"]).requires_grad_()
    with pytest.raises(ValueError, match="no gradient"):
        tvox.rgb_carry(images, pix)


# ---------------------------------------------------------------------
# the gated fusion
# ---------------------------------------------------------------------

def _fused(d, mod, xp):
    """``mod.fused_mean_cov`` of the global volume (the mapped and the
    in-scan rgb streams), gated by ``d["depth"]`` unless it is None;
    ``xp`` makes the arrays (jnp.asarray or torch.from_numpy)."""
    depth = None if d["depth"] is None else xp(d["depth"])
    return mod.fused_mean_cov(
        xp(d["feats"]), xp(d["points"]), xp(d["proj"]), depth=depth,
        voxel_size_z=VOX[2], image_hw=FEAT_HW,
        extra_features=xp(d["images"]), extra_projection=xp(d["proj_e"]),
        extra_image_hw=IMG, mapped_kernel=xp(d["w"]),
        mapped_bias=xp(d["b"]))


@pytest.mark.parametrize("gated", [True, False], ids=["depth", "no_depth"])
def test_gated_fused_mean_cov_matches_jax(gated):
    """The global volume with the in-scan rgb stream, with and without
    the depth gate."""
    d = _fusion_inputs()
    if not gated:
        d["depth"] = None
    want = _fused(d, jvox, jnp.asarray)
    got = _fused(d, tvox, torch.from_numpy)
    assert len(got) == len(want) == 5
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    count = np.asarray(want[2])
    assert count.max() >= 2 and (count == 0).any()
    for k in (0, 1, 3, 4):
        a, b = got[k].numpy(), np.asarray(want[k])
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)


def test_gated_fusion_gradients_match_jax():
    d = _fusion_inputs()
    rng = np.random.RandomState(7)
    n, c, m = d["points"].shape[0], d["feats"].shape[-1], d["w"].shape[1]
    g = [rng.randn(n, k).astype(np.float32) for k in (c, c, 3 + m, 3 + m)]

    def jax_loss(f, w, b):
        out = _fused(dict(d, feats=f, w=w, b=b), jvox, jnp.asarray)
        return sum(jnp.sum(o * gi) for o, gi in zip(
            (out[0], out[1], out[3], out[4]), g))

    want = jax.grad(jax_loss, argnums=(0, 1, 2))(
        jnp.asarray(d["feats"]), jnp.asarray(d["w"]), jnp.asarray(d["b"]))
    leaves = [torch.from_numpy(d[k]).requires_grad_()
              for k in ("feats", "w", "b")]
    f, w, b = leaves
    out = tvox.fused_mean_cov(
        f, torch.from_numpy(d["points"]), torch.from_numpy(d["proj"]),
        depth=torch.from_numpy(d["depth"]), voxel_size_z=VOX[2],
        image_hw=FEAT_HW, extra_features=torch.from_numpy(d["images"]),
        extra_projection=torch.from_numpy(d["proj_e"]), extra_image_hw=IMG,
        mapped_kernel=w, mapped_bias=b)
    sum((o * torch.from_numpy(gi)).sum() for o, gi in zip(
        (out[0], out[1], out[3], out[4]), g)).backward()
    for name, t, wj in zip(("features", "W", "b"), leaves, want):
        wj = np.asarray(wj)
        scale = np.abs(wj).max()
        assert scale > 0, name
        err = np.abs(t.grad.numpy() - wj).max()
        assert err <= 1e-3 * scale, (name, err, scale)


# ---------------------------------------------------------------------
# the R101 forward
# ---------------------------------------------------------------------

def _jax_model(depth):
    return JaxNerfDet(
        backbone_depth=depth, fpn_out_channels=FPN_OUT,
        neck3d_out_channels=NECK3D_OUT, neck3d_n_blocks=(1, 1, 1),
        n_classes=N_CLS, n_scales=N_SCALES, n_voxels=N_VOX,
        voxel_size=VOX, n_samples=N_SAMPLES, n_rand=N_RAND,
        near_far_range=NEAR_FAR, nerf_density=True,
        meta=JaxSceneMeta(ori_shape=ORI, img_shape=IMG, pad_shape=PAD))


def _port_model(depth):
    return NerfDet(
        backbone_depth=depth, fpn_out_channels=FPN_OUT,
        neck3d_out_channels=NECK3D_OUT, neck3d_n_blocks=(1, 1, 1),
        n_classes=N_CLS, n_scales=N_SCALES, n_voxels=N_VOX, voxel_size=VOX,
        n_samples=N_SAMPLES, n_rand=N_RAND, near_far_range=NEAR_FAR,
        nerf_density=True,
        meta=SceneMeta(ori_shape=ORI, img_shape=IMG, pad_shape=PAD))


def _variables(jmodel, scene, seed=0):
    """Initialized (with the render head: the scene has rays) and
    perturbed JAX variables."""
    init = {k: jnp.asarray(scene[k]) for k in (
        "imgs", "denorm_images", "intrinsic", "extrinsics", "origin",
        "depth", "ray_o", "ray_d")}
    variables = jax.jit(lambda k: jmodel.init(k, init, train=False))(
        jax.random.PRNGKey(0))
    rng = np.random.RandomState(seed)
    return {"params": _perturb(dict(variables["params"]), rng),
            "batch_stats": _perturb(dict(variables["batch_stats"]), rng)}


def test_r101_forward_with_depth_matches_jax():
    scene = _scene(3)
    jmodel = _jax_model(101)
    variables = _variables(jmodel, scene)
    assert len([k for k in variables["params"]["backbone"]
                if k.startswith("layer3_")]) == 23
    keys = ("imgs", "denorm_images", "intrinsic", "extrinsics", "origin",
            "depth")
    head_j, valid_j, _ = jax.jit(lambda v, b: jmodel.apply(
        v, b, train=False, with_rays=True))(
        variables, {k: jnp.asarray(scene[k]) for k in keys})

    model = _port_model(101)
    model.load_state_dict(from_jax_variables(variables), strict=True)
    model.eval()
    batch = api.device_batch(model, scene)
    assert "depth" in batch and "rgb_s1" not in batch
    before = tvox.rgb_carry.launches
    with torch.inference_mode():
        head_t, valid_t, _ = model(batch)
    assert tvox.rgb_carry.launches == before  # the CPU: the plain stream
    np.testing.assert_array_equal(valid_t.numpy(), np.asarray(valid_j))
    valid = np.asarray(valid_j)
    assert valid.max() >= 2 and (valid == 0).any()
    for s in range(N_SCALES):
        for a, b in zip(head_t[s], head_j[s]):
            b = np.asarray(b)
            assert a.shape == b.shape
            assert np.abs(a.numpy() - b).max() <= 1e-3


# ---------------------------------------------------------------------
# the depth_sp train step
# ---------------------------------------------------------------------

# a scene whose rendered samples keep their density alive, so the NVS and
# depth losses reach ``mapping`` (most toy seeds leave sigma dead there)
STEP_SEED, STEP_RAYS, STEP_PERTURB = 18, 19, 0
STEP_KEYS = ("imgs", "denorm_images", "intrinsic", "extrinsics", "origin",
             "depth", "gt_boxes", "gt_labels", "gt_mask", "ray_o", "ray_d",
             "gt_rgb", "gt_depth") + ray_stats.RAY_STREAM_KEYS


@pytest.fixture(scope="module")
def step(tmp_path_factory):
    """JAX's loss terms and gradients of one depth_sp scene (its
    ``scene_loss_terms`` and ``reduce_loss_terms``, as its train step
    runs them on a batch of one, compiled: the seeds keep every 3D-neck
    ReLU input 3e-6 from 0, which ``tests/test_torch_train.py`` needs
    op-by-op JAX for) and the port's train step on the same scene,
    without gradient clipping."""
    scene = ray_stats.prepare_rays(
        _scene(STEP_SEED, n_rand=N_RAND), np.random.RandomState(STEP_RAYS),
        N_RAND, NEAR_FAR, N_SAMPLES, ORI, IMG)
    ref = computed_once(tmp_path_factory, "torch_depth_jax_step",
                        lambda: _jax_step(scene))

    model = _port_model(50)
    start = from_jax_variables(ref["variables"])
    model.load_state_dict(start, strict=True)
    port_step = make_train_step(
        model, toptim.build_optimizer(model, OPTIMIZER), depth_supervise=True)
    tbatch = api.train_batch(model, [scene])
    port_metrics = port_step(tbatch)
    port_grads = {n: (torch.zeros_like(p) if p.grad is None
                      else p.grad.clone())
                  for n, p in model.named_parameters()}
    return dict(batch=tbatch[0], start=start,
                jax=(ref["metrics"], ref["grads"]),
                port=(port_metrics, port_grads))


def _jax_step(scene):
    """The weights and JAX's loss terms and gradients of ``scene`` (once
    per test run: ``computed_once``)."""
    jmodel = _jax_model(50)
    variables = _variables(jmodel, scene, STEP_PERTURB)
    scene_j = {k: jnp.asarray(scene[k]) for k in STEP_KEYS}

    def loss_fn(params):
        terms, _ = jax_scene_terms(jmodel, params, variables["batch_stats"],
                                   scene_j, jax.random.PRNGKey(0),
                                   depth_supervise=True, use_nerf_mask=True)
        return jax_reduce(jax.tree_util.tree_map(lambda t: t[None], terms))

    @jax.jit
    def grads_of(params):
        (_, metrics), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            params)
        return dict(metrics, grad_norm=optax.global_norm(grads)), grads

    metrics, grads = grads_of(variables["params"])
    zero_stats = jax.tree_util.tree_map(np.zeros_like,
                                        variables["batch_stats"])
    return dict(variables=variables,
                metrics={k: np.asarray(v) for k, v in metrics.items()},
                grads=_port_tree(grads, zero_stats))


def test_depth_sp_step_loss_terms_match_jax(step):
    got, want = step["port"][0], step["jax"][0]
    batch = step["batch"]
    assert "depth" in batch and "gt_depth" in batch
    assert "rgb_s1" not in batch  # the rgb stream is gated on the device
    assert set(got) == set(want)
    assert float(got["n_pos"]) == float(want["n_pos"]) > 0
    assert float(want["loss_depth"]) > 0 and float(want["loss_nvs"]) > 0
    for k in ("loss", "loss_cls", "loss_bbox", "loss_centerness",
              "loss_nvs", "loss_depth", "grad_norm"):
        assert _rel(got[k], want[k]) <= 1e-4, (k, got[k], want[k])


def test_depth_sp_step_every_gradient_matches_jax(step):
    grads, want = step["port"][1], step["jax"][1]
    for name, g in grads.items():
        w = want[name]
        assert g.shape == w.shape, name
        tol = 1e-3 * float(w.abs().max())
        assert float((g - w).abs().max()) <= tol, name
    # the gradient crosses the gated fusion (K1's backward) into mapping
    # and the FPN, and the render into the radiance field
    for name in ("mapping.0.weight", "mapping.0.bias",
                 "neck.lateral_convs.0.conv.weight",
                 "nerf_mlp.mlp.rgb_layer.output_layer.weight"):
        assert float(grads[name].abs().max()) > 0, name


def test_depth_sp_step_keeps_neck_relu_inputs_off_zero(step):
    """The condition the gradient tolerance rests on (as in
    ``tests/test_torch_train.py``): no ReLU input of the 3D neck lies
    within 3e-6 of 0."""
    model = _port_model(50)
    model.load_state_dict(step["start"])
    model.train()
    seen = {}
    hook = model.neck_3d.register_forward_pre_hook(
        lambda m, args: seen.setdefault("x", args[0].detach()))
    with torch.no_grad():
        model(step["batch"])
    hook.remove()
    with torch.no_grad(), _ReluMargin() as mode:
        copy.deepcopy(model.neck_3d)(seen["x"])
    assert 3e-6 <= mode.least < float("inf")
