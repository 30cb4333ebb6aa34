"""The port's joint detection + NVS training against the JAX package.

Held against JAX, on the CPU, in float32:

* the host ray stream (``data/ray_stats.py``): ``host_sample_z`` and
  ``host_ray_rgb_stats`` bit for bit for the same ``RandomState``, and
  ``prepare_rays`` bit for bit against the JAX data path
  (``subsample_rays``, then the stream);
* the device jitter of ``sample_along_camera_ray`` by its properties
  (each depth in its stratum; the evenly spaced depths with ``det``):
  JAX's and torch's generators give other numbers;
* K2's gradient (the autograd Function: on the CPU the plain forward and
  ``streaming_sample_mean_var_backward_plain``) against ``jax.grad`` of
  the JAX ``streaming_sample_mean_var``, in the training form (host rgb)
  and the eval form, within 1e-4 x the max |gradient|; the points include
  ones no view sees and taps with partial border weights, whose 1 / (cnt
  + 1e-8) sets that max. The plain backward also against autograd through
  ``ray_view_carry_plain`` (1e-5 x max);
* one joint train step of a toy NeRF-Det (ResNet-50 at 32x40 images,
  three views, 24 rays of 16 samples a scene, FPN 64, neck 16, five
  classes) on two scenes against JAX ``make_train_step(rgb_supervision=
  True)`` run op by op, for the reason ``tests/test_torch_train.py``
  gives: loss terms (``loss_nvs`` included) and grad_norm 1e-4 relative,
  every gradient within 1e-3 x its max, the updated parameters within
  1e-6 where the gradient is signal (the rule of that file); the seeds
  keep the 3D neck's ReLU inputs 3e-6 from 0 and the density of both
  scenes' rendered samples alive, so the NVS loss reaches ``mapping``
  through K2's backward (most seeds leave sigma dead there);
* ``loss_depth`` of one scene with ``depth_supervise=True`` (and the
  all-ones mask of ``use_nerf_mask=False``) against JAX's
  ``scene_loss_terms``, 1e-4 relative.

The intrinsic is given at ``ori_shape``, so the rays' samples and the
voxels project where the images are. The file takes ~4 minutes on 2
threads, most of it JAX's op-by-op step, which runs once per test run
(``computed_once``).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nerfdet_tpu.data.pipeline import subsample_rays
from nerfdet_tpu.data.synthetic import make_synthetic_scene
from nerfdet_tpu.models.nerfdet import NerfDet as JaxNerfDet
from nerfdet_tpu.models.nerfdet import SceneMeta as JaxSceneMeta
from nerfdet_tpu.ops import render as jrender
from nerfdet_tpu.ops.voxel import host_rgb_stats as jax_host_rgb_stats
from nerfdet_tpu.train import optim as joptim
from nerfdet_tpu.train import TrainState, make_train_step as jax_train_step
from nerfdet_tpu.train.step import scene_loss_terms as jax_scene_terms

from nerfdet_tpu_torch import api
from nerfdet_tpu_torch.data import ray_stats
from nerfdet_tpu_torch.models.nerfdet import NerfDet, SceneMeta
from nerfdet_tpu_torch.ops import render as trender
from nerfdet_tpu_torch.train import optim as toptim
from nerfdet_tpu_torch.train.step import make_train_step, scene_loss_terms
from nerfdet_tpu_torch.utils.weight_convert import from_jax_variables

from tests.test_torch_nerfdet import _perturb
from tests.test_torch_render import _edge_points, _jax_intrinsics
from tests.test_torch_session_cache import computed_once
import tests.test_torch_train as det
from tests.test_torch_train import (OPTIMIZER, _capture, _port_tree,
                                    _ReluMargin, _rel)

ORI, IMG, PAD = (128, 160), (31, 40), (32, 40)
RATIO = ORI[0] / IMG[0]
N_VOX, VOX = (8, 8, 4), (0.8, 0.8, 0.8)
FPN_OUT, NECK3D_OUT, N_CLS, N_SCALES = 64, 16, 5, 3
N_RAND, N_SAMPLES, NEAR_FAR = 24, 16, (0.2, 8.0)
PERTURB_SEED, SCENE_SEEDS, RAY_SEED = 0, (10, 13), 11
MAX_NORM = 35.0
JAX_KEYS = ("imgs", "denorm_images", "intrinsic", "extrinsics", "origin",
            "rgb_s1", "rgb_s2", "gt_boxes", "gt_labels", "gt_mask", "ray_o",
            "ray_d", "gt_rgb", "gt_depth") + ray_stats.RAY_STREAM_KEYS


@pytest.fixture(autouse=True, scope="module")
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _raw_scene(seed, n_rand=N_RAND):
    """A synthetic scene with its intrinsic at ``ori_shape``."""
    s = make_synthetic_scene(seed=seed, n_views=3, n_targets=1, hw=IMG,
                             pad_hw=PAD, n_rand=n_rand, n_boxes=2, max_gt=4,
                             margin=2)
    s["intrinsic"] = s["intrinsic"].copy()
    s["intrinsic"][:2] *= np.float32(RATIO)
    return s


def _stream_args(scene, z):
    return (scene["denorm_images"], scene["intrinsic"], scene["extrinsics"],
            scene["ray_o"], scene["ray_d"], z, ORI, IMG)


# ---------------------------------------------------------------------
# the host ray stream
# ---------------------------------------------------------------------

@pytest.mark.parametrize("det", [False, True])
def test_host_sample_z_is_jaxs_bit_for_bit(det):
    got = ray_stats.host_sample_z(np.random.RandomState(4), 37, *NEAR_FAR,
                                  N_SAMPLES, det=det)
    want = jrender.host_sample_z(np.random.RandomState(4), 37, *NEAR_FAR,
                                 N_SAMPLES, det=det)
    assert got.dtype == want.dtype == np.float32
    assert got.shape == (37, N_SAMPLES)
    np.testing.assert_array_equal(got, want)


def test_host_ray_rgb_stats_is_jaxs_bit_for_bit():
    scene = _raw_scene(1, n_rand=64)
    z = jrender.host_sample_z(np.random.RandomState(2), 64, *NEAR_FAR,
                              N_SAMPLES)
    got = ray_stats.host_ray_rgb_stats(*_stream_args(scene, z))
    want = jrender.host_ray_rgb_stats(*_stream_args(scene, z))
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    cnt = got[3]
    assert cnt.min() == 0 and cnt.max() == 3  # unseen and fully seen


def test_host_ray_rgb_stats_refuses_float16():
    """float32 and bfloat16 streams only (``tests/test_torch_bf16.py``
    holds the bfloat16 one to JAX's)."""
    scene = _raw_scene(1)
    z = np.ones((N_RAND, 2), np.float32)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ray_stats.host_ray_rgb_stats(*_stream_args(scene, z),
                                     compute_dtype="float16")


def test_prepare_rays_is_the_jax_data_path_bit_for_bit():
    """Rays of the whole target view (more than N_rand) with their
    depths: the draw of ``subsample_rays`` (zero-depth rays dropped
    first), then ``host_sample_z`` and the rgb stream, all from one
    RandomState in that order."""
    scene = _raw_scene(2, n_rand=10_000)
    n_all = scene["ray_o"].shape[0]
    assert n_all > N_RAND
    got = ray_stats.prepare_rays(scene, np.random.RandomState(9), N_RAND,
                                 NEAR_FAR, N_SAMPLES, ORI, IMG)

    rng = np.random.RandomState(9)
    want = subsample_rays(dict(raydirs=scene["ray_d"],
                               lightpos=scene["ray_o"],
                               gt_images=scene["gt_rgb"],
                               gt_depths=scene["gt_depth"]), N_RAND, rng)
    z = jrender.host_sample_z(rng, N_RAND, *NEAR_FAR, N_SAMPLES)
    stats = jrender.host_ray_rgb_stats(
        scene["denorm_images"], scene["intrinsic"], scene["extrinsics"],
        want["ray_o"], want["ray_d"], z, ORI, IMG)
    for k in ("ray_o", "ray_d", "gt_rgb", "gt_depth"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k, w in zip(ray_stats.RAY_STREAM_KEYS, (z,) + stats):
        np.testing.assert_array_equal(got[k], w, err_msg=k)
    assert scene["ray_o"].shape[0] == n_all  # the input is not changed


# ---------------------------------------------------------------------
# the device jitter
# ---------------------------------------------------------------------

def test_stratified_jitter_keeps_each_depth_in_its_stratum():
    rng = np.random.RandomState(0)
    ray_o = torch.tensor(rng.randn(500, 3), dtype=torch.float32)
    ray_d = torch.tensor(rng.randn(500, 3), dtype=torch.float32)
    even, z_even = trender.sample_along_camera_ray(
        ray_o, ray_d, *NEAR_FAR, N_SAMPLES, det=True)
    _, z_j = jrender.sample_along_camera_ray(
        jnp.asarray(ray_o.numpy()), jnp.asarray(ray_d.numpy()), *NEAR_FAR,
        N_SAMPLES, det=True)
    np.testing.assert_array_equal(z_even.numpy(), np.asarray(z_j))

    gen = torch.Generator().manual_seed(3)
    pts, z = trender.sample_along_camera_ray(
        ray_o, ray_d, *NEAR_FAR, N_SAMPLES, det=False, generator=gen)
    zn, ze = z.numpy(), z_even.numpy()
    mids = 0.5 * (ze[:, 1:] + ze[:, :-1])
    lower = np.concatenate([ze[:, :1], mids], 1)
    upper = np.concatenate([mids, ze[:, -1:]], 1)
    assert (zn >= lower).all() and (zn <= upper).all()
    assert (np.diff(zn, axis=1) >= 0).all()
    # the draws fill their strata: uniform in [0, 1) relative positions
    t = (zn - lower) / (upper - lower)
    assert 0.45 < t.mean() < 0.55 and t.min() < 0.01 and t.max() > 0.99
    np.testing.assert_allclose(pts.numpy(), (z[..., None] * ray_d[:, None]
                                             + ray_o[:, None]).numpy())
    again = trender.sample_along_camera_ray(
        ray_o, ray_d, *NEAR_FAR, N_SAMPLES, det=False,
        generator=torch.Generator().manual_seed(3))[1]
    assert torch.equal(again, z)


# ---------------------------------------------------------------------
# K2's gradient
# ---------------------------------------------------------------------

def _k2_case(case, c=8):
    """(pts (R, S, 3), scene, feats, host rgb stream) for the rays of a
    scene at stratified depths, or for the trap points of
    ``tests.test_torch_render._edge_points`` (S = 1)."""
    scene = _raw_scene(0, n_rand=96)
    rng = np.random.RandomState(5)
    if case == "rays":
        z = ray_stats.host_sample_z(rng, 96, *NEAR_FAR, N_SAMPLES)
        feats = rng.randn(3, 7, 10, c).astype(np.float32)
        ray_o, ray_d = scene["ray_o"], scene["ray_d"]
    else:
        pts, feats = _edge_points(scene, c)
        ray_o = pts.reshape(-1, 3)
        ray_d = np.zeros_like(ray_o)
        z = np.ones((ray_o.shape[0], 1), np.float32)
    pts = (z[..., None] * ray_d[:, None, :] + ray_o[:, None, :])
    host = ray_stats.host_ray_rgb_stats(
        scene["denorm_images"], scene["intrinsic"], scene["extrinsics"],
        ray_o, ray_d, z, ORI, IMG)
    return pts.astype(np.float32), scene, feats, host


@pytest.mark.parametrize("form", ["training", "eval"])
@pytest.mark.parametrize("case", ["rays", "edges"])
def test_k2_gradient_matches_jax_grad(case, form):
    pts, scene, feats, host = _k2_case(case)
    images = scene["denorm_images"]
    cs = 3 + feats.shape[-1]
    g = np.random.RandomState(6).randn(*pts.shape[:2], 2 * cs).astype(
        np.float32)
    intr = _jax_intrinsics(scene["intrinsic"], 3)
    pre_j = tuple(jnp.asarray(h) for h in host) if form == "training" \
        else None

    def jax_loss(f):
        gf, _ = jrender.streaming_sample_mean_var(
            jnp.asarray(pts), jnp.asarray(images), intr,
            jnp.asarray(scene["extrinsics"]), IMG, featmaps=f,
            precomputed_rgb=pre_j)
        return jnp.sum(gf * g), gf

    (_, gf_j), grad_j = jax.value_and_grad(jax_loss, has_aux=True)(
        jnp.asarray(feats))
    grad_j = np.asarray(grad_j)

    proj = trender.view_projection(scene["intrinsic"], scene["extrinsics"],
                                   RATIO)
    pre_t = (tuple(torch.from_numpy(h) for h in host)
             if form == "training" else None)
    f = torch.from_numpy(feats).requires_grad_()
    gf_t, mask_t = trender.streaming_sample_mean_var(
        torch.from_numpy(pts), torch.from_numpy(images), proj, IMG, f,
        pre_t)
    (gf_t * torch.from_numpy(g)).sum().backward()
    assert gf_t.requires_grad and not mask_t.requires_grad
    np.testing.assert_allclose(gf_t.detach().numpy(), np.asarray(gf_j),
                               rtol=0, atol=2e-5)
    scale = np.abs(grad_j).max()
    assert scale > 0
    err = np.abs(f.grad.numpy() - grad_j).max()
    assert err <= 1e-4 * scale, (err, scale)

    # the traps are there: points no view sees, and taps with partial
    # border weights of points some view sees
    cnt = host[3][..., 0]
    assert (cnt == 0).any() and (cnt > 0).any()
    if case == "edges":
        assert (cnt[:30] == 0).any() and (np.abs(grad_j) > 0).any()


@pytest.mark.parametrize("form", ["training", "eval"])
def test_k2_plain_backward_matches_autograd_through_the_plain_carry(form):
    pts, scene, feats, host = _k2_case("rays", c=5)
    proj = trender.view_projection(scene["intrinsic"], scene["extrinsics"],
                                   RATIO)
    args = (torch.from_numpy(pts), torch.from_numpy(scene["denorm_images"]),
            proj, IMG)
    pre = (tuple(torch.from_numpy(h) for h in host)
           if form == "training" else None)
    g = torch.from_numpy(np.random.RandomState(7).randn(
        *pts.shape[:2], 2 * 8).astype(np.float32))
    f = torch.from_numpy(feats).requires_grad_()
    gf, _ = trender.streaming_sample_mean_var_plain(*args, f, pre)
    (gf * g).sum().backward()

    before = trender.streaming_sample_mean_var_backward.launches
    f2 = torch.from_numpy(feats).requires_grad_()
    gf2, _ = trender.streaming_sample_mean_var(*args, f2, pre)
    (gf2 * g).sum().backward()
    assert trender.streaming_sample_mean_var_backward.launches == before
    assert float((f2.grad - f.grad).abs().max()) <= 1e-5 * float(
        f.grad.abs().max())


def test_window_order_lists_each_windows_pairs_in_point_order():
    """K2's backward index: ``order`` lists each window's pairs in
    ascending pair order, the dropped pairs (keyed ``n_windows``) last;
    ``off`` bounds each window's run."""
    rng = np.random.RandomState(0)
    v, n, n_win = 3, 50, 12
    keys = rng.randint(0, n_win // v, (v, n)) + (np.arange(v) * (
        n_win // v))[:, None]
    keys[rng.rand(v, n) < 0.3] = n_win
    order, off = trender.window_order(
        torch.from_numpy(keys.astype(np.int32)), n_win)
    assert order.dtype == off.dtype == torch.int32
    assert off.shape == (n_win + 1,) and int(off[0]) == 0
    assert int(off[-1]) == int((keys < n_win).sum())
    flat = keys.reshape(-1)
    for k in range(n_win):
        run = order[off[k]:off[k + 1]].numpy()
        np.testing.assert_array_equal(run, np.flatnonzero(flat == k))
    np.testing.assert_array_equal(np.sort(order.numpy()),
                                  np.arange(v * n))


def test_k2_refuses_float16_maps_under_grad():
    """float32 and bfloat16 maps only (``tests/test_torch_bf16.py`` holds
    the bfloat16 forms and their gradient to JAX's)."""
    pts, scene, feats, host = _k2_case("rays")
    f = torch.from_numpy(feats).half().requires_grad_()
    proj = trender.view_projection(scene["intrinsic"], scene["extrinsics"],
                                   RATIO)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        trender.streaming_sample_mean_var(
            torch.from_numpy(pts), None, proj, IMG, f,
            tuple(torch.from_numpy(h) for h in host))


# ---------------------------------------------------------------------
# the joint train step
# ---------------------------------------------------------------------

def _scene(seed):
    """A training scene with its host rgb sums and ray stream."""
    s = _raw_scene(seed)
    s1, s2 = jax_host_rgb_stats(s["denorm_images"], s["intrinsic"],
                                s["extrinsics"], s["origin"], N_VOX, VOX,
                                ORI, IMG)
    s = ray_stats.prepare_rays(dict(s, rgb_s1=s1, rgb_s2=s2),
                               np.random.RandomState(RAY_SEED + seed),
                               N_RAND, NEAR_FAR, N_SAMPLES, ORI, IMG)
    return s


def _port_model():
    return NerfDet(
        fpn_out_channels=FPN_OUT, neck3d_out_channels=NECK3D_OUT,
        neck3d_n_blocks=(1, 1, 1), n_classes=N_CLS, n_scales=N_SCALES,
        n_voxels=N_VOX, voxel_size=VOX, n_samples=N_SAMPLES, n_rand=N_RAND,
        near_far_range=NEAR_FAR, nerf_density=True,
        meta=SceneMeta(ori_shape=ORI, img_shape=IMG, pad_shape=PAD))


def _jax_model():
    return JaxNerfDet(
        backbone_depth=50, fpn_out_channels=FPN_OUT,
        neck3d_out_channels=NECK3D_OUT, neck3d_n_blocks=(1, 1, 1),
        n_classes=N_CLS, n_scales=N_SCALES, n_voxels=N_VOX,
        voxel_size=VOX, n_samples=N_SAMPLES, n_rand=N_RAND,
        near_far_range=NEAR_FAR, nerf_density=True,
        meta=JaxSceneMeta(ori_shape=ORI, img_shape=IMG, pad_shape=PAD))


def toy_variables(tmp_path_factory, scenes):
    """The toy's perturbed JAX variables, once per test run
    (``tests/test_torch_ddp.py`` trains from them too)."""
    def compute():
        init = {k: jnp.asarray(scenes[0][k]) for k in JAX_KEYS}
        variables = jax.jit(lambda k: _jax_model().init(
            k, init, train=False))(jax.random.PRNGKey(0))
        rng = np.random.RandomState(PERTURB_SEED)
        return {"params": _perturb(dict(variables["params"]), rng),
                "batch_stats": _perturb(dict(variables["batch_stats"]),
                                        rng)}
    return computed_once(tmp_path_factory, "torch_train_nvs_variables",
                         compute)


def _jax_reference(variables, scenes):
    """JAX's joint step on the toy, op by op, and what the tests read of
    it."""
    jmodel = _jax_model()
    batch = {k: np.stack([s[k] for s in scenes]) for k in JAX_KEYS}
    params = variables["params"]
    tx = optax.chain(_capture(), joptim.build_optimizer(
        params, OPTIMIZER, grad_clip=dict(max_norm=MAX_NORM)))
    state = TrainState.create(params, variables["batch_stats"], tx)
    step = jax_train_step(jmodel, tx, rgb_supervision=True, donate=False)
    with jax.disable_jit():  # op by op: see tests/test_torch_train.py
        new, metrics = step(state, batch, jax.random.PRNGKey(0))
    clip = optax.clip_by_global_norm(MAX_NORM)
    clipped, _ = clip.update(new.opt_state[0], clip.init(new.opt_state[0]))
    zero_stats = jax.tree_util.tree_map(np.zeros_like,
                                        variables["batch_stats"])
    return dict(metrics={k: np.asarray(v) for k, v in metrics.items()},
                grads=_port_tree(clipped, zero_stats),
                params=_port_tree(new.params, new.batch_stats))


def _jax_loss_depth(variables, scenes, use_nerf_mask):
    """Both scenes' terms with ``depth_supervise``, JAX's ``vmap``ped as
    its step maps them (op by op, so its primitives are the step's)."""
    batch = {k: jnp.asarray(np.stack([s[k] for s in scenes]))
             for k in JAX_KEYS}
    with jax.disable_jit():
        want, _ = jax.vmap(lambda scene: jax_scene_terms(
            _jax_model(), variables["params"], variables["batch_stats"],
            scene, None, depth_supervise=True,
            use_nerf_mask=use_nerf_mask))(batch)
    return want


def jax_step_references(tmp_path_factory):
    """JAX's op-by-op steps of this file's toy and of
    ``tests/test_torch_train.py``'s, and this toy's depth terms: once per
    test run, in one process. Op by op, JAX compiles each primitive at
    each shape once a process, which is most of the time: ~220 s for the
    first toy's step alone, ~40 s more for the second's."""
    def compute():
        det_scenes = [det._scene(s) for s in det.SCENE_SEEDS]
        scenes = [_scene(s) for s in SCENE_SEEDS]
        variables = toy_variables(tmp_path_factory, scenes)
        return dict(
            detection=det._jax_reference(det.toy_variables(tmp_path_factory),
                                         det_scenes),
            joint=_jax_reference(variables, scenes),
            loss_depth={m: _jax_loss_depth(variables, scenes, m)
                        for m in (True, False)})
    return computed_once(tmp_path_factory, "torch_train_jax_steps", compute)


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    scenes = [_scene(s) for s in SCENE_SEEDS]
    variables = toy_variables(tmp_path_factory, scenes)
    refs = jax_step_references(tmp_path_factory)
    jax_out = refs["joint"]

    model = _port_model()
    start = from_jax_variables(variables)
    model.load_state_dict(start, strict=True)
    opt = toptim.build_optimizer(model, OPTIMIZER,
                                 grad_clip=dict(max_norm=MAX_NORM))
    port_metrics = make_train_step(model, opt)(api.train_batch(model,
                                                                scenes))
    grads = {n: (torch.zeros_like(p) if p.grad is None else p.grad.clone())
             for n, p in model.named_parameters()}
    yield dict(loss_depth=refs["loss_depth"], scenes=scenes,
               start=start, jax=jax_out,
               port=(port_metrics, grads, copy.deepcopy(model.state_dict())),
               labels=toptim.param_labels(model))


def test_joint_step_loss_terms_match_jax(toy):
    got, want = toy["port"][0], toy["jax"]["metrics"]
    assert set(got) == set(want)
    assert "loss_nvs" in got and "loss_depth" not in got
    assert float(got["n_pos"]) == float(want["n_pos"]) > 0
    assert float(want["loss_nvs"]) > 0
    for k in ("loss", "loss_cls", "loss_bbox", "loss_centerness",
              "loss_nvs", "grad_norm"):
        assert _rel(got[k], want[k]) <= 1e-4, (k, got[k], want[k])


def test_joint_step_every_gradient_matches_jax(toy):
    grads, want = toy["port"][1], toy["jax"]["grads"]
    for name, g in grads.items():
        w = want[name]
        assert g.shape == w.shape, name
        tol = 1e-3 * float(w.abs().max())
        assert float((g - w).abs().max()) <= tol, name
    # the NVS loss trains the radiance field's colour branch, and the
    # gradient crosses K2's backward into mapping and the FPN
    for name in ("nerf_mlp.mlp.rgb_layer.output_layer.weight",
                 "nerf_mlp.mlp.bottleneck_layer.output_layer.weight",
                 "mapping.0.weight", "mapping.0.bias",
                 "neck.lateral_convs.0.conv.weight"):
        assert float(grads[name].abs().max()) > 0, name


def test_joint_step_parameters_match_jax(toy):
    state, want = toy["port"][2], toy["jax"]["params"]
    grads = toy["jax"]["grads"]
    for name, label in toy["labels"].items():
        before, after = toy["start"][name], state[name]
        if label == "frozen":
            assert torch.equal(after, before), name
            continue
        g = grads[name].abs()
        mult = 0.1 if label == "backbone" else 1.0
        err = (after - want[name]).abs()
        signal = g >= 1e-3 * float(g.max())
        if bool(signal.any()):
            assert float(err[signal].max()) <= 1e-6, name
        assert float(err.max()) <= 2 * 2e-4 * mult + 1e-6, name
    for k in state:
        if k.endswith(("running_mean", "running_var")):
            assert float((state[k] - want[k]).abs().max()) <= 1e-5, k


def test_toy_keeps_neck_relu_inputs_off_zero(toy):
    """The condition the gradient tolerance rests on (as in
    ``tests/test_torch_train.py``): in each scene, no ReLU input of the 3D
    neck lies within 3e-6 of 0."""
    model = _port_model()
    model.load_state_dict(toy["start"])
    model.train()
    for batch in api.train_batch(model, toy["scenes"]):
        seen = {}
        hook = model.neck_3d.register_forward_pre_hook(
            lambda m, args: seen.setdefault("x", args[0].detach()))
        with torch.no_grad():
            model(batch)
        hook.remove()
        with torch.no_grad(), _ReluMargin() as mode:
            copy.deepcopy(model.neck_3d)(seen["x"])
        assert 3e-6 <= mode.least < float("inf")


@pytest.mark.parametrize("scene", [0, 1])
def test_render_alone_trains_mapping(toy, scene):
    """In each scene the NVS loss alone, through K2's backward, puts a
    gradient on ``mapping`` (its other side is K1's backward): the seeds
    keep the density of the rendered samples alive."""
    model = _port_model()
    model.load_state_dict(toy["start"])
    model.train()
    batch = api.train_batch(model, [toy["scenes"][scene]])[0]
    terms = scene_loss_terms(model, batch)
    terms["loss_nvs"].backward()
    assert float(model.mapping[0].weight.grad.abs().max()) > 0
    assert float(model.mapping[0].bias.grad.abs().max()) > 0


def test_train_forward_without_z_vals_jitters_on_the_device(toy):
    """A training batch whose rays bring no host stream renders at depths
    jittered from the forward's generator, with K2's eval form (the
    images' rgb sampled in the kernel): the same seed gives the same
    render, another seed another."""
    model = _port_model()
    model.load_state_dict(toy["start"])
    model.train()
    scene = toy["scenes"][0]
    batch = api.train_batch(model, [scene])[0]
    for k in ray_stats.RAY_STREAM_KEYS:
        del batch[k]
    batch["denorm_images"] = torch.from_numpy(scene["denorm_images"])
    with torch.no_grad():
        outs = [model(batch, torch.Generator().manual_seed(seed))[2]
                for seed in (1, 1, 2)]
    assert torch.equal(outs[0]["depth"], outs[1]["depth"])
    assert not torch.equal(outs[0]["depth"], outs[2]["depth"])
    assert all(torch.isfinite(o["rgb"]).all() for o in outs)


@pytest.mark.parametrize("use_nerf_mask", [True, False])
def test_loss_depth_matches_jax(toy, use_nerf_mask):
    """Both scenes' terms with ``depth_supervise`` against JAX's
    (``_jax_loss_depth``)."""
    want = toy["loss_depth"][use_nerf_mask]
    model = _port_model()
    model.load_state_dict(toy["start"])
    model.train()
    for i, scene in enumerate(api.train_batch(model, toy["scenes"])):
        with torch.no_grad():
            got = scene_loss_terms(model, scene, depth_supervise=True,
                                   use_nerf_mask=use_nerf_mask)
        assert float(want["loss_depth"][i]) > 0
        for k in ("loss_nvs", "loss_depth"):
            assert _rel(got[k], want[k][i]) <= 1e-4, (k, i, got[k])
