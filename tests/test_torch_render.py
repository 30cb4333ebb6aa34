"""The port's render branch (image mode) against the JAX package.

One toy NeRF-Det (``tests/test_train_step.tiny_model``: ResNet-50 at
32x40 images, FPN(256), 16 samples per ray) is initialized in JAX with
a ray bundle, its weights perturbed from a numpy seed and carried to
the port with ``from_jax_variables``. On the CPU every K2 call runs its
plain version. Held against JAX, in float32:

* the bilinear packing bit for bit and its sample within 1e-6;
* K2's wrapper (on the CPU its plain version: the carry, then the
  epilogue) against ``streaming_sample_mean_var``: the two-view mask
  exactly, globalfeat within 2e-5 (the projection's products are summed
  in another order);
* ``render`` and ``forward`` with rays: rgb within 1e-4, depth within
  1e-3, the ray mask exactly; ``render_full`` at chunk 128 with padding;
* ``run_nvs_eval`` on the dataset ``tests/test_nvs.py`` builds: PSNR
  within 1e-3 dB, SSIM and RMSE within 1e-4.

The scene's intrinsic is given at ``ori_shape`` (scaled from the
rendered size), so the sample points project where the images are.
"""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from nerfdet_tpu.api import run_nvs_eval as jax_run_nvs_eval
from nerfdet_tpu.ops import grid_sample as jgs
from nerfdet_tpu.ops import render as jrender
from nerfdet_tpu.ops.voxel import host_rgb_stats as jax_host_rgb_stats

from nerfdet_tpu_torch import api
from nerfdet_tpu_torch.data.synthetic import make_synthetic_scene
from nerfdet_tpu_torch.models.nerfdet import NerfDet, SceneMeta
from nerfdet_tpu_torch.ops import grid_sample as tgs
from nerfdet_tpu_torch.ops import render as trender
from nerfdet_tpu_torch.utils.weight_convert import from_jax_variables

from tests.test_torch_nerfdet import _perturb
from tests.test_train_step import tiny_model

ORI, IMG, PAD = (128, 160), (31, 40), (32, 40)
RATIO = ORI[0] / IMG[0]
N_SAMPLES, NEAR_FAR = 16, (0.2, 8.0)


@pytest.fixture(autouse=True, scope="module")
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _scene(n_rand=96):
    scene = make_synthetic_scene(seed=0, n_views=3, n_targets=1, hw=IMG,
                                 pad_hw=PAD, n_rand=n_rand, n_boxes=2,
                                 max_gt=4, margin=2)
    scene["intrinsic"] = scene["intrinsic"].copy()
    scene["intrinsic"][:2] *= np.float32(RATIO)
    return scene


def _jax_intrinsics(intrinsic, v):
    intr4 = jnp.asarray(intrinsic, jnp.float32).at[:2].divide(RATIO)
    return jnp.broadcast_to(intr4, (v, 4, 4))


# ---------------------------------------------------------------------
# ops
# ---------------------------------------------------------------------

def test_pack_and_sample_match_jax():
    rng = np.random.RandomState(0)
    img = rng.randn(5, 6, 4).astype(np.float32)
    # interior, the partial windows (-1, 0) and (size - 1, size), beyond
    px = np.concatenate([rng.uniform(-1.5, 6.5, 200),
                         [-0.5, -0.999, 5.25, 5.999, 6.0, -1.0, 1e6, -1e6]])
    py = np.concatenate([rng.uniform(-1.5, 5.5, 200),
                         [2.0, 4.5, -0.25, 4.75, 1.0, 3.0, 2.0, 2.0]])
    px, py = px.astype(np.float32), py.astype(np.float32)
    packed_j = jgs.pack_bilinear(jnp.asarray(img))
    packed_t = tgs.pack_bilinear(torch.from_numpy(img))
    np.testing.assert_array_equal(packed_t.numpy(), np.asarray(packed_j))
    want = np.asarray(jgs.grid_sample_2d(jnp.asarray(img), jnp.asarray(px),
                                         jnp.asarray(py), padding="zeros"))
    got = tgs.grid_sample_2d_packed(packed_t, torch.from_numpy(px),
                                    torch.from_numpy(py)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert np.abs(got[200:202]).max() > 0  # partial left-edge windows
    np.testing.assert_array_equal(got[-2:], 0.0)


def test_sampling_and_projection_match_jax():
    scene = _scene()
    ray_o, ray_d = scene["ray_o"], scene["ray_d"]
    pts_j, z_j = jrender.sample_along_camera_ray(
        jnp.asarray(ray_o), jnp.asarray(ray_d), *NEAR_FAR, N_SAMPLES,
        det=True)
    pts_t, z_t = trender.sample_along_camera_ray(
        torch.from_numpy(ray_o), torch.from_numpy(ray_d), *NEAR_FAR,
        N_SAMPLES)
    np.testing.assert_array_equal(z_t.numpy(), np.asarray(z_j))
    np.testing.assert_allclose(pts_t.numpy(), np.asarray(pts_j), rtol=1e-6,
                               atol=1e-6)
    pix_j, front_j = jrender.project_to_views(
        pts_j, _jax_intrinsics(scene["intrinsic"], 3),
        jnp.asarray(scene["extrinsics"]))
    proj = trender.view_projection(scene["intrinsic"], scene["extrinsics"],
                                   RATIO)
    pix_t, front_t = trender.project_to_views(
        torch.tensor(np.asarray(pts_j)), proj)
    assert pix_t.shape == pix_j.shape == (3, 96, N_SAMPLES, 2)
    np.testing.assert_array_equal(front_t.numpy(), np.asarray(front_j))
    np.testing.assert_allclose(pix_t.numpy(), np.asarray(pix_j), rtol=1e-5,
                               atol=1e-4)


def _edge_points(scene, feat_c=8):
    """Sample points that land on the traps: the partial windows of view
    0 at each edge, points behind every camera (far above the scene,
    the cameras look down), and points beyond the images."""
    k = scene["intrinsic"].astype(np.float64)[:3, :3].copy()
    k[:2] /= RATIO
    c2w = np.linalg.inv(scene["extrinsics"][0].astype(np.float64))
    h, w = IMG
    pix = [(-0.5, 15.2), (-0.9, 3.3), (w - 0.5, 10.0), (w - 1 + 0.3, 29.7),
           (20.3, -0.7), (12.0, h - 1 + 0.6), (5.5, h - 0.2), (-1.5, 5.0),
           (w + 3.0, 7.0), (19.5, 14.5)]
    pts = []
    for depth in (1.5, 2.5, 4.0):
        for px, py in pix:
            cam = depth * np.linalg.solve(k, [px, py, 1.0])
            pts.append(c2w[:3, :3] @ cam + c2w[:3, 3])
    pts += [[0.3 * i, -0.2 * i, 50.0 + i] for i in range(len(pix))]
    pts = np.asarray(pts, np.float32).reshape(4, len(pix), 3)
    rng = np.random.RandomState(1)
    feats = rng.randn(3, 7, 10, feat_c).astype(np.float32)
    return pts, feats


@pytest.mark.parametrize("case", ["rays", "edges"])
def test_ray_view_carry_plain_matches_jax(case):
    scene = _scene()
    if case == "rays":
        pts, _ = jrender.sample_along_camera_ray(
            jnp.asarray(scene["ray_o"]), jnp.asarray(scene["ray_d"]),
            *NEAR_FAR, N_SAMPLES, det=True)
        pts = np.array(pts)
        feats = np.random.RandomState(2).randn(3, 7, 10, 32).astype(
            np.float32)
    else:
        pts, feats = _edge_points(scene)
    images = scene["denorm_images"]
    gf_j, mask_j = jrender.streaming_sample_mean_var(
        jnp.asarray(pts), jnp.asarray(images),
        _jax_intrinsics(scene["intrinsic"], 3),
        jnp.asarray(scene["extrinsics"]), IMG, featmaps=jnp.asarray(feats))

    proj = trender.view_projection(scene["intrinsic"], scene["extrinsics"],
                                   RATIO)
    args = (torch.from_numpy(pts), torch.from_numpy(images), proj, IMG,
            torch.from_numpy(feats))
    before = trender.streaming_sample_mean_var.launches
    gf_t, mask_t = trender.streaming_sample_mean_var(*args)
    # CPU: the plain version
    assert trender.streaming_sample_mean_var.launches == before
    c = 3 + feats.shape[-1]
    assert gf_t.shape == pts.shape[:2] + (2 * c,)
    np.testing.assert_array_equal(mask_t.numpy(), np.asarray(mask_j))
    np.testing.assert_allclose(gf_t.numpy(), np.asarray(gf_j), rtol=0,
                               atol=2e-5)
    assert 0 < mask_t.numpy().mean() < 1

    carry = trender.ray_view_carry_plain(args[0], args[1], args[4], proj, IMG)
    assert [t.shape[-1] for t in carry] == [c, c, c, 1]
    cnt = carry[3].numpy()[..., 0]
    np.testing.assert_array_equal(cnt > 1, mask_t.numpy())
    if case == "edges":
        # behind every camera: unseen, yet s1u holds the samples
        assert (cnt[3] == 0).all()
        # the partial left and right windows of view 0 sample the image
        # unmasked, so s1u exceeds the masked s1m there
        s1u, s1m = carry[0].numpy(), carry[2].numpy()
        assert (np.abs(s1u - s1m)[:3, :4].max(axis=-1) > 0).all()


# ---------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def toy():
    """(jax_model, jax_variables, port_model): weights initialized with
    a ray bundle, so the rgb head exists, then perturbed."""
    jmodel = tiny_model()
    scene = _scene(n_rand=8)
    batch = {k: jnp.asarray(scene[k]) for k in (
        "imgs", "denorm_images", "intrinsic", "extrinsics", "origin",
        "ray_o", "ray_d")}
    variables = jax.jit(lambda k: jmodel.init(
        k, batch, train=False, with_rays=True))(jax.random.PRNGKey(0))
    rng = np.random.RandomState(0)
    variables = {"params": _perturb(dict(variables["params"]), rng),
                 "batch_stats": _perturb(dict(variables["batch_stats"]),
                                         rng)}
    model = NerfDet(n_voxels=(8, 8, 4), voxel_size=(0.8, 0.8, 0.8),
                    n_samples=N_SAMPLES, near_far_range=NEAR_FAR,
                    meta=SceneMeta(ori_shape=ORI, img_shape=IMG,
                                   pad_shape=PAD))
    model.load_state_dict(from_jax_variables(variables), strict=True)
    return jmodel, variables, model.eval()


def test_forward_and_render_match_jax(toy):
    jmodel, variables, model = toy
    scene = _scene()
    s1, s2 = jax_host_rgb_stats(
        scene["denorm_images"], scene["intrinsic"], scene["extrinsics"],
        scene["origin"], (8, 8, 4), (0.8, 0.8, 0.8), ORI, IMG)
    scene = dict(scene, rgb_s1=s1, rgb_s2=s2)
    keys = ("imgs", "denorm_images", "intrinsic", "extrinsics", "origin",
            "rgb_s1", "rgb_s2", "ray_o", "ray_d")
    head_j, valid_j, out_j = jax.jit(lambda v, b: jmodel.apply(
        v, b, train=False, with_rays=True))(
        variables, {k: jnp.asarray(scene[k]) for k in keys})

    batch = {**api.device_batch(model, scene),
             **api.render_batch(model, scene)}
    with torch.inference_mode():
        head_t, valid_t, out_t = model(batch)
        features = model.extract_2d(batch["imgs"])
        alone = model.render(batch["ray_o"], batch["ray_d"], features,
                             batch["denorm_images"], scene["intrinsic"],
                             scene["extrinsics"])
    np.testing.assert_array_equal(valid_t.numpy(), np.asarray(valid_j))
    for s in range(3):
        for a, b in zip(head_t[s], head_j[s]):
            # exp'd box sizes reach 1e4 at FPN(256): relative
            b = np.asarray(b)
            assert (np.abs(a.numpy() - b).max()
                    <= 1e-4 * max(np.abs(b).max(), 1.0))
    mask_j = np.asarray(out_j["mask"])
    assert 0 < mask_j.mean() < 1  # both kinds of rays
    for out in (out_t, alone):
        assert out["rgb"].shape == (96, 3) and out["depth"].shape == (96,)
        np.testing.assert_allclose(out["rgb"].numpy(),
                                   np.asarray(out_j["rgb"]), rtol=0,
                                   atol=1e-4)
        np.testing.assert_allclose(out["depth"].numpy(),
                                   np.asarray(out_j["depth"]), rtol=0,
                                   atol=1e-3)
        np.testing.assert_array_equal(out["mask"].numpy(), mask_j)

    # the eval step carries the render through
    step = api.eval_step(model, batch, 100)
    np.testing.assert_array_equal(step["render_rgb"].numpy(),
                                  out_t["rgb"].numpy())
    assert "render_rgb" not in api.eval_step(
        model, api.device_batch(model, scene), 100)


def test_render_full_matches_jax(toy):
    jmodel, variables, model = toy
    scene = _scene(n_rand=300)  # 3 chunks of 128, the last padded
    keys = ("imgs", "denorm_images", "intrinsic", "extrinsics", "ray_o",
            "ray_d")
    rgb_j, depth_j = jax.jit(lambda v, b: jmodel.apply(
        v, b, 128, method=type(jmodel).render_full))(
        variables, {k: jnp.asarray(scene[k]) for k in keys})
    with torch.inference_mode():
        rgb_t, depth_t = model.render_full(api.render_batch(model, scene),
                                           chunk=128)
    assert rgb_t.shape == (300, 3) and depth_t.shape == (300,)
    np.testing.assert_allclose(rgb_t.numpy(), np.asarray(rgb_j), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(depth_t.numpy(), np.asarray(depth_j), rtol=0,
                               atol=1e-3)


def test_run_nvs_eval_matches_jax(toy, tmp_path):
    from nerfdet_tpu.data import (MultiViewPipeline, ScanNetMultiViewDataset,
                                  write_synthetic_scannet)

    jmodel, variables, model = toy
    root = write_synthetic_scannet(str(tmp_path / "data"), n_scenes=1,
                                   n_images=5, hw=IMG, splits=("val",),
                                   with_depth=True)
    ds = ScanNetMultiViewDataset(
        data_root=root, ann_file=f"{root}/scannet_infos_val.pkl",
        pipeline=MultiViewPipeline(n_images=4, img_scale=(40, 31),
                                   pad_size=PAD, margin=4,
                                   nerf_target_views=1, use_depth=True),
        test_mode=True, use_ray=True)
    want = jax_run_nvs_eval(jmodel, variables, ds, chunk=128,
                            progress=False)
    out_dir = str(tmp_path / "renders")
    got = api.run_nvs_eval(model, ds, chunk=128, out_dir=out_dir,
                           progress=False)
    assert set(got) == set(want) == {"psnr", "ssim", "rmse"}
    assert abs(got["psnr"] - want["psnr"]) <= 1e-3
    assert abs(got["ssim"] - want["ssim"]) <= 1e-4
    assert abs(got["rmse"] - want["rmse"]) <= 1e-4
    assert os.path.exists(os.path.join(out_dir, "scene_0", "view_0.png"))
