"""The port's detection-inference slice against the JAX package, whole.

One toy NeRF-Det (ResNet-50 at 32x40 images, three views, an 8x8x4
volume, three scales with one neck block each, five classes) is built in
JAX, its weights perturbed from a numpy seed and carried to the port
with ``from_jax_variables``. The JAX graph ``NerfDet.apply(...,
with_rays=True)`` + ``get_candidate_bboxes`` (density on, host rgb sums)
is held against the port's ``eval_step``: view counts exact, head
outputs and candidates within 1e-3 (as the whole-graph torch parity
test), the final NMS picks identical.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from nerfdet_tpu.data.synthetic import make_synthetic_scene
from nerfdet_tpu.models.nerfdet import NerfDet as JaxNerfDet
from nerfdet_tpu.models.nerfdet import SceneMeta as JaxSceneMeta
from nerfdet_tpu.nn.heads import get_candidate_bboxes as jax_candidates
from nerfdet_tpu.ops.voxel import host_rgb_stats as jax_host_rgb_stats

from nerfdet_tpu_torch import api
from nerfdet_tpu_torch.models.nerfdet import NerfDet, SceneMeta
from nerfdet_tpu_torch.utils.weight_convert import from_jax_variables

ORI, IMG, PAD = (128, 160), (31, 40), (32, 40)
N_VOX, VOX = (8, 8, 4), (0.8, 0.8, 0.8)
FPN_OUT, NECK3D_OUT, N_CLS, N_SCALES = 64, 16, 5, 3
NMS_PRE = 100


def _perturb(tree, rng, path=()):
    """Random norms, biases and head scales, so every parameter matters."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            out[k] = _perturb(dict(v), rng, path + (k,))
            continue
        v = np.asarray(v, np.float32)
        if k in ("scale", "var"):
            v = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        elif k in ("bias", "mean"):
            v = (v + rng.normal(0, 0.1, v.shape)).astype(np.float32)
        elif k == "scales":
            v = rng.uniform(0.8, 1.2, v.shape).astype(np.float32)
        elif k == "kernel" and "bbox_head" in path:
            v = v * 20.0  # normal(0.01) init leaves the head near-constant
        out[k] = v
    return out


def build_toy():
    """(jax_model, jax_variables, port_model, scene) at toy size."""
    jmodel = JaxNerfDet(
        backbone_depth=50, fpn_out_channels=FPN_OUT,
        neck3d_out_channels=NECK3D_OUT, neck3d_n_blocks=(1, 1, 1),
        n_classes=N_CLS, n_scales=N_SCALES, n_voxels=N_VOX,
        voxel_size=VOX, n_samples=16, n_rand=8, nerf_density=True,
        meta=JaxSceneMeta(ori_shape=ORI, img_shape=IMG, pad_shape=PAD))
    scene = make_synthetic_scene(seed=3, n_views=3, n_targets=1, hw=IMG,
                                 pad_hw=PAD, n_rand=8, n_boxes=2, max_gt=4,
                                 margin=2)
    variables = jax.jit(lambda k: jmodel.init(
        k, {k2: jnp.asarray(v) for k2, v in scene.items()}, train=False))(
        jax.random.PRNGKey(0))
    rng = np.random.RandomState(0)
    variables = {"params": _perturb(dict(variables["params"]), rng),
                 "batch_stats": _perturb(dict(variables["batch_stats"]),
                                         rng)}
    model = NerfDet(
        fpn_out_channels=FPN_OUT, neck3d_out_channels=NECK3D_OUT,
        neck3d_n_blocks=(1, 1, 1), n_classes=N_CLS, n_scales=N_SCALES,
        n_voxels=N_VOX, voxel_size=VOX, nerf_density=True,
        meta=SceneMeta(ori_shape=ORI, img_shape=IMG, pad_shape=PAD))
    model.load_state_dict(from_jax_variables(variables), strict=True)
    s1, s2 = jax_host_rgb_stats(
        scene["denorm_images"], scene["intrinsic"], scene["extrinsics"],
        scene["origin"], N_VOX, VOX, ORI, IMG)
    scene = dict(scene, rgb_s1=s1, rgb_s2=s2)
    return jmodel, variables, model.eval(), scene


@pytest.fixture(scope="module")
def toy():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield build_toy()
    torch.set_num_threads(n)


def _jax_batch(scene):
    keys = ("imgs", "denorm_images", "intrinsic", "extrinsics", "origin",
            "rgb_s1", "rgb_s2")
    return {k: jnp.asarray(scene[k]) for k in keys}


def test_eval_step_matches_jax_graph(toy):
    jmodel, variables, model, scene = toy
    batch = _jax_batch(scene)
    head_j, valid_j, render_j = jax.jit(lambda v, b: jmodel.apply(
        v, b, train=False, with_rays=True))(variables, batch)
    assert render_j is None  # no ray bundle: detection path only
    boxes_j, scores_j = jax_candidates(
        head_j, valid_j, jmodel.mlvl_points(batch["origin"]), NMS_PRE,
        N_CLS)

    tbatch = api.device_batch(model, scene)
    with torch.inference_mode():
        head_t, valid_t = model(tbatch)
    out = api.eval_step(model, tbatch, NMS_PRE)

    np.testing.assert_array_equal(valid_t.numpy(), np.asarray(valid_j))
    assert np.asarray(valid_j).max() >= 2
    for s in range(N_SCALES):
        for a, b in zip(head_t[s], head_j[s]):
            b = np.asarray(b)
            assert a.shape == b.shape
            assert np.abs(a.numpy() - b).max() <= 1e-3
    assert out["boxes"].shape == boxes_j.shape
    assert np.abs(out["boxes"].numpy() - np.asarray(boxes_j)).max() <= 1e-3
    assert np.abs(out["scores"].numpy()
                  - np.asarray(scores_j)).max() <= 1e-3

    from nerfdet_tpu.api import detections_from_candidates

    det_j = detections_from_candidates(np.asarray(boxes_j),
                                       np.asarray(scores_j), 0.0, 0.25)
    det_t = api.single_scene_test(model, scene, score_thr=0.0,
                                  iou_thr=0.25, nms_pre=NMS_PRE)
    assert len(det_t["labels_3d"]) > 1
    np.testing.assert_array_equal(det_t["labels_3d"], det_j["labels_3d"])
    np.testing.assert_allclose(det_t["scores_3d"], det_j["scores_3d"],
                               rtol=0, atol=1e-3)
    np.testing.assert_allclose(det_t["boxes_3d"], det_j["boxes_3d"],
                               rtol=0, atol=1e-3)


def test_density_modulation_is_on(toy):
    """The port's eval step follows the with_rays=True graph: switching
    the density off changes the head outputs."""
    _, _, model, scene = toy
    batch = api.device_batch(model, scene)
    with torch.inference_mode():
        on, _ = model(batch)
        model.nerf_density = False
        try:
            off, _ = model(batch)
        finally:
            model.nerf_density = True
    assert np.abs(on[0][2].numpy() - off[0][2].numpy()).max() > 1e-3


def test_density_needs_host_rgb_stats(toy):
    _, _, model, scene = toy
    batch = api.device_batch(model, scene)
    del batch["rgb_s1"], batch["rgb_s2"]
    with pytest.raises(NotImplementedError, match="rgb"):
        model(batch)
