"""The port's VoteNet inference slice against the JAX package, whole.

The tiny VoteNet of ``tests/test_votenet.py`` (4 classes, 128/64/32/16
sampled points, 16 proposals) is built from one config dict by both
packages' builders; the JAX variables, with BatchNorm statistics and
affine terms perturbed from a numpy seed so every one matters, reach the
port through ``from_jax_variables``. On a 512-point cloud:

* seed indices are exact (FPS on the input xyz); so are the vote FPS's
  picks, which are held through the aggregated points (the sampled
  votes: one other pick would move a row by the cloud's scale);
* floats agree within 1e-4 relative to each output's largest magnitude:
  torch folds BatchNorm into one scale and shift where flax subtracts
  the mean first, and its CPU matmuls sum in another order than XLA's,
  so layers differ by a few ulps that the stacked MLPs and the
  normalisation by the vote feature's length carry forward (measured
  ~1e-6);
* the host tail returns the same selections and labels.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from nerfdet_tpu.models.builder import build_model as jax_build
from nerfdet_tpu.models.votenet import votenet_nms as jax_nms
from nerfdet_tpu.nn.vote_head import vote_head_get_bboxes as jax_bboxes

from nerfdet_tpu_torch import api
from nerfdet_tpu_torch.models.builder import build_model
from nerfdet_tpu_torch.nn.vote_head import vote_head_get_bboxes
from nerfdet_tpu_torch.utils.weight_convert import from_jax_variables

from tests.test_torch_session_cache import computed_once
from tests.test_votenet import synthetic_cloud

CFG = dict(
    type="VoteNet",
    backbone_cfg=dict(
        in_channels=4, num_points=(128, 64, 32, 16),
        radii=(0.3, 0.6, 1.0, 1.5), num_samples=(16, 16, 8, 8),
        sa_channels=((16, 16, 32), (32, 32, 64), (32, 32, 64),
                     (32, 32, 64)),
        fp_channels=((64, 64), (64, 64))),
    bbox_head=dict(num_classes=4, num_proposal=16, bbox_coder=dict(
        num_dir_bins=1, with_rot=False,
        mean_sizes=[[1.0, 1.0, 0.9]] * 4)))
RTOL = 1e-4


def _perturb(tree, rng):
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out[k] = _perturb(dict(v), rng)
            continue
        v = np.asarray(v, np.float32)
        if k in ("scale", "var"):
            v = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        elif k in ("bias", "mean"):
            v = (v + rng.normal(0, 0.1, v.shape)).astype(np.float32)
        out[k] = v
    return out


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    cloud = synthetic_cloud()[0]
    jmodel = jax_build(CFG)

    def init():  # once per test run
        variables = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(cloud))
        return _perturb(jax.tree_util.tree_map(np.asarray, dict(variables)),
                        np.random.RandomState(0))

    variables = computed_once(tmp_path_factory, "torch_votenet_variables",
                              init)
    model = build_model(CFG).eval()
    model.load_state_dict(from_jax_variables(variables), strict=True)
    yield jmodel, variables, model, cloud
    torch.set_num_threads(n)


def _close(got, want, key):
    want = np.asarray(want)
    got = got.numpy()
    assert got.shape == want.shape, key
    if want.dtype.kind in "iu":
        assert got.dtype == want.dtype, key
        np.testing.assert_array_equal(got, want, err_msg=key)
        return
    scale = max(float(np.abs(want).max()), 1e-30)
    assert np.abs(got - want).max() <= RTOL * scale, key


def _compare(got, want):
    assert set(got) == set(want)
    for key, w in want.items():
        if isinstance(w, (list, tuple)):
            for g, x in zip(got[key], w):
                _close(g, x, key)
        else:
            _close(got[key], w, key)


def test_votenet_forward_matches_jax(toy):
    jmodel, variables, model, cloud = toy
    want = jax.device_get(jax.jit(jmodel.apply)(variables,
                                                jnp.asarray(cloud)))
    with torch.inference_mode():
        got = model(torch.from_numpy(cloud))
    _compare(got, want)
    assert got["seed_indices"].dtype == torch.int32


@pytest.mark.parametrize("sample_mod", ["vote", "seed"])
def test_vote_head_matches_jax(toy, sample_mod):
    jmodel, variables, model, cloud = toy
    feat = jax.jit(lambda v, p: jmodel.apply(
        v, p, method=lambda m, x: m.backbone(x)))(variables,
                                                  jnp.asarray(cloud))
    want = jax.device_get(jax.jit(lambda v, f: jmodel.apply(
        v, f, method=lambda m, x: m.bbox_head(x, sample_mod=sample_mod)))(
        variables, feat))
    feat_t = {k: ([torch.tensor(np.asarray(x)) for x in v]
                  if isinstance(v, (list, tuple))
                  else torch.tensor(np.asarray(v)))
              for k, v in jax.device_get(feat).items()}
    with torch.inference_mode():
        got = model.bbox_head(feat_t, sample_mod=sample_mod)
    _compare(got, want)


def test_vote_head_get_bboxes(toy):
    jmodel, variables, model, cloud = toy
    preds = jax.jit(jmodel.apply)(variables, jnp.asarray(cloud))
    want = jax.device_get(jax_bboxes(preds, jmodel.bbox_coder))
    preds_t = {k: (torch.tensor(np.asarray(v))
                   if not isinstance(v, (list, tuple)) else None)
               for k, v in jax.device_get(preds).items()}
    got = vote_head_get_bboxes(preds_t, model.bbox_coder)
    for g, w, key in zip(got, want, ("boxes", "obj", "sem")):
        _close(g, w, key)


def test_single_cloud_test_matches_jax(toy):
    """The port's device path + host tail against the JAX forward +
    decode + ``votenet_nms`` (``run_indoor_points_eval``'s per-scene
    steps). ``score_thr=0`` keeps every non-empty NMS survivor."""
    jmodel, variables, model, cloud = toy
    boxes, obj, sem = jax.device_get(jax.jit(lambda v, p: jax_bboxes(
        jmodel.apply(v, p), jmodel.bbox_coder))(variables,
                                                jnp.asarray(cloud)))
    want = jax_nms(np.asarray(boxes), np.asarray(obj), np.asarray(sem),
                   cloud[:, :3], score_thr=0.0)
    got = api.single_cloud_test(model, cloud, score_thr=0.0)
    assert set(got) == set(want)
    assert len(want["labels_3d"]) > 0
    np.testing.assert_array_equal(got["labels_3d"], want["labels_3d"])
    for key in ("boxes_3d", "scores_3d"):
        _close(torch.from_numpy(got[key]), want[key], key)
