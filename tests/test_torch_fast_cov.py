"""The fast_cov family (``configs/imvoxelnet/*fast_cov*``, NeRF-Det typed
``ImVoxelNet``) through the port, against the JAX package on the CPU.

* Every config that builds on ``_base_fast_cov.py`` builds in the port
  with the fields JAX's builder gives its NerfDet (routing, volume_type,
  nerf_mode, the Swin keys, the geometry), its data path without host
  streams (as JAX's dataset specs say); the four volume-mode configs
  (``nerf_density=True``) and the SUN RGB-D and outdoor ImVoxelNet
  configs without NeRF keys raise their named errors, and one case pins the JAX fault the first refusal
  names (``ScopeParamShapeError`` at the NeRF MLP's first layer).
* ``build_volume`` for each ``volume_type``, with and without the
  density, on random maps (the in-scan rgb stream, gated by depth):
  the mean and the cov within 1e-6, the counts exact, the volume the 3D
  neck reads within 1e-6 without the density and 1e-4 of its max with it
  (the density MLP's 256-wide products, which XLA sums in another
  order).
* One toy NeRF-Det (the Swin backbone at toy widths, 32x40 images, three
  views with depth maps, an 8x8x4 volume, ``cov_w_mean`` with the
  density, 24 rays) takes one train step in JAX (``scene_loss_terms``,
  ``reduce_loss_terms``, compiled) and in the port, with the device
  streams of the family: the rgb stream summed on the device, the render
  sampling the images in K2's eval form under grad at the same depths
  (``z_vals`` in the batch, no host rgb sums). Head outputs 1e-3, loss
  terms and grad_norm 1e-4 relative, every gradient within 1e-3 x its
  max, parameters after AdamW 1e-6 where the gradient is signal (as
  ``tests/test_torch_train.py``). JAX runs compiled, not op by op (~4
  min for this toy on the CPU): the seeds keep every 3D-neck ReLU input
  3e-6 from 0, checked below, as ``tests/test_torch_depth.py`` does. The
  weights are random from a numpy seed at the shapes ``jax.eval_shape``
  gives (no compiled init), carried over with ``from_jax_variables``.
* The fusion's cov cotangent (K1's backward with g2) through
  ``parallel/dist.all_reduce_sum``'s backward: two gloo ranks holding
  half the views each against one process holding all.

The JAX side runs once per test run (``computed_once``); the toy and its
reference are shared with ``tests/test_torch_volume_mode.py`` and
``tests/test_torch_swin.py``.
"""

import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nerfdet_tpu.api import scene_meta_from_config as jax_meta
from nerfdet_tpu.data.synthetic import make_synthetic_scene
from nerfdet_tpu.models.builder import build_model as jax_build_model
from nerfdet_tpu.models.nerfdet import NerfDet as JaxNerfDet
from nerfdet_tpu.models.nerfdet import SceneMeta as JaxSceneMeta
from nerfdet_tpu.train import optim as joptim
from nerfdet_tpu.train.step import reduce_loss_terms as jax_reduce
from nerfdet_tpu.train.step import scene_loss_terms as jax_scene_terms

from nerfdet_tpu_torch import api
from nerfdet_tpu_torch.config import Config
from nerfdet_tpu_torch.data import ray_stats
from nerfdet_tpu_torch.data.dataset import (ray_stats_spec_from_config,
                                            rgb_stats_spec_from_config)
from nerfdet_tpu_torch.models.builder import build_model, routes_to_nerfdet
from nerfdet_tpu_torch.models.nerfdet import NerfDet, SceneMeta
from nerfdet_tpu_torch.ops import voxel as tvox
from nerfdet_tpu_torch.tools import train as train_cli
from nerfdet_tpu_torch.train import optim as toptim
from nerfdet_tpu_torch.train.step import make_train_step
from nerfdet_tpu_torch.utils.weight_convert import from_jax_variables

from tests.test_torch_ddp import _spawn
from tests.test_torch_session_cache import computed_once
from tests.test_torch_train import _port_tree, _ReluMargin, _rel

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAMILY = sorted(
    p for p in glob.glob(os.path.join(ROOT, "configs", "imvoxelnet", "*.py"))
    if "_base_fast_cov" in open(p).read())
VOLUME_DENSITY = {  # nerf_mode='volume' with nerf_density=True
    "imvoxelnet_scannet_fast_cov_w_mean_volume_renderrgb_volume_mode.py",
    "imvoxelnet_scannet_fast_cov_w_mean_volume_renderrgb_volume_mode_1021_.py",
    "imvoxelnet_scannet_fast_cov_w_mean_volume_renderrgb_volume_depth_"
    "supervision.py",
    "imvoxelnet_scannet_fast_cov_w_mean_volume_renderrgb_volume_mode_"
    "votenetschedule.py"}

ORI, IMG, PAD = (128, 160), (31, 40), (32, 40)
N_RAND, N_SAMPLES, NEAR_FAR = 24, 16, (0.2, 8.0)
SWIN = dict(embed_dims=8, patch_size=4, window_size=3, mlp_ratio=2.0,
            depths=(2, 2, 2, 2), num_heads=(1, 1, 2, 2),
            out_indices=(0, 1, 2, 3), qkv_bias=True)
TOY = dict(backbone_type="SwinTransformer", backbone_cfg=SWIN,
           fpn_in_channels=(8, 16, 32, 64), fpn_out_channels=32,
           neck3d_out_channels=16, neck3d_n_blocks=(1, 1, 1), n_classes=5,
           n_scales=3, n_voxels=(8, 8, 4), voxel_size=(0.8, 0.8, 0.8),
           aabb=((-3.2, -3.2, -1.1), (3.2, 3.2, 2.1)), n_samples=N_SAMPLES,
           n_rand=N_RAND, near_far_range=NEAR_FAR)
OPTIMIZER = dict(type="AdamW", lr=2e-4, weight_decay=1e-4,
                 paramwise_cfg=dict(custom_keys=dict(
                     backbone=dict(lr_mult=0.1, decay_mult=1.0))))
SCENE_KEYS = ("imgs", "denorm_images", "intrinsic", "extrinsics", "origin",
              "depth", "gt_boxes", "gt_labels", "gt_mask", "ray_o", "ray_d",
              "gt_rgb", "gt_depth", "z_vals")
# seeds: (scene, weights) keeping the 3D neck's ReLU inputs 3e-6 from 0
# and the rendered density alive
STEP_SEEDS = {"cov_w_mean": (3, 0)}


@pytest.fixture(autouse=True, scope="module")
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------
# the toy, shared with test_torch_volume_mode.py and test_torch_swin.py
# ---------------------------------------------------------------------

def jax_toy(**kw) -> JaxNerfDet:
    return JaxNerfDet(**dict(TOY, meta=JaxSceneMeta(
        ori_shape=ORI, img_shape=IMG, pad_shape=PAD), **kw))


def port_toy(**kw) -> NerfDet:
    """The toy in the port, with the family's device streams."""
    return NerfDet(**dict(TOY, meta=SceneMeta(
        ori_shape=ORI, img_shape=IMG, pad_shape=PAD), host_streams=False,
        **kw))


def toy_scene(seed, n_views=3):
    """A synthetic scene with depth maps (its intrinsic at ``ori_shape``)
    and ``N_RAND`` rays with stratified depths ``z_vals``."""
    s = make_synthetic_scene(seed=seed, n_views=n_views, n_targets=1, hw=IMG,
                             pad_hw=PAD, n_rand=N_RAND, n_boxes=2, max_gt=4,
                             margin=2, with_depth=True)
    s["intrinsic"] = s["intrinsic"].copy()
    s["intrinsic"][:2] *= np.float32(ORI[0] / IMG[0])
    s["z_vals"] = ray_stats.host_sample_z(np.random.RandomState(seed),
                                          N_RAND, *NEAR_FAR, N_SAMPLES)
    return s


def random_variables(jmodel, scene, seed):
    """Random JAX variables at the shapes of the model's init (traced by
    ``jax.eval_shape``, not compiled): kernels normal(1/sqrt(fan_in))
    (the head's 0.05), biases and norm means normal(0.1), norm scales and
    variances uniform(0.5, 1.5), the head's scales uniform(0.8, 1.2),
    relative position bias tables normal(0.02)."""
    batch = {k: jnp.asarray(scene[k]) for k in SCENE_KEYS}
    shapes = jax.eval_shape(lambda k: jmodel.init(k, batch, train=False),
                            jax.random.PRNGKey(0))
    rng = np.random.RandomState(seed)

    def leaf(path, sd):
        names = [str(getattr(p, "key", p)) for p in path]
        name, shape = names[-1], sd.shape
        if name == "kernel":
            std = (0.05 if "bbox_head" in names
                   else float(np.prod(shape[:-1])) ** -0.5)
            v = rng.normal(0.0, std, shape)
        elif name in ("scale", "var"):
            v = rng.uniform(0.5, 1.5, shape)
        elif name in ("bias", "mean"):
            v = rng.normal(0.0, 0.1, shape)
        elif name == "scales":
            v = rng.uniform(0.8, 1.2, shape)
        elif name == "relative_position_bias_table":
            v = rng.normal(0.0, 0.02, shape)
        else:
            raise KeyError("/".join(names))
        return np.asarray(v, np.float32)

    tree = jax.tree_util.tree_map_with_path(leaf, shapes)
    return {"params": _plain(tree["params"]),
            "batch_stats": _plain(tree["batch_stats"])}


def _plain(tree):
    return {k: _plain(v) if hasattr(v, "items") else v
            for k, v in tree.items()}


class _HeadsOf:
    """The JAX model as ``scene_loss_terms`` sees it, keeping the head
    outputs of its forward (so one compiled forward gives both)."""

    def __init__(self, model):
        self.model, self.heads = model, None

    def __getattr__(self, name):
        return getattr(self.model, name)

    def apply(self, *args, **kwargs):
        out = self.model.apply(*args, **kwargs)
        self.heads = out[0][0]
        return out


def _adamw_step(params, grads):
    """JAX's optimizer (``joptim.build_optimizer``, no clip) for one update
    of ``params``: the backbone's leaves and the others each flattened
    into one vector under their own label (AdamW acts element by
    element), so one small graph compiles for any model."""
    leaves, tree = jax.tree_util.tree_flatten_with_path(params)
    backbone = ["backbone" in str(path[0]) for path, _ in leaves]
    g_leaves = jax.tree_util.tree_leaves(grads)

    def packed(values):
        return {name: {"flat": jnp.concatenate([
            jnp.ravel(v) for v, b in zip(values, backbone) if b == keep])}
            for name, keep in (("backbone", True), ("neck", False))}

    p = packed([v for _, v in leaves])
    tx = joptim.build_optimizer(p, OPTIMIZER)
    updates, _ = jax.jit(tx.update)(packed(g_leaves), tx.init(p), p)
    new = optax.apply_updates(p, updates)
    offsets = {"backbone": 0, "neck": 0}
    out = []
    for (_, v), b in zip(leaves, backbone):
        name = "backbone" if b else "neck"
        n = int(np.prod(np.shape(v)))
        out.append(new[name]["flat"][offsets[name]:offsets[name] + n]
                   .reshape(np.shape(v)))
        offsets[name] += n
    return jax.tree_util.tree_unflatten(tree, out)


def jax_step_reference(jmodel, variables, scene):
    """JAX's train-mode head outputs, loss terms, gradients and the
    parameters after one AdamW update (no clip) on ``scene``, compiled."""
    scene_j = {k: jnp.asarray(scene[k]) for k in SCENE_KEYS}
    stats = variables["batch_stats"]

    def loss_fn(params):
        model = _HeadsOf(jmodel)
        terms, _ = jax_scene_terms(model, params, stats, scene_j,
                                   jax.random.PRNGKey(0),
                                   depth_supervise=True, use_nerf_mask=True)
        loss, metrics = jax_reduce(jax.tree_util.tree_map(
            lambda t: t[None], terms))
        return loss, (metrics, model.heads)

    @jax.jit
    def run(params):
        (_, (metrics, heads)), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(params)
        metrics = dict(metrics, grad_norm=optax.global_norm(grads))
        return metrics, heads, grads

    params = variables["params"]
    metrics, heads, grads = run(params)
    new = _adamw_step(params, grads)
    zero = jax.tree_util.tree_map(np.zeros_like, stats)
    return dict(
        variables=variables,
        metrics={k: np.asarray(v) for k, v in metrics.items()},
        heads=[[np.asarray(t) for t in s] for s in heads],
        grads=_port_tree(grads, zero), params=_port_tree(new, zero))


def port_step(model, start, scene):
    """The port's head outputs (train mode, before the step), metrics,
    gradients and state after one step (no clip) on ``scene`` with the
    family's device streams and the scene's ``z_vals``."""
    model.load_state_dict(start, strict=True)
    model.train()
    batch = api.train_batch(model, [scene])
    assert not any(k in batch[0] for k in ("rgb_s1", "ray_s1u", "z_vals"))
    batch[0]["z_vals"] = torch.from_numpy(scene["z_vals"])
    with torch.no_grad():
        heads, _, _ = model(batch[0])
    model.load_state_dict(start, strict=True)  # the running statistics
    step = make_train_step(model, toptim.build_optimizer(model, OPTIMIZER),
                           depth_supervise=True)
    metrics = step(batch)
    grads = {n: (torch.zeros_like(p) if p.grad is None else p.grad.clone())
             for n, p in model.named_parameters()}
    return dict(batch=batch[0], heads=heads, metrics=metrics, grads=grads,
                state={k: v.clone() for k, v in model.state_dict().items()})


def step_case(tmp_path_factory, name, seeds, **kw):
    """JAX's reference (once per test run) and the port's step of the
    toy built with ``kw``."""
    scene_seed, weight_seed = seeds

    def compute():
        jmodel = jax_toy(**kw)
        scene = toy_scene(scene_seed)
        return jax_step_reference(
            jmodel, random_variables(jmodel, scene, weight_seed), scene)

    ref = computed_once(tmp_path_factory, f"torch_fast_cov_{name}", compute)
    model = port_toy(**kw)
    start = from_jax_variables(ref["variables"])
    return dict(ref=ref, model=model, start=start,
                port=port_step(model, start, toy_scene(scene_seed)))


def check_heads(port, ref, tol=1e-3):
    for s, (got, want) in enumerate(zip(port["heads"], ref["heads"])):
        for a, b in zip(got, want):
            assert a.shape == b.shape, s
            assert float(np.abs(a.numpy() - b).max()) <= tol, s


def check_metrics(got, want, keys):
    assert float(got["n_pos"]) == float(want["n_pos"]) > 0
    for k in keys:
        assert _rel(got[k], want[k]) <= 1e-4, (k, got[k], want[k])


def check_gradients(grads, want):
    assert set(grads) == {k for k in want if not k.endswith((
        "running_mean", "running_var", "num_batches_tracked"))}
    for name, g in grads.items():
        w = want[name]
        assert g.shape == w.shape, name
        tol = 1e-3 * float(w.abs().max())
        assert float((g - w).abs().max()) <= tol, name


def check_parameters(model, start, state, want, grads):
    """1e-6 where the JAX gradient is at least 1e-3 of its tensor's max,
    else 2 lr mult + 1e-6 (Adam's first step is lr g / (|g| + eps)); no
    parameter of the toy is frozen (its backbone is the Swin)."""
    labels = toptim.param_labels(model)
    assert "frozen" not in labels.values()
    live = moved = 0
    for name, label in labels.items():
        g = grads[name].abs()
        mult = 0.1 if label == "backbone" else 1.0
        err = (state[name] - want[name]).abs()
        signal = g >= 1e-3 * float(g.max())
        if float(g.max()) > 0:
            assert float(err[signal].max()) <= 1e-6, name
        assert float(err.max()) <= 2 * 2e-4 * mult + 1e-6, name
        live += float(g.max()) > 0
        moved += float(g.max()) > 0 and not torch.equal(state[name],
                                                        start[name])
    # every parameter with a gradient moved (the FPN levels the detector
    # does not read only decay, by less than their rounding)
    assert moved == live > 100


def check_relu_margin(model, start, batch):
    """No ReLU input of the 3D neck within 3e-6 of 0 (the condition the
    gradient tolerance rests on, as in tests/test_torch_train.py)."""
    import copy

    model.load_state_dict(start)
    model.train()
    seen = {}
    hook = model.neck_3d.register_forward_pre_hook(
        lambda m, args: seen.setdefault("x", args[0].detach()))
    with torch.no_grad():
        model(batch)
    hook.remove()
    with torch.no_grad(), _ReluMargin() as mode:
        copy.deepcopy(model.neck_3d)(seen["x"])
    assert 3e-6 <= mode.least < float("inf")


# ---------------------------------------------------------------------
# the configs
# ---------------------------------------------------------------------

def test_the_family_has_its_56_configs():
    assert len(FAMILY) == 56
    assert VOLUME_DENSITY <= {os.path.basename(p) for p in FAMILY}


@pytest.mark.parametrize(
    "path", [p for p in FAMILY if os.path.basename(p) not in VOLUME_DENSITY],
    ids=lambda p: os.path.basename(p)[len("imvoxelnet_scannet_"):-3])
def test_fast_cov_config_builds_with_the_jax_fields(path):
    cfg = Config.fromfile(path)
    assert cfg.model["type"] == "ImVoxelNet" and routes_to_nerfdet(cfg.model)
    want = jax_build_model(cfg.to_dict()["model"], meta=jax_meta(cfg))
    with torch.device("meta"):  # the modules without their weights
        model = build_model(cfg.model, meta=api.scene_meta_from_config(cfg))
    assert isinstance(want, JaxNerfDet) and isinstance(model, NerfDet)
    for field in ("volume_type", "nerf_mode", "nerf_density", "n_voxels",
                  "voxel_size", "near_far_range", "n_samples", "n_rand",
                  "n_classes", "n_scales", "head_limit",
                  "head_centerness_topk"):
        w = getattr(want, field)
        assert getattr(model, field) == (
            tuple(w) if isinstance(w, (list, tuple)) else w), field
    assert model.aabb == tuple(tuple(float(x) for x in b) for b in want.aabb)
    assert tuple(model.meta.__dict__.values()) == tuple(
        want.meta.__dict__.values())
    assert model.nerf_mlp.mlp.base.hidden_layers[0].in_features == 63 + (
        want.nerf_feature_dim + (6 if want.nerf_mode == "image" else 0))
    if want.backbone_type == "SwinTransformer":
        assert type(model.backbone).__name__ == "SwinTransformer"
        assert model.backbone.depths == tuple(want.backbone_cfg["depths"])
        assert model.backbone.window_size == want.backbone_cfg[
            "window_size"]
    else:
        assert len(model.backbone.layer3) == {50: 6, 101: 23}[
            want.backbone_depth]
    # the JAX data path ships no host streams for the ImVoxelNet type
    assert not model.host_streams
    assert rgb_stats_spec_from_config(cfg) is None
    assert ray_stats_spec_from_config(cfg) is None
    train_cli.refuse_unported(train_cli.parse_args([path]), cfg)


@pytest.mark.parametrize("name", sorted(VOLUME_DENSITY) + ["jax_init"])
def test_volume_mode_with_density_is_refused_for_the_jax_fault(name):
    """The four shipped volume-mode configs set ``nerf_density=True``,
    which the JAX package cannot initialize: the port refuses them by
    name; the ``jax_init`` case pins that fault."""
    if name == "jax_init":
        scene = toy_scene(0)
        jmodel = jax_toy(nerf_mode="volume", nerf_density=True)
        batch = {k: jnp.asarray(scene[k]) for k in SCENE_KEYS}
        with pytest.raises(Exception) as err:
            jax.eval_shape(lambda k: jmodel.init(k, batch, train=False),
                           jax.random.PRNGKey(0))
        assert type(err.value).__name__ == "ScopeParamShapeError"
        assert "nerf_mlp/mlp/base/hidden_0" in str(err.value)
        return
    path = os.path.join(ROOT, "configs", "imvoxelnet", name)
    cfg = Config.fromfile(path)
    assert cfg.model["nerf_mode"] == "volume" and cfg.model["nerf_density"]
    for fn in (lambda: build_model(cfg.model),
               lambda: train_cli.refuse_unported(
                   train_cli.parse_args([path]), cfg)):
        with pytest.raises(NotImplementedError,
                           match="ScopeParamShapeError.*ROADMAP §1 item 2.2"):
            fn()
    cfg.merge_from_options({"model.nerf_density": False})
    with torch.device("meta"):
        assert build_model(cfg.model).nerf_mode == "volume"


@pytest.mark.parametrize("name", ["imvoxelnet_sunrgbd.py",
                                  "imvoxelnet_kitti.py"])
def test_imvoxelnet_without_nerf_keys_is_refused(name):
    """Of the ImVoxelNet configs without NeRF keys the ScanNet and SUN
    RGB-D ones build the indoor ImVoxelNet, not NeRF-Det
    (``tests/test_torch_imvoxelnet.py``, ``tests/test_torch_sunrgbd.py``)
    and train; the outdoor ones are refused by name."""
    path = os.path.join(ROOT, "configs", "imvoxelnet", name)
    cfg = Config.fromfile(path)
    assert not routes_to_nerfdet(cfg.model)
    if "sunrgbd" in name:
        with torch.device("meta"):
            assert type(build_model(cfg.model)).__name__ == \
                "IndoorImVoxelNet"
        train_cli.refuse_unported(train_cli.parse_args([path]), cfg)
        return
    with pytest.raises(NotImplementedError, match="ROADMAP §1 item 3"):
        build_model(cfg.model)
    with pytest.raises(NotImplementedError, match="ROADMAP §1 item 3"):
        train_cli.refuse_unported(train_cli.parse_args([path]), cfg)


# ---------------------------------------------------------------------
# volume_type in build_volume
# ---------------------------------------------------------------------

def _volume_case(n_views=3):
    rng = np.random.RandomState(5)
    scene = toy_scene(4, n_views)
    feats = rng.randn(n_views, PAD[0] // 4, PAD[1] // 4, 32).astype(
        np.float32)
    return scene, feats


def _jax_volumes():
    scene, feats = _volume_case()
    out = {}
    for density in (False, True):
        for vt in ("mean", "cov", "cov_w_mean"):
            jmodel = jax_toy(volume_type=vt, nerf_density=density)
            variables = random_variables(jmodel, scene, 1)
            fn = jax.jit(lambda v, f: jmodel.apply(
                v, f, method=lambda m, f: m.build_volume(
                    f, jnp.asarray(scene["denorm_images"]),
                    jnp.asarray(scene["intrinsic"]),
                    jnp.asarray(scene["extrinsics"]),
                    jnp.asarray(scene["origin"]),
                    depth=jnp.asarray(scene["depth"]))))
            vol = fn(variables, jnp.asarray(feats))
            out[f"{vt}_{density}"] = dict(
                variables=variables,
                **{k: np.asarray(vol[k]) for k in (
                    "det_volume", "valid", "mean", "cov")})
    return out


def test_build_volume_volume_type_matches_jax(tmp_path_factory):
    """Each volume_type with and without the density (one test: the six
    JAX references come from one computation, which a worker would
    otherwise wait on for each case)."""
    refs = computed_once(tmp_path_factory, "torch_fast_cov_volumes",
                         _jax_volumes)
    scene, feats = _volume_case()
    for density in (False, True):
        for vt in ("mean", "cov", "cov_w_mean"):
            _check_volume(refs[f"{vt}_{density}"], scene, feats, vt,
                          density)


def _check_volume(want, scene, feats, vt, density):
    case = f"{vt}, density {density}"
    model = port_toy(volume_type=vt, nerf_density=density)
    model.load_state_dict(from_jax_variables(want["variables"]), strict=True)
    before = tvox.rgb_carry.launches
    with torch.no_grad():
        got = model.build_volume(
            torch.from_numpy(feats), scene["intrinsic"], scene["extrinsics"],
            scene["origin"],
            denorm_images=torch.from_numpy(scene["denorm_images"]),
            depth=torch.from_numpy(scene["depth"]))
    assert tvox.rgb_carry.launches == before  # the CPU's plain version
    np.testing.assert_array_equal(got["valid"].numpy(), want["valid"])
    assert want["valid"].max() >= 2 and (want["valid"] == 0).any()
    for k in ("mean", "cov") + (() if density else ("det_volume",)):
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=0,
                                   atol=1e-6, err_msg=f"{case}: {k}")
    if density:  # the density MLP's 256-wide products, summed otherwise
        np.testing.assert_allclose(
            got["det_volume"].numpy(), want["det_volume"], rtol=0,
            atol=1e-4 * np.abs(want["det_volume"]).max(), err_msg=case)
    observed = want["valid"] > 0
    expect = {"mean": want["mean"], "cov": want["cov"],
              "cov_w_mean": want["mean"] * want["cov"]}[vt]
    if not density:  # the chosen statistic, unmodulated, where observed
        np.testing.assert_array_equal(want["det_volume"][observed],
                                      expect[observed], err_msg=case)


# ---------------------------------------------------------------------
# the cov_w_mean train step
# ---------------------------------------------------------------------

def test_cov_w_mean_step_matches_jax(tmp_path_factory):
    """Heads, loss terms, every gradient, the parameters after the
    update, and the condition the gradient tolerance rests on (one test:
    the step's JAX reference is computed once, and a worker holding any
    of these checks would otherwise wait on it)."""
    case = step_case(tmp_path_factory, "cov_w_mean_step",
                     STEP_SEEDS["cov_w_mean"], volume_type="cov_w_mean",
                     nerf_density=True)
    port, ref = case["port"], case["ref"]
    check_heads(port, ref)
    assert set(port["metrics"]) == set(ref["metrics"])
    assert float(ref["metrics"]["loss_nvs"]) > 0
    assert float(ref["metrics"]["loss_depth"]) > 0
    check_metrics(port["metrics"], ref["metrics"], (
        "loss", "loss_cls", "loss_bbox", "loss_centerness", "loss_nvs",
        "loss_depth", "grad_norm"))
    check_gradients(port["grads"], ref["grads"])
    # through K1's backward (both cotangents) into the FPN and the Swin
    # backbone, the mapped stream, and through K2's into the field
    for name in ("mapping.0.weight", "neck.lateral_convs.0.conv.weight",
                 "backbone.stage0_block1.attn.qkv.weight",
                 "backbone.patch_embed.weight",
                 "nerf_mlp.mlp.rgb_layer.output_layer.weight"):
        assert float(port["grads"][name].abs().max()) > 0, name
    check_parameters(case["model"], case["start"], port["state"],
                     ref["params"], ref["grads"])
    check_relu_margin(case["model"], case["start"], port["batch"])


# ---------------------------------------------------------------------
# the cov cotangent over a views group
# ---------------------------------------------------------------------

def _cov_case():
    scene, feats = _volume_case(n_views=4)
    rng = np.random.RandomState(9)
    n = int(np.prod(TOY["n_voxels"]))
    w = (rng.randn(32, 8) / np.sqrt(32)).astype(np.float32)
    b = rng.randn(8).astype(np.float32)
    g = rng.randn(n, 32).astype(np.float32)
    gg = rng.randn(n, 22).astype(np.float32)
    return scene, feats, w, b, g, gg


def _cov_grads(lo, hi, group=None):
    """d features (views lo:hi), d W, d b of the cov_w_mean statistic and
    the global volume of the fusion, over the views ``group``."""
    scene, feats, w, b, g, gg = _cov_case()
    f = torch.from_numpy(feats[lo:hi]).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    bt = torch.from_numpy(b).requires_grad_()
    points = tvox.get_points(TOY["n_voxels"], TOY["voxel_size"],
                             scene["origin"]).reshape(-1, 3)
    proj = tvox.compute_projection(scene["intrinsic"],
                                   scene["extrinsics"][lo:hi],
                                   ORI[0] / (IMG[0] / 4))
    proj_e = tvox.compute_projection(scene["intrinsic"],
                                     scene["extrinsics"][lo:hi],
                                     ORI[0] / IMG[0])
    mean, cov, _, g_mean, g_cov = tvox.fused_mean_cov(
        f, points, proj, depth=torch.from_numpy(scene["depth"][lo:hi]),
        voxel_size_z=TOY["voxel_size"][2], image_hw=(IMG[0] // 4,
                                                     IMG[1] // 4),
        extra_features=torch.from_numpy(scene["denorm_images"][lo:hi]),
        extra_projection=proj_e, extra_image_hw=IMG, mapped_kernel=wt,
        mapped_bias=bt, view_group=group)
    loss = ((mean * cov) * torch.from_numpy(g)).sum() + (
        torch.cat([g_mean, g_cov], -1) * torch.from_numpy(gg)).sum()
    loss.backward()
    return f.grad.numpy(), wt.grad.numpy(), bt.grad.numpy()


def _cov_rank(rank, world, port, out):
    from nerfdet_tpu_torch.parallel import dist as pdist

    torch.set_num_threads(1)
    with pdist.process_group("cpu", f"localhost:{port}", world, rank) as (
            _, group):
        got = _cov_grads(2 * rank, 2 * rank + 2, group)
    np.savez(os.path.join(out, f"rank{rank}.npz"), *got)


def test_cov_cotangent_over_two_views_ranks_matches_one_process(tmp_path):
    """Two gloo ranks (views 0-1 and 2-3) against one process (views
    0-3). Every rank forms the same loss from the group's sums, whose
    backward sums the ranks' cotangents (``train/step.py``): a rank's d
    features is twice the one-process slice, and the ranks' mean of d W
    and d b (the step's mean over the ranks) the one-process ones."""
    want = _cov_grads(0, 4)
    _spawn(_cov_rank, 2, str(tmp_path))
    ranks = [np.load(tmp_path / f"rank{r}.npz") for r in (0, 1)]
    for r in (0, 1):
        np.testing.assert_allclose(ranks[r]["arr_0"] / 2,
                                   want[0][2 * r:2 * r + 2], rtol=0,
                                   atol=1e-5)
    for i in (1, 2):
        np.testing.assert_allclose(
            (ranks[0][f"arr_{i}"] + ranks[1][f"arr_{i}"]) / 2, want[i],
            rtol=0, atol=1e-5 * np.abs(want[i]).max())
    assert np.abs(want[0]).max() > 0
