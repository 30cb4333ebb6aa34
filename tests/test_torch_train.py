"""The port's detection train step against the JAX package.

One toy NeRF-Det (ResNet-50 at 32x40 images, three views, an 8x8x4
volume, FPN 64, neck 16, three scales, five classes), its JAX weights
perturbed from a numpy seed and carried to the port with
``from_jax_variables``, takes one step on a batch of two scenes (host rgb
sums, no rays) through JAX ``make_train_step(rgb_supervision=False)`` and
through the port's step, from the config's optimizer (AdamW 2e-4, wd
1e-4, backbone x0.1, clip 35, which acts here).

Tolerances, each for its reason:

* n_pos exact (integer counts of the targets);
* loss terms and grad_norm 1e-4 relative (float32, other summation
  orders);
* every gradient within 1e-3 x the max |g| of the JAX gradient of that
  tensor. The ReLU's gradient jumps at 0, so the toy's seeds keep every
  ReLU input of the 3D neck at least 3e-6 from it (checked below), above
  the rounding by which the two forwards differ there, and the JAX step
  runs op by op (``jax.disable_jit``): XLA's compiled graph on the CPU
  rounds the det volume differently enough to move ReLU inputs across 0,
  and some 3D-neck gradients then miss this tolerance by far; op by op,
  JAX and the port both agree with a float64 run of the port. The seeds
  also keep the density alive, so gradient crosses the fusion. The
  op-by-op step makes this file the suite's slowest (~4 min on 2
  threads);
* BatchNorm running statistics 1e-5 (flax's variance is E[x^2] - E[x]^2,
  the port's two-pass);
* updated parameters 1e-6 absolute where |g_jax| >= 1e-3 x the tensor's
  max; elsewhere 2 lr mult + 1e-6, since Adam's first step is lr g /
  (|g| + eps), whose sign is noise where g is;
* frozen parameters bitwise unchanged; parameter labels equal.

The JAX side runs once per test run, with the joint toy's of
``tests/test_torch_train_nvs.py`` (``jax_step_references``: the first
pytest-xdist worker to need it computes it, the others load it); its raw
gradients are read from an identity transform chained in front of the
optimizer.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

from nerfdet_tpu.data.synthetic import make_synthetic_scene
from nerfdet_tpu.models.nerfdet import NerfDet as JaxNerfDet
from nerfdet_tpu.models.nerfdet import SceneMeta as JaxSceneMeta
from nerfdet_tpu.nn import heads as jheads
from nerfdet_tpu.nn import losses as jlosses
from nerfdet_tpu.ops.voxel import host_rgb_stats as jax_host_rgb_stats
from nerfdet_tpu.train import optim as joptim
from nerfdet_tpu.train import TrainState, make_train_step as jax_train_step

from nerfdet_tpu_torch import api
from nerfdet_tpu_torch.models.nerfdet import NerfDet, SceneMeta
from nerfdet_tpu_torch.nn import heads as theads
from nerfdet_tpu_torch.nn import losses as tlosses
from nerfdet_tpu_torch.train import optim as toptim
from nerfdet_tpu_torch.train.step import make_train_step
from nerfdet_tpu_torch.utils.weight_convert import from_jax_variables

from tests.test_torch_nerfdet import _perturb
from tests.test_torch_session_cache import computed_once

ORI, IMG, PAD = (128, 160), (31, 40), (32, 40)
N_VOX, VOX = (8, 8, 4), (0.8, 0.8, 0.8)
FPN_OUT, NECK3D_OUT, N_CLS, N_SCALES = 64, 16, 5, 3
PERTURB_SEED, SCENE_SEEDS = 6, (3, 5)
OPTIMIZER = dict(type="AdamW", lr=2e-4, weight_decay=1e-4,
                 paramwise_cfg=dict(custom_keys=dict(
                     backbone=dict(lr_mult=0.1, decay_mult=1.0))))
MAX_NORM = 35.0
JAX_KEYS = ("imgs", "denorm_images", "intrinsic", "extrinsics", "origin",
            "rgb_s1", "rgb_s2", "gt_boxes", "gt_labels", "gt_mask")


def _scene(seed):
    s = make_synthetic_scene(seed=seed, n_views=3, n_targets=1, hw=IMG,
                             pad_hw=PAD, n_rand=8, n_boxes=2, max_gt=4,
                             margin=2)
    s1, s2 = jax_host_rgb_stats(s["denorm_images"], s["intrinsic"],
                                s["extrinsics"], s["origin"], N_VOX, VOX,
                                ORI, IMG)
    return dict(s, rgb_s1=s1, rgb_s2=s2)


def _port_model():
    return NerfDet(
        fpn_out_channels=FPN_OUT, neck3d_out_channels=NECK3D_OUT,
        neck3d_n_blocks=(1, 1, 1), n_classes=N_CLS, n_scales=N_SCALES,
        n_voxels=N_VOX, voxel_size=VOX, nerf_density=True,
        meta=SceneMeta(ori_shape=ORI, img_shape=IMG, pad_shape=PAD))


def _capture():
    """An identity transform whose state is the last gradients."""
    return optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda u, s, p=None: (u, u))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port_tree(params, batch_stats):
    return from_jax_variables({"params": _np_tree(params),
                               "batch_stats": _np_tree(batch_stats)})


def _port_step(model, start, scenes, max_norm):
    """One port step from the state_dict ``start``: returns the metrics,
    the (clipped) gradients and the state after the step."""
    model.load_state_dict(start, strict=True)
    opt = toptim.build_optimizer(model, OPTIMIZER,
                                 grad_clip=dict(max_norm=max_norm))
    step = make_train_step(model, opt, rgb_supervision=False)
    metrics = step(api.train_batch(model, scenes))
    grads = {n: (torch.zeros_like(p) if p.grad is None else p.grad.clone())
             for n, p in model.named_parameters()}
    return metrics, grads, copy.deepcopy(model.state_dict())


def _jax_model():
    return JaxNerfDet(
        backbone_depth=50, fpn_out_channels=FPN_OUT,
        neck3d_out_channels=NECK3D_OUT, neck3d_n_blocks=(1, 1, 1),
        n_classes=N_CLS, n_scales=N_SCALES, n_voxels=N_VOX,
        voxel_size=VOX, n_samples=16, n_rand=8, nerf_density=True,
        meta=JaxSceneMeta(ori_shape=ORI, img_shape=IMG, pad_shape=PAD))


def toy_variables(tmp_path_factory):
    """The toy's perturbed JAX variables, once per test run
    (``tests/test_torch_ddp.py`` trains from them too)."""
    def compute():
        init_scene = _scene(0)  # with rays: the tree holds the render head
        variables = jax.jit(lambda k: _jax_model().init(
            k, {k2: jnp.asarray(v) for k2, v in init_scene.items()},
            train=False))(jax.random.PRNGKey(0))
        rng = np.random.RandomState(PERTURB_SEED)
        return {"params": _perturb(dict(variables["params"]), rng),
                "batch_stats": _perturb(dict(variables["batch_stats"]),
                                        rng)}
    return computed_once(tmp_path_factory, "torch_train_variables", compute)


def _jax_reference(variables, scenes):
    """JAX's step on the toy, op by op, and what the tests read of it."""
    jmodel = _jax_model()
    batch = {k: np.stack([s[k] for s in scenes]) for k in JAX_KEYS}

    params = variables["params"]
    tx = optax.chain(_capture(), joptim.build_optimizer(
        params, OPTIMIZER, grad_clip=dict(max_norm=MAX_NORM)))
    state = TrainState.create(params, variables["batch_stats"], tx)
    step = jax_train_step(jmodel, tx, rgb_supervision=False, donate=False)
    with jax.disable_jit():  # op by op: see the module docstring
        new, metrics = step(state, batch, jax.random.PRNGKey(0))
    raw = new.opt_state[0]
    clip = optax.clip_by_global_norm(MAX_NORM)
    clipped, _ = clip.update(raw, clip.init(raw))
    # the same update without clipping, from the same raw gradients
    tx_free = joptim.build_optimizer(params, OPTIMIZER)
    free, _ = tx_free.update(raw, tx_free.init(params), params)
    zero_stats = jax.tree_util.tree_map(np.zeros_like,
                                        variables["batch_stats"])
    return dict(
        metrics={k: np.asarray(v) for k, v in metrics.items()},
        grads=_port_tree(clipped, zero_stats),
        params={MAX_NORM: _port_tree(new.params, new.batch_stats),
                None: _port_tree(optax.apply_updates(params, free),
                                 zero_stats)},
        labels=joptim.param_labels(params),
        stats={k: v for k, v in _port_tree(params, new.batch_stats).items()
               if k.endswith(("running_mean", "running_var"))})


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    n_threads = torch.get_num_threads()
    torch.set_num_threads(2)
    from tests.test_torch_train_nvs import jax_step_references

    variables = toy_variables(tmp_path_factory)
    scenes = [_scene(s) for s in SCENE_SEEDS]
    jax_out = jax_step_references(tmp_path_factory)["detection"]

    model = _port_model()
    start = from_jax_variables(variables)
    port = {norm: _port_step(model, start, scenes, norm or 1e30)
            for norm in (MAX_NORM, None)}
    yield dict(variables=variables, scenes=scenes, model=model,
               start=start, jax=jax_out, port=port)
    torch.set_num_threads(n_threads)


def _rel(a, b):
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


def test_loss_terms_and_grad_norm_match_jax(toy):
    got, want = toy["port"][MAX_NORM][0], toy["jax"]["metrics"]
    assert set(got) == set(want)
    assert float(got["n_pos"]) == float(want["n_pos"]) > 0
    assert float(want["grad_norm"]) > MAX_NORM  # the clip acts
    for k in ("loss", "loss_cls", "loss_bbox", "loss_centerness",
              "grad_norm"):
        assert _rel(got[k], want[k]) <= 1e-4, (k, got[k], want[k])


def test_every_gradient_matches_jax(toy):
    grads, want = toy["port"][MAX_NORM][1], toy["jax"]["grads"]
    for name, g in grads.items():
        w = want[name]
        assert g.shape == w.shape, name
        tol = 1e-3 * float(w.abs().max())
        assert float((g - w).abs().max()) <= tol, name
    # the gradient crosses the fusion (K1's backward) into the FPN, the
    # mapped stream and the backbone
    for name in ("mapping.0.weight", "mapping.0.bias",
                 "neck.lateral_convs.2.conv.weight",
                 "backbone.layer3.2.conv2.weight"):
        assert float(grads[name].abs().max()) > 0, name


class _ReluMargin(TorchFunctionMode):
    """The least |input| of every ReLU run under the mode."""

    least = float("inf")

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func in (torch.relu, F.relu):
            self.least = min(self.least, float(args[0].abs().min()))
        return func(*args, **(kwargs or {}))


def test_toy_keeps_neck_relu_inputs_off_zero(toy):
    """The condition the gradient tolerance rests on: in each scene, no
    ReLU input of the 3D neck lies within 3e-6 of 0."""
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


def test_batchnorm_running_stats_match_jax(toy):
    state, want = toy["port"][MAX_NORM][2], toy["jax"]["stats"]
    keys = [k for k in state if k.endswith(("running_mean", "running_var"))]
    assert len(keys) == 2 * sum(1 for k in state if k.endswith(
        "running_mean"))
    moved = 0
    for k in keys:
        assert float((state[k] - want[k]).abs().max()) <= 1e-5, k
        moved += not torch.equal(state[k], toy["start"][k])
    assert moved == len(keys)


@pytest.mark.parametrize("max_norm", [MAX_NORM, None],
                         ids=["clip 35 acts", "no clip"])
def test_parameters_after_one_step_match_jax(toy, max_norm):
    state = toy["port"][max_norm][2]
    want = toy["jax"]["params"][max_norm]
    grads = toy["jax"]["grads"]
    labels = toptim.param_labels(toy["model"])
    changed = live = 0
    for name, label in labels.items():
        before, after = toy["start"][name], state[name]
        if label == "frozen":
            assert torch.equal(after, before), name
            continue
        g = grads[name].abs()
        live += bool(g.max() > 0)
        changed += bool(g.max() > 0) and not torch.equal(after, before)
        mult = 0.1 if label == "backbone" else 1.0
        err = (after - want[name]).abs()
        signal = g >= 1e-3 * float(g.max())
        if bool(signal.any()):
            assert float(err[signal].max()) <= 1e-6, name
        assert float(err.max()) <= 2 * 2e-4 * mult + 1e-6, name
    # every trained parameter with a gradient moved (the unused render
    # head and FPN levels only decay, by less than their rounding)
    assert changed == live > 100


def test_param_labels_match_jax(toy):
    codes = {"frozen": 0.0, "backbone": 1.0, "main": 2.0}
    tree = jax.tree_util.tree_map(
        lambda label, p: np.full(np.shape(p), codes[label], np.float32),
        toy["jax"]["labels"], toy["variables"]["params"])
    zero_stats = jax.tree_util.tree_map(
        np.zeros_like, toy["variables"]["batch_stats"])
    want = from_jax_variables({"params": tree, "batch_stats": zero_stats})
    got = toptim.param_labels(toy["model"])
    assert set(got) == {n for n, _ in toy["model"].named_parameters()}
    for name, label in got.items():
        assert torch.all(want[name] == codes[label]), (name, label)
    # the JAX rule freezes every backbone module named conv1: the 13
    # bottlenecks of layers 2-4 included
    assert sum(label == "frozen" and name.endswith("conv1.weight")
               and not name.startswith("backbone.layer1")
               and name != "backbone.conv1.weight"
               for name, label in got.items()) == 13
    assert got["backbone.layer3.4.conv2.weight"] == "backbone"
    assert got["backbone.layer2.0.downsample.0.weight"] == "backbone"
    assert got["backbone.layer2.0.downsample.1.scale"] == "frozen"


@pytest.mark.parametrize("lr_config", [
    dict(policy="step", step=[8, 11]),
    dict(policy="step", step=[8, 11], warmup="linear", warmup_iters=40,
         warmup_ratio=0.001),
    dict(policy="cyclic", target_ratio=(10, 1e-4), step_ratio_up=0.4),
    dict(policy="CosineAnnealing", min_lr_ratio=1e-3),
    dict(policy="CosineAnnealing", warmup="linear", warmup_iters=50),
], ids=["step", "step+warmup", "cyclic", "cosine", "cosine+warmup"])
def test_lr_schedules_match_optax(lr_config):
    args = (2e-4, lr_config, 25, 12)
    want = joptim.build_lr_schedule_from_config(*args)
    got = toptim.build_lr_schedule_from_config(*args)
    for step in (0, 1, 39, 40, 41, 117, 118, 199, 200, 201, 274, 275, 276,
                 299, 300, 350):
        # optax computes in float32: 1e-5 relative, or 1e-7 of the base
        # rate where the cosine nears its end
        assert np.isclose(got(step), float(want(step)), rtol=1e-5,
                          atol=2e-11), (step, got(step), float(want(step)))


def _boxes_case(seed, n=64):
    rng = np.random.RandomState(seed)
    lo = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    pred = np.concatenate([lo, lo + rng.uniform(0.1, 1.5, (n, 3))], 1)
    tlo = lo + rng.normal(0, 0.3, (n, 3))
    target = np.concatenate([tlo, tlo + rng.uniform(0.1, 1.5, (n, 3))], 1)
    w = rng.uniform(0, 1, n)
    return [a.astype(np.float32) for a in (pred, target, w)]


def _jax_and_port_grad(jfn, tfn, x, *rest):
    """Value and gradient in ``x`` of a scalar loss, JAX and port."""
    jv, jg = jax.value_and_grad(jfn)(jnp.asarray(x),
                                     *[jnp.asarray(r) for r in rest])
    xt = torch.tensor(x, requires_grad=True)
    tv = tfn(xt, *[torch.as_tensor(r) for r in rest])
    tv.backward()
    return (float(jv), np.asarray(jg)), (float(tv.detach()), xt.grad.numpy())


@pytest.mark.parametrize("name", ["focal", "bce", "iou"])
def test_losses_match_jax(name):
    """Values 1e-5 relative, gradients 1e-5 x their max."""
    rng = np.random.RandomState(1)
    if name == "focal":
        logits = rng.normal(0, 3, (200, N_CLS)).astype(np.float32)
        labels = rng.randint(-1, N_CLS + 1, 200).astype(np.int32)
        w = rng.uniform(0, 1, 200).astype(np.float32)
        cases = _jax_and_port_grad(
            lambda x, l, w: jlosses.sigmoid_focal_loss(x, l, weight=w,
                                                       avg_factor=7.0),
            lambda x, l, w: tlosses.sigmoid_focal_loss(
                x, l.long(), weight=w, avg_factor=7.0), logits, labels, w)
    elif name == "bce":
        logits = rng.normal(0, 3, 300).astype(np.float32)
        targets = rng.uniform(0, 1, 300).astype(np.float32)
        w = (rng.uniform(0, 1, 300) > 0.3).astype(np.float32)
        cases = _jax_and_port_grad(
            lambda x, t, w: jlosses.binary_cross_entropy(x, t, weight=w),
            lambda x, t, w: tlosses.binary_cross_entropy(x, t, weight=w),
            logits, targets, w)
    else:
        pred, target, w = _boxes_case(2)
        cases = _jax_and_port_grad(
            lambda x, t, w: jlosses.axis_aligned_iou_loss(x, t, weight=w),
            lambda x, t, w: tlosses.axis_aligned_iou_loss(x, t, weight=w),
            pred, target, w)
    (jv, jg), (tv, tg) = cases
    assert _rel(tv, jv) <= 1e-5
    assert np.abs(tg - jg).max() <= 1e-5 * np.abs(jg).max()


def test_iou_corner_format_unaligned_matches_jax():
    from nerfdet_tpu.core.boxes import axis_aligned_iou_corner_format as j
    from nerfdet_tpu_torch.core.boxes import axis_aligned_iou_corner_format

    pred, target, _ = _boxes_case(3, 20)
    got = axis_aligned_iou_corner_format(torch.from_numpy(pred),
                                         torch.from_numpy(target[:7]),
                                         aligned=False)
    want = np.asarray(j(jnp.asarray(pred), jnp.asarray(target[:7]),
                        aligned=False))
    assert got.shape == want.shape == (20, 7)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_get_targets_matches_jax(seed):
    """Labels exact, centerness and target boxes 1e-6, on three scales
    of voxel centers and padded boxes; some boxes share points, so the
    volume tie-break and the top-k cut both act."""
    rng = np.random.RandomState(seed)
    pts = [np.stack(np.meshgrid(
        *[np.arange(n // 2 ** i) * (0.4 * 2 ** i) - 1.6 for n in (8, 8, 4)],
        indexing="ij"), -1).reshape(-1, 3) for i in range(3)]
    points = np.concatenate(pts).astype(np.float32)
    scale_ids = np.concatenate([np.full(len(p), i, np.int32)
                                for i, p in enumerate(pts)])
    g = 6
    boxes = np.concatenate([rng.uniform(-1.5, 1.0, (g, 2)),
                            rng.uniform(-1.6, 0.0, (g, 1)),
                            rng.uniform(0.5, 2.5, (g, 3)),
                            np.zeros((g, 1))], 1).astype(np.float32)
    labels = rng.randint(0, N_CLS, g).astype(np.int32)
    mask = np.array([True] * (g - 1) + [False])
    want = jheads.get_targets(jnp.asarray(points), jnp.asarray(scale_ids),
                              jnp.asarray(boxes), jnp.asarray(labels),
                              jnp.asarray(mask), 3, 27, 18)
    got = theads.get_targets(torch.from_numpy(points),
                             torch.from_numpy(scale_ids),
                             torch.from_numpy(boxes),
                             torch.from_numpy(labels).long(),
                             torch.from_numpy(mask), 3, 27, 18)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    fg = np.asarray(want[2]) >= 0
    assert 0 < fg.sum() < len(fg)
    for a, b in zip(got[:2], want[:2]):
        np.testing.assert_allclose(a.numpy()[fg], np.asarray(b)[fg],
                                   rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        theads.compute_centerness(torch.from_numpy(points[:, None].repeat(
            2, 1).reshape(-1, 6) + 1.0)).numpy(),
        np.asarray(jheads.compute_centerness(jnp.asarray(
            points[:, None].repeat(2, 1).reshape(-1, 6) + 1.0))),
        rtol=0, atol=1e-6)


def test_training_without_rays_gives_no_nvs_term(toy):
    """Under ``rgb_supervision`` (the default) a scene without rays adds
    no NVS term: the step's metrics and loss are the detection step's."""
    model = _port_model()
    model.load_state_dict(toy["start"])
    opt = toptim.build_optimizer(model, OPTIMIZER,
                                 grad_clip=dict(max_norm=MAX_NORM))
    scenes = [{k: v for k, v in s.items()
               if k not in ("ray_o", "ray_d", "gt_rgb", "gt_depth")}
              for s in toy["scenes"]]
    batch = api.train_batch(model, scenes)
    assert all("ray_o" not in b for b in batch)
    got = make_train_step(model, opt)(batch)
    want = toy["port"][MAX_NORM][0]
    assert set(got) == set(want) and "loss_nvs" not in got
    for k in got:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("rgb_supervision", [None, True, False])
def test_init_trainer_reads_the_loss_switches_from_the_config(
        monkeypatch, rgb_supervision):
    """``init_trainer`` builds the step ``tools/train.py`` builds for the
    config: the NVS loss unless ``model.rgb_supervision`` is False, and
    ``depth_supervise`` and ``use_nerf_mask`` as the config sets them."""
    from nerfdet_tpu_torch.config import Config

    cfg = Config.fromfile("configs/nerfdet/nerfdet_res50_2x_low_res.py")
    assert "rgb_supervision" not in cfg.model
    assert cfg.model["depth_supervise"] is False
    if rgb_supervision is not None:
        cfg.model["rgb_supervision"] = rgb_supervision
    cfg.model["use_nerf_mask"] = False
    seen = {}

    def spy(model, optimizer, **kw):
        seen.update(kw)
        return make_train_step(model, optimizer, **kw)

    monkeypatch.setattr(api, "make_train_step", spy)
    tr = api.init_trainer(cfg, device="cpu")
    assert seen == dict(rgb_supervision=rgb_supervision is not False,
                        depth_supervise=False, use_nerf_mask=False,
                        process_group=None)
    assert tr.model.n_rand == 2048 and tr.model.n_samples == 64


def test_init_trainer_needs_cuda_unless_cpu():
    cfg = "configs/nerfdet/nerfdet_res50_2x_low_res.py"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            api.init_trainer(cfg)
    tr = api.init_trainer(cfg, device="cpu", steps_per_epoch=100)
    assert tr.model.training
    assert next(tr.model.parameters()).device.type == "cpu"
    groups = tr.optimizer.adamw.param_groups
    labels = toptim.param_labels(tr.model)
    assert [len(g["params"]) for g in groups] == [
        sum(v == label for v in labels.values())
        for label in ("main", "backbone")]
    assert np.isclose(tr.optimizer.schedule(799), 2e-4)
    assert np.isclose(tr.optimizer.schedule(800), 2e-5)
    assert np.isclose(tr.optimizer.schedule(1100), 2e-6)
    assert tr.optimizer.max_norm == 35.0 and tr.optimizer.lr_mult == 0.1
