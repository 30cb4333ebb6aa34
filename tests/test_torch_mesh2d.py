"""The 2-D data x views sharding and the last tools, on the CPU, against
the JAX package.

The ranks are gloo processes spawned with ``torch.multiprocessing`` (two,
one spawn for every sharded case of the file, its results computed once
per test run) or the CLIs as subprocesses; they run the port (a spawned
rank imports this module, and so JAX, for its scene helpers). The toy is ``tests/test_parallel.py``'s: NeRF-Det-R50 at the
JAX defaults on 31x40 images, an 8x8x4 volume, 16 samples a ray, four
views and 32 rays a scene (so both split over two ranks), the JAX
weights carried over by ``from_jax_variables``. The JAX references run
once per test run (``computed_once``), jitted, on a 2-device mesh of the
suite's 8 virtual CPU devices where they shard:

* ``make_view_sharded_volume`` against the port's view-sharded
  ``build_volume`` over 2 ranks (``parallel/intra_scene.py``): the view
  counts exact, the volume within 5e-4 (the JAX test's own bound; JAX's
  sharded and unsharded volumes differ by 7.3e-5 here) and within 1e-5
  of its max of the port's unsharded volume;
* K2 over a views group (``_ShardedK2``: the rank's sums, one
  all-reduce, the epilogue at the scene's view count; backward: the
  cotangent summed, then K2's backward at that view count) against the
  plain K2 on every view with the ranks' cotangents summed, both forms:
  globalfeat 1e-6, d featmaps 1e-5 of their max;
* ``make_ray_sharded_render`` (chunk 8) against the port's: rgb 1e-3,
  depth 1e-2 (the JAX test's own tolerances);
* the port's sharded eval (``parallel/train2d.make_eval_step_sharded``,
  the density modulation on) against JAX's unsharded eval with
  ``with_rays=True``: boxes and scores 1e-4;
* the 2-D train step at data 1 x views 2 (two scenes, the host rgb sums
  and ray stream in the batch) against the port's one-process step
  (loss terms and grad_norm 1e-4 relative, the two ranks' parameters bit
  for bit the same; also with ``loss_depth``, whose depth divides by
  the rendered weights' sum and is the most sensitive term: 6.8e-5),
  the parameters by the rule of ``tests/test_parallel.py`` (AdamW's
  first step moves an element by ~lr sign(g), so an element whose
  gradient sums to rounding noise may differ by up to 2 lr: at most
  max(3, 1e-3 of a tensor) beyond 2e-4 relative + 2e-6, none beyond 2.2
  lr), the running statistics 1e-4 / 1e-6; and against JAX's 1-D
  ``make_train_step`` (its defaults: the JAX benchmark's step too): the
  loss terms 1e-4 relative and the running statistics within 1e-4 of
  each tensor's max. JAX's step is compiled here (op by op it takes
  ~200 s), and compiled XLA rounds the det volume otherwise (ROADMAP §3):
  its gradients are no reference (on these scenes its grad_norm is
  87.988 compiled and 87.743 op by op, the port's 87.745), and 5 of 1024
  neck running means sit 1.6e-6 from the port's (4e-3 of their small
  value). The one-process step the 2-D step is held to is held to JAX's
  op-by-op step by ``tests/test_torch_train_nvs.py``.
  No 3D-neck ReLU input of these scenes lies within 3e-6 of 0 (asserted,
  as ``tests/test_torch_depth.py`` does). JAX's own 2-D step is not run
  here: its test peaks at 24.9 GB;
* a views group whose first rank loads with two loader threads: both
  ranks hold the same scenes, bit for bit.

The CLIs: ``tools/train --distributed --mesh-views 2`` at 2 ranks for 2
steps against one process (the smoke config, its test scenes given 4
source views as its train scenes have), the checkpoints' parameters by
the rule of ``tests/test_parallel.py``;
``tools/test --distributed --mesh-views 2`` (torchrun, 2 ranks) prints
the metrics of world 1. A data 2 x views 2 step on 4 ranks is marked
``slow``.

The tools: ``tools/benchmark``'s three timed functions at toy size
against JAX's (detection and rendering on the toy's scene; the train
step's metrics against JAX's step on the same scenes, which do not depend
on the optimizer; the train scene's host streams bit for bit);
``tools/publish_model`` loads back with the same ``eval_step`` outputs
and a stable hash; ``tools/print_config`` prints the JAX tool's text for
the flagship config.

Each multi-process test waits at most 120 s for its ranks, then kills
them and fails. The file takes ~2.5 minutes of one worker on 2 threads
(most of it the JAX references and the CLIs' processes); its processes
peak at ~12.5 GB summed (the train CLI test's three at once), the test
process alone at 7.7 GB.
"""

import contextlib
import copy
import hashlib
import importlib.util
import io
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfdet_tpu.data.synthetic import make_synthetic_scene
from nerfdet_tpu.models.nerfdet import NerfDet as JaxNerfDet
from nerfdet_tpu.nn.heads import get_candidate_bboxes
from nerfdet_tpu.ops.render import host_ray_rgb_stats as jax_ray_stats
from nerfdet_tpu.ops.render import host_sample_z as jax_sample_z
from nerfdet_tpu.ops.voxel import host_rgb_stats as jax_rgb_stats
from nerfdet_tpu.parallel import (make_ray_sharded_render,
                                  make_view_sharded_volume)
from nerfdet_tpu.train import TrainState, build_optimizer, make_train_step
from nerfdet_tpu.train.step import make_mesh

from nerfdet_tpu_torch import api
from nerfdet_tpu_torch.config import Config
from nerfdet_tpu_torch.data.synthetic import write_synthetic_scannet
from nerfdet_tpu_torch.models.nerfdet import NerfDet, SceneMeta
from nerfdet_tpu_torch.ops import render
from nerfdet_tpu_torch.parallel import dist as pdist
from nerfdet_tpu_torch.parallel import intra_scene, train2d
from nerfdet_tpu_torch.tools import benchmark, print_config, publish_model
from nerfdet_tpu_torch.train import optim as toptim
from nerfdet_tpu_torch.train.step import make_train_step as port_train_step
from nerfdet_tpu_torch.utils.checkpoint import load_checkpoint, \
    save_checkpoint
from nerfdet_tpu_torch.utils.weight_convert import from_jax_variables

from tests.test_torch_ddp import (JOIN_TIMEOUT, ROOT, SMOKE, _cli,
                                  _free_port, _load_ranks, _max_err, _rel,
                                  _run, _spawn, _torchrun)
from tests.test_torch_session_cache import computed_once
from tests.test_torch_train import _port_tree, _ReluMargin
from tests.test_train_step import tiny_model

THREADS = 2
ORI, IMG, PAD = (128, 160), (31, 40), (32, 40)
N_VIEWS, N_RAND, N_SAMPLES, NEAR_FAR = 4, 32, 16, (0.2, 8.0)
CHUNK, NMS_PRE, SCENE_SEEDS = 8, 20, (10, 16)
LR = 1e-3
OPTIMIZER = dict(type="AdamW", lr=LR, weight_decay=1e-4,
                 paramwise_cfg=dict(custom_keys=dict(
                     backbone=dict(lr_mult=0.1))))
MAX_NORM = 35.0
DET_KEYS = ("imgs", "denorm_images", "intrinsic", "extrinsics", "origin")
LOSS_KEYS = ("loss", "loss_cls", "loss_bbox", "loss_centerness",
             "loss_nvs", "n_pos")


@pytest.fixture(autouse=True, scope="module")
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    yield
    torch.set_num_threads(n)


def _scene(seed):
    """``tests/test_parallel.py``'s scene (the depth maps dropped, the
    target view's depth kept as gt_depth) with the host streams the
    loader makes: the rgb sums, the ray depths and the ray stream."""
    s = make_synthetic_scene(seed=seed, n_views=N_VIEWS, n_targets=1,
                             hw=IMG, pad_hw=PAD, n_rand=N_RAND, n_boxes=2,
                             max_gt=4, margin=2, with_depth=True)
    s.pop("depth")
    s["rgb_s1"], s["rgb_s2"] = jax_rgb_stats(
        s["denorm_images"], s["intrinsic"], s["extrinsics"], s["origin"],
        (8, 8, 4), (0.8, 0.8, 0.8), ORI, IMG)
    s["z_vals"] = jax_sample_z(np.random.RandomState(seed + 7), N_RAND,
                               *NEAR_FAR, N_SAMPLES)
    (s["ray_s1u"], s["ray_s2u"], s["ray_s1m"], s["ray_cnt"]) = \
        jax_ray_stats(s["denorm_images"], s["intrinsic"], s["extrinsics"],
                      s["ray_o"], s["ray_d"], s["z_vals"], ORI, IMG)
    return s


def _port_model():
    return NerfDet(n_voxels=(8, 8, 4), voxel_size=(0.8, 0.8, 0.8),
                   n_samples=N_SAMPLES, n_rand=N_RAND, nerf_density=True,
                   meta=SceneMeta(ori_shape=ORI, img_shape=IMG,
                                  pad_shape=PAD))


def _nvs_rays(scene):
    """The benchmark's rays at toy size: 32 from the scene's first ray
    origin, directions from the tool's generator."""
    b = benchmark.nvs_batch(_port_model(), scene, 32)
    return b["ray_o"].numpy(), b["ray_d"].numpy()


def _jax_refs():
    model = tiny_model()
    scenes = [_scene(s) for s in SCENE_SEEDS]
    s = scenes[0]
    variables = jax.jit(lambda k: model.init(
        k, {k2: s[k2] for k2 in DET_KEYS + ("ray_o", "ray_d")},
        train=False, with_rays=True))(jax.random.PRNGKey(0))
    det = {k: s[k] for k in DET_KEYS}

    def infer(v, b):
        head_outs, valid, _ = model.apply(v, b, train=False, with_rays=True)
        return get_candidate_bboxes(head_outs, valid,
                                    model.mlvl_points(b["origin"]), NMS_PRE,
                                    model.n_classes)

    boxes, scores = jax.jit(infer)(variables, det)
    ray_o, ray_d = _nvs_rays(s)
    nvs = jax.jit(lambda v, b: model.apply(
        v, b, CHUNK, method=JaxNerfDet.render_full))(
        variables, dict(det, ray_o=ray_o, ray_d=ray_d))
    mesh = make_mesh(2, axis="views")
    volume, valid = make_view_sharded_volume(model, mesh)(variables, s)
    rgb, depth = make_ray_sharded_render(model, mesh, chunk=CHUNK)(
        variables, s)

    batch = {k: np.stack([sc[k] for sc in scenes]) for k in scenes[0]}
    tx = build_optimizer(variables["params"], OPTIMIZER,
                         grad_clip=dict(max_norm=MAX_NORM))
    state = TrainState.create(variables["params"],
                              variables["batch_stats"], tx)
    step = make_train_step(model, tx, donate=False)
    new, metrics = step(state, batch, jax.random.PRNGKey(7))
    return dict(
        variables=_np(variables), det=(np.asarray(boxes), np.asarray(scores)),
        nvs=(np.asarray(nvs[0]), np.asarray(nvs[1])),
        volume=(np.asarray(volume), np.asarray(valid)),
        ray_render=(np.asarray(rgb), np.asarray(depth)),
        step=dict(metrics={k: np.asarray(v) for k, v in metrics.items()},
                  state=_port_tree(new.params, new.batch_stats)))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def refs(tmp_path_factory):
    return computed_once(tmp_path_factory, "torch_mesh2d_jax", _jax_refs)


def _start(refs):
    return from_jax_variables(refs["variables"])


def _loaded(start, mode="eval"):
    model = _port_model()
    model.load_state_dict(start, strict=True)
    return model.train() if mode == "train" else model.eval()


def _stepped(model, scenes, group=None, views=None, data=None,
             depth=False, keep_state=True):
    """One step of the toy: its metrics, the SHA-256 of the state after it
    and, with ``keep_state``, the state (401 MB)."""
    opt = toptim.build_optimizer(model, OPTIMIZER,
                                 grad_clip=dict(max_norm=MAX_NORM))
    step = port_train_step(model, opt, depth_supervise=depth,
                           process_group=group, view_group=views,
                           data_group=data)
    metrics = step(api.train_batch(model, scenes, view_group=views))
    h = hashlib.sha256()
    for v in model.state_dict().values():
        h.update(v.numpy().tobytes())
    out = dict(metrics={k: v.clone() for k, v in metrics.items()},
               state_sha256=h.hexdigest())
    if keep_state:
        out["state"] = {k: v.clone() for k, v in model.state_dict().items()}
    return out


K2_C = 8  # the feature channels of the K2 case


def _k2_case():
    """K2's inputs at the toy scene's rays and views: the sample points,
    images, projections, random maps (C = 8), the host rgb sums, and a
    random cotangent of globalfeat for each of the two ranks."""
    s = _scene(SCENE_SEEDS[0])
    rng = np.random.RandomState(5)
    feats = torch.tensor(rng.randn(N_VIEWS, 7, 10, K2_C), dtype=torch.float32)
    proj = render.view_projection(s["intrinsic"], s["extrinsics"],
                                  ORI[0] / IMG[0])
    pts = render.points_at(*(torch.as_tensor(s[k]) for k in (
        "ray_o", "ray_d", "z_vals")))
    host = tuple(torch.as_tensor(s[k]) for k in (
        "ray_s1u", "ray_s2u", "ray_s1m", "ray_cnt"))
    g = [torch.tensor(np.random.RandomState(9 + r).randn(
        N_RAND, N_SAMPLES, 2 * (3 + K2_C)), dtype=torch.float32)
        for r in (0, 1)]
    return pts, torch.as_tensor(s["denorm_images"]), proj, feats, host, g


def _k2_sharded(rank, views):
    """On this rank's two views: globalfeat and d featmaps of
    ``(globalfeat * g[rank]).sum()`` through K2 with the views group (on
    the CPU ``_ShardedK2`` over the plain sums and backward) and through
    its plain version (torch autograd over the group's sum), both forms."""
    pts, images, proj, feats, host, g = _k2_case()
    lo, hi = 2 * rank, 2 * rank + 2
    out = {}
    for form, h in (("eval", None), ("training", host)):
        for name, fn in (("kernel", render.streaming_sample_mean_var),
                         ("plain", render.streaming_sample_mean_var_plain)):
            f = feats[lo:hi].clone().requires_grad_()
            gf, _ = fn(pts, images[lo:hi], proj[lo:hi], IMG, f, h, views)
            (gf * g[rank]).sum().backward()
            out[f"{form}_{name}"] = (gf.detach(), f.grad)
    return out


def _digest(scene):
    h = hashlib.sha256()
    for k in sorted(scene):
        h.update(k.encode())
        h.update(np.ascontiguousarray(scene[k]).tobytes())
    return h.hexdigest()


def _mesh_rank(rank, world, port, start_path, data_root, out):
    """Every sharded case of the file on one rank of 2 (views group of
    2, data group of 1)."""
    torch.set_num_threads(THREADS)
    start = torch.load(start_path)
    scenes = [_scene(s) for s in SCENE_SEEDS]
    got = {}
    with pdist.process_group("cpu", f"localhost:{port}", world, rank) as (
            _, group):
        views, data = pdist.mesh_groups(2, group)
        assert data is None and pdist.world(views) == 2
        got["k2"] = _k2_sharded(rank, views)
        model = _loaded(start)
        batch = detection_batch(model, scenes[0])
        got["volume"] = intra_scene.make_view_sharded_volume(
            model, views)(batch)
        got["ray_render"] = intra_scene.make_ray_sharded_render(
            model, views, CHUNK)(dict(batch, ray_o=torch.as_tensor(
                scenes[0]["ray_o"]), ray_d=torch.as_tensor(
                scenes[0]["ray_d"])))
        det = {k: v for k, v in scenes[0].items() if k in DET_KEYS
               or k in ("rgb_s1", "rgb_s2")}
        out_eval = train2d.make_eval_step_sharded(model, views, NMS_PRE)(
            api.device_batch(model, det, view_group=views))
        got["eval"] = (out_eval["boxes"], out_eval["scores"])
        got["step"] = _stepped(_loaded(start, "train"), scenes, group,
                               views, data, keep_state=rank == 0)
        got["step_depth"] = _stepped(_loaded(start, "train"), scenes, group,
                                     views, data, depth=True,
                                     keep_state=False)
        # a views group whose first rank loads with two threads
        cfg = Config.fromfile(SMOKE)
        cfg.merge_from_options([f"data.train.data_root={data_root}/",
                                f"data.train.ann_file={data_root}/"
                                f"scannet_infos_train.pkl"])
        from nerfdet_tpu_torch.data.dataset import build_dataset
        from nerfdet_tpu_torch.data.loader import BatchLoader
        loader = BatchLoader(build_dataset(cfg.data["train"], n_rand=16),
                             batch_size=2, num_workers=2, seed=5)
        got["loaded"] = [[_digest(s) for s in b] for b in
                         train2d.shared_batches(loader, views)]
    torch.save(got, os.path.join(out, f"rank{rank}.pt"))


def detection_batch(model, scene):
    return benchmark.detection_batch(model, scene)


@pytest.fixture(scope="module")
def ranks(refs, tmp_path_factory):
    """The two ranks' results (``_mesh_rank``), once per test run."""
    def compute():
        d = tmp_path_factory.mktemp("mesh2d")
        start = str(d / "start.pt")
        torch.save(_start(refs), start)
        root = write_synthetic_scannet(str(d / "data"), n_scenes=4,
                                       n_images=8, hw=(120, 160),
                                       splits=("train",))
        _spawn(_mesh_rank, 2, start, root, str(d))
        os.remove(start)
        return _load_ranks(str(d), 2)
    return computed_once(tmp_path_factory, "torch_mesh2d_ranks", compute)


def test_view_sharded_volume_matches_jax(refs, ranks):
    """The view counts exact; the volume within 5e-4 of JAX's sharded one
    (the JAX test's own bound: JAX's sharded and unsharded volumes differ
    by 7.3e-5 here, the psum's order) and within 1e-5 of its max of the
    port's unsharded volume."""
    want_vol, want_valid = refs["volume"]
    model = _loaded(_start(refs))
    batch = detection_batch(model, _scene(SCENE_SEEDS[0]))
    with torch.inference_mode():
        one = model.build_volume(
            model.extract_2d(batch["imgs"]), batch["intrinsic"],
            batch["extrinsics"], batch["origin"],
            denorm_images=batch["denorm_images"])["det_volume"]
    for r in ranks:
        vol, valid = r["volume"]
        np.testing.assert_array_equal(valid.numpy(), want_valid)
        np.testing.assert_allclose(vol.numpy(), want_vol, atol=5e-4)
        assert _max_err(vol, one) <= 1e-5
    assert int(want_valid.max()) >= 2  # voxels seen by both ranks' views
    assert torch.equal(ranks[0]["volume"][0], ranks[1]["volume"][0])


def test_sharded_k2_gradient_is_the_sum_transpose(ranks):
    """K2 over a views group, forward and backward, against the plain K2
    on every view with the ranks' cotangents summed (what JAX's psum and
    its transpose give): on each rank globalfeat within 1e-6 and d
    featmaps within 1e-5 of their max of the unsharded plain version's
    (its rank's views), for the sharded Function (the cotangent summed
    over the group, then K2's backward at the scene's view count) and
    for autograd through the plain version's sum over the group, whose
    globalfeat the Function's matches within 1e-6 of its max (bitwise in
    all but one of ~20 runs of this file; measured 8.3e-8 from the
    unsharded, the gradients 2.5e-7 and 3.6e-7)."""
    pts, images, proj, feats, host, g = _k2_case()
    for form, h in (("eval", None), ("training", host)):
        f = feats.clone().requires_grad_()
        gf, _ = render.streaming_sample_mean_var_plain(pts, images, proj,
                                                       IMG, f, h)
        (gf * (g[0] + g[1])).sum().backward()
        assert float(f.grad.abs().max()) > 0
        for r, rank in enumerate(ranks):
            (k_gf, k_grad), (p_gf, p_grad) = (rank["k2"][f"{form}_kernel"],
                                              rank["k2"][f"{form}_plain"])
            assert _max_err(k_gf, p_gf) <= 1e-6, form
            assert _max_err(k_gf, gf.detach()) <= 1e-6, form
            want = f.grad[2 * r:2 * r + 2]
            assert _max_err(k_grad, want) <= 1e-5, form
            assert _max_err(p_grad, want) <= 1e-5, form


def test_ray_sharded_render_matches_jax(refs, ranks):
    want_rgb, want_depth = refs["ray_render"]
    for r in ranks:
        rgb, depth = r["ray_render"]
        assert rgb.shape == (N_RAND, 3) and depth.shape == (N_RAND,)
        np.testing.assert_allclose(rgb.numpy(), want_rgb, atol=1e-3)
        np.testing.assert_allclose(depth.numpy(), want_depth, atol=1e-2)


def test_sharded_eval_matches_jax_unsharded_eval(refs, ranks):
    want_boxes, want_scores = refs["det"]
    for r in ranks:
        boxes, scores = r["eval"]
        np.testing.assert_allclose(boxes.numpy(), want_boxes, atol=1e-4)
        np.testing.assert_allclose(scores.numpy(), want_scores, atol=1e-4)


@pytest.fixture(scope="module")
def one_process(refs):
    """The port's one-process step on both scenes, without and with
    ``loss_depth``."""
    scenes = [_scene(s) for s in SCENE_SEEDS]
    return {key: _stepped(_loaded(_start(refs), "train"), scenes,
                          depth=key == "step_depth",
                          keep_state=key == "step")
            for key in ("step", "step_depth")}


@pytest.mark.parametrize("key", ["step", "step_depth"])
def test_2d_step_matches_the_one_process_step(ranks, one_process, key):
    want = one_process[key]["metrics"]
    for r in ranks:
        got = r[key]["metrics"]
        assert set(got) == set(want)
        for k, v in want.items():
            assert _rel(got[k], v) <= 1e-4, (k, got[k], v)
    assert ranks[0][key]["state_sha256"] == ranks[1][key]["state_sha256"]
    assert float(want["loss_nvs"]) > 0
    assert ("loss_depth" in want) == (key == "step_depth")
    if key == "step_depth":
        assert float(want["loss_depth"]) > 0


def _check_params_by_the_jax_rule(got, want, names, lr=LR, steps=1):
    """``tests/test_parallel.py``'s rule for the parameters after
    ``steps`` AdamW steps at rate ``lr``: at most max(3, 1e-3 of the
    tensor) elements beyond 2e-4 relative + 2e-6, none beyond 2.2 lr a
    step."""
    for name in names:
        p1, p2 = want[name].double().numpy(), got[name].double().numpy()
        diff = np.abs(p1 - p2)
        tol = 2e-4 * np.abs(p1) + 2e-6
        n_bad = int((diff > tol).sum())
        assert n_bad <= max(3, 1e-3 * diff.size), (name, n_bad, diff.size)
        assert diff.max() <= 2.2 * lr * steps, (name, diff.max())


def test_2d_step_parameters_match_the_one_process_step(ranks, one_process):
    got, want = ranks[0]["step"], one_process["step"]
    assert _rel(got["metrics"]["grad_norm"],
                want["metrics"]["grad_norm"]) <= 1e-3
    params = [k for k in want["state"] if not k.endswith((
        "running_mean", "running_var", "num_batches_tracked"))]
    _check_params_by_the_jax_rule(got["state"], want["state"], params)
    moved = [k for k in params
             if not torch.equal(want["state"][k], got["state"][k])]
    assert moved  # a step was taken
    for k in want["state"]:
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(got["state"][k].numpy(),
                                       want["state"][k].numpy(), rtol=1e-4,
                                       atol=1e-6, err_msg=k)


def test_2d_step_matches_jax_1d_step(refs, ranks, one_process):
    want = refs["step"]
    stats = [k for k in want["state"]
             if k.endswith(("running_mean", "running_var"))]
    for got in (ranks[0]["step"], one_process["step"]):
        for k in LOSS_KEYS:
            assert _rel(got["metrics"][k], want["metrics"][k]) <= 1e-4, k
        for k in stats:  # of each tensor's max: see the module docstring
            assert _max_err(got["state"][k], want["state"][k]) <= 1e-4, k


def test_toy_keeps_neck_relu_inputs_off_zero(refs):
    """The condition the compiled JAX step's gradients rest on: in each
    scene no ReLU input of the 3D neck lies within 3e-6 of 0."""
    model = _loaded(_start(refs), "train")
    for batch in api.train_batch(model, [_scene(s) for s in SCENE_SEEDS]):
        seen = {}
        hook = model.neck_3d.register_forward_pre_hook(
            lambda m, args: seen.setdefault("x", args[0].detach()))
        with torch.no_grad():
            model(batch)
        hook.remove()
        with torch.no_grad(), _ReluMargin() as mode:
            copy.deepcopy(model.neck_3d)(seen["x"])
        assert 3e-6 <= mode.least < float("inf")


def test_a_views_group_holds_the_same_scenes(ranks):
    a, b = ranks[0]["loaded"], ranks[1]["loaded"]
    assert len(a) == 2 and all(len(batch) == 2 for batch in a)
    assert a == b


def test_view_shard_splits_the_view_led_keys():
    s = _scene(0)
    parts = [train2d.view_shard(s, i, 2) for i in (0, 1)]
    for k in train2d.VIEW_LED_KEYS:
        if k in s:
            np.testing.assert_array_equal(
                np.concatenate([p[k] for p in parts]), s[k])
    for k in ("rgb_s1", "ray_o", "z_vals", "intrinsic", "gt_boxes"):
        assert parts[1][k] is s[k]
    with pytest.raises(ValueError, match="4 views of 'imgs' do not split"):
        train2d.view_shard(s, 0, 3)


def _two_by_two_rank(rank, world, port, start_path, out):
    torch.set_num_threads(THREADS)
    start = torch.load(start_path)
    scenes = [_scene(s) for s in SCENE_SEEDS]
    with pdist.process_group("cpu", f"localhost:{port}", world, rank) as (
            _, group):
        views, data = pdist.mesh_groups(2, group)
        got = _stepped(_loaded(start, "train"), [scenes[rank // 2]], group,
                       views, data, keep_state=False)
    torch.save(got, os.path.join(out, f"rank{rank}.pt"))


@pytest.mark.slow
def test_2x2_step_matches_jax_1d_step(refs, one_process, tmp_path):
    """Data 2 x views 2 on four ranks, a scene a data group."""
    start = str(tmp_path / "start.pt")
    torch.save(_start(refs), start)
    _spawn(_two_by_two_rank, 4, start, str(tmp_path))
    got = _load_ranks(str(tmp_path), 4)
    for r in got:
        for k, v in one_process["step"]["metrics"].items():
            assert _rel(r["metrics"][k], v) <= 1e-4, k
        assert r["state_sha256"] == got[0]["state_sha256"]
    want = refs["step"]
    for k in LOSS_KEYS:
        assert _rel(got[0]["metrics"][k], want["metrics"][k]) <= 1e-4, k


# ---------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def smoke4(tmp_path_factory):
    """The smoke config with 4 source views a test scene as a train scene
    has (its test pipeline draws 4, one of them a target, and 3 do not
    split over 2 ranks), its dataset and a checkpoint of its random
    weights."""
    d = tmp_path_factory.mktemp("smoke4")
    with open(SMOKE) as f:
        text = f.read()
    assert text.count("n_images=4") == 1  # the test pipeline's
    config = str(d / "smoke4.py")
    with open(config, "w") as f:
        f.write(text.replace("n_images=4", "n_images=5"))
    root = write_synthetic_scannet(str(d / "data"), n_scenes=2, n_images=8,
                                   hw=(240, 320))
    ckpt = save_checkpoint(
        str(d / "ckpt"), 1,
        dict(model=api.init_detector(config, device="cpu").state_dict(),
             optimizer={}))
    options = [f"data.{split}.{k}={root}/{v}"
               for split, ann in (("train", "train"), ("val", "val"),
                                  ("test", "val"))
               for k, v in (("data_root", ""),
                            ("ann_file", f"scannet_infos_{ann}.pkl"))]
    return dict(config=config, root=root, ckpt=ckpt,
                options=options + ["test_cfg.score_thr=0.0"])


def test_train_cli_mesh_views_matches_one_process(smoke4, tmp_path):
    port = _free_port()
    args = [smoke4["config"], "--max-steps", "2", "--device", "cpu",
            "--no-validate", "--options", *smoke4["options"]]
    ranks = [_cli("train") + [
        "--work-dir", str(tmp_path / "mesh"), "--distributed",
        "--mesh-views", "2", "--coordinator", f"localhost:{port}",
        "--num-processes", "2", "--process-id", str(r)] + args
        for r in (0, 1)]
    one = _cli("train") + ["--work-dir", str(tmp_path / "one")] + args
    for code, _, err in _run(ranks + [one], ROOT):
        assert code == 0, err[-3000:]
    got = load_checkpoint(str(tmp_path / "mesh" / "ckpts" / "ckpt_1.pth"))
    want = load_checkpoint(str(tmp_path / "one" / "ckpts" / "ckpt_1.pth"))
    assert got["step"] == want["step"] == 2
    # the parameters by the rule of tests/test_parallel.py, the JAX
    # package's for its 2-D step against its 1-D one (the sharded sums'
    # order moves the volume by ~1e-6 and a step's 3D-neck gradients by
    # ~5e-5 of their max; the second step starts from parameters that
    # differed by up to 2 lr where the first gradient was rounding
    # noise); the running statistics 1e-4 / 1e-6; AdamW's moments within
    # 1e-2 of their max (1.2e-3 seen; a gradient scaled by the views
    # group's size would miss it by far)
    cfg = Config.fromfile(smoke4["config"])
    names = [k for k in want["model"] if not k.endswith((
        "running_mean", "running_var", "num_batches_tracked"))]
    _check_params_by_the_jax_rule(got["model"], want["model"], names,
                                  lr=cfg.optimizer["lr"], steps=2)
    for k, v in want["model"].items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(got["model"][k].numpy(), v.numpy(),
                                       rtol=1e-4, atol=1e-6, err_msg=k)
    for i, state in want["optimizer"]["adamw"]["state"].items():
        for key in ("exp_avg", "exp_avg_sq"):
            other = got["optimizer"]["adamw"]["state"][i][key]
            assert _max_err(other, state[key]) <= 1e-2, (i, key)


def test_test_cli_mesh_views_prints_world_one_metrics(smoke4):
    args = [smoke4["config"], smoke4["ckpt"], "--eval", "mAP", "--device",
            "cpu", "--options", *smoke4["options"]]
    (c2, out2, err2), (c1, out1, err1) = _run(
        [_torchrun(2) + ["-m", "nerfdet_tpu_torch.tools.test",
                         "--distributed", "--mesh-views", "2"] + args,
         _cli("test") + args], ROOT)
    assert c2 == 0, err2[-3000:]
    assert c1 == 0, err1[-3000:]
    assert out2.count('"mAP_0.25"') == 1  # rank 0 alone prints
    assert out2[out2.rindex("{"):] == out1[out1.rindex("{"):]


# ---------------------------------------------------------------------
# the tools
# ---------------------------------------------------------------------

def test_benchmark_detection_and_nvs_match_jax(refs):
    model = _loaded(_start(refs))
    scene = _scene(SCENE_SEEDS[0])
    out = benchmark.detection_fn(model, NMS_PRE)(
        benchmark.detection_batch(model, scene))
    boxes, scores = refs["det"]
    np.testing.assert_allclose(out["boxes"].numpy(), boxes, atol=1e-4)
    np.testing.assert_allclose(out["scores"].numpy(), scores, atol=1e-4)
    moved = benchmark.moved_origins(scene["origin"], 3)
    np.testing.assert_array_equal(
        moved[2], np.asarray(jnp.asarray(scene["origin"])
                             + jnp.float32(2) * 1e-4))
    rgb, depth = benchmark.nvs_fn(model, CHUNK)(
        benchmark.nvs_batch(model, scene, 32))
    np.testing.assert_allclose(rgb.numpy(), refs["nvs"][0], atol=1e-3)
    np.testing.assert_allclose(depth.numpy(), refs["nvs"][1], atol=1e-2)


def test_benchmark_train_step_matches_jax(refs, one_process):
    """The tool's step (its optimizer is the JAX tool's: AdamW 2e-4, weight
    decay 1e-4, clip 35) on the toy's scenes: its loss terms are those of
    JAX's step at the same weights, its grad_norm the one-process step's
    (see the module docstring)."""
    assert benchmark.OPTIMIZER == dict(type="AdamW", lr=2e-4,
                                       weight_decay=1e-4)
    assert benchmark.GRAD_CLIP == dict(max_norm=35.0)
    model = _loaded(_start(refs), "eval")
    step = benchmark.train_fn(model)
    assert model.training
    got = step(api.train_batch(model, [_scene(s) for s in SCENE_SEEDS]))
    want = refs["step"]["metrics"]
    assert set(got) == set(want)
    for k in LOSS_KEYS:
        assert _rel(got[k], want[k]) <= 1e-4, k
    assert _rel(got["grad_norm"],
                one_process["step"]["metrics"]["grad_norm"]) <= 1e-6


def test_benchmark_train_scene_is_jaxs():
    """The tool's train scene at the smoke config's size (2 views): the
    synthetic scene and its host streams bit for bit as the JAX tool
    builds them."""
    cfg = Config.fromfile(SMOKE)
    meta = api.scene_meta_from_config(cfg)
    got = benchmark.train_scene(cfg, meta, 2, bf16=False)
    n_rand = cfg.model["N_rand"]
    want = make_synthetic_scene(
        seed=0, n_views=2, n_targets=1, hw=meta.img_shape,
        pad_hw=meta.pad_shape, n_rand=n_rand, n_boxes=4, max_gt=8,
        margin=10)
    want["rgb_s1"], want["rgb_s2"] = jax_rgb_stats(
        want["denorm_images"], want["intrinsic"], want["extrinsics"],
        want["origin"], cfg.model["n_voxels"], cfg.model["voxel_size"],
        meta.ori_shape, meta.img_shape)
    z = jax_sample_z(np.random.RandomState(0), n_rand,
                     *cfg.model["near_far_range"], cfg.model["N_samples"])
    (want["ray_s1u"], want["ray_s2u"], want["ray_s1m"], want["ray_cnt"]) = \
        jax_ray_stats(want["denorm_images"], want["intrinsic"],
                      want["extrinsics"], want["ray_o"], want["ray_d"], z,
                      meta.ori_shape, meta.img_shape)
    want["z_vals"] = z
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]),
                                      err_msg=k)


def test_publish_model_round_trip(tmp_path):
    model = api.init_detector(SMOKE, device="cpu", seed=3)
    ckpt = save_checkpoint(str(tmp_path / "in"), 4, dict(
        model=model.state_dict(), optimizer={"adamw": {"state": {}}},
        step=12, epoch=4))
    first = publish_model.main([ckpt, str(tmp_path / "out")])
    again = publish_model.main([ckpt, str(tmp_path / "out2")])
    assert first["sha256"] == again["sha256"] and len(first["sha256"]) == 8
    assert first["path"].endswith(f"ckpt_0.pth-{first['sha256']}")
    saved = torch.load(first["path"], weights_only=True)
    assert set(saved) == {"model", "meta"}
    assert saved["meta"] == dict(sha256=first["sha256"], step=12)
    loaded = api.init_detector(SMOKE, first["path"], device="cpu")
    assert publish_model.state_digest(loaded.state_dict()) == \
        first["sha256"]
    scene = make_synthetic_scene(seed=1, n_views=3, n_targets=1,
                                 hw=(240, 320), pad_hw=(240, 320),
                                 n_rand=8, n_boxes=2, max_gt=4, margin=10)
    want = api.eval_step(model, api.device_batch(model, scene))
    got = api.eval_step(loaded, api.device_batch(loaded, scene))
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_print_config_prints_the_jax_tools_text(monkeypatch):
    config = os.path.join(ROOT, "configs", "nerfdet",
                          "nerfdet_res50_2x_low_res.py")
    spec = importlib.util.spec_from_file_location(
        "jax_print_config", os.path.join(ROOT, "tools", "print_config.py"))
    jax_tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_tool)
    options = ["--options", "model.N_rand=1024", "data.workers_per_gpu=2"]
    texts = []
    for run in (lambda: print_config.main([config] + options),
                lambda: jax_tool.main()):
        monkeypatch.setattr(sys, "argv", ["print_config.py", config]
                            + options)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            run()
        texts.append(buf.getvalue())
    assert texts[0] == texts[1]
    assert "N_rand': 1024" in texts[0] and texts[0].count("\n") > 50


def test_print_config_and_publish_model_run_as_modules(tmp_path):
    """The tools as ``python -m`` runs them."""
    config = os.path.join(ROOT, "configs", "nerfdet",
                          "nerfdet_res50_2x_low_res.py")
    ckpt = save_checkpoint(str(tmp_path), 1, dict(
        model={"w": torch.ones(3)}, optimizer={}, step=1))
    (c1, out1, err1), (c2, out2, err2) = _run(
        [_cli("print_config") + [config],
         _cli("publish_model") + [ckpt, str(tmp_path / "pub")]], ROOT)
    assert c1 == 0, err1[-2000:]
    assert c2 == 0, err2[-2000:]
    assert "\nmodel = {" in out1
    assert '"sha256"' in out2
    assert JOIN_TIMEOUT >= 120
