"""SUN RGB-D ImVoxelNet training through the port, against the JAX package
on the CPU.

* The rotated 3D IoU of aligned pairs (``ops/rotated_iou_loss.py``)
  against JAX's float32 ``rotated_iou_3d_aligned``, jitted, on seeded
  yawed boxes: 1% perturbations, offsets at one yaw and random
  overlapping pairs: IoU within 1e-5, the gradient with respect to both
  boxes within 1e-4 of its max. The degenerate pairs of ROADMAP §3
  (boxes against themselves and shifted by 1e-6 m, and the collinear pair
  of unit boxes at yaw 0.3, 0.739 m apart along x) are pinned at what the
  port gives; JAX's compiled form differs at coincident boxes (ROADMAP
  §3), so they are not held to it.
* The yawed targets (``get_targets_v1`` and ``get_targets`` with
  ``yaw``) on boxes with random non-zero yaws: labels exact, centerness
  and the assigned boxes within 1e-6.
* The yawed loss sums (``head_loss_sums`` (V2) and ``head_loss_sums_v1``
  with ``yaw``) on seeded head outputs: the sums within 1e-5 relative,
  each sum's gradient with respect to the head outputs within 1e-4 of
  its max.
* One train step of ``tests/test_torch_sunrgbd.py``'s V1 toy (ResNet-50
  at one 48x64 view, the Atlas neck, the yawed V1 head) on two scenes
  whose boxes have random yaws, against JAX's step compiled without XLA's
  fusion pass: the tolerances and checks of
  ``tests/test_torch_imvoxelnet.py``'s toy step (loss terms 1e-4, every
  gradient 1e-3 of its max, the clip acting, parameters 1e-6 where the
  gradient is signal).
* The train split of ``imvoxelnet_sunrgbd.py`` (``RepeatDataset`` of 2,
  ``LoadAnnotations3D``) on a pkl JAX's ETL writes: the port's dataset
  and loader batches against JAX's array for array, the gt boxes padded
  to (G, 7) with the yaw in column 6.
* ``tools/train`` for one step then ``tools/test --eval mAP`` from its
  checkpoint, on a narrow override of ``imvoxelnet_sunrgbd.py`` at 48x64.

JAX's step runs once per test run (``computed_once``).
"""

import copy
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nerfdet_tpu.data import dataset as jdataset
from nerfdet_tpu.data import loader as jloader
from nerfdet_tpu.data.sunrgbd_etl import (create_sunrgbd_infos,
                                          write_synthetic_sunrgbd_raw)
from nerfdet_tpu.data.synthetic import make_synthetic_scene
from nerfdet_tpu.nn import heads as jheads
from nerfdet_tpu.nn import heads_v1 as jheads_v1
from nerfdet_tpu.ops import rotated_iou as jrotated_iou
from nerfdet_tpu.train import TrainState
from nerfdet_tpu.train import make_train_step as jax_train_step
from nerfdet_tpu.train import optim as joptim

from nerfdet_tpu_torch import api
from nerfdet_tpu_torch.config import Config
from nerfdet_tpu_torch.data.dataset import build_dataset
from nerfdet_tpu_torch.data.loader import BatchLoader
from nerfdet_tpu_torch.nn import heads as theads
from nerfdet_tpu_torch.nn import heads_v1 as theads_v1
from nerfdet_tpu_torch.ops.rotated_iou_loss import rotated_iou_3d_aligned
from nerfdet_tpu_torch.ops.voxel import get_points
from nerfdet_tpu_torch.parallel.train2d import (check_mesh_views,
                                                pipeline_views)
from nerfdet_tpu_torch.tools import test as test_cli
from nerfdet_tpu_torch.tools import train as train_cli
from nerfdet_tpu_torch.train import optim as toptim
from nerfdet_tpu_torch.train.step import make_train_step
from nerfdet_tpu_torch.utils.weight_convert import from_jax_variables

from tests.test_torch_imvoxelnet import (OPTIMIZER, REACHED, UNFUSED,
                                         _check_gradients,
                                         _check_loss_terms,
                                         _check_parameters, random_tree)
from tests.test_torch_session_cache import computed_once
from tests.test_torch_sunrgbd import (CONFIGS, IMG, N_VOX, RANGES, VOX,
                                      jax_toy, port_toy, yawed_boxes)
from tests.test_torch_train import MAX_NORM, _capture, _port_tree

SCENE_KEYS = ("imgs", "intrinsic", "extrinsics", "origin", "gt_boxes",
              "gt_labels", "gt_mask")
SCENE_SEEDS, WEIGHT_SEED = (3, 4), 40
N_CLS = 5


@pytest.fixture(autouse=True, scope="module")
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------
# the rotated 3D IoU loss form
# ---------------------------------------------------------------------

def _pairs(kind, n=400, seed=0):
    """Bottom-centered (n, 7) yawed pairs of one kind."""
    rng = np.random.RandomState(seed)
    a = np.concatenate([rng.uniform(-1, 1, (n, 2)),
                        rng.uniform(0, 0.5, (n, 1)),
                        rng.uniform(0.3, 2.0, (n, 3)),
                        rng.uniform(-np.pi, np.pi, (n, 1))], 1)
    if kind == "perturbed":  # 1% of each value
        b = a * (1 + rng.uniform(-0.01, 0.01, a.shape))
    elif kind == "same_yaw":  # moved in the plane, the yaw kept
        b = a.copy()
        b[:, :2] += rng.uniform(-0.5, 0.5, (n, 2))
    else:  # random pairs, near enough to overlap mostly
        b = a[rng.permutation(n)] * np.array([0.5, 0.5, 1, 1, 1, 1, 1])
    return a.astype(np.float32), b.astype(np.float32)


_JAX_IOU = jax.jit(lambda a, b: (
    jrotated_iou.rotated_iou_3d_aligned(a, b),
    jax.grad(lambda p, q: jrotated_iou.rotated_iou_3d_aligned(p, q).sum(),
             (0, 1))(a, b)))


def _port_iou(a, b):
    ta = torch.from_numpy(a).requires_grad_()
    tb = torch.from_numpy(b).requires_grad_()
    iou = rotated_iou_3d_aligned(ta, tb)
    iou.sum().backward()
    return iou.detach().numpy(), ta.grad.numpy(), tb.grad.numpy()


@pytest.mark.parametrize("kind", ["perturbed", "same_yaw", "random"])
def test_rotated_iou_loss_matches_jax(kind):
    a, b = _pairs(kind)
    want, (ga, gb) = _JAX_IOU(jnp.asarray(a), jnp.asarray(b))
    got, ta, tb = _port_iou(a, b)
    want = np.asarray(want)
    assert got.dtype == np.float32
    assert 0.8 < float((want > 0).mean()) and float(want.max()) > 0.5
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    for g, w in ((ta, np.asarray(ga)), (tb, np.asarray(gb))):
        assert float(np.abs(g - w).max()) <= 1e-4 * float(np.abs(w).max())


def test_rotated_iou_loss_pins_degenerate_pairs():
    """What the port gives where JAX's form breaks down (ROADMAP §3): a
    box against itself reads 1 (1e-5) with a gradient norm under 1e3
    (4,000 random boxes and the named cases of ``yawed_boxes``; the
    0.02 m thin box's 132 is the largest), shifted by 1e-6 m above 0.99;
    the collinear pair of ROADMAP §3 0.2349 (0.1501 in float64) with a
    gradient above 1e6 in y."""
    rng = np.random.RandomState(0)
    n = 4000
    a = np.concatenate([
        rng.uniform(-3, 3, (n, 2)), rng.uniform(-0.2, 1, (n, 1)),
        rng.uniform(0.2, 2, (n, 3)), rng.uniform(-np.pi, np.pi, (n, 1))],
        1).astype(np.float32)
    a = np.concatenate([a, yawed_boxes(0, 0)])
    iou, ga, gb = _port_iou(a, a.copy())
    np.testing.assert_allclose(iou, 1.0, rtol=0, atol=1e-5)
    norm = np.sqrt((ga ** 2).sum(1) + (gb ** 2).sum(1))
    assert np.isfinite(norm).all() and float(norm.max()) < 1e3
    shifted = a.copy()
    shifted[:, 0] += np.float32(1e-6)
    iou, ga, gb = _port_iou(a, shifted)
    assert float(iou.min()) > 0.99 and np.isfinite(ga).all()
    yaw, d = 0.3, 0.739  # the second box d along the first's x axis
    pair = np.array([[0, 0, 0, 1, 1, 1, yaw],
                     [d * np.cos(yaw), d * np.sin(yaw), 0, 1, 1, 1, yaw]],
                    np.float32)
    iou, ga, _ = _port_iou(pair[:1], pair[1:])
    assert abs(float(iou[0]) - 0.23495) < 1e-4
    assert abs(float(ga[0, 1])) > 1e6


# ---------------------------------------------------------------------
# the yawed targets and loss sums
# ---------------------------------------------------------------------

def _points(origin=(0.0, 3.0, -1.0)):
    pts = [get_points(tuple(v // 2 ** i for v in N_VOX),
                      tuple(s * 2 ** i for s in VOX), origin).reshape(-1, 3)
           for i in range(3)]
    ids = torch.cat([torch.full((p.shape[0],), i, dtype=torch.int32)
                     for i, p in enumerate(pts)])
    return pts, ids


def _yawed_gt(seed, n=5, max_gt=7):
    """Padded bottom-centered boxes in the volume around (0, 3, -1), with
    random non-zero yaws; two of one volume (the first box takes the
    point)."""
    rng = np.random.RandomState(seed)
    boxes = np.zeros((max_gt, 7), np.float32)
    boxes[:n, 0] = rng.uniform(-2.0, 2.0, n)
    boxes[:n, 1] = rng.uniform(1.0, 5.0, n)
    boxes[:n, 2] = rng.uniform(-2.0, -1.0, n)
    boxes[:n, 3:6] = rng.uniform(0.6, 2.6, (n, 3))
    boxes[:n, 6] = rng.uniform(0.2, 1.4, n) * rng.choice([-1, 1], n)
    boxes[1, 3:6] = boxes[0, 3:6]
    labels = rng.randint(0, N_CLS, max_gt).astype(np.int64)
    return boxes, labels, np.arange(max_gt) < n


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("head,topk", [("v1", 0), ("v1", 18), ("v2", 18)])
def test_yawed_targets_match_jax(head, topk, seed):
    pts, ids = _points()
    points = torch.cat(pts)
    boxes, labels, mask = _yawed_gt(seed)
    jargs = (jnp.asarray(points.numpy()), jnp.asarray(ids.numpy()))
    targs = (points, ids)
    gt = (boxes, labels, mask)
    if head == "v1":
        want = jheads_v1.get_targets_v1(
            *jargs, RANGES, *map(jnp.asarray, gt), N_CLS, topk, yaw=True)
        got = theads_v1.get_targets_v1(
            *targs, RANGES, *map(torch.from_numpy, gt), N_CLS, topk,
            yaw=True)
        fg = got[2].numpy() < N_CLS
    else:
        want = jheads.get_targets(*jargs, *map(jnp.asarray, gt), 3, 27,
                                  topk, yaw=True)
        got = theads.get_targets(*targs, *map(torch.from_numpy, gt), 3, 27,
                                 topk, yaw=True)
        fg = got[2].numpy() >= 0
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert 0 < int(fg.sum()) < len(fg)
    assert got[1].shape == (len(fg), 7)
    np.testing.assert_allclose(got[0].numpy()[fg], np.asarray(want[0])[fg],
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=0,
                               atol=1e-6)
    # the targets are the assigned boxes, gravity-centered, yaw kept
    assert set(np.unique(got[1].numpy()[fg, 6])) <= set(boxes[mask, 6])


def _yawed_head_outs(seed):
    """Per-level (centerness, 7 regression values, cls) near where the
    yawed targets put the boxes, and a view-count volume."""
    rng = np.random.RandomState(seed)
    outs = []
    for i in range(3):
        shape = tuple(v // 2 ** i for v in N_VOX)
        outs.append((rng.normal(0, 1, shape + (1,)),
                     np.concatenate([
                         np.exp(rng.normal(-0.3, 0.4, shape + (6,))),
                         rng.normal(0, 1, shape + (1,))], -1),
                     rng.normal(-2, 1, shape + (N_CLS,))))
    valid = rng.randint(0, 2, N_VOX).astype(np.float32)
    return [tuple(np.asarray(t, np.float32) for t in o) for o in outs], valid


@pytest.mark.parametrize("head", ["v1", "v2"])
def test_yawed_loss_sums_match_jax(head):
    outs, valid = _yawed_head_outs(11)
    boxes, labels, mask = _yawed_gt(5)
    pts, _ = _points()
    keys = ("cls_sum", "centerness_sum", "bbox_sum")

    def jax_sums(o):
        args = (o, jnp.asarray(valid), [jnp.asarray(p.numpy()) for p in pts])
        gt = (jnp.asarray(boxes), jnp.asarray(labels), jnp.asarray(mask))
        if head == "v1":
            return jheads_v1.head_loss_sums_v1(*args, RANGES, *gt, N_CLS, 18,
                                               True)
        return jheads.head_loss_sums(*args, *gt, 3, 27, 18, N_CLS, yaw=True)

    jo = [tuple(jnp.asarray(t) for t in o) for o in outs]
    want, grads = jax.jit(lambda o: (jax_sums(o), {
        k: jax.grad(lambda x, k=k: jax_sums(x)[k])(o) for k in keys}))(jo)
    to = [tuple(torch.from_numpy(t).requires_grad_() for t in o)
          for o in outs]
    gt = (torch.from_numpy(boxes), torch.from_numpy(labels),
          torch.from_numpy(mask))
    args = (to, torch.from_numpy(valid), pts)
    got = (theads_v1.head_loss_sums_v1(*args, RANGES, *gt, N_CLS, 18, True)
           if head == "v1" else
           theads.head_loss_sums(*args, *gt, 3, 27, 18, N_CLS, yaw=True))
    assert float(got["n_pos"]) == float(want["n_pos"]) > 3
    for k in keys + ("bbox_avg",):
        w = float(want[k])
        assert abs(float(got[k].detach()) - w) <= 1e-5 * abs(w), k
    for k in keys:
        g = torch.autograd.grad(got[k], [t for o in to for t in o],
                                allow_unused=True, retain_graph=True)
        for gt_, w in zip(g, [t for o in grads[k] for t in o]):
            w = np.asarray(w)
            gt_ = np.zeros_like(w) if gt_ is None else gt_.numpy()
            assert float(np.abs(gt_ - w).max()) <= 1e-4 * max(
                float(np.abs(w).max()), 1e-30), k
    # the rotated IoU's gradient reaches the angle channel
    g = torch.autograd.grad(got["bbox_sum"], [o[1] for o in to])
    assert float(g[0][..., 6].abs().max()) > 0


# ---------------------------------------------------------------------
# one train step of the yawed V1 toy
# ---------------------------------------------------------------------

def yawed_scene(seed):
    """A one-view synthetic scene whose boxes have random non-zero yaws."""
    s = make_synthetic_scene(seed=seed, n_views=1, n_targets=1, hw=IMG,
                             pad_hw=IMG, n_rand=8, n_boxes=3, max_gt=4,
                             margin=2)
    s = {k: s[k] for k in SCENE_KEYS}
    rng = np.random.RandomState(seed + 100)
    n = int(s["gt_mask"].sum())
    s["gt_boxes"] = s["gt_boxes"].copy()
    s["gt_boxes"][:n, 6] = (rng.uniform(0.2, 1.4, n)
                            * rng.choice([-1, 1], n)).astype(np.float32)
    return s


def _jax_step_reference():
    """Random JAX variables of the V1 toy at ``jax.eval_shape``'s shapes
    and JAX's train step on both scenes, compiled ``UNFUSED``."""
    jmodel = jax_toy("v1")
    scenes = [yawed_scene(s) for s in SCENE_SEEDS]
    first = {k: jnp.asarray(v) for k, v in scenes[0].items()}
    shapes = jax.eval_shape(lambda k: jmodel.init(k, first),
                            jax.random.PRNGKey(0))
    variables = {"params": random_tree(shapes["params"], WEIGHT_SEED),
                 "batch_stats": random_tree(shapes["batch_stats"],
                                            WEIGHT_SEED + 1)}
    params = variables["params"]
    tx = optax.chain(_capture(), joptim.build_optimizer(
        params, OPTIMIZER, grad_clip=dict(max_norm=MAX_NORM)))
    state = TrainState.create(params, variables["batch_stats"], tx)
    step = jax_train_step(jmodel, tx, rgb_supervision=False, donate=False)
    batch = {k: np.stack([s[k] for s in scenes]) for k in SCENE_KEYS}
    key = jax.random.PRNGKey(0)
    new, metrics = step.lower(state, batch, key).compile(
        compiler_options=UNFUSED)(state, batch, key)
    raw = new.opt_state[0]
    clip = optax.clip_by_global_norm(MAX_NORM)
    clipped, _ = jax.jit(clip.update)(raw, clip.init(raw))
    zero = jax.tree_util.tree_map(np.zeros_like, variables["batch_stats"])
    return dict(variables=variables,
                metrics={k: np.asarray(v) for k, v in metrics.items()},
                grads=_port_tree(clipped, zero),
                params=_port_tree(new.params, new.batch_stats))


def test_yawed_v1_toy_train_step_matches_jax(tmp_path_factory):
    """One step of the yawed V1 toy on two one-view scenes: loss terms,
    clipped gradients and parameters as ``tests/test_torch_imvoxelnet.py``
    holds its toy's; the rotated IoU loss reaches the angle channel."""
    ref = computed_once(tmp_path_factory, "torch_sunrgbd_train_step",
                        _jax_step_reference)
    scenes = [yawed_scene(s) for s in SCENE_SEEDS]
    assert all(np.abs(s["gt_boxes"][s["gt_mask"], 6]).min() > 0.1
               for s in scenes)
    start = from_jax_variables(ref["variables"])
    model = port_toy("v1")
    model.load_state_dict(start, strict=True)
    opt = toptim.build_optimizer(model, OPTIMIZER,
                                 grad_clip=dict(max_norm=MAX_NORM))
    batch = api.train_batch(model, scenes)
    assert all(b["gt_boxes"].shape == (4, 7) for b in batch)
    metrics = make_train_step(model, opt)(batch)
    grads = {n: (torch.zeros_like(p) if p.grad is None else p.grad.clone())
             for n, p in model.named_parameters()}
    toy = dict(ref=ref, start=start, metrics=metrics, grads=grads,
               state=copy.deepcopy(model.state_dict()), model=model)
    _check_loss_terms(toy)
    # the rotated IoU loss reaches the angle's regression row; the
    # finest level holds no positive here (its range ends at 0.75 m)
    _check_gradients(toy, [n for n in REACHED if "scales.0" not in n])
    assert float(grads["bbox_head.reg_conv.weight"][6].abs().max()) > 0
    _check_parameters(toy)
    assert float(metrics["loss_bbox"]) > 0


# ---------------------------------------------------------------------
# the train split, and the CLIs
# ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def train_pkls(tmp_path_factory):
    """Train and val pkls (and their JPEG views) written by JAX's raw
    fixture and ETL."""
    root = str(tmp_path_factory.mktemp("sunrgbd_train"))
    write_synthetic_sunrgbd_raw(root, n_frames=3, splits=("train", "val"),
                                hw=(30, 40), seed=5)
    paths = create_sunrgbd_infos(root, splits=("train", "val"),
                                 num_points=256, num_workers=1)
    return root + "/", dict(zip(("train", "val"), paths))


def toy_config(tmp_path, root, pkls):
    """``imvoxelnet_sunrgbd.py`` narrowed (FPN 8, an Atlas neck at 8-64
    channels over 16x16x8, the head at 8) at the fixture's 30x40 views
    resized to 48x64, two scenes a batch, on the fixture's files."""
    base = os.path.join(CONFIGS, "imvoxelnet_sunrgbd.py")
    path = tmp_path / "toy_sunrgbd.py"
    path.write_text(f"""
_base_ = [{base!r}]
ori_shape = (30, 40)
model = dict(
    neck=dict(out_channels=8),
    neck_3d=dict(channels=[8, 16, 32, 64], out_channels=8,
                 down_layers=[1, 1, 1, 1], up_layers=[1, 1, 1]),
    bbox_head=dict(n_channels=8), n_voxels=(16, 16, 8),
    voxel_size=(.4, .4, .4))
_mv = dict(type='MultiViewPipeline', n_images=1, nerf_target_views=0,
           transforms=[dict(type='LoadImageFromFile'),
                       dict(type='Resize', img_scale=(64, 48),
                            keep_ratio=True),
                       dict(type='Normalize', mean=[123.675, 116.28, 103.53],
                            std=[58.395, 57.12, 57.375], to_rgb=True),
                       dict(type='Pad', size=(48, 64))])
train_pipeline = [dict(type='LoadAnnotations3D'), _mv]
test_pipeline = [dict(_mv, loading='stride')]
data = dict(
    samples_per_gpu=2, workers_per_gpu=1,
    train=dict(dataset=dict(data_root={root!r}, ann_file={pkls['train']!r},
                            pipeline=train_pipeline)),
    val=dict(data_root={root!r}, ann_file={pkls['val']!r},
             pipeline=test_pipeline),
    test=dict(data_root={root!r}, ann_file={pkls['val']!r},
              pipeline=test_pipeline))
""")
    return str(path)


def test_sunrgbd_train_batches_match_jax(train_pkls, tmp_path):
    """The config's train split through both packages' dataset and loader
    (one worker, seed 0): every batch array for array; the step's inputs
    hold the gt boxes padded to (G, 7) with the yaws in column 6."""
    cfg = Config.fromfile(toy_config(tmp_path, *train_pkls))
    train = cfg.data["train"]
    assert train["type"] == "RepeatDataset" and train["times"] == 2
    got, want = (build_dataset(train), jdataset.build_dataset(train))
    assert type(got).__name__ == type(want).__name__ == (
        "SunRgbdMultiViewDataset")
    assert len(got) == len(want) == 6
    batches = [list(BatchLoader(got, 2, num_workers=1, seed=0)),
               list(jloader.BatchLoader(want, 2, num_workers=1, seed=0))]
    assert len(batches[0]) == len(batches[1]) == 3
    yawed = 0
    for mine, theirs in zip(*batches):
        stacked = jloader.stack_scenes(mine)
        assert set(stacked) == set(theirs), sorted(stacked)
        for k in theirs:
            assert stacked[k].dtype == theirs[k].dtype, k
            np.testing.assert_array_equal(stacked[k], theirs[k], err_msg=k)
        assert theirs["gt_boxes"].shape[1:] == (got.max_gt, 7)
        yawed += int((theirs["gt_boxes"][..., 6] != 0).sum())
    assert yawed > 0
    model = api.init_detector(cfg, device="cpu")
    for scene in api.train_batch(model, batches[0][0]):
        assert scene["gt_boxes"].shape == (got.max_gt, 7)
        assert scene["gt_boxes"].dtype == torch.float32
        assert scene["imgs"].shape[0] == 1


def test_sunrgbd_toy_config_trains_and_tests_through_the_clis(
        train_pkls, tmp_path, monkeypatch):
    """``tools/train`` one step, then ``tools/test --eval mAP`` from its
    checkpoint; ``--mesh-views`` on a one-view scene fails at
    ``check_mesh_views``. TensorBoard's writer is left out (here its
    import loads TensorFlow, ~10 s)."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    config = toy_config(tmp_path, *train_pkls)
    result = train_cli.main([config, "--work-dir", str(tmp_path / "w"),
                             "--max-steps", "1", "--no-validate",
                             "--device", "cpu"])
    (step,) = result["history"]
    assert all(np.isfinite(step[k]) for k in ("loss", "loss_bbox",
                                              "grad_norm"))
    metrics = test_cli.main([config, result["checkpoints"][-1], "--eval",
                             "mAP", "--device", "cpu"])
    assert {"mAP_0.25", "mAP_0.50"} <= set(metrics)
    assert all(np.isfinite(v) for v in metrics.values())
    cfg = Config.fromfile(os.path.join(CONFIGS, "imvoxelnet_sunrgbd.py"))
    views = {"train": pipeline_views(cfg.data["train"])}
    assert views == {"train": 1}
    with pytest.raises(ValueError, match="does not divide the 1 views a "
                                         "train scene"):
        check_mesh_views(2, 2, views, cfg.model.get("N_rand", 2048))
