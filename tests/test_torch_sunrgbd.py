"""SUN RGB-D ImVoxelNet inference and evaluation through the port, against
the JAX package on the CPU.

* The rotated BEV overlap and the pairwise 3D IoU of yawed boxes
  (``core/boxes.boxes_iou_3d(with_yaw=True)``, ``DepthBoxes3D.overlaps``)
  against JAX's as it runs here (its C++ ``ops/native`` library) and its
  numpy form, on seeded boxes with identical, 45 degree, touching,
  disjoint, nested and thin pairs: within 1e-5 of the largest area. The
  pair where the two JAX forms disagree (equal yaws, collinear edges:
  JAX's float32 numpy form loses vertices) is pinned: the port gives the
  native area.
* ``core/nms.nms_bev_rotated``'s kept indices equal JAX's, native and
  numpy (``nerfdet_tpu.ops.native.nms_rotated_bev`` patched away in the
  test); where they disagree the port keeps the native boxes.
* ``indoor_eval`` with yawed GT and detections: every value within 1e-6
  at (0.25, 0.5) and (0.15,).
* The yawed V1 head (``SunRgbdImVoxelHead``) and V2 head
  (``SunRgbdImVoxelHeadV2``): forwards within 1e-5 of each output's
  max; the decode's
  candidate indices exact and boxes within 1e-5 against both JAX decodes
  (``get_candidate_bboxes_v1(yaw=True)``, ``get_candidate_bboxes(
  yaw=True)``); at bfloat16 the port at least 2x closer to JAX's
  bfloat16 than that is to its float32 (the bar of
  ``tests/test_torch_imvoxelnet.py``'s bf16 test).
* The two datasets against JAX's on one pkl that JAX's
  ``write_synthetic_sunrgbd_raw`` + ``create_sunrgbd_infos`` write:
  intrinsic, extrinsics, c2w, origin, boxes and labels exact, images
  bitwise, ``evaluate`` equal at each split's IoUs; ``inference_detector``
  keeps JAX's origin and threshold.
* The whole slice: two toy ``IndoorImVoxelNet`` (ResNet-50 at one 48x64
  view, FPN 8; an Atlas neck and the yawed V1 head, or the fast neck and
  the yawed V2 head), random JAX weights through ``from_jax_variables``:
  head outputs within 1e-4, detections after rotated NMS equal to JAX's
  ``detections_from_candidates`` (labels and order exact, boxes 1e-5 of
  their largest coordinate; from JAX's own candidates 1e-5).
* The six configs build through ``init_detector`` on the CPU with JAX's
  fields and through ``init_trainer`` at float32 and bfloat16, and pass
  ``tools/train``'s refusals with and without ``--distributed``
  (their training against JAX: ``tests/test_torch_sunrgbd_train.py``);
  the three total-scene configs are refused everywhere by name.

JAX's references are compiled once a run (``computed_once``).
"""

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfdet_tpu import api as japi
from nerfdet_tpu.api import scene_meta_from_config as jax_meta
from nerfdet_tpu.config import Config as JaxConfig
from nerfdet_tpu.core import boxes as jboxes
from nerfdet_tpu.core import eval as jeval
from nerfdet_tpu.core import nms as jnms
from nerfdet_tpu.data import dataset as jdataset
from nerfdet_tpu.data.sunrgbd_etl import (create_sunrgbd_infos,
                                          write_synthetic_sunrgbd_raw)
from nerfdet_tpu.data.synthetic import make_synthetic_scene
from nerfdet_tpu.models.builder import build_model as jax_build_model
from nerfdet_tpu.models.imvoxelnet_indoor import \
    IndoorImVoxelNet as JaxIndoor
from nerfdet_tpu.models.imvoxelnet_indoor import _Neck3DCfg
from nerfdet_tpu.models.nerfdet import SceneMeta as JaxSceneMeta
from nerfdet_tpu.nn import heads as jheads
from nerfdet_tpu.nn import heads_v1 as jheads_v1
from nerfdet_tpu.ops import native

from nerfdet_tpu_torch import api
from nerfdet_tpu_torch.config import Config
from nerfdet_tpu_torch.core import boxes as tboxes
from nerfdet_tpu_torch.core import eval as teval
from nerfdet_tpu_torch.core import nms as tnms
from nerfdet_tpu_torch.data.dataset import build_dataset
from nerfdet_tpu_torch.models.builder import build_model, unported_refusal
from nerfdet_tpu_torch.models.imvoxelnet_indoor import IndoorImVoxelNet
from nerfdet_tpu_torch.models.nerfdet import SceneMeta
from nerfdet_tpu_torch.nn import heads as theads
from nerfdet_tpu_torch.nn import heads_v1 as theads_v1
from nerfdet_tpu_torch.ops import rotated_iou
from nerfdet_tpu_torch.tools import train as train_cli
from nerfdet_tpu_torch.utils import weight_convert
from nerfdet_tpu_torch.utils.weight_convert import from_jax_variables
from tests.test_torch_imvoxelnet import _bf16_rel, random_tree
from tests.test_torch_session_cache import computed_once

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(ROOT, "configs", "imvoxelnet")
SUNRGBD = ("imvoxelnet_sunrgbd.py", "imvoxelnet_sunrgbd_top27.py",
           "imvoxelnet_sunrgbd_fast.py", "imvoxelnet_perspective_sunrgbd.py",
           "imvoxelnet_perspective_sunrgbd_top27.py",
           "imvoxelnet_perspective_sunrgbd_fast.py")
TOTAL = ("imvoxelnet_total_sunrgbd.py", "imvoxelnet_total_sunrgbd_fast.py",
         "imvoxelnet_total_sunrgbd_top27.py")
LAYOUT = "ROADMAP §1 item 3.*(layout|total-scene)"

IMG = (48, 64)
N_VOX, VOX = (16, 16, 8), (0.4, 0.4, 0.4)
ATLAS = dict(channels=(8, 16, 32), out_channels=8, down_layers=(1, 1, 1),
             up_layers=(1, 1))
FAST = dict(type="FastIndoorImVoxelNeck", out_channels=8, n_blocks=(1, 1, 1))
RANGES = ((-1.0, 0.75), (0.75, 1.5), (1.5, 1e8))
TOY = dict(fpn_out_channels=8, n_classes=5, head_n_channels=8,
           head_n_convs=1, head_n_reg_outs=7, n_voxels=N_VOX,
           voxel_size=VOX, regress_ranges=RANGES)
HEADS = {"v1": ("SunRgbdImVoxelHead", ATLAS),
         "v2": ("SunRgbdImVoxelHeadV2", FAST)}
NMS_PRE, SCORE_THR, NMS_THR = 64, 0.05, 0.15


@pytest.fixture(autouse=True, scope="module")
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def jax_numpy_geometry(monkeypatch):
    """JAX's numpy forms: its C++ library's entry points return None."""
    monkeypatch.setattr(native, "rotated_bev_overlap", lambda *a: None)
    monkeypatch.setattr(native, "nms_rotated_bev", lambda *a: None)


# ---------------------------------------------------------------------
# rotated overlap, NMS and mAP
# ---------------------------------------------------------------------

def yawed_boxes(seed, n):
    """Bottom-centered (n, 7) yawed boxes, then the named cases: an
    identical pair, a 45 degree pair, a touching pair, a disjoint pair, a
    nested pair and a thin box across a wide one."""
    rng = np.random.RandomState(seed)
    b = np.concatenate([rng.uniform(-1.5, 1.5, (n, 2)),
                        rng.uniform(0.0, 0.5, (n, 1)),
                        rng.uniform(0.2, 1.6, (n, 3)),
                        rng.uniform(-np.pi, np.pi, (n, 1))], 1)
    cases = [
        [0.3, 0.2, 0.1, 1.0, 0.6, 0.8, 0.7],      # identical to the next
        [0.3, 0.2, 0.1, 1.0, 0.6, 0.8, 0.7],
        [0.0, 0.0, 0.0, 1.0, 1.0, 1.0, 0.0],      # 45 degrees
        [0.0, 0.0, 0.2, 1.0, 1.0, 1.0, np.pi / 4],
        [2.0, 2.0, 0.0, 1.0, 1.0, 1.0, 0.0],      # touching along x
        [3.0, 2.0, 0.0, 1.0, 1.0, 1.0, 0.0],
        [-3.0, 3.0, 0.0, 0.5, 0.5, 0.5, 0.4],     # disjoint
        [-1.0, -3.0, 0.0, 0.5, 0.5, 0.5, -0.4],
        [1.0, -1.0, 0.0, 2.0, 1.5, 1.0, 0.3],     # nested
        [1.0, -1.0, 0.2, 0.8, 0.5, 0.4, 0.5],
        [0.0, 2.0, 0.0, 3.0, 0.02, 1.0, 0.25],    # thin across a wide one
        [0.0, 2.0, 0.0, 1.0, 1.0, 1.0, -0.6],
    ]
    return np.concatenate([b, np.asarray(cases)]).astype(np.float32)


def collinear_pair(yaw=0.3, d=0.73893094):
    """Two unit boxes of one yaw, one shifted along their x axis by d:
    their long edges are collinear (BEV IoU 0.1502)."""
    d = np.float32(d)
    return np.array([[0, 0, 0, 1, 1, 1, yaw],
                     [d * np.cos(yaw), d * np.sin(yaw), 0, 1, 1, 1, yaw]],
                    np.float32)


def test_rotated_overlap_and_iou_match_jax_native():
    assert native.available()  # JAX runs its C++ library here
    a = yawed_boxes(0, 24)
    area = native.rotated_bev_overlap(a, a)
    got = tboxes.rotated_bev_overlap_f32(a, a)
    assert area.max() > 1.0 and got.dtype == np.float32
    np.testing.assert_allclose(got, area, rtol=0, atol=1e-5 * area.max())
    for i in (24, 26, 32, 34):  # identical, 45 degrees, nested, thin
        assert got[i, i + 1] > 0.02
    for i in (28, 30):  # touching, disjoint: none
        assert got[i, i + 1] <= 1e-6
    for mode in ("iou", "iof"):
        np.testing.assert_allclose(
            tboxes.boxes_iou_3d(a, a, with_yaw=True, mode=mode),
            jboxes.boxes_iou_3d(a, a, with_yaw=True, mode=mode), rtol=0,
            atol=1e-5)
    got = tboxes.DepthBoxes3D(a, origin=(0.5, 0.5, 0.5))
    want = jboxes.DepthBoxes3D(a, origin=(0.5, 0.5, 0.5))
    np.testing.assert_allclose(got.overlaps(got), want.overlaps(want),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(rotated_iou.rotated_bev_overlap(
        a.astype(np.float64), a.astype(np.float64)), area, rtol=0, atol=1e-6)


def test_rotated_overlap_and_iou_match_jax_numpy(jax_numpy_geometry):
    a = yawed_boxes(1, 24)
    want = jboxes.boxes_iou_3d(a, a, with_yaw=True)
    from nerfdet_tpu.ops.rotated_iou import rotated_bev_overlap as jax_np
    area = jax_np(a, a)
    np.testing.assert_allclose(tboxes.rotated_bev_overlap_f32(a, a), area,
                               rtol=0, atol=1e-5 * area.max())
    np.testing.assert_allclose(tboxes.boxes_iou_3d(a, a, with_yaw=True),
                               want, rtol=0, atol=1e-5)
    # where the two JAX forms disagree: JAX's float32 numpy form loses the
    # vertices of collinear edges and gives half the area; the port gives
    # the native area
    pair = collinear_pair()
    numpy_area = float(jax_np(pair[:1], pair[1:])[0, 0])
    port_area = float(tboxes.rotated_bev_overlap_f32(pair[:1], pair[1:])[
        0, 0])
    assert abs(port_area - 0.2610691) < 1e-6
    assert abs(numpy_area - port_area / 2) < 1e-5


@pytest.mark.parametrize("thresh", [0.15, 0.25])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_nms_bev_rotated_keeps_jax_indices(seed, thresh, monkeypatch):
    rng = np.random.RandomState(seed)
    n = 60
    centers = rng.uniform(-1.5, 1.5, (6, 2))[rng.randint(0, 6, n)]
    bev = np.concatenate([centers + rng.normal(0, 0.15, (n, 2)),
                          rng.uniform(0.3, 1.2, (n, 2)),
                          rng.uniform(-np.pi, np.pi, (n, 1))],
                         1).astype(np.float32)
    scores = rng.uniform(0, 1, n).astype(np.float32)
    scores[5] = scores[9]  # a tie: argsort's order
    got = tnms.nms_bev_rotated(bev, scores, thresh)
    want_native = jnms.nms_bev_rotated(bev, scores, thresh)
    assert 1 < len(got) < n
    np.testing.assert_array_equal(got, want_native)
    monkeypatch.setattr(native, "nms_rotated_bev", lambda *a: None)
    np.testing.assert_array_equal(got, jnms.nms_bev_rotated(bev, scores,
                                                            thresh))
    monkeypatch.undo()
    if seed == 0:  # the collinear pair: native suppresses, numpy keeps
        pair = collinear_pair()[:, [0, 1, 3, 4, 6]]
        two = np.array([0.9, 0.8], np.float32)
        np.testing.assert_array_equal(tnms.nms_bev_rotated(pair, two, 0.15),
                                      [0])
        np.testing.assert_array_equal(jnms.nms_bev_rotated(pair, two, 0.15),
                                      [0])
        monkeypatch.setattr(native, "nms_rotated_bev", lambda *a: None)
        np.testing.assert_array_equal(jnms.nms_bev_rotated(pair, two, 0.15),
                                      [0, 1])


def _yawed_annos(seed, n_scenes=4, n_classes=10):
    """Gravity-centered yawed GT (the pkl's ``annos``) and detections
    (bottom-centered, yaw jittered) near it, with wrong labels and
    strays."""
    rng = np.random.RandomState(seed)
    gts, dets = [], []
    for s in range(n_scenes):
        n = 0 if s == 2 else rng.randint(2, 6)
        g = yawed_boxes(seed * 10 + s, n)[:n]
        g[:, 2] += g[:, 5] / 2
        gts.append(dict(gt_num=n, gt_boxes_upright_depth=g,
                        **{"class": rng.randint(0, n_classes, n)}))
        near = g.copy()
        near[:, 2] -= near[:, 5] / 2
        near[:, :3] += rng.normal(0, 0.1, (n, 3))
        near[:, 6] += rng.normal(0, 0.2, n)
        stray = yawed_boxes(seed * 10 + s + 5, 3)[:3]
        boxes = np.concatenate([near, stray]).astype(np.float32)
        labels = np.concatenate([gts[-1]["class"],
                                 rng.randint(0, n_classes, 3)])
        if n:
            labels[0] = (labels[0] + 1) % n_classes
        dets.append(dict(boxes_3d=boxes, labels_3d=labels.astype(np.int64),
                         scores_3d=rng.uniform(0, 1, len(boxes)).astype(
                             np.float32)))
    return gts, dets


@pytest.mark.parametrize("metric", [(0.25, 0.5), (0.15,)])
def test_indoor_eval_yawed_matches_jax(metric):
    gts, dets = _yawed_annos(3)
    label2cat = {i: f"c{i}" for i in range(10)}
    got = teval.indoor_eval(gts, dets, list(metric), label2cat)
    want = jeval.indoor_eval(gts, dets, list(metric), label2cat)
    assert set(got) == set(want)
    assert want[f"mAP_{metric[0]:.2f}"] > 0
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-6, k


# ---------------------------------------------------------------------
# the yawed heads: forward, decode, bfloat16
# ---------------------------------------------------------------------

def _scales(seed, c=8):
    rng = np.random.RandomState(seed)
    return [rng.normal(0, 1, (1,) + tuple(v // 2 ** i for v in N_VOX)
                       + (c,)).astype(np.float32) for i in range(3)]


def _jax_head(kind, dtype=jnp.float32):
    if kind == "v1":
        return jheads_v1.ImVoxelHeadV1(n_classes=5, n_channels=8, n_convs=1,
                                       n_reg_outs=7, regress_ranges=RANGES,
                                       yaw=True, dtype=dtype)
    return jheads.ScanNetImVoxelHeadV2(n_classes=5, n_channels=8,
                                       n_reg_outs=7, n_scales=3, dtype=dtype)


def _port_head(kind, variables, dtype=torch.float32):
    head = (theads_v1.ImVoxelHeadV1(8, 5, 8, 1, 7, RANGES, yaw=True,
                                    dtype=dtype) if kind == "v1" else
            theads.ScanNetImVoxelHeadV2(5, 8, 7, 3, dtype=dtype))
    state = {}
    params = variables["params"]
    weight_convert._layer_bn_tree(
        state, "h", {k: v for k, v in params.items() if k != "scales"},
        variables.get("batch_stats", {}), weight_convert._conv)
    for i, v in enumerate(params["scales"]):
        state[f"h.scales.{i}.scale"] = torch.tensor(float(v))
    head.load_state_dict({k[2:]: v for k, v in state.items()}, strict=True)
    return head.eval()


def _head_reference(kind):
    xs = _scales(4)
    mod32, mod16 = _jax_head(kind), _jax_head(kind, jnp.bfloat16)
    shapes = jax.eval_shape(lambda k: mod32.init(k, [jnp.asarray(x)
                                                     for x in xs]),
                            jax.random.PRNGKey(0))
    variables = {"params": random_tree(shapes["params"], 9)}
    if "batch_stats" in shapes:
        variables["batch_stats"] = random_tree(shapes["batch_stats"], 10)

    def run(mod, opts):
        fn = lambda v, a: mod.apply(v, a)  # noqa: E731
        args = (variables, [jnp.asarray(x) for x in xs])
        return jax.jit(fn).lower(*args).compile(compiler_options=opts)(
            *args)

    return dict(xs=xs, variables=variables,
                f32=[[np.asarray(t)[0] for t in o]
                     for o in run(mod32, None)],
                bf16=[[np.asarray(t.astype(jnp.float32))[0] for t in o]
                      for o in run(mod16, {"xla_allow_excess_precision":
                                           False})])


def _mlvl_points(origin=(0.0, 3.0, -1.0)):
    from nerfdet_tpu_torch.ops.voxel import get_points
    return [get_points(tuple(v // 2 ** i for v in N_VOX),
                       tuple(s * 2 ** i for s in VOX), origin).reshape(-1, 3)
            for i in range(3)]


@pytest.mark.parametrize("kind", ["v1", "v2"])
def test_yawed_head_forward_and_decode_match_jax(kind, tmp_path_factory):
    """The head's forward (f32 1e-5, the angle channel raw), the decode
    against both JAX decodes, and the bfloat16 forward."""
    ref = computed_once(tmp_path_factory, f"torch_sunrgbd_head_{kind}",
                        lambda: _head_reference(kind))
    head = _port_head(kind, ref["variables"])
    xs = [torch.from_numpy(x).permute(0, 4, 1, 2, 3) for x in ref["xs"]]
    with torch.no_grad():
        outs = [[t[0].permute(1, 2, 3, 0) for t in o] for o in head(xs)]
    assert outs[0][1].shape[-1] == 7
    for got, want in zip(outs, ref["f32"]):
        for a, b in zip(got, want):  # 1e-5 of each output's max
            np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                       atol=1e-5 * float(np.abs(b).max()))
    assert float(outs[0][1][..., 6].min()) < 0  # the angle is not exp'd

    # the decode: the same head outputs through each package
    rng = np.random.RandomState(5)
    valid = rng.randint(0, 2, N_VOX).astype(np.float32)
    pts = _mlvl_points()
    houts = [tuple(np.asarray(t) for t in o) for o in ref["f32"]]
    got_b, got_s = theads.get_candidate_bboxes(
        [tuple(torch.from_numpy(t) for t in o) for o in houts],
        torch.from_numpy(valid), pts, NMS_PRE, 5, yaw=True)
    args = ([tuple(jnp.asarray(t) for t in o) for o in houts],
            jnp.asarray(valid), [jnp.asarray(p.numpy()) for p in pts],
            NMS_PRE, 5)
    for want_b, want_s in (jheads_v1.get_candidate_bboxes_v1(*args, True),
                           jheads.get_candidate_bboxes(*args, yaw=True)):
        assert got_b.shape == (NMS_PRE * 2 + 32, 7)
        np.testing.assert_allclose(got_b.numpy(), np.asarray(want_b),
                                   rtol=0, atol=1e-5)
        np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s),
                                   rtol=0, atol=1e-6)
    # the candidate indices of each level, exactly
    for c, _, s in houts:
        sc = (torch.sigmoid(torch.from_numpy(s.reshape(-1, 5)))
              * torch.sigmoid(torch.from_numpy(c.reshape(-1)))[:, None])
        jsc = (jax.nn.sigmoid(jnp.asarray(s.reshape(-1, 5)))
               * jax.nn.sigmoid(jnp.asarray(c.reshape(-1)))[:, None])
        k = min(NMS_PRE, sc.shape[0])
        np.testing.assert_array_equal(
            theads._top_k_ids(sc.max(dim=1).values, k).numpy(),
            np.asarray(jax.lax.top_k(jsc.max(axis=1), k)[1]))

    # bfloat16: at least 2x closer to JAX's bfloat16 than that is to f32
    head16 = _port_head(kind, ref["variables"], torch.bfloat16)
    with torch.no_grad():
        outs16 = head16(xs)
    assert all(t.dtype == torch.bfloat16 for o in outs16 for t in o)
    for k, name in enumerate(("centerness", "bbox", "cls")):
        g = np.concatenate([o[k][0].float().permute(1, 2, 3, 0).numpy()
                            .ravel() for o in outs16])
        w16 = np.concatenate([o[k].ravel() for o in ref["bf16"]])
        w32 = np.concatenate([o[k].ravel() for o in ref["f32"]])
        d_port, d_ref = _bf16_rel(g, w16), _bf16_rel(w16, w32)
        print(f"[bf16] {kind} {name}: port-jax16 {d_port:.3g}, "
              f"jax16-jax32 {d_ref:.3g}")
        assert d_ref >= 2.0 * d_port, name


# ---------------------------------------------------------------------
# the datasets
# ---------------------------------------------------------------------

def _data_cfg(kind, root, ann, loading):
    mv = dict(type="MultiViewPipeline", n_images=1, loading=loading,
              nerf_target_views=0, transforms=[
                  dict(type="LoadImageFromFile"),
                  dict(type="Resize", img_scale=(64, 48), keep_ratio=True),
                  dict(type="Normalize", mean=[123.675, 116.28, 103.53],
                       std=[58.395, 57.12, 57.375], to_rgb=True),
                  dict(type="Pad", size=(48, 64))])
    return dict(type=kind, data_root=root, ann_file=ann, pipeline=[mv])


@pytest.fixture(scope="module")
def sunrgbd_pkl(tmp_path_factory):
    """One pkl (and its JPEG views) written by JAX's raw fixture and ETL."""
    root = str(tmp_path_factory.mktemp("sunrgbd"))
    write_synthetic_sunrgbd_raw(root, n_frames=3, splits=("val",),
                                hw=(30, 40), seed=3)
    paths = create_sunrgbd_infos(root, splits=("val",), num_points=256,
                                 num_workers=1)
    return root, paths[0]


@pytest.mark.parametrize("kind", ["SunRgbdMultiViewDataset",
                                  "SunRgbdPerspectiveMultiViewDataset"])
def test_sunrgbd_datasets_match_jax(kind, sunrgbd_pkl):
    root, ann = sunrgbd_pkl
    for test_mode, loading in ((True, "stride"), (False, "random")):
        cfg = _data_cfg(kind, root + "/", ann, loading)
        got = build_dataset(cfg, test_mode=test_mode)
        want = jdataset.build_dataset(cfg, test_mode=test_mode)
        assert type(got).__name__ == type(want).__name__ == kind
        assert got.classes == want.classes and len(got) == len(want) == 3
        for i in range(len(want)):
            gi, wi = got.get_data_info(i), want.get_data_info(i)
            assert gi["img_paths"] == wi["img_paths"]
            for k in ("intrinsic", "extrinsics", "c2w", "origin",
                      "gt_bboxes_3d", "gt_labels_3d"):
                assert gi[k].dtype == wi[k].dtype, k
                np.testing.assert_array_equal(gi[k], wi[k], err_msg=k)
            np.testing.assert_array_equal(gi["origin"], [0, 3, -1])
            gs, ws = got[i], want[i]
            assert set(gs) == set(ws), (sorted(gs), sorted(ws))
            for k in ws:
                np.testing.assert_array_equal(gs[k], ws[k], err_msg=k)
            assert gs["imgs"].shape == (1, 48, 64, 3)
    infos = pickle.load(open(ann, "rb"))
    dets = []
    for i, info in enumerate(infos):
        g = np.asarray(info["annos"]["gt_boxes_upright_depth"],
                       np.float32).copy()
        g[:, 2] -= g[:, 5] / 2
        g[:, 6] += 0.1 * (i + 1)
        dets.append(dict(boxes_3d=g, labels_3d=np.asarray(
            info["annos"]["class"]), scores_3d=np.linspace(
                0.9, 0.5, len(g)).astype(np.float32)))
    m_got, m_want = got.evaluate(dets), want.evaluate(dets)
    ious = (0.15,) if "Perspective" in kind else (0.25, 0.5)
    assert {k for k in m_want if k.startswith("mAP")} == {
        f"mAP_{t:.2f}" for t in ious}
    assert m_want[f"mAP_{ious[0]:.2f}"] > 0
    for k in m_want:
        assert abs(m_got[k] - m_want[k]) <= 1e-6, k


def test_inference_detector_keeps_jax_origin_and_threshold(sunrgbd_pkl,
                                                           monkeypatch):
    """``inference_detector`` sets the origin (0, 0, 0.5) and reads only
    ``iou_thr`` (0.25 without it) as the JAX function does, for a SUN
    RGB-D config too; ``run_eval`` reads the dataset's origin and
    ``iou_thr``, else ``nms_thr``. The SUN RGB-D configs inherit
    ``iou_thr=0.15`` from ``imvoxelnet_scannet.py``, their ``nms_thr``:
    dropped here, the two entry points part."""
    root, ann = sunrgbd_pkl
    cfg = Config.fromfile(os.path.join(CONFIGS, SUNRGBD[0]))
    assert cfg.test_cfg["iou_thr"] == cfg.test_cfg["nms_thr"] == 0.15
    del cfg.test_cfg["iou_thr"]
    cfg.data["test"] = _data_cfg("SunRgbdMultiViewDataset", root + "/",
                                 ann, "stride")
    seen = []
    monkeypatch.setattr(api, "single_scene_test",
                        lambda model, scene, **kw: seen.append(
                            (scene["origin"], kw)) or {})
    info = build_dataset(cfg.data["test"], test_mode=True).get_data_info(0)
    api.inference_detector(None, info, cfg)
    ds = build_dataset(cfg.data["test"], test_mode=True)
    monkeypatch.setattr(ds, "evaluate", lambda results, logger=None: {})
    api.run_eval(None, ds, dict(cfg.test_cfg), progress=False)
    (o1, kw1), (o2, kw2) = seen[0], seen[1]
    np.testing.assert_array_equal(o1, [0, 0, 0.5])
    assert kw1["iou_thr"] == 0.25 and kw1["score_thr"] == 0.05
    np.testing.assert_array_equal(o2, [0, 3, -1])
    assert kw2["iou_thr"] == 0.15 and kw2["score_thr"] == 0.05


def test_perspective_configs_keep_their_base_classes_as_jax(sunrgbd_pkl):
    """The perspective configs set 30 ``class_names`` after their base's
    data dicts were built with its 10: both packages build the perspective
    dataset with 10 class names beside a 30-class head, and its
    ``evaluate`` raises on a label past 9 (a fault of the config files,
    ROADMAP §3; ``--options data.test.classes=...`` names the 30)."""
    root, ann = sunrgbd_pkl
    for name in SUNRGBD[3:]:
        path = os.path.join(CONFIGS, name)
        cfg, jcfg = Config.fromfile(path), JaxConfig.fromfile(path)
        assert len(cfg.data["test"]["classes"]) == len(
            jcfg.data["test"]["classes"]) == 10
        assert cfg.model["bbox_head"]["n_classes"] == len(
            cfg.class_names) == 30
    data = dict(cfg.data["test"], data_root=root + "/", ann_file=ann)
    det = dict(boxes_3d=np.array([[0, 0, 0, 1, 1, 1, 0]], np.float32),
               labels_3d=np.array([12]), scores_3d=np.array([.5], np.float32))
    for ds in (build_dataset(data, test_mode=True),
               jdataset.build_dataset(data, test_mode=True)):
        assert type(ds).__name__ == "SunRgbdPerspectiveMultiViewDataset"
        with pytest.raises(KeyError):
            ds.evaluate([det] * len(ds))


# ---------------------------------------------------------------------
# the whole slice: two toys at one view
# ---------------------------------------------------------------------

def _meta(n):
    return n(ori_shape=IMG, img_shape=IMG, pad_shape=IMG)


def jax_toy(kind):
    head_type, neck = HEADS[kind]
    return JaxIndoor(backbone_depth=50, neck3d=_Neck3DCfg(**neck),
                     head_type=head_type, meta=_meta(JaxSceneMeta), **TOY)


def port_toy(kind, dtype=torch.float32):
    head_type, neck = HEADS[kind]
    return IndoorImVoxelNet(neck3d=dict(neck), head_type=head_type,
                            meta=_meta(SceneMeta), compute_dtype=dtype,
                            **TOY)


def toy_scene():
    s = make_synthetic_scene(seed=7, n_views=1, n_targets=1, hw=IMG,
                             pad_hw=IMG, n_rand=8, n_boxes=3, max_gt=4,
                             margin=2)
    return {k: s[k] for k in ("imgs", "intrinsic", "extrinsics", "origin")}


def _slice_reference():
    scene = toy_scene()
    batch = {k: jnp.asarray(v) for k, v in scene.items()}
    out = {}
    models = {kind: jax_toy(kind) for kind in HEADS}
    variables = {}
    for i, (kind, m) in enumerate(models.items()):
        shapes = jax.eval_shape(lambda k, m=m: m.init(k, batch),
                                jax.random.PRNGKey(0))
        variables[kind] = {
            "params": random_tree(shapes["params"], 20 + 2 * i),
            "batch_stats": random_tree(shapes["batch_stats"], 21 + 2 * i)}

    def run(v, b):
        res = {}
        for kind, m in models.items():
            heads, valid, _ = m.apply(v[kind], b)
            pts = m.apply(v[kind], b["origin"], method=type(m).mlvl_points)
            boxes, scores = (
                jheads_v1.get_candidate_bboxes_v1(heads, valid, pts, NMS_PRE,
                                                  5, True) if kind == "v1"
                else jheads.get_candidate_bboxes(heads, valid, pts, NMS_PRE,
                                                 5, yaw=True))
            res[kind] = (heads, valid, boxes, scores)
        return res

    res = jax.jit(run)(variables, batch)
    for kind, (heads, valid, boxes, scores) in res.items():
        det = japi.detections_from_candidates(
            np.asarray(boxes), np.asarray(scores), SCORE_THR, NMS_THR)
        out[kind] = dict(variables=variables[kind],
                         heads=[[np.asarray(t) for t in s] for s in heads],
                         valid=np.asarray(valid), boxes=np.asarray(boxes),
                         scores=np.asarray(scores), det=det)
    return out


def test_toy_slices_match_jax(tmp_path_factory):
    """Both toys' head outputs (1e-4) and final detections against JAX,
    one view: from JAX's candidates the port's host tail gives JAX's
    detections (boxes 1e-5); from its own, labels and order exact, scores
    1e-6, boxes 1e-5 of their largest coordinate. The 7-output
    ``reg_conv`` of each head comes through ``from_jax_variables``."""
    ref = computed_once(tmp_path_factory, "torch_sunrgbd_slice",
                        _slice_reference)
    scene = toy_scene()
    for kind in HEADS:
        r = ref[kind]
        model = port_toy(kind)
        assert model.yaw and model.uses_v1_head == (kind == "v1")
        state = from_jax_variables(r["variables"])
        assert state["bbox_head.reg_conv.weight"].shape[0] == 7
        model.load_state_dict(state, strict=True)
        model.eval()
        batch = api.device_batch(model, scene)
        assert batch["imgs"].shape[0] == 1
        with torch.no_grad():
            heads, valid, third = model(batch)
        assert third is None
        np.testing.assert_array_equal(valid.numpy(), r["valid"])
        assert 0 < float((valid > 0).float().mean()) < 1
        for got, want in zip(heads, r["heads"]):
            for a, b in zip(got, want):
                assert a.shape == b.shape
                assert float(np.abs(a.numpy() - b).max()) <= 1e-4
        out = api.eval_step(model, batch, NMS_PRE)
        assert out["boxes"].shape[-1] == 7
        det = api.detections_from_candidates(out["boxes"].numpy(),
                                             out["scores"].numpy(),
                                             SCORE_THR, NMS_THR)
        want = r["det"]
        print(f"[slice] {kind}: {len(want['labels_3d'])} detections")
        assert 1 < len(want["labels_3d"]) < out["boxes"].shape[0]
        tail = api.detections_from_candidates(r["boxes"], r["scores"],
                                              SCORE_THR, NMS_THR)
        for d, atol in ((tail, 1e-5),
                        (det, 1e-5 * float(np.abs(want["boxes_3d"]).max()))):
            np.testing.assert_array_equal(d["labels_3d"], want["labels_3d"])
            np.testing.assert_allclose(d["scores_3d"], want["scores_3d"],
                                       rtol=0, atol=1e-6)
            np.testing.assert_allclose(d["boxes_3d"], want["boxes_3d"],
                                       rtol=0, atol=atol)


# ---------------------------------------------------------------------
# the configs
# ---------------------------------------------------------------------

@pytest.mark.parametrize("name", SUNRGBD)
def test_sunrgbd_config_builds_and_refuses_training(name):
    """(Named when training was refused.) The config builds with JAX's
    fields and now trains: ``init_trainer`` at float32 and bfloat16, and
    ``tools/train``'s refusals pass it with and without
    ``--distributed``."""
    path = os.path.join(CONFIGS, name)
    cfg = Config.fromfile(path)
    jcfg = JaxConfig.fromfile(path)
    want = jax_build_model(jcfg.model, meta=jax_meta(jcfg))
    model = api.init_detector(cfg, device="cpu")
    assert isinstance(model, IndoorImVoxelNet) and not model.training
    for field in ("n_voxels", "voxel_size", "n_classes", "n_scales",
                  "head_type", "yaw"):
        w = getattr(want, field)
        assert getattr(model, field) == (tuple(w) if isinstance(
            w, (list, tuple)) else w), field
    assert model.yaw
    assert tuple(model.meta.__dict__.values()) == tuple(
        want.meta.__dict__.values()) == ((530, 730), (465, 640), (480, 640))
    assert model.bbox_head.reg_conv.out_channels == 7
    assert unported_refusal(cfg.model) is None
    for dtype in (torch.float32, torch.bfloat16):
        tr = api.init_trainer(cfg, device="cpu", compute_dtype=dtype)
        assert isinstance(tr.model, IndoorImVoxelNet) and tr.model.training
        assert tr.model.yaw and tr.model.compute_dtype == dtype
        del tr
    for extra in ([], ["--distributed"]):
        train_cli.refuse_unported(train_cli.parse_args([path, *extra]), cfg)


@pytest.mark.parametrize("name", TOTAL)
def test_total_sunrgbd_configs_are_refused_everywhere(name):
    path = os.path.join(CONFIGS, name)
    cfg = Config.fromfile(path)
    for fn in (lambda: build_model(cfg.model),
               lambda: api.init_detector(cfg, device="cpu"),
               lambda: api.init_trainer(cfg, device="cpu"),
               lambda: train_cli.refuse_unported(
                   train_cli.parse_args([path]), cfg),
               lambda: build_dataset(cfg.data["test"], test_mode=True)):
        with pytest.raises(NotImplementedError, match=LAYOUT):
            fn()

