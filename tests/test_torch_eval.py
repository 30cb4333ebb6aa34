"""The port's indoor evaluation against the JAX package's, exactly.

``indoor_eval`` (mAP / mAR at 0.25 and 0.5, per-class AP and recall,
the printed table) and ``average_precision`` ('area' and '11points')
give equal dicts and arrays for seeded ground truth and detections:
several scenes with near-GT detections, a class with detections and no
GT and one with GT and no detections, a scene without GT, no detections
at all, and IoU ties (duplicated GT boxes: the first wins, as in the
reference's greedy match, so the second copies stay unmatched) with
equal scores. The box helpers the
evaluation copies are held bit for bit; yawed overlaps are refused.
"""

import numpy as np
import pytest

from nerfdet_tpu.core import boxes as jboxes
from nerfdet_tpu.core import eval as jeval

from nerfdet_tpu_torch.core import boxes as tboxes
from nerfdet_tpu_torch.core import eval as teval

LABEL2CAT = {i: f"class{i}" for i in range(18)}


def _gt(rng, n, classes):
    """Gravity-centered (n, 6) upright boxes, reference info schema."""
    boxes = np.concatenate([rng.uniform(-3, 3, (n, 2)),
                            rng.uniform(0.2, 1.2, (n, 1)),
                            rng.uniform(0.3, 1.5, (n, 3))], 1)
    return dict(gt_num=n, gt_boxes_upright_depth=boxes.astype(np.float32),
                **{"class": rng.choice(classes, n).astype(np.int64)})


def _dets_near(rng, gt, n_extra, classes, jitter=0.15):
    """Detections: each GT box jittered (bottom-centered, 7 values) with
    its label or a wrong one, plus random boxes."""
    g = gt["gt_boxes_upright_depth"]
    near = g.copy()
    near[:, 2] -= near[:, 5] / 2
    near = near + rng.normal(0, jitter, near.shape).astype(np.float32)
    near[:, 3:6] = np.abs(near[:, 3:6]) + 0.05
    far = np.concatenate([rng.uniform(-3, 3, (n_extra, 2)),
                          rng.uniform(0, 1, (n_extra, 1)),
                          rng.uniform(0.3, 1.5, (n_extra, 3))], 1)
    boxes = np.concatenate([near, far]).astype(np.float32)
    boxes = np.concatenate([boxes, np.zeros((len(boxes), 1), np.float32)],
                           1)
    labels = np.concatenate([
        np.where(rng.rand(len(near)) < 0.8, gt["class"],
                 rng.choice(classes, len(near))),
        rng.choice(classes, n_extra)]).astype(np.int64)
    scores = rng.rand(len(boxes)).astype(np.float32)
    return dict(boxes_3d=boxes, labels_3d=labels, scores_3d=scores)


def _case(name):
    rng = np.random.RandomState(CASES.index(name))
    classes = np.array([0, 2, 5, 7])
    empty = dict(boxes_3d=np.zeros((0, 7), np.float32),
                 labels_3d=np.zeros(0, np.int64),
                 scores_3d=np.zeros(0, np.float32))
    no_gt = dict(gt_num=0, gt_boxes_upright_depth=np.zeros((0, 6),
                                                           np.float32),
                 **{"class": np.zeros(0, np.int64)})
    if name == "seeded scenes":
        gts = [_gt(rng, n, classes) for n in (5, 8, 3)]
        dets = [_dets_near(rng, g, 6, classes) for g in gts]
        dets[1]["labels_3d"][-1] = 11  # a class with detections, no GT
        gts[2]["class"][:] = 13  # GT whose class has no detection
        return gts, dets
    if name == "a scene without GT":
        gts = [_gt(rng, 4, classes), no_gt]
        return gts, [_dets_near(rng, gts[0], 3, classes),
                     _dets_near(rng, _gt(rng, 3, classes), 2, classes)]
    if name == "no detections":
        return [_gt(rng, 4, classes), _gt(rng, 2, classes)], [empty, empty]
    # IoU ties: every GT box twice, detections on them with equal scores
    gt = _gt(rng, 3, classes)
    gt = dict(gt_num=6, gt_boxes_upright_depth=np.concatenate(
        [gt["gt_boxes_upright_depth"]] * 2),
        **{"class": np.concatenate([gt["class"]] * 2)})
    det = _dets_near(rng, gt, 0, classes, jitter=0.05)
    det["labels_3d"] = gt["class"].copy()
    det["scores_3d"][:] = 0.5
    return [gt], [det]


CASES = ["seeded scenes", "a scene without GT", "no detections",
         "IoU ties"]


@pytest.mark.parametrize("name", CASES)
def test_indoor_eval_equals_jax(name, capsys):
    gts, dets = _case(name)
    got = teval.indoor_eval(gts, dets, [0.25, 0.5], LABEL2CAT)
    printed = capsys.readouterr().out
    want = jeval.indoor_eval(gts, dets, [0.25, 0.5], LABEL2CAT)
    assert got == want
    assert printed == capsys.readouterr().out
    assert {"mAP_0.25", "mAR_0.25", "mAP_0.50", "mAR_0.50"} <= set(got)
    if name == "seeded scenes":
        assert 0 < got["mAP_0.25"] < 1 and "class11_AP_0.25" in got
        assert got["class13_rec_0.25"] == 0.0
    if name == "IoU ties":
        # both copies' detections pick the first copy (ties go to the
        # first GT), so the second copies stay unmatched
        assert got["mAR_0.25"] == 0.5


@pytest.mark.parametrize("mode", ["area", "11points"])
def test_average_precision_equals_jax(mode):
    rng = np.random.RandomState(7)
    recalls = np.sort(rng.rand(3, 20), axis=1)
    precisions = rng.rand(3, 20)
    got = teval.average_precision(recalls, precisions, mode)
    want = jeval.average_precision(recalls, precisions, mode)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_box_helpers_equal_jax():
    rng = np.random.RandomState(3)
    a = np.concatenate([rng.uniform(-2, 2, (9, 3)),
                        rng.uniform(0.2, 2, (9, 3)), np.zeros((9, 1))],
                       1).astype(np.float32)
    b = a[::2] + rng.normal(0, 0.3, a[::2].shape).astype(np.float32)
    b[:, 3:6] = np.abs(b[:, 3:6])
    b[:, 6] = 0
    for fn in ("height_overlap", "axis_aligned_bev_overlap"):
        np.testing.assert_array_equal(getattr(tboxes, fn)(a, b),
                                      getattr(jboxes, fn)(a, b))
    for mode in ("iou", "iof"):
        np.testing.assert_array_equal(tboxes.boxes_iou_3d(a, b, mode=mode),
                                      jboxes.boxes_iou_3d(a, b, mode=mode))
    np.testing.assert_array_equal(tboxes.shift_origin(a),
                                  jboxes.shift_origin(a))
    got = tboxes.DepthBoxes3D(a[:, :6], box_dim=6, with_yaw=False,
                              origin=(0.5, 0.5, 0.5))
    want = jboxes.DepthBoxes3D(a[:, :6], box_dim=6, with_yaw=False,
                               origin=(0.5, 0.5, 0.5))
    np.testing.assert_array_equal(got.tensor, want.tensor)
    np.testing.assert_array_equal(got.overlaps(got), want.overlaps(want))
    yawed = tboxes.DepthBoxes3D(a)
    with pytest.raises(NotImplementedError, match="ROADMAP §1 item 3"):
        yawed.overlaps(yawed)
