"""ScanNet-protocol indoor detection evaluation (mAP / mAR at IoU
thresholds).

A copy of ``nerfdet_tpu/core/eval.py`` (``average_precision``,
``indoor_eval``), held to it exactly by ``tests/test_torch_eval.py``.
The VOC greedy match assigns each detection a fixed candidate GT (its
highest-IoU same-class GT, independent of matching state), so a
detection is a true positive iff it clears the IoU threshold and is the
first threshold-clearing detection, in descending-confidence order,
whose candidate is that GT: one IoU matrix per scene, one argmax, one
sort and one first-occurrence scan, with the results of the reference's
per-detection loop.
"""

from __future__ import annotations

import numpy as np

from .boxes import DepthBoxes3D


def average_precision(recalls, precisions, mode: str = "area"):
    """VOC AP from (num_scales, N) recall/precision curves.

    ``area`` integrates the precision envelope over recall (reference
    `indoor_eval.py:7-52` semantics); ``11points`` averages the envelope
    at recall {0, 0.1, ..., 1}.
    """
    recalls = np.atleast_2d(np.asarray(recalls))
    precisions = np.atleast_2d(np.asarray(precisions))
    assert recalls.shape == precisions.shape and recalls.ndim == 2
    num_scales = recalls.shape[0]
    pad0 = np.zeros((num_scales, 1), dtype=np.float64)
    pad1 = np.ones((num_scales, 1), dtype=np.float64)
    r = np.concatenate([pad0, recalls, pad1], axis=1)
    p = np.concatenate([pad0, precisions, pad0], axis=1)
    # precision envelope: running max from the right
    p = np.maximum.accumulate(p[:, ::-1], axis=1)[:, ::-1]
    if mode == "area":
        return np.sum((r[:, 1:] - r[:, :-1]) * p[:, 1:],
                      axis=1).astype(np.float32)
    if mode == "11points":
        thrs = np.arange(0.0, 1.0 + 1e-3, 0.1)
        # envelope precision at the first recall point >= thr
        at = np.stack([
            np.where(r[i, :, None] >= thrs[None, :], p[i, :, None],
                     0.0).max(axis=0)
            for i in range(num_scales)
        ])
        return at.mean(axis=1).astype(np.float32)
    raise ValueError('mode must be "area" or "11points"')


def _as_depth_boxes(boxes, origin=(0.5, 0.5, 0)):
    if isinstance(boxes, DepthBoxes3D):
        return boxes
    arr = np.asarray(boxes, np.float32).reshape(-1, 7)
    return DepthBoxes3D(arr, box_dim=7, with_yaw=False, origin=origin)


def _candidate_matches(det_sets, gt_sets):
    """Per-detection candidate GT and IoU, over a list of scenes.

    Args:
        det_sets: per scene (DepthBoxes3D, labels (n,), scores (n,)).
        gt_sets: per scene (DepthBoxes3D, labels (m,)).

    Returns flat arrays over all detections: ``labels``, ``scores``,
    ``best_iou`` (IoU with the candidate, ``-inf`` when the scene has no
    same-class GT) and ``best_gt`` (globally unique candidate id), plus
    the per-class GT counts ``npos`` as a dict.
    """
    labels, scores, best_iou, best_gt = [], [], [], []
    npos: dict = {}
    gt_offset = 0
    for (dboxes, dlabels, dscores), (gboxes, glabels) in zip(
            det_sets, gt_sets):
        for c in glabels.tolist():
            npos[int(c)] = npos.get(int(c), 0) + 1
        nd, ng = len(dboxes), len(gboxes)
        if nd:
            labels.append(dlabels)
            scores.append(dscores)
            if ng:
                iou = np.asarray(dboxes.overlaps(gboxes))  # (nd, ng)
                same = dlabels[:, None] == glabels[None, :]
                iou = np.where(same, iou, -np.inf)
                j = np.argmax(iou, axis=1)  # first max wins ties
                best_iou.append(iou[np.arange(nd), j])
                best_gt.append(gt_offset + j)
            else:
                best_iou.append(np.full(nd, -np.inf))
                best_gt.append(np.full(nd, -1, dtype=np.int64))
        gt_offset += ng
    if labels:
        return (np.concatenate(labels), np.concatenate(scores),
                np.concatenate(best_iou), np.concatenate(best_gt), npos)
    return (np.zeros(0, np.int64), np.zeros(0), np.zeros(0),
            np.zeros(0, np.int64), npos)


def _class_pr_curves(scores, best_iou, best_gt, npos, thresholds):
    """Precision/recall curves of one class at each IoU threshold.

    ``scores/best_iou/best_gt`` are this class's detections only.
    Returns per threshold ``(recall, precision, ap)``.
    """
    order = np.argsort(-scores, kind="stable")
    iou_s = best_iou[order]
    gt_s = best_gt[order]
    nd = len(order)
    out = []
    for thr in thresholds:
        ok = iou_s > thr
        tp = np.zeros(nd)
        if ok.any():
            # first qualifying detection per candidate GT is the TP
            idx = np.nonzero(ok)[0]
            _, first = np.unique(gt_s[idx], return_index=True)
            tp[idx[first]] = 1.0
        fp = np.cumsum(1.0 - tp)
        tp = np.cumsum(tp)
        recall = tp / float(max(npos, 1))
        precision = tp / np.maximum(tp + fp, np.finfo(np.float64).eps)
        out.append((recall, precision,
                    average_precision(recall, precision)[0]))
    return out


def indoor_eval(gt_annos, dt_annos, metric, label2cat, logger=None,
                box_dim: int = 6):
    """ScanNet mAP/mAR evaluation (protocol of `indoor_eval.py:203-310`).

    Args:
        gt_annos: list of dicts with keys ``gt_num``,
            ``gt_boxes_upright_depth`` ((n, 6/7), gravity-centered) and
            ``class`` ((n,) labels).
        dt_annos: list of dicts with ``labels_3d`` (n,), ``scores_3d`` (n,)
            and ``boxes_3d`` — either a DepthBoxes3D or a raw
            bottom-centered (n, 7) array.
        metric: list of IoU thresholds, e.g. ``[0.25, 0.5]``.
        label2cat: {label: class name}.
    """
    assert len(dt_annos) == len(gt_annos)
    det_sets, gt_sets = [], []
    for det_anno, gt_anno in zip(dt_annos, gt_annos):
        dboxes = _as_depth_boxes(det_anno["boxes_3d"])
        dlabels = np.asarray(det_anno["labels_3d"]).astype(np.int64)
        dscores = np.asarray(det_anno["scores_3d"]).astype(np.float64)
        det_sets.append((dboxes, dlabels, dscores))
        if gt_anno["gt_num"] != 0:
            raw = gt_anno["gt_boxes_upright_depth"]
            gboxes = DepthBoxes3D(raw, box_dim=raw.shape[-1],
                                  with_yaw=raw.shape[-1] == 7,
                                  origin=(0.5, 0.5, 0.5))
            glabels = np.asarray(gt_anno["class"]).astype(np.int64)
        else:
            gboxes = DepthBoxes3D(np.zeros((0, 7), np.float32))
            glabels = np.zeros(0, np.int64)
        gt_sets.append((gboxes, glabels))

    labels, scores, best_iou, best_gt, npos = _candidate_matches(
        det_sets, gt_sets)

    # evaluated classes = union of GT and detection labels (a class with
    # detections but no GT contributes AP/AR 0 to the means, matching
    # the reference's dict construction)
    classes = sorted(set(npos) | set(int(c) for c in np.unique(labels)))
    ap = [dict() for _ in metric]
    rec_last = [dict() for _ in metric]
    for c in classes:
        sel = labels == c
        if sel.any():
            curves = _class_pr_curves(scores[sel], best_iou[sel],
                                      best_gt[sel], npos.get(c, 0), metric)
            for i, (recall, _prec, ap_c) in enumerate(curves):
                ap[i][c] = float(ap_c)
                rec_last[i][c] = float(recall[-1])
        else:
            for i in range(len(metric)):
                ap[i][c] = 0.0
                rec_last[i][c] = 0.0

    ret_dict = {}
    for i, iou_thresh in enumerate(metric):
        for c in classes:
            ret_dict[f"{label2cat[c]}_AP_{iou_thresh:.2f}"] = ap[i][c]
            ret_dict[f"{label2cat[c]}_rec_{iou_thresh:.2f}"] = rec_last[i][c]
        ret_dict[f"mAP_{iou_thresh:.2f}"] = float(
            np.mean([ap[i][c] for c in classes])) if classes else 0.0
        ret_dict[f"mAR_{iou_thresh:.2f}"] = float(
            np.mean([rec_last[i][c] for c in classes])) if classes else 0.0

    lines = [f"{'class':<16}" + "".join(
        f"AP_{t:.2f}   AR_{t:.2f}   " for t in metric)]
    for c in classes:
        row = f"{str(label2cat[c]):<16}"
        for i in range(len(metric)):
            row += f"{ap[i][c]:<9.4f}{rec_last[i][c]:<9.4f}"
        lines.append(row)
    row = f"{'Overall':<16}"
    for t in metric:
        row += f"{ret_dict[f'mAP_{t:.2f}']:<9.4f}{ret_dict[f'mAR_{t:.2f}']:<9.4f}"
    lines.append(row)
    report = "\n".join(lines)
    if logger is not None:
        logger.info("\n" + report)
    else:
        print(report)
    return ret_dict
