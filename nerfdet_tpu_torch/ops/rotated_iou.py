"""Rotated-BEV box overlap and 3D IoU on the host (numpy).

The port's copy of the numpy path of ``nerfdet_tpu/ops/rotated_iou.py``
(``bev_corners``, ``_points_in_quad``, ``_segment_intersections``,
``_convex_area_from_candidates``, ``rotated_bev_overlap``,
``rotated_iou_3d``), held bit for bit against it, at float32 and at
float64, by ``tests/test_torch_port_rules.py``. The candidate vertices of
an intersection are the corners of each box inside the other and the 16
edge-edge intersections; sorted by angle around their centroid, they
give the area by the shoelace formula. The corners and the edge
intersections are computed at the boxes' dtype (the area is float64
either way: the centroid divides by an integer count). On float32 boxes
of equal yaw with collinear edges that loses vertices (half the area, in
JAX's numpy form too; ROADMAP §3), so ``core/boxes.boxes_iou_3d`` and
``core/nms.nms_bev_rotated`` call these on float64 boxes, as the JAX
package's C++ geometry library computes in double. The differentiable
aligned form (the rotated IoU loss) is ``ops/rotated_iou_loss.py``, in
torch.
"""

from __future__ import annotations

import numpy as np


def bev_corners(boxes):
    """(N, 7) center-format boxes -> (N, 4, 2) BEV footprint corners,
    counter-clockwise for yaw 0."""
    cx, cy = boxes[:, 0], boxes[:, 1]
    dx, dy = boxes[:, 3], boxes[:, 4]
    yaw = boxes[:, 6] if boxes.shape[-1] > 6 else np.zeros_like(cx)
    lx = np.stack([dx / 2, -dx / 2, -dx / 2, dx / 2], axis=-1)
    ly = np.stack([dy / 2, dy / 2, -dy / 2, -dy / 2], axis=-1)
    c, s = np.cos(yaw)[:, None], np.sin(yaw)[:, None]
    gx = lx * c - ly * s + cx[:, None]
    gy = lx * s + ly * c + cy[:, None]
    return np.stack([gx, gy], axis=-1)


def _cross(o, a, b):
    return (a[..., 0] - o[..., 0]) * (b[..., 1] - o[..., 1]) - (
        a[..., 1] - o[..., 1]
    ) * (b[..., 0] - o[..., 0])


def _points_in_quad(pts, quad):
    """pts (..., P, 2) inside the convex quad (..., 4, 2), either winding."""
    signs = []
    for i in range(4):
        o = quad[..., i, :][..., None, :]
        a = quad[..., (i + 1) % 4, :][..., None, :]
        signs.append(_cross(o, a, pts))
    s = np.stack(signs, axis=-1)  # (..., P, 4)
    eps = 1e-8
    return np.all(s >= -eps, axis=-1) | np.all(s <= eps, axis=-1)


def _segment_intersections(c1, c2):
    """The 16 edge-pair intersection points of two quads (..., 4, 2):
    points (..., 16, 2) and their validity (..., 16)."""
    p = c1
    r = np.concatenate([c1[..., 1:, :], c1[..., :1, :]], axis=-2) - c1
    q = c2
    s = np.concatenate([c2[..., 1:, :], c2[..., :1, :]], axis=-2) - c2

    p_ = p[..., :, None, :]  # (..., 4, 1, 2)
    r_ = r[..., :, None, :]
    q_ = q[..., None, :, :]  # (..., 1, 4, 2)
    s_ = s[..., None, :, :]

    denom = r_[..., 0] * s_[..., 1] - r_[..., 1] * s_[..., 0]
    qmp = q_ - p_
    t_num = qmp[..., 0] * s_[..., 1] - qmp[..., 1] * s_[..., 0]
    u_num = qmp[..., 0] * r_[..., 1] - qmp[..., 1] * r_[..., 0]
    safe = np.where(np.abs(denom) < 1e-12, 1.0, denom)
    t = t_num / safe
    u = u_num / safe
    valid = (
        (np.abs(denom) > 1e-12)
        & (t >= 0.0) & (t <= 1.0)
        & (u >= 0.0) & (u <= 1.0)
    )
    pts = p_ + t[..., None] * r_
    shape = pts.shape[:-3] + (16, 2)
    return pts.reshape(shape), valid.reshape(shape[:-1])


def _convex_area_from_candidates(cand, valid):
    """Area of the convex region of the valid candidate vertices."""
    n_valid = valid.sum(axis=-1)
    denom = np.maximum(n_valid, 1)[..., None]
    centroid = (cand * valid[..., None]).sum(axis=-2) / denom
    rel = cand - centroid[..., None, :]
    ang = np.arctan2(rel[..., 1], rel[..., 0])
    ang = np.where(valid, ang, 1e9)  # invalid sort last
    order = np.argsort(ang, axis=-1)
    sorted_rel = np.take_along_axis(rel, order[..., None], axis=-2)
    k = n_valid[..., None]
    idx = np.asarray(np.arange(cand.shape[-2]))
    nxt = np.where(idx + 1 < k, idx + 1, 0)  # wrap at k
    nxt_rel = np.take_along_axis(sorted_rel, nxt[..., None], axis=-2)
    crosses = (
        sorted_rel[..., 0] * nxt_rel[..., 1]
        - sorted_rel[..., 1] * nxt_rel[..., 0]
    )
    use = idx < k  # only the first k sorted vertices count
    area = 0.5 * np.abs((crosses * use).sum(axis=-1))
    return np.where(n_valid >= 3, area, 0.0)


def rotated_bev_overlap(boxes1, boxes2):
    """Pairwise (N, M) BEV intersection areas of rotated boxes."""
    n, m = boxes1.shape[0], boxes2.shape[0]
    c1 = bev_corners(boxes1)
    c2 = bev_corners(boxes2)
    c1p = np.broadcast_to(c1[:, None], (n, m, 4, 2)).reshape(n * m, 4, 2)
    c2p = np.broadcast_to(c2[None, :], (n, m, 4, 2)).reshape(n * m, 4, 2)

    in12 = _points_in_quad(c1p, c2p)
    in21 = _points_in_quad(c2p, c1p)
    ipts, ivalid = _segment_intersections(c1p, c2p)

    cand = np.concatenate([c1p, c2p, ipts], axis=-2)  # (NM, 24, 2)
    valid = np.concatenate([in12, in21, ivalid], axis=-1)
    area = _convex_area_from_candidates(cand, valid)
    return area.reshape(n, m)


def rotated_iou_3d(boxes1, boxes2):
    """Pairwise 3D IoU of (N, 7) bottom-centered rotated boxes."""
    inter_bev = rotated_bev_overlap(boxes1, boxes2)
    top1 = (boxes1[:, 2] + boxes1[:, 5])[:, None]
    top2 = (boxes2[:, 2] + boxes2[:, 5])[None, :]
    bot1 = boxes1[:, 2][:, None]
    bot2 = boxes2[:, 2][None, :]
    inter_h = np.clip(np.minimum(top1, top2) - np.maximum(bot1, bot2), 0,
                      None)
    inter = inter_bev * inter_h
    v1 = (boxes1[:, 3] * boxes1[:, 4] * boxes1[:, 5])[:, None]
    v2 = (boxes2[:, 3] * boxes2[:, 4] * boxes2[:, 5])[None, :]
    return inter / np.clip(v1 + v2 - inter, 1e-8, None)
