"""Host NMS (numpy): class-aware axis-aligned 3D, and rotated BEV.

Port of the numpy branch of ``nerfdet_tpu/core/nms.py:aligned_3d_nms``,
with the same greedy order, and of ``nms_bev_rotated`` as the JAX
package runs it where its C++ library builds (``nms_rotated_bev``,
``csrc/geometry.cc``): the BEV IoU in float64, against the threshold as
a float32 widened to float64. JAX's numpy form computes the overlap on
float32 boxes, which loses the vertices of collinear edges (half the
area), and then keeps boxes the C++ one suppresses (ROADMAP §3); the
port keeps the C++ one's.
"""

from __future__ import annotations

import numpy as np

from ..ops.rotated_iou import rotated_bev_overlap


def aligned_3d_nms(boxes, scores, classes, thresh: float) -> np.ndarray:
    """Greedy NMS on (N, 6) corner boxes (x1, y1, z1, x2, y2, z2).

    Returns the indices of the kept boxes, highest score first.
    """
    boxes = np.asarray(boxes, np.float32)
    scores = np.asarray(scores, np.float32)
    classes = np.asarray(classes)
    x1, y1, z1, x2, y2, z2 = (boxes[:, i] for i in range(6))
    area = (x2 - x1) * (y2 - y1) * (z2 - z1)

    order = np.argsort(scores)  # ascending, pick from the back
    pick = []
    while order.shape[0] != 0:
        i = order[-1]
        pick.append(int(i))
        rest = order[:-1]
        xx1 = np.maximum(x1[i], x1[rest])
        yy1 = np.maximum(y1[i], y1[rest])
        zz1 = np.maximum(z1[i], z1[rest])
        xx2 = np.minimum(x2[i], x2[rest])
        yy2 = np.minimum(y2[i], y2[rest])
        zz2 = np.minimum(z2[i], z2[rest])
        inter = (np.clip(xx2 - xx1, 0, None) * np.clip(yy2 - yy1, 0, None)
                 * np.clip(zz2 - zz1, 0, None))
        iou = inter / (area[i] + area[rest] - inter)
        iou = iou * (classes[i] == classes[rest]).astype(np.float32)
        order = rest[iou <= thresh]
    return np.asarray(pick, np.int64)


def nms_bev_rotated(boxes_bev, scores, thresh: float) -> np.ndarray:
    """Greedy rotated-BEV NMS on (N, 5) ``(cx, cy, dx, dy, yaw)`` boxes:
    in descending score order (``np.argsort(-scores)``), each box not yet
    suppressed is kept and suppresses every later one whose BEV IoU with
    it is above ``thresh``. Returns the kept indices in that order."""
    boxes_bev = np.asarray(boxes_bev, np.float32)
    scores = np.asarray(scores, np.float32)
    boxes7 = np.zeros((boxes_bev.shape[0], 7), np.float64)
    boxes7[:, [0, 1, 3, 4, 6]] = boxes_bev
    areas = boxes7[:, 3] * boxes7[:, 4]
    thresh = float(np.float32(thresh))
    order = np.argsort(-scores)
    pick = []
    suppressed = np.zeros(len(scores), bool)
    for pos, i in enumerate(order):
        if suppressed[i]:
            continue
        pick.append(int(i))
        rest = order[pos + 1:]
        rest = rest[~suppressed[rest]]
        if rest.size:
            inter = rotated_bev_overlap(boxes7[i:i + 1], boxes7[rest])[0]
            iou = inter / np.maximum(areas[i] + areas[rest] - inter, 1e-8)
            suppressed[rest[iou > thresh]] = True
    return np.asarray(pick, np.int64)
