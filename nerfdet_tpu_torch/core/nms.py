"""Class-aware axis-aligned 3D NMS on the host (numpy).

Port of the numpy branch of ``nerfdet_tpu/core/nms.py:aligned_3d_nms``,
with the same greedy order.
"""

from __future__ import annotations

import numpy as np


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
