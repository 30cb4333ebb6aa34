"""Box geometry of the indoor Depth frame (z up).

The port's copy of the numpy branches of ``gravity_center``,
``corners_from_boxes`` and the z-axis case of ``rotation_3d_in_axis``
in ``nerfdet_tpu/core/boxes.py``, held bit for bit against them by
``tests/test_torch_port_rules.py``, and torch versions of
``volume_of_boxes`` and ``axis_aligned_iou_corner_format`` for the
head's targets and IoU loss. Boxes are (N, 7) rows (cx, cy, z_bottom,
dx, dy, dz, yaw).
"""

from __future__ import annotations

import numpy as np
import torch


def volume_of_boxes(boxes: torch.Tensor) -> torch.Tensor:
    """(N,) volumes dx * dy * dz."""
    return boxes[..., 3] * boxes[..., 4] * boxes[..., 5]


def axis_aligned_iou_corner_format(boxes1, boxes2, aligned: bool = True,
                                   eps: float = 1e-6) -> torch.Tensor:
    """IoU of (x1, y1, z1, x2, y2, z2) corner-format boxes: row by row
    when ``aligned`` ((N,)), else every pair ((N, M)); the union is
    clamped to ``eps``."""
    def volume(b):
        return ((b[..., 3] - b[..., 0]) * (b[..., 4] - b[..., 1])
                * (b[..., 5] - b[..., 2]))

    vol1, vol2 = volume(boxes1), volume(boxes2)
    if aligned:
        lt = torch.maximum(boxes1[..., :3], boxes2[..., :3])
        rb = torch.minimum(boxes1[..., 3:], boxes2[..., 3:])
        whd = torch.clamp(rb - lt, min=0)
        inter = whd[..., 0] * whd[..., 1] * whd[..., 2]
        union = vol1 + vol2 - inter
    else:
        lt = torch.maximum(boxes1[..., :, None, :3], boxes2[..., None, :, :3])
        rb = torch.minimum(boxes1[..., :, None, 3:], boxes2[..., None, :, 3:])
        whd = torch.clamp(rb - lt, min=0)
        inter = whd[..., 0] * whd[..., 1] * whd[..., 2]
        union = vol1[..., :, None] + vol2[..., None, :] - inter
    return inter / torch.clamp(union, min=eps)


def rotation_3d_in_z(points, angles):
    """Rotate (N, M, 3) points by (N,) angles about +z, as
    ``points @ R_T`` per batch element (``rotation_3d_in_axis(...,
    axis=2)``)."""
    rot_sin = np.sin(angles)
    rot_cos = np.cos(angles)
    ones = np.ones_like(rot_cos)
    zeros = np.zeros_like(rot_cos)
    rot_mat_T = np.stack([
        np.stack([rot_cos, -rot_sin, zeros]),
        np.stack([rot_sin, rot_cos, zeros]),
        np.stack([zeros, zeros, ones]),
    ])
    return np.einsum("aij,jka->aik", points, rot_mat_T)


def gravity_center(boxes):
    """(N, 3) geometric centers."""
    bottom = boxes[..., :3]
    return np.concatenate(
        [bottom[..., :2], (bottom[..., 2:3] + boxes[..., 5:6] * 0.5)], axis=-1)


def corners_from_boxes(boxes):
    """(N, 8, 3) corners, yaw about +z."""
    dims = boxes[:, 3:6]
    # unit cube corners in [0,1]^3, origin (.5,.5,0): bottom-center frame
    unit = np.stack(
        np.meshgrid([0, 1], [0, 1], [0, 1], indexing="ij"), axis=-1
    ).reshape(8, 3).astype(np.float32)
    unit = unit - np.array([0.5, 0.5, 0.0], np.float32)
    corners = dims[:, None, :] * np.asarray(unit)[None, :, :]
    yaw = (boxes[:, 6] if boxes.shape[-1] > 6
           else np.zeros(boxes.shape[0], boxes.dtype))
    corners = rotation_3d_in_z(corners, yaw)
    return corners + boxes[:, None, :3]
