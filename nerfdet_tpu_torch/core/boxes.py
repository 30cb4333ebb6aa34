"""Box geometry of the indoor Depth frame (z up), numpy only.

The port's copy of the numpy branches of ``gravity_center``,
``corners_from_boxes`` and the z-axis case of ``rotation_3d_in_axis``
in ``nerfdet_tpu/core/boxes.py``, held bit for bit against them by
``tests/test_torch_port_rules.py``. Boxes are (N, 7) rows (cx, cy,
z_bottom, dx, dy, dz, yaw).
"""

from __future__ import annotations

import numpy as np


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
