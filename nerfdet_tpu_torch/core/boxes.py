"""Box geometry of the indoor Depth frame (z up).

The port's copy of the numpy branches of ``gravity_center``,
``corners_from_boxes`` and the z-axis case of ``rotation_3d_in_axis``
in ``nerfdet_tpu/core/boxes.py``, held bit for bit against them by
``tests/test_torch_port_rules.py``; of what the indoor evaluation needs
(``shift_origin``, ``height_overlap``, ``axis_aligned_bev_overlap``,
``boxes_iou_3d`` and ``DepthBoxes3D``), held against them by
``tests/test_torch_eval.py`` and, for yawed boxes (the rotated BEV
overlap of ``ops/rotated_iou.py`` in float64, as the JAX package's C++
library computes it), by ``tests/test_torch_sunrgbd.py``; and torch
versions of
``volume_of_boxes``, ``axis_aligned_iou_corner_format`` and
``rotation_3d_in_z`` (``rotation_3d_in_z_torch``, the yawed targets')
for the heads' targets and IoU loss (``volume_of_boxes`` also takes
numpy).
Boxes are (N, 7) rows (cx, cy, z_bottom, dx, dy, dz, yaw).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.rotated_iou import rotated_bev_overlap


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


def rotation_3d_in_z_torch(points: torch.Tensor,
                           angles: torch.Tensor) -> torch.Tensor:
    """``rotation_3d_in_z`` on tensors (the yawed targets' rotation on the
    device): (N, M, 3) points by (N,) angles about +z, ``points @ R_T``
    per batch element, as JAX's einsum."""
    rot_sin, rot_cos = torch.sin(angles), torch.cos(angles)
    ones, zeros = torch.ones_like(rot_cos), torch.zeros_like(rot_cos)
    rot_mat_T = torch.stack([
        torch.stack([rot_cos, -rot_sin, zeros]),
        torch.stack([rot_sin, rot_cos, zeros]),
        torch.stack([zeros, zeros, ones]),
    ])
    return torch.einsum("aij,jka->aik", points, rot_mat_T)


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


def shift_origin(boxes, src=(0.5, 0.5, 0.5), dst=(0.5, 0.5, 0.0)):
    """Move the reference point of each box from ``src`` to ``dst``
    (fractions of its dimensions)."""
    boxes = np.asarray(boxes, dtype=np.float32).copy()
    if boxes.size == 0:
        return boxes.reshape(0, boxes.shape[-1] if boxes.ndim == 2 else 7)
    offset = np.asarray(dst, np.float32) - np.asarray(src, np.float32)
    boxes[:, :3] = boxes[:, :3] + boxes[:, 3:6] * offset
    return boxes


def height_overlap(boxes1, boxes2):
    """Pairwise (N, M) vertical overlap."""
    b1_top = (boxes1[:, 2] + boxes1[:, 5])[:, None]
    b2_top = (boxes2[:, 2] + boxes2[:, 5])[None, :]
    b1_bot = boxes1[:, 2][:, None]
    b2_bot = boxes2[:, 2][None, :]
    return np.clip(
        np.minimum(b1_top, b2_top) - np.maximum(b1_bot, b2_bot), 0, None)


def axis_aligned_bev_overlap(boxes1, boxes2):
    """Pairwise (N, M) BEV intersection area for yaw-free boxes."""
    b1_min = (boxes1[:, :2] - boxes1[:, 3:5] * 0.5)[:, None, :]
    b1_max = (boxes1[:, :2] + boxes1[:, 3:5] * 0.5)[:, None, :]
    b2_min = (boxes2[:, :2] - boxes2[:, 3:5] * 0.5)[None, :, :]
    b2_max = (boxes2[:, :2] + boxes2[:, 3:5] * 0.5)[None, :, :]
    wh = np.clip(np.minimum(b1_max, b2_max) - np.maximum(b1_min, b2_min),
                 0, None)
    return wh[..., 0] * wh[..., 1]


def rotated_bev_overlap_f32(boxes1, boxes2):
    """Pairwise (N, M) BEV intersection areas of rotated boxes, computed
    in float64 and returned as float32, as the JAX package's C++
    ``rotated_bev_overlap`` (``csrc/geometry.cc``) returns them."""
    return rotated_bev_overlap(np.asarray(boxes1, np.float64),
                               np.asarray(boxes2, np.float64)).astype(
                                   np.float32)


def boxes_iou_3d(boxes1, boxes2, with_yaw: bool = False, mode: str = "iou"):
    """Pairwise 3D IoU (``mode='iou'``) or overlap over the first box's
    volume (``'iof'``) of bottom-centered numpy boxes: height overlap x
    BEV overlap, the rotated BEV overlap where ``with_yaw`` and the boxes
    carry a yaw (SUN RGB-D)."""
    if boxes1.shape[0] == 0 or boxes2.shape[0] == 0:
        return np.zeros((boxes1.shape[0], boxes2.shape[0]), np.float32)
    if with_yaw and boxes1.shape[-1] > 6:
        overlaps_bev = rotated_bev_overlap_f32(boxes1, boxes2)
    else:
        overlaps_bev = axis_aligned_bev_overlap(boxes1, boxes2)
    overlaps_3d = overlaps_bev * height_overlap(boxes1, boxes2)
    volume1 = volume_of_boxes(boxes1)[:, None]
    volume2 = volume_of_boxes(boxes2)[None, :]
    if mode == "iou":
        return overlaps_3d / np.clip(volume1 + volume2 - overlaps_3d, 1e-8,
                                     None)
    return overlaps_3d / np.clip(volume1, 1e-8, None)


class DepthBoxes3D:
    """Host-side boxes of the Depth frame: ``tensor`` (N, 7) float32,
    bottom-centered. Built from rows whose reference point is ``origin``
    (ScanNet's GT is gravity-centered, (0.5, 0.5, 0.5)); six-value rows
    without yaw get yaw 0."""

    def __init__(self, tensor, box_dim: int = 7, with_yaw: bool = True,
                 origin=(0.5, 0.5, 0)):
        tensor = np.asarray(tensor, dtype=np.float32).reshape(-1, box_dim)
        if not with_yaw and box_dim == 6:
            tensor = np.concatenate(
                [tensor, np.zeros((tensor.shape[0], 1), np.float32)], axis=-1
            )
            box_dim = 7
        if tuple(origin) != (0.5, 0.5, 0):
            tensor = shift_origin(tensor, src=origin, dst=(0.5, 0.5, 0))
        self.tensor = tensor
        self.box_dim = box_dim
        self.with_yaw = with_yaw

    def __len__(self):
        return self.tensor.shape[0]

    def overlaps(self, other: "DepthBoxes3D", mode: str = "iou"):
        return boxes_iou_3d(
            self.tensor, other.tensor, with_yaw=self.with_yaw or other.with_yaw,
            mode=mode,
        )
