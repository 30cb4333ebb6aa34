"""Anchor-free 3D detection head (ScanNet variant), inference part.

Port of the forward and decode parts of ``nerfdet_tpu/nn/heads.py``:
``ScanNetImVoxelHeadV2`` (shared 3x3x3 conv towers over the scales),
``bbox_pred_to_bbox``, ``resize_valid`` and ``get_candidate_bboxes``.
Module names follow the reference state_dict (``centerness_conv``,
``reg_conv``, ``cls_conv``, ``scales.{i}.scale``).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch
from torch import nn


class _Scale(nn.Module):
    def __init__(self, value: float = 1.0):
        super().__init__()
        self.scale = nn.Parameter(torch.tensor(float(value)))


class ScanNetImVoxelHeadV2(nn.Module):
    def __init__(self, n_classes: int = 18, n_channels: int = 128,
                 n_reg_outs: int = 6, n_scales: int = 3):
        super().__init__()
        if n_reg_outs != 6:
            raise NotImplementedError(
                "the yawed (n_reg_outs=7) head is not yet ported")
        self.centerness_conv = nn.Conv3d(n_channels, 1, 3, padding=1,
                                         bias=False)
        self.reg_conv = nn.Conv3d(n_channels, n_reg_outs, 3, padding=1,
                                  bias=False)
        self.cls_conv = nn.Conv3d(n_channels, n_classes, 3, padding=1)
        self.scales = nn.ModuleList(_Scale() for _ in range(n_scales))

    def forward(self, xs: Sequence[torch.Tensor]):
        """Per scale (centerness, exp(scale * reg), cls), NCDHW."""
        return [(self.centerness_conv(x),
                 torch.exp(self.scales[i].scale * self.reg_conv(x)),
                 self.cls_conv(x)) for i, x in enumerate(xs)]


def bbox_pred_to_bbox(points, bbox_pred):
    """Distances -> corner boxes (x1, y1, z1, x2, y2, z2)."""
    return torch.stack([
        points[..., 0] - bbox_pred[..., 0],
        points[..., 1] - bbox_pred[..., 2],
        points[..., 2] - bbox_pred[..., 4],
        points[..., 0] + bbox_pred[..., 1],
        points[..., 1] + bbox_pred[..., 3],
        points[..., 2] + bbox_pred[..., 5],
    ], dim=-1)


def _resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """(in, out) float32 weights of ``jax.image.resize(..., "trilinear")``
    along one axis, antialiased: when downsampling, the triangle filter
    widens by in/out (a low-pass filter), unlike ``F.interpolate``."""
    f32 = np.float32
    scale = out_size / in_size
    inv_scale = 1.0 / scale
    kernel_scale = f32(max(inv_scale, 1.0))
    sample_f = ((np.arange(out_size, dtype=f32) + f32(0.5)) * f32(inv_scale)
                - f32(0.0 * inv_scale) - f32(0.5))
    x = np.abs(sample_f[None, :]
               - np.arange(in_size, dtype=f32)[:, None]) / kernel_scale
    weights = np.maximum(f32(0), f32(1) - np.abs(x))
    total = weights.sum(axis=0, keepdims=True, dtype=f32)
    weights = np.where(
        np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
        weights / np.where(total != 0, total, f32(1)), f32(0))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return np.where(inside[None, :], weights, f32(0)).astype(f32)


def resize_valid(valid: torch.Tensor, shape) -> torch.Tensor:
    """Resize the (nx, ny, nz) view-count volume and threshold it.

    The semantics are those of ``jax.image.resize(valid, shape,
    "trilinear")`` (antialias on) followed by ``round(r) > 0``. An axis
    whose size is unchanged is left as it is.
    """
    r = valid.float()
    for axis, out in enumerate(shape):
        if r.shape[axis] == out:
            continue
        w = torch.from_numpy(_resize_weights(r.shape[axis], out)).to(
            r.device)
        r = torch.movedim(torch.tensordot(r, w, dims=([axis], [0])), -1,
                          axis)
    return torch.round(r) > 0


def _top_k_ids(values: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest values, ties to the lower index (as
    ``lax.top_k``)."""
    return torch.sort(values, descending=True, stable=True).indices[:k]


def get_candidate_bboxes(head_outs, valid, mlvl_points, nms_pre: int,
                         n_classes: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-level top-k candidates.

    Args:
        head_outs: per scale (centerness, bbox_pred, cls_score),
            channels-last (nx, ny, nz, ch).
        valid: (nx, ny, nz) view counts at scale 0.
        mlvl_points: per scale (P, 3) voxel centers.

    Returns (M, 6) corner boxes and (M, n_classes) scores
    (sigmoid(cls) * sigmoid(centerness) * valid).
    """
    all_boxes: List[torch.Tensor] = []
    all_scores: List[torch.Tensor] = []
    for (c, b, s), points in zip(head_outs, mlvl_points):
        center = torch.sigmoid(c.reshape(-1))
        bbox_pred = b.reshape(-1, b.shape[-1])
        scores = torch.sigmoid(s.reshape(-1, n_classes))
        v = resize_valid(valid, c.shape[:-1]).reshape(-1)
        scores = scores * center[:, None] * v[:, None].to(scores.dtype)
        if scores.shape[0] > nms_pre > 0:
            ids = _top_k_ids(scores.max(dim=1).values, nms_pre)
            bbox_pred, scores, points = bbox_pred[ids], scores[ids], points[ids]
        all_boxes.append(bbox_pred_to_bbox(points, bbox_pred))
        all_scores.append(scores)
    return torch.cat(all_boxes), torch.cat(all_scores)
