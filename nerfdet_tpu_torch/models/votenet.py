"""VoteNet: point-cloud 3D detection on one cloud.

Port of ``nerfdet_tpu/models/votenet.py`` for inference: the
``PointNet2SASSG`` backbone -> ``VoteHead`` (its default 'vote' mode,
as the JAX forward and its test loop run it), and ``votenet_nms``, the
port's own numpy copy of the host tail (non-empty filter, aligned NMS,
per-class proposals), held bit for bit against the original by
``tests/test_torch_port_rules.py``.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..core.bbox_coders import PartialBinBasedBBoxCoder
from ..core.boxes import corners_from_boxes
from ..core.nms import aligned_3d_nms
from ..nn.pointnet2 import PointNet2SASSG
from ..nn.vote_head import VoteHead

# ScanNet mean sizes (reference votenet scannet config)
SCANNET_MEAN_SIZES = (
    (0.76966727, 0.8116021, 0.92573744),
    (1.876858, 1.8425595, 1.1931566),
    (0.61328, 0.6148609, 0.7182701),
    (1.3955007, 1.5121545, 0.83443564),
    (0.97949594, 1.0675149, 0.6329687),
    (0.531663, 0.5955577, 1.7500148),
    (0.9624706, 0.72462326, 1.1481868),
    (0.83221924, 1.0490936, 1.6875663),
    (0.21132214, 0.4206159, 0.5372846),
    (1.4440073, 1.8970833, 0.26985747),
    (1.0294262, 1.4040797, 0.87554324),
    (1.3766412, 0.65521795, 1.6813129),
    (0.6650819, 0.71111923, 1.298853),
    (0.41999173, 0.37906948, 1.7513971),
    (0.59359556, 0.5912492, 0.73919016),
    (0.50867593, 0.50656086, 0.30136237),
    (1.1511526, 1.0546296, 0.49706793),
    (0.47535285, 0.49249494, 0.5802117),
)


class VoteNet(nn.Module):
    def __init__(self, num_classes: int = 18, num_dir_bins: int = 1,
                 with_rot: bool = False,
                 mean_sizes: Sequence[Sequence[float]] = SCANNET_MEAN_SIZES,
                 num_proposal: int = 256,
                 backbone_cfg: Optional[Dict] = None):
        super().__init__()
        cfg = dict(backbone_cfg or {})
        self.num_classes = num_classes
        self.bbox_coder = PartialBinBasedBBoxCoder(
            num_dir_bins=num_dir_bins, num_sizes=len(mean_sizes),
            mean_sizes=tuple(tuple(m) for m in mean_sizes),
            with_rot=with_rot)
        self.backbone = PointNet2SASSG(**cfg)
        fp = cfg.get("fp_channels", ((256, 256), (256, 256)))
        self.bbox_head = VoteHead(num_classes=num_classes,
                                  bbox_coder=self.bbox_coder,
                                  in_channels=fp[-1][-1],
                                  num_proposal=num_proposal)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Seeded random weights after the JAX package's initializers:
        lecun-normal dense kernels (std 1/sqrt(fan_in)), zero biases,
        identity BatchNorms. Call it while the model is on the CPU."""
        for m in self.modules():
            if isinstance(m, nn.Linear):
                nn.init.normal_(m.weight, 0.0, m.weight.shape[1] ** -0.5,
                                generator=generator)
                if m.bias is not None:
                    nn.init.zeros_(m.bias)
            elif isinstance(m, nn.BatchNorm1d):
                m.reset_parameters()

    def forward(self, points: torch.Tensor) -> Dict:
        """points: (N, 3 + extra) one cloud -> the head's prediction
        dict."""
        return self.bbox_head(self.backbone(points))


def votenet_nms(boxes, obj_scores, sem_scores, points,
                nms_thr: float = 0.25, score_thr: float = 0.05,
                per_class_proposal: bool = True,
                min_points: int = 5) -> Dict:
    """Host tail: non-empty filter (> min_points inside), aligned NMS on
    corner AABBs, per-class proposal expansion.

    Args:
        boxes: (P, 7) gravity-centered decoded boxes.
        points: (N, 3) input cloud.

    Returns dict(boxes_3d (bottom-centered (n, 7)), scores_3d,
    labels_3d).
    """
    boxes = np.asarray(boxes)
    obj = np.asarray(obj_scores)
    sem = np.asarray(sem_scores)
    pts = np.asarray(points)[:, :3]

    bottom = boxes.copy()
    bottom[:, 2] -= bottom[:, 5] / 2

    # points-inside count per box (dense; overlapping boxes all counted)
    rel = pts[:, None, :2] - bottom[None, :, :2]
    c, s = np.cos(-bottom[:, 6]), np.sin(-bottom[:, 6])
    lx = rel[..., 0] * c[None] - rel[..., 1] * s[None]
    ly = rel[..., 0] * s[None] + rel[..., 1] * c[None]
    inside = ((np.abs(lx) <= bottom[None, :, 3] / 2)
              & (np.abs(ly) <= bottom[None, :, 4] / 2)
              & (pts[:, None, 2] >= bottom[None, :, 2])
              & (pts[:, None, 2] <= bottom[None, :, 2]
                 + bottom[None, :, 5]))
    nonempty = inside.sum(axis=0) > min_points

    corners = corners_from_boxes(bottom)
    minmax = np.concatenate(
        [corners.min(axis=1), corners.max(axis=1)], axis=-1)
    cls = sem.argmax(axis=-1)
    keep = aligned_3d_nms(minmax[nonempty], obj[nonempty], cls[nonempty],
                          nms_thr)
    sel_mask = np.zeros(len(boxes), bool)
    sel_mask[np.flatnonzero(nonempty)[keep]] = True
    sel_mask &= obj > score_thr

    if per_class_proposal:
        n_cls = sem.shape[-1]
        b = np.tile(bottom[sel_mask], (n_cls, 1))
        sc = np.concatenate(
            [obj[sel_mask] * sem[sel_mask, k] for k in range(n_cls)])
        lb = np.concatenate(
            [np.full(sel_mask.sum(), k, np.int64) for k in range(n_cls)])
        return dict(boxes_3d=b, scores_3d=sc, labels_3d=lb)
    return dict(boxes_3d=bottom[sel_mask], scores_3d=obj[sel_mask],
                labels_3d=cls[sel_mask])
