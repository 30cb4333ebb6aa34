"""Detection losses of the 3D head, mask-weighted sums.

Port of the detection part of ``nerfdet_tpu/nn/losses.py``:
``sigmoid_focal_loss`` (mmcv semantics: labels outside ``[0, C)`` are
pure negatives), ``binary_cross_entropy`` (the centerness loss) and
``axis_aligned_iou_loss`` (1 - IoU of corner-format boxes). Each takes an
elementwise ``weight`` and an ``avg_factor``: ``sum(loss * weight) /
avg_factor``, times ``loss_weight``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.boxes import axis_aligned_iou_corner_format


def _bce_with_logits(logits, targets):
    """max(x, 0) - x t + log(1 + exp(-|x|)), stable for any logit."""
    return (torch.clamp(logits, min=0) - logits * targets
            + torch.log1p(torch.exp(-torch.abs(logits))))


def _reduce(loss, weight, avg_factor, loss_weight):
    if weight is not None:
        loss = loss * weight
    loss = loss.sum()
    if avg_factor is not None:
        loss = loss / avg_factor
    return loss * loss_weight


def sigmoid_focal_loss(logits, labels, weight=None, gamma: float = 2.0,
                       alpha: float = 0.25, avg_factor=None,
                       loss_weight: float = 1.0):
    """Focal loss of (N, C) class logits against (N,) int labels; a label
    outside [0, C) (e.g. -1) is background. ``weight`` is (N,)."""
    n_classes = logits.shape[-1]
    fg = (labels >= 0) & (labels < n_classes)
    one_hot = F.one_hot(torch.where(fg, labels, torch.zeros_like(labels))
                        .long(), n_classes).to(torch.float32)
    one_hot = one_hot * fg[..., None].to(torch.float32)
    p = torch.sigmoid(logits)
    ce = _bce_with_logits(logits, one_hot)
    p_t = p * one_hot + (1 - p) * (1 - one_hot)
    alpha_t = alpha * one_hot + (1 - alpha) * (1 - one_hot)
    loss = (alpha_t * ((1 - p_t) ** gamma) * ce).sum(-1)
    return _reduce(loss, weight, avg_factor, loss_weight)


def binary_cross_entropy(logits, targets, weight=None, avg_factor=None,
                         loss_weight: float = 1.0):
    """Sigmoid cross-entropy of logits against targets in [0, 1]."""
    return _reduce(_bce_with_logits(logits, targets), weight, avg_factor,
                   loss_weight)


def axis_aligned_iou_loss(pred, target, weight=None, avg_factor=None,
                          loss_weight: float = 1.0):
    """1 - IoU of (N, 6) corner-format (x1, y1, z1, x2, y2, z2) boxes."""
    iou = axis_aligned_iou_corner_format(pred, target, aligned=True)
    return _reduce(1.0 - iou, weight, avg_factor, loss_weight)
