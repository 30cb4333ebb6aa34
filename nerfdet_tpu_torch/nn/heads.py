"""Anchor-free 3D detection head: forward, decode and the training
targets and loss sums.

Port of ``nerfdet_tpu/nn/heads.py``: ``ScanNetImVoxelHeadV2`` (shared
3x3x3 conv towers over the scales; with ``n_reg_outs=7`` the SUN RGB-D
``SunRgbdImVoxelHeadV2``, its seventh channel the raw angle),
``bbox_pred_to_bbox``, ``resize_valid``, ``get_candidate_bboxes`` (with
``yaw``, gravity-centered yawed boxes, the decode of both SUN RGB-D
heads), ``compute_centerness``, ``get_targets`` and ``head_loss_sums``
(with ``yaw``, SUN RGB-D: the offsets rotated into each box's frame,
the assigned gravity-centered yawed boxes as targets, and the rotated
3D IoU loss of ``ops/rotated_iou_loss.py``). Module
names follow the reference state_dict (``centerness_conv``,
``reg_conv``, ``cls_conv``, ``scales.{i}.scale``). The head's ``dtype``
is flax's compute dtype (``nn/compute.py``): at bfloat16 its outputs are
bfloat16, and the losses and the decode widen them where JAX's type
promotion does (a bfloat16 array meeting a float32 one).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch
from torch import nn

from ..core.boxes import rotation_3d_in_z_torch, volume_of_boxes
from ..ops.resize import resize_axes
from ..ops.rotated_iou_loss import rotated_iou_3d_aligned, to_bottom
from . import losses
from .compute import conv3x3x3


class _Scale(nn.Module):
    def __init__(self, value: float = 1.0):
        super().__init__()
        self.scale = nn.Parameter(torch.tensor(float(value)))


class ScanNetImVoxelHeadV2(nn.Module):
    def __init__(self, n_classes: int = 18, n_channels: int = 128,
                 n_reg_outs: int = 6, n_scales: int = 3,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.n_reg_outs = n_reg_outs
        self.centerness_conv = nn.Conv3d(n_channels, 1, 3, padding=1,
                                         bias=False)
        self.reg_conv = nn.Conv3d(n_channels, n_reg_outs, 3, padding=1,
                                  bias=False)
        self.cls_conv = nn.Conv3d(n_channels, n_classes, 3, padding=1)
        self.scales = nn.ModuleList(_Scale() for _ in range(n_scales))

    def forward(self, xs: Sequence[torch.Tensor]):
        """Per scale (centerness, exp(scale * reg), cls), NCDHW; past six
        regression channels the rest (the angle) are not exp'd."""
        dt, outs = self.dtype, []
        for i, x in enumerate(xs):
            reg = conv3x3x3(self.reg_conv, x, dt)
            bbox = torch.exp(self.scales[i].scale.to(dt) * reg[:, :6])
            if self.n_reg_outs > 6:
                bbox = torch.cat([bbox, reg[:, 6:]], dim=1)
            outs.append((conv3x3x3(self.centerness_conv, x, dt), bbox,
                         conv3x3x3(self.cls_conv, x, dt)))
        return outs


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


def resize_valid(valid: torch.Tensor, shape) -> torch.Tensor:
    """Resize the (nx, ny, nz) view-count volume and threshold it.

    The semantics are those of ``jax.image.resize(valid, shape,
    "trilinear")`` (antialias on) followed by ``round(r) > 0``. An axis
    whose size is unchanged is left as it is.
    """
    r = resize_axes(valid.float(), enumerate(shape))
    return torch.round(r) > 0


def _top_k_ids(values: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest values, ties to the lower index (as
    ``lax.top_k``)."""
    return torch.sort(values, descending=True, stable=True).indices[:k]


def get_candidate_bboxes(head_outs, valid, mlvl_points, nms_pre: int,
                         n_classes: int, yaw: bool = False
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-level top-k candidates.

    Args:
        head_outs: per scale (centerness, bbox_pred, cls_score),
            channels-last (nx, ny, nz, ch).
        valid: (nx, ny, nz) view counts at scale 0.
        mlvl_points: per scale (P, 3) voxel centers.

    Returns (M, 6) corner boxes, or with ``yaw`` (M, 7) gravity-centered
    yawed boxes (``heads_v1.bbox_pred_to_bbox_yaw``), and (M, n_classes)
    scores (sigmoid(cls) * sigmoid(centerness) * valid).
    """
    from .heads_v1 import bbox_pred_to_bbox_yaw
    decode = bbox_pred_to_bbox_yaw if yaw else bbox_pred_to_bbox
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
        all_boxes.append(decode(points, bbox_pred))
        all_scores.append(scores)
    return torch.cat(all_boxes), torch.cat(all_scores)


def compute_centerness(bbox_targets):
    """(..., 6) distance targets -> centerness, sqrt of the product of
    min/max over the three axes (NaN where a max is 0, as in JAX)."""
    x_dims = bbox_targets[..., 0:2]
    y_dims = bbox_targets[..., 2:4]
    z_dims = bbox_targets[..., 4:6]
    prod = (x_dims.min(-1).values / x_dims.max(-1).values
            * y_dims.min(-1).values / y_dims.max(-1).values
            * z_dims.min(-1).values / z_dims.max(-1).values)
    return torch.sqrt(torch.clamp(prod, min=0.0))


def get_targets(points, scale_ids, gt_boxes, gt_labels, gt_mask,
                n_scales: int, limit: int, centerness_topk: int,
                yaw: bool = False):
    """Assign each voxel center a target box and label.

    A point is a candidate for a (real) gt box when it lies inside it, on
    the box's best scale and among the box's ``centerness_topk`` most
    central points there (strictly above the (k+1)-th centerness). The
    best scale is the one before the first scale with fewer than
    ``limit`` points inside the box (scale 0 if that is scale 0), or the
    coarsest if no scale has fewer. A point that several boxes take goes
    to the smallest volume, then to the first box. With ``yaw`` the
    distances to the faces are taken in each box's frame (the point's
    offset from the box's center rotated by minus its yaw).

    Args:
        points: (P, 3) voxel centers of all scales, concatenated.
        scale_ids: (P,) scale of each point.
        gt_boxes: (G, 7) bottom-centered boxes, padded; gt_labels (G,);
            gt_mask (G,) bool, the real rows.

    Returns (centerness targets (P,), target boxes, labels (P,), -1 for
    background): the boxes corner-format (P, 6), or with ``yaw`` the
    assigned gt boxes gravity-centered with their yaw (P, 7).
    """
    float_max = 1e8
    n_points = points.shape[0]
    volumes = volume_of_boxes(gt_boxes)
    bottom = gt_boxes[..., :3]
    centers = torch.cat(
        [bottom[..., :2], bottom[..., 2:3] + gt_boxes[..., 5:6] * 0.5],
        dim=-1)
    dims = gt_boxes[:, 3:6]
    local = _box_frame(points, centers, gt_boxes[:, 6]) if yaw \
        else points[:, None, :]
    dx_min = local[..., 0] - centers[None, :, 0] + dims[None, :, 0] / 2
    dx_max = centers[None, :, 0] + dims[None, :, 0] / 2 - local[..., 0]
    dy_min = local[..., 1] - centers[None, :, 1] + dims[None, :, 1] / 2
    dy_max = centers[None, :, 1] + dims[None, :, 1] / 2 - local[..., 1]
    dz_min = local[..., 2] - centers[None, :, 2] + dims[None, :, 2] / 2
    dz_max = centers[None, :, 2] + dims[None, :, 2] / 2 - local[..., 2]
    bbox_targets = torch.stack(
        [dx_min, dx_max, dy_min, dy_max, dz_min, dz_max], dim=-1)  # (P, G, 6)

    # inside a real box
    inside = (bbox_targets.min(-1).values > 0) & gt_mask[None, :]

    # the best scale of each box (>= limit points inside)
    scale_onehot = torch.nn.functional.one_hot(
        scale_ids.long(), n_scales).to(torch.float32)
    n_pos_per_scale = scale_onehot.t() @ inside.to(torch.float32)  # (S, G)
    lower_limit_mask = n_pos_per_scale < limit
    extra = torch.arange(n_scales, 0, -1, dtype=torch.int32,
                         device=points.device)[:, None]
    lower_index = torch.argmax(lower_limit_mask.to(torch.int32) * extra,
                               dim=0) - 1  # first index of the max
    lower_index = torch.clamp(lower_index, min=0)
    all_upper = torch.all(~lower_limit_mask, dim=0)
    best_scale = torch.where(all_upper, torch.full_like(lower_index,
                                                        n_scales - 1),
                             lower_index)
    inside_best_scale = best_scale[None, :] == scale_ids[:, None]

    # the box's top-k centerness
    centerness = compute_centerness(bbox_targets)
    centerness = torch.where(inside, centerness,
                             torch.full_like(centerness, -1.0))
    centerness = torch.where(inside_best_scale, centerness,
                             torch.full_like(centerness, -1.0))
    top_c = torch.topk(centerness.t(), centerness_topk + 1, dim=1).values
    inside_top = centerness > top_c[:, -1][None, :]

    # smallest volume, then the first box
    vols = volumes[None, :].expand(n_points, -1)
    vols = torch.where(inside & inside_best_scale & inside_top, vols,
                       torch.full_like(vols, float_max))
    min_area, min_inds = vols.min(dim=1).values, torch.argmin(vols, dim=1)
    labels = gt_labels[min_inds]
    labels = torch.where(min_area == float_max, torch.full_like(labels, -1),
                         labels)
    sel_targets = bbox_targets[torch.arange(n_points, device=points.device),
                               min_inds]
    if yaw:
        tgt = torch.cat([centers, dims, gt_boxes[:, 6:7]], dim=-1)
        return compute_centerness(sel_targets), tgt[min_inds], labels
    return (compute_centerness(sel_targets),
            bbox_pred_to_bbox(points, sel_targets), labels)


def _box_frame(points, centers, yaws):
    """(P, G, 3): each point in each box's frame, its offset from the
    box's center rotated by minus the box's yaw, then the center added
    back (JAX's ``rotation_3d_in_axis(..., axis=2)`` on (G, P, 3))."""
    rel = points[:, None, :] - centers[None, :, :]
    rel_r = rotation_3d_in_z_torch(rel.transpose(0, 1), -yaws)
    return rel_r.transpose(0, 1) + centers[None, :, :]


def yawed_iou_loss(points, bbox_preds, box_t):
    """(P,) rotated 3D IoU of the decoded yawed predictions
    (``heads_v1.bbox_pred_to_bbox_yaw``) with the gravity-centered yawed
    targets, both moved to their bottoms first."""
    from .heads_v1 import bbox_pred_to_bbox_yaw
    pred = bbox_pred_to_bbox_yaw(points, bbox_preds)
    return rotated_iou_3d_aligned(to_bottom(pred), to_bottom(box_t))


def head_loss_sums(head_outs, valid, mlvl_points, gt_boxes, gt_labels,
                   gt_mask, n_scales: int, limit: int, centerness_topk: int,
                   n_classes: int,
                   yaw: bool = False) -> Dict[str, torch.Tensor]:
    """Per-scene loss sums and their normalizers: cls_sum (focal over the
    observed voxels), centerness_sum (BCE over the positives), bbox_sum
    (1 - IoU weighted by the centerness targets: the axis-aligned IoU, or
    with ``yaw`` the rotated 3D IoU, summed over the positives alone), n_pos
    and bbox_avg (the positives' centerness sum). The train step
    normalizes them.

    ``head_outs``: per scale (centerness, bbox_pred, cls_score),
    channels-last without a batch dimension; ``valid`` the (nx, ny, nz)
    view counts at scale 0; ``mlvl_points`` per-scale (P_i, 3) centers.
    Targets carry no gradient.
    """
    flat_center, flat_bbox, flat_cls, flat_valid = [], [], [], []
    for c, b, s in head_outs:
        flat_center.append(c.reshape(-1))
        flat_bbox.append(b.reshape(-1, b.shape[-1]))
        flat_cls.append(s.reshape(-1, n_classes))
        flat_valid.append(resize_valid(valid, c.shape[:-1]).reshape(-1))
    centerness = torch.cat(flat_center)
    bbox_preds = torch.cat(flat_bbox)
    cls_scores = torch.cat(flat_cls)
    valids = torch.cat(flat_valid)
    points = torch.cat(mlvl_points)
    scale_ids = torch.cat([
        torch.full((p.shape[0],), i, dtype=torch.int32, device=p.device)
        for i, p in enumerate(mlvl_points)])

    with torch.no_grad():
        centerness_t, bbox_t, labels = get_targets(
            points, scale_ids, gt_boxes, gt_labels, gt_mask, n_scales,
            limit, centerness_topk, yaw)
    pos = (labels >= 0) & valids
    n_pos = pos.sum().to(torch.float32)
    cls_sum = losses.sigmoid_focal_loss(
        cls_scores, torch.where(valids, labels, torch.full_like(labels, -1)),
        weight=valids.to(torch.float32))
    pos_w = pos.to(torch.float32)
    centerness_t = torch.where(pos, centerness_t,
                               torch.zeros_like(centerness_t))
    centerness_sum = losses.binary_cross_entropy(centerness, centerness_t,
                                                 weight=pos_w)
    bbox_avg = torch.sum(centerness_t * pos_w)
    if yaw:  # a background row's IoU may be anything finite: mask it
        iou = yawed_iou_loss(points, bbox_preds, bbox_t)
        bbox_sum = torch.sum(torch.where(
            pos, (1.0 - iou) * centerness_t * pos_w, torch.zeros_like(iou)))
    else:
        bbox_sum = losses.axis_aligned_iou_loss(
            bbox_pred_to_bbox(points, bbox_preds), bbox_t,
            weight=centerness_t * pos_w)
    return dict(cls_sum=cls_sum, centerness_sum=centerness_sum,
                bbox_sum=bbox_sum, n_pos=n_pos, bbox_avg=bbox_avg)
