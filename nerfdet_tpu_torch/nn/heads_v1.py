"""The indoor ImVoxelNet's V1 head: forward, the regress-range
assignment, the loss sums and the decode.

Port of ``nerfdet_tpu/nn/heads_v1.py``: ``_ConvTower`` (``n_convs`` x
conv-BN-ReLU a branch), ``ImVoxelHeadV1`` (centerness and regression
convs on the regression tower, the class conv on the class tower, one
scale a regress range exp'd with the regression; with ``yaw``, the SUN
RGB-D ``SunRgbdImVoxelHead``, the six distances exp'd and the seventh
channel, the angle, raw), ``bbox_pred_to_bbox_yaw`` (the yawed decode's
boxes), ``get_targets_v1`` (FCOS-style: inside the box, its largest
distance within the point's level range, among the box's
``centerness_topk`` most central points, then the smallest volume) and
``head_loss_sums_v1`` (with ``yaw``: the offsets rotated into each
box's frame, the assigned gravity-centered yawed boxes as targets, the
rotated 3D IoU loss). Its decode is the V2 head's
(``nn/heads.get_candidate_bboxes``, with ``yaw`` for the SUN RGB-D head),
as in JAX.

Names follow the flax tree (``reg_convs.conv_{i}``, ``reg_convs.norm_{i}``,
``centerness_conv``, ``reg_conv``, ``cls_conv``) and, as the port's V2
head, ``scales.{i}.scale``. The 3x3x3 convs run the JAX package's
schedule at ``dtype`` (``nn/compute.conv3x3x3``); outputs as
``nn/heads.ScanNetImVoxelHeadV2``'s.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
from torch import nn

from . import losses
from .compute import conv3x3x3
from .heads import (_box_frame, _Scale, bbox_pred_to_bbox,
                    compute_centerness, resize_valid, yawed_iou_loss)
from .neck3d import BatchNorm3d

INF = 1e8


def _conv3(c_in: int, c_out: int, bias: bool = False) -> nn.Conv3d:
    return nn.Conv3d(c_in, c_out, 3, padding=1, bias=bias)


class _ConvTower(nn.Module):
    """``n_convs`` x (3x3x3 conv without bias, BN, ReLU)."""

    def __init__(self, c_in: int, n_channels: int, n_convs: int,
                 dtype=torch.float32):
        super().__init__()
        self.n_convs, self.dtype = n_convs, dtype
        for i in range(n_convs):
            self.add_module(f"conv_{i}", _conv3(c_in if i == 0
                                                else n_channels, n_channels))
            self.add_module(f"norm_{i}", BatchNorm3d(n_channels))

    def forward(self, x):
        for i in range(self.n_convs):
            x = conv3x3x3(getattr(self, f"conv_{i}"), x, self.dtype)
            x = torch.relu(getattr(self, f"norm_{i}")(x))
        return x


class ImVoxelHeadV1(nn.Module):
    """Multi-level head with separate regression and class towers."""

    def __init__(self, in_channels: int, n_classes: int = 18,
                 n_channels: int = 64, n_convs: int = 0,
                 n_reg_outs: int = 6,
                 regress_ranges: Sequence[Tuple[float, float]] = (
                     (-1e8, 1e8),), yaw: bool = False,
                 dtype=torch.float32):
        super().__init__()
        if n_reg_outs != (7 if yaw else 6):
            raise ValueError(f"the V1 head regresses {7 if yaw else 6} "
                             f"values with yaw={yaw}, not {n_reg_outs}")
        self.dtype, self.yaw = dtype, yaw
        self.reg_convs = _ConvTower(in_channels, n_channels, n_convs, dtype)
        self.cls_convs = _ConvTower(in_channels, n_channels, n_convs, dtype)
        c = n_channels if n_convs else in_channels
        self.centerness_conv = _conv3(c, 1)
        self.reg_conv = _conv3(c, n_reg_outs)
        self.cls_conv = _conv3(c, n_classes, bias=True)
        self.scales = nn.ModuleList(_Scale() for _ in regress_ranges)

    def forward(self, xs: Sequence[torch.Tensor]):
        """Per level (centerness, exp(scale * reg), cls), NCDHW; with yaw
        the regression's seventh channel (the angle) is not exp'd."""
        dt, outs = self.dtype, []
        for i, x in enumerate(xs):
            reg, cls = self.reg_convs(x), self.cls_convs(x)
            reg_final = conv3x3x3(self.reg_conv, reg, dt)
            bbox = torch.exp(self.scales[i].scale.to(dt) * reg_final[:, :6])
            if self.yaw:
                bbox = torch.cat([bbox, reg_final[:, 6:7]], dim=1)
            outs.append((conv3x3x3(self.centerness_conv, reg, dt), bbox,
                         conv3x3x3(self.cls_conv, cls, dt)))
        return outs


def bbox_pred_to_bbox_yaw(points, bbox_pred):
    """(M, 7) distances and angle -> (M, 7) gravity-centered yawed boxes
    (cx, cy, cz, dx, dy, dz, yaw): the distances' midpoint offset rotated
    by the angle about +z (``rotation_3d_in_axis(..., axis=2)``, a row
    vector times R^T) from the point. The rotation runs in float32 and is
    cast to the predictions' dtype, as JAX's einsum accumulates."""
    dt = bbox_pred.dtype
    sx = (bbox_pred[:, 1] - bbox_pred[:, 0]) / 2
    sy = (bbox_pred[:, 3] - bbox_pred[:, 2]) / 2
    sz = (bbox_pred[:, 5] - bbox_pred[:, 4]) / 2
    angle = bbox_pred[:, 6]
    c, s = torch.cos(angle).float(), torch.sin(angle).float()
    shift = torch.stack([sx.float() * c + sy.float() * s,
                         sy.float() * c - sx.float() * s,
                         sz.float()], dim=-1).to(dt)
    center = points + shift
    size = torch.stack([bbox_pred[:, 0] + bbox_pred[:, 1],
                        bbox_pred[:, 2] + bbox_pred[:, 3],
                        bbox_pred[:, 4] + bbox_pred[:, 5]], dim=-1)
    out_dt = torch.promote_types(center.dtype, dt)
    return torch.cat([center.to(out_dt), size.to(out_dt),
                      bbox_pred[:, 6:7].to(out_dt)], dim=-1)


def get_targets_v1(points, range_ids, regress_ranges, gt_boxes, gt_labels,
                   gt_mask, n_classes: int, centerness_topk: int,
                   yaw: bool = False):
    """The V1 assignment.

    A point is a candidate for a real gt box when it lies inside it, the
    largest of its six distances to the box's faces lies in the point's
    level range (``regress_ranges[range_ids]``, both ends included) and,
    with ``centerness_topk`` > 0, its centerness is strictly above the
    box's k-th largest (a value: a tie cannot change the assignment). A
    point several boxes take goes to the smallest volume, then the first
    box. With ``yaw`` the distances are taken in each box's frame.

    Args:
        points: (P, 3) centers of every level, concatenated.
        range_ids: (P,) level of each point.
        regress_ranges: (L, 2) (min, max) distance of each level.
        gt_boxes: (G, 7) bottom-centered boxes, padded; gt_labels (G,);
            gt_mask (G,) bool, the real rows.

    Returns (centerness targets (P,), boxes, labels (P,), ``n_classes``
    for background): the boxes corner-format (P, 6), or with ``yaw`` the
    assigned gt boxes gravity-centered with their yaw (P, 7).
    """
    n_points = points.shape[0]
    bottom = gt_boxes[:, :3]
    centers = torch.cat([bottom[:, :2], bottom[:, 2:3]
                         + gt_boxes[:, 5:6] * 0.5], dim=-1)
    dims = gt_boxes[:, 3:6]
    volumes = dims[:, 0] * dims[:, 1] * dims[:, 2]
    local = _box_frame(points, centers, gt_boxes[:, 6]) if yaw \
        else points[:, None, :]
    dists = torch.stack([
        local[..., 0] - centers[None, :, 0] + dims[None, :, 0] / 2,
        centers[None, :, 0] + dims[None, :, 0] / 2 - local[..., 0],
        local[..., 1] - centers[None, :, 1] + dims[None, :, 1] / 2,
        centers[None, :, 1] + dims[None, :, 1] / 2 - local[..., 1],
        local[..., 2] - centers[None, :, 2] + dims[None, :, 2] / 2,
        centers[None, :, 2] + dims[None, :, 2] / 2 - local[..., 2],
    ], dim=-1)  # (P, G, 6)

    inside = (dists.min(-1).values > 0) & gt_mask[None, :]
    ranges = torch.as_tensor(regress_ranges, dtype=torch.float32,
                             device=points.device)[range_ids.long()]
    max_dist = dists.max(-1).values
    in_range = (max_dist >= ranges[:, :1]) & (max_dist <= ranges[:, 1:])

    vols = volumes[None, :].expand(n_points, -1)
    inf = torch.full_like(vols, INF)
    if centerness_topk > 0:
        centerness = torch.where(inside & in_range,
                                 compute_centerness(dists),
                                 torch.full_like(vols, -1.0))
        k = min(centerness_topk, n_points)
        top_c = torch.topk(centerness.t(), k, dim=1).values[:, -1]
        vols = torch.where(centerness > top_c[None, :], vols, inf)
    vols = torch.where(inside & in_range, vols, inf)
    min_area = vols.min(dim=1).values
    min_inds = torch.argmin(vols, dim=1)  # the first of equal minima
    labels = torch.where(min_area == INF,
                         torch.full_like(gt_labels[min_inds], n_classes),
                         gt_labels[min_inds])
    sel = dists[torch.arange(n_points, device=points.device), min_inds]
    if yaw:
        tgt = torch.cat([centers, dims, gt_boxes[:, 6:7]], dim=-1)
        return compute_centerness(sel), tgt[min_inds], labels
    return compute_centerness(sel), bbox_pred_to_bbox(points, sel), labels


def head_loss_sums_v1(head_outs, valid, mlvl_points, regress_ranges,
                      gt_boxes, gt_labels, gt_mask, n_classes: int,
                      centerness_topk: int,
                      yaw: bool = False) -> Dict[str, torch.Tensor]:
    """Per-scene V1 loss sums and normalizers, the contract of
    ``nn/heads.head_loss_sums`` (cls_sum, centerness_sum, bbox_sum, n_pos,
    bbox_avg): focal loss over the observed voxels (background -1 for it,
    where the assignment says ``n_classes``), BCE centerness and the
    axis-aligned IoU loss (with ``yaw`` the rotated 3D IoU loss) over the
    positives. ``head_outs`` per level (centerness, bbox_pred, cls_score)
    channels-last; ``valid`` the (nx, ny, nz) view counts at level 0.
    Targets carry no gradient."""
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
    range_ids = torch.cat([
        torch.full((p.shape[0],), i, dtype=torch.int32, device=p.device)
        for i, p in enumerate(mlvl_points)])

    with torch.no_grad():
        centerness_t, box_t, labels = get_targets_v1(
            points, range_ids, regress_ranges, gt_boxes, gt_labels,
            gt_mask, n_classes, centerness_topk, yaw)
    fg = labels < n_classes
    pos = fg & valids
    background = torch.full_like(labels, -1)
    cls_sum = losses.sigmoid_focal_loss(
        cls_scores, torch.where(valids & fg, labels, background),
        weight=valids.to(torch.float32))
    pos_w = pos.to(torch.float32)
    centerness_t = torch.where(pos, centerness_t,
                               torch.zeros_like(centerness_t))
    centerness_sum = losses.binary_cross_entropy(centerness, centerness_t,
                                                 weight=pos_w)
    w = centerness_t * pos_w
    if yaw:  # a background row's IoU may be anything finite: mask it
        iou = yawed_iou_loss(points, bbox_preds, box_t)
        bbox_sum = torch.sum(torch.where(pos, (1.0 - iou) * w,
                                         torch.zeros_like(iou)))
    else:
        bbox_sum = losses.axis_aligned_iou_loss(
            bbox_pred_to_bbox(points, bbox_preds), box_t, weight=w)
    return dict(cls_sum=cls_sum, centerness_sum=centerness_sum,
                bbox_sum=bbox_sum, n_pos=pos.sum().to(torch.float32),
                bbox_avg=torch.sum(w))

