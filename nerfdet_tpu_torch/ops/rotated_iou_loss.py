"""The rotated 3D IoU of aligned box pairs in torch: the yawed losses' form.

Port of ``nerfdet_tpu/ops/rotated_iou.py``'s ``rotated_iou_3d_aligned``
as JAX runs it on jnp float32 arrays inside the SUN RGB-D heads' losses
(``nn/heads.head_loss_sums`` and ``nn/heads_v1.head_loss_sums_v1`` with
``yaw``), differentiable through autograd. The candidate vertices of a
pair's BEV intersection are the 4 corners of each box inside the other
and the 16 edge-edge intersections (24, in that order); the valid ones,
sorted by their angle around their centroid (a stable sort, invalid
ones last at angle 1e9), give the area by the shoelace formula over the
first ``n_valid``. The arithmetic follows JAX's float32 operation for
operation, and where torch's gradient rule differs from JAX's it is
written out as JAX's:

- ``jnp.clip(x, 0, None)``, ``jnp.maximum`` and ``jnp.minimum`` split the
  gradient of a tie in half: ``torch.maximum`` / ``torch.minimum`` do,
  ``torch.clamp`` gives it all to ``x``;
- ``jnp.abs`` has a gradient of 1 at 0, ``torch.abs`` 0;
- the centroid divides by the integer count and stays float32;
- no gradient flows through the sort.

JAX's form breaks down at coincident boxes (a vertex may drop out of
the sort; ROADMAP §3); the port follows it there too. The host's
float64 overlap for NMS and mAP is ``ops/rotated_iou.py``.
"""

from __future__ import annotations

import torch


def bev_corners(boxes: torch.Tensor) -> torch.Tensor:
    """(N, 7) boxes -> (N, 4, 2) BEV footprint corners, counter-clockwise
    for yaw 0."""
    cx, cy = boxes[:, 0], boxes[:, 1]
    dx, dy = boxes[:, 3], boxes[:, 4]
    yaw = boxes[:, 6]
    lx = torch.stack([dx / 2, -dx / 2, -dx / 2, dx / 2], dim=-1)
    ly = torch.stack([dy / 2, dy / 2, -dy / 2, -dy / 2], dim=-1)
    c, s = torch.cos(yaw)[:, None], torch.sin(yaw)[:, None]
    gx = lx * c - ly * s + cx[:, None]
    gy = lx * s + ly * c + cy[:, None]
    return torch.stack([gx, gy], dim=-1)


def _cross(o, a, b):
    return ((a[..., 0] - o[..., 0]) * (b[..., 1] - o[..., 1])
            - (a[..., 1] - o[..., 1]) * (b[..., 0] - o[..., 0]))


def _points_in_quad(pts, quad):
    """pts (N, P, 2) inside the convex quad (N, 4, 2), either winding."""
    s = torch.stack([_cross(quad[:, i, None, :],
                            quad[:, (i + 1) % 4, None, :], pts)
                     for i in range(4)], dim=-1)  # (N, P, 4)
    eps = 1e-8
    return (s >= -eps).all(dim=-1) | (s <= eps).all(dim=-1)


def _segment_intersections(c1, c2):
    """The 16 edge-pair intersections of two quads (N, 4, 2): points
    (N, 16, 2) and their validity (N, 16)."""
    r = torch.cat([c1[:, 1:], c1[:, :1]], dim=-2) - c1
    s = torch.cat([c2[:, 1:], c2[:, :1]], dim=-2) - c2
    p_, r_ = c1[:, :, None, :], r[:, :, None, :]  # (N, 4, 1, 2)
    q_, s_ = c2[:, None, :, :], s[:, None, :, :]  # (N, 1, 4, 2)
    denom = r_[..., 0] * s_[..., 1] - r_[..., 1] * s_[..., 0]
    qmp = q_ - p_
    t_num = qmp[..., 0] * s_[..., 1] - qmp[..., 1] * s_[..., 0]
    u_num = qmp[..., 0] * r_[..., 1] - qmp[..., 1] * r_[..., 0]
    small = denom.abs() < 1e-12
    safe = torch.where(small, torch.ones_like(denom), denom)
    t = t_num / safe
    u = u_num / safe
    valid = ((denom.abs() > 1e-12) & (t >= 0.0) & (t <= 1.0)
             & (u >= 0.0) & (u <= 1.0))
    pts = p_ + t[..., None] * r_
    n = pts.shape[0]
    return pts.reshape(n, 16, 2), valid.reshape(n, 16)


def _convex_area_from_candidates(cand, valid):
    """Area of the convex region of the valid candidates (N, 24, 2)."""
    n_valid = valid.sum(dim=-1)  # (N,)
    denom = torch.clamp(n_valid, min=1).to(cand.dtype)[:, None]
    centroid = (cand * valid[..., None].to(cand.dtype)).sum(dim=-2) / denom
    rel = cand - centroid[:, None, :]
    ang = torch.atan2(rel[..., 1].detach(), rel[..., 0].detach())
    ang = torch.where(valid, ang, torch.full_like(ang, 1e9))
    order = torch.argsort(ang, dim=-1, stable=True)
    sorted_rel = torch.gather(rel, 1, order[..., None].expand(-1, -1, 2))
    k = n_valid[:, None]
    idx = torch.arange(cand.shape[-2], device=cand.device)
    nxt = torch.where(idx + 1 < k, idx + 1, torch.zeros_like(idx))
    nxt_rel = torch.gather(sorted_rel, 1, nxt[..., None].expand(-1, -1, 2))
    crosses = (sorted_rel[..., 0] * nxt_rel[..., 1]
               - sorted_rel[..., 1] * nxt_rel[..., 0])
    use = (idx < k).to(crosses.dtype)
    total = (crosses * use).sum(dim=-1)
    area = 0.5 * torch.where(total >= 0, total, -total)  # jnp.abs' gradient
    return torch.where(n_valid >= 3, area, torch.zeros_like(area))


def rotated_iou_3d_aligned(boxes1: torch.Tensor,
                           boxes2: torch.Tensor) -> torch.Tensor:
    """(N,) 3D IoU of row i of ``boxes1`` with row i of ``boxes2``, both
    (N, 7) bottom-centered yawed boxes (cx, cy, z_bottom, dx, dy, dz,
    yaw); the union is floored at 1e-8."""
    c1, c2 = bev_corners(boxes1), bev_corners(boxes2)
    in12 = _points_in_quad(c1, c2)
    in21 = _points_in_quad(c2, c1)
    ipts, ivalid = _segment_intersections(c1, c2)
    cand = torch.cat([c1, c2, ipts], dim=-2)
    valid = torch.cat([in12, in21, ivalid], dim=-1)
    inter_bev = _convex_area_from_candidates(cand, valid)
    top1 = boxes1[:, 2] + boxes1[:, 5]
    top2 = boxes2[:, 2] + boxes2[:, 5]
    zero = torch.zeros((), dtype=boxes1.dtype, device=boxes1.device)
    inter_h = torch.maximum(torch.minimum(top1, top2)
                            - torch.maximum(boxes1[:, 2], boxes2[:, 2]), zero)
    inter = inter_bev * inter_h
    v1 = boxes1[:, 3] * boxes1[:, 4] * boxes1[:, 5]
    v2 = boxes2[:, 3] * boxes2[:, 4] * boxes2[:, 5]
    return inter / torch.maximum(v1 + v2 - inter, zero + 1e-8)


def to_bottom(boxes: torch.Tensor) -> torch.Tensor:
    """Gravity-centered (N, 7) boxes -> bottom-centered: z minus half the
    height (out of place)."""
    z = boxes[:, 2:3] + (-boxes[:, 5:6] / 2)
    return torch.cat([boxes[:, :2], z, boxes[:, 3:]], dim=-1)
