"""Partial-bin box coder of the VoteNet head.

Port of ``PartialBinBasedBBoxCoder`` in
``nerfdet_tpu/core/bbox_coders.py`` (``split_pred``, ``decode``,
``class2angle``): direction as (bin class, residual), size as (cluster
class, residual from the cluster's mean size). One scene, no batch
axis. ``encode`` belongs to training and is not ported yet.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Tuple

import torch


@dataclass(frozen=True)
class PartialBinBasedBBoxCoder:
    num_dir_bins: int
    num_sizes: int
    mean_sizes: Tuple[Tuple[float, float, float], ...]
    with_rot: bool = True

    def __post_init__(self):
        if len(self.mean_sizes) != self.num_sizes:
            raise ValueError(f"{len(self.mean_sizes)} mean sizes for "
                             f"{self.num_sizes} size classes")

    def _means(self, like: torch.Tensor) -> torch.Tensor:
        return torch.tensor(self.mean_sizes, dtype=torch.float32,
                            device=like.device)

    def class2angle(self, cls, res):
        """Bin class + residual -> angle, wrapped into (-pi, pi]."""
        period = 2 * math.pi / self.num_dir_bins
        angle = cls.float() * period + res
        return torch.where(angle > math.pi, angle - 2 * math.pi, angle)

    def decode(self, bbox_out: Dict, suffix: str = "") -> torch.Tensor:
        """Prediction dict -> (P, 7) gravity-centered boxes."""
        center = bbox_out["center" + suffix]  # (P, 3)
        if self.with_rot:
            dir_class = torch.argmax(bbox_out["dir_class" + suffix], -1)
            dir_res = torch.gather(bbox_out["dir_res" + suffix], 1,
                                   dir_class[:, None])[:, 0]
            dir_angle = self.class2angle(dir_class, dir_res)[:, None]
        else:
            dir_angle = torch.zeros_like(center[:, :1])
        size_class = torch.argmax(bbox_out["size_class" + suffix], -1)
        size_res = torch.gather(
            bbox_out["size_res" + suffix], 1,
            size_class[:, None, None].expand(-1, 1, 3))[:, 0]
        bbox_size = self._means(center)[size_class] + size_res
        return torch.cat([center, bbox_size, dir_angle], dim=-1)

    def split_pred(self, cls_preds, reg_preds, base_xyz) -> Dict:
        """Split raw head channels.

        Args:
            cls_preds: (P, 2 + n_classes) objectness + semantic scores.
            reg_preds: (P, 3 + 2*bins + 4*sizes) regression channels.
            base_xyz: (P, 3) aggregation centers.
        """
        results: Dict = {}
        results["obj_scores"] = cls_preds[:, :2]
        results["sem_scores"] = cls_preds[:, 2:]
        start = 0
        results["center"] = base_xyz + reg_preds[:, start:start + 3]
        start += 3
        results["dir_class"] = reg_preds[:, start:start + self.num_dir_bins]
        start += self.num_dir_bins
        dir_res_norm = reg_preds[:, start:start + self.num_dir_bins]
        start += self.num_dir_bins
        results["dir_res_norm"] = dir_res_norm
        results["dir_res"] = dir_res_norm * (math.pi / self.num_dir_bins)
        results["size_class"] = reg_preds[:, start:start + self.num_sizes]
        start += self.num_sizes
        size_res_norm = reg_preds[
            :, start:start + self.num_sizes * 3].reshape(
            -1, self.num_sizes, 3)
        results["size_res_norm"] = size_res_norm
        results["size_res"] = size_res_norm * self._means(reg_preds)[None]
        return results
