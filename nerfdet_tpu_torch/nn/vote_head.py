"""VoteNet detection head, inference.

Port of the ``VoteHead`` forward and ``vote_head_get_bboxes`` in
``nerfdet_tpu/nn/vote_head.py``: seeds -> ``VoteModule`` -> vote
aggregation (set abstraction over the votes) -> prediction MLP ->
class / regression layers -> partial-bin split; decode to boxes with
objectness and semantic probabilities. The losses belong to training.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

from ..core.bbox_coders import PartialBinBasedBBoxCoder
from ..ops import pointnet
from .pointnet2 import PointSAModule, SharedMLP
from .vote_module import VoteModule


# the JAX VoteHead's defaults, which its builder keeps
VOTE_CONV_CHANNELS = (256, 256)
AGG_RADIUS, AGG_NUM_SAMPLE, AGG_MLP_CHANNELS = 0.3, 16, (128, 128, 128)
PRED_LAYER_CHANNELS = (128, 128)


class VoteHead(nn.Module):
    def __init__(self, num_classes: int,
                 bbox_coder: PartialBinBasedBBoxCoder,
                 in_channels: int, num_proposal: int):
        super().__init__()
        self.num_classes = num_classes
        self.bbox_coder = bbox_coder
        self.vote_module = VoteModule(in_channels, VOTE_CONV_CHANNELS)
        self.vote_aggregation = PointSAModule(
            num_proposal, AGG_RADIUS, AGG_NUM_SAMPLE, in_channels,
            AGG_MLP_CHANNELS)
        self.pred_mlp = SharedMLP(AGG_MLP_CHANNELS[-1], PRED_LAYER_CHANNELS)
        c = PRED_LAYER_CHANNELS[-1]
        self.conv_cls = nn.Linear(c, num_classes + 2)
        self.conv_reg = nn.Linear(
            c, 3 + bbox_coder.num_dir_bins * 2 + bbox_coder.num_sizes * 4)

    def forward(self, feat_dict: Dict, sample_mod: str = "vote") -> Dict:
        """feat_dict: the backbone's output (fp_xyz / fp_features /
        fp_indices). 'vote' samples the proposals by FPS over the votes;
        'seed' by FPS over the seeds, taking the matching votes."""
        if sample_mod not in ("vote", "seed"):
            raise ValueError(f"unknown sample_mod {sample_mod!r}")
        seed_xyz = feat_dict["fp_xyz"][-1]
        seed_feats = feat_dict["fp_features"][-1]
        vote_xyz, vote_feats = self.vote_module(seed_xyz, seed_feats)
        sample_indices = None
        if sample_mod == "seed":
            sample_indices = pointnet.furthest_point_sample(
                seed_xyz, self.vote_aggregation.num_point)
        agg_xyz, agg_feats, _ = self.vote_aggregation(
            vote_xyz, vote_feats, sample_indices=sample_indices)
        x = self.pred_mlp(agg_feats)
        results = self.bbox_coder.split_pred(self.conv_cls(x),
                                             self.conv_reg(x), agg_xyz)
        results.update(
            seed_points=seed_xyz,
            seed_indices=feat_dict.get("fp_indices"),
            vote_points=vote_xyz,
            vote_features=vote_feats,
            aggregated_points=agg_xyz,
            aggregated_features=agg_feats,
        )
        return results


def vote_head_get_bboxes(preds: Dict, coder: PartialBinBasedBBoxCoder
                         ) -> Tuple[torch.Tensor, torch.Tensor,
                                    torch.Tensor]:
    """Decode proposals -> ((P, 7) gravity-centered boxes, (P,)
    objectness probability, (P, num_classes) semantic probabilities).
    The host ``votenet_nms`` finishes the job."""
    boxes = coder.decode(preds)
    obj = torch.softmax(preds["obj_scores"], dim=-1)[:, 1]
    sem = torch.softmax(preds["sem_scores"], dim=-1)
    return boxes, obj, sem
