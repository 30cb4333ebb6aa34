"""Vote generation from seed points.

Port of ``VoteModule`` in ``nerfdet_tpu/nn/vote_module.py`` with the
settings the VoteNet head uses: a per-seed MLP (Linear -> BatchNorm ->
ReLU) predicts one vote offset and residual feature per seed, and the
vote features are re-normalised to length sqrt(C). Several votes per
seed, the vote range clamp and the variants without residual features
or normalisation are not ported (no ported model sets them);
``vote_loss`` belongs to training.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
from torch import nn


class VoteModule(nn.Module):
    def __init__(self, in_channels: int, conv_channels: Sequence[int]):
        super().__init__()
        self.in_channels = in_channels
        self.n_layers = len(conv_channels)
        c = in_channels
        for i, ch in enumerate(conv_channels):
            self.add_module(f"conv{i}", nn.Linear(c, ch))
            self.add_module(f"bn{i}", nn.BatchNorm1d(ch, eps=1e-5,
                                                     momentum=0.1))
            c = ch
        self.conv_out = nn.Linear(c, 3 + in_channels)

    def forward(self, seed_xyz: torch.Tensor, seed_feats: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(S, 3) seeds + (S, C) features -> ((S, 3) votes, (S, C) vote
        features)."""
        x = seed_feats
        for i in range(self.n_layers):
            x = getattr(self, f"conv{i}")(x)
            x = torch.relu(getattr(self, f"bn{i}")(x))
        votes = self.conv_out(x)
        vote_xyz = seed_xyz + votes[:, :3]
        vote_feats = seed_feats + votes[:, 3:]
        norm = torch.linalg.vector_norm(vote_feats, dim=-1, keepdim=True)
        vote_feats = vote_feats / torch.clamp(norm, min=1e-8) * math.sqrt(
            self.in_channels)
        return vote_xyz, vote_feats
