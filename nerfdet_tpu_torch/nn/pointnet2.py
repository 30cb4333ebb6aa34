"""PointNet++ single-scale-grouping backbone on one cloud.

Port of ``nerfdet_tpu/nn/pointnet2.py`` (``SharedMLP``,
``PointSAModule``, ``PointFPModule``, ``PointNet2SASSG``): set
abstraction (FPS -> ball query -> grouped shared MLP -> max pool) and
feature propagation (three_nn inverse-distance interpolation -> shared
MLP). Point-major (N, C) layouts, no batch axis, as in the JAX package.
Module names follow the flax tree, so ``from_jax_variables`` maps it
key for key. BatchNorm stays a module with running statistics.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
from torch import nn

from ..ops import pointnet


class SharedMLP(nn.Module):
    """Per-point MLP (1x1 conv stack): Linear without bias -> BatchNorm
    -> ReLU per layer, on (..., C)."""

    def __init__(self, in_channels: int, channels: Sequence[int]):
        super().__init__()
        self.n_layers = len(channels)
        for i, c in enumerate(channels):
            self.add_module(f"fc{i}", nn.Linear(in_channels, c, bias=False))
            self.add_module(f"bn{i}", nn.BatchNorm1d(c, eps=1e-5,
                                                     momentum=0.1))
            in_channels = c
        self.out_channels = in_channels

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lead = x.shape[:-1]
        x = x.reshape(-1, x.shape[-1])
        for i in range(self.n_layers):
            x = getattr(self, f"fc{i}")(x)
            x = torch.relu(getattr(self, f"bn{i}")(x))
        return x.reshape(*lead, x.shape[-1])


class PointSAModule(nn.Module):
    """Set abstraction: FPS + ball-query grouping + MLP + max pool."""

    def __init__(self, num_point: int, radius: float, num_sample: int,
                 in_channels: int, mlp_channels: Sequence[int],
                 use_xyz: bool = True):
        super().__init__()
        self.num_point = num_point
        self.radius = radius
        self.num_sample = num_sample
        self.use_xyz = use_xyz
        self.mlp = SharedMLP(in_channels + (3 if use_xyz else 0),
                             mlp_channels)

    def forward(self, xyz, features, sample_indices=None):
        """(N, 3), (N, C) or None -> ((S, 3), (S, C'), (S,) int32 idx).

        ``sample_indices`` gives the centers instead of FPS (the head's
        'seed' mode)."""
        fps_idx = (sample_indices if sample_indices is not None
                   else pointnet.furthest_point_sample(xyz, self.num_point))
        new_xyz = pointnet.gather_points(xyz, fps_idx)
        group_idx = pointnet.ball_query(new_xyz, xyz, self.radius,
                                        self.num_sample)
        grouped = pointnet.group_points(xyz, features, None, group_idx,
                                        use_xyz=self.use_xyz,
                                        new_xyz=new_xyz)
        return new_xyz, self.mlp(grouped).amax(dim=1), fps_idx


class PointFPModule(nn.Module):
    """Feature propagation: 3-NN interpolation + MLP."""

    def __init__(self, in_channels: int, mlp_channels: Sequence[int]):
        super().__init__()
        self.mlp = SharedMLP(in_channels, mlp_channels)

    def forward(self, target_xyz, source_xyz, target_feats, source_feats):
        dist, idx = pointnet.three_nn(target_xyz, source_xyz)
        w = pointnet.interpolation_weights(dist)
        interp = pointnet.three_interpolate(source_feats, idx, w)
        if target_feats is not None:
            interp = torch.cat([interp, target_feats], dim=-1)
        return self.mlp(interp)


class PointNet2SASSG(nn.Module):
    """4-level SA + 2-level FP backbone (VoteNet's ScanNet setting)."""

    def __init__(self, in_channels: int = 4,
                 num_points: Sequence[int] = (2048, 1024, 512, 256),
                 radii: Sequence[float] = (0.2, 0.4, 0.8, 1.2),
                 num_samples: Sequence[int] = (64, 32, 16, 16),
                 sa_channels: Sequence[Sequence[int]] = (
                     (64, 64, 128), (128, 128, 256), (128, 128, 256),
                     (128, 128, 256)),
                 fp_channels: Sequence[Sequence[int]] = (
                     (256, 256), (256, 256))):
        super().__init__()
        self.n_sa = len(num_points)
        self.n_fp = len(fp_channels)
        sa_out = [in_channels - 3]  # per level's output features
        for i in range(self.n_sa):
            self.add_module(f"sa{i}", PointSAModule(
                num_points[i], radii[i], num_samples[i], sa_out[-1],
                sa_channels[i]))
            sa_out.append(sa_channels[i][-1])
        src = sa_out[-1]
        for i in range(self.n_fp):
            tgt = self.n_sa - i - 1
            self.add_module(f"fp{i}", PointFPModule(
                src + sa_out[tgt], fp_channels[i]))
            src = fp_channels[i][-1]

    def forward(self, points: torch.Tensor) -> Dict:
        """points: (N, 3 + extra) -> dict(fp_xyz, fp_features,
        fp_indices): the FP levels, finest last, and the final level's
        (int32) indices into the input cloud."""
        xyz = points[:, :3].contiguous()
        feats = points[:, 3:] if points.shape[-1] > 3 else None
        sa_xyz, sa_feats, sa_idx = [xyz], [feats], [None]
        for i in range(self.n_sa):
            new_xyz, new_f, idx = getattr(self, f"sa{i}")(sa_xyz[-1],
                                                          sa_feats[-1])
            sa_xyz.append(new_xyz)
            sa_feats.append(new_f)
            sa_idx.append(idx)

        fp_xyz, fp_feats = [sa_xyz[-1]], [sa_feats[-1]]
        for i in range(self.n_fp):
            tgt = self.n_sa - i - 1
            fp_feats.append(getattr(self, f"fp{i}")(
                sa_xyz[tgt], sa_xyz[tgt + 1], sa_feats[tgt], fp_feats[-1]))
            fp_xyz.append(sa_xyz[tgt])

        idx_chain = sa_idx[1]
        for i in range(2, self.n_sa - self.n_fp + 1):
            idx_chain = idx_chain[sa_idx[i].long()]
        return dict(fp_xyz=fp_xyz, fp_features=fp_feats,
                    fp_indices=idx_chain)
