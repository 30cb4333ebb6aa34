"""Vanilla NeRF radiance field: encoders, trunk and density head.

Port of ``nerfdet_tpu/nn/nerf_mlp.py``. Flax infers layer input widths;
here they are stated: the trunk input is the encoded position
(``encoded_dim(3, 0, 10)`` = 63) plus the feature width, and a skip
layer concatenates the trunk input back after its ReLU. Module names
follow the reference state_dict (``mlp.base.hidden_layers.{i}``,
``mlp.sigma_layer.output_layer``, ...). This slice runs
``query_density`` only; the view-conditioned rgb layers are built so a
full checkpoint loads.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn


def sinusoidal_encode(x, min_deg: int, max_deg: int,
                      use_identity: bool = True):
    """``[x, sin(x * 2^d), sin(x * 2^d + pi/2)]`` for d in [min, max)."""
    if max_deg == min_deg:
        return x
    scales = torch.tensor([2.0 ** i for i in range(min_deg, max_deg)],
                          dtype=x.dtype, device=x.device)
    xb = (x[..., None, :] * scales[:, None]).reshape(
        x.shape[:-1] + ((max_deg - min_deg) * x.shape[-1],))
    latent = torch.sin(torch.cat([xb, xb + 0.5 * math.pi], dim=-1))
    if use_identity:
        latent = torch.cat([x, latent], dim=-1)
    return latent


def encoded_dim(x_dim: int, min_deg: int, max_deg: int,
                use_identity: bool = True) -> int:
    return (int(use_identity) + (max_deg - min_deg) * 2) * x_dim


class MLP(nn.Module):
    """Plain MLP with periodic skip connections."""

    def __init__(self, in_dim: int, output_dim: Optional[int] = None,
                 net_depth: int = 8, net_width: int = 256,
                 skip_layer: Optional[int] = 4):
        super().__init__()
        self.skip_layer = skip_layer
        layers = []
        width = in_dim
        for i in range(net_depth):
            layers.append(nn.Linear(width, net_width))
            width = net_width
            if skip_layer is not None and i % skip_layer == 0 and i > 0:
                width += in_dim
        self.hidden_layers = nn.ModuleList(layers)
        self.output_layer = (nn.Linear(width, output_dim)
                             if output_dim is not None else None)
        self.out_dim = width if output_dim is None else output_dim

    def forward(self, x):
        inputs = x
        for i, layer in enumerate(self.hidden_layers):
            x = torch.relu(layer(x))
            if (self.skip_layer is not None and i % self.skip_layer == 0
                    and i > 0):
                x = torch.cat([x, inputs], dim=-1)
        if self.output_layer is not None:
            x = self.output_layer(x)
        return x


class NerfMLP(nn.Module):
    """Trunk + sigma head + view-conditioned rgb head."""

    def __init__(self, in_dim: int, condition_dim: int, net_depth: int = 8,
                 net_width: int = 256, skip_layer: Optional[int] = 4,
                 net_depth_condition: int = 1,
                 net_width_condition: int = 128):
        super().__init__()
        self.base = MLP(in_dim, None, net_depth, net_width, skip_layer)
        trunk = self.base.out_dim
        self.sigma_layer = MLP(trunk, 1, 0)
        self.bottleneck_layer = MLP(trunk, net_width, 0)
        self.rgb_layer = MLP(net_width + condition_dim, 3,
                             net_depth_condition, net_width_condition, None)

    def query_density(self, x, features=None):
        if features is not None:
            x = torch.cat([x, features], dim=-1)
        return self.sigma_layer(self.base(x))


class VanillaNeRFRadianceField(nn.Module):
    """Radiance field with the sinusoidal encoders built in."""

    def __init__(self, net_depth: int = 8, net_width: int = 256,
                 skip_layer: Optional[int] = 4, feature_dim: int = 0,
                 net_depth_condition: int = 1,
                 net_width_condition: int = 128):
        super().__init__()
        self.mlp = NerfMLP(
            encoded_dim(3, 0, 10) + feature_dim, encoded_dim(3, 0, 4),
            net_depth, net_width, skip_layer, net_depth_condition,
            net_width_condition)

    def query_density(self, x, features=None):
        x = sinusoidal_encode(x, 0, 10)
        return torch.relu(self.mlp.query_density(x, features))
