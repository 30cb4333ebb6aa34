"""Vanilla NeRF radiance field: encoders, trunk and density head.

Port of ``nerfdet_tpu/nn/nerf_mlp.py``. Flax infers layer input widths;
here they are stated: the trunk input is the encoded position
(``encoded_dim(3, 0, 10)`` = 63) plus the feature width, and a skip
layer concatenates the trunk input back after its ReLU. Module names
follow the reference state_dict (``mlp.base.hidden_layers.{i}``,
``mlp.sigma_layer.output_layer``, ...). Detection runs
``query_density``; rendering runs the full forward, whose rgb head is
conditioned on the encoded view direction. ``dtype`` is flax's compute
dtype (``nn/compute.py``): at bfloat16 the field casts its inputs, as
the JAX model does at each call, and every layer, encoding and
activation runs in bfloat16.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from .compute import linear


def sinusoidal_encode(x, min_deg: int, max_deg: int,
                      use_identity: bool = True):
    """``[x, sin(x * 2^d), sin(x * 2^d + pi/2)]`` for d in [min, max)."""
    if max_deg == min_deg:
        return x
    scales = torch.tensor([2.0 ** i for i in range(min_deg, max_deg)],
                          dtype=x.dtype, device=x.device)
    xb = (x[..., None, :] * scales[:, None]).reshape(
        x.shape[:-1] + ((max_deg - min_deg) * x.shape[-1],))
    # pi / 2 in x's dtype, as JAX rounds its weak scalar (nn/compute.py)
    half_pi = torch.tensor(0.5 * math.pi, dtype=x.dtype, device=x.device)
    latent = torch.sin(torch.cat([xb, xb + half_pi], dim=-1))
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
                 skip_layer: Optional[int] = 4, dtype=torch.float32):
        super().__init__()
        self.skip_layer = skip_layer
        self.dtype = dtype
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
            x = torch.relu(linear(layer, x, self.dtype))
            if (self.skip_layer is not None and i % self.skip_layer == 0
                    and i > 0):
                x = torch.cat([x, inputs], dim=-1)
        if self.output_layer is not None:
            x = linear(self.output_layer, x, self.dtype)
        return x


class NerfMLP(nn.Module):
    """Trunk + sigma head + view-conditioned rgb head."""

    def __init__(self, in_dim: int, condition_dim: int, net_depth: int = 8,
                 net_width: int = 256, skip_layer: Optional[int] = 4,
                 net_depth_condition: int = 1,
                 net_width_condition: int = 128, dtype=torch.float32):
        super().__init__()
        self.base = MLP(in_dim, None, net_depth, net_width, skip_layer,
                        dtype)
        trunk = self.base.out_dim
        self.sigma_layer = MLP(trunk, 1, 0, dtype=dtype)
        self.bottleneck_layer = MLP(trunk, net_width, 0, dtype=dtype)
        self.rgb_layer = MLP(net_width + condition_dim, 3,
                             net_depth_condition, net_width_condition, None,
                             dtype)

    def query_density(self, x, features=None):
        if features is not None:
            x = torch.cat([x, features], dim=-1)
        return self.sigma_layer(self.base(x))

    def forward(self, x, condition, features):
        """Raw (rgb, sigma) of (..., in) points: the trunk over [x,
        features], the sigma head, then the rgb head over [bottleneck,
        condition]; ``condition`` (R, D) is broadcast over the samples
        of each ray."""
        x = self.base(torch.cat([x, features], dim=-1))
        raw_sigma = self.sigma_layer(x)
        if condition.shape[:-1] != x.shape[:-1]:
            condition = condition.reshape(
                condition.shape[:1] + (1,) * (x.dim() - condition.dim())
                + condition.shape[-1:]).expand(
                    x.shape[:-1] + condition.shape[-1:])
        x = torch.cat([self.bottleneck_layer(x), condition], dim=-1)
        return self.rgb_layer(x), raw_sigma


class VanillaNeRFRadianceField(nn.Module):
    """Radiance field with the sinusoidal encoders built in."""

    def __init__(self, net_depth: int = 8, net_width: int = 256,
                 skip_layer: Optional[int] = 4, feature_dim: int = 0,
                 net_depth_condition: int = 1,
                 net_width_condition: int = 128, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.mlp = NerfMLP(
            encoded_dim(3, 0, 10) + feature_dim, encoded_dim(3, 0, 4),
            net_depth, net_width, skip_layer, net_depth_condition,
            net_width_condition, dtype)

    def query_density(self, x, features=None):
        x = sinusoidal_encode(x.to(self.dtype), 0, 10)
        if features is not None:
            features = features.to(self.dtype)
        return torch.relu(self.mlp.query_density(x, features))

    def forward(self, x, condition, features):
        """(sigmoid(rgb), relu(sigma)) at points ``x`` (..., 3) with
        view directions ``condition`` (R, 3) and ``features`` (..., F)."""
        dt = self.dtype
        rgb, sigma = self.mlp(sinusoidal_encode(x.to(dt), 0, 10),
                              sinusoidal_encode(condition.to(dt), 0, 4),
                              features.to(dt))
        return torch.sigmoid(rgb), torch.relu(sigma)
