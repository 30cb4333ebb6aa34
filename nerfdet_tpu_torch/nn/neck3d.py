"""3D encoder-decoder neck over the fused voxel volume (NCDHW inside).

Port of ``nerfdet_tpu/nn/neck3d.py`` (``FastIndoorImVoxelNeck``): a
residual 3D conv encoder over ``len(n_blocks)`` scales, a transpose-conv
top-down path and one output block per scale; the volume axes
(nx, ny, nz) are the (D, H, W) of the convolutions. Inference only:
BatchNorm runs on its running statistics. Module names follow the
reference state_dict (``down_layer_{i}.{b}``, ``up_block_{i}``,
``out_block_{i}``).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn


def _conv3(c_in: int, c_out: int, stride: int = 1) -> nn.Conv3d:
    return nn.Conv3d(c_in, c_out, 3, stride, 1, bias=False)


class BasicBlock3dV2(nn.Module):
    """Residual 3D block with an optional strided 1x1x1 downsample."""

    def __init__(self, c_in: int, c_out: int, stride: int = 1):
        super().__init__()
        self.conv1 = _conv3(c_in, c_out, stride)
        self.norm1 = nn.BatchNorm3d(c_out)
        self.conv2 = _conv3(c_out, c_out)
        self.norm2 = nn.BatchNorm3d(c_out)
        self.downsample = None
        if stride != 1:
            self.downsample = nn.Sequential(
                nn.Conv3d(c_in, c_out, 1, stride, bias=False),
                nn.BatchNorm3d(c_out))

    def forward(self, x):
        y = torch.relu(self.norm1(self.conv1(x)))
        y = self.norm2(self.conv2(y))
        identity = x if self.downsample is None else self.downsample(x)
        return torch.relu(y + identity)


def _up_block(c_in: int, c_out: int) -> nn.Sequential:
    return nn.Sequential(
        nn.ConvTranspose3d(c_in, c_out, 2, 2, bias=False),
        nn.BatchNorm3d(c_out), nn.ReLU(),
        _conv3(c_out, c_out), nn.BatchNorm3d(c_out), nn.ReLU())


def _out_block(c_in: int, c_out: int) -> nn.Sequential:
    return nn.Sequential(_conv3(c_in, c_out), nn.BatchNorm3d(c_out),
                         nn.ReLU())


class FastIndoorImVoxelNeck(nn.Module):
    """Multi-scale 3D encoder-decoder; returns finest-first features."""

    def __init__(self, in_channels: int = 256, out_channels: int = 128,
                 n_blocks: Sequence[int] = (1, 1, 1)):
        super().__init__()
        self.n_scales = len(n_blocks)
        n_ch = in_channels
        for i, n in enumerate(n_blocks):
            blocks = []
            for b in range(n):
                if b == 0 and i > 0:
                    blocks.append(BasicBlock3dV2(n_ch, 2 * n_ch, 2))
                    n_ch *= 2
                else:
                    blocks.append(BasicBlock3dV2(n_ch, n_ch))
            self.add_module(f"down_layer_{i}", nn.Sequential(*blocks))
            if i > 0:
                self.add_module(f"up_block_{i}", _up_block(n_ch, n_ch // 2))
            self.add_module(f"out_block_{i}", _out_block(n_ch, out_channels))

    def forward(self, x) -> Tuple[torch.Tensor, ...]:
        down = []
        for i in range(self.n_scales):
            x = getattr(self, f"down_layer_{i}")(x)
            down.append(x)
        outs = []
        for i in range(self.n_scales - 1, -1, -1):
            if i < self.n_scales - 1:
                x = down[i] + getattr(self, f"up_block_{i + 1}")(x)
            outs.append(getattr(self, f"out_block_{i}")(x))
        return tuple(outs[::-1])
