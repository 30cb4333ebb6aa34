"""ResNet-50/101 backbone with frozen batch norm (NCHW inside).

Port of ``nerfdet_tpu/nn/resnet.py``: "pytorch" style (stride on the
3x3 conv of each bottleneck), every BatchNorm frozen and held as a
per-channel scale and bias (``FrozenAffine``), folded from
gamma/beta/mean/var when a reference checkpoint is loaded
(``utils/weight_convert.from_reference_state_dict``). Module names
follow the torchvision/mmdet state_dict keys. Stages after the last of
``out_indices`` are not built.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn

STAGE_BLOCKS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}


class FrozenAffine(nn.Module):
    """Per-channel scale and bias standing in for a frozen BatchNorm."""

    def __init__(self, channels: int):
        super().__init__()
        self.register_buffer("scale", torch.ones(channels))
        self.register_buffer("bias", torch.zeros(channels))

    def forward(self, x):
        return x * self.scale[:, None, None] + self.bias[:, None, None]


class Bottleneck(nn.Module):
    """1x1 -> 3x3(stride) -> 1x1 residual block."""

    def __init__(self, in_ch: int, mid: int, stride: int = 1):
        super().__init__()
        out_ch = mid * 4
        self.conv1 = nn.Conv2d(in_ch, mid, 1, bias=False)
        self.bn1 = FrozenAffine(mid)
        self.conv2 = nn.Conv2d(mid, mid, 3, stride, 1, bias=False)
        self.bn2 = FrozenAffine(mid)
        self.conv3 = nn.Conv2d(mid, out_ch, 1, bias=False)
        self.bn3 = FrozenAffine(out_ch)
        self.downsample = None
        if in_ch != out_ch or stride != 1:
            self.downsample = nn.Sequential(
                nn.Conv2d(in_ch, out_ch, 1, stride, bias=False),
                FrozenAffine(out_ch))

    def forward(self, x):
        y = torch.relu(self.bn1(self.conv1(x)))
        y = torch.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        residual = x if self.downsample is None else self.downsample(x)
        return torch.relu(y + residual)


class ResNet(nn.Module):
    """Multi-stage ResNet returning the C2..C5 maps of ``out_indices``."""

    def __init__(self, depth: int = 50,
                 out_indices: Sequence[int] = (0, 1, 2, 3)):
        super().__init__()
        self.out_indices = tuple(out_indices)
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = FrozenAffine(64)
        self.maxpool = nn.MaxPool2d(3, 2, 1)
        in_ch, mid = 64, 64
        self.n_stages = max(self.out_indices) + 1
        for stage, n_blocks in enumerate(STAGE_BLOCKS[depth][:self.n_stages]):
            blocks = []
            for b in range(n_blocks):
                stride = 2 if stage > 0 and b == 0 else 1
                blocks.append(Bottleneck(in_ch, mid, stride))
                in_ch = mid * 4
            self.add_module(f"layer{stage + 1}", nn.Sequential(*blocks))
            mid *= 2

    def forward(self, x) -> Tuple[torch.Tensor, ...]:
        x = self.maxpool(torch.relu(self.bn1(self.conv1(x))))
        outs = []
        for stage in range(self.n_stages):
            x = getattr(self, f"layer{stage + 1}")(x)
            if stage in self.out_indices:
                outs.append(x)
        return tuple(outs)
