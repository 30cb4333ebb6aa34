"""Feature Pyramid Network (NCHW inside).

Port of ``nerfdet_tpu/nn/fpn.py``: lateral 1x1 convs, a nearest-neighbor
top-down path (2x upsample, then crop to the finer level, as the JAX
package does), 3x3 output convs. Module names follow the mmdet FPN
state_dict keys (``lateral_convs.{i}.conv``, ``fpn_convs.{i}.conv``).
``dtype`` is flax's compute dtype (``nn/compute.py``).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn

from .compute import conv


class _ConvModule(nn.Module):
    def __init__(self, layer: nn.Conv2d, dtype=torch.float32):
        super().__init__()
        self.conv = layer
        self.dtype = dtype

    def forward(self, x):
        return conv(self.conv, x, self.dtype)


class FPN(nn.Module):
    def __init__(self, in_channels: Sequence[int] = (256, 512, 1024, 2048),
                 out_channels: int = 256, dtype=torch.float32):
        super().__init__()
        self.lateral_convs = nn.ModuleList(
            _ConvModule(nn.Conv2d(c, out_channels, 1), dtype)
            for c in in_channels)
        self.fpn_convs = nn.ModuleList(
            _ConvModule(nn.Conv2d(out_channels, out_channels, 3, padding=1),
                        dtype)
            for _ in in_channels)

    def forward(self, inputs, num_outs=None) -> Tuple[torch.Tensor, ...]:
        """Output levels ``0 .. num_outs - 1`` (default: all). The
        detector consumes level 0 only and skips the other output convs,
        which XLA drops as dead code in the JAX package."""
        laterals = [conv(x) for conv, x in zip(self.lateral_convs, inputs)]
        for i in range(len(laterals) - 1, 0, -1):
            up = torch.repeat_interleave(
                torch.repeat_interleave(laterals[i], 2, dim=2), 2, dim=3)
            h, w = laterals[i - 1].shape[2:]
            laterals[i - 1] = laterals[i - 1] + up[:, :, :h, :w]
        n = len(self.fpn_convs) if num_outs is None else num_outs
        return tuple(self.fpn_convs[i](laterals[i]) for i in range(n))
