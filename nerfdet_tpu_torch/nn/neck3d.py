"""3D encoder-decoder neck over the fused voxel volume (NCDHW inside).

Port of ``nerfdet_tpu/nn/neck3d.py`` (``FastIndoorImVoxelNeck``): a
residual 3D conv encoder over ``len(n_blocks)`` scales, a transpose-conv
top-down path and one output block per scale; the volume axes
(nx, ny, nz) are the (D, H, W) of the convolutions. BatchNorm follows
flax's ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)``: in eval mode it runs
on its running statistics; in train mode it normalizes by the batch's
biased statistics and moves the running ones 0.1 of the way to them
(``BatchNorm3d``). Module names follow the reference state_dict
(``down_layer_{i}.{b}``, ``up_block_{i}``, ``out_block_{i}``).

``dtype`` is flax's compute dtype (``nn/compute.py``): at bfloat16 the
convolutions run in bfloat16 (the 3x3x3 ones in the JAX package's
schedule) and BatchNorm follows flax 0.12's ``BatchNorm(dtype=bf16)``:
statistics in float32 (E[x^2] - E[x]^2), ``((x - mean) * (rsqrt(var +
eps) * scale)) + bias`` in float32, rounded to bfloat16 once.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .compute import conv, conv3x3x3


class BatchNorm3d(nn.BatchNorm3d):
    """``nn.BatchNorm3d`` with flax's train-mode update: the running
    variance moves toward the biased batch variance (torch's moves toward
    the unbiased one). Normalization uses the biased batch variance in
    both; flax computes it as E[x^2] - E[x]^2, torch in two passes, which
    differ by rounding. Eval mode is torch's."""

    def __init__(self, channels: int):
        super().__init__(channels, eps=1e-5, momentum=0.1)

    def forward(self, x):
        if x.dtype != torch.float32:
            return self._flax_low_precision(x)
        if not self.training:
            return super().forward(x)
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=(0, 2, 3, 4), correction=0)
            for run, batch in ((self.running_mean, mean),
                               (self.running_var, var)):
                run.mul_(1.0 - self.momentum).add_(batch, alpha=self.momentum)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                            self.eps)

    def _flax_low_precision(self, x):
        """flax's arithmetic on a bfloat16 input. ``x`` is widened apart
        for the statistics and for the normalization, as flax converts
        it twice (so its gradient adds the two parts in bfloat16)."""
        shape = (1, -1, 1, 1, 1)
        if self.training:
            xs = x.float()
            mean = xs.mean(dim=(0, 2, 3, 4))
            var = torch.clamp((xs * xs).mean(dim=(0, 2, 3, 4))
                              - mean * mean, min=0.0)
            with torch.no_grad():
                for run, batch in ((self.running_mean, mean),
                                   (self.running_var, var)):
                    run.mul_(1.0 - self.momentum).add_(
                        batch.detach(), alpha=self.momentum)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (x.float() - mean.reshape(shape)) * mul.reshape(shape)
        return (y + self.bias.reshape(shape)).to(x.dtype)


def _conv3(c_in: int, c_out: int, stride: int = 1) -> nn.Conv3d:
    return nn.Conv3d(c_in, c_out, 3, stride, 1, bias=False)


class BasicBlock3dV2(nn.Module):
    """Residual 3D block with an optional strided 1x1x1 downsample."""

    def __init__(self, c_in: int, c_out: int, stride: int = 1,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv1 = _conv3(c_in, c_out, stride)
        self.norm1 = BatchNorm3d(c_out)
        self.conv2 = _conv3(c_out, c_out)
        self.norm2 = BatchNorm3d(c_out)
        self.downsample = None
        if stride != 1:
            self.downsample = nn.Sequential(
                nn.Conv3d(c_in, c_out, 1, stride, bias=False),
                BatchNorm3d(c_out))

    def forward(self, x):
        dt = self.dtype
        y = torch.relu(self.norm1(conv3x3x3(self.conv1, x, dt)))
        y = self.norm2(conv3x3x3(self.conv2, y, dt))
        identity = x
        if self.downsample is not None:
            identity = self.downsample[1](conv(self.downsample[0], x, dt))
        return torch.relu(y + identity)


class _Stack(nn.Sequential):
    """Convolutions, BatchNorms and ReLUs in order, the convolutions at
    ``dtype``; indexed as the reference state_dict's up and out blocks."""

    def __init__(self, *layers, dtype=torch.float32):
        super().__init__(*layers)
        self.dtype = dtype

    def forward(self, x):
        for layer in self:
            if isinstance(layer, nn.ConvTranspose3d):
                x = conv(layer, x, self.dtype)
            elif isinstance(layer, nn.Conv3d):
                x = conv3x3x3(layer, x, self.dtype)
            else:
                x = layer(x)
        return x


def _up_block(c_in: int, c_out: int, dtype) -> nn.Sequential:
    return _Stack(
        nn.ConvTranspose3d(c_in, c_out, 2, 2, bias=False),
        BatchNorm3d(c_out), nn.ReLU(),
        _conv3(c_out, c_out), BatchNorm3d(c_out), nn.ReLU(), dtype=dtype)


def _out_block(c_in: int, c_out: int, dtype) -> nn.Sequential:
    return _Stack(_conv3(c_in, c_out), BatchNorm3d(c_out), nn.ReLU(),
                  dtype=dtype)


class FastIndoorImVoxelNeck(nn.Module):
    """Multi-scale 3D encoder-decoder; returns finest-first features."""

    def __init__(self, in_channels: int = 256, out_channels: int = 128,
                 n_blocks: Sequence[int] = (1, 1, 1), dtype=torch.float32):
        super().__init__()
        self.n_scales = len(n_blocks)
        n_ch = in_channels
        for i, n in enumerate(n_blocks):
            blocks = []
            for b in range(n):
                if b == 0 and i > 0:
                    blocks.append(BasicBlock3dV2(n_ch, 2 * n_ch, 2, dtype))
                    n_ch *= 2
                else:
                    blocks.append(BasicBlock3dV2(n_ch, n_ch, 1, dtype))
            self.add_module(f"down_layer_{i}", nn.Sequential(*blocks))
            if i > 0:
                self.add_module(f"up_block_{i}",
                                _up_block(n_ch, n_ch // 2, dtype))
            self.add_module(f"out_block_{i}",
                            _out_block(n_ch, out_channels, dtype))

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
