"""The indoor ImVoxelNet's Atlas 3D neck (NCDHW inside).

Port of ``ImVoxelNeck`` from ``nerfdet_tpu/nn/imvoxel_necks.py`` with its
parts ``AtlasBlock3d``, ``_CondProj`` and ``EncoderDecoder3D``: a 3D
encoder of residual blocks over ``len(channels)`` scales (each scale
after the first opened by a stride-2 conv), a decoder that upsamples 2x
trilinearly, maps the channels down with a 1x1x1 conv and averages with
the encoder's projected skip, and one conv-BN-ReLU output block a
decoder scale, finest first. The volume axes (nx, ny, nz) are the (D, H,
W) of the convolutions. Module names are the flax names
(``model.down_{i}_{j}.conv1``, ``model.down_conv_{i}``,
``model.up_conv_{i}``, ``model.proj_{i}.norm``, ``out_conv_{i}``, ...),
so ``utils/weight_convert.from_jax_variables`` maps the JAX tree by name.
The outdoor necks (``KittiImVoxelNeck``, ``NuScenesImVoxelNeck``) are
not ported.

As in JAX: the second BatchNorm of each block starts with a zero scale
(``init_weights``), so each block starts as the identity; BatchNorm is
``nn/neck3d.BatchNorm3d`` (flax's momentum and eps); the upsampling is
``jax.image.resize(..., "trilinear")``, which at 2x is
``F.interpolate(mode="trilinear", align_corners=False)`` (half-pixel
centres, the edge sample taking the edge voxel); ``conditional`` lets a
voxel no view observed take the decoder's feature in place of the
skip's, the observed mask taken from the input volume and downscaled by
``jax.image.resize(..., "nearest")`` (input index floor((i + 0.5) *
in / out), torch's ``nearest-exact``).

``dtype`` is flax's compute dtype (``nn/compute.py``): every conv runs
at it in one piece (flax's ``nn.Conv``, not the z-tap schedule), a bias
added as its own rounding; a bfloat16 volume is upsampled as JAX's
resize rounds it (``upsample2x``). The first block's residual adds the
float32 volume, so its output is float32, as in JAX.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.resize import resize_weights
from .compute import conv
from .neck3d import BatchNorm3d


def _conv(c_in: int, c_out: int, k: int, stride: int = 1,
          bias: bool = False) -> nn.Conv3d:
    return nn.Conv3d(c_in, c_out, k, stride, k // 2, bias=bias)


class AtlasBlock3d(nn.Module):
    """conv-BN-ReLU-conv-BN + identity, ReLU; ``bn2`` starts at zero."""

    def __init__(self, channels: int, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv1 = _conv(channels, channels, 3)
        self.bn1 = BatchNorm3d(channels)
        self.conv2 = _conv(channels, channels, 3)
        self.bn2 = BatchNorm3d(channels)

    def forward(self, x):
        y = torch.relu(self.bn1(conv(self.conv1, x, self.dtype)))
        y = self.bn2(conv(self.conv2, y, self.dtype))
        return torch.relu(y + x)


class _CondProj(nn.Module):
    """The projected encoder skip: a 1x1x1 conv of the encoder feature,
    with ``condition`` the decoder's feature where ``mask`` is False, then
    BN and ReLU."""

    def __init__(self, c_in: int, channels: int, condition: bool = False,
                 dtype=torch.float32):
        super().__init__()
        self.dtype, self.condition = dtype, condition
        self.conv = _conv(c_in, channels, 1)
        self.norm = BatchNorm3d(channels)

    def forward(self, x, y, mask):
        x = conv(self.conv, x, self.dtype)
        if self.condition:
            x = torch.where(mask, x, y)
        return torch.relu(self.norm(x))


def _nearest_index(n_in: int, n_out: int, device) -> torch.Tensor:
    """``jax.image.resize``'s nearest source index of each output
    element, in its float32 arithmetic."""
    f32 = np.float32
    pos = (np.arange(n_out, dtype=f32) + f32(0.5)) * f32(n_in) / f32(n_out)
    return torch.from_numpy(np.floor(pos).astype(np.int64)).to(device)


def nearest_resize(mask: torch.Tensor, size) -> torch.Tensor:
    """(N, 1, D, H, W) -> (N, 1, *size) as ``jax.image.resize(...,
    "nearest")``."""
    for axis, n in zip((2, 3, 4), size):
        mask = mask.index_select(axis, _nearest_index(mask.shape[axis], n,
                                                      mask.device))
    return mask


def upsample2x(x: torch.Tensor, dtype) -> torch.Tensor:
    """2x trilinear upsampling of (N, C, D, H, W), as JAX's
    ``jax.image.resize(x, 2x, "trilinear").astype(dtype)``. A float32 volume
    in one ``F.interpolate``. A bfloat16 one as JAX contracts it: one axis
    at a time with the (exact) 0.75 / 0.25 weights, each product summed
    in float32 and rounded to bfloat16, the longest axis first (ties in
    axis order), the order the einsum inside ``jax.image.resize`` takes."""
    if x.dtype != torch.bfloat16:
        d, h, w = x.shape[2:]
        y = F.interpolate(x.float(), size=(2 * d, 2 * h, 2 * w),
                          mode="trilinear", align_corners=False)
        return y.to(dtype)
    for axis in sorted((2, 3, 4), key=lambda a: -x.shape[a]):
        n = x.shape[axis]
        w = torch.from_numpy(resize_weights(n, 2 * n)).to(x.device)
        x = torch.movedim(torch.tensordot(x.float(), w, dims=([axis], [0])),
                          -1, axis).to(torch.bfloat16)
    return x.to(dtype)


class EncoderDecoder3D(nn.Module):
    """The Atlas refinement network: returns the decoder's outputs,
    coarse first, each with ``channels[::-1][i + 1]`` channels."""

    def __init__(self, channels: Sequence[int] = (64, 128, 256, 512),
                 layers_down: Sequence[int] = (1, 2, 3, 4),
                 layers_up: Sequence[int] = (3, 2, 1),
                 cond_proj: bool = False, dtype=torch.float32):
        super().__init__()
        chans = tuple(channels)
        self.chans, self.dtype, self.cond_proj = chans, dtype, cond_proj
        self.layers_down, self.layers_up = tuple(layers_down), \
            tuple(layers_up)
        for i, c in enumerate(chans):
            if i > 0:
                self.add_module(f"down_conv_{i}",
                                _conv(chans[i - 1], c, 3, stride=2))
                self.add_module(f"down_norm_{i}", BatchNorm3d(c))
            for j in range(self.layers_down[i]):
                self.add_module(f"down_{i}_{j}", AtlasBlock3d(c, dtype))
        rev = chans[::-1]
        for i in range(len(chans) - 1):
            self.add_module(f"up_conv_{i}", _conv(rev[i], rev[i + 1], 1))
            self.add_module(f"proj_{i}", _CondProj(
                rev[i + 1], rev[i + 1], cond_proj, dtype))
            for j in range(self.layers_up[i]):
                self.add_module(f"up_{i}_{j}", AtlasBlock3d(rev[i + 1],
                                                            dtype))

    def forward(self, x):
        valid = (x != 0).any(dim=1, keepdim=True) if self.cond_proj else None
        xs = []
        for i in range(len(self.chans)):
            if i > 0:
                x = conv(getattr(self, f"down_conv_{i}"), x, self.dtype)
                x = torch.relu(getattr(self, f"down_norm_{i}")(x))
            for j in range(self.layers_down[i]):
                x = getattr(self, f"down_{i}_{j}")(x)
            xs.append(x)
        xs = xs[::-1]
        outs = []
        for i in range(len(self.chans) - 1):
            x = upsample2x(x, self.dtype)
            x = conv(getattr(self, f"up_conv_{i}"), x, self.dtype)
            mask = None
            if self.cond_proj:
                mask = nearest_resize(valid, x.shape[2:])
            y = getattr(self, f"proj_{i}")(xs[i + 1], x, mask)
            x = (x + y) / 2
            for j in range(self.layers_up[i]):
                x = getattr(self, f"up_{i}_{j}")(x)
            outs.append(x)
        return outs


class ImVoxelNeck(nn.Module):
    """The indoor Atlas neck: ``EncoderDecoder3D`` (as ``model``) and one
    conv (with bias)-BN-ReLU block a decoder scale; returns the scales
    finest first, each ``out_channels`` wide."""

    def __init__(self, channels: Sequence[int] = (64, 128, 256, 512),
                 out_channels: int = 64,
                 down_layers: Sequence[int] = (1, 2, 3, 4),
                 up_layers: Sequence[int] = (3, 2, 1),
                 conditional: bool = False, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.model = EncoderDecoder3D(channels, down_layers, up_layers,
                                      conditional, dtype)
        # the decoder's scales, finest first: channels[:-1] reversed back
        for i, c in enumerate(tuple(channels)[:-1]):
            self.add_module(f"out_conv_{i}",
                            _conv(c, out_channels, 3, bias=True))
            self.add_module(f"out_norm_{i}", BatchNorm3d(out_channels))

    def forward(self, x) -> Tuple[torch.Tensor, ...]:
        feats = self.model(x)[::-1]
        return tuple(
            torch.relu(getattr(self, f"out_norm_{i}")(
                conv(getattr(self, f"out_conv_{i}"), f, self.dtype)))
            for i, f in enumerate(feats))

    @torch.no_grad()
    def zero_residual_scales(self) -> None:
        """Each block's ``bn2`` scale to zero (flax's ``scale_init``)."""
        for m in self.modules():
            if isinstance(m, AtlasBlock3d):
                m.bn2.weight.zero_()
