"""Layers at a compute dtype, as flax's ``dtype`` runs them.

A flax layer built with ``dtype=bfloat16`` keeps its parameters in
float32 and, at every call, casts its input and its parameters to
bfloat16, computes, and returns bfloat16. These helpers do the same with
a torch layer whose parameters stay float32; at float32 they call the
layer as it is. What the JAX package's ``--bf16`` path computes, found
by running its ops on XLA's CPU backend:

* a convolution or dense product of bfloat16 operands accumulates in
  float32 and rounds its output to bfloat16 once (as cuDNN and cuBLAS
  do); the bias is then added as a bfloat16 op of its own, a second
  rounding (so the bias is never fused here);
* the 3x3x3 convolutions of the 3D neck and head run the JAX package's
  schedule (``nerfdet_tpu/ops/conv3d.py``): for the (C_in, C_out,
  stride) of its ``_BEST`` table one convolution, for every other shape
  the z-tap decomposition, three convolutions over the z taps, each
  rounded to bfloat16, summed in tap order with each sum rounded;
* a Python scalar in a bfloat16 op is first rounded to bfloat16 (JAX's
  weak type); torch keeps it in float32, so the port passes such a
  constant as a tensor of the input's dtype where its rounding shows.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

# (C_in, C_out, max stride) that the JAX package convolves in one piece
# (the z-fold schedule); every other 3x3x3 shape runs the z taps apart
_ONE_PIECE = {(256, 512, 2), (512, 512, 1), (512, 1024, 2), (1024, 1024, 1),
              (128, 18, 1), (128, 6, 1)}


def _bias(y, layer, dtype, dims: int):
    if layer.bias is None:
        return y
    return y + layer.bias.to(dtype).reshape((-1,) + (1,) * dims)


def linear(layer: nn.Linear, x, dtype):
    """``layer(x)`` at ``dtype``: (x W^T) rounded, then + b rounded."""
    if dtype == torch.float32:
        return layer(x)
    y = F.linear(x.to(dtype), layer.weight.to(dtype))
    return y if layer.bias is None else y + layer.bias.to(dtype)


def conv(layer, x, dtype):
    """A Conv2d / Conv3d / ConvTranspose3d at ``dtype`` (channels first)."""
    if dtype == torch.float32:
        return layer(x)
    x, w = x.to(dtype), layer.weight.to(dtype)
    if isinstance(layer, nn.ConvTranspose3d):
        y = F.conv_transpose3d(x, w, None, layer.stride, layer.padding,
                               layer.output_padding)
    else:
        y = layer._conv_forward(x, w, None)
    return _bias(y, layer, dtype, x.dim() - 2)


def conv3x3x3(layer: nn.Conv3d, x, dtype):
    """A 3x3x3, padding-1 Conv3d over an (N, C, nx, ny, nz) volume at
    ``dtype``, in the JAX package's schedule (see the module docstring);
    z is the last axis."""
    if dtype == torch.float32:
        return layer(x)
    x, w = x.to(dtype), layer.weight.to(dtype)
    sx, sy, sz = layer.stride
    if (w.shape[1], w.shape[0], max(layer.stride)) in _ONE_PIECE:
        y = F.conv3d(x, w, None, layer.stride, 1)
    else:
        xp = F.pad(x, (1, 1))
        nz = (x.shape[-1] - 1) // sz + 1
        y = None
        for dz in range(3):
            t = F.conv3d(xp[..., dz:dz + (nz - 1) * sz + 1],
                         w[..., dz:dz + 1], None, (sx, sy, sz), (1, 1, 0))
            y = t if y is None else y + t
    return _bias(y, layer, dtype, 3)
