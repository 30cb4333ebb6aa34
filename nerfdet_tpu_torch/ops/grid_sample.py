"""Bilinear sampling from a 2x2-packed map (zero padding).

Port of ``pack_bilinear`` and ``grid_sample_2d_packed`` of
``nerfdet_tpu/ops/grid_sample.py``. Coordinates are unnormalized pixel
coordinates (``align_corners=True``). The plain version of K2
(``ops/render.ray_view_carry_plain``) is built on these two functions.

On a bfloat16 map the taps follow JAX's two forms: the feature taps
(its native-dtype einsum) round the four weights to bfloat16, sum the
exact products in float32 and round the sum to bfloat16 (XLA's CPU
backend computes a bfloat16 dot in float32 and rounds once); the rgb
taps (``f32_taps``) keep the weights in float32 and round only the sum.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .bf16 import bf16_round


def pack_bilinear(image: torch.Tensor) -> torch.Tensor:
    """(H, W, C) -> (H, W, 4C) with the 2x2 tap window packed into
    channels: ``packed[y, x] = [f(y,x), f(y,x+1), f(y+1,x), f(y+1,x+1)]``,
    zero beyond the right and bottom edges."""
    h, w, _ = image.shape
    p = F.pad(image, (0, 0, 0, 1, 0, 1))
    return torch.cat([p[:h, :w], p[:h, 1:w + 1], p[1:h + 1, :w],
                      p[1:h + 1, 1:w + 1]], dim=-1)


def _window(p: torch.Tensor, size: int):
    """Window start ``clip(floor(p), 0, size-1)`` and the weights
    ``max(0, 1 - |p - start - k|)`` of its two taps k = 0, 1.

    One expression gives the interior bilinear weights, the windows
    shifted by the clamp at the edges, and the zero-padding cutoff: a
    coordinate in (-1, 0) or (size-1, size) keeps a partial weight on
    its one tap inside the map."""
    start = torch.clamp(torch.floor(p), 0.0, size - 1.0)
    r = p - start
    w0 = torch.clamp(1.0 - r.abs(), min=0.0)
    w1 = torch.clamp(1.0 - (r - 1.0).abs(), min=0.0)
    return start, w0, w1


def grid_sample_2d_packed(packed: torch.Tensor, px: torch.Tensor,
                          py: torch.Tensor,
                          f32_taps: bool = False) -> torch.Tensor:
    """Bilinear sample of a :func:`pack_bilinear`-packed (H, W, 4C) map
    at float pixel coordinates (...,) -> (..., C), as float32.

    Equals zero-padded ``grid_sample`` with ``align_corners=True``. The
    four taps are summed in the fixed order ((t00 + t01) + t10) + t11,
    each product and sum rounded on its own, as K2 does. A bfloat16 map
    rounds the weights to bfloat16 unless ``f32_taps``, and the sum to
    bfloat16 either way (see the module docstring)."""
    h, w, c4 = packed.shape
    c = c4 // 4
    sx, wx0, wx1 = _window(px, w)
    sy, wy0, wy1 = _window(py, h)
    lin = (sy.long() * w + sx.long()).reshape(-1)
    rows = packed.reshape(h * w, c4).index_select(0, lin).reshape(
        px.shape + (4, c)).float()
    wgt = (wy0 * wx0, wy0 * wx1, wy1 * wx0, wy1 * wx1)
    bf16 = packed.dtype == torch.bfloat16
    if bf16 and not f32_taps:
        wgt = tuple(bf16_round(wk) for wk in wgt)
    out = rows[..., 0, :] * wgt[0][..., None]
    for k in (1, 2, 3):
        out = out + rows[..., k, :] * wgt[k][..., None]
    return bf16_round(out) if bf16 else out
