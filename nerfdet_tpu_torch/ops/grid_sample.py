"""Bilinear sampling from a 2x2-packed map (zero padding), and
trilinear sampling of a voxel volume.

Port of ``pack_bilinear``, ``grid_sample_2d_packed`` and
``grid_sample_3d`` of ``nerfdet_tpu/ops/grid_sample.py``. Coordinates
are unnormalized pixel coordinates (``align_corners=True``). The plain
version of K2 (``ops/render.ray_view_carry_plain``) is built on the first
two; the volume-mode renderer on the third.

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


def _clip(p: torch.Tensor, size: int) -> torch.Tensor:
    """``jnp.clip(p, 0, size - 1)``: max, then min, so a coordinate on an
    edge takes half the gradient, as JAX's tie rule gives it."""
    lo = torch.zeros((), dtype=p.dtype, device=p.device)
    return torch.minimum(torch.maximum(p, lo), lo + (size - 1))


def grid_sample_3d(volume: torch.Tensor, px: torch.Tensor, py: torch.Tensor,
                   pz: torch.Tensor, padding: str = "border") -> torch.Tensor:
    """Trilinear sample of a (D, H, W, C) volume at float voxel
    coordinates (...,) -> (..., C): ``px`` indexes W, ``py`` H, ``pz`` D
    (torch's 5-D ``grid_sample`` order). ``padding`` "border" clamps the
    coordinates into the volume; "zeros" drops the taps outside it. The
    eight taps add in the JAX order (x, then y, then z tap outermost
    first), each weight ``(wx * wy) * wz`` float32, so a bfloat16 volume
    gives float32 samples, as JAX's type promotion does. Differentiable
    in the volume and the coordinates (autograd)."""
    d, h, w, c = volume.shape
    if padding == "border":
        px, py, pz = _clip(px, w), _clip(py, h), _clip(pz, d)
    elif padding != "zeros":
        raise ValueError(f"padding must be 'border' or 'zeros', got "
                         f"{padding!r}")
    x0, y0, z0 = torch.floor(px), torch.floor(py), torch.floor(pz)
    wx1, wy1, wz1 = px - x0, py - y0, pz - z0
    flat = volume.reshape(d * h * w, c)

    def tap(xi, yi, zi, wgt):
        if padding == "zeros":
            inb = ((xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)
                   & (zi >= 0) & (zi <= d - 1))
            wgt = wgt * inb.to(wgt.dtype)
        xc = torch.clamp(xi, 0, w - 1).long()
        yc = torch.clamp(yi, 0, h - 1).long()
        zc = torch.clamp(zi, 0, d - 1).long()
        vals = flat.index_select(0, ((zc * h + yc) * w + xc).reshape(-1))
        return vals.reshape(wgt.shape + (c,)) * wgt[..., None]

    out = None
    for dx, wx in ((0, 1 - wx1), (1, wx1)):
        for dy, wy in ((0, 1 - wy1), (1, wy1)):
            for dz, wz in ((0, 1 - wz1), (1, wz1)):
                t = tap(x0 + dx, y0 + dy, z0 + dz, wx * wy * wz)
                out = t if out is None else out + t
    return out
